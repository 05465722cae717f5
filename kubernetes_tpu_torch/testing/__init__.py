"""Fixture builders for the port's tests and its chip smoke run."""
