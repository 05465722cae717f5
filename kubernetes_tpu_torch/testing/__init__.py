"""Fixture builders for the port's tests and its chip smoke run."""

from .cluster import synthetic_cluster

__all__ = ["synthetic_cluster"]
