"""Scheduler configuration (reference: pkg/scheduler/apis/config/)."""
