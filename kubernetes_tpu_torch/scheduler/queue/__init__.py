"""Scheduling queue pieces (reference: pkg/scheduler/backend/queue/). The
port has the nominator; the queue that holds it comes with the
scheduling loop."""

from .nominator import Nominator  # noqa: F401
