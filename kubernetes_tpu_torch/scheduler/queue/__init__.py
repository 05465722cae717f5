"""Scheduling queue (reference: pkg/scheduler/backend/queue/): the
three-tier SchedulingQueue and the Nominator it holds."""

from .nominator import Nominator  # noqa: F401
from .scheduling_queue import QueuedPodInfo, SchedulingQueue  # noqa: F401
