"""The scheduler framework's public types the single-pod cycle returns and
raises: status codes, Status, NodeToStatus, FitError, Diagnosis,
ScheduleResult, CycleState. The plugins, the runtime and the queue come
with a later slice."""

from .cycle_state import CycleState  # noqa: F401
from .interface import (  # noqa: F401
    Diagnosis,
    FitError,
    NodeToStatus,
    ScheduleResult,
    Status,
)
