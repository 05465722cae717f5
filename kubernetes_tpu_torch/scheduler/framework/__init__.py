"""The scheduler framework's public types the single-pod cycle returns and
raises (status codes, Status, NodeToStatus, FitError, Diagnosis,
ScheduleResult, CycleState), the Plugin base, and the placement half of the
runtime the gang planner calls (Framework, Handle, ObjectLookup). The rest
of the runtime and the queue come with a later slice."""

from .cycle_state import CycleState  # noqa: F401
from .interface import (  # noqa: F401
    Diagnosis,
    FitError,
    NodeToStatus,
    Plugin,
    ScheduleResult,
    Status,
)
from .runtime import Framework, Handle, ObjectLookup  # noqa: F401
