"""Scheduler framework: plugin API, cycle state, events, runtime.

Reference: staging/src/k8s.io/kube-scheduler/framework (public API) +
pkg/scheduler/framework/runtime (the plugin runner). The handle its
plugins read (Handle, ObjectLookup) stands in for the reference
scheduler's until the loop and store are ported.
"""

from . import events  # noqa: F401
from .cycle_state import CycleState  # noqa: F401
from .interface import (  # noqa: F401
    Status,
    Plugin,
    PreFilterResult,
    PostFilterResult,
    NodeScore,
    NodePluginScores,
    NodeToStatus,
    Diagnosis,
    FitError,
    ScheduleResult,
    WaitingPod,
    status_of,
    SUCCESS,
    ERROR,
    UNSCHEDULABLE,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    WAIT,
    SKIP,
    PENDING,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
)
from .runtime import Framework, Handle, ObjectLookup  # noqa: F401
