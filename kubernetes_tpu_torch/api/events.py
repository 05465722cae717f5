"""events.k8s.io/v1 Event — the API object component event recorders write.

Reference: staging/src/k8s.io/api/events/v1/types.go. A copy of the
reference package's module (kubernetes_tpu/api/events.py): the object the
store holds for the scheduler's Scheduled and FailedScheduling events.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

EVENT_TYPE_NORMAL = "Normal"
EVENT_TYPE_WARNING = "Warning"


@dataclass
class Event:
    """events.k8s.io/v1 Event (scheduling-relevant subset)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: str = ""  # "<kind>/<namespace>/<name>"
    type: str = EVENT_TYPE_NORMAL
    reason: str = ""
    message: str = ""
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    reporting_controller: str = "default-scheduler"

    kind = "Event"
