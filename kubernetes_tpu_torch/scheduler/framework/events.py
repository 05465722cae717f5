"""Cluster-event taxonomy driving queueing hints.

Reference: staging/src/k8s.io/kube-scheduler/framework/types.go:33-183 —
ActionType bitmask + EventResource; ClusterEventWithHint at :185-227.
A copy of the reference package's module: the plugins' events_to_register
return these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

# ActionType bits (types.go:33)
ADD = 1 << 0
DELETE = 1 << 1
UPDATE_NODE_ALLOCATABLE = 1 << 2
UPDATE_NODE_LABEL = 1 << 3
UPDATE_NODE_TAINT = 1 << 4
UPDATE_NODE_CONDITION = 1 << 5
UPDATE_NODE_ANNOTATION = 1 << 6
UPDATE_POD_LABEL = 1 << 7
UPDATE_POD_SCALE_DOWN = 1 << 8
UPDATE_POD_TOLERATIONS = 1 << 9
UPDATE_POD_SCHEDULING_GATES_ELIMINATED = 1 << 10
UPDATE_POD_GENERATED_RESOURCE_CLAIM = 1 << 11
UPDATE = (
    UPDATE_NODE_ALLOCATABLE
    | UPDATE_NODE_LABEL
    | UPDATE_NODE_TAINT
    | UPDATE_NODE_CONDITION
    | UPDATE_NODE_ANNOTATION
    | UPDATE_POD_LABEL
    | UPDATE_POD_SCALE_DOWN
    | UPDATE_POD_TOLERATIONS
    | UPDATE_POD_SCHEDULING_GATES_ELIMINATED
    | UPDATE_POD_GENERATED_RESOURCE_CLAIM
)
ALL = ADD | DELETE | UPDATE

# EventResource (types.go:124)
POD = "Pod"
ASSIGNED_POD = "AssignedPod"
UNSCHEDULED_POD = "UnscheduledPod"
NODE = "Node"
POD_GROUP = "PodGroup"
PVC = "PersistentVolumeClaim"
PV = "PersistentVolume"
STORAGE_CLASS = "StorageClass"
CSI_NODE = "CSINode"
RESOURCE_CLAIM = "ResourceClaim"
RESOURCE_SLICE = "ResourceSlice"
WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    resource: str
    action_type: int
    label: str = ""

    def match(self, other: "ClusterEvent") -> bool:
        """Does a registered event (self) cover a fired event (other)?"""
        res_ok = self.resource == WILDCARD or self.resource == other.resource or (
            self.resource == POD and other.resource in (ASSIGNED_POD, UNSCHEDULED_POD)
        )
        return res_ok and bool(self.action_type & other.action_type)

    def __str__(self) -> str:
        return self.label or f"{self.resource}:{self.action_type}"


# QueueingHint results (types.go QueueingHint)
QUEUE_SKIP = 0
QUEUE = 1

# hint fn: (pod, old_obj, new_obj) -> QUEUE | QUEUE_SKIP (raise -> treated as QUEUE)
QueueingHintFn = Callable[[Any, Any, Any], int]


@dataclass
class ClusterEventWithHint:
    event: ClusterEvent
    queueing_hint_fn: QueueingHintFn | None = None


# Common pre-made events
EVENT_WILDCARD = ClusterEvent(WILDCARD, ALL, "WildCardEvent")
EVENT_UNSCHEDULED_POD_ADD = ClusterEvent(UNSCHEDULED_POD, ADD, "UnscheduledPodAdd")
EVENT_UNSCHEDULED_POD_UPDATE = ClusterEvent(UNSCHEDULED_POD, UPDATE, "UnscheduledPodUpdate")
EVENT_ASSIGNED_POD_ADD = ClusterEvent(ASSIGNED_POD, ADD, "AssignedPodAdd")
EVENT_ASSIGNED_POD_DELETE = ClusterEvent(ASSIGNED_POD, DELETE, "AssignedPodDelete")
EVENT_NODE_ADD = ClusterEvent(NODE, ADD, "NodeAdd")
EVENT_NODE_DELETE = ClusterEvent(NODE, DELETE, "NodeDelete")
EVENT_NODE_ALLOCATABLE = ClusterEvent(NODE, UPDATE_NODE_ALLOCATABLE, "NodeAllocatable")
EVENT_NODE_LABEL = ClusterEvent(NODE, UPDATE_NODE_LABEL, "NodeLabel")
EVENT_NODE_TAINT = ClusterEvent(NODE, UPDATE_NODE_TAINT, "NodeTaint")
EVENT_POD_GROUP_ADD = ClusterEvent(POD_GROUP, ADD, "PodGroupAdd")
