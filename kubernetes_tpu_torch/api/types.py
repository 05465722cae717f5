"""Core API object types: the Pod, Node, PodGroup and
PodDisruptionBudget subset the port schedules.

Reference: staging/src/k8s.io/api/core/v1/types.go (Pod at :4604, Node, Taint,
Toleration, Affinity, TopologySpreadConstraint). Only the scheduling-relevant
subset is modeled; everything is a plain dataclass, treated as immutable
once written to the store.
"""

from __future__ import annotations

import copy as copy_mod
from dataclasses import dataclass, field
from typing import Mapping

from .labels import LabelSelector, Requirement
from .meta import ObjectMeta

MAX_NODE_SCORE = 100  # staging/.../framework/interface.go MaxNodeScore

# Taint effects
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# TopologySpread whenUnsatisfiable
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

DEFAULT_SCHEDULER_NAME = "default-scheduler"


# --- node selectors / affinity -------------------------------------------


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        return Requirement(self.key, self.operator, tuple(self.values)).matches(labels)


@dataclass(frozen=True)
class NodeSelectorTerm:
    match_expressions: tuple[NodeSelectorRequirement, ...] = ()
    match_fields: tuple[NodeSelectorRequirement, ...] = ()

    def matches(self, node_labels: Mapping[str, str], node_fields: Mapping[str, str]) -> bool:
        return all(r.matches(node_labels) for r in self.match_expressions) and all(
            r.matches(node_fields) for r in self.match_fields
        )


@dataclass(frozen=True)
class NodeSelector:
    """OR of terms (each term an AND). Empty term list matches nothing."""

    terms: tuple[NodeSelectorTerm, ...] = ()

    def matches(self, node_labels: Mapping[str, str], node_fields: Mapping[str, str]) -> bool:
        return any(t.matches(node_labels, node_fields) for t in self.terms)


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required: NodeSelector | None = None
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    label_selector: LabelSelector | None = None
    topology_key: str = ""
    namespaces: tuple[str, ...] = ()  # empty -> pod's own namespace


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required: tuple[PodAffinityTerm, ...] = ()
    preferred: tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: NodeAffinity | None = None
    pod_affinity: PodAffinity | None = None
    pod_anti_affinity: PodAntiAffinity | None = None


# --- taints / tolerations -------------------------------------------------


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty -> all effects

    def tolerates(self, taint: Taint) -> bool:
        """Reference: component-helpers/scheduling/corev1 Toleration.ToleratesTaint."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


# --- topology spread ------------------------------------------------------


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: LabelSelector | None = None
    min_domains: int | None = None


# --- containers / pod -----------------------------------------------------


@dataclass(frozen=True)
class ContainerPort:
    container_port: int
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = "c"
    image: str = ""
    requests: dict[str, object] = field(default_factory=dict)
    ports: tuple[ContainerPort, ...] = ()


@dataclass(frozen=True)
class SchedulingGroup:
    """Gang membership (fork feature GenericWorkload).

    Reference: staging/src/k8s.io/api/core/v1/types.go:4488 — pod.Spec points
    at a PodGroup by name; all members share it.
    """

    pod_group_name: str


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    overhead: dict[str, object] = field(default_factory=dict)
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Affinity | None = None
    tolerations: tuple[Toleration, ...] = ()
    topology_spread_constraints: tuple[TopologySpreadConstraint, ...] = ()
    priority: int = 0
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    scheduling_gates: tuple[str, ...] = ()
    scheduling_group: SchedulingGroup | None = None


@dataclass
class PodCondition:
    type: str  # "PodScheduled", ...
    status: str  # "True"/"False"/"Unknown"
    reason: str = ""
    message: str = ""


@dataclass
class PodStatus:
    """The part of core/v1 PodStatus the scheduler reads and writes: the
    node a preemption nominated for the pod, and the PodScheduled
    condition of a pod that fits nowhere."""

    nominated_node_name: str = ""
    conditions: list[PodCondition] = field(default_factory=list)


@dataclass
class Pod:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind = "Pod"

    @property
    def is_scheduled(self) -> bool:
        return bool(self.spec.node_name)

    @property
    def is_terminating(self) -> bool:
        return self.meta.deletion_timestamp is not None


# --- node -----------------------------------------------------------------


@dataclass(frozen=True)
class ContainerImage:
    names: tuple[str, ...]
    size_bytes: int


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: tuple[Taint, ...] = ()


@dataclass
class NodeStatus:
    capacity: dict[str, object] = field(default_factory=dict)
    allocatable: dict[str, object] = field(default_factory=dict)
    images: list[ContainerImage] = field(default_factory=list)
    # node features the node declares (NodeDeclaredFeatures)
    declared_features: tuple[str, ...] = ()


@dataclass
class Node:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind = "Node"


# --- pod group (gang) -----------------------------------------------------


@dataclass(frozen=True)
class GangPolicy:
    min_count: int = 0


@dataclass(frozen=True)
class TopologyConstraint:
    key: str
    mode: str = "Required"  # Required | Preferred


@dataclass(frozen=True)
class SchedulingConstraints:
    topology: tuple[TopologyConstraint, ...] = ()


@dataclass
class PodGroupSpec:
    policy: GangPolicy = field(default_factory=GangPolicy)
    constraints: SchedulingConstraints = field(default_factory=SchedulingConstraints)


@dataclass
class PodGroupStatus:
    all_pods_count: int = 0
    scheduled_pods_count: int = 0


@dataclass
class PodGroup:
    """Reference: staging/src/k8s.io/api/scheduling/v1alpha2/types.go:191."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)

    kind = "PodGroup"


# --- disruption budgets -----------------------------------------------------


@dataclass
class PodDisruptionBudgetSpec:
    """policy/v1 PodDisruptionBudgetSpec (scheduling-relevant subset).

    Exactly one of min_available / max_unavailable is meaningful; both are
    absolute counts (the reference also accepts percentages, which the
    disruption controller resolves before the scheduler reads them)."""

    selector: LabelSelector | None = None  # None matches nothing
    min_available: int | None = None
    max_unavailable: int | None = None


@dataclass
class PodDisruptionBudgetStatus:
    """policy/v1 PodDisruptionBudgetStatus: the scheduler reads only
    disruptions_allowed and disrupted_pods (default_preemption.go:380
    filterPodsWithPDBViolation)."""

    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0
    # pod name -> eviction time; a disruption already recorded does not
    # count against the budget again
    disrupted_pods: dict = field(default_factory=dict)


@dataclass
class PodDisruptionBudget:
    """Reference: staging/src/k8s.io/api/policy/v1/types.go."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)

    kind = "PodDisruptionBudget"


# --- fast deepcopy hooks --------------------------------------------------
#
# The store isolates what it holds by deepcopying objects on every write
# (store/store.py); generic copy.deepcopy recurses through every field of a
# Pod. These hooks keep the copy semantics while sharing the immutable
# fragments: every frozen dataclass here holds only str/int/tuples of
# frozen values, so returning self is a correct deepcopy.


def _identity_deepcopy(self, memo):
    return self


for _frozen in (
    NodeSelectorRequirement, NodeSelectorTerm, NodeSelector,
    PreferredSchedulingTerm, NodeAffinity, PodAffinityTerm,
    WeightedPodAffinityTerm, PodAffinity, PodAntiAffinity, Affinity,
    Taint, Toleration, TopologySpreadConstraint, ContainerPort,
    SchedulingGroup, ContainerImage, GangPolicy, TopologyConstraint,
    SchedulingConstraints,
):
    _frozen.__deepcopy__ = _identity_deepcopy  # type: ignore[attr-defined]


def _container_deepcopy(self: Container, memo) -> Container:
    # keep in sync with Container's fields: a dropped field would silently
    # truncate every object that passes through the store
    return Container(self.name, self.image, dict(self.requests), self.ports)


def _podspec_deepcopy(self: PodSpec, memo) -> PodSpec:
    s = copy_mod.copy(self)  # shallow: immutable/str fields carried over
    s.containers = [_container_deepcopy(c, memo) for c in self.containers]
    s.init_containers = [_container_deepcopy(c, memo) for c in self.init_containers]
    s.overhead = dict(self.overhead)
    s.node_selector = dict(self.node_selector)
    return s


def _podstatus_deepcopy(self: PodStatus, memo) -> PodStatus:
    s = copy_mod.copy(self)
    s.conditions = [copy_mod.copy(c) for c in self.conditions]
    return s


def _pod_deepcopy(self: Pod, memo) -> Pod:
    return Pod(meta=self.meta.copy(),
               spec=_podspec_deepcopy(self.spec, memo),
               status=_podstatus_deepcopy(self.status, memo))


def _nodestatus_deepcopy(self: NodeStatus, memo) -> NodeStatus:
    s = copy_mod.copy(self)
    s.capacity = dict(self.capacity)
    s.allocatable = dict(self.allocatable)
    s.images = list(self.images)  # ContainerImage is frozen: share entries
    return s


def _node_deepcopy(self: Node, memo) -> Node:
    return Node(meta=self.meta.copy(),
                spec=copy_mod.copy(self.spec),  # taints tuple shared (frozen)
                status=_nodestatus_deepcopy(self.status, memo))


Container.__deepcopy__ = _container_deepcopy  # type: ignore[attr-defined]
PodSpec.__deepcopy__ = _podspec_deepcopy  # type: ignore[attr-defined]
PodStatus.__deepcopy__ = _podstatus_deepcopy  # type: ignore[attr-defined]
Pod.__deepcopy__ = _pod_deepcopy  # type: ignore[attr-defined]
NodeStatus.__deepcopy__ = _nodestatus_deepcopy  # type: ignore[attr-defined]
Node.__deepcopy__ = _node_deepcopy  # type: ignore[attr-defined]
