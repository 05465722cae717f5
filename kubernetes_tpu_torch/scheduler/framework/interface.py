"""Scheduler-framework public plugin API: status codes and plugin interfaces.

Reference: staging/src/k8s.io/kube-scheduler/framework/interface.go — `Code`
(7 statuses), `Status`, and the extension-point interfaces (PreEnqueue :442,
QueueSort :454, PreFilter :508, Filter :537, PostFilter :566, PreScore :593,
Score :614, Reserve :631, PreBind :647, PostBind :664, Permit :675, Bind :688,
SignPlugin :735, PlacementGenerate :762, PlacementScore :787). Python plugins
implement these by defining the corresponding methods; the runtime discovers
extension points by hasattr (duck typing replaces Go interface assertions).
A copy of the reference package's module
(kubernetes_tpu/scheduler/framework/interface.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from ..nodeinfo import NodeInfo
    from ...api.types import Pod

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0

# --- status codes (interface.go Code) -------------------------------------

SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
UNSCHEDULABLE_AND_UNRESOLVABLE = 3
WAIT = 4
SKIP = 5
PENDING = 6

_CODE_NAMES = {
    SUCCESS: "Success",
    ERROR: "Error",
    UNSCHEDULABLE: "Unschedulable",
    UNSCHEDULABLE_AND_UNRESOLVABLE: "UnschedulableAndUnresolvable",
    WAIT: "Wait",
    SKIP: "Skip",
    PENDING: "Pending",
}


class Status:
    """Plugin result. None is treated as Success everywhere (as in Go)."""

    __slots__ = ("code", "reasons", "plugin", "error")

    def __init__(
        self,
        code: int = SUCCESS,
        reasons: tuple[str, ...] = (),
        plugin: str = "",
        error: Exception | None = None,
    ):
        self.code = code
        self.reasons = reasons
        self.plugin = plugin
        self.error = error

    # constructors mirroring framework.NewStatus / AsStatus
    @classmethod
    def unschedulable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(UNSCHEDULABLE, reasons, plugin)

    @classmethod
    def unresolvable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(UNSCHEDULABLE_AND_UNRESOLVABLE, reasons, plugin)

    @classmethod
    def as_error(cls, err: Exception, plugin: str = "") -> "Status":
        return cls(ERROR, (str(err),), plugin, err)

    @classmethod
    def skip(cls, plugin: str = "") -> "Status":
        return cls(SKIP, (), plugin)

    @classmethod
    def wait(cls, plugin: str = "") -> "Status":
        return cls(WAIT, (), plugin)

    @classmethod
    def pending(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(PENDING, reasons, plugin)

    @property
    def is_success(self) -> bool:
        return self.code == SUCCESS

    @property
    def is_skip(self) -> bool:
        return self.code == SKIP

    @property
    def is_wait(self) -> bool:
        return self.code == WAIT

    @property
    def is_rejected(self) -> bool:
        """Unschedulable family (interface.go IsRejected)."""
        return self.code in (UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE, PENDING)

    @property
    def code_name(self) -> str:
        return _CODE_NAMES.get(self.code, str(self.code))

    def message(self) -> str:
        return "; ".join(self.reasons)

    def __repr__(self) -> str:
        return f"Status({self.code_name}, {self.reasons}, plugin={self.plugin})"


def status_of(s: "Status | None") -> Status:
    return s if s is not None else Status()


# --- results --------------------------------------------------------------


@dataclass
class PreFilterResult:
    """Narrows the candidate node set (interface.go PreFilterResult)."""

    node_names: set[str] | None = None  # None = all nodes

    def merge(self, other: "PreFilterResult") -> "PreFilterResult":
        if self.node_names is None:
            return PreFilterResult(other.node_names)
        if other.node_names is None:
            return PreFilterResult(self.node_names)
        return PreFilterResult(self.node_names & other.node_names)

    @property
    def all_nodes(self) -> bool:
        return self.node_names is None


@dataclass
class PostFilterResult:
    nominated_node_name: str = ""
    nominating_mode: str = "ModeOverride"  # ModeNoop | ModeOverride


@dataclass
class NodeScore:
    name: str
    score: int


@dataclass
class NodePluginScores:
    name: str
    scores: list[tuple[str, int]] = field(default_factory=list)  # (plugin, weighted)
    total_score: int = 0


@dataclass
class NodeToStatus:
    """Per-node filter failure map with an absent-node default.

    Reference: framework/types.go NodeToStatus — preemption needs to know
    whether unlisted nodes were rejected as Unschedulable (retriable by
    removing victims) or UnschedulableAndUnresolvable.
    """

    node_to_status: dict[str, Status] = field(default_factory=dict)
    absent_nodes_status: Status = field(default_factory=lambda: Status(UNSCHEDULABLE_AND_UNRESOLVABLE))

    def get(self, node_name: str) -> Status:
        return self.node_to_status.get(node_name, self.absent_nodes_status)

    def set(self, node_name: str, status: Status) -> None:
        self.node_to_status[node_name] = status

    def aggregate_reasons(self) -> dict[str, int]:
        """reason string -> node count (FitError's message body). Subclasses
        backed by dense kernel rows aggregate vectorized instead of
        materializing a Status per node."""
        reasons: dict[str, int] = {}
        for st in self.node_to_status.values():
            for r in st.reasons:
                reasons[r] = reasons.get(r, 0) + 1
        return reasons

    def nodes_with_code(self, code: int, snapshot) -> list:
        out = []
        for ni in snapshot.list_nodes():
            if self.get(ni.name).code == code:
                out.append(ni)
        return out


class FitError(Exception):
    """Scheduling failed: no node fits (framework/types.go FitError)."""

    def __init__(self, pod, num_all_nodes: int, diagnosis: "Diagnosis"):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.diagnosis = diagnosis
        # message building is LAZY (__str__): a preemption-heavy workload
        # raises a FitError per pod per attempt, and walking every node's
        # status to format a message nobody may read was a top cost
        super().__init__()

    def __str__(self) -> str:
        return self.error_message()

    def error_message(self) -> str:
        reasons = self.diagnosis.node_to_status.aggregate_reasons()
        parts = [f"{n} {r}" for r, n in sorted(reasons.items())]
        return (
            f"0/{self.num_all_nodes} nodes are available: {', '.join(parts) or 'none'}"
        )


@dataclass
class Diagnosis:
    node_to_status: NodeToStatus = field(default_factory=NodeToStatus)
    unschedulable_plugins: set[str] = field(default_factory=set)
    pending_plugins: set[str] = field(default_factory=set)
    pre_filter_msg: str = ""
    post_filter_msg: str = ""


@dataclass
class ScheduleResult:
    suggested_host: str = ""
    evaluated_nodes: int = 0
    feasible_nodes: int = 0
    nominating_info: PostFilterResult | None = None


class Plugin:
    """Base plugin. Subclasses define extension-point methods:

    - pre_enqueue(pod) -> Status
    - less(pod_info_a, pod_info_b) -> bool                       (QueueSort)
    - events_to_register() -> list[ClusterEventWithHint]
    - pre_filter(state, pod, nodes) -> (PreFilterResult|None, Status)
    - pre_filter_extensions() -> self | None  (add_pod/remove_pod)
    - filter(state, pod, node_info) -> Status
    - post_filter(state, pod, node_to_status) -> (PostFilterResult|None, Status)
    - pre_score(state, pod, nodes) -> Status
    - score(state, pod, node_info) -> (int, Status)
    - normalize_score(state, pod, scores) -> Status
    - reserve(state, pod, node_name) -> Status / unreserve(...)
    - permit(state, pod, node_name) -> (Status, timeout_seconds)
    - pre_bind(state, pod, node_name) -> Status
    - pre_bind_pre_flight(state, pod, node_name) -> Status
    - bind(state, pod, node_name) -> Status
    - post_bind(state, pod, node_name) -> None
    - sign(pod) -> str | None                                     (SignPlugin)
    - generate_placements(state, pods, parent) -> (list[Placement], Status)
    - score_placement(state, pods, placement) -> (int, Status)
    """

    name = "Plugin"

    def __repr__(self) -> str:
        return self.name


@dataclass
class WaitingPod:
    """A pod parked at Permit (runtime/waiting_pods_map.go). Deciders
    (allow/reject) signal the condition so WaitOnPermit blocks on a real
    wakeup instead of polling (framework.go:2034 blocks on a channel)."""

    pod: Any
    pending_plugins: dict[str, float] = field(default_factory=dict)  # plugin -> deadline
    decision: Status | None = None

    def __post_init__(self):
        import threading

        self._cond = threading.Condition()

    def allow(self, plugin: str) -> None:
        with self._cond:
            self.pending_plugins.pop(plugin, None)
            if not self.pending_plugins and self.decision is None:
                self.decision = Status()
            self._cond.notify_all()

    def reject(self, plugin: str, msg: str) -> None:
        with self._cond:
            self.decision = Status.unschedulable(msg, plugin=plugin)
            self._cond.notify_all()

    def wait_for_decision(self, timeout: float) -> Status | None:
        """Block until a decision lands or timeout elapses."""
        with self._cond:
            if self.decision is None and timeout > 0:
                self._cond.wait(timeout)
            return self.decision
