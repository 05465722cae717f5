"""Scheduler-framework result types: status codes, Status, the per-node
failure map, FitError, ScheduleResult and the Plugin base.

Reference: staging/src/k8s.io/kube-scheduler/framework/interface.go (`Code`,
`Status`) and pkg/scheduler/framework/types.go (NodeToStatus, FitError,
Diagnosis). A trimmed copy: of the plugin extension points only the
placement ones (gang scheduling) have a caller in the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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

    @property
    def is_success(self) -> bool:
        return self.code == SUCCESS

    @property
    def is_skip(self) -> bool:
        return self.code == SKIP

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
class NodeToStatus:
    """Per-node filter failure map with an absent-node default.

    Reference: framework/types.go NodeToStatus — preemption needs to know
    whether unlisted nodes were rejected as Unschedulable (retriable by
    removing victims) or UnschedulableAndUnresolvable.
    """

    node_to_status: dict[str, Status] = field(default_factory=dict)
    absent_nodes_status: Status = field(
        default_factory=lambda: Status(UNSCHEDULABLE_AND_UNRESOLVABLE))

    def get(self, node_name: str) -> Status:
        return self.node_to_status.get(node_name, self.absent_nodes_status)

    def set(self, node_name: str, status: Status) -> None:
        self.node_to_status[node_name] = status

    def aggregate_reasons(self) -> dict[str, int]:
        """reason string -> node count (FitError's message body)."""
        reasons: dict[str, int] = {}
        for st in self.node_to_status.values():
            for r in st.reasons:
                reasons[r] = reasons.get(r, 0) + 1
        return reasons


class FitError(Exception):
    """Scheduling failed: no node fits (framework/types.go FitError). The
    message is built lazily (error_message / __str__)."""

    def __init__(self, pod, num_all_nodes: int, diagnosis: "Diagnosis"):
        self.pod = pod
        self.num_all_nodes = num_all_nodes
        self.diagnosis = diagnosis
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


class Plugin:
    """Base plugin. Of the reference's extension points the port calls the
    placement ones (framework/runtime.py):

    - generate_placements(state, pods, parent) -> (list[Placement], Status)
    - score_placement(state, pods, placement) -> (int, Status)
    """

    name = "Plugin"

    def __repr__(self) -> str:
        return self.name
