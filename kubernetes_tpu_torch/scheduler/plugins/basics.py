"""Small in-tree plugins: PrioritySort, NodeName, NodeUnschedulable, NodePorts,
SchedulingGates, TaintToleration, ImageLocality, DefaultBinder.

Reference: pkg/scheduler/framework/plugins/{queuesort,nodename,
nodeunschedulable,nodeports,schedulinggates,tainttoleration,imagelocality,
defaultbinder}. A copy of the reference package's module.
"""

from __future__ import annotations

from ...api.types import NO_SCHEDULE, PREFER_NO_SCHEDULE, Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE, QUEUE_SKIP
from ..framework.interface import MAX_NODE_SCORE, Plugin, Status
from ..nodeinfo import NodeInfo


class PrioritySort(Plugin):
    """queuesort/priority_sort.go — priority desc, then queue-entry time asc."""

    name = "PrioritySort"

    def less(self, a, b) -> bool:
        pa, pb = a.pod.spec.priority, b.pod.spec.priority
        if pa != pb:
            return pa > pb
        return a.timestamp < b.timestamp


class NodeName(Plugin):
    """nodename/node_name.go:79 — spec.nodeName equality."""

    name = "NodeName"

    def events_to_register(self):
        return [ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD))]

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        if pod.spec.node_name and pod.spec.node_name != node_info.name:
            return Status.unresolvable("node didn't match the requested node name", plugin=self.name)
        return Status()


class NodeUnschedulable(Plugin):
    """nodeunschedulable/node_unschedulable.go:142 — spec.unschedulable with
    toleration escape hatch."""

    name = "NodeUnschedulable"
    TAINT_KEY = "node.kubernetes.io/unschedulable"

    def events_to_register(self):
        def hint(pod, old, new):
            if new is not None and not new.spec.unschedulable:
                return QUEUE
            return QUEUE_SKIP

        return [
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_TAINT), hint)
        ]

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        if node is not None and node.spec.unschedulable:
            tolerated = any(
                t.key in (self.TAINT_KEY, "") and t.operator == "Exists"
                for t in pod.spec.tolerations
            )
            if not tolerated:
                return Status.unresolvable("node(s) were unschedulable", plugin=self.name)
        return Status()


class NodePorts(Plugin):
    """nodeports/node_ports.go — host-port conflict check vs NodeInfo.UsedPorts."""

    name = "NodePorts"
    PRE_FILTER_KEY = "PreFilterNodePorts"

    def events_to_register(self):
        return [ClusterEventWithHint(ClusterEvent(ev.POD, ev.DELETE))]

    def sign(self, pod: Pod) -> str | None:
        """signers.go PortsSigner — host-port demands key the signature."""
        ports = sorted(
            (p.host_ip, p.protocol, p.host_port)
            for c in pod.spec.containers for p in c.ports if p.host_port > 0
        )
        return ";".join(f"{ip}:{proto}:{port}" for ip, proto, port in ports)

    def pre_filter(self, state, pod: Pod, nodes):
        ports = []
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    ports.append((p.host_ip or "0.0.0.0", p.protocol, p.host_port))
        if not ports:
            return None, Status.skip()
        state.write(self.PRE_FILTER_KEY, ports)
        return None, Status()

    @staticmethod
    def _conflict(want: tuple[str, str, int], used: dict) -> bool:
        ip, proto, port = want
        for (uip, uproto, uport) in used:
            if uport != port or uproto != proto:
                continue
            if ip == "0.0.0.0" or uip == "0.0.0.0" or uip == ip:
                return True
        return False

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        ports = state.read(self.PRE_FILTER_KEY)
        if not ports:
            return Status()
        for want in ports:
            if self._conflict(want, node_info.used_ports):
                return Status.unschedulable(
                    "node(s) didn't have free ports for the requested pod ports",
                    plugin=self.name,
                )
        return Status()


class SchedulingGates(Plugin):
    """schedulinggates — PreEnqueue gate on spec.schedulingGates."""

    name = "SchedulingGates"

    def events_to_register(self):
        def hint(pod, old, new):
            if new is not None and not new.spec.scheduling_gates:
                return QUEUE
            return QUEUE_SKIP

        return [
            ClusterEventWithHint(
                ClusterEvent(ev.POD, ev.UPDATE_POD_SCHEDULING_GATES_ELIMINATED), hint
            )
        ]

    def pre_enqueue(self, pod: Pod) -> Status:
        if pod.spec.scheduling_gates:
            return Status.unresolvable(
                f"waiting for scheduling gates: {list(pod.spec.scheduling_gates)}",
                plugin=self.name,
            )
        return Status()


class TaintToleration(Plugin):
    """tainttoleration/taint_toleration.go — Filter on NoSchedule/NoExecute,
    Score counts intolerable PreferNoSchedule taints (inverted)."""

    name = "TaintToleration"
    PRE_SCORE_KEY = "PreScoreTaintToleration"

    def events_to_register(self):
        return [ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_TAINT))]

    def sign(self, pod: Pod) -> str | None:
        """signers.go TolerationsSigner — pods differing in tolerations must
        not share a batch signature."""
        return ";".join(
            f"{t.key}:{t.operator}:{t.value}:{t.effect}"
            for t in sorted(pod.spec.tolerations, key=lambda t: (t.key, t.effect))
        )

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        if node is None:
            return Status()
        for taint in node.spec.taints:
            if taint.effect not in (NO_SCHEDULE, "NoExecute"):
                continue
            if not any(t.tolerates(taint) for t in pod.spec.tolerations):
                return Status.unresolvable(
                    f"node(s) had untolerated taint {{{taint.key}: {taint.value}}}",
                    plugin=self.name,
                )
        return Status()

    def pre_score(self, state, pod: Pod, nodes) -> Status:
        tolerations = [t for t in pod.spec.tolerations if t.effect in ("", PREFER_NO_SCHEDULE)]
        state.write(self.PRE_SCORE_KEY, tolerations)
        return Status()

    def score(self, state, pod: Pod, node_info: NodeInfo):
        tolerations = state.read(self.PRE_SCORE_KEY) or []
        node = node_info.node
        count = 0
        if node is not None:
            for taint in node.spec.taints:
                if taint.effect == PREFER_NO_SCHEDULE and not any(
                    t.tolerates(taint) for t in tolerations
                ):
                    count += 1
        return count, Status()

    def normalize_score(self, state, pod: Pod, scores) -> Status:
        """Invert: fewer intolerable taints -> higher score (:180-215)."""
        max_count = max((s for _, s in scores), default=0)
        for row in scores:
            if max_count > 0:
                row[1] = MAX_NODE_SCORE - (row[1] * MAX_NODE_SCORE) // max_count
            else:
                row[1] = MAX_NODE_SCORE
        return Status()


class ImageLocality(Plugin):
    """imagelocality/image_locality.go — score by present image bytes, scaled
    into [23MB, 1GB * containers] (:34-35,93-105)."""

    name = "ImageLocality"
    # KiB units (matching the device kernel's int32 math; < 1 score point of
    # rounding vs the reference's byte thresholds image_locality.go:34-35)
    MIN_THRESHOLD = 23 * 1024
    MAX_CONTAINER_THRESHOLD = 1024 * 1024

    def score(self, state, pod: Pod, node_info: NodeInfo):
        total = 0
        for c in pod.spec.containers:
            if c.image and c.image in node_info.image_sizes:
                total += node_info.image_sizes[c.image] >> 10
        max_threshold = self.MAX_CONTAINER_THRESHOLD * max(len(pod.spec.containers), 1)
        if total < self.MIN_THRESHOLD:
            score = 0
        elif total > max_threshold:
            score = MAX_NODE_SCORE
        else:
            score = (
                MAX_NODE_SCORE
                * (total - self.MIN_THRESHOLD)
                // (max_threshold - self.MIN_THRESHOLD)
            )
        return score, Status()


class DefaultBinder(Plugin):
    """defaultbinder — POST pods/binding against the store."""

    name = "DefaultBinder"

    def __init__(self, store):
        self._store = store

    def bind(self, state, pod: Pod, node_name: str) -> Status:
        from ...store.store import ConflictError, NotFoundError

        try:
            bind_sub = getattr(self._store, "bind_pod", None)
            if bind_sub is not None:
                # the binding subresource, the reference's API shape
                bind_sub(pod.meta.key, node_name)
            else:
                # a RESTStore: the pod written back with its node (PUT)
                cur = self._store.get("Pod", pod.meta.key)
                cur.spec.node_name = node_name
                self._store.update(cur, check_version=False)
        except (NotFoundError, ConflictError) as e:
            return Status.as_error(e, self.name)
        return Status()
