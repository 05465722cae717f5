"""PodTopologySpread: maxSkew filter + normalized spreading score.

Reference: pkg/scheduler/framework/plugins/podtopologyspread/ — PreFilter
builds per-(topologyKey,value) match counts with two-minimum criticalPaths
(filtering.go:97,237); Filter enforces `count + selfMatch - min <= maxSkew`
(filtering.go:314); Score computes per-domain counts weighted by
topologyNormalizingWeight = log(domains+2) (scoring.go:118-305). Cluster
defaults (SystemDefaulting, plugin.go:46-60): zone + hostname ScheduleAnyway.

A copy of the reference package's module. Its score's log weight,
np.log(np.float32(domains + 2)), is the one the port's kernels use
(ops/kernels.py log_weight_table): the bit-exact contract names it.
"""

from __future__ import annotations

import numpy as np

from ...api.labels import LabelSelector
from ...api.types import (
    DO_NOT_SCHEDULE,
    SCHEDULE_ANYWAY,
    Pod,
    TopologySpreadConstraint,
)
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint
from ..framework.interface import MAX_NODE_SCORE, Plugin, Status
from ..nodeinfo import NodeInfo, PodInfo

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"

_SYSTEM_DEFAULT_CONSTRAINTS = (
    TopologySpreadConstraint(3, HOSTNAME_LABEL, SCHEDULE_ANYWAY, None),
    TopologySpreadConstraint(5, ZONE_LABEL, SCHEDULE_ANYWAY, None),
)


class _MatchNothing:
    """nil labelSelector on an explicit constraint selects no pods (k8s
    LabelSelectorAsSelector semantics)."""

    def matches(self, labels) -> bool:
        return False

    def canonical(self) -> str:
        return "<nothing>"


_MATCH_NOTHING = _MatchNothing()


def _self_selector(pod: Pod, c: TopologySpreadConstraint):
    return c.label_selector if c.label_selector is not None else _MATCH_NOTHING


class _PreFilterState:
    __slots__ = ("constraints", "domain_counts", "min_counts", "self_matches")

    def __init__(self):
        self.constraints: list[TopologySpreadConstraint] = []
        # per-constraint: {domain value: count of matching pods}
        self.domain_counts: list[dict[str, int]] = []
        self.min_counts: list[int] = []
        self.self_matches: list[int] = []

    def clone(self):
        s = _PreFilterState()
        s.constraints = self.constraints
        s.domain_counts = [dict(d) for d in self.domain_counts]
        s.min_counts = list(self.min_counts)
        s.self_matches = list(self.self_matches)
        return s

    def recompute_min(self, i: int) -> None:
        d = self.domain_counts[i]
        self.min_counts[i] = min(d.values()) if d else 0


class PodTopologySpread(Plugin):
    name = "PodTopologySpread"
    PRE_FILTER_KEY = "PreFilterPodTopologySpread"
    PRE_SCORE_KEY = "PreScorePodTopologySpread"

    def __init__(self, default_constraints=None, system_defaulting: bool = True):
        self.default_constraints = tuple(default_constraints or ())
        self.system_defaulting = system_defaulting

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.POD, ev.ADD | ev.DELETE | ev.UPDATE_POD_LABEL)),
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_LABEL | ev.DELETE)),
        ]

    # -- constraint selection ----------------------------------------------

    def _constraints_for(self, pod: Pod, action: str) -> list[TopologySpreadConstraint]:
        explicit = [
            c for c in pod.spec.topology_spread_constraints if c.when_unsatisfiable == action
        ]
        if pod.spec.topology_spread_constraints:
            return explicit
        defaults = self.default_constraints or (
            _SYSTEM_DEFAULT_CONSTRAINTS if self.system_defaulting else ()
        )
        out = []
        for c in defaults:
            if c.when_unsatisfiable != action:
                continue
            sel = c.label_selector or LabelSelector.of(dict(pod.meta.labels))
            out.append(
                TopologySpreadConstraint(c.max_skew, c.topology_key, c.when_unsatisfiable, sel)
            )
        return out

    # -- prefilter: build domain counts -------------------------------------

    def pre_filter(self, state, pod: Pod, nodes: list[NodeInfo]):
        constraints = self._constraints_for(pod, DO_NOT_SCHEDULE)
        if not constraints:
            return None, Status.skip()
        s = _PreFilterState()
        s.constraints = constraints
        for c in constraints:
            sel = _self_selector(pod, c)
            counts: dict[str, int] = {}
            for ni in nodes:
                node = ni.node
                if node is None:
                    continue
                val = node.meta.labels.get(c.topology_key)
                if val is None:
                    continue  # nodes without the key are not domains
                # node-affinity honored domains (filtering.go: nodeaffinity check)
                counts.setdefault(val, 0)
                for pi in ni.iter_pods():
                    if pi.pod.meta.namespace != pod.meta.namespace:
                        continue
                    if pi.pod.is_terminating:
                        continue
                    if sel.matches(pi.pod.meta.labels):
                        counts[val] += 1
            s.domain_counts.append(counts)
            s.min_counts.append(min(counts.values()) if counts else 0)
            s.self_matches.append(1 if sel.matches(pod.meta.labels) else 0)
        state.write(self.PRE_FILTER_KEY, s)
        return None, Status()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        s: _PreFilterState | None = state.read(self.PRE_FILTER_KEY)
        if s is None:
            return Status()
        node = node_info.node
        if node is None:
            return Status.unschedulable("node not found", plugin=self.name)
        for i, c in enumerate(s.constraints):
            val = node.meta.labels.get(c.topology_key)
            if val is None:
                return Status.unresolvable(
                    f"node(s) didn't have required label {c.topology_key}", plugin=self.name
                )
            count = s.domain_counts[i].get(val, 0)
            skew = count + s.self_matches[i] - s.min_counts[i]
            if skew > c.max_skew:
                return Status.unschedulable(
                    "node(s) didn't match pod topology spread constraints",
                    plugin=self.name,
                )
        return Status()

    # -- AddPod/RemovePod extensions (nominated pods, preemption dry-runs) ---

    def add_pod(self, state, pod: Pod, pod_info_to_add: PodInfo, node_info: NodeInfo) -> Status:
        return self._update(state, pod, pod_info_to_add, node_info, +1)

    def remove_pod(self, state, pod: Pod, pod_info_to_remove: PodInfo, node_info: NodeInfo) -> Status:
        return self._update(state, pod, pod_info_to_remove, node_info, -1)

    def _update(self, state, pod, pi: PodInfo, node_info: NodeInfo, delta: int) -> Status:
        s: _PreFilterState | None = state.read(self.PRE_FILTER_KEY)
        if s is None or node_info.node is None:
            return Status()
        for i, c in enumerate(s.constraints):
            val = node_info.node.meta.labels.get(c.topology_key)
            if val is None or val not in s.domain_counts[i]:
                continue
            if pi.pod.meta.namespace != pod.meta.namespace:
                continue
            if _self_selector(pod, c).matches(pi.pod.meta.labels):
                s.domain_counts[i][val] += delta
                s.recompute_min(i)
        return Status()

    # -- score ---------------------------------------------------------------

    def pre_score(self, state, pod: Pod, nodes: list[NodeInfo]) -> Status:
        constraints = self._constraints_for(pod, SCHEDULE_ANYWAY)
        if not constraints:
            return Status.skip()
        per_constraint: list[tuple[TopologySpreadConstraint, dict[str, int], int]] = []
        for c in constraints:
            sel = _self_selector(pod, c)
            counts: dict[str, int] = {}
            for ni in nodes:
                node = ni.node
                if node is None:
                    continue
                val = node.meta.labels.get(c.topology_key)
                if val is None:
                    continue
                counts.setdefault(val, 0)
                for pi in ni.iter_pods():
                    if (
                        pi.pod.meta.namespace == pod.meta.namespace
                        and not pi.pod.is_terminating
                        and sel.matches(pi.pod.meta.labels)
                    ):
                        counts[val] += 1
            per_constraint.append((c, counts, 1 if sel.matches(pod.meta.labels) else 0))
        state.write(self.PRE_SCORE_KEY, per_constraint)
        return Status()

    def score(self, state, pod: Pod, node_info: NodeInfo):
        """scoring.go:221 — lower matching count on the node's domains = better;
        raw score here is the *cost*, inverted in normalize."""
        per_constraint = state.read(self.PRE_SCORE_KEY)
        if not per_constraint:
            return 0, Status()
        node = node_info.node
        if node is None:
            return 0, Status()
        # float32 fixed op order — the canonical spec mirrored by the device
        # kernels (ops/kernels.py log_weight_table); math.log would be
        # float64 and could truncate differently at int() boundaries.
        cost = np.float32(0.0)
        for c, counts, _self_match in per_constraint:
            val = node.meta.labels.get(c.topology_key)
            if val is None:
                continue
            count = counts.get(val, 0)
            ndomains = len(counts)
            # topologyNormalizingWeight (scoring.go:305)
            weight = np.log(np.float32(ndomains + 2))
            cost = cost + np.float32(count) * weight
        return int(cost), Status()

    def normalize_score(self, state, pod: Pod, scores) -> Status:
        """scoring.go:262 — invert: maxCost -> 0, minCost -> 100."""
        vals = [s for _, s in scores]
        if not vals:
            return Status()
        max_cost, min_cost = max(vals), min(vals)
        spread = max_cost - min_cost
        for row in scores:
            if spread == 0:
                row[1] = MAX_NODE_SCORE
            else:
                row[1] = MAX_NODE_SCORE * (max_cost - row[1]) // spread
        return Status()

    def sign(self, pod: Pod) -> str | None:
        cs = pod.spec.topology_spread_constraints
        return ";".join(
            f"{c.topology_key}:{c.max_skew}:{c.when_unsatisfiable}:"
            f"{c.label_selector.canonical() if c.label_selector else ''}"
            for c in cs
        )
