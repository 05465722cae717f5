"""InterPodAffinity: pod↔pod (anti)affinity over topology domains.

Reference: pkg/scheduler/framework/plugins/interpodaffinity/ — PreFilter builds
topologyToMatchedTermCount maps (filtering.go:91-185) by scanning
HavePodsWithAffinityList; Filter is 3 predicate checks (filtering.go:352-412);
Score sums weighted preferred-term matches over existing pods
(scoring.go:81-257).

The domain-count preaggregation (NOT naive pods x pods) is exactly the shape
the TPU kernel uses: match vectors over existing pods segment-summed into
(term, domain) counts. A copy of the reference package's module.
"""

from __future__ import annotations

from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint
from ..framework.interface import MAX_NODE_SCORE, Plugin, Status
from ..nodeinfo import AffinityTerm, NodeInfo, PodInfo

TopoPair = tuple[str, str]  # (topology key, value)


class _PreFilterState:
    __slots__ = (
        "pod_info",
        "existing_anti_counts",
        "affinity_counts",
        "anti_affinity_counts",
    )

    def __init__(self):
        self.pod_info: PodInfo | None = None
        # (key,value) -> count of existing pods whose required anti-affinity
        # terms match the incoming pod in that domain
        self.existing_anti_counts: dict[TopoPair, int] = {}
        # per incoming required affinity term index: (key,value) -> match count
        self.affinity_counts: list[dict[TopoPair, int]] = []
        self.anti_affinity_counts: list[dict[TopoPair, int]] = []

    def clone(self):
        s = _PreFilterState()
        s.pod_info = self.pod_info
        s.existing_anti_counts = dict(self.existing_anti_counts)
        s.affinity_counts = [dict(d) for d in self.affinity_counts]
        s.anti_affinity_counts = [dict(d) for d in self.anti_affinity_counts]
        return s


def _topo_pairs(node, term: AffinityTerm) -> TopoPair | None:
    val = node.meta.labels.get(term.topology_key)
    return (term.topology_key, val) if val is not None else None


class InterPodAffinity(Plugin):
    name = "InterPodAffinity"
    PRE_FILTER_KEY = "PreFilterInterPodAffinity"
    PRE_SCORE_KEY = "PreScoreInterPodAffinity"

    def __init__(self, ignore_preferred_terms_of_existing_pods: bool = False):
        self.ignore_preferred_existing = ignore_preferred_terms_of_existing_pods

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.POD, ev.ALL)),
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_LABEL)),
        ]

    # -- prefilter -----------------------------------------------------------

    def pre_filter(self, state, pod: Pod, nodes: list[NodeInfo]):
        from ...api.resource import ResourceNames

        pi = PodInfo(pod, ResourceNames())
        aff = pod.spec.affinity
        has_constraints = pi.required_affinity_terms or pi.required_anti_affinity_terms
        s = _PreFilterState()
        s.pod_info = pi

        # existing pods' required anti-affinity vs incoming pod
        # (filtering.go getExistingAntiAffinityCounts — scan only nodes with
        # pods that declare required anti-affinity)
        any_existing_anti = False
        for ni in nodes:
            if ni.pods_with_required_anti_affinity:
                any_existing_anti = True
                break
        if not has_constraints and not any_existing_anti:
            return None, Status.skip()

        for ni in nodes:
            node = ni.node
            if node is None:
                continue
            for epi in ni.pods_with_required_anti_affinity:
                for term in epi.required_anti_affinity_terms:
                    if term.matches(pod):
                        pair = _topo_pairs(node, term)
                        if pair is not None:
                            s.existing_anti_counts[pair] = s.existing_anti_counts.get(pair, 0) + 1

        # incoming pod's required terms vs existing pods
        # (filtering.go getIncomingAffinityAntiAffinityCounts)
        if pi.required_affinity_terms:
            s.affinity_counts = [{} for _ in pi.required_affinity_terms]
        if pi.required_anti_affinity_terms:
            s.anti_affinity_counts = [{} for _ in pi.required_anti_affinity_terms]
        if has_constraints:
            for ni in nodes:
                node = ni.node
                if node is None:
                    continue
                for epi in ni.iter_pods():
                    for ti, term in enumerate(pi.required_affinity_terms):
                        if term.matches(epi.pod):
                            pair = _topo_pairs(node, term)
                            if pair is not None:
                                d = s.affinity_counts[ti]
                                d[pair] = d.get(pair, 0) + 1
                    for ti, term in enumerate(pi.required_anti_affinity_terms):
                        if term.matches(epi.pod):
                            pair = _topo_pairs(node, term)
                            if pair is not None:
                                d = s.anti_affinity_counts[ti]
                                d[pair] = d.get(pair, 0) + 1
        state.write(self.PRE_FILTER_KEY, s)
        return None, Status()

    # -- add/remove pod extensions -------------------------------------------

    def add_pod(self, state, pod, pod_info_to_add: PodInfo, node_info: NodeInfo) -> Status:
        return self._update(state, pod, pod_info_to_add, node_info, +1)

    def remove_pod(self, state, pod, pod_info_to_remove: PodInfo, node_info: NodeInfo) -> Status:
        return self._update(state, pod, pod_info_to_remove, node_info, -1)

    def _update(self, state, pod, epi: PodInfo, node_info: NodeInfo, delta: int) -> Status:
        s: _PreFilterState | None = state.read(self.PRE_FILTER_KEY)
        if s is None or node_info.node is None:
            return Status()
        node = node_info.node
        for term in epi.required_anti_affinity_terms:
            if term.matches(pod):
                pair = _topo_pairs(node, term)
                if pair is not None:
                    s.existing_anti_counts[pair] = s.existing_anti_counts.get(pair, 0) + delta
        pi = s.pod_info
        if pi is not None:
            for ti, term in enumerate(pi.required_affinity_terms):
                if term.matches(epi.pod):
                    pair = _topo_pairs(node, term)
                    if pair is not None and ti < len(s.affinity_counts):
                        d = s.affinity_counts[ti]
                        d[pair] = d.get(pair, 0) + delta
            for ti, term in enumerate(pi.required_anti_affinity_terms):
                if term.matches(epi.pod):
                    pair = _topo_pairs(node, term)
                    if pair is not None and ti < len(s.anti_affinity_counts):
                        d = s.anti_affinity_counts[ti]
                        d[pair] = d.get(pair, 0) + delta
        return Status()

    # -- filter ---------------------------------------------------------------

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        s: _PreFilterState | None = state.read(self.PRE_FILTER_KEY)
        if s is None:
            return Status()
        node = node_info.node
        if node is None:
            return Status.unschedulable("node not found", plugin=self.name)
        pi = s.pod_info

        # 1. existing pods' required anti-affinity reject (filtering.go:352)
        for (key, val), count in s.existing_anti_counts.items():
            if count > 0 and node.meta.labels.get(key) == val:
                return Status.unschedulable(
                    "node(s) had pods with anti-affinity rules rejecting the pod",
                    plugin=self.name,
                )

        # 2. incoming required anti-affinity (filtering.go:389)
        for ti, term in enumerate(pi.required_anti_affinity_terms):
            pair = _topo_pairs(node, term)
            if pair is None:
                continue
            if s.anti_affinity_counts[ti].get(pair, 0) > 0:
                return Status.unschedulable(
                    "node(s) didn't satisfy pod anti-affinity rules", plugin=self.name
                )

        # 3. incoming required affinity (filtering.go:404) — every term must
        # match in this node's domain, unless no pod matches it anywhere and
        # the pod matches its own term (bootstrap case).
        for ti, term in enumerate(pi.required_affinity_terms):
            pair = _topo_pairs(node, term)
            if pair is not None and s.affinity_counts[ti].get(pair, 0) > 0:
                continue
            term_matched_anywhere = any(v > 0 for v in s.affinity_counts[ti].values())
            if not term_matched_anywhere and term.matches(pod):
                continue  # self-match bootstrap
            return Status.unschedulable(
                "node(s) didn't satisfy pod affinity rules", plugin=self.name
            )
        return Status()

    # -- score -----------------------------------------------------------------

    def pre_score(self, state, pod: Pod, nodes: list[NodeInfo]) -> Status:
        from ...api.resource import ResourceNames

        pi = PodInfo(pod, ResourceNames())
        has_preferred = pi.preferred_affinity_terms or pi.preferred_anti_affinity_terms
        if not has_preferred and self.ignore_preferred_existing:
            return Status.skip()
        # (key,value) -> accumulated weight for the incoming pod
        scores: dict[TopoPair, int] = {}

        def accumulate(node, terms, target: Pod, sign: int):
            for weight, term in terms:
                if term.matches(target):
                    val = node.meta.labels.get(term.topology_key)
                    if val is not None:
                        pair = (term.topology_key, val)
                        scores[pair] = scores.get(pair, 0) + sign * weight

        any_existing_affinity = any(ni.pods_with_affinity for ni in nodes)
        if not has_preferred and not any_existing_affinity:
            return Status.skip()

        for ni in nodes:
            node = ni.node
            if node is None:
                continue
            pods = ni.pods_with_affinity if not has_preferred else ni.iter_pods()
            for epi in pods:
                # incoming pod's preferred terms vs existing pod
                accumulate(node, pi.preferred_affinity_terms, epi.pod, +1)
                accumulate(node, pi.preferred_anti_affinity_terms, epi.pod, -1)
                if not self.ignore_preferred_existing:
                    # existing pod's preferred terms vs incoming pod
                    accumulate(node, epi.preferred_affinity_terms, pod, +1)
                    accumulate(node, epi.preferred_anti_affinity_terms, pod, -1)
        if not scores:
            return Status.skip()
        state.write(self.PRE_SCORE_KEY, scores)
        return Status()

    def score(self, state, pod: Pod, node_info: NodeInfo):
        scores = state.read(self.PRE_SCORE_KEY)
        if not scores:
            return 0, Status()
        node = node_info.node
        if node is None:
            return 0, Status()
        total = 0
        for (key, val), weight in scores.items():
            if node.meta.labels.get(key) == val:
                total += weight
        return total, Status()

    def normalize_score(self, state, pod: Pod, scores) -> Status:
        """scoring.go:229 — scale [min,max] -> [0,100] handling negatives."""
        vals = [s for _, s in scores]
        if not vals:
            return Status()
        max_v, min_v = max(vals), min(vals)
        spread = max_v - min_v
        for row in scores:
            if spread == 0:
                row[1] = MAX_NODE_SCORE if max_v > 0 else 0
            else:
                row[1] = MAX_NODE_SCORE * (row[1] - min_v) // spread
        return Status()

    def sign(self, pod: Pod) -> str | None:
        aff = pod.spec.affinity
        if aff is None or (aff.pod_affinity is None and aff.pod_anti_affinity is None):
            return ""
        return repr((aff.pod_affinity, aff.pod_anti_affinity))
