"""NodeAffinity plugin: required selector filter + preferred-term scoring.

Reference: pkg/scheduler/framework/plugins/nodeaffinity/node_affinity.go
(PreFilter:159 with single-node fast path, Filter:218, Score:272).
A copy of the reference package's module.
"""

from __future__ import annotations

from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint
from ..framework.interface import Plugin, PreFilterResult, Status
from ..nodeinfo import NodeInfo

_FIELD_HOSTNAME = "metadata.name"


def _node_fields(node) -> dict[str, str]:
    return {_FIELD_HOSTNAME: node.meta.name}


def _required_matches(pod: Pod, node) -> bool:
    # spec.nodeSelector: all labels must match
    for k, v in pod.spec.node_selector.items():
        if node.meta.labels.get(k) != v:
            return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required is not None:
        return aff.node_affinity.required.matches(node.meta.labels, _node_fields(node))
    return True


class NodeAffinity(Plugin):
    name = "NodeAffinity"
    PRE_SCORE_KEY = "PreScoreNodeAffinity"

    def __init__(self, added_affinity=None):
        # per-profile AddedAffinity (NodeAffinityArgs)
        self.added_affinity = added_affinity

    def events_to_register(self):
        return [ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_LABEL))]

    def pre_filter(self, state, pod: Pod, nodes):
        """Single-node-name fast path: In(metadata.name, [n]) narrows the node
        set without touching other nodes (node_affinity.go:159)."""
        aff = pod.spec.affinity
        has_required = (
            aff is not None
            and aff.node_affinity is not None
            and aff.node_affinity.required is not None
        )
        if not pod.spec.node_selector and not has_required:
            return None, Status.skip()
        if has_required:
            terms = aff.node_affinity.required.terms
            node_names: set[str] | None = set()
            for term in terms:
                term_names = None
                for req in term.match_fields:
                    if req.key == _FIELD_HOSTNAME and req.operator == "In":
                        term_names = set(req.values)
                if term_names is None:
                    node_names = None  # this OR-branch matches arbitrary nodes
                    break
                node_names |= term_names
            if node_names is not None:
                return PreFilterResult(node_names), Status()
        return None, Status()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        node = node_info.node
        if node is None:
            return Status.unschedulable("node not found", plugin=self.name)
        if self.added_affinity is not None and not self.added_affinity.matches(
            node.meta.labels, _node_fields(node)
        ):
            return Status.unresolvable(
                "node(s) didn't match scheduler-enforced node affinity", plugin=self.name
            )
        if not _required_matches(pod, node):
            return Status.unresolvable(
                "node(s) didn't match Pod's node affinity/selector", plugin=self.name
            )
        return Status()

    def pre_score(self, state, pod: Pod, nodes) -> Status:
        aff = pod.spec.affinity
        preferred = (
            list(aff.node_affinity.preferred)
            if aff and aff.node_affinity
            else []
        )
        if not preferred:
            return Status.skip()
        state.write(self.PRE_SCORE_KEY, preferred)
        return Status()

    def score(self, state, pod: Pod, node_info: NodeInfo):
        preferred = state.read(self.PRE_SCORE_KEY) or []
        node = node_info.node
        if node is None:
            return 0, Status()
        total = 0
        for term in preferred:
            if term.preference.matches(node.meta.labels, _node_fields(node)):
                total += term.weight
        return total, Status()

    def normalize_score(self, state, pod: Pod, scores) -> Status:
        from ..framework.interface import MAX_NODE_SCORE

        max_score = max((s for _, s in scores), default=0)
        if max_score == 0:
            return Status()
        for row in scores:
            row[1] = row[1] * MAX_NODE_SCORE // max_score
        return Status()

    def sign(self, pod: Pod) -> str | None:
        """Canonical fragment for pod signatures (signers.go)."""
        parts = [f"{k}={v}" for k, v in sorted(pod.spec.node_selector.items())]
        aff = pod.spec.affinity
        if aff and aff.node_affinity:
            parts.append(repr(aff.node_affinity))
        return ";".join(parts)
