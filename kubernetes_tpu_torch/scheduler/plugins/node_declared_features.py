"""NodeDeclaredFeatures: pods land only on nodes declaring the features
their spec depends on.

Reference: pkg/scheduler/framework/plugins/nodedeclaredfeatures/
(PreFilter infers the pod's required feature set from its spec via
component-helpers/nodedeclaredfeatures, Filter checks it is a subset of
NodeInfo.GetNodeDeclaredFeatures(); empty requirement set skips). The
reference's inference framework derives requirements from spec shapes
(e.g. pod-level resources); ours mirrors that with an inference table over
the spec fields this framework models, plus the explicit
`features.k8s.io/required` annotation as the extensible hook.
A copy of the reference package's module.
"""

from __future__ import annotations

from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE, QUEUE_SKIP
from ..framework.interface import Plugin, Status

REQUIRED_FEATURES_ANNOTATION = "features.k8s.io/required"
_ERR_REASON = "node(s) didn't match Pod's required features"

STATE_KEY = "PreFilterNodeDeclaredFeatures"


def infer_required_features(pod: Pod) -> frozenset[str]:
    """InferForPodScheduling: spec shapes → feature names the node must
    declare. The reference infers from spec fields with node-side feature
    dependencies (e.g. pod-level resources); none of the spec fields this
    framework models carries one yet, so the inference table is currently
    the explicit annotation alone — extend it as fields gain dependencies
    (resource claims deliberately do NOT require a declared feature: device
    fit is the DRA plugin's job, as in the reference)."""
    ann = pod.meta.annotations.get(REQUIRED_FEATURES_ANNOTATION, "")
    if not ann:
        return frozenset()
    return frozenset(f.strip() for f in ann.split(",") if f.strip())


class NodeDeclaredFeatures(Plugin):
    name = "NodeDeclaredFeatures"

    def events_to_register(self):
        def node_hint(pod, old, new):
            if new is None:
                return QUEUE_SKIP
            reqs = infer_required_features(pod)
            declared = set(new.status.declared_features)
            return QUEUE if reqs <= declared else QUEUE_SKIP

        return [ClusterEventWithHint(
            ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE), node_hint
        )]

    def pre_filter(self, state, pod: Pod, nodes):
        reqs = infer_required_features(pod)
        if not reqs:
            return None, Status.skip()
        state.write(STATE_KEY, reqs)
        return None, Status()

    def filter(self, state, pod: Pod, node_info) -> Status:
        reqs = state.read(STATE_KEY)
        if not reqs:
            return Status()
        declared = set(node_info.node.status.declared_features)
        if not (reqs <= declared):
            return Status.unresolvable(_ERR_REASON, plugin=self.name)
        return Status()

    def sign(self, pod: Pod) -> str | None:
        return ",".join(sorted(infer_required_features(pod)))
