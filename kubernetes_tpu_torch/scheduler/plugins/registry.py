"""In-tree plugin registry and default enablement/weights.

Reference: pkg/scheduler/framework/plugins/registry.go:49-77 and default
plugin set + weights at pkg/scheduler/apis/config/v1/default_plugins.go:29-73
(TaintToleration w3, NodeAffinity w2, PodTopologySpread w2, InterPodAffinity
w2, NodeResourcesFit w1, NodeResourcesBalancedAllocation w1, ImageLocality w1).

A copy of the reference package's registry
(kubernetes_tpu/scheduler/plugins/registry.py:44-100): the same weights,
and the same order and feature gates for the plugins the port has, with
DefaultPreemption last behind its gate (on by default). DefaultBinder,
which binds through a store, is in the list when a store is passed (the
Scheduler passes its own), at the reference's position. Not in the list
yet: VolumeRestrictions, NodeVolumeLimits, VolumeBinding and VolumeZone
(they need the storage API) and DynamicResources (the DRA API), all
ROADMAP A4b. For a pod without volumes or resource claims those plugins
Skip or pass, so the profile decides such pods as the reference's full
one does (tests/test_torch_host_plugins.py holds that).
"""

from __future__ import annotations

from ...api.resource import ResourceNames
from .basics import (
    DefaultBinder,
    ImageLocality,
    NodeName,
    NodePorts,
    NodeUnschedulable,
    PrioritySort,
    SchedulingGates,
    TaintToleration,
)
from .interpod_affinity import InterPodAffinity
from .node_affinity import NodeAffinity
from .node_resources import BalancedAllocation, NodeResourcesFit
from .pod_topology_spread import PodTopologySpread

DEFAULT_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
    "VolumeBinding": 1,
}


def default_plugins(names: ResourceNames, feature_gates=None, args: dict | None = None,
                    store=None):
    """The default-profile plugin list, in extension-point order; with
    DefaultBinder over `store` when one is given."""
    args = args or {}
    fit_args = args.get("NodeResourcesFit", {})
    ipa_args = args.get("InterPodAffinity", {})
    plugins = [
        SchedulingGates(),
        PrioritySort(),
        NodeUnschedulable(),
        NodeName(),
        TaintToleration(),
        NodeAffinity(),
        NodePorts(),
        NodeResourcesFit(
            names,
            scoring_strategy=fit_args.get("strategy", "LeastAllocated"),
            resource_weights=fit_args.get("resources"),
            shape=fit_args.get("shape"),
        ),
        PodTopologySpread(),
        InterPodAffinity(ignore_preferred_terms_of_existing_pods=ipa_args.get(
            "ignorePreferredTermsOfExistingPods", False)),
        BalancedAllocation(names),
        ImageLocality(),
    ]
    if store is not None:
        plugins.append(DefaultBinder(store))
    gates = feature_gates or {}
    if gates.get("NodeDeclaredFeatures", True):
        from .node_declared_features import NodeDeclaredFeatures

        # filters before NodeResourcesFit (default_plugins.go gated adds)
        idx = next(i for i, p in enumerate(plugins)
                   if p.name == "NodeResourcesFit")
        plugins.insert(idx, NodeDeclaredFeatures())
    if gates.get("GangScheduling", True):
        from .gang_scheduling import GangScheduling

        plugins.insert(1, GangScheduling())
    if gates.get("TopologyAwareWorkloadScheduling", True):
        from .topology_placement import TopologyPlacementGenerator

        plugins.append(TopologyPlacementGenerator())
    if gates.get("DefaultPreemption", True):
        from .default_preemption import DefaultPreemption

        plugins.append(DefaultPreemption(names))
    return plugins
