"""TopologyAware placement generation + scoring for pod-group cycles.

Reference: pkg/scheduler/framework/plugins/topologyaware/topology_placement.go
:61-105 (KEP-5732) — partitions the parent placement's nodes by the pod
group's SchedulingConstraints.Topology[0].Key into one Placement per domain,
so the group cycle can try to pack the whole gang into a single topology
domain. The upstream leaves PlacementScore as a TODO
(schedule_one_podgroup.go:569); ours scores a placement by the mean
NodeResourcesFit strategy score of its nodes, so LeastAllocated prefers the
emptiest domain and MostAllocated bin-packs the fullest one that still fits.

A copy of the reference package's plugin. Its handle (framework/runtime.py
Handle) reads PodGroups and bound Pods through `store.try_get`, the live
gang accounting through `cache.pod_group_states` and nodes through
`snapshot`, as the reference's does.
"""

from __future__ import annotations

from ...api.types import Pod
from ..cache.snapshot import Placement
from ..framework.interface import Plugin, Status


class TopologyPlacementGenerator(Plugin):
    name = "TopologyPlacementGenerator"

    def __init__(self, handle=None):
        self.handle = handle

    def set_handle(self, handle) -> None:
        self.handle = handle

    def _group_of(self, pod: Pod):
        sg = pod.spec.scheduling_group
        if sg is None or self.handle is None:
            return None
        gk = f"{pod.meta.namespace}/{sg.pod_group_name}"
        return self.handle.store.try_get("PodGroup", gk)

    def topology_mode(self, pods: list[Pod]) -> str | None:
        """"Required" | "Preferred" | None when the group has no topology
        constraint (drives whether a no-fitting-domain gang fails or falls
        back to all nodes)."""
        group = self._group_of(pods[0]) if pods else None
        if group is None or not group.spec.constraints.topology:
            return None
        return group.spec.constraints.topology[0].mode

    def _scheduled_pods_domain(self, pods: list[Pod], key: str):
        """requiredDomain (topology_placement.go:74-93
        getScheduledPodsTopologyDomain): a partially-scheduled gang is
        pinned to the single domain its already-scheduled members occupy.
        Returns (domain | None, error Status | None)."""
        sg = pods[0].spec.scheduling_group if pods else None
        if sg is None:
            return None, None
        gk = f"{pods[0].meta.namespace}/{sg.pod_group_name}"
        gstate = self.handle.cache.pod_group_states.get(gk)
        if gstate is None or not gstate.scheduled:
            return None, None
        snapshot = self.handle.snapshot
        domain = None
        for pod_key in sorted(gstate.scheduled):
            pod = self.handle.store.try_get("Pod", pod_key)
            if pod is None or not pod.spec.node_name:
                continue
            ni = snapshot.get(pod.spec.node_name)
            node = ni.node if ni is not None else None
            if node is None:
                continue
            val = node.meta.labels.get(key)
            if val is None:
                return None, Status.as_error(RuntimeError(
                    f"no topology domain found for scheduled pod {pod_key}"
                ), self.name)
            if domain is not None and domain != val:
                return None, Status.as_error(RuntimeError(
                    f"more than 1 domain for pod group {gk}: {domain}, {val}"
                ), self.name)
            domain = val
        return domain, None

    def generate_placements(self, state, pods: list[Pod], placements):
        """topology_placement.go:61-105 — one child placement per domain
        value of the group's first topology key, in sorted value order; a
        partially-scheduled gang only gets its scheduled members' domain
        (requiredDomain, :74-93), so an incremental gang cannot split."""
        group = self._group_of(pods[0]) if pods else None
        if group is None or not group.spec.constraints.topology:
            return placements, Status.skip()
        key = group.spec.constraints.topology[0].key
        required_domain, err = self._scheduled_pods_domain(pods, key)
        if err is not None:
            return placements, err
        snapshot = self.handle.snapshot
        out: list[Placement] = []
        for parent in placements:
            domains: dict[str, list[str]] = {}
            for name in parent.node_names:
                ni = snapshot.get(name)
                node = ni.node if ni is not None else None
                if node is None:
                    continue
                val = node.meta.labels.get(key)
                if val is not None and (required_domain is None
                                        or val == required_domain):
                    domains.setdefault(val, []).append(name)
            for val in sorted(domains):
                out.append(Placement(f"{parent.name}/{key}={val}", domains[val]))
        if not out and required_domain is not None:
            # the pinned domain has no candidate nodes left: with Required
            # topology the gang must not land elsewhere — an empty
            # placement makes the dry-run fail cleanly
            return [Placement(f"{key}={required_domain}", [])], Status()
        if not out:
            return placements, Status.skip()
        return out, Status()

    def score_placement(self, state, pods: list[Pod], placement) -> tuple[int, Status]:
        """Mean free-capacity score (0-100) of the placement's nodes under
        the LeastAllocated shape: emptier domains score higher, giving the
        gang headroom; deterministic tie-break is placement order."""
        snapshot = self.handle.snapshot
        total = 0
        n = 0
        for name in placement.node_names:
            ni = snapshot.get(name)
            if ni is None or ni.node is None:
                continue
            score = 0
            parts = 0
            for col in (0, 1):  # cpu, memory plane columns
                cap = ni.allocatable[col]
                if cap <= 0:
                    continue
                used = min(ni.requested[col], cap)
                score += (cap - used) * 100 // cap
                parts += 1
            if parts:
                total += score // parts
                n += 1
        return (total // n if n else 0), Status()
