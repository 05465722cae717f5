"""NodeResources plugins: Fit filter + scoring strategies + BalancedAllocation.

Reference: pkg/scheduler/framework/plugins/noderesources/ — fitsRequest
(fit.go:673-760), LeastAllocated (least_allocated.go:30-52), MostAllocated
(most_allocated.go:30-54), RequestedToCapacityRatio
(requested_to_capacity_ratio.go:31-60), BalancedAllocation
(balanced_allocation.go:204-230), shared scorer resource_allocation.go.

All fit/score arithmetic is integer on plane units, except BalancedAllocation
which is defined as float32 with a fixed op order (host numpy float32 ==
device XLA float32) so host and TPU paths agree bit-for-bit. These formulas
are the canonical spec for the dense kernels in ops/kernels.py — any change
here must be mirrored there (golden tests enforce it).

A copy of the reference package's module: the port's K4 and K2
(ops/csrc/scoring.cuh) mirror these formulas.
"""

from __future__ import annotations

import numpy as np

from ...api.resource import CPU, MEM, PODS, ResourceNames, ResourceVec
from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE, QUEUE_SKIP
from ..framework.interface import MAX_NODE_SCORE, Plugin, Status
from ..nodeinfo import NodeInfo, PodInfo

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"

DEFAULT_RESOURCE_WEIGHTS = {"cpu": 1, "memory": 1}


class NodeResourcesFit(Plugin):
    name = "NodeResourcesFit"
    PRE_FILTER_KEY = "PreFilterNodeResourcesFit"

    def __init__(
        self,
        names: ResourceNames,
        scoring_strategy: str = LEAST_ALLOCATED,
        resource_weights: dict[str, int] | None = None,
        shape: list[tuple[int, int]] | None = None,
        ignored_resources: set[str] | None = None,
    ):
        self.names = names
        self.strategy = scoring_strategy
        self.resource_weights = dict(resource_weights or DEFAULT_RESOURCE_WEIGHTS)
        # RequestedToCapacityRatio shape: (utilization%, score) breakpoints
        self.shape = sorted(shape or [(0, 0), (100, MAX_NODE_SCORE)])
        self.ignored = ignored_resources or set()
        self.handle = None  # wired by the scheduler (ScorePlacement needs it)

    def set_handle(self, handle) -> None:
        self.handle = handle

    # -- events ------------------------------------------------------------

    def events_to_register(self):
        def pod_deleted_hint(pod, old, new):
            return QUEUE if new is None or new.is_terminating else QUEUE_SKIP

        def scale_down_hint(pod, old, new):
            """Requeue when any pod (including the pending pod itself) lowered
            its requests (fit.go isSchedulableAfterPodChange)."""
            if new is None:
                return QUEUE
            if old is None:
                return QUEUE_SKIP
            old_req = PodInfo(old, self.names).request
            new_req = PodInfo(new, self.names).request
            shrank = any(n < o for o, n in zip(old_req.v, new_req.v))
            return QUEUE if shrank else QUEUE_SKIP

        return [
            ClusterEventWithHint(ClusterEvent(ev.ASSIGNED_POD, ev.DELETE), pod_deleted_hint),
            ClusterEventWithHint(
                ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_ALLOCATABLE)
            ),
            # resource POD (not just AssignedPod): a pending pod scaling down
            # its own request must retrigger itself
            ClusterEventWithHint(ClusterEvent(ev.POD, ev.UPDATE_POD_SCALE_DOWN), scale_down_hint),
        ]

    # -- prefilter / filter -------------------------------------------------

    def pre_filter(self, state, pod: Pod, nodes):
        """Precompute the request vector once per cycle (fit.go:317)."""
        pi = PodInfo(pod, self.names)
        state.write(self.PRE_FILTER_KEY, pi)
        return None, Status()

    def _pod_info(self, state, pod: Pod) -> PodInfo:
        pi = state.read(self.PRE_FILTER_KEY)
        if pi is None or pi.pod is not pod:
            pi = PodInfo(pod, self.names)
        return pi

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        """fitsRequest (fit.go:673-760): for every resource,
        request <= allocatable - requested; plus pod-count slot."""
        pi = self._pod_info(state, pod)
        req, alloc, used = pi.request, node_info.allocatable, node_info.requested
        reasons = []
        if len(node_info.pods) + 1 > alloc[PODS]:
            reasons.append("Too many pods")
        width = max(len(req.v), len(alloc.v))
        for i in range(width):
            r = req[i]
            if r == 0 or i == PODS:
                continue
            rname = self.names.names[i] if i < self.names.width else f"res{i}"
            if rname in self.ignored:
                continue
            if r > alloc[i] - used[i]:
                reasons.append(f"Insufficient {rname}")
        if reasons:
            return Status.unschedulable(*reasons, plugin=self.name)
        return Status()

    # -- scoring ------------------------------------------------------------

    def _score_resources(self, pi: PodInfo, node_info: NodeInfo) -> int:
        """resource_allocation.go score: weighted mean of per-resource scores.

        requested includes the incoming pod; cpu/mem use NonZero values.
        """
        total_weight = 0
        total_score = 0
        for rname, weight in self.resource_weights.items():
            i = self.names.get(rname)
            if i is None:
                continue
            alloc = node_info.allocatable[i]
            if alloc <= 0:
                continue
            if i in (CPU, MEM):
                requested = node_info.nonzero_requested[i] + pi.nonzero_request[i]
            else:
                requested = node_info.requested[i] + pi.request[i]
            if requested > alloc:
                requested = alloc
            total_weight += weight
            total_score += self._strategy_score(requested, alloc) * weight
        if total_weight == 0:
            return 0
        return total_score // total_weight

    def _strategy_score(self, requested: int, capacity: int) -> int:
        if self.strategy == LEAST_ALLOCATED:
            # least_allocated.go:30-52 — ((capacity-requested)*100)/capacity
            return (capacity - requested) * MAX_NODE_SCORE // capacity
        if self.strategy == MOST_ALLOCATED:
            # most_allocated.go — (requested*100)/capacity
            return requested * MAX_NODE_SCORE // capacity
        # RequestedToCapacityRatio: piecewise-linear over utilization%
        util = requested * 100 // capacity
        shape = self.shape
        if util <= shape[0][0]:
            return shape[0][1]
        for (x0, y0), (x1, y1) in zip(shape, shape[1:]):
            if util <= x1:
                if x1 == x0:
                    return y1
                return y0 + (y1 - y0) * (util - x0) // (x1 - x0)
        return shape[-1][1]

    def score(self, state, pod: Pod, node_info: NodeInfo):
        return self._score_resources(self._pod_info(state, pod), node_info), Status()

    # -- signatures + gang placement scoring --------------------------------

    def sign(self, pod: Pod) -> str | None:
        pi = PodInfo(pod, self.names)
        return ",".join(str(x) for x in pi.request.v)

    def score_placement(self, state, pods, placement):
        """fit.go:789 ScorePlacement — aggregate gang request vs placement
        free capacity using the strategy score."""
        total_req = ResourceVec(self.names.width)
        for pod in pods:
            total_req.add(PodInfo(pod, self.names).request)
        total_alloc = ResourceVec(self.names.width)
        total_used = ResourceVec(self.names.width)
        snapshot = self.handle.snapshot if self.handle is not None else None
        for name in placement.node_names:
            ni = snapshot.get(name) if snapshot is not None else None
            if ni is None:
                continue
            total_alloc.add(ni.allocatable)
            total_used.add(ni.requested)
        score = 0
        weight_sum = 0
        for rname, weight in self.resource_weights.items():
            i = self.names.get(rname)
            if i is None or total_alloc[i] <= 0:
                continue
            requested = min(total_used[i] + total_req[i], total_alloc[i])
            score += self._strategy_score(requested, total_alloc[i]) * weight
            weight_sum += weight
        return (score // weight_sum if weight_sum else 0), Status()


class BalancedAllocation(Plugin):
    """balanced_allocation.go — favor nodes whose per-resource utilization
    fractions are close together: score = (1 - stddev(fractions)) * 100.

    Float32 with fixed op order; mirrored exactly by the device kernel.
    """

    name = "NodeResourcesBalancedAllocation"
    PRE_SCORE_KEY = "PreScoreBalancedAllocation"

    def __init__(self, names: ResourceNames, resources: list[str] | None = None):
        self.names = names
        self.resources = resources or ["cpu", "memory"]

    def pre_score(self, state, pod: Pod, nodes) -> Status:
        state.write(self.PRE_SCORE_KEY, PodInfo(pod, self.names))
        return Status()

    def score(self, state, pod: Pod, node_info: NodeInfo):
        pi = state.read(self.PRE_SCORE_KEY)
        if pi is None or pi.pod is not pod:
            pi = PodInfo(pod, self.names)
        fracs = []
        for rname in self.resources:
            i = self.names.get(rname)
            if i is None:
                continue
            alloc = node_info.allocatable[i]
            if alloc <= 0:
                continue
            if i in (CPU, MEM):
                requested = node_info.nonzero_requested[i] + pi.nonzero_request[i]
            else:
                requested = node_info.requested[i] + pi.request[i]
            frac = np.float32(requested) / np.float32(alloc)
            fracs.append(min(frac, np.float32(1.0)))
        if len(fracs) < 2:
            return 0, Status()
        arr = np.array(fracs, dtype=np.float32)
        mean = arr.sum(dtype=np.float32) / np.float32(len(arr))
        var = ((arr - mean) ** 2).sum(dtype=np.float32) / np.float32(len(arr))
        std = np.sqrt(var, dtype=np.float32)
        score = int((np.float32(1.0) - std) * np.float32(MAX_NODE_SCORE))
        return score, Status()
