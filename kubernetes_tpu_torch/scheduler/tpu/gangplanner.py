"""Gang-wave planner: whole-PodGroup admission onto the device gang kernel.

A copy of the reference package's planner
(kubernetes_tpu/scheduler/tpu/gangplanner.py). The host pod-group cycle
reproduces the reference's scheduleOnePodGroup: enumerate topology
placements, dry-run the whole gang once per placement in a narrowed
snapshot, score the fitting domains, then run the default algorithm under
the winner. This module decides whether a popped gang is fully
device-placeable, replicates the host's placement enumeration (the SAME
PlacementGenerate plugin calls, so domain set, order, requiredDomain pin
and error statuses can never diverge), and hands the resolved GangPlan to
TorchBackend.run_gang — one K1 + K5 launch pair that scans the gang over
every domain mask at once.

Fallback contract: the device path handles only the success case. Every
odd case — no feasible domain in Required mode, tie-word overflow, plugin
error status, host-compose members, nominated pods, too many domains or
members — returns None with the rng and snapshot untouched, and the host
pod-group cycle takes the group.

The port has no host tier yet, so three of the reference's gates wait for
it: the circuit breaker's check, the nominated-pods check
(_has_relevant_nominations) and the catch-all around run_gang that
degrades any error to the host cycle. Without the catch-all a K5 build or
launch failure raises; FallbackNeeded from run_gang still becomes None.
"""

from __future__ import annotations

from ...ops.planes import FallbackNeeded
from ..cache.snapshot import Placement
from ..framework.cycle_state import CycleState
from .backend import TorchSchedulingAlgorithm

# program-shape guards: a gang spanning more domains than this (pow2-padded
# mask rows) or more members than this rides the host cycle
MAX_GANG_DOMAINS = 32
MAX_GANG_MEMBERS = 128


class GangPlan:
    """One PodGroup's resolved device placement plan.

    gang_placements holds the host PlacementGenerate output in plugin
    order — rows [0, gang_n_constrained) are topology domains, and when
    gang_has_fallback the final row is the unconstrained parent placement
    (Preferred topology / plugin-less gangs)."""

    __slots__ = ("gang_placements", "gang_n_constrained",
                 "gang_has_fallback", "gang_required")

    def __init__(self, placements, n_constrained, has_fallback, required):
        self.gang_placements = placements
        self.gang_n_constrained = n_constrained
        self.gang_has_fallback = has_fallback
        self.gang_required = required


def _member_device_eligible(algo, pod) -> bool:
    """Is this member's decision fully modeled by the gang kernel? A
    nominated pod or one needing a host stage sends the whole group to the
    host cycle: a gang must not split across tiers."""
    if pod.status.nominated_node_name:
        return False
    if algo._needs_host_compose(pod):
        return False
    return True


def plan_gang(sched, fw, qpis) -> GangPlan | None:
    """Replicate the host pod-group algorithm's placement enumeration.

    Runs the same run_placement_generate_plugins call on a scratch cycle
    state (the plugins are pure reads of store/cache), applies the same
    `narrowed = placements != [parent]` single-placement-still-constrains
    rule, and derives Required mode from the same topology_mode probe.
    A plugin error status returns None."""
    pods = [q.pod for q in qpis]
    parent = Placement(
        "all", [ni.name for ni in sched.snapshot.list_nodes()]
    )
    placements = None
    narrowed = False
    required = False
    if fw.placement_generate_plugins:
        pstate = CycleState()
        placements, st = fw.run_placement_generate_plugins(
            pstate, pods, parent
        )
        if not st.is_success and not st.is_skip:
            return None  # the host cycle reproduces the error status
        narrowed = placements != [parent]
        for p in fw.placement_generate_plugins:
            mode = getattr(p, "topology_mode", lambda _p: None)(pods)
            required = required or mode == "Required"
    if placements is not None and narrowed:
        constrained = list(placements)
        if required:
            # Required topology: no unconstrained fallback row — a gang no
            # domain holds is unschedulable
            return GangPlan(constrained, len(constrained), False, True)
        return GangPlan(constrained + [parent], len(constrained), True,
                        False)
    # no placement plugins / skipped / not narrowed: the default algorithm
    # on the whole snapshot — one unconstrained row
    return GangPlan([parent], 0, True, required)


def try_gang_wave(sched, fw, algo, gk: str, qpis: list):
    """Attempt whole-gang device placement; returns hosts aligned with
    `qpis` on success, else None (the host cycle takes the group).

    sched is what the scheduler exposes (its `snapshot`), fw the profile's
    Framework, algo its TorchSchedulingAlgorithm, gk the group's key (the
    reference logs it) and qpis the queued members (each with `.pod`),
    sorted by priority then queue time. Every None path leaves the rng,
    snapshot and cache untouched and counts the members on the "host" side
    of the backend's gang_pod_totals; run_gang counts the "device" side on
    success."""
    if not isinstance(algo, TorchSchedulingAlgorithm):
        return None
    backend = algo.backend

    def host_path():
        backend.count_gang_pods("host", len(qpis))
        return None

    if not qpis or sched.snapshot.num_nodes() == 0:
        return host_path()
    if len(qpis) > MAX_GANG_MEMBERS:
        return host_path()
    if not all(_member_device_eligible(algo, q.pod) for q in qpis):
        return host_path()
    plan = plan_gang(sched, fw, qpis)
    if plan is None or len(plan.gang_placements) > MAX_GANG_DOMAINS:
        return host_path()
    try:
        res = backend.run_gang(
            [q.pod for q in qpis], sched.snapshot, plan.gang_placements,
            plan.gang_n_constrained, plan.gang_has_fallback, algo.rng,
        )
    except FallbackNeeded:
        res = None
    if res is None:
        algo.fallback_count += len(qpis)
        return host_path()
    hosts, _win_d, _rec = res
    algo.kernel_count += len(qpis)
    return hosts
