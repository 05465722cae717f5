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
error status, host-compose members, nominated pods or members a
nomination outranks, an open circuit breaker, too many domains or
members — returns None with the
rng and snapshot untouched, and the host pod-group cycle (schedule_one.py
PodGroupCycle) takes the group. OutOfSlice (a gang the kernels do not
compute) always raises. Any other error from run_gang is counted on the
backend (gang_errors, gang_last_error; the recorder keeps gang_pod_totals); on the CPU,
where the plain versions run, the group then goes to the host cycle as in
the reference, and on the card the error raises, so a failed K1/K5 build
or launch never hides behind the host tier.
"""

from __future__ import annotations

import logging

from ...ops.kernels import OutOfSlice
from ..cache.snapshot import Placement
from ..framework.cycle_state import CycleState
from .backend import TorchSchedulingAlgorithm

_log = logging.getLogger("kubernetes_tpu_torch.gangplanner")

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
    nominated pod, one a nomination outranks (the nominated-pod simulation)
    or one needing a host stage sends the whole group to the host cycle: a
    gang must not split across tiers."""
    if pod.status.nominated_node_name:
        return False
    if algo._has_relevant_nominations(pod):
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
            required = required or p.topology_mode(pods) == "Required"
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

    sched is what the scheduler exposes (its `snapshot`; PodGroupCycle), fw the profile's
    Framework, algo its TorchSchedulingAlgorithm, gk the group's key (the
    reference logs it) and qpis the queued members (each with `.pod`),
    sorted by priority then queue time. Every None path leaves the rng,
    snapshot and cache untouched and counts the members on the "host" side
    of the wave recorder's gang_pod_totals; run_gang counts the "device"
    side on success."""
    if not isinstance(algo, TorchSchedulingAlgorithm):
        return None
    backend = algo.backend
    recorder = backend.recorder

    def host_path():
        recorder.count_gang_pods("host", len(qpis))
        return None

    if not qpis or sched.snapshot.num_nodes() == 0:
        return host_path()
    if backend._ctx.n_shards != 1:
        # the reference's mesh gate (gangplanner.py:143): placement masks
        # are not sharded over the node axis, so K5 does not run on a mesh
        return host_path()
    if algo.breaker.device_blocked():
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
    except OutOfSlice:
        raise
    except Exception as e:  # noqa: BLE001 — the reference's degrade, on the CPU only
        backend.gang_errors += 1
        backend.gang_last_error = f"{type(e).__name__}: {e}"
        if algo.on_card:
            raise
        _log.error("gang wave failed; host cycle takes the group %s (%d members): %s",
                   gk, len(qpis), e)
        algo.fallback_count += len(qpis)
        return host_path()
    if res is None:
        algo.fallback_count += len(qpis)
        return host_path()
    hosts, _win_d, _rec = res
    algo.kernel_count += len(qpis)
    return hosts
