"""The scheduling algorithm: one pod (schedulePod) and one pod group.

Reference: pkg/scheduler/schedule_one.go — schedulePod:568,
findNodesThatFitPod:626, findNodesThatPassFilters:775,
numFeasibleNodesToFind:862, prioritizeNodes:941, selectHost:1080 — and
schedule_one_podgroup.go. A copy of the algorithm half of the reference
package's module (kubernetes_tpu/scheduler/schedule_one.py:65-299 and
:1003-1186):

- `SchedulingAlgorithm`, the host algorithm for one pod, sequential over
  the framework's plugins. The device algorithm
  (`tpu/backend.py TorchSchedulingAlgorithm`) is its subclass and falls
  back to it. The OpportunisticBatching hint path (the reference's
  `batch`, a BatchCache the loop sets) and HTTP extenders are not ported:
  the first comes with the scheduling loop, and a non-empty extender
  list raises OutOfSlice.
- `PodGroupCycle`, the pod-group (gang) algorithm: the device gang wave
  when the planner admits the group, else the host cycle — placement
  enumeration, a dry run per placement on a narrowed snapshot, the
  default algorithm under the best one — with in-snapshot assumes,
  reserve and permit per member, and a full revert on failure. The
  reference runs these as methods of its ScheduleOneLoop; the queue pops
  and the result submission (bindings, failure handling) come with the
  loop.
"""

from __future__ import annotations

import random

from ..api.resource import ResourceNames
from ..api.types import Pod
from ..ops.kernels import OutOfSlice
from .cache.snapshot import Placement
from .framework.cycle_state import CycleState
from .framework.interface import (
    Diagnosis,
    FitError,
    NodePluginScores,
    ScheduleResult,
    Status,
)
from .framework.runtime import Framework
from .nodeinfo import NodeInfo, PodInfo

MIN_FEASIBLE_NODES_TO_FIND = 100  # schedule_one.go:56
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # schedule_one.go:62


def num_feasible_nodes_to_find(percentage: int, num_all_nodes: int) -> int:
    """Adaptive sampling formula (schedule_one.go:862-888)."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive == 0:
        adaptive = 50 - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num = num_all_nodes * adaptive // 100
    if num < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num


class SchedulingAlgorithm:
    """schedulePod + helpers, bound to one framework profile."""

    # runs on a card, where an error other than FitError is a failed kernel
    # and raises instead of reading as a member that does not fit
    on_card = False

    def __init__(
        self,
        framework: Framework,
        percentage_of_nodes_to_score: int = 0,
        rng: random.Random | None = None,
        nominator=None,
        extenders: list | None = None,
    ):
        if extenders:
            raise OutOfSlice("extenders: A4b")
        self.fw = framework
        self.percentage = percentage_of_nodes_to_score
        self.next_start_node_index = 0
        self.rng = rng or random.Random(0)  # seeded: deterministic tie-breaks
        self.nominator = nominator  # queue, for nominated-pod protection

    # -- filtering -----------------------------------------------------------

    def find_nodes_that_fit_pod(
        self, state: CycleState, pod: Pod, snapshot, nominated_node: str = "",
    ) -> tuple[list[NodeInfo], Diagnosis]:
        all_nodes = snapshot.list_nodes()
        diagnosis = Diagnosis()
        result, status = self.fw.run_pre_filter_plugins(state, pod, all_nodes)
        if not status.is_success:
            if status.is_rejected:
                diagnosis.pre_filter_msg = status.message()
                diagnosis.unschedulable_plugins.add(status.plugin)
                diagnosis.node_to_status.absent_nodes_status = status
                return [], diagnosis
            raise RuntimeError(f"prefilter failed: {status.reasons}")

        # nominated-node fast path (schedule_one.go:718 evaluateNominatedNode)
        if nominated_node:
            ni = snapshot.get(nominated_node)
            if ni is not None:
                feasible = self._filter_one(state, pod, ni, diagnosis)
                if feasible:
                    return [ni], diagnosis

        nodes = all_nodes
        if result is not None and not result.all_nodes:
            nodes = [n for n in all_nodes if n.name in result.node_names]
            diagnosis.node_to_status.absent_nodes_status = Status.unresolvable(
                "node(s) didn't satisfy plugin(s) "
                f"[{', '.join(sorted(diagnosis.unschedulable_plugins)) or 'prefilter'}]"
            )
        feasible = self._find_nodes_that_pass_filters(state, pod, nodes, diagnosis)
        return feasible, diagnosis

    def _filter_one(self, state, pod, ni: NodeInfo, diagnosis: Diagnosis) -> bool:
        nominated = self._nominated_pod_infos(pod, ni)
        st = self.fw.run_filter_plugins_with_nominated_pods(state, pod, ni, nominated)
        if st.is_success:
            return True
        diagnosis.node_to_status.set(ni.name, st)
        if st.plugin:
            diagnosis.unschedulable_plugins.add(st.plugin)
        return False

    def _nominated_pod_infos(self, pod: Pod, ni: NodeInfo) -> list[PodInfo]:
        """Equal-or-higher-priority pods nominated onto this node must be
        assumed during filtering so a preemptor's freed resources aren't
        stolen (schedule_one.go:1190 addNominatedPods)."""
        if self.nominator is None:
            return []
        out = []
        for key in self.nominator.nominated_pods_for_node(ni.name):
            if key == pod.meta.key:
                continue
            npi = self.nominator.nominated_pod_info(key)
            if npi is not None and npi.pod.spec.priority >= pod.spec.priority:
                out.append(npi)
        return out

    def _find_nodes_that_pass_filters(
        self, state, pod, nodes: list[NodeInfo], diagnosis: Diagnosis
    ) -> list[NodeInfo]:
        """findNodesThatPassFilters:775 — rotate start index for fairness,
        stop at numFeasibleNodesToFind (early exit)."""
        num_all = len(nodes)
        num_to_find = num_feasible_nodes_to_find(self.percentage, num_all)
        feasible: list[NodeInfo] = []
        start = self.next_start_node_index % num_all if num_all else 0
        evaluated = 0
        for i in range(num_all):
            ni = nodes[(start + i) % num_all]
            evaluated += 1
            if self._filter_one(state, pod, ni, diagnosis):
                feasible.append(ni)
                if len(feasible) >= num_to_find:
                    break
        self.next_start_node_index = (start + evaluated) % num_all if num_all else 0
        return feasible

    # -- scoring ---------------------------------------------------------------

    def prioritize_nodes(
        self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
    ) -> list:
        """prioritizeNodes:941 — PreScore + 3-pass Score; returns
        NodePluginScores list."""
        if not self.fw.score_plugins and not self.fw.pre_score_plugins:
            return [NodePluginScores(name=n.name, total_score=1) for n in nodes]
        st = self.fw.run_pre_score_plugins(state, pod, nodes)
        if not st.is_success:
            raise RuntimeError(f"prescore failed: {st.reasons}")
        scores, st = self.fw.run_score_plugins(state, pod, nodes)
        if not st.is_success:
            raise RuntimeError(f"score failed: {st.reasons}")
        return scores

    def select_host(self, node_scores: list, count: int = 1) -> tuple[str, list]:
        """selectHost:1080 — heap-select top `count`, random tie-break among
        max-score nodes (seeded rng makes it reproducible)."""
        if not node_scores:
            raise ValueError("empty priority list")
        best = max(s.total_score for s in node_scores)
        winners = [s for s in node_scores if s.total_score == best]
        chosen = winners[self.rng.randrange(len(winners))] if len(winners) > 1 else winners[0]
        ordered = sorted(node_scores, key=lambda s: -s.total_score)
        return chosen.name, ordered

    # -- schedulePod ------------------------------------------------------------

    def schedule_pod(self, state: CycleState, pod: Pod, snapshot) -> ScheduleResult:
        """schedulePod:568 — the complete algorithm for one pod."""
        if snapshot.num_nodes() == 0:
            raise FitError(pod, 0, Diagnosis())
        # nominated-node fast path: a preemptor retries its nomination first
        # (schedule_one.go:718 evaluateNominatedNode)
        nominated = pod.status.nominated_node_name
        feasible, diagnosis = self.find_nodes_that_fit_pod(
            state, pod, snapshot, nominated_node=nominated,
        )
        if not feasible:
            raise FitError(pod, snapshot.num_nodes(), diagnosis)
        if len(feasible) == 1:
            return ScheduleResult(
                suggested_host=feasible[0].name,
                evaluated_nodes=1 + len(diagnosis.node_to_status.node_to_status),
                feasible_nodes=1,
            )
        scores = self.prioritize_nodes(state, pod, feasible)
        host, _ordered = self.select_host(scores)
        return ScheduleResult(
            suggested_host=host,
            evaluated_nodes=len(feasible) + len(diagnosis.node_to_status.node_to_status),
            feasible_nodes=len(feasible),
        )


class PodGroupCycle:
    """The pod-group algorithm over one snapshot (scheduleOnePodGroup's
    algorithm half, schedule_one_podgroup.go:42).

    Holds what the reference's ScheduleOneLoop gives these methods: the
    cycle's snapshot, the profile's framework and algorithm, and the
    cluster's resource names. Members are queued pod infos (anything with
    `.pod`), sorted by priority then queue time as the caller pops them.
    An outcome is the reference's tuple: ("success", placed, None) with
    placed a list of (qpi, state, result, pod_info) whose assumes stay in
    the snapshot, or ("unschedulable" | "error", failing qpi, FitError or
    Status) with every assume reverted. OutOfSlice (a member the kernels
    do not compute) raises from every step, with every assume reverted: it
    is never read as a member that does not fit.
    """

    def __init__(self, snapshot, framework: Framework, algorithm: SchedulingAlgorithm,
                 names: ResourceNames):
        self.snapshot = snapshot
        self.fw = framework
        self.algo = algorithm
        self.names = names

    def schedule_pod_group(self, gk: str, qpis: list):
        """The device gang wave when the planner admits the group, else the
        host algorithm (schedule_one.py:1017-1019)."""
        outcome = self._pod_group_wave_algorithm(gk, qpis)
        if outcome is None:
            outcome = self._pod_group_algorithm(gk, qpis)
        return outcome

    def _pod_group_wave_algorithm(self, gk: str, qpis: list):
        """Whole-group device placement (K1 + K5 through try_gang_wave).
        None when the group must ride the host path (always for the host
        algorithm, which try_gang_wave declines); every None leaves rng,
        snapshot and cache untouched. The reference's KUBE_TPU_GANG_WAVES=0,
        which pins the host cycle, comes with the scheduling loop that
        reads it."""
        from .tpu.gangplanner import try_gang_wave

        hosts = try_gang_wave(self, self.fw, self.algo, gk, qpis)
        if hosts is None:
            return None
        return self._pod_group_apply_wave(gk, qpis, hosts)

    def _pod_group_apply_wave(self, gk: str, qpis: list, hosts: list):
        """The apply half of _pod_group_default_algorithm with the device
        wave's precomputed hosts: in-snapshot assume + reserve + permit per
        member, full revert on any failure."""
        fw = self.fw
        placed: list[tuple] = []  # (qpi, state, result, pod_info)
        gsnap = self.snapshot.pod_group_states.get(gk)
        evaluated = self.snapshot.num_nodes()
        for q, host in zip(qpis, hosts):
            state = CycleState()
            state.is_pod_group_scheduling_cycle = True
            result = ScheduleResult(suggested_host=host,
                                    evaluated_nodes=evaluated,
                                    feasible_nodes=1)
            pi = PodInfo(q.pod, self.names)
            self.snapshot.assume_pod(pi, host)
            if gsnap is not None:
                gsnap.unscheduled.discard(q.pod.meta.key)
                gsnap.assumed.add(q.pod.meta.key)
            st = fw.run_reserve_plugins_reserve(state, q.pod, host)
            if st.is_success:
                st = fw.run_permit_plugins(state, q.pod, host)
            if not (st.is_success or st.is_wait):
                placed.append((q, state, result, pi))
                self._revert_pod_group(gk, placed)
                return ("unschedulable" if st.is_rejected else "error", q, st)
            placed.append((q, state, result, pi))
        return ("success", placed, None)

    def _pod_group_algorithm(self, gk: str, qpis: list):
        """podGroupSchedulingAlgorithm (:573): placement enumeration when
        PlacementGenerate plugins produced >1 candidate (each dry-run in a
        narrowed snapshot, best picked by PlacementScore), else the default
        whole-snapshot algorithm."""
        fw = self.fw
        pods = [q.pod for q in qpis]
        pstate = CycleState()
        placements = None
        narrowed = False
        required = False
        if fw.placement_generate_plugins:
            parent = Placement(
                "all", [ni.name for ni in self.snapshot.list_nodes()]
            )
            placements, _st = fw.run_placement_generate_plugins(
                pstate, pods, parent
            )
            if not _st.is_success and not _st.is_skip:
                # e.g. requiredDomain inconsistency: scheduled members span
                # two domains (topology_placement.go getScheduledPods error)
                return ("error", qpis[0], _st)
            # a SINGLE placement must still constrain (the requiredDomain
            # pin of a partially-scheduled gang is exactly one placement)
            narrowed = placements != [parent]
            for p in fw.placement_generate_plugins:
                required = required or p.topology_mode(pods) == "Required"
        if placements is not None and narrowed:
            # podGroupSchedulingPlacementAlgorithm:520 — dry-run per
            # placement, score the ones that fit, run the real algorithm
            # under the winner
            best = None
            for pl in placements:
                self.snapshot.assume_placement(pl)
                try:
                    ok = self._pod_group_dry_run(qpis)
                    if ok:
                        score = fw.run_placement_score_plugins(pstate, pods, pl)
                        if best is None or score > best[0]:
                            best = (score, pl)
                finally:
                    self.snapshot.forget_placement()
            if best is not None:
                self.snapshot.assume_placement(best[1])
                try:
                    return self._pod_group_default_algorithm(gk, qpis)
                finally:
                    self.snapshot.forget_placement()
            if required:
                return ("unschedulable", qpis[0], Status.unschedulable(
                    "no topology domain can hold the whole pod group",
                    plugin="TopologyPlacementGenerator",
                ))
            # Preferred topology: fall back to the unconstrained snapshot
        return self._pod_group_default_algorithm(gk, qpis)

    def _pod_group_dry_run(self, qpis: list) -> bool:
        """Does the whole gang fit the (placement-narrowed) snapshot?
        Schedules each member with in-snapshot assumes, reverts everything,
        restores the tie-break rng (dry runs must not consume the stream).

        A FitError, or as in the reference any other error of a run on the
        CPU, reads as "does not fit". OutOfSlice, and on the card any error
        other than FitError (a failed K4 or K3 launch), raise after the
        revert."""
        algo = self.algo
        rng_state = algo.rng.getstate()
        placed: list[tuple[str, str]] = []
        ok = True
        try:
            for q in qpis:
                state = CycleState()
                state.is_pod_group_scheduling_cycle = True
                try:
                    result = algo.schedule_pod(state, q.pod, self.snapshot)
                except FitError:
                    ok = False
                    break
                except OutOfSlice:
                    raise
                except Exception:  # noqa: BLE001 — the reference's, on the CPU only
                    if algo.on_card:
                        raise
                    ok = False
                    break
                pi = PodInfo(q.pod, self.names)
                self.snapshot.assume_pod(pi, result.suggested_host)
                placed.append((q.pod.meta.key, result.suggested_host))
        finally:
            for key, host in reversed(placed):
                self.snapshot.forget_pod(key, host)
            algo.rng.setstate(rng_state)
        return ok

    def _pod_group_default_algorithm(self, gk: str, qpis: list):
        """podGroupSchedulingDefaultAlgorithm:275 — sequential per-pod
        algorithm; assumes go into the SNAPSHOT (schedule_one.go:1113-1118),
        reserve + permit run per pod (the gang plugin returns Wait until the
        snapshot group state reaches quorum, then allows every sibling)."""
        fw, algo = self.fw, self.algo
        placed: list[tuple] = []  # (qpi, state, result, pod_info)
        gsnap = self.snapshot.pod_group_states.get(gk)
        for q in qpis:
            state = CycleState()
            state.is_pod_group_scheduling_cycle = True
            try:
                result = algo.schedule_pod(state, q.pod, self.snapshot)
            except FitError as fe:
                self._revert_pod_group(gk, placed)
                return ("unschedulable", q, fe)
            except OutOfSlice:
                self._revert_pod_group(gk, placed)
                raise
            except Exception as e:  # noqa: BLE001
                self._revert_pod_group(gk, placed)
                return ("error", q, Status.as_error(e))
            pi = PodInfo(q.pod, self.names)
            self.snapshot.assume_pod(pi, result.suggested_host)
            if gsnap is not None:
                gsnap.unscheduled.discard(q.pod.meta.key)
                gsnap.assumed.add(q.pod.meta.key)
            st = fw.run_reserve_plugins_reserve(state, q.pod, result.suggested_host)
            if st.is_success:
                st = fw.run_permit_plugins(state, q.pod, result.suggested_host)
            if not (st.is_success or st.is_wait):
                placed.append((q, state, result, pi))
                self._revert_pod_group(gk, placed)
                return ("unschedulable" if st.is_rejected else "error", q, st)
            placed.append((q, state, result, pi))
        return ("success", placed, None)

    def _revert_pod_group(self, gk: str, placed: list) -> None:
        """The deferred revertFn of the group algorithm (schedule_one.go:
        363-393): unreserve, drop permit waiters, forget in-snapshot assumes,
        restore the snapshot group state."""
        fw = self.fw
        gsnap = self.snapshot.pod_group_states.get(gk)
        for q, state, result, pi in reversed(placed):
            fw.run_reserve_plugins_unreserve(state, q.pod, result.suggested_host)
            fw.remove_waiting_pod(q.pod.meta.key)
            self.snapshot.forget_pod(pi.key, result.suggested_host)
            if gsnap is not None:
                gsnap.assumed.discard(q.pod.meta.key)
                gsnap.unscheduled.add(q.pod.meta.key)
