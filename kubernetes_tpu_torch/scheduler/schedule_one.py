"""The scheduling cycle: the algorithm for one pod (schedulePod) and one
pod group, and the loop that pops, schedules and binds.

Reference: pkg/scheduler/schedule_one.go — ScheduleOne:66,
schedulingCycle:174, schedulePod:568, findNodesThatFitPod:626,
findNodesThatPassFilters:775, numFeasibleNodesToFind:862,
prioritizeNodes:941, selectHost:1080, bindingCycle:396,
handleSchedulingFailure:1188 — and schedule_one_podgroup.go. A copy of the
reference package's module (kubernetes_tpu/scheduler/schedule_one.py):

- `SchedulingAlgorithm`, the host algorithm for one pod, sequential over
  the framework's plugins, with the OpportunisticBatching hint path (the
  BatchCache the Scheduler sets as `batch` when that gate is on; off by
  default, as in the reference). The device algorithm
  (`tpu/backend.py TorchSchedulingAlgorithm`) is its subclass and falls
  back to it. HTTP extenders (`extender.py`) prune the feasible set after
  the in-tree filters and add their weighted scores to the totals.
- `PodGroupCycle`, the pod-group (gang) algorithm over one snapshot: the
  device gang wave when the planner admits the group, else the host cycle
  — placement enumeration, a dry run per placement on a narrowed snapshot,
  the default algorithm under the best one — with in-snapshot assumes,
  reserve and permit per member, and a full revert on failure.
- `ScheduleOneLoop`, the per-pod cycle and the batched wave pipeline: the
  wave pop (`schedule_wave`), the launch of wave k+1 on the device carry
  while wave k's results are assumed and bound (`_pipeline_wave`,
  `_complete_wave`), the circuit breaker's outcome records, the
  pod-group cycle's queue pops and result submission, and the binding
  cycle through the framework's binder or the async dispatcher.

The loop writes the reference's telemetry into its wave recorder
(tpu/waverecorder.py): the phase stopwatches and spans, one `wave/<id>`
span per completed wave with the wave record closed after its binds, the
pod latency ledger's wave_admission, kernel_verdict, gang_wait,
bind_dispatch and bind_commit stamps, the stall profiler's gap marks
(queue_empty, capacity_gate, flush) and the async bind wait
(bind_backpressure), per-plugin fallback attribution around every wave
that falls back to per-pod cycles, `metrics.pod_scheduled` /
`pod_unschedulable`, and a slow-cycle trace of any per-pod or pod-group
cycle over 100 ms. The wave controller's latency guard observes each
recorded wave (opt-in, off by default). No decision reads any of it. The
fleet's shard gate is A13's.
"""

from __future__ import annotations

import collections
import logging
import os
import random
import threading
import time as _time

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
from .queue.scheduling_queue import QueuedPodInfo
from ..utils import faultinject
from ..utils.envknob import int_env
from ..utils.tracing import Span, threshold_log_exporter

_log = logging.getLogger("kubernetes_tpu_torch.scheduler")

# slow-cycle diagnosis (utiltrace LogIfLong, schedule_one.go:570-571):
# steps are span events, formatted and logged (to the
# "kubernetes_tpu_torch.trace" logger) only when the cycle breaches the
# threshold
_SLOW_CYCLE_THRESHOLD_S = 0.1
_slow_cycle_export = threshold_log_exporter(_SLOW_CYCLE_THRESHOLD_S)

MIN_FEASIBLE_NODES_TO_FIND = 100  # schedule_one.go:56
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # schedule_one.go:62

# wave-size cap while the circuit breaker is HALF_OPEN: a recovering device
# probes with small waves instead of being handed a full one (a probe
# failure then strands N pods, not max_pods)
PROBE_WAVE_PODS = 8

# async-bind completion budget: total seconds a binding cycle waits for the
# dispatcher to land one bind call, waited in short slices so a stalled
# dispatcher shows in the log before the budget burns down
BIND_WAIT_S = 30.0
_BIND_WAIT_SLICE_S = 5.0


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
        self.fw = framework
        self.percentage = percentage_of_nodes_to_score
        self.next_start_node_index = 0
        self.rng = rng or random.Random(0)  # seeded: deterministic tie-breaks
        self.nominator = nominator  # queue, for nominated-pod protection
        self.batch = None  # BatchCache when OpportunisticBatching is on
        self.extenders = list(extenders or [])

    # -- filtering -----------------------------------------------------------

    def find_nodes_that_fit_pod(
        self, state: CycleState, pod: Pod, snapshot, nominated_node: str = "",
        pre_filter_done: tuple | None = None,
    ) -> tuple[list[NodeInfo], Diagnosis]:
        all_nodes = snapshot.list_nodes()
        diagnosis = Diagnosis()
        if pre_filter_done is not None:
            # PreFilter already ran this cycle (batch hint path)
            result, status = pre_filter_done
        else:
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
        if self.extenders and feasible:
            # findNodesThatPassExtenders (schedule_one.go:890): after the
            # in-tree filters, on their feasible set
            from .extender import find_nodes_that_pass_extenders

            feasible = find_nodes_that_pass_extenders(
                self.extenders, pod, feasible, diagnosis
            )
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
        if self.extenders:
            from .extender import extender_scores

            ext = extender_scores(self.extenders, pod, nodes)
            if ext:
                for nps in scores:
                    bonus = ext.get(nps.name, 0)
                    if bonus:
                        nps.scores.append(("extenders", bonus))
                        nps.total_score += bonus
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
        # opportunistic batching (findNodesThatFitPod:654 GetNodeHint): an
        # identical pod signed earlier this batch window reuses its sorted
        # score list — only the hinted node is re-Filtered
        signature = None
        pre_filter_done = None
        if self.batch is not None and not pod.status.nominated_node_name:
            signature = self.fw.sign_pod(pod)
            # only pay the hint-path PreFilter when a fresh entry exists
            if signature is not None and self.batch.has_fresh(signature):
                hinted, pre_filter_done = self._try_node_hint(
                    state, pod, snapshot, signature)
                if hinted is not None:
                    return ScheduleResult(
                        suggested_host=hinted, evaluated_nodes=1, feasible_nodes=1)
        # nominated-node fast path: a preemptor retries its nomination first
        # (schedule_one.go:718 evaluateNominatedNode)
        nominated = pod.status.nominated_node_name
        feasible, diagnosis = self.find_nodes_that_fit_pod(
            state, pod, snapshot, nominated_node=nominated,
            pre_filter_done=pre_filter_done,
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
        host, ordered = self.select_host(scores)
        if signature is not None:
            self.batch.store_schedule_results(signature, [s.name for s in ordered])
        return ScheduleResult(
            suggested_host=host,
            evaluated_nodes=len(feasible) + len(diagnosis.node_to_status.node_to_status),
            feasible_nodes=len(feasible),
        )

    def _try_node_hint(self, state, pod, snapshot, signature: str):
        """Run PreFilter (the cycle state must be populated for the Filter
        re-check and the later Reserve/PreBind), then consult the batch
        cache. Returns (hinted_node | None, pre_filter_done) so a miss hands
        its PreFilter work to the full path instead of rerunning it."""
        all_nodes = snapshot.list_nodes()
        result, status = self.fw.run_pre_filter_plugins(state, pod, all_nodes)
        if not status.is_success:
            return None, (result, status)

        def filter_fn(node_name: str) -> bool:
            ni = snapshot.get(node_name)
            if ni is None:
                return False
            return self._filter_one(state, pod, ni, Diagnosis())

        return self.batch.get_node_hint(signature, filter_fn), (result, status)


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
                 names: ResourceNames, gang_waves: bool = True):
        self.snapshot = snapshot
        self.fw = framework
        self.algo = algorithm
        self.names = names
        # False pins the host cycle (the loop's KUBE_TPU_GANG_WAVES=0)
        self.gang_waves = gang_waves

    def schedule_pod_group(self, gk: str, qpis: list):
        """The device gang wave when the planner admits the group, else the
        host algorithm (schedule_one.py:1017-1019)."""
        outcome = self._pod_group_wave_algorithm(gk, qpis)
        if outcome is None:
            outcome = self._pod_group_algorithm(gk, qpis)
        return outcome

    def _pod_group_wave_algorithm(self, gk: str, qpis: list):
        """Whole-group device placement (K1 + K5 through try_gang_wave).
        None when the group must ride the host path (gang waves off, or the
        host algorithm, which try_gang_wave declines); every None leaves
        rng, snapshot and cache untouched."""
        if not self.gang_waves:
            return None
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
        snapshot group state reaches quorum, then allows every sibling).

        As in the dry run, OutOfSlice and on the card any error other than
        FitError (a failed K4 or K3 launch) raise after the revert; on the
        CPU such an error is the member's error status, as in the
        reference."""
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
            except Exception as e:  # noqa: BLE001 — the reference's, on the CPU only
                self._revert_pod_group(gk, placed)
                if algo.on_card:
                    raise
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


class ScheduleOneLoop:
    """The scheduling loop: pop → schedule → assume/reserve/permit → bind.

    Reference: ScheduleOne:66 + schedulingCycle:174 + bindingCycle:396 (the
    reference package's ScheduleOneLoop, schedule_one.py:301-1541). The
    binding cycle runs inline, or on a thread with async_binding and for a
    pod parked at Permit. The batched wave pipeline launches wave k+1's K1 +
    K2 on the device carry while the host assumes and binds wave k.
    """

    def __init__(
        self,
        cache,
        queue,
        profiles: dict[str, Framework],
        algorithms: dict[str, SchedulingAlgorithm],
        store,
        snapshot,
        async_binding: bool = False,
        event_recorder=None,
        names=None,
        api_cacher=None,
        pod_group_cycles: bool = True,
        recorder=None,
        metrics=None,
    ):
        from .tpu.wavecontroller import WaveSizeController
        from .tpu.waverecorder import WaveRecorder

        self.names = names or ResourceNames()
        self.cache = cache
        self.queue = queue
        self.profiles = profiles
        self.algorithms = algorithms
        self.store = store
        self.snapshot = snapshot
        self.metrics = metrics
        self.async_binding = async_binding
        self.event_recorder = event_recorder
        self.api_cacher = api_cacher  # SchedulerAsyncAPICalls path
        self.pod_group_cycles = pod_group_cycles
        self._binding_threads: list = []
        # host seconds per loop phase: phase_profile IS the recorder's
        # phase_totals dict (the same object)
        self.recorder = recorder if recorder is not None else WaveRecorder(
            metrics=metrics)
        self.phase_profile = self.recorder.phase_totals
        # the launched-but-unprocessed batched wave: (algo, InflightWave).
        # While its kernels run on the device, the host processes the
        # PREVIOUS wave's results (schedule_one.go:146's scheduling/binding
        # overlap, at wave granularity)
        self._inflight_wave: tuple | None = None
        # depth <= 1 degrades the pipeline to the serial loop (launch then
        # complete at once — the same code path); read at construction
        self.pipeline_depth = max(1, int_env("KUBE_TPU_PIPELINE_DEPTH", 2))
        # gang waves: whole-PodGroup device placement instead of the host
        # cycle's per-placement dry runs; 0 pins the host cycle
        self.gang_waves = os.environ.get("KUBE_TPU_GANG_WAVES", "1") != "0"
        # adaptive wave sizing: queue depth picks the next wave's pow2
        # target within the caller's max_pods cap (the breaker's HALF_OPEN
        # probe break stays authoritative over both)
        self.wave_controller = WaveSizeController()
        # async wave-bind completions: dispatcher worker threads only append
        # here; the scheduling thread drains, so every queue/cache/carry
        # mutation stays on the scheduling thread
        self._wave_completions: "collections.deque[tuple]" = collections.deque()
        # one correlation token per bound wave: the event recorder folds
        # the wave's Scheduled events into an aggregate past its threshold
        self._wave_event_seq = 0

    def framework_for_pod(self, pod: Pod) -> Framework | None:
        return self.profiles.get(pod.spec.scheduler_name)

    def _skip_pod_schedule(self, fw: Framework, pod: Pod) -> bool:
        """skipPodSchedule:546 — deleted or already-assumed pods."""
        if pod.is_terminating:
            return True
        if not self.store.contains("Pod", pod.meta.key):
            return True
        if self.cache.is_assumed_pod(pod):
            return True
        return False

    # -- one iteration -----------------------------------------------------------

    def schedule_one(self, timeout: float | None = 0.05) -> bool:
        """Pop and schedule one pod; returns False when queue empty."""
        qpi = self.queue.pop(timeout=timeout)
        if qpi is None:
            return False
        with self.recorder.phase("cycle"):
            self.schedule_pod_info(qpi)
        return True

    def schedule_pod_info(self, qpi: QueuedPodInfo) -> None:
        pod = qpi.pod
        fw = self.framework_for_pod(pod)
        if fw is None:
            self.queue.done(qpi.key, qpi.inflight_token)
            return
        if self._skip_pod_schedule(fw, pod):
            self.queue.done(qpi.key, qpi.inflight_token)
            return
        # whole-gang cycle (ScheduleOne, schedule_one.go:77)
        if pod.spec.scheduling_group is not None and self.pod_group_cycles:
            sp = Span(name="SchedulingPodGroup", start=_time.perf_counter(),
                      attributes={"pod": pod.meta.key})
            self.schedule_pod_group(qpi, fw)
            sp.end = _time.perf_counter()
            _slow_cycle_export(sp)
            return
        sp = Span(name="Scheduling", start=_time.perf_counter(),
                  attributes={"pod": pod.meta.key,
                              "scheduler": fw.profile_name})
        # ledger: a per-pod cycle is this pod's "wave" admission
        ledger = self.recorder.pod_ledger
        ledger.stamp(pod.meta.key, "wave_admission")
        state = CycleState()
        scheduling_cycle = self.queue.moved_count
        result, status = self._scheduling_cycle(state, fw, qpi)
        sp.event("Computing pod placement done" if status.is_success
                 else "Scheduling attempt failed")
        if not status.is_success:
            self._handle_scheduling_failure(fw, qpi, status, scheduling_cycle)
            sp.event("Failure handled (requeue + condition)")
            sp.end = _time.perf_counter()
            _slow_cycle_export(sp)
            return
        ledger.stamp(pod.meta.key, "kernel_verdict")
        self._dispatch_binding(state, fw, qpi, result)
        sp.event("Binding dispatched")
        sp.end = _time.perf_counter()
        _slow_cycle_export(sp)

    def _dispatch_binding(self, state, fw: Framework, qpi: QueuedPodInfo,
                          result: ScheduleResult) -> None:
        """Run the binding cycle inline or on a thread. A pod parked at
        Permit (gang quorum wait) must bind on a thread even in sync mode:
        the loop has to keep scheduling its siblings or quorum never
        arrives (bindingCycle is always a goroutine, schedule_one.go:146)."""
        must_thread = fw.waiting_pod(qpi.pod.meta.key) is not None
        if self.async_binding or must_thread:
            t = threading.Thread(
                target=self._binding_cycle, args=(state, fw, qpi, result), daemon=True
            )
            self._binding_threads.append(t)
            t.start()
        else:
            self._binding_cycle(state, fw, qpi, result)

    # -- batched wave -------------------------------------------------------------

    def schedule_wave(self, max_pods: int = 256, timeout: float | None = 0.0) -> int:
        """Pop a run of wave-eligible pods and schedule them in one device
        launch (TorchBackend.launch_batched: K1 + K2, or K1 + K6 on a
        mesh), then run the per-pod assume/reserve/permit cycle and the
        wave's batched bind for each winner.

        Decisions equal popping the same pods one at a time (the scan
        carries assumes between pods and draws the selectHost tie-break
        from the algorithm's rng). Ineligible pods — gang members, hybrid
        and nominated pods, another profile's pods — end the wave and go
        through the per-pod path, keeping queue order.

        Returns the number of pods processed (0 = queue empty)."""
        wave: list[QueuedPodInfo] = []
        wave_algo = None
        trailer: QueuedPodInfo | None = None
        # adaptive wave sizing: the queue's active depth (pure informer and
        # store state) picks the next wave's pow2 target within the cap
        active, _, _ = self.queue.pending_pods()
        target = self.wave_controller.next_size(active, cap=max_pods)
        clipped = self.wave_controller.last_clipped
        with self.recorder.phase("pop"):
            while len(wave) < target:
                qpi = self.queue.pop(
                    timeout=timeout if not wave and not trailer else 0.0
                )
                if qpi is None:
                    break
                pod = qpi.pod
                fw = self.framework_for_pod(pod)
                if fw is None:
                    self.queue.done(qpi.key, qpi.inflight_token)
                    continue
                if self._skip_pod_schedule(fw, pod):
                    self.queue.done(qpi.key, qpi.inflight_token)
                    continue
                algo = self.algorithms.get(fw.profile_name)
                # ORDER MATTERS (the reference's volume plans have side
                # effects in wave_eligible): every other precondition,
                # the same-profile check included, passes first
                eligible = (
                    pod.spec.scheduling_group is None
                    and (wave_algo is None or algo is wave_algo)
                    and algo.wave_eligible(pod)
                )
                if not eligible:
                    trailer = qpi
                    break
                wave_algo = algo
                wave.append(qpi)
                self.recorder.pod_ledger.stamp(pod.meta.key, "wave_admission")
                if len(wave) == PROBE_WAVE_PODS and algo.breaker.probing():
                    # HALF_OPEN: probe the recovering device with a small
                    # wave; the rest of the queue waits for the verdict
                    # (asked once per wave, when the wave reaches the cap)
                    break

        if not wave:
            # nothing to prep a successor from: whatever is in flight sat
            # (and drains now) because the queue ran dry — the stall
            # profiler attributes its open gap to queue_empty
            infl = self._inflight_wave
            if infl is not None or trailer is not None:
                self.recorder.stall_profiler.mark_gap(
                    infl[1].record if infl is not None else None,
                    "queue_empty")
            processed = self._flush_wave_pipeline()
            if trailer is not None:
                with self.recorder.phase("cycle"):
                    self.schedule_pod_info(trailer)
                processed += 1
            return processed

        # partial waves are padded with inactive slots to the next pow2
        # bucket (floor 8, cap max_pods): the device sees a bounded set of
        # wave shapes while small trickle waves still use small launches
        pad_to = 8
        while pad_to < len(wave):
            pad_to <<= 1
        processed = self._pipeline_wave(wave_algo, wave, min(pad_to, max_pods))
        if clipped:
            # the controller wanted more slots than the per-call cap
            # allowed: the launched wave sits in flight while the clipped
            # backlog waits for the next call — attribute its gap
            infl = self._inflight_wave
            if infl is not None:
                self.recorder.stall_profiler.mark_gap(
                    infl[1].record, "capacity_gate")
        if trailer is not None:
            # the trailer (gang/hybrid/nominated pod) must run strictly
            # after the wave that preceded it in queue order
            infl = self._inflight_wave
            if infl is not None:
                self.recorder.stall_profiler.mark_gap(
                    infl[1].record, "flush")
            processed += self._flush_wave_pipeline()
            with self.recorder.phase("cycle"):
                self.schedule_pod_info(trailer)
            processed += 1
        return processed

    def _pipeline_wave(self, algo, wave: list, pad_to: int) -> int:
        """Launch this wave's kernels (non-blocking, chained on the device
        carry), then process the PREVIOUS wave's results while they run.
        Returns pods fully processed this call (the previous wave's count)."""
        from ..ops.planes import FallbackNeeded
        from .tpu.backend import NeedResync

        processed = self._drain_wave_completions()
        infl = self._inflight_wave
        if infl is not None and (
            infl[0] is not algo or infl[1].pad != pad_to or infl[1].poisoned
        ):
            # incompatible in-flight wave (another profile, another pad —
            # the tie-word frame assumes equal pads — or a poisoned
            # carry): drain before launching
            self.recorder.stall_profiler.mark_gap(infl[1].record, "flush")
            processed += self._flush_wave_pipeline()

        breaker = algo.breaker
        if not breaker.allow_device_wave():
            # breaker OPEN (or probes exhausted): no device launch — drain
            # what is in flight (strict queue order) and run the wave per
            # pod; schedule_pod's device_blocked() routes each pod to the
            # host tier while the breaker cools
            infl = self._inflight_wave
            self.recorder.stall_profiler.mark_gap(
                infl[1].record if infl is not None else None, "flush")
            processed += self._flush_wave_pipeline()
            with self.recorder.phase("finish"), self.recorder.fallback_attribution(
                    self.framework_for_pod(wave[0].pod)):
                for qpi in wave:
                    algo.revert_wave_plan(qpi.pod)
                    self.schedule_pod_info(qpi)
            return processed + len(wave)

        with self.recorder.phase("snapshot"):
            self.cache.update_snapshot(self.snapshot)
        pods = [qpi.pod for qpi in wave]
        fl = None
        flake: Exception | None = None
        for _attempt in (0, 1):
            try:
                with self.recorder.phase("kernel"):
                    fl = algo.backend.launch_batched(
                        pods, self.snapshot, rng=algo.rng, pad_to=pad_to
                    )
                break
            except NeedResync:
                # drain the pipeline, re-upload from host truth, retry once
                infl = self._inflight_wave
                self.recorder.stall_profiler.mark_gap(
                    infl[1].record if infl is not None else None, "flush")
                processed += self._flush_wave_pipeline()
                algo.backend.invalidate_carry()
                with self.recorder.phase("snapshot"):
                    self.cache.update_snapshot(self.snapshot)
            except FallbackNeeded as e:
                if e.device_flake:
                    flake = e
                break
        if fl is None:
            # not kernelizable, or an injected launch flake: strict queue
            # order — whatever is in flight precedes these pods
            if flake is not None:
                breaker.record_failure(str(flake))
            else:
                # no device verdict either way (resync exhaustion, benign
                # fallback): release a half-open probe slot
                breaker.record_benign()
            infl = self._inflight_wave
            self.recorder.stall_profiler.mark_gap(
                infl[1].record if infl is not None else None, "flush")
            processed += self._flush_wave_pipeline()
            algo.fallback_count += len(wave)
            with self.recorder.phase("finish"), self.recorder.fallback_attribution(
                    self.framework_for_pod(wave[0].pod)):
                for qpi in wave:
                    algo.revert_wave_plan(qpi.pod)
                    self.schedule_pod_info(qpi)
            return processed + len(wave)
        fl.qpis = wave
        prev, self._inflight_wave = self._inflight_wave, (algo, fl)
        self.recorder.count_wave()
        if prev is not None:
            processed += self._complete_wave(*prev)
        if self.pipeline_depth <= 1:
            # pipelining off: complete the wave just launched before
            # returning — the serial loop, through the same code path
            processed += self._flush_wave_pipeline()
        return processed

    def _flush_wave_pipeline(self) -> int:
        """Process the in-flight wave (if any); returns pods processed."""
        n = self._drain_wave_completions()
        infl, self._inflight_wave = self._inflight_wave, None
        if infl is None:
            return n
        return n + self._complete_wave(*infl)

    def _complete_wave(self, algo, fl) -> int:
        """Wait for a launched wave's results and run the host half of its
        scheduling cycles: assume/reserve/permit per pod, then the wave's
        batched bind."""
        from ..ops.planes import FallbackNeeded

        rec = self.recorder
        wave = fl.qpis
        record = fl.record
        breaker = algo.breaker
        invalidated = False
        # one root span per wave: collect/finish/bind phases nest under it
        # (launch-side phases were children of the launching call's spans)
        with rec.tracer.span(
            f"wave/{record.wave_id if record is not None else 0}",
            pods=len(wave),
        ):
            try:
                with rec.phase("kernel"):
                    hosts, planes = algo.backend.collect(fl, rng=algo.rng)
            except FallbackNeeded as e:
                # tie-draw overflow, poisoned carry, or an injected device
                # flake: results discarded, pods re-run per pod against
                # live state; a successor launched on the bad carry is
                # poisoned too. The backend already closed the wave's
                # record with the fallback reason.
                if e.device_flake:
                    breaker.record_failure(str(e))
                else:
                    breaker.record_benign()
                self._poison_successor(algo)
                algo.fallback_count += len(wave)
                with rec.phase("finish"), rec.fallback_attribution(
                        self.framework_for_pod(wave[0].pod)):
                    for qpi in wave:
                        algo.revert_wave_plan(qpi.pod)
                        self.schedule_pod_info(qpi)
                if breaker.device_blocked() and e.device_flake:
                    # the flake tripped the breaker OPEN: drain the
                    # (poisoned) successor now rather than holding it in
                    # flight through the cooldown — its pods reroute to the
                    # host tier in queue order right behind this wave's
                    infl = self._inflight_wave
                    rec.stall_profiler.mark_gap(
                        infl[1].record if infl is not None else None, "flush")
                    return len(wave) + self._flush_wave_pipeline()
                return len(wave)
            # the device round-tripped a full wave: the breaker's success
            # signal (host-side bind outcomes are another failure domain)
            breaker.record_success()
            algo.kernel_count += len(wave)
            # crash point: the wave is collected but none of its per-pod
            # finish cycles has run
            faultinject.fire("loop.wave")
            batch: list[tuple] = []
            with rec.phase("finish", record):
                exported = self._export_wave_signatures(algo, fl, planes)
                if record is not None:
                    record.cache_exports = exported
                ledger = rec.pod_ledger
                wave_id = record.wave_id if record is not None else None
                for qpi, host in zip(wave, hosts):
                    if host is not None and not invalidated:
                        # the kernel picked this pod's node; the wave_id is
                        # the exemplar link to the wave/<id> span
                        ledger.stamp(qpi.pod.meta.key, "kernel_verdict",
                                     wave_id=wave_id)
                    if invalidated or host is None:
                        # host=None re-runs reproduce the FitError (no rng
                        # draws, no state change — safe under a live
                        # successor); invalidated pods re-run because the
                        # carry diverged
                        algo.revert_wave_plan(qpi.pod)
                        self.schedule_pod_info(qpi)
                        continue
                    fw = self.framework_for_pod(qpi.pod)
                    state = CycleState()
                    vol_plan = algo.take_wave_plan(qpi.pod.meta.key)
                    if vol_plan is not None:
                        # the node-neutral volume decision made at wave
                        # admission: seed the cycle state so Reserve and
                        # PreBind run the normal VolumeBinding flow against
                        # the selected host
                        from .plugins.volumes import VolumeBinding, _BindingState, _ClaimsToBind

                        bs = _BindingState(_ClaimsToBind())
                        bs.per_node[host] = vol_plan
                        state.write(VolumeBinding.STATE_KEY, bs)
                    result = ScheduleResult(
                        suggested_host=host, evaluated_nodes=planes.n,
                        feasible_nodes=1,
                    )
                    result, status = self._finish_scheduling_cycle(
                        state, fw, qpi, result, from_wave=True
                    )
                    if not status.is_success:
                        if vol_plan is not None:
                            algo.safe_revert_volumes(vol_plan)
                        self._handle_scheduling_failure(
                            fw, qpi, status, self.queue.moved_count
                        )
                        # the kernel placed this pod but the host reverted
                        # it: the carry (and any successor computed from
                        # it) is wrong
                        self._poison_successor(algo)
                        invalidated = True
                        continue
                    if (fw.waiting_pod(qpi.pod.meta.key) is not None
                            or not self._default_bind_only(fw)):
                        self._dispatch_binding(state, fw, qpi, result)
                    else:
                        batch.append((state, fw, qpi, result))
            with rec.phase("bind", record):
                self._bind_wave(batch)
        if record is not None:
            rec.end_wave(
                record,
                fallback_reason="host revert: carry poisoned"
                if invalidated else None,
            )
            # feed the wave controller's (opt-in) latency guard
            self.wave_controller.observe(record.duration_s)
        return len(wave)

    def _export_wave_signatures(self, algo, fl, planes) -> int:
        """Warm the host BatchCache from the kernel's per-signature score
        rows: each distinct wave signature exports its ordered feasible
        node list, so pods that later take the host path ride GetNodeHint
        (one re-Filter) instead of a full Filter+Score pass. Returns the
        number of signatures exported."""
        import numpy as np

        batch = algo.batch
        sig_scores = fl.info.get("sig_scores")
        if batch is None or sig_scores is None or fl.sig_ids is None:
            return 0
        # the per-signature score rows' device→host copy, through the
        # backend's accounted seam (the "scores" plane)
        rows = algo.backend.telemetry.accounted_fetch("scores", sig_scores).numpy()
        seen: set[int] = set()
        exported = 0
        for pod, gid in zip(fl.pods, fl.sig_ids):
            gid = int(gid)
            if gid in seen:
                continue
            seen.add(gid)
            signature = self.framework_for_pod(pod).sign_pod(pod)
            if signature is None:
                continue
            row = rows[gid]
            # stable argsort on -score: score-descending, snapshot node
            # order within ties (select_host's ordered list); -1 rows
            # (infeasible or padding) drop out
            order = np.argsort(-row, kind="stable")
            names = [planes.node_names[i] for i in order if row[i] >= 0]
            if names:
                batch.store_schedule_results(signature, names)
                exported += 1
        return exported

    def _poison_successor(self, algo) -> None:
        """Mark the in-flight wave's results unusable and drop the carry —
        host-side state diverged from what its kernel assumed."""
        algo.backend.invalidate_carry()
        if self._inflight_wave is not None:
            self._inflight_wave[1].mark_poisoned()

    def _default_bind_only(self, fw: Framework) -> bool:
        """True when the profile's bind chain is exactly the DefaultBinder —
        the only binder whose store write the wave transaction replicates."""
        from .plugins.basics import DefaultBinder

        return (len(fw.bind_plugins) == 1
                and isinstance(fw.bind_plugins[0], DefaultBinder))

    def _bind_wave(self, batch: list[tuple]) -> None:
        """The binding cycle for a whole wave: PreBind per pod, then ONE
        multi-pod bind transaction (store.bind_pods; through the async
        dispatcher when SchedulerAsyncAPICalls is on, so the next wave's
        scheduling overlaps this wave's writes), then per-pod completion."""
        if not batch:
            return
        ready: list[tuple] = []
        for state, fw, qpi, result in batch:
            st = fw.wait_on_permit(qpi.pod)  # instant: no waiting pod in batch
            if st.is_success:
                st = fw.run_pre_bind_plugins(state, qpi.pod, result.suggested_host)
            if not st.is_success:
                self._handle_binding_failure(
                    state, fw, qpi, result.suggested_host, st
                )
                continue
            ready.append((state, fw, qpi, result))
        if not ready:
            return
        bindings = [(q.pod.meta.key, r.suggested_host) for _, _, q, r in ready]
        for key, _host in bindings:
            self.recorder.pod_ledger.stamp(key, "bind_dispatch")
        if self.api_cacher is not None:
            # the dispatcher worker only parks the outcome; every queue/
            # cache/pipeline mutation happens on the scheduling thread when
            # it drains _wave_completions
            self.api_cacher.bind_pods(
                bindings,
                on_done=lambda results, err:
                    self._wave_completions.append((ready, results, err)),
            )
            return
        try:
            results = self.store.bind_pods(bindings)
        except Exception as e:  # noqa: BLE001
            self._apply_wave_bind_results(ready, None, e)
            return
        self._apply_wave_bind_results(ready, results, None)

    def _drain_wave_completions(self) -> int:
        """Apply parked async wave-bind outcomes (scheduling thread only).
        Returns 0 — the pods were counted as processed by their wave."""
        while self._wave_completions:
            ready, results, err = self._wave_completions.popleft()
            self._apply_wave_bind_results(ready, results, err)
        return 0

    def _apply_wave_bind_results(self, ready: list[tuple], results, err) -> None:
        from ..store.store import ConflictError

        # crash point: the store bind ran, but the cache still holds the
        # assumes and queue.done has not run
        faultinject.fire("loop.bind_commit")
        self._wave_event_seq += 1
        corr = f"wave/{self._wave_event_seq}"
        for entry, status in zip(ready, results or ["conflict"] * len(ready)):
            state, fw, qpi, result = entry
            if err is not None or status != "bound":
                # "missing" (pod deleted mid-flight) also takes the failure
                # path: only _handle_binding_failure's forget releases the
                # assumed resources of a pod deleted before its bind
                e = err or ConflictError(
                    f"pod {qpi.pod.meta.key} bind rejected ({status})"
                )
                self._handle_binding_failure(
                    state, fw, qpi, result.suggested_host, Status.as_error(e)
                )
                continue
            self._finish_binding(state, fw, qpi, result.suggested_host,
                                 correlation=corr)

    # -- pod-group (gang) cycle ---------------------------------------------------

    def schedule_pod_group(self, qpi: QueuedPodInfo, fw: Framework) -> None:
        """scheduleOnePodGroup (schedule_one_podgroup.go:42): pop every
        unscheduled gang sibling, take ONE snapshot, run the pod-group
        algorithm (PodGroupCycle) with in-snapshot assume + revert, then
        submit — bindings for all members on success, per-pod failure
        handling otherwise."""
        pod = qpi.pod
        gk = self._group_key(pod)
        group = self.store.try_get("PodGroup", gk)
        gstate = self.cache.pod_group_states.get(gk)
        if group is None or gstate is None:
            # PreEnqueue normally parks group-less members; be defensive
            self._handle_scheduling_failure(
                fw, qpi,
                Status.unschedulable(f"PodGroup {gk} not found",
                                     plugin="GangScheduling"),
                self.queue.moved_count,
            )
            return
        # podGroupInfoForPod:119,143 — pop every sibling still queued
        qpis = [qpi]
        for key in sorted(gstate.unscheduled):
            if key == pod.meta.key:
                continue
            sib = self.queue.pop_specific(key)
            if sib is not None:
                qpis.append(sib)
        # priority desc, then queue timestamp asc (:151)
        qpis.sort(key=lambda q: (-q.pod.spec.priority, q.timestamp))

        self.cache.update_snapshot(self.snapshot)
        cycle = PodGroupCycle(self.snapshot, fw, self.algorithms[fw.profile_name],
                              self.names, gang_waves=self.gang_waves)
        self._submit_pod_group_result(fw, gk, qpis, cycle.schedule_pod_group(gk, qpis))

    def _submit_pod_group_result(self, fw: Framework, gk: str, qpis: list,
                                 outcome) -> None:
        """submitPodGroupAlgorithmResult:410 — success starts every member's
        binding cycle; failure routes every member through the failure
        handler (the failing pod with its own diagnosis)."""
        kind = outcome[0]
        if kind == "success":
            # gang placements change node state outside the wave pipeline
            self.mark_wave_external()
            dispatchable: list[tuple] = []
            for q, state, result, _pi in outcome[1]:
                try:
                    self.cache.assume_pod(q.pod, result.suggested_host)
                except Exception as e:  # noqa: BLE001
                    self._handle_scheduling_failure(
                        fw, q, Status.as_error(e), self.queue.moved_count
                    )
                    continue
                self.cache.pod_group_states.pod_assumed(gk, q.pod.meta.key)
                dispatchable.append((q, state, result))
            # crash point: every member is assumed but no binding has been
            # dispatched
            faultinject.fire("gang.permit")
            for q, state, result in dispatchable:
                self._dispatch_binding(state, fw, q, result)
            return
        failing, err = outcome[1], outcome[2]
        if isinstance(err, FitError):
            for p in err.diagnosis.unschedulable_plugins:
                failing.unschedulable_plugins.add(p)
            fail_status = Status.unschedulable(str(err), plugin="")
        else:
            fail_status = err
        sibling_status = Status.unschedulable(
            f"pod group {gk}: member {failing.pod.meta.key} did not fit",
            plugin="GangScheduling",
        )
        for q in qpis:
            self._handle_scheduling_failure(
                fw, q, fail_status if q is failing else sibling_status,
                self.queue.moved_count,
            )

    # -- scheduling cycle ---------------------------------------------------------

    def _scheduling_cycle(
        self, state: CycleState, fw: Framework, qpi: QueuedPodInfo
    ) -> tuple[ScheduleResult | None, Status]:
        pod = qpi.pod
        self.cache.update_snapshot(self.snapshot)
        algo = self.algorithms[fw.profile_name]
        try:
            result = algo.schedule_pod(state, pod, self.snapshot)
        except FitError as fit_err:
            # PostFilter (preemption) — schedule_one.go:293
            for p in fit_err.diagnosis.unschedulable_plugins:
                qpi.unschedulable_plugins.add(p)
            for p in fit_err.diagnosis.pending_plugins:
                qpi.pending_plugins.add(p)
            if fw.post_filter_plugins:
                pf_result, pf_status = fw.run_post_filter_plugins(
                    state, pod, fit_err.diagnosis.node_to_status
                )
                if pf_status.is_success and pf_result and pf_result.nominated_node_name:
                    # nominate; the pod returns to the queue and retries
                    self.queue.add_nominated_pod(
                        pod, pf_result.nominated_node_name, PodInfo(pod, self.names)
                    )
                    self._patch_nominated_node(pod, pf_result.nominated_node_name)
            return None, Status.unschedulable(str(fit_err), plugin="")
        except OutOfSlice:
            raise
        except Exception as e:  # noqa: BLE001 — the reference's, on the CPU only
            if algo.on_card:
                # a failed build or launch of a kernel on the card raises
                # out of the loop: never read as a scheduler error
                raise
            return None, Status.as_error(e)

        return self._finish_scheduling_cycle(state, fw, qpi, result)

    def _finish_scheduling_cycle(
        self, state: CycleState, fw: Framework, qpi: QueuedPodInfo,
        result: ScheduleResult, from_wave: bool = False,
    ) -> tuple[ScheduleResult | None, Status]:
        """assume + reserve + permit (the post-algorithm half of the
        scheduling cycle, schedule_one.go:320-393) — shared by the per-pod
        path and the batched wave path."""
        pod = qpi.pod
        # assume (schedule_one.go:320,1106): the cache sees the pod on the node
        assumed = pod
        try:
            self.cache.assume_pod(assumed, result.suggested_host)
        except Exception as e:  # noqa: BLE001
            return None, Status.as_error(e)
        if not from_wave:
            # a host-path placement changes node state the wave pipeline's
            # device carry did not see
            self.mark_wave_external()
        gk = self._group_key(pod)
        if gk is not None:
            self.cache.pod_group_states.pod_assumed(gk, pod.meta.key)

        st = fw.run_reserve_plugins_reserve(state, assumed, result.suggested_host)
        if not st.is_success:
            fw.run_reserve_plugins_unreserve(state, assumed, result.suggested_host)
            self._forget(assumed)
            return None, st

        st = fw.run_permit_plugins(state, assumed, result.suggested_host)
        if not (st.is_success or st.is_wait):
            fw.run_reserve_plugins_unreserve(state, assumed, result.suggested_host)
            self._forget(assumed)
            return None, st
        return result, Status()

    def _group_key(self, pod: Pod) -> str | None:
        sg = pod.spec.scheduling_group
        return f"{pod.meta.namespace}/{sg.pod_group_name}" if sg else None

    def _forget(self, pod: Pod) -> None:
        self.cache.forget_pod(pod)
        # forgetting frees node resources outside the wave writeback
        self.mark_wave_external()
        gk = self._group_key(pod)
        if gk is not None:
            self.cache.pod_group_states.pod_unassumed(gk, pod.meta.key)

    def mark_wave_external(self, poison: bool = True) -> None:
        """Something outside the wave pipeline's own writeback changed
        cluster state: the device carry is stale (the next launch resyncs).

        poison=True (host-path assume/forget on the scheduling thread): the
        in-flight wave's results are discarded too — its kernels computed
        placements without this change, and sequential order puts the
        change FIRST. poison=False (informer events): the in-flight wave's
        pods were popped before the event, so using its results matches the
        reference's snapshot-at-cycle-start semantics (schedule_one.go:182).

        The gate is the reference's as it stands (ROADMAP C11): the wave in
        flight is poisoned only while some backend holds a carry, and a
        re-run inside a re-run window may have dropped it."""
        marked = False
        for algo in self.algorithms.values():
            backend = getattr(algo, "backend", None)
            if backend is not None and backend._carry is not None:
                backend.mark_external()
                marked = True
        if poison and marked and self._inflight_wave is not None:
            self._inflight_wave[1].mark_poisoned()

    # -- binding cycle --------------------------------------------------------------

    def _binding_cycle(
        self, state: CycleState, fw: Framework, qpi: QueuedPodInfo, result: ScheduleResult
    ) -> None:
        pod = qpi.pod
        host = result.suggested_host
        # the gang Permit wait is the dominant binding-cycle stall for gang
        # members: its own ledger segment
        gang_waiting = fw.waiting_pod(pod.meta.key) is not None
        if gang_waiting:
            self.recorder.pod_ledger.stamp(pod.meta.key, "gang_wait_start")
        st = fw.wait_on_permit(pod)
        if gang_waiting:
            self.recorder.pod_ledger.stamp(pod.meta.key, "gang_wait_end")
        if not st.is_success:
            self._handle_binding_failure(state, fw, qpi, host, st)
            return
        st = fw.run_pre_bind_plugins(state, pod, host)
        if not st.is_success:
            self._handle_binding_failure(state, fw, qpi, host, st)
            return
        self.recorder.pod_ledger.stamp(pod.meta.key, "bind_dispatch")
        st = self._bind(state, fw, pod, host)
        if not st.is_success and not st.is_skip:
            self._handle_binding_failure(state, fw, qpi, host, st)
            return
        self._finish_binding(state, fw, qpi, host)

    def _finish_binding(self, state, fw: Framework, qpi: QueuedPodInfo, host: str,
                        correlation: str | None = None) -> None:
        """Post-bind tail shared by the per-pod cycle and the wave batch."""
        pod = qpi.pod
        # ledger: the bind is durable — close the entry (a status_ack, when
        # a kubelet reports the pod Running, lands on the retained entry)
        self.recorder.pod_ledger.stamp(pod.meta.key, "bind_commit")
        self.recorder.pod_ledger.complete(pod.meta.key)
        fw.run_post_bind_plugins(state, pod, host)
        # the pod leaves the cycle for good: stop in-flight event tracking
        # only now (a done() before bind would drop events a bind failure
        # needs)
        self.queue.done(qpi.key, qpi.inflight_token)
        self.queue.delete_nominated_pod_if_exists(pod)
        if self.metrics is not None:
            self.metrics.pod_scheduled(qpi)
        if self.event_recorder is not None:
            self.event_recorder.event(pod, "Normal", "Scheduled",
                                      f"bound to {host}",
                                      correlation=correlation)
        _log.debug("Successfully bound pod %s to node %s", qpi.key, host)
        gk = self._group_key(pod)
        if gk is not None:
            self.cache.pod_group_states.pod_scheduled(gk, pod.meta.key)

    def _bind(self, state, fw: Framework, pod: Pod, host: str) -> Status:
        """bind:1136 — an interested binder extender takes precedence over
        the bind plugins (extendersBinding, schedule_one.go:1160); with
        SchedulerAsyncAPICalls the store write goes through the dispatcher
        (DefaultBinder via APICacher.bind_pod); else the bind plugins."""
        for ext in self.algorithms[fw.profile_name].extenders:
            if ext.is_binder() and ext.is_interested(pod):
                # the webhook owns the binding API write (extender.go
                # Bind:362). Until its update lands in the store the pod
                # stays assumed in the cache; if the webhook never writes,
                # the assume expires and the pod is retried
                return ext.bind(pod, host)
        if self.api_cacher is not None:
            from .api_dispatcher import CallSkippedError

            try:
                call = self.api_cacher.bind_pod(pod, host)
            except CallSkippedError as e:
                return Status.as_error(e)
            # the budget (BIND_WAIT_S) is burned in short slices so
            # a stalled dispatcher is logged while it stalls
            deadline = _time.monotonic() + BIND_WAIT_S
            # the dispatcher in-flight wait is pipeline backpressure: the
            # loop cannot prep a successor while it sits here, so the time
            # lands on the stall profiler's cumulative bind_backpressure
            with self.recorder.stall_profiler.stall(None, "bind_backpressure"):
                while not call.done.wait(
                    timeout=min(_BIND_WAIT_SLICE_S,
                                max(0.0, deadline - _time.monotonic()))
                ):
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        return Status.as_error(TimeoutError(
                            f"async bind of {pod.meta.key} timed out after "
                            f"{BIND_WAIT_S}s"
                        ))
                    _log.error("async bind of %s to %s still pending; %.1f s left",
                               pod.meta.key, host, remaining)
            if call.error is not None:
                return Status.as_error(call.error)
            return Status()
        return fw.run_bind_plugins(state, pod, host)

    def _handle_binding_failure(self, state, fw, qpi, host, status: Status) -> None:
        """handleBindingCycleError (schedule_one.go:504) — unreserve, forget,
        requeue via AssignedPodDelete movement."""
        from .framework import events as ev
        from .framework.events import ClusterEvent

        pod = qpi.pod
        fw.run_reserve_plugins_unreserve(state, pod, host)
        self._forget(pod)
        self.queue.move_all_to_active_or_backoff(
            ClusterEvent(ev.ASSIGNED_POD, ev.DELETE, "BindFailure"), None, None
        )
        self._handle_scheduling_failure(fw, qpi, status, self.queue.moved_count)

    def _handle_scheduling_failure(
        self, fw: Framework, qpi: QueuedPodInfo, status: Status, cycle: int
    ) -> None:
        """handleSchedulingFailure:1188 — requeue + PodScheduled condition.
        The queue keeps the backoff counters on re-add
        (scheduling_queue.go:924-932)."""
        pod = qpi.pod
        if status.plugin:
            qpi.unschedulable_plugins.add(status.plugin)
        self.queue.add_unschedulable_if_not_present(qpi, cycle)
        self._patch_condition(pod, status)
        if self.event_recorder is not None:
            self.event_recorder.event(
                pod, "Warning", "FailedScheduling", status.message()
            )
        _log.debug("Unable to schedule pod %s; waiting: %s", qpi.key,
                   status.message())
        if self.metrics is not None:
            self.metrics.pod_unschedulable(qpi)

    # -- API writeback ----------------------------------------------------------------

    def _patch_condition(self, pod: Pod, status: Status) -> None:
        from ..api.types import PodCondition

        cur = self.store.try_get("Pod", pod.meta.key)
        if cur is None:
            return
        reason = "Unschedulable" if status.is_rejected else "SchedulerError"
        msg = status.message()
        for c in cur.status.conditions:
            if c.type == "PodScheduled":
                if c.reason == reason and c.message == msg:
                    return
                break
        condition = PodCondition("PodScheduled", "False", reason, msg)
        if self.api_cacher is not None:
            # SchedulerAsyncAPICalls: status writes ride the dispatcher so
            # failure handling never blocks the loop (api_cache.go:29-61)
            from .api_dispatcher import CallSkippedError

            try:
                self.api_cacher.patch_pod_status(pod, condition=condition)
            except CallSkippedError:
                pass
            return
        for c in cur.status.conditions:
            if c.type == "PodScheduled":
                c.status, c.reason, c.message = "False", reason, msg
                break
        else:
            cur.status.conditions.append(condition)
        try:
            self.store.update(cur, check_version=False)
        except Exception:  # noqa: BLE001
            pass

    def _patch_nominated_node(self, pod: Pod, node_name: str) -> None:
        if self.api_cacher is not None:
            from .api_dispatcher import CallSkippedError

            try:
                self.api_cacher.patch_pod_status(pod, nominated_node=node_name)
            except CallSkippedError:
                pass
            return
        cur = self.store.try_get("Pod", pod.meta.key)
        if cur is None:
            return
        cur.status.nominated_node_name = node_name
        try:
            self.store.update(cur, check_version=False)
        except Exception:  # noqa: BLE001
            pass

    def wait_for_bindings(self) -> None:
        # a launched-but-uncollected wave holds popped pods: never leave it
        infl = self._inflight_wave
        if infl is not None:
            self.recorder.stall_profiler.mark_gap(infl[1].record, "flush")
        self._flush_wave_pipeline()
        for t in self._binding_threads:
            t.join(timeout=5)
        self._binding_threads.clear()
        self._drain_wave_completions()
