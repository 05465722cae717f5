"""Scheduler object: wiring of store, informers, cache, queue, profiles and
the scheduling loop.

Reference: pkg/scheduler/scheduler.go (Scheduler struct :67, New :273,
Run :536) + eventhandlers.go (addAllEventHandlers :481). A copy of the
reference package's module (kubernetes_tpu/scheduler/scheduler.py):

    store → informers → SchedulingQueue → ScheduleOneLoop → store

Every profile schedules through the port's device backend (TorchBackend,
TorchSchedulingAlgorithm, which routes the pods and gangs the kernels do
not model to its host tier): with wave_size > 0, schedule_pending pops
runs of up to wave_size pods and places each run in one K1 + K2 launch
(K1 + K6 under a MeshContext), chained on the device carry one wave ahead
of the host's assumes and binds; with wave_size 0 each pod takes the
per-pod cycle (K4). The backend runs on `device` ("cuda" unless the
caller passes "cpu"; without a card and without device="cpu" the
constructor raises). The reference's backend="host" profile, the plain
host algorithm alone, is not a profile of the port.

HTTP extenders (`extenders`: ExtenderConfig or HTTPExtender objects, or
objects with HTTPExtender's interface) filter, prioritize and bind the pods
they are interested in; such pods take the hybrid route around K4.

Telemetry, as the reference wires it: one wave recorder
(`flight_recorder`, tpu/waverecorder.py) shared by the loop, every backend
and the dispatcher — phase stopwatches, wave records, the pod latency
ledger the event handlers stamp (watch_arrival, queue_admission,
status_ack), the stall profiler and the device telemetry; `metrics` (a
SchedulerMetrics) reaches the frameworks' sampled plugin timings, the
batch cache, the dispatcher, the event recorder and the loop; `tracer`
(utils.tracing.Tracer) gets the phase, wave and api spans. Both are off
(None) by default, and no decision reads any of it.

Not in this slice, each queued in ROADMAP: the crash-recovery reconcile
(`reconcile`, `adopt_shard`: A13; `start()` syncs the informers only), the
warm start (A9) and the fleet's shard filter (A13).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from ..api.resource import ResourceNames
from ..api.types import DEFAULT_SCHEDULER_NAME, RUNNING, Node, Pod
from ..client.informer import InformerFactory
from ..config.types import validate_profiles
from ..store.store import ADDED, DELETED, MODIFIED, Store
from .cache import Cache, Snapshot
from .extender import ExtenderConfig, HTTPExtender
from .framework import events as ev
from .framework.events import ClusterEvent
from .framework.runtime import Framework, Handle
from .nodeinfo import PodInfo
from .plugins.registry import DEFAULT_WEIGHTS, default_plugins
from .queue.scheduling_queue import SchedulingQueue
from .schedule_one import ScheduleOneLoop
from .tpu.backend import KERNEL_FILTER_PLUGINS, TorchBackend, TorchSchedulingAlgorithm


@dataclass
class Profile:
    name: str = DEFAULT_SCHEDULER_NAME
    percentage_of_nodes_to_score: int = 0
    plugin_args: dict = field(default_factory=dict)
    weights: dict = field(default_factory=lambda: dict(DEFAULT_WEIGHTS))
    backend: str = "tpu"  # the port's device backend, the only one
    # per-profile plugin disable list (config PluginSet.disabled; "*" with
    # enabled names = whitelist, per the reference's profile semantics)
    disabled_plugins: tuple = ()
    enabled_plugins: tuple = ()  # only meaningful with "*" in disabled
    # >0: schedule_pending pops runs of up to wave_size
    # pods and schedules each run in one device launch (equal to per-pod,
    # see ScheduleOneLoop.schedule_wave) — the throughput mode
    wave_size: int = 0


def _apply_plugin_set(plugins: list, prof: Profile) -> list:
    """Per-profile enable/disable (apis/config Plugins semantics): names in
    disabled are removed; disabled=("*",) whitelists enabled_plugins. The
    infrastructural plugins every cycle needs (QueueSort, Bind) survive a
    bare wildcard unless explicitly disabled by name."""
    disabled = set(prof.disabled_plugins)
    if not disabled:
        return plugins
    if "*" in disabled:
        keep = set(prof.enabled_plugins) | {"PrioritySort", "DefaultBinder"}
        return [p for p in plugins if p.name in keep]
    return [p for p in plugins if p.name not in disabled]


class Scheduler:
    def __init__(
        self,
        store: Store,
        profiles: list[Profile] | None = None,
        names: ResourceNames | None = None,
        feature_gates: dict | None = None,
        clock=None,
        metrics=None,
        seed: int = 0,
        async_binding: bool = False,
        async_api_calls: bool = False,
        parallelism: int = 16,
        event_recorder=None,
        extenders: list | None = None,
        tracer=None,
        device="cuda",
    ):
        from ..utils.clock import Clock
        from .tpu.waverecorder import WaveRecorder

        profiles = profiles or [Profile()]
        errs = validate_profiles(profiles)
        if errs:
            raise ValueError("; ".join(errs))
        self.store = store
        self.names = names or ResourceNames()
        self.clock = clock or Clock()
        self.metrics = metrics
        self.tracer = tracer
        # one wave recorder shared by the loop, every device backend and
        # the dispatcher: the phase stopwatches, per-wave records, the pod
        # ledger, the stall profiler, the device telemetry and the
        # slow-wave watchdog live here
        self.flight_recorder = WaveRecorder(tracer=tracer, metrics=metrics)
        if event_recorder is None:
            # every scheduler emits Scheduled/FailedScheduling events
            # (schedule_one.go:1174,1273); the recorder buffers + aggregates
            # so the binding path only appends to a dict
            from .events import EventRecorder

            event_recorder = EventRecorder(store)
        self.event_recorder = event_recorder
        if metrics is not None and getattr(event_recorder, "metrics", None) is None:
            # spill/aggregation/GC visibility: the recorder lands counters
            # on the shared registry
            event_recorder.metrics = metrics
        self.cache = Cache(self.names)
        self.snapshot = Snapshot()
        self.feature_gates = dict(feature_gates or {})
        # a config becomes an HTTPExtender; anything else is taken as one
        self.extenders = [HTTPExtender(e) if isinstance(e, ExtenderConfig) else e
                          for e in (extenders or [])]

        self.wave_size = max(p.wave_size for p in profiles)
        self.frameworks: dict[str, Framework] = {}
        self.algorithms: dict[str, TorchSchedulingAlgorithm] = {}
        handles: list[Handle] = []
        pre_enqueue = []
        hint_map: dict = {}
        less_fn = None
        for prof in profiles:
            plugins = default_plugins(self.names, self.feature_gates,
                                      prof.plugin_args, store=store)
            plugins = _apply_plugin_set(plugins, prof)
            missing = KERNEL_FILTER_PLUGINS - {p.name for p in plugins}
            if missing:
                raise ValueError(
                    f"profile {prof.name!r}: kernel-modeled plugins "
                    f"{sorted(missing)} cannot be disabled (the kernels "
                    f"always run them)"
                )
            # the handle's queue is wired below, once the queue exists;
            # set_handle runs now, and the plugins read the handle late
            handle = Handle(store=store, cache=self.cache, snapshot=self.snapshot)
            handles.append(handle)
            fw = Framework(plugins, prof.weights, profile_name=prof.name,
                           clock=self.clock, handle=handle, metrics=metrics)
            self.frameworks[prof.name] = fw
            backend = TorchBackend(self.names, plugin_args=prof.plugin_args,
                                   device=device, recorder=self.flight_recorder)
            # the nominator is wired below once the queue exists
            self.algorithms[prof.name] = TorchSchedulingAlgorithm(
                fw, backend, rng=random.Random(seed),
                host_tail_percentage=prof.percentage_of_nodes_to_score,
                extenders=self.extenders,
            )
            pre_enqueue = fw.pre_enqueue_plugins  # last profile wins (single-profile typical)
            hint_map.update(fw.queueing_hint_map())
            if less_fn is None:
                less_fn = fw.queue_sort_less

        self.queue = SchedulingQueue(
            less_fn or (lambda a, b: a.timestamp < b.timestamp),
            clock=self.clock,
            pre_enqueue_plugins=pre_enqueue,
            queueing_hint_map=hint_map,
            pop_from_backoff=self.feature_gates.get(
                "SchedulerPopFromBackoffQ", True
            ),
        )
        for handle in handles:
            handle.queue = self.queue
        # OpportunisticBatching (KEP-5598, alpha -> default off as in the
        # reference): one shared batch cache; flushed on node-shape events
        self.batch_cache = None
        if self.feature_gates.get("OpportunisticBatching", False):
            from .framework.batch import BatchCache

            self.batch_cache = BatchCache(metrics=metrics)
        for algo in self.algorithms.values():
            # the queue is the one nominator (algo.nominator = self.queue,
            # reference scheduler.py:214-216)
            algo.nominator = self.queue
            algo.batch = self.batch_cache

        # SchedulerAsyncAPICalls: bind/status writes through the dispatcher
        self.api_dispatcher = None
        self.api_cacher = None
        if async_api_calls:
            from .api_dispatcher import APICacher, APIDispatcher

            self.api_dispatcher = APIDispatcher(parallelism, metrics=metrics,
                                                tracer=tracer,
                                                recorder=self.flight_recorder)
            self.api_dispatcher.run()
            self.api_cacher = APICacher(store, self.api_dispatcher)
            # event flushes ride the dispatcher too
            self.event_recorder.dispatcher = self.api_dispatcher
        for handle in handles:
            # DefaultPreemption's evictions ride it (reference
            # scheduler.py:235-236)
            handle.api_dispatcher = self.api_dispatcher

        self.loop = ScheduleOneLoop(
            self.cache,
            self.queue,
            self.frameworks,
            self.algorithms,
            store,
            self.snapshot,
            metrics=metrics,
            async_binding=async_binding,
            event_recorder=event_recorder,
            names=self.names,
            api_cacher=self.api_cacher,
            pod_group_cycles=self.feature_gates.get("GenericWorkload", True),
            recorder=self.flight_recorder,
        )

        self._last_leftover_flush = self.clock.now()

        # informers (addAllEventHandlers, eventhandlers.go:481)
        self.informers = InformerFactory(store)
        self.informers.set_partition_observer(
            self.flight_recorder.partition_detected
        )
        self.informers.informer("Pod").add_handler(self._on_pod_event)
        self.informers.informer("Node").add_handler(self._on_node_event)
        self.informers.informer("PodGroup").add_handler(self._on_podgroup_event)
        # dynamic handlers for the event resources the plugins' hints
        # register (eventhandlers.go:481 — only kinds some hint listens to
        # get informers): the volume plugins' and DynamicResources' kinds
        registered = {
            h.event.resource
            for hints in hint_map.values()
            for h in hints
        }
        for kind in (ev.PVC, ev.PV, ev.STORAGE_CLASS, ev.CSI_NODE,
                     ev.RESOURCE_CLAIM, ev.RESOURCE_SLICE):
            if kind in registered:
                self.informers.informer(kind).add_handler(
                    self._make_generic_handler(kind)
                )

    # -- event handlers (eventhandlers.go) ----------------------------------

    def _group_key(self, pod: Pod) -> str | None:
        sg = pod.spec.scheduling_group
        return f"{pod.meta.namespace}/{sg.pod_group_name}" if sg else None

    def _mark_external(self) -> None:
        """Informer-observed external change: stale the wave carry but keep
        the in-flight wave's results (its pods were popped before the event
        — reference snapshot-at-cycle-start semantics)."""
        self.loop.mark_wave_external(poison=False)

    def _on_pod_event(self, etype: str, old: Pod | None, new: Pod) -> None:
        gk = self._group_key(new)
        ledger = self.flight_recorder.pod_ledger
        if etype == ADDED:
            if new.is_scheduled:
                if not self.cache.is_assumed_pod(new):
                    # a bound pod we did not place (foreign writer)
                    self._mark_external()
                self.cache.add_pod(new)
                if gk:
                    self.cache.pod_group_states.pod_scheduled(gk, new.meta.key)
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(ev.ASSIGNED_POD, ev.ADD), None, new
                )
            else:
                # ledger edges: the informer delivered the pod, then it
                # entered the scheduling queue (the informer segment spans
                # PodInfo construction + queue admission)
                ledger.stamp(new.meta.key, "watch_arrival")
                if gk:
                    self.cache.pod_group_states.pod_added(gk, new.meta.key)
                self.queue.add(new, PodInfo(new, self.names))
                ledger.stamp(new.meta.key, "queue_admission")
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(ev.UNSCHEDULED_POD, ev.ADD), None, new
                )
        elif etype == MODIFIED:
            if new.is_scheduled:
                if old is not None and not old.is_scheduled:
                    if not self.cache.is_assumed_pod(new):
                        self._mark_external()
                    # bind landed: the cache confirms the assume
                    self.cache.add_pod(new)
                    if gk:
                        self.cache.pod_group_states.pod_scheduled(gk, new.meta.key)
                    self.queue.move_all_to_active_or_backoff(
                        ClusterEvent(ev.ASSIGNED_POD, ev.ADD), old, new
                    )
                else:
                    # update of a placed pod (labels/scale-down) changes the
                    # node planes outside the wave pipeline's writeback
                    if (old is not None and old.status.phase != RUNNING
                            and new.status.phase == RUNNING):
                        # a kubelet reported the pod up: the ledger's last
                        # edge
                        ledger.stamp(new.meta.key, "status_ack")
                    self._mark_external()
                    self.cache.update_pod(old, new)
                    action = self._pod_update_actions(old, new)
                    if action:
                        self.queue.move_all_to_active_or_backoff(
                            ClusterEvent(ev.ASSIGNED_POD, action), old, new
                        )
            else:
                self.queue.update(old, new)
                action = self._pod_update_actions(old, new)
                if action:
                    self.queue.move_all_to_active_or_backoff(
                        ClusterEvent(ev.UNSCHEDULED_POD, action), old, new
                    )
        elif etype == DELETED:
            if gk:
                self.cache.pod_group_states.pod_removed(gk, new.meta.key)
            if self.metrics is not None and hasattr(self.metrics, "forget_pod"):
                self.metrics.forget_pod(new.meta.key)
            ledger.forget(new.meta.key)
            if new.is_scheduled:
                self._mark_external()
                self.cache.remove_pod(new)
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(ev.ASSIGNED_POD, ev.DELETE), new, None
                )
            else:
                self.queue.delete(new)

    def _pod_update_actions(self, old: Pod | None, new: Pod) -> int:
        """OR of action bits describing what changed (eventhandlers.go
        podSchedulingPropertiesChange) — never a guess of a single bit."""
        if old is None:
            return ev.UPDATE
        action = 0
        if old.meta.labels != new.meta.labels:
            action |= ev.UPDATE_POD_LABEL
        if old.spec.tolerations != new.spec.tolerations:
            action |= ev.UPDATE_POD_TOLERATIONS
        if old.spec.scheduling_gates != new.spec.scheduling_gates and not new.spec.scheduling_gates:
            action |= ev.UPDATE_POD_SCHEDULING_GATES_ELIMINATED
        old_req = PodInfo(old, self.names).request
        new_req = PodInfo(new, self.names).request
        if any(n < o for o, n in zip(old_req.v, new_req.v)):
            action |= ev.UPDATE_POD_SCALE_DOWN
        return action

    def _on_node_event(self, etype: str, old: Node | None, new: Node) -> None:
        self._mark_external()
        if self.batch_cache is not None:
            # node shape changed: cached sorted score lists are stale
            self.batch_cache.flush()
        if etype == ADDED:
            self.cache.add_node(new)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(ev.NODE, ev.ADD), None, new
            )
        elif etype == MODIFIED:
            self.cache.update_node(old, new)
            action = 0
            if old is not None:
                if old.status.allocatable != new.status.allocatable:
                    action |= ev.UPDATE_NODE_ALLOCATABLE
                if old.meta.labels != new.meta.labels:
                    action |= ev.UPDATE_NODE_LABEL
                if old.spec.taints != new.spec.taints:
                    action |= ev.UPDATE_NODE_TAINT
                if old.spec.unschedulable != new.spec.unschedulable:
                    action |= ev.UPDATE_NODE_TAINT
            if action:
                self.queue.move_all_to_active_or_backoff(
                    ClusterEvent(ev.NODE, action), old, new
                )
        elif etype == DELETED:
            self.cache.remove_node(new)

    def _make_generic_handler(self, kind: str):
        """Storage/DRA kinds only move queued pods; there is no cache state."""

        def handler(etype: str, old, new) -> None:
            action = {ADDED: ev.ADD, MODIFIED: ev.UPDATE, DELETED: ev.DELETE}[etype]
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(kind, action), old, new
            )

        return handler

    def _on_podgroup_event(self, etype: str, old, new) -> None:
        if etype in (ADDED, MODIFIED):
            self.cache.pod_group_states.set_group(new)
            self.queue.move_all_to_active_or_backoff(
                ClusterEvent(ev.POD_GROUP, ev.ADD), old, new
            )
        elif etype == DELETED:
            self.cache.pod_group_states.remove_group(new.meta.key)

    # -- run -----------------------------------------------------------------

    def start(self) -> None:
        """Sync the informers (initial list). The reference then reconciles
        state a crashed predecessor left behind and, with warm_start,
        pre-builds its kernels; those come with A13 and A9."""
        self.informers.start_all()

    def pump(self) -> int:
        """Drain informer events (deterministic single-thread mode)."""
        with self.flight_recorder.phase("pump"):
            n = self.informers.pump_all()
        # event-recorder flush + leftover sweep, accounted apart from
        # informer pumping
        with self.flight_recorder.phase("events"):
            # periodic safety net (reference: 30s ticker -> 5 min leftover
            # flush)
            now = self.clock.now()
            if now - self._last_leftover_flush > 30.0:
                self._last_leftover_flush = now
                self.queue.flush_unschedulable_leftover()
            if self.event_recorder is not None:
                # cadence-gated (and dispatcher-offloaded when async API
                # calls are on): the per-iteration cost here is a clock read
                self.event_recorder.maybe_flush()
            if self.metrics is not None and hasattr(self.metrics,
                                                    "update_queue_gauges"):
                active, backoff, unsched = self.queue.pending_pods()
                self.metrics.update_queue_gauges(active, backoff, unsched)
        return n

    def schedule_pending(self, max_cycles: int = 100_000) -> int:
        """Run scheduling cycles until the queue stays empty; returns count.

        Each cycle pumps informers first so bind results confirm assumes.
        """
        scheduled = 0
        idle_rounds = 0
        for _ in range(max_cycles):
            self.pump()
            if self.wave_size > 0:
                n = self.loop.schedule_wave(self.wave_size, timeout=0.0)
            else:
                n = 1 if self.loop.schedule_one(timeout=0.0) else 0
            if n == 0:
                idle_rounds += 1
                if self.api_dispatcher is not None:
                    # flush queued async binds so their events confirm
                    # assumes before declaring the queue drained
                    with self.flight_recorder.phase("drain"):
                        self.api_dispatcher.drain(timeout=1.0)
                # a lost watch delivery can strand a pod invisible to the
                # queue: consult the partition detector on every idle round
                with self.flight_recorder.phase("pump"):
                    repaired = self.informers.detect_and_repair_all()
                if repaired:
                    idle_rounds = 0
                if idle_rounds > 2:
                    break
                continue
            idle_rounds = 0
            scheduled += n
        self.loop.wait_for_bindings()
        self.pump()
        return scheduled

    def run_forever(self, stop_event) -> None:
        """Threaded mode: pump + schedule until stop_event set."""
        while not stop_event.is_set():
            self.pump()
            self.loop.schedule_one(timeout=0.05)
