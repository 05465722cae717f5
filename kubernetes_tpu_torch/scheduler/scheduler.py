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

The restart path, as in the reference: `start()` syncs the informers,
then `reconcile()` resolves what a crashed predecessor left half-applied
against store truth (assumed pods, half-bound gangs, stale permit
quorums), and with `warm_start=True` `_run_warmup()` builds and loads the
kernel libraries and launches every kernel once per static configuration
the waves will meet (scheduler/tpu/warmup.py), so the first real wave pays
no first use. A fleet member (scheduler/fleet.py) installs `shard_filter`
and calls `adopt_shard` when it takes a shard over.
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
    # fleet ownership predicate (installed by scheduler/fleet.py, its one
    # writer). None = own every pod, the single-scheduler default. When
    # set, _on_pod_event ignores non-owned unbound pods at admission; the
    # queue and loop carry the same predicate on their own gates.
    shard_filter = None

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
        warm_start: bool = False,
        context=None,
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
        # warm start (scheduler/tpu/warmup.py): start() ends by building the
        # kernels and launching each once per static configuration. Off by
        # default; decisions are the same either way
        self.warm_start = warm_start
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
                                   device=device, recorder=self.flight_recorder,
                                   context=context)
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
                # fleet gate: a peer's pod never enters this member's queue
                # (its owner admits it; the bound-pod branches above stay
                # ungated so every member's cache mirrors all occupancy)
                sf = self.shard_filter
                if sf is not None and not sf(new):
                    return
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
        """Sync the informers (initial list), then reconcile half-applied
        state a previous incarnation may have left behind; with warm_start,
        end by building the kernels and launching each at the static
        configurations the waves will meet, so the first real wave pays no
        first use."""
        self.informers.start_all()
        self.reconcile(shard_pred=self.shard_filter)
        if self.warm_start:
            self._run_warmup()

    def _run_warmup(self) -> list[dict]:
        """Warm every profile's backend against the live node planes (after
        the informer sync: bucket sizes come from the synced cache), with
        warm pods shaped like the oldest pending pod this member owns, if
        any. Returns each backend's warmup summary."""
        from .tpu.warmup import warm_backend

        self.cache.update_snapshot(self.snapshot)
        sf = self.shard_filter
        template = next((p for p in self._list_refs("Pod")
                         if not p.is_scheduled and (sf is None or sf(p))), None)
        self.warmup_summaries = [
            warm_backend(algo.backend, self.snapshot, self.wave_size,
                         template=template)
            for algo in self.algorithms.values()]
        return self.warmup_summaries

    def _list_refs(self, kind: str) -> list:
        """Read-only listing duck-typed against the narrower RESTStore
        surface (list() only), so a scheduler fronted by the API server
        reconciles the same way as one on the in-process Store."""
        if hasattr(self.store, "list_refs"):
            return self.store.list_refs(kind)
        return self.store.list(kind)[0]

    def reconcile(self, shard_pred=None, kind_prefix: str = "") -> dict:
        """Startup crash recovery: resolve every piece of mid-flight state a
        previous incarnation may have left behind against store truth. Three
        sweeps (the reference's reconcile, scheduler.py:469-601):

        1. Assumed-but-unconfirmed pods (orphaned assumes from in-flight
           waves, dispatcher calls lost between prepare and commit). Store
           truth decides: bound → adopt; gone → forget; unbound → forget +
           requeue (the bind never happened).
        2. Half-bound PodGroups (a crash between members' binds):
           all-or-nothing across restart — when the members can still reach
           quorum, activate the pending remainder for the gang cycle; when
           they cannot, release (delete) every landed member.
        3. Stale gang Permit quorum state: group-state `assumed` entries
           backed by neither a live cache assume nor a store bind revert
           to unscheduled, or are promoted to scheduled when the bind
           landed.

        Every outcome lands on the recorder's restart_events and the
        scheduler_restart_recoveries_total{kind} series; gang/permit kinds
        appear in the returned stats only when non-zero. A sweep that
        changed occupancy drops any live device carry.

        `shard_pred` scopes every sweep to one fleet member's ownership
        (None = own everything): a member never forgets or requeues a
        peer's in-flight pod. `kind_prefix` namespaces the recorded kinds
        (the fleet's adoption records "shard_adopt_*")."""
        stats = {"adopted": 0, "forgotten": 0, "requeued": 0}
        for pod in self.cache.assumed_pods():
            if shard_pred is not None and not shard_pred(pod):
                continue  # a peer's in-flight assume: not ours to resolve
            key = pod.meta.key
            cur = self.store.try_get("Pod", key)
            if cur is None:
                self.cache.forget_pod(pod)
                stats["forgotten"] += 1
                continue
            if cur.spec.node_name:
                # the bind landed (possibly on another node than assumed):
                # add_pod confirms a matching assume, re-places a divergent one
                self.cache.add_pod(cur)
                stats["adopted"] += 1
                continue
            # half-applied: assumed in the cache, the store write never landed
            self.cache.forget_pod(pod)
            stats["forgotten"] += 1
            # clear any stale in-flight queue record surviving the crash
            # (token None clears unconditionally), then requeue
            self.queue.done(key)
            self.queue.add(cur, PodInfo(cur, self.names))
            stats["requeued"] += 1

        # -- sweep 2: half-bound PodGroups against store truth ------------
        gang_adopt = gang_release = 0
        members: dict[str, list] = {}
        for p in self._list_refs("Pod"):
            gk = self._group_key(p)
            if gk is not None:
                members.setdefault(gk, []).append(p)
        for g in self._list_refs("PodGroup"):
            gk = g.meta.key
            mem = members.get(gk, [])
            # gangs shard by group key: one member decides the whole gang
            if shard_pred is not None and mem and not shard_pred(mem[0]):
                continue
            bound = [p for p in mem if p.spec.node_name]
            if not bound or len(bound) >= g.spec.policy.min_count:
                continue  # the whole gang landed, or nothing did
            if len(mem) >= g.spec.policy.min_count:
                # salvageable: the pending remainder can still reach quorum
                self.queue.activate([p for p in mem if not p.spec.node_name])
                gang_adopt += 1
            else:
                # the remainder can never reach quorum: release the landed
                for p in bound:
                    try:
                        self.store.delete("Pod", p.meta.key)
                    except Exception:  # noqa: BLE001 — a racing deletion
                        pass
                gang_release += 1

        # -- sweep 3: stale gang Permit quorum state ----------------------
        permit_cleared = 0
        live_assumes = {p.meta.key for p in self.cache.assumed_pods()}
        for gk, gstate in self.cache.pod_group_states.snapshot().items():
            mem = members.get(gk, [])
            if shard_pred is not None and mem and not shard_pred(mem[0]):
                continue  # a peer's gang quorum state
            for key in gstate.assumed:
                if key in live_assumes:
                    continue  # a real assume: sweep 1 owns its fate
                cur = self.store.try_get("Pod", key)
                if cur is not None and cur.spec.node_name:
                    # the bind landed but the quorum state never advanced
                    self.cache.pod_group_states.pod_scheduled(gk, key)
                else:
                    # the assume died with the old incarnation
                    self.cache.pod_group_states.pod_unassumed(gk, key)
                permit_cleared += 1

        if gang_adopt:
            stats["gang_adopt"] = gang_adopt
        if gang_release:
            stats["gang_release"] = gang_release
        if permit_cleared:
            stats["permit_cleared"] = permit_cleared
        for kind, n in stats.items():
            self.flight_recorder.restart_recovery(kind_prefix + kind, n)
        if stats["adopted"] or stats["forgotten"] or gang_release:
            # node occupancy changed under any live device carry
            self._mark_external()
        return stats

    def adopt_shard(self, shard_pred, kind_prefix: str = "shard_adopt_") -> dict:
        """Fleet shard adoption (scheduler/fleet.py calls this when a
        member acquires a shard — at boot, or after a dead peer's lease
        expired): the reconcile() sweeps scoped to the shard, plus a
        requeue pass for the shard's pending pods this member's admission
        gate had been filtering out while a peer owned them. Outcomes
        count on restart_recoveries{kind="<kind_prefix>*"}."""
        stats = self.reconcile(shard_pred=shard_pred, kind_prefix=kind_prefix)
        pending = 0
        for pod in self._list_refs("Pod"):
            if pod.is_scheduled or not shard_pred(pod):
                continue
            key = pod.meta.key
            if self.queue.has_pod(key) or self.cache.is_assumed_pod(pod):
                continue
            # register gang membership first: the admission gate skipped
            # pod_added while a peer owned this shard, and the gang cycle
            # pops siblings from gstate.unscheduled
            gk = self._group_key(pod)
            if gk is not None:
                self.cache.pod_group_states.pod_added(gk, key)
            # clear any stale in-flight record, then admit through the
            # queue's own gate (the shard is owned now, so it passes)
            self.queue.done(key)
            self.queue.add(pod, PodInfo(pod, self.names))
            pending += 1
        if pending:
            stats["pending"] = pending
            self.flight_recorder.restart_recovery(kind_prefix + "pending",
                                                  pending)
        return stats

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
