"""The 3-tier priority scheduling queue with QueueingHint-driven requeue.

Reference: pkg/scheduler/backend/queue/scheduling_queue.go (PriorityQueue),
active_queue.go (in-flight pods + in-flight cluster events), backoff_queue.go
(separate error vs unschedulable exponential backoff), unschedulable_pods.go.

Tiers:
- activeQ:           heap ordered by the QueueSort plugin; Pop() blocks here.
- backoffQ:          heap ordered by backoff expiry; flushed to activeQ.
- unschedulablePods: parked pods waiting for a cluster event that a rejecting
                     plugin's QueueingHintFn says could make them schedulable.

In-flight event tracking: events arriving while a pod is mid-cycle are
recorded and replayed when the pod comes back unschedulable, so concurrent
cluster changes are never lost (active_queue.go:378-450).

A copy of the reference package's queue
(kubernetes_tpu/scheduler/queue/scheduling_queue.py), with the fleet's
shard gate at admission (`shard_filter`, installed by scheduler/fleet.py)
and `prune` for a lost shard. The queue is the scheduler's one nominator, as
in the reference: it holds a Nominator (nominator.py) and answers its
calls, and a deleted pod leaves both.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable

from ...api.types import Pod
from ...utils.clock import Clock
from ..framework import events as fwk_events
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE
from ..framework.interface import Status
from ..nodeinfo import PodInfo
from .heap import KeyedHeap
from .nominator import Nominator

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # scheduling_queue.go:79
DEFAULT_POD_MAX_BACKOFF = 10.0  # scheduling_queue.go:83
DEFAULT_MAX_IN_UNSCHEDULABLE_PODS = 300.0  # scheduling_queue.go:66


class QueuedPodInfo:
    """Reference: staging/.../framework/types.go QueuedPodInfo :316-331."""

    __slots__ = (
        "pod_info",
        "timestamp",
        "initial_attempt_timestamp",
        "attempts",
        "unschedulable_count",
        "consecutive_errors_count",
        "gated",
        "gating_plugin",
        "unschedulable_plugins",
        "pending_plugins",
        "backoff_expiry",
        "inflight_token",
    )

    def __init__(self, pod_info: PodInfo, now: float):
        self.pod_info = pod_info
        self.timestamp = now
        self.initial_attempt_timestamp: float | None = None
        self.attempts = 0
        self.unschedulable_count = 0
        self.consecutive_errors_count = 0
        self.gated = False
        self.gating_plugin = ""
        self.unschedulable_plugins: set[str] = set()
        self.pending_plugins: set[str] = set()
        self.backoff_expiry = 0.0
        self.inflight_token = None  # _InFlightPod of the CURRENT attempt

    @property
    def pod(self) -> Pod:
        return self.pod_info.pod

    @property
    def key(self) -> str:
        return self.pod_info.key


class _InFlightPod:
    __slots__ = ("key", "event_seq")

    def __init__(self, key: str, event_seq: int):
        self.key = key
        self.event_seq = event_seq


class SchedulingQueue:
    # fleet ownership predicate at queue admission (installed by
    # scheduler/fleet.py, its one writer): None = admit everything. A
    # non-owned pod never enters any tier.
    shard_filter = None

    def __init__(
        self,
        less_fn: Callable[[QueuedPodInfo, QueuedPodInfo], bool],
        clock: Clock | None = None,
        pre_enqueue_plugins: list | None = None,
        queueing_hint_map: dict[str, list[ClusterEventWithHint]] | None = None,
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        pod_max_in_unschedulable_pods: float = DEFAULT_MAX_IN_UNSCHEDULABLE_PODS,
        pop_from_backoff: bool = True,
    ):
        self._clock = clock or Clock()
        self._mu = threading.Condition()
        self._active = KeyedHeap[QueuedPodInfo](lambda q: q.key, less_fn)
        self._backoff = KeyedHeap[QueuedPodInfo](
            lambda q: q.key, lambda a, b: a.backoff_expiry < b.backoff_expiry
        )
        # error backoffs live in their OWN heap (backoff_queue.go
        # podErrorBackoffQ): pop-from-backoff must never short-circuit an
        # error backoff — it exists to protect the apiserver
        self._error_backoff = KeyedHeap[QueuedPodInfo](
            lambda q: q.key, lambda a, b: a.backoff_expiry < b.backoff_expiry
        )
        self._unschedulable: dict[str, QueuedPodInfo] = {}
        self._pre_enqueue = pre_enqueue_plugins or []
        # plugin name -> its registered events+hints
        self._hint_map = queueing_hint_map or {}
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        # SchedulerPopFromBackoffQ (kube_features.go:913, default on since
        # 1.33): an idle scheduler pops the earliest-expiry backoff pod
        # instead of sleeping out the window — retries (nominated
        # preemptors especially) stop paying whole backoff windows
        self._pop_from_backoff = pop_from_backoff
        self._max_unschedulable_duration = pod_max_in_unschedulable_pods
        # in-flight tracking
        self._event_seq = itertools.count(1)
        self._event_log: list[tuple[int, ClusterEvent, Any, Any]] = []
        self._in_flight: dict[str, _InFlightPod] = {}
        self._min_inflight_seq: int | None = None  # gc cache (monotonic)
        self._closed = False
        self.moved_count = 0  # schedulingCycle counter for AddUnschedulableIfNotPresent
        # nominator (backend/queue/nominator.go)
        self.nominator = Nominator()

    # -- helpers -----------------------------------------------------------

    def _run_pre_enqueue(self, qpi: QueuedPodInfo) -> bool:
        """Returns True if admitted to activeQ; sets gated on rejection."""
        for pl in self._pre_enqueue:
            st: Status | None = pl.pre_enqueue(qpi.pod)
            if st is not None and not st.is_success:
                qpi.gated = True
                qpi.gating_plugin = pl.name
                qpi.unschedulable_plugins.add(pl.name)
                return False
        qpi.gated = False
        qpi.gating_plugin = ""
        return True

    # backoffQ ordering window (backoff_queue.go:38): expiries snap to
    # window boundaries so same-window pods flush together and ordering is
    # stable under arrival jitter. The reference uses 1s because its flush
    # ticker fires once per second; our flusher is pop-driven, so a 100ms
    # window gives the same ordering stability without stretching every
    # retry by up to a second.
    BACKOFF_ORDERING_WINDOW = 0.1

    def _align_to_window(self, t: float) -> float:
        """alignToWindow (backoff_queue.go:140): expiries snap to window
        boundaries so whole windows flush together. We snap UP — a backoff
        may stretch to the next boundary but can never run SHORTER than
        computed (flooring against a raw now would cut it by up to a
        window)."""
        w = self.BACKOFF_ORDERING_WINDOW
        return -(-t // w) * w

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        """backoff_queue.go getBackoffTime:217-246 — the error count drives
        the exponent while the LAST cycle errored (it resets on a plain
        unschedulable rejection); otherwise the unschedulable count does."""
        count = qpi.unschedulable_count
        if qpi.consecutive_errors_count > 0:
            count = qpi.consecutive_errors_count
        if count == 0:
            return 0.0
        # cap the exponent before floating: a long failure streak must
        # saturate at max backoff, not overflow
        duration = self._initial_backoff * (2 ** min(count - 1, 40))
        return min(duration, self._max_backoff)

    def _move_to_active_or_backoff_locked(self, qpi: QueuedPodInfo, event_label: str) -> None:
        now = self._clock.now()
        if qpi.pending_plugins:
            # Pending (vs Unschedulable) skips backoff (scheduling_queue.go —
            # hinted by a plugin that declared the pod schedulable now)
            self._active.add(qpi)
            self._mu.notify()
            return
        duration = self._backoff_duration(qpi)
        expiry = self._align_to_window(qpi.timestamp + duration)
        if duration > 0 and expiry > now:
            qpi.backoff_expiry = expiry
            if qpi.consecutive_errors_count > 0:
                self._error_backoff.add(qpi)
            else:
                self._backoff.add(qpi)
        else:
            self._active.add(qpi)
            self._mu.notify()

    # -- public API --------------------------------------------------------

    def add(self, pod: Pod, pod_info: PodInfo | None = None) -> None:
        from ...api.resource import ResourceNames

        sf = self.shard_filter
        if sf is not None and not sf(pod):
            return  # a peer's shard: its owner queues it
        with self._mu:
            pi = pod_info or PodInfo(pod, ResourceNames())
            qpi = QueuedPodInfo(pi, self._clock.now())
            if self._run_pre_enqueue(qpi):
                self._active.add(qpi)
                self._mu.notify()
            else:
                self._unschedulable[qpi.key] = qpi

    def update(self, old_pod: Pod | None, new_pod: Pod) -> None:
        """Refresh the stored pod object wherever it is queued; a gated pod is
        re-evaluated through PreEnqueue (scheduling_queue.go Update)."""
        with self._mu:
            key = new_pod.meta.key
            for heap in (self._active, self._backoff, self._error_backoff):
                qpi = heap.get(key)
                if qpi is not None:
                    qpi.pod_info.pod = new_pod
                    return
            qpi = self._unschedulable.get(key)
            if qpi is not None:
                qpi.pod_info.pod = new_pod
                if qpi.gated and self._run_pre_enqueue(qpi):
                    del self._unschedulable[key]
                    qpi.timestamp = self._clock.now()
                    self._active.add(qpi)
                    self._mu.notify()
                return
            if key not in self._in_flight:
                self.add(new_pod)

    def delete(self, pod: Pod) -> None:
        with self._mu:
            key = pod.meta.key
            self._active.delete(key)
            self._backoff.delete(key)
            self._error_backoff.delete(key)
            self._unschedulable.pop(key, None)
            self.nominator.delete_nominated_pod_if_exists(pod)

    def pop(self, timeout: float | None = None) -> QueuedPodInfo | None:
        with self._mu:
            self._flush_backoff_locked()
            while (len(self._active) == 0 and not self._closed
                   and not (self._pop_from_backoff and len(self._backoff))):
                if not self._mu.wait(timeout=timeout if timeout is not None else 0.1):
                    if timeout is not None:
                        return None
                self._flush_backoff_locked()
                if (timeout is not None and len(self._active) == 0
                        and not (self._pop_from_backoff
                                 and len(self._backoff))):
                    return None
            if self._closed:
                return None
            if len(self._active):
                qpi = self._active.pop()
            else:
                # activeQ drained: pop the earliest-expiry backoff pod
                # early (backoff_queue.go popBackoffQ semantics)
                qpi = self._backoff.pop()
            qpi.attempts += 1
            # each attempt reports its OWN rejectors (the reference replaces
            # UnschedulablePlugins per failure, never accumulates): a stale
            # set would misclassify a later error as a plugin rejection and
            # park a retriable pod
            qpi.unschedulable_plugins = set()
            qpi.pending_plugins = set()
            if qpi.initial_attempt_timestamp is None:
                qpi.initial_attempt_timestamp = self._clock.now()
            qpi.inflight_token = self._insert_in_flight_locked(qpi.key)
            return qpi

    def pop_specific(self, key: str) -> QueuedPodInfo | None:
        """Remove a specific pod from whichever tier holds it (gang popping,
        scheduling_queue.go PopSpecificPod:1017)."""
        with self._mu:
            qpi = (self._active.delete(key) or self._backoff.delete(key)
                   or self._error_backoff.delete(key))
            if qpi is None:
                qpi = self._unschedulable.pop(key, None)
            if qpi is None:
                return None
            qpi.attempts += 1
            qpi.unschedulable_plugins = set()
            qpi.pending_plugins = set()
            if qpi.initial_attempt_timestamp is None:
                qpi.initial_attempt_timestamp = self._clock.now()
            qpi.inflight_token = self._insert_in_flight_locked(qpi.key)
            return qpi

    def _insert_in_flight_locked(self, key: str) -> "_InFlightPod":
        """Record a popped pod as in-flight. Delete-before-insert keeps the
        dict ordered by seq even when a key is RE-popped while an earlier
        incarnation is still in flight (delete+recreate racing an async
        binding) — a plain assignment would keep the key's OLD position
        with the NEW (largest) seq, and the O(1) first-entry min in
        _gc_event_log_locked would then overstate the minimum and drop
        event-log entries other in-flight pods still need. The displaced
        incarnation's seq is GC'd immediately: a stale cached minimum
        pointing at a seq nobody holds would disable log GC until the
        in-flight set empties."""
        old = self._in_flight.pop(key, None)
        if old is not None:
            self._gc_event_log_locked(old.event_seq)
        rec = _InFlightPod(key, next(self._event_seq))
        self._in_flight[key] = rec
        return rec

    def done(self, key: str, token=None) -> None:
        """Finish a pod's cycle. `token` (QueuedPodInfo.inflight_token) pins
        the call to ONE incarnation: when a pod was deleted + recreated under
        the same key while the first incarnation was mid-binding, the first
        incarnation's done() must not pop the second's in-flight record (its
        mid-flight events would then never replay)."""
        with self._mu:
            p = self._in_flight.get(key)
            if p is None:
                self._gc_event_log_locked(None)
                return
            if token is not None and p is not token:
                # a newer incarnation owns the record; ours was displaced
                # (and GC'd) at its re-pop — nothing to do
                return
            del self._in_flight[key]
            self._gc_event_log_locked(p.event_seq)

    def _gc_event_log_locked(self, removed_seq: int | None = None) -> None:
        """Amortized: event seqs are monotonic, so the in-flight minimum
        only moves when the CURRENT minimum leaves — recomputing it on
        every done() made wave draining O(wave²) in in-flight scans."""
        if not self._event_log:
            if not self._in_flight:
                self._min_inflight_seq = None
            elif (removed_seq is not None
                  and removed_seq == self._min_inflight_seq):
                # the cached minimum just left while the log was empty: a
                # stale cache would satisfy `removed_seq > min` for every
                # later pod (seqs are monotonic) and disable GC forever
                self._min_inflight_seq = None
            return
        if not self._in_flight:
            self._event_log.clear()
            self._min_inflight_seq = None
            return
        if (self._min_inflight_seq is not None and removed_seq is not None
                and removed_seq > self._min_inflight_seq):
            return  # the min didn't change; the log can't shrink
        # seqs are assigned monotonically at insert and dicts preserve
        # insertion order, so the oldest in-flight pod is the FIRST entry —
        # an O(1) read where min() over values made head-of-line done()
        # calls (a draining wave) O(wave²)
        self._min_inflight_seq = next(
            iter(self._in_flight.values())
        ).event_seq
        self._event_log = [
            e for e in self._event_log if e[0] > self._min_inflight_seq
        ]

    def add_unschedulable_if_not_present(self, qpi: QueuedPodInfo, pod_scheduling_cycle: int) -> None:
        """Return a pod after a failed attempt (scheduling_queue.go:905).

        Replays cluster events that fired while the pod was in flight; if any
        matches a rejecting plugin's hint, the pod re-enters backoff/active
        instead of parking in unschedulablePods.
        """
        with self._mu:
            key = qpi.key
            inflight = self._in_flight.get(key)
            if (inflight is not None and qpi.inflight_token is not None
                    and inflight is not qpi.inflight_token):
                # the record belongs to a NEWER incarnation of this key
                # (delete+recreate raced our binding); leave it for them
                inflight = None
            elif inflight is not None:
                del self._in_flight[key]
            qpi.timestamp = self._clock.now()
            # scheduling_queue.go:924-932 — rejected by no plugin means an
            # unexpected error (backoff counts errors); a plugin rejection
            # resets the error streak
            if not qpi.unschedulable_plugins and not qpi.pending_plugins:
                qpi.consecutive_errors_count += 1
            else:
                qpi.unschedulable_count += 1
                qpi.consecutive_errors_count = 0
            removed_seq = inflight.event_seq if inflight is not None else None
            if qpi.gated:
                self._unschedulable[key] = qpi
                self._gc_event_log_locked(removed_seq)
                return
            requeue = False
            if inflight is not None:
                for seq, ev, old, new in self._event_log:
                    if seq <= inflight.event_seq:
                        continue
                    if self._is_worth_requeuing(qpi, ev, old, new):
                        requeue = True
                        break
            self._gc_event_log_locked(removed_seq)
            if not requeue and not qpi.unschedulable_plugins and not qpi.pending_plugins:
                # rejected by no plugin (scheduler/bind error): retriable — go
                # through backoff, never park (reference: backoffQ for errors)
                requeue = True
            if requeue:
                self._move_to_active_or_backoff_locked(qpi, "inflight-event")
            else:
                self._unschedulable[key] = qpi

    def _is_worth_requeuing(self, qpi: QueuedPodInfo, ev: ClusterEvent, old: Any, new: Any) -> bool:
        """scheduling_queue.go isPodWorthRequeuing:488 — consult only the hint
        functions of plugins that rejected this pod."""
        rejectors = qpi.unschedulable_plugins | qpi.pending_plugins
        if not rejectors:
            return True  # rejected by no plugin (e.g. error) — any event helps
        for plugin_name in rejectors:
            for ewh in self._hint_map.get(plugin_name, []):
                if not ewh.event.match(ev):
                    continue
                if ewh.queueing_hint_fn is None:
                    return True
                try:
                    if ewh.queueing_hint_fn(qpi.pod, old, new) == QUEUE:
                        return True
                except Exception:
                    return True  # hint error -> requeue (fail open)
        return False

    def move_all_to_active_or_backoff(self, ev: ClusterEvent, old: Any = None, new: Any = None,
                                      precheck: Callable[[QueuedPodInfo], bool] | None = None) -> None:
        """Cluster event arrived: requeue matching unschedulable pods
        (scheduling_queue.go MoveAllToActiveOrBackoffQueue:1273)."""
        with self._mu:
            self._event_log.append((next(self._event_seq), ev, old, new))
            self.moved_count += 1
            moved = []
            for key, qpi in self._unschedulable.items():
                if qpi.gated:
                    # A gated pod re-runs PreEnqueue when an event matches its
                    # gating plugin's registered events (reference: gated pods
                    # are re-admitted event-driven, not only on pod update).
                    rejectors = qpi.unschedulable_plugins | {qpi.gating_plugin}
                    saved = qpi.unschedulable_plugins
                    qpi.unschedulable_plugins = rejectors
                    worth = ev.resource == fwk_events.WILDCARD or self._is_worth_requeuing(
                        qpi, ev, old, new
                    )
                    qpi.unschedulable_plugins = saved
                    if worth and self._run_pre_enqueue(qpi):
                        moved.append(key)
                    continue
                if precheck is not None and not precheck(qpi):
                    continue
                if ev.resource == fwk_events.WILDCARD or self._is_worth_requeuing(qpi, ev, old, new):
                    moved.append(key)
            for key in moved:
                # backoff expiry counts from the rejection timestamp, so a pod
                # parked longer than its backoff goes straight to activeQ
                qpi = self._unschedulable.pop(key)
                self._move_to_active_or_backoff_locked(qpi, str(ev))

    def activate(self, pods: Iterable[Pod]) -> None:
        """Force pods into activeQ (gang siblings, Permit allow)."""
        with self._mu:
            for pod in pods:
                key = pod.meta.key
                qpi = (self._unschedulable.pop(key, None)
                       or self._backoff.delete(key)
                       or self._error_backoff.delete(key))
                if qpi is None:
                    continue
                qpi.timestamp = self._clock.now()
                self._active.add(qpi)
            self._mu.notify_all()

    def prune(self, keep: Callable[[Pod], bool]) -> int:
        """Drop every QUEUED pod failing `keep` from all three tiers (a
        fleet member losing a shard lease calls this before its next pop —
        the new owner requeues the pods from store truth). In-flight pods
        are left alone: their cycle resolves through the pop-side shard
        gate and the store's CAS, never by yanking state mid-cycle."""
        removed = 0
        with self._mu:
            for heap in (self._active, self._backoff, self._error_backoff):
                for key in list(heap.keys()):
                    qpi = heap.get(key)
                    if qpi is not None and not keep(qpi.pod):
                        heap.delete(key)
                        self.nominator.delete_nominated_pod_if_exists(qpi.pod)
                        removed += 1
            for key in [k for k, q in self._unschedulable.items()
                        if not keep(q.pod)]:
                qpi = self._unschedulable.pop(key)
                self.nominator.delete_nominated_pod_if_exists(qpi.pod)
                removed += 1
        return removed

    def _flush_backoff_locked(self) -> None:
        now = self._clock.now()
        for heap in (self._backoff, self._error_backoff):
            while True:
                head = heap.peek()
                if head is None or head.backoff_expiry > now:
                    break
                self._active.add(heap.pop())
                self._mu.notify()

    def flush_unschedulable_leftover(self) -> None:
        """Pods parked longer than podMaxInUnschedulablePodsDuration re-enter
        (scheduling_queue.go flushUnschedulablePodsLeftover:985)."""
        with self._mu:
            now = self._clock.now()
            expired = [
                k
                for k, q in self._unschedulable.items()
                if not q.gated and now - q.timestamp > self._max_unschedulable_duration
            ]
            for k in expired:
                self._move_to_active_or_backoff_locked(self._unschedulable.pop(k), "leftover")

    # -- nominator ----------------------------------------------------------

    def add_nominated_pod(self, pod: Pod, node_name: str, pod_info: PodInfo | None = None) -> None:
        self.nominator.add_nominated_pod(pod, node_name, pod_info)

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        self.nominator.delete_nominated_pod_if_exists(pod)

    def nominated_pods_for_node(self, node_name: str) -> list[str]:
        return self.nominator.nominated_pods_for_node(node_name)

    def nominated_pod_info(self, key: str) -> PodInfo | None:
        return self.nominator.nominated_pod_info(key)

    def nominated_node_for(self, pod: Pod) -> str:
        return self.nominator.nominated_node_for(pod)

    def max_nominated_priority(self, exclude_key: str | None = None) -> int | None:
        return self.nominator.max_nominated_priority(exclude_key)

    def has_nominated_pods(self) -> bool:
        return self.nominator.has_nominated_pods()

    # -- introspection -------------------------------------------------------

    def pending_pods(self) -> tuple[int, int, int]:
        with self._mu:
            return (len(self._active),
                    len(self._backoff) + len(self._error_backoff),
                    len(self._unschedulable))

    def has_pod(self, key: str) -> bool:
        with self._mu:
            return (key in self._active or key in self._backoff
                    or key in self._error_backoff
                    or key in self._unschedulable)

    def close(self) -> None:
        with self._mu:
            self._closed = True
            self._mu.notify_all()
