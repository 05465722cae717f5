"""EventRecorder: "Scheduled" / "FailedScheduling" events as API objects.

Reference: client-go tools/events EventRecorder + the events.k8s.io Event
type — the scheduler emits an event per binding and per failure
(pkg/scheduler/schedule_one.go:1174,1273). The reference's recorder is an
async broadcaster with aggregation (an EventSeries bumps a count instead of
minting a new object for repeats); this recorder buffers and aggregates the
same way and flushes batches to the store, so the hot binding path only
appends to a list.

A copy of the reference package's module (kubernetes_tpu/scheduler/events.py).
"""

from __future__ import annotations

import inspect
import threading
import time

from ..api.events import Event
from ..api.meta import ObjectMeta


class EventRecorder:
    """Buffered, aggregating recorder; thread-safe appends, batched flush."""

    # events older than this are garbage-collected (the reference relies on
    # the apiserver's event TTL, default 1h)
    EVENT_TTL_S = 3600.0
    # sweep the stored events after this many writes since the last sweep
    GC_EVERY_WRITES = 512
    # ... but never sweep more often than this (the sweep walks every stored
    # event; it belongs on a slow timer, not the scheduling hot loop)
    GC_MIN_INTERVAL_S = 30.0
    # correlation spill threshold (the reference correlator's
    # EventAggregator, defaultAggregateMaxEvents=10): the first N events
    # sharing a correlation key stay individual; the rest collapse into ONE
    # aggregate object whose count keeps climbing
    AGGREGATE_SPILL = 10
    # maybe_flush cadence: the scheduler pump calls it every iteration, but
    # store writes happen at most this often
    FLUSH_INTERVAL_S = 0.25

    def __init__(self, store, component: str = "default-scheduler",
                 max_buffer: int = 4096):
        self.store = store
        self.component = component
        # the in-process Store returns no copy when asked; a RESTStore
        # takes no copy_return
        self._create_kw = ({"copy_return": False}
                           if "copy_return" in inspect.signature(
                               store.create).parameters else {})
        self._mu = threading.Lock()
        # (involved, type, reason, message) -> pending Event
        self._pending: dict[tuple, Event] = {}
        self._seq = 0
        self._max_buffer = max_buffer
        self._writes_since_gc = 0
        # events recorded per (correlation, type, reason) since last flush
        self._corr_counts: dict[tuple, int] = {}
        # optional APIDispatcher: maybe_flush routes the store writes
        # through its workers so the scheduling thread never pays them
        self.dispatcher = None
        self._flush_seq = 0
        self._last_flush = float("-inf")  # monotonic
        self._last_gc = time.monotonic()
        # optional SchedulerMetrics (the Scheduler wires its own): every
        # disposition, aggregation and GC prune is counted
        self.metrics = None

    def event(self, obj, etype: str, reason: str, message: str,
              correlation: str | None = None) -> None:
        """Record one event (schedule_one.go:1174 "Scheduled",
        :1273 "FailedScheduling"). Repeats aggregate into a count.

        correlation groups similar-but-not-identical events (e.g. one wave's
        per-pod "Scheduled" events, whose messages differ by node): past
        AGGREGATE_SPILL events per key, the remainder becomes a single
        aggregate object ("combined from similar events"), exactly the
        reference correlator's spam-vs-signal compromise."""
        involved = f"{obj.kind}/{obj.meta.key}"
        now = time.time()
        flush_now = False
        with self._mu:
            aggregated = False
            if correlation is not None:
                ckey = (correlation, etype, reason)
                seen = self._corr_counts.get(ckey, 0) + 1
                self._corr_counts[ckey] = seen
                aggregated = seen > self.AGGREGATE_SPILL
            if aggregated:
                key = (correlation, etype, reason, None)
                message = f"(combined from similar events): {message}"
                involved = correlation
            else:
                key = (involved, etype, reason, message)
            ev = self._pending.get(key)
            if ev is not None:
                ev.count += 1
                ev.last_timestamp = now
                if aggregated:
                    ev.message = message  # latest representative
            else:
                # deterministic name per key: repeats aggregate into the
                # SAME stored object across flushes (EventSeries semantics),
                # never a new one per flush
                import hashlib

                digest = hashlib.sha1(
                    "|".join(k or "aggregated" for k in key).encode()
                ).hexdigest()[:12]
                name = f"{obj.meta.name}.{digest}"
                self._pending[key] = Event(
                    meta=ObjectMeta(name=name, namespace=obj.meta.namespace),
                    involved_object=involved,
                    type=etype,
                    reason=reason,
                    message=message,
                    first_timestamp=now,
                    last_timestamp=now,
                    reporting_controller=self.component,
                )
            flush_now = len(self._pending) >= self._max_buffer
        if self.metrics is not None and hasattr(self.metrics, "event_recorded"):
            self.metrics.event_recorded(aggregated)
        if flush_now:
            self.flush()

    def maybe_flush(self) -> int:
        """Hot-loop entry point: flush at most every FLUSH_INTERVAL_S, and
        through the async dispatcher when one is wired — either way the
        per-iteration cost in the scheduling loop is a clock read."""
        now = time.monotonic()
        if now - self._last_flush < self.FLUSH_INTERVAL_S:
            return 0
        with self._mu:
            if not self._pending:
                return 0
        self._last_flush = now
        if self.dispatcher is not None:
            from .api_dispatcher import APICall

            self._flush_seq += 1
            self.dispatcher.add(APICall(
                "event_flush", f"__events__/{self._flush_seq}",
                self.flush,
            ))
            return 0
        return self.flush()

    def flush(self) -> int:
        """Write buffered events to the store; returns how many landed."""
        with self._mu:
            pending, self._pending = self._pending, {}
            self._corr_counts.clear()
        n = 0
        for ev in pending.values():
            try:
                existing = self.store.try_get("Event", ev.meta.key)
                if existing is not None:
                    existing.count += ev.count
                    existing.last_timestamp = ev.last_timestamp
                    existing.message = ev.message
                    self.store.update(existing, check_version=False)
                else:
                    # copy_return=False: the returned copy is discarded, and
                    # at one event per bound pod the deepcopy is a
                    # measurable slice of scheduling wall time (a RESTStore
                    # takes no copy_return)
                    self.store.create(ev, **self._create_kw)
                n += 1
            except Exception:  # noqa: BLE001 - events are best-effort
                pass
        self._writes_since_gc += n
        now_m = time.monotonic()
        if (self._writes_since_gc >= self.GC_EVERY_WRITES
                and now_m - self._last_gc >= self.GC_MIN_INTERVAL_S):
            self._writes_since_gc = 0
            self._last_gc = now_m
            self._gc()
        return n

    def _gc(self) -> int:
        """Expire stored events past the TTL — the store has no apiserver
        event TTL, so unbounded churny runs would otherwise leak objects.
        Returns how many series it pruned (previously discarded silently)."""
        cutoff = time.time() - self.EVENT_TTL_S
        pruned = 0
        try:
            # read-only scan (list_refs): a deepcopying list() would grow
            # O(stored-events) per sweep
            if hasattr(self.store, "list_refs"):
                events = self.store.list_refs("Event")
            else:
                events, _ = self.store.list("Event")
            expired = [ev.meta.key for ev in events
                       if ev.last_timestamp < cutoff]
            for key in expired:
                self.store.delete("Event", key)
                pruned += 1
        except Exception:  # noqa: BLE001
            pass
        if self.metrics is not None and hasattr(self.metrics, "events_pruned"):
            self.metrics.events_pruned(pruned)
        return pruned
