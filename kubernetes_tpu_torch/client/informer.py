"""Shared informers over the Store.

Reference: client-go tools/cache — Reflector (reflector.go) feeds DeltaFIFO
(delta_fifo.go) feeds SharedIndexInformer (shared_informer.go) which fans out
to event handlers and maintains a thread-safe store. Here the Store's watch
log already provides a gap-free ordered stream, so the informer reduces to:
list (sync local cache, emit Adds) + watch (pump events to handlers).

Determinism: `pump()` drains available events synchronously — tests and the
single-threaded scheduler loop call it at well-defined points instead of
racing a background goroutine.

A copy of the reference package's module (kubernetes_tpu/client/informer.py)
less its cache-mutation detector, its threaded pump and its branches for
store facades other than the port's Store.
"""

from __future__ import annotations

from typing import Any, Callable

from ..store.store import Store, Event, ADDED, MODIFIED, DELETED

Handler = Callable[[str, Any, Any], None]  # (event_type, old_obj, new_obj)


class SharedInformer:
    def __init__(self, store: Store, kind: str):
        self._store = store
        self.kind = kind
        self._cache: dict[str, Any] = {}
        self._handlers: list[Handler] = []
        self._watch = None
        self._synced = False
        # revision-continuity tracking (partition detection):
        #   _last_rev  — store revision this cache is known current through
        #   _last_seq  — per-kind event seq of the last delivered event
        #                (None = stream without seq support; tracking off)
        # A delivered event jumping the seq by more than one means the
        # stream LOST events (an interior gap); the log holding an event
        # newer than _last_rev after a full pump means the stream is
        # silently stale (a tail gap — the open-partition case).
        self._last_rev = 0
        self._last_seq: int | None = None
        self._gap = False
        self._gap_rev = 0
        self.partitions_detected = 0
        self._partition_observer: Callable[[str, int, float], None] | None = None

    def add_handler(self, handler: Handler) -> None:
        """Register a handler. If already synced, replays Adds for the current
        cache contents (client-go AddEventHandler semantics)."""
        self._handlers.append(handler)
        if self._synced:
            for obj in list(self._cache.values()):
                handler(ADDED, None, obj)

    def start(self) -> None:
        """List + open watch. Emits ADDED for the initial list. A relist
        covers the (heavy-churn) case where the list revision is compacted
        out of the watch window before the watch opens — the reflector's
        "too old resource version" retry."""
        from ..store.store import CompactedError

        while True:
            objs, rev = self._store.list(self.kind)
            try:
                self._watch = self._store.watch(self.kind, from_revision=rev)
                break
            except CompactedError:
                continue
        for obj in objs:
            self._cache[obj.meta.key] = obj
            for h in self._handlers:
                h(ADDED, None, obj)
        self._last_rev = rev
        self._last_seq = self._watch.start_seq
        self._synced = True

    def has_synced(self) -> bool:
        return self._synced

    def pump(self) -> int:
        """Drain all currently queued watch events; returns count processed."""
        if self._watch is None:
            return 0
        n = 0
        for ev in self._watch.drain():
            seq = ev.seq
            if self._last_seq is not None and seq:
                if seq > self._last_seq + 1 and not self._gap:
                    # interior gap: events between _last_seq and this one
                    # never arrived, even though delivery has resumed
                    self._gap = True
                    self._gap_rev = self._last_rev
                self._last_seq = max(self._last_seq, seq)
            if ev.revision:
                self._last_rev = max(self._last_rev, ev.revision)
            self._dispatch(ev)
            n += 1
        return n

    def resync(self) -> int:
        """Repair lost watch deliveries: diff the local cache against an
        atomic store relist + watch swap; dispatch synthesized events for
        every difference. Returns the number of repairs.

        A dropped delivery (lossy connection, injected watch.deliver fault)
        leaves the cache permanently stale — the event is gone from the
        stream even though it sits in the store's log. client-go answers
        with the reflector's periodic resync; ours is cheaper because
        Store.sync_watch hands back refs and a fresh watch under ONE lock
        acquisition, so there is no replay window to double-deliver."""
        if not self._synced:
            return 0
        # drain the old stream first so the diff only covers true losses
        self.pump()
        refs, new_watch, rev = self._store.sync_watch(self.kind)
        old_watch, self._watch = self._watch, new_watch
        if old_watch is not None:
            old_watch.stop()
        # restart the continuity bookmarks from the sync point — captured
        # under the SAME lock as the relist, so neither under- nor
        # overshoots: an earlier value would re-flag the diff-repaired
        # events as a gap forever, a later one would hide real losses
        self._last_rev = rev
        self._last_seq = new_watch.start_seq
        self._gap = False
        self._gap_rev = 0
        n = 0
        seen = set()
        for obj in refs:
            key = obj.meta.key
            seen.add(key)
            cached = self._cache.get(key)
            if cached is None:
                self._dispatch(Event(ADDED, obj, obj.meta.resource_version))
                n += 1
            elif (cached.meta.resource_version
                  != obj.meta.resource_version):
                self._dispatch(Event(MODIFIED, obj,
                                     obj.meta.resource_version,
                                     prev_obj=cached))
                n += 1
        for key in [k for k in self._cache if k not in seen]:
            gone = self._cache[key]
            self._dispatch(Event(DELETED, gone,
                                 gone.meta.resource_version))
            n += 1
        return n

    def set_partition_observer(
        self, cb: Callable[[str, int, float], None] | None
    ) -> None:
        """cb(kind, repaired_count, repair_latency_s) fires once per
        detected partition, right after the repairing resync."""
        self._partition_observer = cb

    def detect_and_repair(self) -> int:
        """Partition self-heal: pump, then check revision continuity; on a
        gap, resync immediately and report the repair latency (now minus
        the emit time of the first event the stream lost).

        Detection is exact, not heuristic: watch delivery is synchronous
        under the store lock, so after a full pump any logged event newer
        than `_last_rev` was dropped, and any seq jump seen during the
        pump brackets events that will never arrive. No-gap cost is one
        store revision read. Returns the number of repaired cache entries
        (0 when no gap, and also when the gap's objects were already
        superseded by later deliveries)."""
        if not self._synced or self._watch is None:
            return 0
        self.pump()
        gap_rev: int | None = self._gap_rev if self._gap else None
        if gap_rev is None and self._store.latest_revision(self.kind) > self._last_rev:
            gap_rev = self._last_rev
        if gap_rev is None:
            return 0
        hit = self._store.first_event_after(self.kind, gap_rev)
        lost_ts = hit[1] if hit is not None else None
        repaired = self.resync()  # clears _gap, re-bookmarks atomically
        self.partitions_detected += 1
        latency_s = 0.0
        if lost_ts is not None:
            import time as _time

            latency_s = max(_time.perf_counter() - lost_ts, 0.0)
        if self._partition_observer is not None:
            self._partition_observer(self.kind, repaired, latency_s)
        return repaired

    def _dispatch(self, ev) -> None:
        key = ev.obj.meta.key
        if ev.type == DELETED:
            old = self._cache.pop(key, None)
            for h in self._handlers:
                h(DELETED, old if old is not None else ev.obj, ev.obj)
        elif key in self._cache:
            old = self._cache[key]
            self._cache[key] = ev.obj
            for h in self._handlers:
                h(MODIFIED, old, ev.obj)
        else:
            self._cache[key] = ev.obj
            for h in self._handlers:
                h(ADDED, None, ev.obj)

    def stop(self) -> None:
        if self._watch is not None:
            self._watch.stop()

    # local read interface (client-go Lister)
    def get(self, key: str) -> Any | None:
        return self._cache.get(key)

    def list(self) -> list[Any]:
        return list(self._cache.values())

    def keys(self) -> list[str]:
        return list(self._cache.keys())


class InformerFactory:
    """SharedInformerFactory: one informer per kind, shared across components."""

    def __init__(self, store: Store):
        self._store = store
        self._informers: dict[str, SharedInformer] = {}
        self._partition_observer: Callable[[str, int, float], None] | None = None

    def informer(self, kind: str) -> SharedInformer:
        inf = self._informers.get(kind)
        if inf is None:
            inf = SharedInformer(self._store, kind)
            inf.set_partition_observer(self._partition_observer)
            self._informers[kind] = inf
        return inf

    def start_all(self) -> None:
        for inf in self._informers.values():
            if not inf.has_synced():
                inf.start()

    def pump_all(self) -> int:
        return sum(inf.pump() for inf in self._informers.values())

    def stop_all(self) -> None:
        """Tear down every informer's watch stream."""
        for inf in self._informers.values():
            inf.stop()

    def resync_all(self) -> int:
        """Diff-repair every informer's cache (see SharedInformer.resync)."""
        return sum(inf.resync() for inf in self._informers.values())

    def detect_and_repair_all(self) -> int:
        """Run every informer's partition detector; resyncs only the
        informers with an actual gap (cheap when the streams are healthy —
        one revision probe per kind)."""
        return sum(inf.detect_and_repair() for inf in self._informers.values())

    def set_partition_observer(
        self, cb: Callable[[str, int, float], None] | None
    ) -> None:
        """Install cb on every existing AND future informer."""
        self._partition_observer = cb
        for inf in self._informers.values():
            inf.set_partition_observer(cb)

    def wait_for_cache_sync(self) -> bool:
        return all(inf.has_synced() for inf in self._informers.values())
