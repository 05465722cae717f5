"""Shared informers over the Store.

Reference: client-go tools/cache — Reflector (reflector.go) feeds DeltaFIFO
(delta_fifo.go) feeds SharedIndexInformer (shared_informer.go) which fans out
to event handlers and maintains a thread-safe store. Here the Store's watch
log already provides a gap-free ordered stream, so the informer reduces to:
list (sync local cache, emit Adds) + watch (pump events to handlers).

Determinism: `pump()` drains available events synchronously — tests and the
single-threaded scheduler loop call it at well-defined points instead of
racing a background goroutine. `run_background()` gives the threaded mode.

A copy of the reference package's module (kubernetes_tpu/client/informer.py).
It runs on the port's Store and on a RESTStore (client/rest.py), whose
watch carries no sequence numbers and which has no sync_watch or revision
probes.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ..store.store import Store, Event, ADDED, MODIFIED, DELETED

Handler = Callable[[str, Any, Any], None]  # (event_type, old_obj, new_obj)


class CacheMutationDetected(Exception):
    """An informer-cache object was mutated in place. Informer caches are
    shared read-only state (client-go's contract); a consumer that edits a
    cached object corrupts every other consumer's view. The reference's
    detector (client-go/tools/cache/mutation_detector.go, enabled by
    KUBE_CACHE_MUTATION_DETECTOR) panics the process; we raise."""


def _mutation_detector_enabled() -> bool:
    import os

    return os.environ.get("KUBERNETES_TPU_CACHE_MUTATION_DETECTOR", "") not in (
        "", "0", "false",
    )


class SharedInformer:
    def __init__(self, store: Store, kind: str):
        self._store = store
        self.kind = kind
        self._cache: dict[str, Any] = {}
        self._handlers: list[Handler] = []
        self._watch = None
        self._synced = False
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # mutation detector: pristine deepcopies to compare against
        self._detect = _mutation_detector_enabled()
        self._pristine: dict[str, Any] = {}
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
            if self._detect:
                import copy as _copy

                self._pristine[obj.meta.key] = _copy.deepcopy(obj)
            for h in self._handlers:
                h(ADDED, None, obj)
        self._last_rev = rev
        self._last_seq = getattr(self._watch, "start_seq", None)
        self._synced = True

    def has_synced(self) -> bool:
        return self._synced

    def pump(self) -> int:
        """Drain all currently queued watch events; returns count processed."""
        if self._watch is None:
            return 0
        if self._detect:
            self.check_mutations()
        n = 0
        for ev in self._watch.drain():
            seq = getattr(ev, "seq", 0)
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
        sync = getattr(self._store, "sync_watch", None)
        if sync is not None:
            res = sync(self.kind)
            if len(res) == 3:
                refs, new_watch, rev = res
            else:  # pre-revision facade
                refs, new_watch = res
                rev = None
        else:
            # facade without the primitive: non-atomic list+watch; events
            # landing in between replay through the new watch, which is
            # harmless (MODIFIED re-dispatch) but not gap-free in theory
            refs, rev = self._store.list(self.kind)
            new_watch = self._store.watch(self.kind, from_revision=rev)
        old_watch, self._watch = self._watch, new_watch
        if old_watch is not None:
            old_watch.stop()
        # restart the continuity bookmarks from the sync point — captured
        # under the SAME lock as the relist, so neither under- nor
        # overshoots: an earlier value would re-flag the diff-repaired
        # events as a gap forever, a later one would hide real losses
        if rev is not None:
            self._last_rev = rev
        self._last_seq = getattr(new_watch, "start_seq", None)
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
        if gap_rev is None:
            probe = getattr(self._store, "latest_revision", None)
            if probe is not None and probe(self.kind) > self._last_rev:
                gap_rev = self._last_rev
        if gap_rev is None:
            return 0
        lost_ts: float | None = None
        first = getattr(self._store, "first_event_after", None)
        if first is not None:
            hit = first(self.kind, gap_rev)
            if hit is not None:
                lost_ts = hit[1]
        repaired = self.resync()  # clears _gap, re-bookmarks atomically
        self.partitions_detected += 1
        latency_s = 0.0
        if lost_ts is not None:
            import time as _time

            latency_s = max(_time.perf_counter() - lost_ts, 0.0)
        if self._partition_observer is not None:
            self._partition_observer(self.kind, repaired, latency_s)
        return repaired

    def check_mutations(self) -> None:
        """Compare every cached object against its pristine copy; raises
        CacheMutationDetected on any in-place edit. Called automatically
        per pump when the detector env is set; tests may call directly."""
        for key, obj in self._cache.items():
            pristine = self._pristine.get(key)
            if pristine is not None and obj != pristine:
                raise CacheMutationDetected(
                    f"{self.kind} {key} was mutated in the informer cache"
                )

    def _dispatch(self, ev) -> None:
        import copy as _copy

        key = ev.obj.meta.key
        if ev.type == DELETED:
            old = self._cache.pop(key, None)
            self._pristine.pop(key, None)
            for h in self._handlers:
                h(DELETED, old if old is not None else ev.obj, ev.obj)
        elif key in self._cache:
            old = self._cache[key]
            self._cache[key] = ev.obj
            if self._detect:
                self._pristine[key] = _copy.deepcopy(ev.obj)
            for h in self._handlers:
                h(MODIFIED, old, ev.obj)
        else:
            self._cache[key] = ev.obj
            if self._detect:
                self._pristine[key] = _copy.deepcopy(ev.obj)
            for h in self._handlers:
                h(ADDED, None, ev.obj)

    def run_background(self, poll_interval: float = 0.002) -> None:
        """Threaded pump, for components that want push-style delivery."""
        if self._thread is not None:
            return

        def loop():
            while not self._stop.is_set():
                ev = self._watch.next(timeout=poll_interval)
                if ev is not None:
                    with self._mu:
                        self._dispatch(ev)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=1)
            self._thread = None

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
        """Tear down every informer's watch stream. The chaos restart
        driver uses this as its stand-in for process death: a crashed
        scheduler's watch connections drop server-side, so the store must
        stop queueing deliveries for a consumer that no longer exists."""
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
