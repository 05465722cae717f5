"""In-process versioned store with watch streams.

Reference behavior modeled:
- etcd3 store (staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go):
  monotonically increasing cluster-wide revision; every write bumps it and
  stamps the object's resource_version.
- optimistic concurrency: update with a stale resource_version fails with
  ConflictError (apiserver 409).
- watch (etcd3 watcher + apiserver watch cache): per-(kind) event log with
  list+watch-from-revision semantics so reflectors never miss events.

The store is the control-plane contract and stays on the host; kernels see
only the cache's snapshots as planes. Thread-safe via one mutex; watch
delivery is synchronous fan-out into per-watcher deques drained by consumer
threads or polls.

A copy of the reference package's pure-Python store
(kubernetes_tpu/store/store.py); its native twin (store/native.py) is not
copied.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from ..api.meta import new_uid
from ..utils import faultinject

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class ConflictError(Exception):
    pass


class NotFoundError(Exception):
    pass


class AlreadyExistsError(Exception):
    pass


class CompactedError(Exception):
    """The requested watch start revision precedes the compacted log window
    (etcd's ErrCompacted → apiserver 410 Gone). The client must relist."""

    def __init__(self, requested: int, oldest: int):
        super().__init__(
            f"revision {requested} compacted (oldest retained: {oldest})"
        )
        self.requested = requested
        self.oldest = oldest


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    obj: Any
    revision: int
    # wall-clock emit time (time.perf_counter); consumers like the perf
    # harness's throughput collector need true write times, not drain times
    ts: float = 0.0
    # previous object state on MODIFIED (the watch cache's
    # watchCacheEvent.PrevObject): lets selector-filtered watches detect an
    # object transitioning out of (or into) the selector and synthesize
    # DELETED/ADDED, exactly as staging/.../storage/cacher does
    prev_obj: Any = None
    # per-KIND contiguous sequence number stamped at emit (1, 2, 3, ...).
    # Revisions are global across kinds, so a Pod watcher seeing revisions
    # 5, 9, 12 cannot tell a delivery gap from other kinds' writes — seq
    # is what makes the informer's continuity check exact. 0 = synthesized
    # event (resync diff), exempt from continuity tracking.
    seq: int = 0


class Watch:
    """A single watch stream: a deque of events + condition variable.

    Equivalent to a client-go watch.Interface; `stop()` is idempotent.
    """

    def __init__(self, store: "Store", kind: str):
        self._store = store
        self._kind = kind
        self._events: list[Event] = []
        self._cond = threading.Condition()
        self._stopped = False
        # seq of the last event this stream is NOT responsible for
        # delivering (everything before it was covered by the list/replay
        # that opened the stream) — the informer's continuity bookmark
        self.start_seq = 0

    def _push(self, ev: Event) -> None:
        with self._cond:
            if self._stopped:
                return
            self._events.append(ev)
            self._cond.notify_all()

    def next(self, timeout: float | None = None) -> Event | None:
        with self._cond:
            if not self._events:
                self._cond.wait(timeout)
            if self._events:
                return self._events.pop(0)
            return None

    def drain(self) -> list[Event]:
        """Non-blocking: take all queued events."""
        with self._cond:
            evs, self._events = self._events, []
            return evs

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._events.clear()
            self._cond.notify_all()
        self._store._remove_watch(self._kind, self)

    @property
    def stopped(self) -> bool:
        return self._stopped


class Store:
    """Ordered, versioned object store for all kinds."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._mu = threading.RLock()
        self._revision = 0
        self._objects: dict[str, dict[str, Any]] = {}  # kind -> key -> obj
        self._log: dict[str, list[Event]] = {}  # kind -> event log (watch cache)
        self._watches: dict[str, list[Watch]] = {}
        self._clock = clock
        self._log_cap = 100_000  # bounded watch cache; older events compacted
        # kind → revision of the first retained event after compaction:
        # watches older than this get CompactedError (etcd compaction rev)
        self._compacted_before: dict[str, int] = {}
        # kind → last Event.seq handed out (compaction never rewinds it)
        self._seq: dict[str, int] = {}

    # -- helpers -----------------------------------------------------------

    def _bump(self) -> int:
        self._revision += 1
        return self._revision

    def _kind_of(self, obj: Any) -> str:
        return obj.kind

    def _emit(self, kind: str, ev: Event) -> None:
        ev.seq = self._seq[kind] = self._seq.get(kind, 0) + 1
        log = self._log.setdefault(kind, [])
        log.append(ev)
        if len(log) > self._log_cap:
            del log[: self._log_cap // 2]
            self._compacted_before[kind] = log[0].revision
        for w in self._watches.get(kind, []):
            # per-watcher delivery drop (chaos: a lossy watch connection).
            # _emit runs mid-write under _mu, so an ERROR-mode spec on this
            # point must NOT corrupt the store state — it degrades to a
            # drop; the event stays in the log, so a resync can repair it.
            # watch.partition is the long-lived cousin: a PARTITION spec
            # swallows a contiguous run of deliveries (a revision-RANGE
            # gap), which the informer must detect from revision
            # continuity — there is no per-event error to react to
            try:
                if faultinject.fire("watch.deliver"):
                    continue
                if faultinject.fire("watch.partition"):
                    continue
            except faultinject.FaultInjected:
                continue
            w._push(ev)

    def _remove_watch(self, kind: str, w: Watch) -> None:
        with self._mu:
            ws = self._watches.get(kind)
            if ws and w in ws:
                ws.remove(w)

    # -- CRUD --------------------------------------------------------------

    def create(self, obj: Any, *, copy_return: bool = True) -> Any:
        """copy_return=False skips the defensive copy of the returned
        object and returns None — for bulk loaders (the perf harness) that
        discard it; a deepcopy per created object is measurable at 11k
        objects."""
        faultinject.fire("store.create")  # before _mu: may sleep or raise
        with self._mu:
            kind = self._kind_of(obj)
            objs = self._objects.setdefault(kind, {})
            key = obj.meta.key
            if key in objs:
                raise AlreadyExistsError(f"{kind} {key}")
            obj = copy.deepcopy(obj)
            if not obj.meta.uid:
                obj.meta.uid = new_uid()
            if not obj.meta.creation_timestamp:
                obj.meta.creation_timestamp = self._clock()
            rev = self._bump()
            obj.meta.resource_version = rev
            objs[key] = obj
            # the event SHARES the stored object (informer convention:
            # event objects are read-only, as in client-go's shared caches
            # — bind_pod established the pattern); a deepcopy per create
            # was a measurable slice of bench setup at 11k objects
            self._emit(kind, Event(ADDED, obj, rev, time.perf_counter()))
            return copy.deepcopy(obj) if copy_return else None

    def get(self, kind: str, key: str) -> Any:
        with self._mu:
            obj = self._objects.get(kind, {}).get(key)
            if obj is None:
                raise NotFoundError(f"{kind} {key}")
            return copy.deepcopy(obj)

    def try_get(self, kind: str, key: str) -> Any | None:
        with self._mu:
            obj = self._objects.get(kind, {}).get(key)
            return copy.deepcopy(obj) if obj is not None else None

    def contains(self, kind: str, key: str) -> bool:
        """Copy-free existence check — the scheduler's skipPodSchedule runs
        once per popped pod, where try_get's deepcopy is pure overhead."""
        with self._mu:
            return key in self._objects.get(kind, {})

    def get_ref(self, kind: str, key: str) -> Any | None:
        """The stored object WITHOUT a copy (read-only by the list_refs
        convention) — for per-(pod, node) hot-loop lookups like the CSI
        attach-limit filter, where try_get's deepcopy dominated the whole
        scheduling cycle."""
        with self._mu:
            return self._objects.get(kind, {}).get(key)

    def update(self, obj: Any, *, check_version: bool = True) -> Any:
        """Optimistic-concurrency update; stamps a fresh resource_version."""
        faultinject.fire("store.update")  # before _mu: may sleep or raise
        with self._mu:
            kind = self._kind_of(obj)
            objs = self._objects.setdefault(kind, {})
            key = obj.meta.key
            cur = objs.get(key)
            if cur is None:
                raise NotFoundError(f"{kind} {key}")
            if obj is cur:
                # a caller mutating a reference it got from list_refs()/an
                # event and updating with it would defeat CAS (rv trivially
                # matches) AND corrupt prev_obj (prev would alias the
                # mutated object, hiding selector transitions)
                raise ValueError(
                    f"{kind} {key}: update() called with the stored object "
                    "itself — store reads are read-only; update a copy"
                )
            if check_version and obj.meta.resource_version != cur.meta.resource_version:
                raise ConflictError(
                    f"{kind} {key}: rv {obj.meta.resource_version} != {cur.meta.resource_version}"
                )
            obj = copy.deepcopy(obj)
            obj.meta.uid = cur.meta.uid
            obj.meta.creation_timestamp = cur.meta.creation_timestamp
            rev = self._bump()
            obj.meta.resource_version = rev
            objs[key] = obj
            # event shares the stored object (see create)
            self._emit(kind, Event(MODIFIED, obj, rev,
                                   time.perf_counter(), prev_obj=cur))
            return copy.deepcopy(obj)

    def bind_pod(self, key: str, node_name: str) -> Any:
        """pods/binding subresource (reference: POST pods/<name>/binding,
        registry/core/pod/rest BindingREST): stamp spec.node_name without a
        full-object round trip. One copy total — the emitted event shares
        the new stored object (informer convention: event objects are
        read-only, as in client-go's shared caches)."""
        faultinject.fire("store.bind_pod")  # before _mu: may sleep or raise
        with self._mu:
            objs = self._objects.get("Pod", {})
            cur = objs.get(key)
            if cur is None:
                raise NotFoundError(f"Pod {key}")
            if cur.spec.node_name:
                raise ConflictError(
                    f"pod {key} is already bound to {cur.spec.node_name}"
                )
            obj = copy.deepcopy(cur)
            obj.spec.node_name = node_name
            self._clear_failed_scheduling_condition(obj)
            rev = self._bump()
            obj.meta.resource_version = rev
            objs[key] = obj
            self._emit("Pod", Event(MODIFIED, obj, rev,
                                        time.perf_counter(), prev_obj=cur))
            return obj

    @staticmethod
    def _clear_failed_scheduling_condition(obj) -> None:
        """A bind supersedes any earlier PodScheduled=False condition; a
        stale failure patch racing the bind on another dispatcher worker
        must not leave a bound pod marked unschedulable."""
        for c in obj.status.conditions:
            if c.type == "PodScheduled" and c.status == "False":
                c.status, c.reason, c.message = "True", "", ""

    def bind_pods(self, bindings: list[tuple[str, str]]) -> list[str]:
        """Batched pods/binding for a whole scheduling wave of (pod key,
        node name) pairs — the writeback half of the batched TPU wave (the
        reference's analogue is the async dispatcher draining one binding
        call per pod, backend/api_dispatcher/api_dispatcher.go:32-112; a
        wave is our unit of pipelining, so the transaction is too).
        Returns one of "bound" | "missing" (pod deleted — binding moot) |
        "conflict" (already bound) per pair; failures leave the rest of
        the wave untouched.

        Prepare/commit split: the per-binding fault window (which may
        SLEEP under LATENCY injection) and the deepcopy run with the store
        unlocked, so one slow binding no longer serializes every unrelated
        read/write behind `_mu`. The short commit section re-validates
        each pod against the live store before landing it."""
        out: list[str] = []
        # (out index, key, node_name, object observed at prepare, staged copy)
        prepared: list[tuple[int, str, str, Any, Any]] = []
        for key, node_name in bindings:
            # per-binding injection point: a fault here fails ONE pod's
            # binding while its wave siblings' bindings land — the
            # status string (never an exception) is how wave-level
            # failure isolation reaches _apply_wave_bind_results
            try:
                faultinject.fire("store.bind_pod")
            except faultinject.FaultInjected as e:
                out.append(f"error: {e}")
                continue
            cur = self.get_ref("Pod", key)
            if cur is None:
                out.append("missing")
                continue
            if cur.spec.node_name:
                out.append("conflict")
                continue
            obj = copy.deepcopy(cur)
            obj.spec.node_name = node_name
            self._clear_failed_scheduling_condition(obj)
            out.append("bound")  # provisional; commit may downgrade it
            prepared.append((len(out) - 1, key, node_name, cur, obj))
        self._commit_bindings(prepared, out)
        return out

    def _commit_bindings(
        self,
        prepared: list[tuple[int, str, str, Any, Any]],
        out: list[str],
    ) -> None:
        """Commit section of bind_pods (nothing in here may block or fire
        an injection point — prepare already paid those windows).
        Re-validates each staged pod against the live store: a write that
        raced the unlocked prepare window shows up as an identity change
        on the stored object."""
        with self._mu:
            objs = self._objects.setdefault("Pod", {})
            for idx, key, node_name, cur, obj in prepared:
                now_cur = objs.get(key)
                if now_cur is None:
                    out[idx] = "missing"
                    continue
                if now_cur is not cur:
                    # raced: re-validate and re-stage from the live object
                    if now_cur.spec.node_name:
                        out[idx] = "conflict"
                        continue
                    obj = copy.deepcopy(now_cur)
                    obj.spec.node_name = node_name
                    self._clear_failed_scheduling_condition(obj)
                    cur = now_cur
                rev = self._bump()
                obj.meta.resource_version = rev
                objs[key] = obj
                self._emit("Pod", Event(MODIFIED, obj, rev,
                                        time.perf_counter(), prev_obj=cur))

    def patch_pod_status(self, key: str, condition: Any = None,
                         nominated_node: str | None = None) -> Any | None:
        """Atomic status patch under the store lock (the non-atomic
        get→mutate→update pattern loses against a concurrent bind: a stale
        whole-object write would silently unbind the pod). A failure
        condition (status=False) is dropped when the pod is already bound —
        the bind superseded it. Returns the stored object or None."""
        faultinject.fire("store.patch_pod_status")  # before _mu
        with self._mu:
            objs = self._objects.get("Pod", {})
            cur = objs.get(key)
            if cur is None:
                return None
            obj = copy.deepcopy(cur)
            changed = False
            if condition is not None:
                if not (obj.spec.node_name and condition.status == "False"):
                    for c in obj.status.conditions:
                        if c.type == condition.type:
                            c.status = condition.status
                            c.reason = condition.reason
                            c.message = condition.message
                            break
                    else:
                        obj.status.conditions.append(condition)
                    changed = True
            if nominated_node is not None:
                obj.status.nominated_node_name = nominated_node
                changed = True
            if not changed:
                return cur
            rev = self._bump()
            obj.meta.resource_version = rev
            objs[key] = obj
            self._emit("Pod", Event(MODIFIED, obj, rev,
                                        time.perf_counter(), prev_obj=cur))
            return obj

    def delete(self, kind: str, key: str) -> Any:
        faultinject.fire("store.delete")  # before _mu: may sleep or raise
        with self._mu:
            objs = self._objects.get(kind, {})
            cur = objs.pop(key, None)
            if cur is None:
                raise NotFoundError(f"{kind} {key}")
            rev = self._bump()
            # the popped object is SHARED with past ADDED/MODIFIED events
            # (and thus informer caches) — it must stay frozen; the DELETED
            # event and the caller get one fresh copy stamped with the
            # deletion revision
            out = copy.deepcopy(cur)
            out.meta.resource_version = rev
            self._emit(kind, Event(DELETED, out, rev, time.perf_counter()))
            return out

    def list_refs(self, kind: str) -> list[Any]:
        """The stored objects WITHOUT copies — read-only by the same
        convention as event objects (client-go shared-cache semantics).
        For hot per-cycle listings (the volume binder's PV candidates) the
        per-call deepcopy of list() is the dominant cost at scale."""
        with self._mu:
            return list(self._objects.get(kind, {}).values())

    def list(self, kind: str, namespace: str | None = None) -> tuple[list[Any], int]:
        """Returns (objects, revision) — the revision to start a watch from.
        namespace filters BEFORE the deepcopy: a namespace-scoped consumer
        (quota admission) must not pay for copying the whole cluster."""
        with self._mu:
            objs = [
                copy.deepcopy(o)
                for o in self._objects.get(kind, {}).values()
                if namespace is None or o.meta.namespace == namespace
            ]
            return objs, self._revision

    @property
    def revision(self) -> int:
        with self._mu:
            return self._revision

    def latest_revision(self, kind: str) -> int:
        """Revision of the newest logged event for `kind` (0 = no events
        yet). This is the informer's partition probe: delivery is
        synchronous under `_mu`, so any logged event at revision ≤ R that
        a connected watch has not received after draining was LOST — the
        comparison has no in-flight window and thus no false positives."""
        with self._mu:
            log = self._log.get(kind)
            return log[-1].revision if log else 0

    def first_event_after(self, kind: str, revision: int) -> tuple[int, float] | None:
        """(revision, emit ts) of the oldest retained event for `kind`
        with revision > `revision`, or None. The ts anchors the partition
        repair-latency measurement: gap age = now − first missed emit."""
        import bisect

        with self._mu:
            log = self._log.get(kind, [])
            i = bisect.bisect_right(log, revision, key=lambda e: e.revision)
            if i >= len(log):
                return None
            ev = log[i]
            return ev.revision, ev.ts

    # -- watch -------------------------------------------------------------

    def watch(self, kind: str, from_revision: int = 0) -> Watch:
        """Open a watch; replays logged events with revision > from_revision.

        list() + watch(rev) gives the reflector's gap-free ListAndWatch.
        Replay binary-searches the sorted per-kind log (the cacher's ring-
        buffer lookup, staging/.../storage/cacher) instead of scanning it.
        Raises CompactedError when from_revision predates the retained
        window — events would be silently missing otherwise; the caller
        must relist (410 Gone semantics). from_revision=0 = "from the
        beginning of history", valid only while kind history is uncompacted.
        """
        import bisect

        with self._mu:
            log = self._log.get(kind, [])
            compacted_before = self._compacted_before.get(kind, 0)
            if from_revision < compacted_before - 1:
                raise CompactedError(from_revision, compacted_before)
            w = Watch(self, kind)
            i = bisect.bisect_right(log, from_revision, key=lambda e: e.revision)
            # replayed events keep their original seqs, so the bookmark is
            # the seq just before the first replayed event (or the current
            # counter when nothing replays)
            w.start_seq = log[i].seq - 1 if i < len(log) else self._seq.get(kind, 0)
            for ev in log[i:]:
                w._push(ev)
            self._watches.setdefault(kind, []).append(w)
            return w

    def sync_watch(self, kind: str) -> tuple[list[Any], Watch, int]:
        """Atomic relist + fresh watch under ONE lock acquisition: the refs
        reflect every write up to now and the new watch sees every write
        after — no replay window, no gap, no duplicate. This is the repair
        primitive for dropped watch deliveries (an informer resync): the
        incremental watch(from_revision) path can't help there because the
        lost events are still IN the log — only a state diff recovers them.
        Returned objects follow the list_refs read-only convention.

        The third element is the store revision AT the sync, captured under
        the same lock. The informer's revision-continuity tracker must
        restart its bookmark from exactly this value: anything earlier
        re-flags diff-repaired events as a gap forever (a perpetual
        false-positive partition), anything later hides real losses."""
        with self._mu:
            refs = list(self._objects.get(kind, {}).values())
            w = Watch(self, kind)
            w.start_seq = self._seq.get(kind, 0)
            self._watches.setdefault(kind, []).append(w)
            return refs, w, self._revision

    # -- convenience typed helpers ----------------------------------------

    def pods(self) -> list[Any]:
        return self.list("Pod")[0]

    def nodes(self) -> list[Any]:
        return self.list("Node")[0]
