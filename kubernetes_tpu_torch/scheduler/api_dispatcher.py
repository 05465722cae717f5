"""Async API-call dispatcher + cache: binding/status writes never block the
scheduling loop.

Reference: pkg/scheduler/backend/api_dispatcher/ (APIDispatcher:32-112,
call_queue.go relevance-merge) + backend/api_cache/api_cache.go:29-61 and the
call types in pkg/scheduler/framework/api_calls/ (Relevances at
api_calls.go:33). SchedulerAsyncAPICalls feature
(pkg/features/kube_features.go:899).

Semantics preserved:
- one in-flight/queued call per object; a newer call against the same object
  merges with or replaces the queued one by relevance comparison
- a less-relevant incoming call is dropped (ErrCallSkipped)
- `parallelism` worker threads drain the queue; callers can wait on a future

A copy of the reference package's module
(kubernetes_tpu/scheduler/api_dispatcher.py): with its metrics, an
`api/<call>` span per execution and the retry counts it gives the wave
recorder; its retry policy's knobs are constants.
"""

from __future__ import annotations

import queue as _queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..store.store import ConflictError
from ..utils import faultinject
from ..utils.backoff import RetryPolicy, retry_call

# call-type relevance (api_calls.go Relevances): higher wins on conflict
POD_STATUS_PATCH = "pod_status_patch"
POD_BINDING = "pod_binding"
POD_DELETE = "pod_delete"  # preemption evictions supersede everything
RELEVANCES = {POD_STATUS_PATCH: 1, POD_BINDING: 2, POD_DELETE: 3}


class CallSkippedError(Exception):
    """A queued more-relevant call made this one redundant."""


class DispatcherClosedError(Exception):
    """Terminal: the dispatcher shut down before this call could run."""


def _default_retry_policy() -> RetryPolicy:
    """Transient store conflicts and injected flakes merit another attempt;
    NotFoundError (pod deleted mid-flight) and everything else must surface
    through on_finish unchanged."""
    return RetryPolicy(
        max_attempts=4,
        base_s=0.002,
        cap_s=0.1,
        retryable=(ConflictError, faultinject.TransientFault),
    )


@dataclass
class APICall:
    call_type: str
    object_key: str
    execute: Callable[[], Any]
    on_finish: Callable[[Exception | None], None] | None = None
    done: threading.Event = field(default_factory=threading.Event)
    error: Exception | None = None

    @property
    def relevance(self) -> int:
        return RELEVANCES.get(self.call_type, 0)

    def sync_or_merge(self, older: "APICall") -> bool:
        """Can this call subsume `older`? Same type merges (latest wins);
        higher relevance replaces; lower relevance is skipped."""
        return self.relevance >= older.relevance


class APIDispatcher:
    """Queue + workers (api_dispatcher.go APIDispatcher)."""

    def __init__(self, parallelism: int = 16, metrics=None, tracer=None,
                 retry_policy: RetryPolicy | None = None, recorder=None):
        self.parallelism = parallelism
        self.metrics = metrics
        self.tracer = tracer  # optional utils.tracing.Tracer: span per call
        self.recorder = recorder  # optional WaveRecorder: retry counts
        self.retry_policy = retry_policy or _default_retry_policy()
        self._retry_rng = random.Random(0xD15)  # jitter only, never decisions
        self._queued: dict[str, APICall] = {}  # object key -> pending call
        self._executing: set[str] = set()  # keys a worker is executing now
        self._parked: set[str] = set()  # deferred keys awaiting in-flight done
        self._order: _queue.Queue = _queue.Queue()
        self._lock = threading.Lock()
        self._workers: list[threading.Thread] = []
        self._stop = threading.Event()
        self._closed = False
        self.retries = 0  # total retry attempts absorbed by backoff
        # worker busy-seconds: on a single-core host this time is taken
        # from the scheduling thread
        self.exec_seconds = 0.0

    # -- enqueue -------------------------------------------------------------

    def add(self, call: APICall) -> APICall:
        """Queue a call; returns the call actually representing the work (the
        merged-into call when dedup applies). Raises CallSkippedError when a
        more relevant call is already pending for the object."""
        superseded: APICall | None = None
        rejected = False
        with self._lock:
            if self._closed:
                rejected = True
            else:
                pending = self._queued.get(call.object_key)
                if pending is not None:
                    if not call.sync_or_merge(pending):
                        raise CallSkippedError(
                            f"{call.call_type} for {call.object_key} "
                            f"skipped: {pending.call_type} already queued"
                        )
                    if call.call_type == pending.call_type:
                        # same type: COMPOSE — two status patches touch
                        # independent fields; dropping one loses an update
                        old_exec, new_exec = pending.execute, call.execute

                        def composed(old_exec=old_exec, new_exec=new_exec):
                            old_exec()
                            new_exec()

                        pending.execute = composed
                        old_finish, new_finish = (pending.on_finish,
                                                  call.on_finish)
                        if old_finish is not None and new_finish is not None:
                            pending.on_finish = lambda err: (
                                old_finish(err), new_finish(err))
                        else:
                            pending.on_finish = new_finish or old_finish
                        return pending
                    # higher relevance REPLACES (a delete supersedes a
                    # binding): the superseded call never runs — its waiters
                    # must see a skip error, NOT inherit the new call's
                    # outcome (a binder waiting on a bind replaced by an
                    # eviction would otherwise 'succeed' and mark a deleted
                    # pod scheduled)
                    superseded = pending
                    self._queued[call.object_key] = call
                    # the key is already in _order; the worker will pop the
                    # replacement
                else:
                    self._queued[call.object_key] = call
                    self._order.put(call.object_key)
                if self.metrics is not None:
                    self.metrics.async_api_pending.set(len(self._queued))
        if rejected:
            # terminal, not silent: a caller that waits on call.done after
            # shutdown must wake with an error, exactly like close() treats
            # the calls it found queued
            err = DispatcherClosedError(
                f"{call.call_type} for {call.object_key} rejected: "
                "dispatcher closed"
            )
            call.error = err
            if call.on_finish is not None:
                call.on_finish(err)
            call.done.set()
            return call
        if superseded is not None:
            err = CallSkippedError(
                f"{superseded.call_type} for {superseded.object_key} "
                f"superseded by {call.call_type}"
            )
            superseded.error = err
            if superseded.on_finish is not None:
                superseded.on_finish(err)
            superseded.done.set()
        return call

    # -- workers -------------------------------------------------------------

    def supersede(self, keys: list[str], relevance: int) -> None:
        """Drop queued calls for these objects with lower relevance — used
        when a wave bind (queued under its own synthetic key) makes per-pod
        status patches moot (api_calls.go relevance ordering: a binding
        replaces a queued status patch for the same pod)."""
        dropped: list[APICall] = []
        with self._lock:
            for key in keys:
                pending = self._queued.get(key)
                if pending is not None and pending.relevance < relevance:
                    del self._queued[key]
                    dropped.append(pending)
                    if self.metrics is not None:
                        self.metrics.async_api_pending.set(len(self._queued))
        # outside the lock (on_finish may re-enter the dispatcher): a
        # superseded call never ran, so its waiters must observe
        # CallSkippedError — done.set() alone would read as success
        for pending in dropped:
            err = CallSkippedError(
                f"{pending.call_type} for {pending.object_key} superseded "
                f"by relevance {relevance}"
            )
            pending.error = err
            if pending.on_finish is not None:
                pending.on_finish(err)
            pending.done.set()

    def run(self) -> None:
        for i in range(self.parallelism):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"api-dispatcher-{i}")
            t.start()
            self._workers.append(t)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                key = self._order.get(timeout=0.05)
            except _queue.Empty:
                continue
            with self._lock:
                if key in self._executing:
                    # strictly one executing call per object
                    # (call_queue.go semantics): PARK the key — the worker
                    # finishing the in-flight call re-enqueues it, so no
                    # thread spins re-putting/re-popping it every ~1ms
                    self._parked.add(key)
                    call = None
                else:
                    call = self._queued.pop(key, None)
                    if call is not None:
                        self._executing.add(key)
                    if self.metrics is not None:
                        self.metrics.async_api_pending.set(len(self._queued))
            if call is None:
                continue
            try:
                self._execute(call)
            finally:
                with self._lock:
                    self._executing.discard(key)
                    if key in self._parked:
                        self._parked.discard(key)
                        # only re-enqueue if a call is actually still queued
                        # for the key — it may have been superseded or
                        # drained while parked
                        if key in self._queued:
                            self._order.put(key)

    def _execute(self, call: APICall) -> None:
        err: Exception | None = None
        # box, not int: on_backoff is a closure mutating across attempts
        stats = {"attempts": 1, "backoff_s": 0.0}

        def attempt():
            faultinject.fire("dispatcher.execute")
            if self.tracer is not None:
                # worker threads get their own span stacks (thread-local),
                # so each api/<type> call exports as its own root span
                with self.tracer.span(f"api/{call.call_type}",
                                      object_key=call.object_key):
                    call.execute()
            else:
                call.execute()

        def on_backoff(attempt_no: int, delay_s: float) -> None:
            stats["attempts"] = attempt_no + 1
            stats["backoff_s"] += delay_s

        t0 = time.perf_counter()
        try:
            # bounded retry absorbs transient failures (store conflicts,
            # injected flakes) without ever releasing the object key: the
            # one-in-flight-per-object and relevance-supersede invariants
            # hold across attempts because the key stays in _executing
            retry_call(
                attempt,
                self.retry_policy,
                self._retry_rng,
                should_abort=self._stop.is_set,
                on_backoff=on_backoff,
            )
        except Exception as e:  # noqa: BLE001 - surfaced via on_finish
            err = e
        finally:
            with self._lock:
                self.exec_seconds += time.perf_counter() - t0
                self.retries += stats["attempts"] - 1
        if stats["attempts"] > 1:
            if self.recorder is not None:
                self.recorder.note_retries(stats["attempts"] - 1)
            if self.metrics is not None:
                self.metrics.async_api_retries.observe(
                    stats["attempts"], call.call_type
                )
                self.metrics.async_api_backoff_seconds.observe(
                    stats["backoff_s"], call.call_type
                )
        call.error = err
        if self.metrics is not None:
            self.metrics.async_api_calls.inc(
                call.call_type, "error" if err else "success"
            )
        if call.on_finish is not None:
            call.on_finish(err)
        call.done.set()

    def drain(self, timeout: float = 5.0) -> None:
        """Synchronously execute everything still queued (tests/shutdown);
        respects the one-executing-call-per-object invariant."""
        # monotonic: a wall-clock step backwards must not extend the drain
        # window (or forwards, cut it short) — this is a duration, not a time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                key = next(
                    (k for k in self._queued if k not in self._executing), None
                )
                if key is None:
                    if not self._queued and not self._executing:
                        return
                    call = None  # everything left is busy in a worker
                else:
                    call = self._queued.pop(key)
                    self._executing.add(key)
            if call is None:
                time.sleep(0.001)
                continue
            try:
                self._execute(call)
            finally:
                with self._lock:
                    self._executing.discard(key)
                    if key in self._parked:
                        self._parked.discard(key)
                        if key in self._queued:
                            self._order.put(key)

    def close(self) -> None:
        """Stop workers and FAIL whatever is still queued: every waiter on
        call.done wakes with a terminal DispatcherClosedError and on_finish
        fires exactly once — close never silently abandons a call."""
        self._stop.set()
        for t in self._workers:
            t.join(timeout=1)
        self._workers.clear()
        with self._lock:
            self._closed = True
            abandoned = list(self._queued.values())
            self._queued.clear()
            self._parked.clear()
            if self.metrics is not None:
                self.metrics.async_api_pending.set(0)
        # outside the lock: on_finish may re-enter the dispatcher
        for call in abandoned:
            err = DispatcherClosedError(
                f"{call.call_type} for {call.object_key} abandoned: "
                "dispatcher closed"
            )
            call.error = err
            if call.on_finish is not None:
                call.on_finish(err)
            call.done.set()


class APICacher:
    """api_cache.go APICacher — routes scheduler API writes through the
    dispatcher while keeping queue/cache consistent. The store write happens
    asynchronously; the cache already holds the assumed pod, so scheduling
    correctness never depends on the write having landed."""

    def __init__(self, store, dispatcher: APIDispatcher):
        self.store = store
        self.dispatcher = dispatcher
        self._wave_seq = 0

    def bind_pod(self, pod, node_name: str) -> APICall:
        def execute():
            # NotFoundError propagates: a pod deleted mid-flight must fail
            # the binding cycle so handleBindingCycleError forgets the
            # cache assume — swallowing it would leak the assumed resources
            # (the DELETED event for an unbound pod never touches the cache)
            cur = self.store.get("Pod", pod.meta.key)
            cur.spec.node_name = node_name
            self.store.update(cur, check_version=False)

        return self.dispatcher.add(
            APICall(POD_BINDING, pod.meta.key, execute)
        )

    def bind_pods(self, bindings: list[tuple[str, str]],
                  on_done: Callable[[list[bool] | None, Exception | None], None] | None = None) -> APICall:
        """One dispatcher call binding a whole wave (store.bind_pods
        transaction). The synthetic object key makes each wave its own
        dedup domain — waves never merge with or supersede each other."""
        results: list = [None]

        def execute():
            results[0] = self.store.bind_pods(bindings)

        def finish(err):
            if on_done is not None:
                on_done(results[0], err)

        # a queued failure patch for any wave member is now moot — per-pod
        # binds supersede it via same-key relevance; the wave's synthetic
        # key needs the explicit form
        self.dispatcher.supersede([k for k, _ in bindings],
                                  RELEVANCES[POD_BINDING])
        self._wave_seq += 1
        return self.dispatcher.add(APICall(
            POD_BINDING, f"__wave__/{self._wave_seq}", execute,
            on_finish=finish,
        ))

    def patch_pod_status(self, pod, condition=None, nominated_node: str | None = None) -> APICall:
        def execute():
            # atomic under the store lock: wave binds run under their own
            # dispatcher key, so this patch may execute CONCURRENTLY with
            # the bind — the store primitive both serializes the write and
            # drops a stale failure condition once the pod is bound
            self.store.patch_pod_status(
                pod.meta.key, condition=condition, nominated_node=nominated_node
            )

        return self.dispatcher.add(
            APICall(POD_STATUS_PATCH, pod.meta.key, execute)
        )
