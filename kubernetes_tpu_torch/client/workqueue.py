"""Rate-limited work queue for controllers.

Reference: client-go util/workqueue — dedup while queued, per-item exponential
backoff on retry (rate_limiting_queue.go). Used by the controller layer;
the scheduler has its own richer 3-tier queue.

A copy of the reference package's module (kubernetes_tpu/client/workqueue.py).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Hashable


class WorkQueue:
    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 1000.0,
        clock=time.monotonic,
    ):
        self._mu = threading.Condition()
        self._queue: list[Hashable] = []
        self._dirty: set[Hashable] = set()
        self._processing: set[Hashable] = set()
        self._failures: dict[Hashable, int] = {}
        self._delayed: list[tuple[float, int, Hashable]] = []
        self._delayed_pending: dict[Hashable, float] = {}  # earliest wake
        self._seq = 0
        self._base_delay = base_delay
        self._max_delay = max_delay
        self._clock = clock
        self._shutdown = False

    def add(self, item: Hashable) -> None:
        with self._mu:
            if self._shutdown or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                self._mu.notify()

    def add_after(self, item: Hashable, delay: float) -> None:
        """Deliver `item` after `delay`. Dedup to the EARLIEST pending wake
        per item (client-go delayingQueue semantics): controllers re-add
        the same deadline on every reconcile, and without dedup the heap
        grows by one timer per event."""
        with self._mu:
            due = self._clock() + delay
            pending = self._delayed_pending.get(item)
            if pending is not None and pending <= due:
                return
            self._delayed_pending[item] = due
            self._seq += 1
            heapq.heappush(self._delayed, (due, self._seq, item))
            self._mu.notify()

    def add_rate_limited(self, item: Hashable) -> None:
        with self._mu:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        self.add_after(item, min(self._base_delay * (2**n), self._max_delay))

    def forget(self, item: Hashable) -> None:
        with self._mu:
            self._failures.pop(item, None)

    def _flush_delayed_locked(self) -> None:
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            t, _, item = heapq.heappop(self._delayed)
            if self._delayed_pending.get(item) != t:
                # superseded heap entry: an earlier wake already delivered
                # (or retimed) this item — a stale timer must not deliver
                # a second, spurious copy
                continue
            del self._delayed_pending[item]
            if item not in self._dirty:
                self._dirty.add(item)
                if item not in self._processing:
                    self._queue.append(item)

    def get(self, timeout: float | None = None) -> Hashable | None:
        # the timeout is a LIVENESS bound for the calling worker loop: it
        # must tick on wall clock even when the queue's own clock is an
        # injected fake (a frozen clock would otherwise trap the caller in
        # here forever, deaf to its stop event)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            while True:
                self._flush_delayed_locked()
                if self._queue:
                    item = self._queue.pop(0)
                    self._dirty.discard(item)
                    self._processing.add(item)
                    return item
                if self._shutdown:
                    return None
                wait = None
                if self._delayed:
                    wait = max(0.0, self._delayed[0][0] - self._clock())
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                # fake-clock intervals aren't real durations — cap so the
                # caller stays responsive; with the real clock the wait is
                # event-driven (woken by add/notify), no polling
                if self._clock is not time.monotonic and wait is not None:
                    wait = min(wait, 0.05)
                self._mu.wait(wait)

    def done(self, item: Hashable) -> None:
        with self._mu:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._mu.notify()

    def __len__(self) -> int:
        with self._mu:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._mu:
            self._shutdown = True
            self._mu.notify_all()
