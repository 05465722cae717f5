"""Controller base: informer event handlers -> workqueue -> reconcile loop.

Reference: the universal controller pattern of pkg/controller/* — shared
informers feed keys into a rate-limited workqueue; worker goroutines pop keys
and reconcile actual state toward desired state, requeueing on error. This
base runs single-threaded-deterministic (sync_once) or threaded (run).

A copy of the reference package's module
(kubernetes_tpu/controllers/base.py).
"""

from __future__ import annotations

import threading

from ..client.informer import InformerFactory
from ..client.workqueue import WorkQueue
from ..utils import faultinject


class Controller:
    """Subclasses set `watches` (kinds whose events enqueue keys) and
    implement `reconcile(key) -> None` (raise to retry with backoff) and
    `key_of(kind, obj) -> str | None` (None = ignore event).

    Time-driven controllers set `clocked_queue = True`: they get a `clock`
    (injectable) and a workqueue whose delayed-add timers tick on that same
    clock — the shared pattern for schedule-time/TTL/stabilization
    self-requeues."""

    name = "controller"
    watches: tuple[str, ...] = ()
    clocked_queue = False

    def __init__(self, store, informers: InformerFactory | None = None,
                 clock=None):
        from ..utils.clock import Clock

        self.store = store
        self.informers = informers or InformerFactory(store)
        self.clock = clock or Clock()
        self.queue = (WorkQueue(clock=self.clock.now) if self.clocked_queue
                      else WorkQueue())
        self._started = False
        for kind in self.watches:
            self.informers.informer(kind).add_handler(
                self._make_handler(kind)
            )

    def _make_handler(self, kind: str):
        def handler(etype, old, new):
            key = self.key_of(kind, new if new is not None else old)
            if key is not None:
                self.queue.add(key)

        return handler

    # -- to override ---------------------------------------------------------

    def key_of(self, kind: str, obj) -> str | None:
        return obj.meta.key

    def reconcile(self, key: str) -> None:
        raise NotImplementedError

    # -- drive ---------------------------------------------------------------

    def start(self) -> None:
        if not self._started:
            self.informers.start_all()
            self._started = True

    def sync_once(self, max_items: int = 10_000) -> int:
        """Pump informers and drain the queue once; returns reconciles run."""
        self.start()
        self.informers.pump_all()
        n = 0
        for _ in range(max_items):
            key = self.queue.get(timeout=0)
            if key is None:
                break
            try:
                # chaos: a reconcile that never ran (DROP — requeued with
                # backoff, the item is NOT lost) or crashed mid-flight
                # (ERROR — caught below, same backoff path as a real panic)
                if faultinject.fire("controller.reconcile"):
                    self.queue.add_rate_limited(key)
                else:
                    self.reconcile(key)
                    self.queue.forget(key)
            except Exception:  # noqa: BLE001 - controller retries with backoff
                self.queue.add_rate_limited(key)
            finally:
                self.queue.done(key)
            n += 1
            self.informers.pump_all()
        return n

    def run(self, stop_event: threading.Event, workers: int = 1,
            poll: float = 0.02) -> list[threading.Thread]:
        """Threaded mode (the reference's N worker goroutines)."""
        self.start()

        def pump_loop():
            while not stop_event.is_set():
                self.informers.pump_all()
                stop_event.wait(poll)

        def worker():
            while not stop_event.is_set():
                key = self.queue.get(timeout=poll)
                if key is None:
                    continue
                try:
                    # chaos: same contract as sync_once — DROP requeues,
                    # ERROR takes the normal backoff path
                    if faultinject.fire("controller.reconcile"):
                        self.queue.add_rate_limited(key)
                    else:
                        self.reconcile(key)
                        self.queue.forget(key)
                except Exception:  # noqa: BLE001
                    self.queue.add_rate_limited(key)
                finally:
                    self.queue.done(key)

        threads = [threading.Thread(target=pump_loop, daemon=True)]
        threads += [threading.Thread(target=worker, daemon=True) for _ in range(workers)]
        for t in threads:
            t.start()
        return threads


class ControllerManager:
    """cmd/kube-controller-manager — owns the controller set and one shared
    informer factory."""

    def __init__(self, store, controllers: list[Controller] | None = None):
        self.store = store
        self.controllers: list[Controller] = list(controllers or [])

    def add(self, controller: Controller) -> None:
        self.controllers.append(controller)

    def sync_once(self, rounds: int = 10) -> int:
        """Drain every controller to quiescence (deterministic tests)."""
        total = 0
        for _ in range(rounds):
            n = sum(c.sync_once() for c in self.controllers)
            total += n
            if n == 0:
                break
        return total

    def run(self, stop_event: threading.Event) -> None:
        for c in self.controllers:
            c.run(stop_event)
