"""Controller base: informer event handlers -> workqueue -> reconcile loop.

Reference: the universal controller pattern of pkg/controller/* — shared
informers feed keys into a rate-limited workqueue; workers pop keys and
reconcile actual state toward desired state, requeueing on error.

A copy of the part of the reference package's Controller
(kubernetes_tpu/controllers/base.py) that the port's controllers need:
the handlers, the workqueue (on an injectable clock for time-driven
controllers), the controller.reconcile fault point and the deterministic
sync_once drive. Left out: the threaded run() and the ControllerManager,
which no path of the port runs.
"""

from __future__ import annotations

from ..client.informer import InformerFactory
from ..client.workqueue import WorkQueue
from ..utils import faultinject


class Controller:
    """Subclasses set `watches` (kinds whose events enqueue keys) and
    implement `reconcile(key) -> None` (raise to retry with backoff) and
    `key_of(kind, obj) -> str | None` (None = ignore event).

    Time-driven controllers set `clocked_queue = True`: their workqueue's
    delayed-add timers tick on the controller's `clock` (injectable), the
    shared pattern for staleness/TTL self-requeues."""

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
