"""Lease-based leader election.

Reference: staging/src/k8s.io/client-go/tools/leaderelection/ —
LeaderElector (tryAcquireOrRenew, renew loop, release on stop) over a
coordination/v1 Lease via resourcelock/leaselock.go. The scheduler wires it
at cmd/kube-scheduler/app/server.go:301-345.

The Lease record's optimistic concurrency comes from the store's
resourceVersion checks — exactly the apiserver mechanism the reference
relies on. A copy of the reference package's module
(kubernetes_tpu/client/leaderelection.py); each round fires the
`lease.renew` fault point.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

from ..api.coordination import Lease, LeaseSpec
from ..api.meta import ObjectMeta
from ..store.store import ConflictError, NotFoundError
from ..utils import faultinject


@dataclass
class LeaderElectionRecord:
    holder_identity: str
    lease_duration: float
    acquire_time: float
    renew_time: float
    transitions: int


@dataclass
class LeaderElector:
    """client-go LeaderElector. run() blocks until stopped; callbacks fire on
    state transitions."""

    store: object
    identity: str
    name: str = "kube-scheduler"
    namespace: str = "kube-system"
    lease_duration: float = 15.0
    renew_deadline: float = 10.0
    retry_period: float = 2.0
    on_started_leading: Callable[[], None] | None = None
    on_stopped_leading: Callable[[], None] | None = None
    on_new_leader: Callable[[str], None] | None = None
    clock: object = None
    _is_leader: bool = field(default=False, init=False)
    _observed_leader: str = field(default="", init=False)
    _stop: threading.Event = field(default_factory=threading.Event, init=False)

    def __post_init__(self):
        if self.clock is None:
            from ..utils.clock import Clock

            self.clock = Clock()

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    def is_leader(self) -> bool:
        return self._is_leader

    # -- lock plumbing (resourcelock/leaselock.go) ---------------------------

    def _get_lease(self) -> Lease | None:
        try:
            return self.store.get("Lease", self.key)
        except NotFoundError:
            return None

    def try_acquire_or_renew(self) -> bool:
        """leaderelection.go tryAcquireOrRenew — one CAS round.

        The round is a seeded fault point (`lease.renew`): ERROR models a
        flaky coordination write (the round fails, retried next tick),
        LATENCY a renew that lands late, PARTITION a window where every
        renewal is lost — so lease loss and renew storms replay from the
        chaos seed like every other fault."""
        try:
            if faultinject.fire("lease.renew"):
                return False  # renewal lost in a partition window
        except faultinject.SchedulerCrashed:
            raise  # CRASH mode must rip through to the restart soak
        except faultinject.FaultInjected:
            return False  # flaky coordination write: retry next round
        # clock read AFTER the fault point: injected LATENCY makes this the
        # renew that lands late, exercising the stale-lease step-down below
        now = self.clock.now()
        lease = self._get_lease()
        if lease is None:
            lease = Lease(
                meta=ObjectMeta(name=self.name, namespace=self.namespace),
                spec=LeaseSpec(
                    holder_identity=self.identity,
                    lease_duration_seconds=self.lease_duration,
                    acquire_time=now,
                    renew_time=now,
                ),
            )
            try:
                self.store.create(lease)
            except Exception:  # noqa: BLE001 - lost the create race
                return False
            self._became_leader()
            return True

        spec = lease.spec
        if spec.holder_identity != self.identity:
            if spec.holder_identity and not spec.expired(now):
                self._observe(spec.holder_identity)
                return False
            # lease expired (or released): try to take it over
            spec.holder_identity = self.identity
            spec.acquire_time = now
            spec.renew_time = now
            spec.lease_transitions += 1
        elif spec.expired(now):
            # renewal edge: this renew landed AFTER our own lease's
            # deadline (slow write, renew storm, partition). The term is
            # dead — a peer may already have observed the expiry and begun
            # takeover, so silently re-stamping renew_time would keep a
            # stale leader scheduling. Step down FIRST (on_stopped_leading
            # halts the owned work before its next pop), then contend for
            # a FRESH term through the same CAS as any other candidate.
            self._lost_leadership()
            spec.acquire_time = now
            spec.renew_time = now
            spec.lease_transitions += 1
        else:
            spec.renew_time = now
        try:
            self.store.update(lease)  # resourceVersion-checked CAS
        except (ConflictError, NotFoundError):
            return False
        self._became_leader()
        return True

    def release(self) -> None:
        """Give up the lease on clean shutdown (leaderelection.go release)."""
        if not self._is_leader:
            return
        lease = self._get_lease()
        if lease is not None and lease.spec.holder_identity == self.identity:
            lease.spec.holder_identity = ""
            try:
                self.store.update(lease)
            except (ConflictError, NotFoundError):
                pass
        self._lost_leadership()

    # -- state transitions ---------------------------------------------------

    def _became_leader(self) -> None:
        if not self._is_leader:
            self._is_leader = True
            self._observe(self.identity)
            if self.on_started_leading is not None:
                self.on_started_leading()

    def _lost_leadership(self) -> None:
        if self._is_leader:
            self._is_leader = False
            if self.on_stopped_leading is not None:
                self.on_stopped_leading()

    def _observe(self, leader: str) -> None:
        if leader != self._observed_leader:
            self._observed_leader = leader
            if self.on_new_leader is not None:
                self.on_new_leader(leader)

    # -- loops ---------------------------------------------------------------

    def run_once(self) -> bool:
        """One election tick: acquire/renew or detect loss. Returns leader?"""
        ok = self.try_acquire_or_renew()
        if not ok and self._is_leader:
            self._lost_leadership()
        return self._is_leader

    def run(self) -> None:
        """Blocking acquire → renew loop (leaderelection.go Run)."""
        while not self._stop.is_set():
            if self.run_once():
                # leader: renew at retry_period cadence, fail if we can't
                # renew within renew_deadline
                deadline = self.clock.now() + self.renew_deadline
                while not self._stop.is_set():
                    self.clock.sleep(self.retry_period)
                    if self.try_acquire_or_renew():
                        deadline = self.clock.now() + self.renew_deadline
                    elif self.clock.now() > deadline:
                        self._lost_leadership()
                        break
            else:
                self.clock.sleep(self.retry_period)
        self.release()

    def stop(self) -> None:
        self._stop.set()
