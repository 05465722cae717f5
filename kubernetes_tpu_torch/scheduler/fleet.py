"""Active-active scheduler fleet: lease-sharded pod ownership.

N `Scheduler` instances run concurrently over ONE store. Pod ownership is
sharded by a stable content hash — `shard_of(namespace, uid) mod N` — and
the shard map is managed through per-shard coordination Leases via the
client-go-shaped elector (`client/leaderelection.py`), one elector per
shard. A member only admits, pops, and binds pods whose shard it holds:
non-owned pods are ignored at `Scheduler._on_pod_event`, at queue
admission, and at the loop's pop-side `_skip_pod_schedule` gate. Every
member's cache still mirrors ALL bound pods (peer binds are foreign
writes that change node occupancy), so scoring planes stay truthful.

Gang members are sharded by their GROUP key, not their own uid: a
PodGroup is always wholly owned by one member, so all-or-nothing
admission is never split across the fleet, and when a peer dies mid-gang
the member that adopts the shard adopts the whole gang.

Failover is the restart machinery re-aimed: when a peer stops renewing,
its shard lease expires and a survivor's elector takes it over
(CAS-arbitrated — two survivors racing resolve through the store's
resourceVersion check). The adopter then runs `Scheduler.adopt_shard`:
the `reconcile()` sweeps (adopt/forget/requeue, half-bound gang
adopt-or-release, stale permit promote/revert) scoped to the adopted
shard, plus a requeue pass for the orphaned shard's pending pods the
admission gate had been filtering out. Outcomes land on
`restart_recoveries{kind="shard_adopt_*"}`; adoption latency (lease
deadline -> takeover) lands on the failover histogram. Any residual
cross-member bind race resolves through the store's ConflictError on
`bind_pod`, so a pod is never bound twice.

A copy of the reference package's module (kubernetes_tpu/scheduler/fleet.py)
with the same shard hash, so a pod's shard is the same in both packages.
Each member's Scheduler has its own TorchBackend; on one card the members'
kernels share the device.
"""

from __future__ import annotations

import hashlib
from functools import partial
from typing import Callable, Iterable

from ..api.coordination import shard_lease_name
from ..api.types import Pod
from ..client.leaderelection import LeaderElector

# Fleet shard-ownership state: the shard set a member holds and the shard
# filter installed into the scheduler, loop, and queue. Exactly ONE writer —
# this module — or the admission gates, the pop gates, and the lease record
# can disagree about who owns a pod, and a disagreement is a double-bind
# waiting for a watch gap. (Documentation: the reference's lint rule
# FLEET01 checks this literal in its own package; nothing checks it here.)
FLEET_SHARD_STATE = (
    ("_owned_shards", "scheduler/fleet.py"),
    ("shard_filter", "scheduler/fleet.py"),
)


def shard_of(namespace: str, uid: str, fleet_size: int) -> int:
    """Stable shard assignment: blake2b over "namespace/uid", mod N.

    hashlib (not builtin hash()) so the map is identical across processes,
    restarts, and PYTHONHASHSEED — a pod must land on the same shard in
    every member and every incarnation, or ownership is ambiguous."""
    if fleet_size <= 1:
        return 0
    digest = hashlib.blake2b(
        f"{namespace}/{uid}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") % fleet_size


def pod_shard(pod: Pod, fleet_size: int) -> int:
    """A pod's shard. Gang members hash their GROUP key ("namespace/group")
    instead of their own uid so a PodGroup is wholly owned by one member —
    all-or-nothing admission and mid-gang failover never split across the
    fleet."""
    sg = pod.spec.scheduling_group
    if sg is not None:
        return shard_of(pod.meta.namespace, f"group:{sg.pod_group_name}",
                        fleet_size)
    return shard_of(pod.meta.namespace, pod.meta.uid or pod.meta.name,
                    fleet_size)


def install_shard_filter(scheduler, pred: Callable[[Pod], bool]) -> None:
    """Install one ownership predicate into all three gates: informer
    admission (`Scheduler._on_pod_event`), queue admission
    (`SchedulingQueue.add`/`activate`), and the pop-side
    `ScheduleOneLoop._skip_pod_schedule`. The predicate reads the member's
    live shard set, so acquire/release take effect at the next gate check
    without re-installation."""
    scheduler.shard_filter = pred
    scheduler.loop.shard_filter = pred
    scheduler.queue.shard_filter = pred


class FleetMember:
    """One fleet member: a Scheduler plus per-shard electors.

    Lease-managed mode (default): one `LeaderElector` per shard, lease
    names `<base>-shard-<i>`. A member always contends for its PREFERRED
    shard; unclaimed non-preferred shards are scavenged only after a grace
    period (so a booting fleet settles on its preferred map instead of the
    first member hoarding every shard), and expired leases — a dead peer's
    orphans — are taken over immediately. Ownership is sticky: a fresh
    lease is never contested, only renewed by its holder.

    Static mode (`static_shards`): ownership pinned, no leases — the
    `--shard-id`-without-leader-election deployment and the bench's
    election-free capacity measurement.

    Single-threaded by design: `elect_once()` is called from the member's
    scheduling thread (or a soak's drive loop) between scheduling rounds,
    so acquire/release callbacks never race the loop's pops."""

    def __init__(
        self,
        scheduler,
        fleet_size: int,
        identity: str,
        preferred_shard: int | None = None,
        static_shards: Iterable[int] | None = None,
        lease_name: str = "kube-scheduler",
        namespace: str = "kube-system",
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
        scavenge_after: float | None = None,
        clock=None,
    ):
        self.scheduler = scheduler
        self.fleet_size = max(1, int(fleet_size))
        self.identity = identity
        self.clock = clock if clock is not None else scheduler.clock
        self._static = static_shards is not None
        if preferred_shard is None and not self._static:
            # stable identity-derived preference: the same member prefers
            # the same shard across restarts
            preferred_shard = shard_of(namespace, identity, self.fleet_size)
        self.preferred_shard = (
            preferred_shard % self.fleet_size
            if preferred_shard is not None else None
        )
        # grace before scavenging an unclaimed non-preferred shard: long
        # enough for that shard's preferred member to boot and claim it
        self.scavenge_after = (
            2.0 * lease_duration if scavenge_after is None else scavenge_after
        )
        self._started_at: float | None = None
        self._owned_shards: set[int] = set()
        # shard -> the orphaned lease's deadline, stashed just before a
        # takeover CAS so the acquire callback can stamp failover latency
        self._takeover_expiry: dict[int, float] = {}
        self.electors: dict[int, LeaderElector] = {}
        if self._static:
            self._static_shards = {
                int(s) % self.fleet_size for s in static_shards
            }
        else:
            self._static_shards = set()
            for s in range(self.fleet_size):
                self.electors[s] = LeaderElector(
                    store=scheduler.store,
                    identity=identity,
                    name=shard_lease_name(lease_name, s),
                    namespace=namespace,
                    lease_duration=lease_duration,
                    renew_deadline=renew_deadline,
                    retry_period=retry_period,
                    clock=self.clock,
                    on_started_leading=partial(self._shard_acquired, s),
                    on_stopped_leading=partial(self._shard_released, s),
                )
        install_shard_filter(scheduler, self.owns_pod)

    # -- ownership reads (free everywhere) --------------------------------

    def owns_pod(self, pod: Pod) -> bool:
        """The installed shard filter: does this member own `pod` NOW?"""
        return pod_shard(pod, self.fleet_size) in self._owned_shards

    def owned_shards(self) -> set[int]:
        return set(self._owned_shards)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Sync informers + reconcile scoped to owned shards (none yet in
        lease mode — each acquisition runs its own scoped adoption), then
        run the first election round."""
        self._started_at = self.clock.now()
        self.scheduler.start()
        if self._static:
            for s in sorted(self._static_shards):
                self._shard_acquired(s)
        else:
            self.elect_once()

    def stop(self) -> None:
        """Clean shutdown: release every held lease so peers can adopt the
        shards immediately instead of waiting out the lease duration."""
        for elector in self.electors.values():
            elector.release()

    def crash(self) -> None:
        """Process death, in-process (the fleet soak's peer kill): no lease
        release, no drain — the orphaned shards stay on record until their
        leases expire and a survivor adopts them."""
        dispatcher = getattr(self.scheduler, "api_dispatcher", None)
        if dispatcher is not None:
            try:
                dispatcher.close()
            except Exception:  # noqa: BLE001 — the corpse may be inconsistent
                pass
        try:
            self.scheduler.informers.stop_all()
        except Exception:  # noqa: BLE001
            pass

    # -- election ---------------------------------------------------------

    def elect_once(self) -> set[int]:
        """One election round over every shard: renew held leases, contend
        for the preferred shard, scavenge unclaimed shards past the grace,
        take over expired (orphaned) ones. Returns the owned set."""
        if self._static:
            return set(self._owned_shards)
        now = self.clock.now()
        for shard, elector in self.electors.items():
            if elector.is_leader():
                # renew; a failed round steps down via run_once, firing
                # _shard_released before this member's next pop
                elector.run_once()
                continue
            lease = elector._get_lease()
            if lease is None or not lease.spec.holder_identity:
                # unclaimed (never created, or cleanly released): preferred
                # member takes it now, others only past the scavenge grace
                if shard == self.preferred_shard or self._past_grace(now):
                    elector.run_once()
                continue
            if lease.spec.holder_identity == self.identity:
                # ours on record (a stepped-down term): reclaim
                elector.run_once()
                continue
            if not lease.spec.expired(now):
                continue  # a live peer's shard: ownership is sticky
            # orphaned shard — the holder stopped renewing. Stash the dead
            # term's deadline so the acquire callback stamps failover
            # latency, then contend (CAS arbitrates racing survivors).
            self._takeover_expiry[shard] = lease.spec.deadline()
            try:
                elector.run_once()
            finally:
                self._takeover_expiry.pop(shard, None)
        return set(self._owned_shards)

    def _past_grace(self, now: float) -> bool:
        return (self._started_at is not None
                and now - self._started_at >= self.scavenge_after)

    # -- acquire/release callbacks (fired inside the electors) ------------

    def _shard_pred(self, shard: int) -> Callable[[Pod], bool]:
        return lambda pod: pod_shard(pod, self.fleet_size) == shard

    def _shard_acquired(self, shard: int) -> None:
        self._owned_shards.add(shard)
        recorder = self.scheduler.flight_recorder
        recorder.shard_ownership(len(self._owned_shards), self.fleet_size)
        expiry = self._takeover_expiry.pop(shard, None)
        # adopt the shard: scoped reconcile sweeps + requeue of pending
        # pods the admission gate had been filtering out. Orphan takeovers
        # count on restart_recoveries{kind="shard_adopt_*"}; first
        # acquisitions on the quieter "shard_acquire_*" kinds.
        prefix = "shard_adopt_" if expiry is not None else "shard_acquire_"
        self.scheduler.adopt_shard(self._shard_pred(shard),
                                   kind_prefix=prefix)
        if expiry is not None:
            latency = max(0.0, self.clock.now() - expiry)
            recorder.shard_failover(shard, latency)

    def _shard_released(self, shard: int) -> None:
        self._owned_shards.discard(shard)
        recorder = self.scheduler.flight_recorder
        recorder.shard_ownership(len(self._owned_shards), self.fleet_size)
        # the lost term must not bind: poison any in-flight wave (its pods
        # may belong to the lost shard) and drop the shard's queued pods
        # BEFORE the loop's next pop — the new owner requeues them from
        # store truth through its own adoption sweep
        self.scheduler.loop.mark_wave_external(poison=True)
        self.scheduler.queue.prune(self.owns_pod)
