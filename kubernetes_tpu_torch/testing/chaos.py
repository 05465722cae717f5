"""Seeded chaos soak: the scale-churn workload under a recorded fault
schedule, asserting convergence.

The harness wires a standard transient-fault schedule into the global
`FaultRegistry` (store conflicts, dispatcher flakes, per-binding bind
errors, a guaranteed burst of device-collect failures, dropped watch
deliveries, create latency), runs a create/schedule/delete churn workload
with the TPU wave pipeline + async dispatcher on, then disarms and drives
the scheduler to convergence. The pass criteria are the degradation
ladder's whole contract:

- every surviving pod is bound (nothing stranded by a dropped event or a
  failed bind — retry, wave isolation, and informer resync absorbed it),
- no leaked cache assumes (reconciliation/failure paths forgot every
  half-applied bind),
- the TPU circuit breaker tripped AND recovered at least once (the
  collect-fault burst is sized to guarantee both),
- the queue is empty.

Everything replays from one seed: the registry's per-spec rng streams are
derived from it, so `python -m kubernetes_tpu_torch.testing.chaos --seed 7`
fails (or passes) identically run after run.

A copy of the reference package's module (kubernetes_tpu/testing/chaos.py)
over the port's Scheduler: every soak takes `device` ("cuda" unless the
caller passes "cpu", as the tests do), and so does the CLI (`--device`).
On the card the `tpu.collect` burst trips the circuit breaker on real K2
collects, the gang soak places its groups through K1 + K5 and the restart
soak's warm restarts launch K1-K5 in start(). The restart soak's
`warm_compiles` is the port's `compile_count_since_warm()`, whose warmup
departs from the reference's where that one leaves first uses (ROADMAP
C16). The CLI has no compilation-cache line: the port's kernel libraries
are built once into a hash-keyed directory (ops/cuda.py).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

from ..store.store import ConflictError, Store
from ..utils import faultinject
from ..utils.faultinject import DROP, ERROR, LATENCY, PARTITION, FaultSpec
from .wrappers import make_node, make_pod


def standard_schedule(registry: faultinject.FaultRegistry) -> None:
    """Register the soak's transient-fault schedule (registry still owns
    arming). Bounded `times` on every spec: the workload must outlive the
    schedule, so convergence is eventually fault-free."""
    # async dispatcher call flakes: absorbed by bounded retry + backoff
    registry.register(FaultSpec(
        "dispatcher.execute", mode=ERROR, transient=True,
        probability=0.15, times=40, message="dispatcher flake"))
    # store write conflicts (the real 409 shape): also retried
    registry.register(FaultSpec(
        "store.update", mode=ERROR, probability=0.2, times=30,
        exc=ConflictError, message="injected conflict"))
    # per-binding failures inside the wave transaction: wave siblings'
    # bindings must land while the victim is retried alone
    registry.register(FaultSpec(
        "store.bind_pod", mode=ERROR, transient=True,
        probability=0.1, times=20, message="bind flake"))
    # guaranteed consecutive device-collect failures: trips the breaker
    # (threshold 3), then one failed probe re-opens it, then exhaustion
    # lets the probe waves through — trip AND recovery are certain
    registry.register(FaultSpec(
        "tpu.collect", mode=ERROR, transient=True,
        start_after=6, times=4, message="device flake"))
    # lossy watch stream: informer resync must repair the cache
    registry.register(FaultSpec(
        "watch.deliver", mode=DROP, probability=0.05, times=50))
    # creation latency: jitters event arrival order
    registry.register(FaultSpec(
        "store.create", mode=LATENCY, probability=0.05, times=20,
        latency_s=0.001))


@dataclasses.dataclass
class SoakReport:
    seed: int
    rounds: int
    created: int = 0
    bound: int = 0
    unbound: int = 0
    leaked_assumes: int = 0
    queue_pending: int = 0
    breaker_trips: int = 0
    breaker_recoveries: int = 0
    faults_fired: int = 0
    retries: int = 0
    resync_repairs: int = 0

    @property
    def ok(self) -> bool:
        return (
            self.unbound == 0
            and self.leaked_assumes == 0
            and self.queue_pending == 0
            and self.breaker_trips >= 1
            and self.breaker_recoveries >= 1
            and self.faults_fired > 0
        )

    def render(self) -> str:
        verdict = "PASS" if self.ok else "FAIL"
        return (
            f"chaos soak [{verdict}] seed={self.seed} rounds={self.rounds}: "
            f"created={self.created} bound={self.bound} "
            f"unbound={self.unbound} leaked_assumes={self.leaked_assumes} "
            f"queue_pending={self.queue_pending} "
            f"breaker_trips={self.breaker_trips} "
            f"breaker_recoveries={self.breaker_recoveries} "
            f"faults_fired={self.faults_fired} retries={self.retries} "
            f"resync_repairs={self.resync_repairs}"
        )


def run_soak(seed: int = 7, rounds: int = 6, pods_per_round: int = 24,
             nodes: int = 32, wave_size: int = 16,
             breaker_cooldown_s: float = 0.05, device="cuda") -> SoakReport:
    """One full seeded soak; leaves the global registry disarmed + reset."""
    from ..scheduler.scheduler import Profile, Scheduler
    from ..scheduler.metrics import SchedulerMetrics

    report = SoakReport(seed=seed, rounds=rounds)
    registry = faultinject.registry()
    registry.reset(seed=seed)
    standard_schedule(registry)

    store = Store()
    for i in range(nodes):
        store.create(make_node(f"n{i}", cpu="16", mem="32Gi",
                               zone=f"z{i % 4}"))
    sched = Scheduler(
        store,
        profiles=[Profile(backend="tpu", wave_size=wave_size)],
        feature_gates={"SchedulerAsyncAPICalls": True},
        async_api_calls=True,
        metrics=SchedulerMetrics(),
        seed=seed,
        device=device,
    )
    # shrink the breaker cooldown so trip -> probe -> recovery fits inside
    # the soak's wall clock (production default is 1s)
    algo = next(iter(sched.algorithms.values()))
    algo.breaker.cooldown_s = breaker_cooldown_s
    # shrink pod error backoff the same way: injected failures put pods in
    # the error-backoff tier, whose expiry pop-from-backoff never
    # short-circuits (it protects the apiserver) — production windows of
    # 1-10s would dominate the soak's wall clock
    sched.queue._initial_backoff = 0.02
    sched.queue._max_backoff = 0.1
    sched.start()

    registry.arm()
    seq = 0
    try:
        for round_no in range(rounds):
            for _ in range(pods_per_round):
                store.create(make_pod(f"chaos-{seq}", cpu="100m",
                                      mem="64Mi"))
                seq += 1
            sched.schedule_pending()
            # voluntary churn: delete a slice of bound pods
            bound = [p for p in store.pods() if p.spec.node_name]
            for p in bound[: pods_per_round // 4]:
                store.delete("Pod", p.meta.key)
            sched.schedule_pending()
    finally:
        registry.disarm()
    report.created = seq
    report.faults_fired = registry.fired_total

    # fault-free convergence: everything the schedule disturbed must now
    # settle — error backoffs expire, resync repairs dropped deliveries,
    # requeued pods schedule
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        sched.schedule_pending()
        pending = [p for p in store.pods() if not p.spec.node_name]
        active, backoff, unsched = sched.queue.pending_pods()
        if (not pending and sched.cache.assumed_pod_count() == 0
                and active + backoff + unsched == 0):
            break
        time.sleep(0.05)

    pods = store.pods()
    report.bound = sum(1 for p in pods if p.spec.node_name)
    report.unbound = len(pods) - report.bound
    report.leaked_assumes = sched.cache.assumed_pod_count()
    active, backoff, unsched = sched.queue.pending_pods()
    report.queue_pending = active + backoff + unsched
    report.breaker_trips = algo.breaker.trip_count
    report.breaker_recoveries = algo.breaker.recovery_count
    report.retries = sched.api_dispatcher.retries
    report.resync_repairs = sched.informers.resync_all()
    sched.api_dispatcher.close()
    registry.reset()
    return report


# -- arrival-trace soak: production-shaped load + the full fleet ---------------


@dataclasses.dataclass
class ArrivalTrace:
    """Seeded, replayable Poisson arrival process with periodic burst
    windows — the millions-of-users load shape instead of
    batch-dumping pods. `arrivals()` returns sorted virtual timestamps;
    the same seed replays the same trace, independent of everything else
    (its rng stream is its own, not the fault registry's).

    `shape` selects the rate curve: "burst" (the default — identical draws
    to the original trace, the chaos soaks replay on it), "poisson"
    (constant rate), or "diurnal" (sinusoidal day-curve over
    `diurnal_period` virtual seconds). The rng stream derivation is shared,
    so the same seed at a different shape is a different — but equally
    replayable — trace."""

    seed: int
    pods: int = 96
    rate: float = 120.0        # base arrivals per virtual second
    burst_every: float = 0.5   # a burst window opens each period...
    burst_len: float = 0.1     # ...and lasts this long...
    burst_factor: float = 4.0  # ...at this rate multiple
    shape: str = "burst"       # "burst" | "poisson" | "diurnal"
    diurnal_period: float = 2.0  # virtual seconds per diurnal cycle

    def arrivals(self) -> list[float]:
        rng = random.Random(f"{self.seed}:arrival-trace")
        out: list[float] = []
        t = 0.0
        while len(out) < self.pods:
            if self.shape == "poisson":
                lam = self.rate
            elif self.shape == "diurnal":
                # day-curve: rate swings between 25% and 175% of base
                lam = self.rate * (1.0 + 0.75 * math.sin(
                    2.0 * math.pi * t / self.diurnal_period))
                lam = max(lam, self.rate * 0.25)
            else:  # "burst" — bit-identical to the original formula
                in_burst = (t % self.burst_every) < self.burst_len
                lam = self.rate * (self.burst_factor if in_burst else 1.0)
            t += rng.expovariate(lam)
            out.append(t)
        return out


def trace_schedule(registry: faultinject.FaultRegistry, nodes: int,
                   outage_start_tick: int, outage_ticks: int) -> None:
    """The trace soak's fault schedule: the tentpole trio — a long-lived
    watch-stream PARTITION, a full-fleet kubelet outage window (AZ-outage
    shaped: every sync in [start, start+len) ticks is dropped, so leases
    go stale together), and bind LATENCY riding the new commit seam —
    plus the breaker-burst and light transient flakes from the standard
    schedule so the load shape stays production-like."""
    # long-lived revision-range gap: opens once, swallows a contiguous run
    # of deliveries across every watcher; the informers must detect it
    # from revision continuity — there is no error to react to
    registry.register(FaultSpec(
        "watch.partition", mode=PARTITION, start_after=200, window=400,
        times=1))
    # kubelet death mid-wave: sync visits go round-robin (one per kubelet
    # per tick), so a [start*n, (start+len)*n) visit window is a fleet-wide
    # outage measured in driver ticks
    registry.register(FaultSpec(
        "kubelet.sync", mode=DROP, start_after=outage_start_tick * nodes,
        times=outage_ticks * nodes))
    # injected latency inside the bind transaction: with the
    # prepare/commit seam this sleeps OUTSIDE the store lock, so readers
    # (kubelet relists, controller reconciles) proceed — the soak's
    # wall-clock budget is the regression tripwire
    registry.register(FaultSpec(
        "store.bind_pod", mode=LATENCY, probability=0.15, times=12,
        latency_s=0.02))
    # guaranteed breaker trip + recovery (same shape as standard_schedule)
    registry.register(FaultSpec(
        "tpu.collect", mode=ERROR, transient=True,
        start_after=4, times=4, message="device flake"))
    # light production noise: call flakes, write conflicts, lossy watch
    registry.register(FaultSpec(
        "dispatcher.execute", mode=ERROR, transient=True,
        probability=0.1, times=20, message="dispatcher flake"))
    registry.register(FaultSpec(
        "store.update", mode=ERROR, probability=0.05, times=15,
        exc=ConflictError, message="injected conflict"))
    registry.register(FaultSpec(
        "watch.deliver", mode=DROP, probability=0.03, times=30))


@dataclasses.dataclass
class TraceSoakReport(SoakReport):
    partitions_detected: int = 0
    partition_repairs: int = 0
    partition_repair_latency_s: float = 0.0
    kubelet_outage_drops: int = 0
    nodes_unreachable_seen: int = 0
    evicted: int = 0
    wall_clock_s: float = 0.0
    budget_s: float = 0.0
    # stall attribution (stallprofiler.py): every completed wave must
    # decompose into overlap + named stalls covering >=95% of its wall
    stall_waves: int = 0
    stall_coverage_min: float = 0.0
    stall_flush_events: int = 0

    @property
    def ok(self) -> bool:  # type: ignore[override]
        return (
            SoakReport.ok.fget(self)  # type: ignore[attr-defined]
            and self.partitions_detected >= 1
            and self.partition_repairs >= 1
            and self.kubelet_outage_drops >= 1
            and self.nodes_unreachable_seen >= 1
            # the outage must actually bite (bound pods evicted) AND the
            # cluster must come back (late arrivals bound after recovery)
            and self.evicted >= 1
            and self.bound >= 1
            and self.wall_clock_s <= self.budget_s
            # the profiler must have attributed EVERY wave's wall time
            # (coverage invariant holds under chaos, not just clean runs),
            # and a breaker trip must leave a 'flush' stall footprint —
            # the trip drains the inflight wave, and that drain is a stall
            and self.stall_waves >= 1
            and self.stall_coverage_min >= 0.95
            and (self.breaker_trips < 1 or self.stall_flush_events >= 1)
        )

    def render(self) -> str:
        verdict = "PASS" if self.ok else "FAIL"
        return (
            f"trace soak [{verdict}] seed={self.seed}: "
            f"created={self.created} bound={self.bound} "
            f"unbound={self.unbound} evicted={self.evicted} "
            f"leaked_assumes={self.leaked_assumes} "
            f"queue_pending={self.queue_pending} "
            f"breaker_trips={self.breaker_trips} "
            f"breaker_recoveries={self.breaker_recoveries} "
            f"partitions_detected={self.partitions_detected} "
            f"partition_repairs={self.partition_repairs} "
            f"partition_repair_latency_s="
            f"{self.partition_repair_latency_s:.4f} "
            f"kubelet_outage_drops={self.kubelet_outage_drops} "
            f"nodes_unreachable_seen={self.nodes_unreachable_seen} "
            f"faults_fired={self.faults_fired} retries={self.retries} "
            f"stall_waves={self.stall_waves} "
            f"stall_coverage_min={self.stall_coverage_min:.4f} "
            f"stall_flush_events={self.stall_flush_events} "
            f"wall_clock_s={self.wall_clock_s:.2f} (budget {self.budget_s})"
        )


def run_trace_soak(seed: int = 7, pods: int = 96, nodes: int = 12,
                   wave_size: int = 16, tick_s: float = 0.02,
                   grace_period_s: float = 0.35,
                   outage_start_tick: int = 10, outage_ticks: int = 30,
                   breaker_cooldown_s: float = 0.05,
                   budget_s: float = 60.0, device="cuda") -> TraceSoakReport:
    """Chaos under a production-shaped arrival trace, against the WHOLE
    control loop: every node runs a hollow kubelet (heartbeating a lease),
    the node-lifecycle controller monitors lease staleness, and the fault
    schedule kills the entire kubelet fleet mid-trace, opens a watch
    partition, and injects bind latency. Converges iff the scheduler,
    informers (partition self-heal), lifecycle controller (taint/evict),
    and breaker (trip + recover) all do their jobs — at arrival-trace load,
    not synthetic churn. Leaves the global registry disarmed + reset."""
    from ..controllers.lifecycle import (
        UNREACHABLE_TAINT,
        NodeLifecycleController,
    )
    from ..kubelet.hollow import HollowKubelet
    from ..scheduler.scheduler import Profile, Scheduler
    from ..scheduler.metrics import SchedulerMetrics

    report = TraceSoakReport(seed=seed, rounds=1, budget_s=budget_s)
    t_start = time.monotonic()
    registry = faultinject.registry()
    registry.reset(seed=seed)
    trace_schedule(registry, nodes=nodes,
                   outage_start_tick=outage_start_tick,
                   outage_ticks=outage_ticks)

    store = Store()
    metrics = SchedulerMetrics()
    sched = Scheduler(
        store,
        profiles=[Profile(backend="tpu", wave_size=wave_size)],
        feature_gates={"SchedulerAsyncAPICalls": True},
        async_api_calls=True,
        metrics=metrics,
        seed=seed,
        device=device,
    )
    algo = next(iter(sched.algorithms.values()))
    algo.breaker.cooldown_s = breaker_cooldown_s
    sched.queue._initial_backoff = 0.02
    sched.queue._max_backoff = 0.1

    # the fleet: EVERY node gets a kubelet — the lifecycle controller
    # taints any node without a fresh lease, so a node without an agent
    # would be evicted as collateral instead of by the injected outage
    kubelets = []
    for i in range(nodes):
        node = make_node(f"tn{i}", cpu="16", mem="32Gi", zone=f"z{i % 4}")
        k = HollowKubelet(store, node)
        k.register()
        kubelets.append(k)
    lifecycle = NodeLifecycleController(store)
    lifecycle.grace_period = grace_period_s
    lifecycle.start()
    lifecycle.sweep()
    sched.start()

    trace = ArrivalTrace(seed=seed, pods=pods)
    arrivals = trace.arrivals()
    # the trace plays out in wall time (leases are wall-clock state); run
    # enough ticks to cover the trace AND the outage + grace expiry
    total_ticks = max(
        int(arrivals[-1] / tick_s) + 1,
        outage_start_tick + outage_ticks + int(grace_period_s / tick_s) + 10,
    )
    registry.arm()
    created = 0
    try:
        for tick in range(total_ticks):
            virtual_now = tick * tick_s
            while created < len(arrivals) and arrivals[created] <= virtual_now:
                store.create(make_pod(f"trace-{created}", cpu="100m",
                                      mem="64Mi"))
                created += 1
            for k in kubelets:
                k.sync_once()
            lifecycle.sync_once()
            sched.schedule_pending()
            unreachable = sum(
                1 for n in store.nodes()
                if any(t.key == UNREACHABLE_TAINT for t in n.spec.taints)
            )
            report.nodes_unreachable_seen = max(
                report.nodes_unreachable_seen, unreachable
            )
            time.sleep(tick_s)
    finally:
        registry.disarm()
    report.created = created
    report.faults_fired = registry.fired_total
    report.kubelet_outage_drops = registry.fired_by_point["kubelet.sync"]

    # fault-free convergence: kubelets heartbeat again, the lifecycle
    # controller un-taints recovered nodes, stranded/backoff pods bind
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        for k in kubelets:
            k.sync_once()
        lifecycle.sync_once()
        sched.schedule_pending()
        pending = [p for p in store.pods() if not p.spec.node_name]
        active, backoff, unsched = sched.queue.pending_pods()
        if (not pending and sched.cache.assumed_pod_count() == 0
                and active + backoff + unsched == 0):
            break
        time.sleep(0.02)

    pods_now = store.pods()
    report.bound = sum(1 for p in pods_now if p.spec.node_name)
    report.unbound = len(pods_now) - report.bound
    report.evicted = created - len(pods_now)
    report.leaked_assumes = sched.cache.assumed_pod_count()
    active, backoff, unsched = sched.queue.pending_pods()
    report.queue_pending = active + backoff + unsched
    report.breaker_trips = algo.breaker.trip_count
    report.breaker_recoveries = algo.breaker.recovery_count
    report.retries = sched.api_dispatcher.retries
    partition_events = list(sched.flight_recorder.partition_events)
    report.partitions_detected = len(partition_events)
    report.partition_repairs = sum(ev[1] for ev in partition_events)
    report.partition_repair_latency_s = max(
        (ev[2] for ev in partition_events), default=0.0
    )
    report.resync_repairs = report.partition_repairs
    # stall attribution under chaos: every retained wave record must carry
    # a >=95%-coverage decomposition, and the guaranteed breaker trip must
    # have stamped at least one 'flush' stall (the trip's pipeline drain)
    profiler = sched.flight_recorder.stall_profiler
    wave_records = sched.flight_recorder.records()
    report.stall_waves = profiler.waves_profiled
    report.stall_coverage_min = min(
        (r.stall_coverage for r in wave_records), default=0.0)
    report.stall_flush_events = profiler.stall_events.get("flush", 0)
    sched.api_dispatcher.close()
    registry.reset()
    report.wall_clock_s = time.monotonic() - t_start
    return report


# -- gang soak: kubelet killed mid-gang, all-or-nothing must hold --------------


def gang_schedule(registry: faultinject.FaultRegistry) -> None:
    """Transient flakes aimed at the gang binding window: per-binding bind
    errors and dispatcher flakes land INSIDE a gang's member-by-member
    bind fan-out, store conflicts hit the status writes. Bounded times, so
    convergence is eventually fault-free."""
    registry.register(FaultSpec(
        "store.bind_pod", mode=ERROR, transient=True,
        probability=0.15, times=12, message="bind flake"))
    registry.register(FaultSpec(
        "dispatcher.execute", mode=ERROR, transient=True,
        probability=0.1, times=20, message="dispatcher flake"))
    registry.register(FaultSpec(
        "store.update", mode=ERROR, probability=0.1, times=15,
        exc=ConflictError, message="injected conflict"))


@dataclasses.dataclass
class GangSoakReport:
    seed: int
    gangs: int
    created: int = 0
    bound: int = 0
    unbound: int = 0
    evicted: int = 0
    recreated: int = 0
    partial_gangs_final: int = 0
    zone_violations: int = 0
    leaked_assumes: int = 0
    queue_pending: int = 0
    device_gang_pods: int = 0
    host_gang_pods: int = 0
    faults_fired: int = 0
    wall_clock_s: float = 0.0

    @property
    def ok(self) -> bool:
        return (
            self.unbound == 0
            and self.partial_gangs_final == 0
            and self.zone_violations == 0
            and self.leaked_assumes == 0
            and self.queue_pending == 0
            # the kill must bite (members evicted + recreated) and the
            # device gang path must have actually carried groups
            and self.evicted >= 1
            and self.recreated >= 1
            and self.device_gang_pods >= 1
            and self.faults_fired > 0
        )

    def render(self) -> str:
        verdict = "PASS" if self.ok else "FAIL"
        return (
            f"gang soak [{verdict}] seed={self.seed} gangs={self.gangs}: "
            f"created={self.created} bound={self.bound} "
            f"unbound={self.unbound} evicted={self.evicted} "
            f"recreated={self.recreated} "
            f"partial_gangs_final={self.partial_gangs_final} "
            f"zone_violations={self.zone_violations} "
            f"leaked_assumes={self.leaked_assumes} "
            f"queue_pending={self.queue_pending} "
            f"device_gang_pods={self.device_gang_pods} "
            f"host_gang_pods={self.host_gang_pods} "
            f"faults_fired={self.faults_fired} "
            f"wall_clock_s={self.wall_clock_s:.2f}"
        )


def run_gang_soak(seed: int = 7, gangs: int = 6, min_count: int = 3,
                  nodes: int = 12, zones: int = 3, rounds: int = 3,
                  kill_round: int = 1, tick_s: float = 0.02,
                  grace_period_s: float = 0.3, device="cuda") -> GangSoakReport:
    """Kubelet killed mid-gang (README "Gang waves" runbook): PodGroups
    with Required/Preferred/no topology arrive in rounds under bind and
    dispatcher flakes; right after one round's waves dispatch (async binds
    still in flight) a node agent hosting a gang member stops
    heartbeating. The lifecycle controller taints + evicts, a minimal
    workload controller recreates the missing members, and after
    fault-free convergence the all-or-nothing contract must hold: every
    gang fully bound, no gang partially placed, Required gangs in exactly
    one zone (the requiredDomain pin re-anchors recreated members into the
    surviving siblings' domain). Leaves the registry disarmed + reset."""
    from ..api.meta import ObjectMeta
    from ..api.types import (
        GangPolicy,
        PodGroup,
        PodGroupSpec,
        SchedulingConstraints,
        TopologyConstraint,
    )
    from ..controllers.lifecycle import NodeLifecycleController
    from ..kubelet.hollow import HollowKubelet
    from ..scheduler.scheduler import Profile, Scheduler
    from ..scheduler.metrics import SchedulerMetrics
    from .wrappers import with_gang

    ZONE_KEY = "topology.kubernetes.io/zone"
    report = GangSoakReport(seed=seed, gangs=gangs)
    t_start = time.monotonic()
    registry = faultinject.registry()
    registry.reset(seed=seed)
    gang_schedule(registry)

    store = Store()
    sched = Scheduler(
        store,
        profiles=[Profile(backend="tpu", wave_size=8)],
        feature_gates={"GenericWorkload": True,
                       "TopologyAwareWorkloadScheduling": True,
                       "SchedulerAsyncAPICalls": True},
        async_api_calls=True,
        metrics=SchedulerMetrics(),
        seed=seed,
        device=device,
    )
    sched.queue._initial_backoff = 0.02
    sched.queue._max_backoff = 0.1

    kubelets = []
    for i in range(nodes):
        node = make_node(f"gn{i}", cpu="16", mem="32Gi",
                         zone=f"z{i % zones}")
        k = HollowKubelet(store, node)
        k.register()
        kubelets.append(k)
    lifecycle = NodeLifecycleController(store)
    lifecycle.grace_period = grace_period_s
    lifecycle.start()
    lifecycle.sweep()
    sched.start()

    gang_specs: dict[str, tuple[int, str | None]] = {}
    killed: set[str] = set()

    def member_name(gang: str, i: int) -> str:
        return f"{gang}-m{i}"

    def make_member(gang: str, i: int):
        return with_gang(make_pod(member_name(gang, i), cpu="200m",
                                  mem="128Mi"), gang)

    def recreate_missing() -> None:
        """The workload controller's job: evicted gang members come back
        (same name, fresh object) so the gang can re-reach quorum."""
        have = {p.meta.name for p in store.pods()}
        for gang, (size, _mode) in gang_specs.items():
            for i in range(size):
                if member_name(gang, i) not in have:
                    store.create(make_member(gang, i))
                    report.recreated += 1

    def drive(ticks: int) -> None:
        for _ in range(ticks):
            for k in kubelets:
                if k.node_name not in killed:
                    k.sync_once()
            lifecycle.sync_once()
            recreate_missing()
            sched.schedule_pending()
            time.sleep(tick_s)

    registry.arm()
    g = 0
    try:
        for rnd in range(rounds):
            per_round = gangs // rounds + (1 if rnd < gangs % rounds else 0)
            for _ in range(per_round):
                mode = ("Required", "Preferred", None)[g % 3]
                constraints = SchedulingConstraints()
                if mode is not None:
                    constraints = SchedulingConstraints(topology=(
                        TopologyConstraint(key=ZONE_KEY, mode=mode),))
                gang = f"gang-{g}"
                store.create(PodGroup(
                    meta=ObjectMeta(name=gang),
                    spec=PodGroupSpec(
                        policy=GangPolicy(min_count=min_count),
                        constraints=constraints),
                ))
                gang_specs[gang] = (min_count, mode)
                for i in range(min_count):
                    store.create(make_member(gang, i))
                g += 1
            report.created += per_round * min_count
            sched.schedule_pending()
            if rnd == kill_round:
                # mid-gang kubelet kill: async binds of this round's gangs
                # may still be in flight; the victim hosts a gang member
                victim = next(
                    (p.spec.node_name for p in store.pods()
                     if p.spec.scheduling_group is not None
                     and p.spec.node_name), kubelets[0].node_name)
                killed.add(victim)
            drive(ticks=int(grace_period_s / tick_s) + 8)
    finally:
        registry.disarm()
    report.faults_fired = registry.fired_total

    # fault-free convergence: evictions drain, recreated members re-reach
    # quorum, every gang binds whole
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        for k in kubelets:
            if k.node_name not in killed:
                k.sync_once()
        lifecycle.sync_once()
        recreate_missing()
        sched.schedule_pending()
        pending = [p for p in store.pods() if not p.spec.node_name]
        active, backoff, unsched = sched.queue.pending_pods()
        if (not pending and sched.cache.assumed_pod_count() == 0
                and active + backoff + unsched == 0):
            break
        time.sleep(tick_s)

    node_zone = {n.meta.name: n.meta.labels.get(ZONE_KEY)
                 for n in store.nodes()}
    pods_now = {p.meta.name: p for p in store.pods()}
    report.bound = sum(1 for p in pods_now.values() if p.spec.node_name)
    report.unbound = len(pods_now) - report.bound
    total_members = sum(size for size, _ in gang_specs.values())
    report.evicted = report.recreated  # every recreation followed an eviction
    for gang, (size, mode) in gang_specs.items():
        hosts = [pods_now[member_name(gang, i)].spec.node_name
                 for i in range(size) if member_name(gang, i) in pods_now]
        n_bound = sum(1 for h in hosts if h)
        if n_bound not in (0, size):
            report.partial_gangs_final += 1
        if mode == "Required" and n_bound == size:
            if len({node_zone.get(h) for h in hosts}) > 1:
                report.zone_violations += 1
    report.created = max(report.created, total_members)
    report.leaked_assumes = sched.cache.assumed_pod_count()
    active, backoff, unsched = sched.queue.pending_pods()
    report.queue_pending = active + backoff + unsched
    totals = sched.flight_recorder.gang_pod_totals
    report.device_gang_pods = totals.get("device", 0)
    report.host_gang_pods = totals.get("host", 0)
    sched.api_dispatcher.close()
    registry.reset()
    report.wall_clock_s = time.monotonic() - t_start
    return report


# -- restart storm: seeded scheduler crashes mid-traffic -----------------------


# one crash per cycle, rotating through the three mid-flight windows the
# reconcile contract hardens: mid-wave (collected, not finished), inside
# the bind-commit window (store bind landed, queue/cache not settled),
# and mid-gang-permit (every member assumed, nothing dispatched)
CRASH_POINTS = ("loop.wave", "loop.bind_commit", "gang.permit")


@dataclasses.dataclass
class RestartSoakReport:
    seed: int
    cycles: int
    crashes: int = 0
    crash_points: tuple = ()
    created: int = 0
    bound: int = 0
    unbound: int = 0
    double_binds: int = 0
    leaked_assumes: int = 0
    partial_gangs_final: int = 0
    queue_pending: int = 0
    warm_compiles: int = 0
    recoveries: dict = dataclasses.field(default_factory=dict)
    faults_fired: int = 0
    wall_clock_s: float = 0.0

    @property
    def ok(self) -> bool:
        return (
            self.crashes >= self.cycles
            and self.unbound == 0
            and self.double_binds == 0
            and self.leaked_assumes == 0
            and self.partial_gangs_final == 0
            and self.queue_pending == 0
            # every warm-restarted scheduler must re-enter service without
            # compiling anything the warmup phase didn't already lower
            and self.warm_compiles == 0
        )

    def render(self) -> str:
        verdict = "PASS" if self.ok else "FAIL"
        rec = ",".join(f"{k}={v}" for k, v in sorted(self.recoveries.items()))
        return (
            f"restart soak [{verdict}] seed={self.seed} "
            f"cycles={self.cycles}: crashes={self.crashes} "
            f"points={'/'.join(self.crash_points)} "
            f"created={self.created} bound={self.bound} "
            f"unbound={self.unbound} double_binds={self.double_binds} "
            f"leaked_assumes={self.leaked_assumes} "
            f"partial_gangs_final={self.partial_gangs_final} "
            f"queue_pending={self.queue_pending} "
            f"warm_compiles={self.warm_compiles} "
            f"recoveries=[{rec}] faults_fired={self.faults_fired} "
            f"wall_clock_s={self.wall_clock_s:.2f}"
        )


def run_restart_soak(seed: int = 7, cycles: int = 3, pods_per_cycle: int = 24,
                     min_count: int = 3, nodes: int = 16,
                     wave_size: int = 8, device="cuda") -> RestartSoakReport:
    """Seeded restart storm (README "Restart & recovery"): each cycle arms
    ONE seeded CRASH point mid-traffic, lets SchedulerCrashed rip through
    `schedule_pending`, tears the dead scheduler down ungracefully (the
    dispatcher's queued calls fail, its watches drop — no drain, no flush),
    and constructs a fresh warm-started scheduler over the same store.
    After the storm, fault-free convergence must restore every invariant:
    all pods bound exactly once (the store's bind path is the double-bind
    oracle), zero leaked assumes, per-gang all-or-nothing, and a
    compile-free warm restart (`compile_count_since_warm() == 0` on every
    restarted scheduler). Leaves the global registry disarmed + reset."""
    from ..api.meta import ObjectMeta
    from ..api.types import GangPolicy, PodGroup, PodGroupSpec
    from ..scheduler.scheduler import Profile, Scheduler
    from ..scheduler.metrics import SchedulerMetrics
    from ..utils.faultinject import CRASH, SchedulerCrashed
    from .wrappers import with_gang

    report = RestartSoakReport(seed=seed, cycles=cycles)
    t_start = time.monotonic()
    registry = faultinject.registry()
    registry.reset(seed=seed)

    store = Store()
    for i in range(nodes):
        store.create(make_node(f"rn{i}", cpu="16", mem="32Gi",
                               zone=f"z{i % 4}"))

    # double-bind oracle: every SUCCESSFUL bind lands here; the soak never
    # deletes pods, so any key bound twice is a restart double-placing a
    # pod the crashed incarnation had already placed
    bind_ledger: dict[str, int] = {}
    orig_bind_pods, orig_bind_pod = store.bind_pods, store.bind_pod

    def ledgered_bind_pods(bindings):
        out = orig_bind_pods(bindings)
        for (key, _node), status in zip(bindings, out):
            if status == "bound":
                bind_ledger[key] = bind_ledger.get(key, 0) + 1
        return out

    def ledgered_bind_pod(key, node_name):
        obj = orig_bind_pod(key, node_name)
        bind_ledger[key] = bind_ledger.get(key, 0) + 1
        return obj

    store.bind_pods = ledgered_bind_pods
    store.bind_pod = ledgered_bind_pod

    def make_scheduler(warm: bool) -> Scheduler:
        s = Scheduler(
            store,
            profiles=[Profile(backend="tpu", wave_size=wave_size)],
            feature_gates={"GenericWorkload": True,
                           "SchedulerAsyncAPICalls": True},
            async_api_calls=True,
            metrics=SchedulerMetrics(),
            seed=seed,
            warm_start=warm,
            device=device,
        )
        s.queue._initial_backoff = 0.02
        s.queue._max_backoff = 0.1
        s.start()
        return s

    def crash_teardown(s: Scheduler) -> None:
        """Process death, in-process: no drain, no flush. Queued dispatcher
        calls die with DispatcherClosedError (the lost prepare/commit
        window), watch streams drop. Nothing here is allowed to rescue
        state — that is reconcile's job on the next incarnation."""
        try:
            s.api_dispatcher.close()
        except Exception:  # noqa: BLE001 — the corpse may be inconsistent
            pass
        try:
            s.informers.stop_all()
        except Exception:  # noqa: BLE001
            pass

    def collect_recoveries(s: Scheduler) -> None:
        for kind, n in list(s.flight_recorder.restart_events):
            report.recoveries[kind] = report.recoveries.get(kind, 0) + n

    sched = make_scheduler(warm=False)
    gang_specs: list[tuple[str, int]] = []
    seq = 0
    registry.arm()
    try:
        for cycle in range(cycles):
            point = CRASH_POINTS[cycle % len(CRASH_POINTS)]
            # aim past the visits the storm has already spent at this
            # point; one extra wave-shaped visit for the loop.* points so
            # the crash lands MID-traffic, not on its first wave
            visits = registry.snapshot()["visits"].get(point, 0)
            offset = 1 if point.startswith("loop.") else 0
            registry.register(FaultSpec(
                point, mode=CRASH, times=1, start_after=visits + offset,
                message="restart storm"))

            gang = f"rgang-{cycle}"
            store.create(PodGroup(
                meta=ObjectMeta(name=gang),
                spec=PodGroupSpec(policy=GangPolicy(min_count=min_count)),
            ))
            for i in range(min_count):
                store.create(with_gang(
                    make_pod(f"{gang}-m{i}", cpu="200m", mem="128Mi"), gang))
            gang_specs.append((gang, min_count))
            for _ in range(pods_per_cycle):
                store.create(make_pod(f"restart-{seq}", cpu="100m",
                                      mem="64Mi"))
                seq += 1
            report.created += min_count + pods_per_cycle

            try:
                sched.schedule_pending()
            except SchedulerCrashed:
                report.crashes += 1
                report.crash_points += (point,)
                if sched.warm_start:
                    # this incarnation was warm-started: it must not have
                    # compiled anything between its warmup and its death
                    report.warm_compiles += (
                        sched.flight_recorder.device_telemetry
                        .compile_count_since_warm())
                crash_teardown(sched)
                sched = make_scheduler(warm=True)
                collect_recoveries(sched)
    finally:
        registry.disarm()
    report.faults_fired = registry.fired_total

    # fault-free convergence: the surviving incarnation adopts/finishes
    # everything the storm stranded
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        sched.schedule_pending()
        pending = [p for p in store.pods() if not p.spec.node_name]
        active, backoff, unsched = sched.queue.pending_pods()
        if (not pending and sched.cache.assumed_pod_count() == 0
                and active + backoff + unsched == 0):
            break
        time.sleep(0.02)

    pods_now = {p.meta.name: p for p in store.pods()}
    report.bound = sum(1 for p in pods_now.values() if p.spec.node_name)
    report.unbound = len(pods_now) - report.bound
    report.double_binds = sum(1 for n in bind_ledger.values() if n > 1)
    report.leaked_assumes = sched.cache.assumed_pod_count()
    active, backoff, unsched = sched.queue.pending_pods()
    report.queue_pending = active + backoff + unsched
    for gang, size in gang_specs:
        n_bound = sum(
            1 for i in range(size)
            if (p := pods_now.get(f"{gang}-m{i}")) is not None
            and p.spec.node_name)
        if n_bound not in (0, size):
            report.partial_gangs_final += 1
    if sched.warm_start:
        report.warm_compiles += (
            sched.flight_recorder.device_telemetry.compile_count_since_warm())
    sched.api_dispatcher.close()
    registry.reset()
    report.wall_clock_s = time.monotonic() - t_start
    return report


# -- fleet soak: active-active schedulers, kill one, zero double-binds ---------


def fleet_schedule(registry: faultinject.FaultRegistry, nodes: int,
                   outage_start_tick: int, outage_ticks: int) -> None:
    """The fleet soak's fault ladder: everything the trace soak throws at
    one scheduler — watch partition, fleet-wide kubelet outage, bind
    latency + flakes, conflicts, lossy watch — PLUS seeded lease loss on
    the new `lease.renew` point (a guaranteed renewal-outage burst and one
    coordination-partition window), all against 2-3 concurrent members.
    The CRASH-mode peer kill is registered separately mid-soak (aimed by
    visit count, like the restart storm)."""
    registry.register(FaultSpec(
        "watch.partition", mode=PARTITION, start_after=150, window=250,
        times=1))
    registry.register(FaultSpec(
        "kubelet.sync", mode=DROP, start_after=outage_start_tick * nodes,
        times=outage_ticks * nodes))
    registry.register(FaultSpec(
        "store.bind_pod", mode=LATENCY, probability=0.15, times=10,
        latency_s=0.02))
    registry.register(FaultSpec(
        "store.bind_pod", mode=ERROR, transient=True,
        probability=0.1, times=10, message="bind flake"))
    registry.register(FaultSpec(
        "dispatcher.execute", mode=ERROR, transient=True,
        probability=0.1, times=20, message="dispatcher flake"))
    registry.register(FaultSpec(
        "store.update", mode=ERROR, probability=0.05, times=15,
        exc=ConflictError, message="injected conflict"))
    registry.register(FaultSpec(
        "watch.deliver", mode=DROP, probability=0.03, times=30))
    # seeded lease loss (lease.renew is a declared point): a
    # guaranteed 4-round renewal outage — whoever's renew lands on those
    # visits steps down and must reclaim — then one coordination-partition
    # window where every CAS round inside it is silently lost. Aim low:
    # the point is visited roughly once per held shard per drive tick
    # (~3/tick), so high start_after values would never arm.
    registry.register(FaultSpec(
        "lease.renew", mode=ERROR, transient=True, start_after=6, times=4,
        message="coordination flake"))
    registry.register(FaultSpec(
        "lease.renew", mode=PARTITION, start_after=18, window=5, times=1))


@dataclasses.dataclass
class FleetSoakReport:
    seed: int
    members: int
    created: int = 0
    bound: int = 0
    unbound: int = 0
    evicted: int = 0
    double_binds: int = 0
    leaked_assumes: int = 0
    queue_pending: int = 0
    crashes: int = 0
    failovers: int = 0
    failover_latency_s: float = 0.0
    failover_budget_s: float = 30.0
    shard_adoptions: int = 0
    ownership_overlap: int = 0
    lease_renew_faults: int = 0
    faults_fired: int = 0
    wall_clock_s: float = 0.0
    budget_s: float = 120.0

    @property
    def ok(self) -> bool:
        return (
            self.unbound == 0
            and self.double_binds == 0
            and self.leaked_assumes == 0
            and self.queue_pending == 0
            and self.ownership_overlap == 0
            # the kill must bite AND a survivor must adopt the orphaned
            # shard inside the bounded window, counted on the
            # restart_recoveries{kind="shard_adopt*"} kinds
            and self.crashes >= 1
            and self.failovers >= 1
            and self.failover_latency_s <= self.failover_budget_s
            and self.shard_adoptions >= 1
            and self.lease_renew_faults >= 1
            and self.faults_fired > 0
            and self.wall_clock_s <= self.budget_s
        )

    def render(self) -> str:
        verdict = "PASS" if self.ok else "FAIL"
        return (
            f"fleet soak [{verdict}] seed={self.seed} "
            f"members={self.members}: created={self.created} "
            f"bound={self.bound} unbound={self.unbound} "
            f"evicted={self.evicted} double_binds={self.double_binds} "
            f"leaked_assumes={self.leaked_assumes} "
            f"queue_pending={self.queue_pending} crashes={self.crashes} "
            f"failovers={self.failovers} "
            f"failover_latency_s={self.failover_latency_s:.2f} "
            f"shard_adoptions={self.shard_adoptions} "
            f"ownership_overlap={self.ownership_overlap} "
            f"lease_renew_faults={self.lease_renew_faults} "
            f"faults_fired={self.faults_fired} "
            f"wall_clock_s={self.wall_clock_s:.2f} (budget {self.budget_s})"
        )


def run_fleet_soak(seed: int = 7, members: int = 3, rounds: int = 3,
                   pods_per_round: int = 12, min_count: int = 3,
                   nodes: int = 12, wave_size: int = 8,
                   tick_s: float = 0.05, ticks_per_round: int = 5,
                   grace_period_s: float = 6.0,
                   outage_start_tick: int = 6, outage_ticks: int = 3,
                   lease_duration: float = 4.0, kill_round: int = 1,
                   budget_s: float = 120.0, device="cuda") -> FleetSoakReport:
    """Active-active fleet under the full chaos ladder: 2-3
    lease-sharded schedulers over ONE store take kubelet death, a watch
    partition, bind latency/flakes, seeded lease loss, and a CRASH-mode
    peer kill mid-traffic. The drive loop is single-threaded and
    fixed-order (arrivals -> kubelets -> lifecycle -> each alive member:
    elect_once + schedule_pending), so the fault schedule replays
    deterministically from the seed. Asserted after fault-free
    convergence: every surviving pod bound EXACTLY once (the store bind
    path is the double-bind oracle), zero leaked assumes across
    survivors, disjoint shard ownership, and the kill-one failover
    adopted the orphaned shard inside the bounded window with recoveries
    counted on restart_recoveries{kind="shard_adopt*"}. Leaves the
    registry disarmed + reset."""
    from ..api.meta import ObjectMeta
    from ..api.types import GangPolicy, PodGroup, PodGroupSpec
    from ..controllers.lifecycle import NodeLifecycleController
    from ..kubelet.hollow import HollowKubelet
    from ..scheduler.scheduler import Profile, Scheduler
    from ..scheduler.fleet import FleetMember
    from ..scheduler.metrics import SchedulerMetrics
    from ..utils.faultinject import CRASH, SchedulerCrashed
    from .wrappers import with_gang

    report = FleetSoakReport(seed=seed, members=members, budget_s=budget_s)
    # lease expiry + a couple of full drive rounds is the legal adoption
    # window; anything slower means survivors are not contending
    report.failover_budget_s = lease_duration + 30.0
    t_start = time.monotonic()
    registry = faultinject.registry()
    registry.reset(seed=seed)
    fleet_schedule(registry, nodes=nodes,
                   outage_start_tick=outage_start_tick,
                   outage_ticks=outage_ticks)

    store = Store()

    # double-bind oracle (same as the restart storm): every SUCCESSFUL
    # bind lands here; lifecycle evictions DELETE pods (never recreate a
    # key), so any key with two landed binds is two members both placing
    # a pod only one of them owned
    bind_ledger: dict[str, int] = {}
    orig_bind_pods, orig_bind_pod = store.bind_pods, store.bind_pod

    def ledgered_bind_pods(bindings):
        out = orig_bind_pods(bindings)
        for (key, _node), status in zip(bindings, out):
            if status == "bound":
                bind_ledger[key] = bind_ledger.get(key, 0) + 1
        return out

    def ledgered_bind_pod(key, node_name):
        obj = orig_bind_pod(key, node_name)
        bind_ledger[key] = bind_ledger.get(key, 0) + 1
        return obj

    store.bind_pods = ledgered_bind_pods
    store.bind_pod = ledgered_bind_pod

    kubelets = []
    for i in range(nodes):
        node = make_node(f"fn{i}", cpu="16", mem="32Gi", zone=f"z{i % 4}")
        k = HollowKubelet(store, node)
        k.register()
        kubelets.append(k)
    lifecycle = NodeLifecycleController(store)
    lifecycle.grace_period = grace_period_s
    lifecycle.start()
    lifecycle.sweep()

    fleet: list[FleetMember] = []
    for i in range(members):
        sched = Scheduler(
            store,
            profiles=[Profile(backend="tpu", wave_size=wave_size)],
            feature_gates={"GenericWorkload": True,
                           "SchedulerAsyncAPICalls": True},
            async_api_calls=True,
            metrics=SchedulerMetrics(),
            seed=seed,
            device=device,
        )
        sched.queue._initial_backoff = 0.02
        sched.queue._max_backoff = 0.1
        member = FleetMember(
            sched, members, f"scheduler-{i}", preferred_shard=i,
            lease_duration=lease_duration,
            renew_deadline=lease_duration * 0.66,
            retry_period=tick_s,
        )
        member.start()
        fleet.append(member)
    alive = list(fleet)

    def drive(ticks: int) -> None:
        for _ in range(ticks):
            for k in kubelets:
                k.sync_once()
            lifecycle.sync_once()
            for member in list(alive):
                member.elect_once()
                try:
                    member.scheduler.schedule_pending()
                except SchedulerCrashed:
                    # the peer kill: ungraceful death — no lease release,
                    # no drain. Its shard leases now age toward expiry;
                    # survivors adopt through elect_once.
                    report.crashes += 1
                    member.crash()
                    alive.remove(member)
            time.sleep(tick_s)

    registry.arm()
    seq = 0
    try:
        for rnd in range(rounds):
            if rnd == kill_round:
                # aim a one-shot CRASH just past the visits the fleet has
                # already spent mid-wave, so the kill lands on live
                # traffic — whichever member launches that wave dies
                visits = registry.snapshot()["visits"].get("loop.wave", 0)
                registry.register(FaultSpec(
                    "loop.wave", mode=CRASH, times=1,
                    start_after=visits + 1, message="fleet peer kill"))
            gang = f"fgang-{rnd}"
            store.create(PodGroup(
                meta=ObjectMeta(name=gang),
                spec=PodGroupSpec(policy=GangPolicy(min_count=min_count)),
            ))
            for i in range(min_count):
                store.create(with_gang(
                    make_pod(f"{gang}-m{i}", cpu="200m", mem="128Mi"),
                    gang))
            for _ in range(pods_per_round):
                store.create(make_pod(f"fleet-{seq}", cpu="100m",
                                      mem="64Mi"))
                seq += 1
            report.created += min_count + pods_per_round
            drive(ticks=ticks_per_round)
    finally:
        registry.disarm()
    report.faults_fired = registry.fired_total
    report.lease_renew_faults = registry.fired_by_point["lease.renew"]

    # fault-free convergence: survivors keep electing (the orphaned
    # shard's lease expires INSIDE this loop when the kill came late),
    # kubelets heartbeat again, stranded/backoff/adopted pods bind
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        for k in kubelets:
            k.sync_once()
        lifecycle.sync_once()
        done = True
        for member in alive:
            member.elect_once()
            member.scheduler.schedule_pending()
            active, backoff, unsched = member.scheduler.queue.pending_pods()
            if (member.scheduler.cache.assumed_pod_count()
                    or active + backoff + unsched):
                done = False
        owned = set().union(*(m.owned_shards() for m in alive)) if alive else set()
        pending = [p for p in store.pods() if not p.spec.node_name]
        if done and not pending and len(owned) == members:
            break
        time.sleep(tick_s)

    pods_now = store.pods()
    report.bound = sum(1 for p in pods_now if p.spec.node_name)
    report.unbound = len(pods_now) - report.bound
    report.evicted = report.created - len(pods_now)
    report.double_binds = sum(1 for n in bind_ledger.values() if n > 1)
    for member in alive:
        report.leaked_assumes += member.scheduler.cache.assumed_pod_count()
        active, backoff, unsched = member.scheduler.queue.pending_pods()
        report.queue_pending += active + backoff + unsched
        for kind, n in list(member.scheduler.flight_recorder.restart_events):
            if kind.startswith("shard_adopt"):
                report.shard_adoptions += n
        for ev_ in list(member.scheduler.flight_recorder.fleet_events):
            if ev_[0] == "failover":
                report.failovers += 1
                report.failover_latency_s = max(
                    report.failover_latency_s, ev_[2])
    # disjoint ownership: no shard held by two live members
    seen: dict[int, int] = {}
    for member in alive:
        for s in member.owned_shards():
            seen[s] = seen.get(s, 0) + 1
    report.ownership_overlap = sum(1 for n in seen.values() if n > 1)
    for member in alive:
        member.scheduler.api_dispatcher.close()
    registry.reset()
    report.wall_clock_s = time.monotonic() - t_start
    return report


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.testing.chaos",
        description="Seeded chaos soak for the TPU scheduler "
                    "(deterministic fault schedule, convergence asserted)",
    )
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--pods-per-round", type=int, default=24)
    parser.add_argument("--nodes", type=int, default=32)
    parser.add_argument("--wave-size", type=int, default=16)
    parser.add_argument("--trace", action="store_true",
                        help="run the arrival-trace soak (watch partition "
                             "+ fleet-wide kubelet outage + bind latency "
                             "under a Poisson/burst arrival trace) instead "
                             "of the scale-churn soak")
    parser.add_argument("--pods", type=int, default=96,
                        help="total arrivals for --trace")
    parser.add_argument("--budget-s", type=float, default=60.0,
                        help="wall-clock budget asserted by --trace")
    parser.add_argument("--gang", action="store_true",
                        help="run the gang soak (kubelet killed mid-gang "
                             "under bind/dispatcher flakes; all-or-nothing "
                             "asserted after convergence) instead of the "
                             "scale-churn soak")
    parser.add_argument("--gangs", type=int, default=6,
                        help="PodGroup count for --gang")
    parser.add_argument("--restart", action="store_true",
                        help="run the restart-storm soak (seeded scheduler "
                             "crashes mid-wave / mid-bind-commit / "
                             "mid-gang-permit, warm restarts over the same "
                             "store; double binds, leaked assumes, partial "
                             "gangs, and post-warmup compiles asserted "
                             "zero) instead of the scale-churn soak")
    parser.add_argument("--cycles", type=int, default=3,
                        help="crash/restart cycles for --restart")
    parser.add_argument("--fleet", action="store_true",
                        help="run the fleet soak (2-3 active-active "
                             "lease-sharded schedulers over one store "
                             "under kubelet death + watch partition + "
                             "bind latency + seeded lease loss + a "
                             "CRASH-mode peer kill; zero double-binds, "
                             "zero leaked assumes, and kill-one shard "
                             "adoption asserted) instead of the "
                             "scale-churn soak")
    parser.add_argument("--members", type=int, default=3,
                        help="fleet size for --fleet")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="where the kernels run (cpu: their plain "
                             "versions)")
    args = parser.parse_args(argv)
    dev = {"device": args.device}

    if args.fleet:
        report = run_fleet_soak(seed=args.seed,
                                members=max(2, min(args.members, 3)),
                                nodes=min(args.nodes, 12),
                                wave_size=min(args.wave_size, 8), **dev)
    elif args.restart:
        report = run_restart_soak(seed=args.seed, cycles=args.cycles,
                                  nodes=min(args.nodes, 16),
                                  wave_size=min(args.wave_size, 8), **dev)
    elif args.gang:
        report = run_gang_soak(seed=args.seed, gangs=args.gangs,
                               nodes=min(args.nodes, 12), **dev)
    elif args.trace:
        report = run_trace_soak(seed=args.seed, pods=args.pods,
                                nodes=min(args.nodes, 12),
                                wave_size=args.wave_size,
                                budget_s=args.budget_s, **dev)
    else:
        report = run_soak(seed=args.seed, rounds=args.rounds,
                          pods_per_round=args.pods_per_round,
                          nodes=args.nodes, wave_size=args.wave_size, **dev)
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
