"""The port's crash-restart recovery against the reference's.

Every case of tests/test_restart.py runs through both packages' Scheduler —
the reference's (kubernetes_tpu.scheduler.Scheduler with
Profile(backend="tpu", wave_size=4)) and the port's
(kubernetes_tpu_torch.scheduler.scheduler.Scheduler, device="cpu", so the
kernels' plain versions run) — over the same store workload and seed, and
holds the final bindings, the stats `reconcile()` returns and the
recorder's `restart_events` equal (tolerance 0: names and integers), beside
the reference test's own assertions on the port:

- half-bound PodGroups resolve all-or-nothing (adopt when the remainder can
  reach quorum, release every landed member when it cannot, leave a whole
  gang alone);
- a bind prepared but never committed is forgotten and requeued; a crash
  at `loop.bind_commit` adopts the binds the store executed; a crash at
  `loop.wave` followed by a fresh Scheduler over the same store binds every
  pod exactly once;
- a dispatcher call lost at close is forgotten and requeued;
- stale gang Permit quorum entries are reverted or promoted;
- a crash at `gang.permit` reconciled on the crashed instance forgets and
  requeues the assumed members and reverts their quorum entries;
- CRASH specs registered at every crash point but never armed leave the
  golden pipeline's bindings, diagnoses and rng as they were.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.scheduler.api_dispatcher as jdisp
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.scheduler.api_dispatcher as tdisp
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, types=jtypes, meta=jmeta, Store=JStore,
                           Scheduler=JScheduler, Profile=JProfile, fi=jfi, disp=jdisp,
                           kw={}),
    "port": SimpleNamespace(name="port", w=tw, types=ttypes, meta=tmeta, Store=TStore,
                            Scheduler=TScheduler, Profile=TProfile, fi=tfi, disp=tdisp,
                            kw={"device": "cpu"}),
}

GATES = {"GenericWorkload": True}
CRASH_POINTS = ("loop.wave", "loop.bind_commit", "gang.permit")


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both packages' fault registries disarmed and empty around every test
    (an armed leftover would poison unrelated tests)."""
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)
    yield
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)


def scheduler(side, store, **kw):
    kw.setdefault("seed", 3)
    return side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=4)],
                          **side.kw, **kw)


def cluster(side, nodes=2, **kw):
    store = side.Store()
    for i in range(nodes):
        store.create(side.w.make_node(f"n{i}", cpu="8", mem="16Gi"))
    sched = scheduler(side, store, **kw)
    sched.start()
    return store, sched


def bind_in_store(store, key, node):
    """A prior incarnation's landed bind: the store write executed, but the
    scheduler died before any of its bookkeeping ran."""
    cur = store.get("Pod", key)
    cur.spec.node_name = node
    store.update(cur, check_version=False)


def gang(side, store, name, min_count, members, namespace="default"):
    t = side.types
    store.create(t.PodGroup(
        meta=side.meta.ObjectMeta(name=name, namespace=namespace),
        spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=min_count)),
    ))
    for i in range(members):
        store.create(side.w.with_gang(
            side.w.make_pod(f"{name}-{i}", cpu="200m", mem="128Mi"), name))


def outcome(store, sched, **extra):
    """What both packages must agree on: every binding, the restart
    records, the final rng state, plus the scenario's own values."""
    out = {"placed": {p.meta.name: p.spec.node_name for p in store.pods()},
           "restart_events": list(sched.flight_recorder.restart_events),
           "rng": sched.algorithms["default-scheduler"].rng.getstate()}
    out.update(extra)
    return out


def both(scenario):
    """The scenario on both packages; asserts equal outcomes, returns the
    port's."""
    out = {name: scenario(side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# --------------------------------------------- half-bound PodGroup sweeps


class TestHalfBoundGangReconcile:
    def test_salvageable_gang_adopted(self):
        def scenario(side):
            store, sched = cluster(side, feature_gates=GATES)
            gang(side, store, "gadopt", min_count=2, members=3)
            bind_in_store(store, "default/gadopt-0", "n0")
            sched.pump()
            stats = sched.reconcile()
            sched.schedule_pending()
            return outcome(store, sched, stats=stats)

        out = both(scenario)
        assert out["stats"] == {"adopted": 0, "forgotten": 0, "requeued": 0,
                                "gang_adopt": 1}
        bound = {k: v for k, v in out["placed"].items() if k.startswith("gadopt")}
        assert len(bound) == 3 and all(bound.values()), bound

    def test_unsalvageable_gang_released(self):
        def scenario(side):
            store, sched = cluster(side, feature_gates=GATES)
            gang(side, store, "grel", min_count=3, members=2)
            bind_in_store(store, "default/grel-0", "n0")
            sched.pump()
            stats = sched.reconcile()
            return outcome(store, sched, stats=stats,
                           gone=store.try_get("Pod", "default/grel-0") is None)

        out = both(scenario)
        assert out["stats"].get("gang_release") == 1
        assert "gang_adopt" not in out["stats"]
        assert out["gone"]
        assert out["placed"] == {"grel-1": ""}

    def test_fully_bound_gang_untouched(self):
        def scenario(side):
            store, sched = cluster(side, feature_gates=GATES)
            gang(side, store, "gdone", min_count=2, members=2)
            bind_in_store(store, "default/gdone-0", "n0")
            bind_in_store(store, "default/gdone-1", "n1")
            sched.pump()
            stats = sched.reconcile()
            return outcome(store, sched, stats=stats)

        out = both(scenario)
        assert "gang_adopt" not in out["stats"] and "gang_release" not in out["stats"]
        assert out["placed"]["gdone-0"] == "n0"


# ------------------------------------------------- bind prepare/commit gap


class TestBindCommitGap:
    def test_prepared_but_uncommitted_bind_forgotten_and_requeued(self):
        def scenario(side):
            store, sched = cluster(side)
            store.create(side.w.make_pod("prep", cpu="100m", mem="64Mi"))
            sched.pump()
            sched.queue.pop_specific("default/prep")
            sched.cache.assume_pod(store.get("Pod", "default/prep"), "n0")
            stats = sched.reconcile()
            assumed = sched.cache.assumed_pod_count()
            sched.schedule_pending()
            return outcome(store, sched, stats=stats, assumed=assumed)

        out = both(scenario)
        assert out["stats"] == {"adopted": 0, "forgotten": 1, "requeued": 1}
        assert out["assumed"] == 0
        assert out["placed"]["prep"]

    def test_crash_at_bind_commit_adopts_executed_binds(self):
        def scenario(side):
            store, sched = cluster(side)
            for i in range(4):
                store.create(side.w.make_pod(f"cb{i}", cpu="100m", mem="64Mi"))
            reg = side.fi.registry()
            reg.reset(seed=11)
            reg.register(side.fi.FaultSpec("loop.bind_commit", mode=side.fi.CRASH,
                                           times=1))
            reg.arm()
            with pytest.raises(side.fi.SchedulerCrashed):
                sched.schedule_pending()
            reg.disarm()
            landed = sorted(p.meta.name for p in store.pods() if p.spec.node_name)
            assumed_before = sched.cache.assumed_pod_count()
            stats = sched.reconcile()
            assumed_after = sched.cache.assumed_pod_count()
            sched.schedule_pending()
            return outcome(store, sched, stats=stats, landed=landed,
                           assumed_before=assumed_before, assumed_after=assumed_after,
                           pending=sched.queue.pending_pods())

        out = both(scenario)
        landed = out["landed"]
        assert landed, "the wave's store bind must have executed"
        assert out["assumed_before"] >= len(landed)
        assert out["stats"]["adopted"] == len(landed)
        assert out["stats"]["requeued"] + out["assumed_after"] == 4 - len(landed)
        assert all(out["placed"].values())
        assert sum(out["pending"]) == 0

    def test_crash_at_wave_then_fresh_scheduler_converges(self):
        def scenario(side):
            store = side.Store()
            for i in range(2):
                store.create(side.w.make_node(f"n{i}", cpu="8", mem="16Gi"))
            for i in range(6):
                store.create(side.w.make_pod(f"w{i}", cpu="100m", mem="64Mi"))
            a = scheduler(side, store)
            a.start()
            reg = side.fi.registry()
            reg.reset(seed=11)
            reg.register(side.fi.FaultSpec("loop.wave", mode=side.fi.CRASH, times=1))
            reg.arm()
            with pytest.raises(side.fi.SchedulerCrashed):
                a.schedule_pending()
            reg.disarm()
            # ungraceful teardown: no drain, no flush — the corpse only
            # stops consuming store events
            a.informers.stop_all()
            b = scheduler(side, store)
            b.start()
            b.schedule_pending()
            return outcome(store, b, assumed=b.cache.assumed_pod_count(),
                           pending=b.queue.pending_pods())

        out = both(scenario)
        assert all(out["placed"].values())
        assert out["assumed"] == 0
        assert sum(out["pending"]) == 0


# --------------------------------------------- dispatcher calls lost


class TestDispatcherCallsLost:
    def test_closed_dispatcher_fails_queued_bind_then_reconcile_requeues(self):
        def scenario(side):
            store, sched = cluster(side)
            store.create(side.w.make_pod("lostcall", cpu="100m", mem="64Mi"))
            sched.pump()
            sched.queue.pop_specific("default/lostcall")
            sched.cache.assume_pod(store.get("Pod", "default/lostcall"), "n0")
            # the prior incarnation's dispatcher with the bind still queued
            d = side.disp.APIDispatcher(parallelism=0)  # no workers
            finishes: list = []
            call = d.add(side.disp.APICall(
                side.disp.POD_BINDING, "default/lostcall",
                lambda: bind_in_store(store, "default/lostcall", "n0"),
                on_finish=finishes.append,
            ))
            d.close()
            assert call.done.is_set()
            assert isinstance(call.error, side.disp.DispatcherClosedError)
            assert len(finishes) == 1
            unbound = not store.get("Pod", "default/lostcall").spec.node_name
            stats = sched.reconcile()
            sched.schedule_pending()
            return outcome(store, sched, stats=stats, unbound=unbound)

        out = both(scenario)
        assert out["unbound"]
        assert out["stats"] == {"adopted": 0, "forgotten": 1, "requeued": 1}
        assert out["placed"]["lostcall"]


# ------------------------------------------------ stale permit quorum


class TestStalePermitQuorum:
    def test_dead_assume_reverted_to_unscheduled(self):
        def scenario(side):
            store, sched = cluster(side, feature_gates=GATES)
            gang(side, store, "gperm", min_count=2, members=2)
            sched.pump()
            gs = sched.cache.pod_group_states
            gs.pod_assumed("default/gperm", "default/gperm-0")
            stats = sched.reconcile()
            st = gs.get("default/gperm")
            sets = ("default/gperm-0" in st.assumed, "default/gperm-0" in st.unscheduled)
            sched.schedule_pending()
            return outcome(store, sched, stats=stats, sets=sets)

        out = both(scenario)
        assert out["stats"].get("permit_cleared") == 1
        assert out["sets"] == (False, True)
        assert all(v for k, v in out["placed"].items() if k.startswith("gperm"))

    def test_landed_assume_promoted_to_scheduled(self):
        def scenario(side):
            store, sched = cluster(side, feature_gates=GATES)
            gang(side, store, "gland", min_count=2, members=2)
            bind_in_store(store, "default/gland-0", "n0")
            sched.pump()
            gs = sched.cache.pod_group_states
            # the stale shape a crash leaves: assumed, never advanced
            st = gs.get("default/gland")
            st.scheduled.discard("default/gland-0")
            st.assumed.add("default/gland-0")
            stats = sched.reconcile()
            st = gs.get("default/gland")
            sets = ("default/gland-0" in st.scheduled, "default/gland-0" in st.assumed)
            return outcome(store, sched, stats=stats, sets=sets)

        out = both(scenario)
        assert out["stats"].get("permit_cleared") == 1
        assert out["sets"] == (True, False)


class TestCrashAtGangPermit:
    def test_crash_at_gang_permit_reconciled_on_the_same_instance(self):
        """A crash between a gang's assumes and its first dispatch leaves
        every member assumed and in the quorum's `assumed` set; the crashed
        instance's own reconcile forgets and requeues the members (sweep 1)
        and reverts the quorum entries (sweep 3), and the gang binds after."""
        def scenario(side):
            store, sched = cluster(side, nodes=4, feature_gates=GATES)
            for g in range(3):
                gang(side, store, f"gp{g}", min_count=2, members=2)
            reg = side.fi.registry()
            reg.reset(seed=11)
            reg.register(side.fi.FaultSpec("gang.permit", mode=side.fi.CRASH, times=1,
                                           start_after=1))
            reg.arm()
            with pytest.raises(side.fi.SchedulerCrashed):
                sched.schedule_pending()
            reg.disarm()
            assumed = sched.cache.assumed_pod_count()
            stats = sched.reconcile()
            sched.schedule_pending()
            return outcome(store, sched, stats=stats, assumed=assumed,
                           left=sched.cache.assumed_pod_count(),
                           pending=sched.queue.pending_pods())

        out = both(scenario)
        assert out["assumed"] == 2
        assert out["stats"] == {"adopted": 0, "forgotten": 2, "requeued": 2,
                                "permit_cleared": 2}
        assert all(out["placed"].values())
        assert out["left"] == 0 and sum(out["pending"]) == 0


# ------------------------------------------- disarmed CRASH points golden


def golden_run(side):
    """tests/test_dedup_golden.py's TestFullPipelineGolden._run(dedup=True)
    in either package: 30 mixed pods of three interleaved signatures on 6
    nodes (27 cpu asked of 24), waves of 8, seed 11."""
    w = side.w
    store = side.Store()
    for i in range(6):
        store.create(w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % 2}"))
    shapes = (("a", "1", "1Gi"), ("b", "900m", "900Mi"), ("c", "800m", "800Mi"))
    for i in range(30):
        app, cpu, mem = shapes[i % 3]
        store.create(w.make_pod(f"{app}{i:02d}", cpu=cpu, mem=mem, labels={"app": app}))
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=8)],
                       seed=11, **side.kw)
    s.start()
    s.schedule_pending()
    s.event_recorder.flush()
    placed = {p.meta.name: p.spec.node_name for p in store.pods()}
    diags = {}
    for p in store.pods():
        for c in p.status.conditions:
            if c.type == "PodScheduled" and c.status == "False":
                diags[p.meta.name] = f"{c.reason}: {c.message}"
    return placed, diags, s.algorithms["default-scheduler"].rng.getstate()


class TestDisarmedCrashGolden:
    def test_crash_points_declared(self):
        for p in CRASH_POINTS + ("lease.renew",):
            assert p in tfi.FAULT_POINTS, p
        assert set(CRASH_POINTS) | {"lease.renew"} <= set(jfi.FAULT_POINTS)
        assert issubclass(tfi.SchedulerCrashed, tfi.FaultInjected)

    def test_disarmed_crash_specs_leave_golden_bit_identical(self):
        ref = golden_run(SIDES["jax"])
        reg = tfi.registry()
        reg.reset(seed=0)
        clean = golden_run(SIDES["port"])
        reg.reset(seed=99)
        for point in CRASH_POINTS:
            reg.register(tfi.FaultSpec(point, mode=tfi.CRASH))
        assert reg.armed is False
        placed, diags, rng = golden_run(SIDES["port"])
        assert (placed, diags, rng) == clean == ref
        assert sum(1 for v in placed.values() if v) > 0
        assert diags
        assert reg.fired_total == 0


# ------------------------------------------ records, the queue's prune, carry


def test_restart_and_fleet_records_land_on_the_metrics():
    """restart_recovery, shard_ownership and shard_failover keep their
    records and land on the same SchedulerMetrics series as the
    reference's flight recorder, sample for sample."""
    from kubernetes_tpu.scheduler.metrics import SchedulerMetrics as JMetrics
    from kubernetes_tpu.scheduler.tpu.flightrecorder import FlightRecorder
    from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics as TMetrics
    from kubernetes_tpu_torch.scheduler.tpu.waverecorder import WaveRecorder

    out = []
    for rec_cls, m_cls in ((FlightRecorder, JMetrics), (WaveRecorder, TMetrics)):
        m = m_cls()
        fr = rec_cls(metrics=m)
        fr.restart_recovery("adopted", 3)
        fr.restart_recovery("forgotten", 0)  # nothing resolved: no record
        fr.restart_recovery("shard_adopt_pending", 7)
        fr.shard_ownership(2, 3)
        fr.shard_failover(1, 0.25)
        lines = [ln for ln in m.expose().splitlines()
                 if ln.startswith(("scheduler_restart_recoveries_total",
                                   "scheduler_fleet_"))]
        out.append((list(fr.restart_events), list(fr.fleet_events), lines))
    assert out[1] == out[0]
    assert out[1][0] == [("adopted", 3), ("shard_adopt_pending", 7)]
    assert any("scheduler_fleet_failover_latency_seconds" in ln for ln in out[1][2])


def test_prune_drops_queued_pods_of_a_lost_shard():
    """SchedulingQueue.prune(keep) against the reference's: every tier
    (active, backoff, unschedulable) and the nominator, the same pods kept."""
    out = {}
    for name, side in SIDES.items():
        store, sched = cluster(side)
        for i in range(12):
            store.create(side.w.make_pod(f"q{i}", cpu="100m", mem="64Mi"))
        sched.pump()
        q = sched.queue
        for key in ("default/q1", "default/q2", "default/q3", "default/q6"):
            # returned after a failed attempt: held outside the active heap
            q.add_unschedulable_if_not_present(q.pop_specific(key), 0)
        q.add_nominated_pod(store.get("Pod", "default/q3"), "n0")
        keep = lambda pod: int(pod.meta.name[1:]) % 3 == 0  # noqa: E731
        removed = q.prune(keep)
        kept = []
        while True:
            qpi = q.pop(timeout=0)
            if qpi is None:
                break
            kept.append(qpi.pod.meta.name)
        out[name] = (removed, sorted(kept), q.nominated_pods_for_node("n0"),
                     q.pending_pods(), q.has_pod("default/q1"), q.has_pod("default/q6"))
    assert out["port"] == out["jax"]
    removed, kept, nominated, pending, has_q1, has_q6 = out["port"]
    assert removed == 8  # q1 q2 q4 q5 q7 q8 q10 q11
    assert kept == ["q0", "q9"]  # q3 and q6 kept, waiting outside the heap
    assert nominated == ["default/q3"]  # q3 is kept (3 % 3 == 0)
    assert (has_q1, has_q6) == (False, True)
    assert sum(pending) == 2  # q3 and q6, waiting outside the active heap


def test_reconcile_drops_a_live_carry():
    """An adopted or forgotten assume changes occupancy under the device
    carry: reconcile marks it external, so the next launch resyncs."""
    store, sched = cluster(SIDES["port"])
    for i in range(8):
        store.create(tw.make_pod(f"c{i}", cpu="100m", mem="64Mi"))
    sched.schedule_pending()
    backend = sched.algorithms["default-scheduler"].backend
    assert backend._carry is not None and not backend._carry_external
    store.create(tw.make_pod("late", cpu="100m", mem="64Mi"))
    sched.pump()
    sched.queue.pop_specific("default/late")
    sched.cache.assume_pod(store.get("Pod", "default/late"), "n0")
    assert sched.reconcile() == {"adopted": 0, "forgotten": 1, "requeued": 1}
    assert backend._carry_external
    sched.schedule_pending()
    assert store.get("Pod", "default/late").spec.node_name
