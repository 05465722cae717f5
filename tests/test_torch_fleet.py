"""The port's active-active fleet and leader election against the reference's.

The 19 cases of tests/test_fleet.py and the 4 of
tests/test_config_leaderelection.py::TestLeaderElection run against the
port (kubernetes_tpu_torch.scheduler.fleet, client.leaderelection; the
Schedulers with device="cpu", so the kernels' plain versions run):

- the shard map: `shard_of` and `pod_shard` equal between the packages on
  every pod, and the reference's own properties;
- the three ownership gates (informer admission, queue admission, the
  loop's pop) and a barrier-synced concurrent drain of one store by two
  members: every pod bound exactly once (a bind ledger on the store);
- kill-one failover inside a bounded window, counted on
  restart_recoveries{kind="shard_adopt*"} with its latency; clean release;
- shard-scoped reconcile and adoption;
- the elector's renewal edge, the seeded `lease.renew` fault point, and
  TestLeaderElection's acquire, takeover, release and callbacks.

Where a case is single-threaded its bindings, restart records and fleet
records are held equal to the reference's on the same store (the
reference's Profile() runs its host algorithm, so its profile is pinned to
backend="tpu"); the concurrent drain's bindings follow the threads'
timing in both packages and are held to the invariants. One more case
holds a pod dropped by the pop-side gate to the reference's loop: the same
bindings, tie-stream position and device carry planes.
"""

from __future__ import annotations

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.client.leaderelection as jle
import kubernetes_tpu.scheduler.fleet as jfleet
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.client.leaderelection as tle
import kubernetes_tpu_torch.scheduler.fleet as tfleet
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.utils import clock as jclock
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import clock as tclock
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, types=jtypes, meta=jmeta, Store=JStore,
                           Scheduler=JScheduler, Profile=JProfile, fi=jfi, fleet=jfleet,
                           le=jle, FakeClock=jclock.FakeClock, kw={}),
    "port": SimpleNamespace(name="port", w=tw, types=ttypes, meta=tmeta, Store=TStore,
                            Scheduler=TScheduler, Profile=TProfile, fi=tfi, fleet=tfleet,
                            le=tle, FakeClock=tclock.FakeClock, kw={"device": "cpu"}),
}
PORT = SIDES["port"]


@pytest.fixture(autouse=True)
def _clean_registries():
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)
    yield
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)


def sched(side, store, wave_size=0, **kw):
    """Profile() of tests/test_fleet.py: the port's per-pod device cycle,
    the reference pinned to its device backend."""
    return side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=wave_size)],
                          seed=0, **side.kw, **kw)


def build_store(side, nodes=8, prefix="ftn"):
    store = side.Store()
    for i in range(nodes):
        store.create(side.w.make_node(f"{prefix}{i}", cpu="16", mem="32Gi",
                                      zone=f"z{i % 2}"))
    return store


def create_pod(side, store, name, **kw):
    """A pod with uid == name, so its shard is computable from the name."""
    pod = side.w.make_pod(name, **kw)
    pod.meta.uid = name
    return store.create(pod)


def ledgered(store):
    """Wrap the store's bind path with the double-bind oracle."""
    ledger: dict[str, int] = {}
    lock = threading.Lock()
    orig_bind_pods, orig_bind_pod = store.bind_pods, store.bind_pod

    def bind_pods(bindings):
        out = orig_bind_pods(bindings)
        with lock:
            for (key, _node), status in zip(bindings, out):
                if status == "bound":
                    ledger[key] = ledger.get(key, 0) + 1
        return out

    def bind_pod(key, node_name):
        obj = orig_bind_pod(key, node_name)
        with lock:
            ledger[key] = ledger.get(key, 0) + 1
        return obj

    store.bind_pods = bind_pods
    store.bind_pod = bind_pod
    return ledger


def placed(store):
    return {p.meta.name: p.spec.node_name for p in store.pods()}


def records(s):
    fr = s.flight_recorder
    return list(fr.restart_events), list(fr.fleet_events)


def both(scenario):
    out = {name: scenario(side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


# --------------------------------------------------------------- shard map


class TestShardMap:
    def test_stable_across_calls_and_instances(self):
        shard_of = tfleet.shard_of
        assert shard_of("default", "a", 3) == shard_of("default", "a", 3)
        one = [shard_of("default", f"p{i}", 4) for i in range(50)]
        two = [shard_of("default", f"p{i}", 4) for i in range(50)]
        assert one == two
        # the same hash as the reference: a pod's shard is the same in both
        # packages, for every fleet size
        for n in (0, 1, 2, 3, 4, 7, 16):
            for ns in ("default", "kube-system", "ns3"):
                got = [shard_of(ns, f"u{i}", n) for i in range(100)]
                assert got == [jfleet.shard_of(ns, f"u{i}", n) for i in range(100)]

    def test_namespace_is_part_of_the_key(self):
        shards = {tfleet.shard_of(f"ns{i}", "same-name", 16) for i in range(64)}
        assert len(shards) > 1

    def test_every_shard_reachable(self):
        for n in (2, 3, 4):
            hit = {tfleet.shard_of("default", f"u{i}", n) for i in range(200)}
            assert hit == set(range(n))

    def test_fleet_of_one_is_shard_zero(self):
        assert tfleet.shard_of("default", "anything", 1) == 0
        assert tfleet.shard_of("default", "anything", 0) == 0

    def test_gang_members_share_their_groups_shard(self):
        a = tw.with_gang(tw.make_pod("ga-0"), "grp")
        b = tw.with_gang(tw.make_pod("totally-different-name"), "grp")
        ja = jw.with_gang(jw.make_pod("ga-0"), "grp")
        for n in (2, 3, 4):
            assert tfleet.pod_shard(a, n) == tfleet.pod_shard(b, n)
            assert tfleet.pod_shard(a, n) == tfleet.shard_of("default", "group:grp", n)
            assert tfleet.pod_shard(a, n) == jfleet.pod_shard(ja, n)

    def test_solo_pods_hash_their_own_identity(self):
        p = tw.make_pod("solo")
        assert tfleet.pod_shard(p, 4) == tfleet.shard_of(
            "default", p.meta.uid or p.meta.name, 4)
        for i in range(40):
            tp, jp = tw.make_pod(f"s{i}"), jw.make_pod(f"s{i}")
            tp.meta.uid = jp.meta.uid = f"uid-{i}"
            assert tfleet.pod_shard(tp, 3) == jfleet.pod_shard(jp, 3)


# ---------------------------------------------------------- ownership gates


class TestOwnershipGates:
    def test_disjoint_ownership_concurrent_drain(self):
        """Two members drain one store concurrently (barrier-synced): every
        pod binds exactly once, ownership stays disjoint, no member leaks an
        assume. Each member's Scheduler has its own backend."""
        store = build_store(PORT)
        ledger = ledgered(store)
        members = []
        for i in range(2):
            s = sched(PORT, store)
            m = tfleet.FleetMember(s, 2, f"scheduler-{i}", preferred_shard=i,
                                   lease_duration=60.0, retry_period=0.01)
            m.start()
            members.append(m)
        for m in members:
            m.elect_once()
        assert members[0].owned_shards() == {0}
        assert members[1].owned_shards() == {1}

        total = 40
        for i in range(total):
            create_pod(PORT, store, f"fp-{i}", cpu="100m", mem="64Mi")
        split = [0, 0]
        for i in range(total):
            split[tfleet.shard_of("default", f"fp-{i}", 2)] += 1
        assert split[0] > 0 and split[1] > 0

        barrier = threading.Barrier(2)
        errors = []

        def drain(m):
            try:
                barrier.wait(timeout=10)
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    m.scheduler.schedule_pending()
                    if sum(1 for p in store.pods() if p.spec.node_name) >= total:
                        return
            except Exception as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        threads = [threading.Thread(target=drain, args=(m,)) for m in members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors

        assert sum(1 for p in store.pods() if p.spec.node_name) == total
        assert len(ledger) == total
        assert all(n == 1 for n in ledger.values()), "double bind"
        for m in members:
            assert m.scheduler.cache.assumed_pod_count() == 0
        assert members[0].owned_shards() & members[1].owned_shards() == set()

    def test_gates_filter_non_owned_unbound_pods(self):
        def scenario(side):
            store = build_store(side)
            s = sched(side, store)
            m = side.fleet.FleetMember(s, 2, "scheduler-0", static_shards={0})
            m.start()
            total = 20
            for i in range(total):
                create_pod(side, store, f"fp-{i}", cpu="100m", mem="64Mi")
            s.schedule_pending()
            return placed(store), s.queue.pending_pods(), records(s)

        bound, pending, _ = both(scenario)
        mine = sum(1 for i in range(20) if tfleet.shard_of("default", f"fp-{i}", 2) == 0)
        assert sum(1 for v in bound.values() if v) == mine
        assert sum(pending) == 0  # the queue never admitted the other shard

    def test_cache_still_mirrors_peer_binds(self):
        def scenario(side):
            store = build_store(side, nodes=1)
            s0 = sched(side, store)
            m0 = side.fleet.FleetMember(s0, 2, "scheduler-0", static_shards={0})
            m0.start()
            s1 = sched(side, store)
            m1 = side.fleet.FleetMember(s1, 2, "scheduler-1", static_shards={1})
            m1.start()
            i = 0
            while side.fleet.shard_of("default", f"peer-{i}", 2) != 1:
                i += 1
            create_pod(side, store, f"peer-{i}", cpu="100m", mem="64Mi")
            s1.schedule_pending()
            pod = store.get("Pod", f"default/peer-{i}")
            # member 0 does not own the pod but must see its resources once
            # its informers drain the bind event
            s0.informers.pump_all()
            ninfo = s0.cache.get_node_info(pod.spec.node_name)
            return (pod.spec.node_name, ninfo is not None
                    and f"default/peer-{i}" in ninfo.pods)

        node, mirrored = both(scenario)
        assert node and mirrored

    def test_pop_gate_leaves_the_tie_stream_and_carry_as_the_reference(self, monkeypatch):
        """Pods admitted while owned, then gated at the pop (their shard
        moved): they are dropped before a wave packs them, so the waves,
        the tie words they consume and the device carry are the
        reference loop's, and the gated pods stay unbound."""
        monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")

        def scenario(side):
            store = build_store(side, nodes=6)
            s = sched(side, store, wave_size=8)
            owned = {0, 1}
            side.fleet.install_shard_filter(
                s, lambda pod: side.fleet.pod_shard(pod, 2) in owned)
            s.start()
            for i in range(30):
                create_pod(side, store, f"gp-{i}", cpu="500m", mem="256Mi")
            s.pump()  # every pod admitted while both shards are owned
            owned.discard(1)  # shard 1 moves before the pops
            s.schedule_pending()
            backend = s.algorithms["default-scheduler"].backend
            carry = {k: np.asarray(backend._carry[k]).tolist()
                     for k in ("used", "nonzero_used", "sel_counts")}
            return (placed(store), s.algorithms["default-scheduler"].rng.getstate(),
                    carry, s.queue.pending_pods())

        bound, _rng, _carry, pending = both(scenario)
        for name, node in bound.items():
            shard = tfleet.shard_of("default", name, 2)
            assert bool(node) == (shard == 0), (name, node, shard)
        assert sum(pending) == 0


# ---------------------------------------------------------------- failover


class TestFailover:
    def test_kill_one_survivor_adopts_inside_bounded_window(self):
        def scenario(side):
            clock = side.FakeClock()
            store = build_store(side)
            ledger = ledgered(store)
            members = []
            for i in range(2):
                s = sched(side, store)
                m = side.fleet.FleetMember(s, 2, f"scheduler-{i}", preferred_shard=i,
                                           lease_duration=15.0, renew_deadline=10.0,
                                           retry_period=0.01, clock=clock)
                m.start()
                members.append(m)
            m0, m1 = members
            owned0 = (m0.owned_shards(), m1.owned_shards())
            m0.crash()  # no release: the lease stays on record
            orphans = [i for i in range(40)
                       if side.fleet.shard_of("default", f"orph-{i}", 2) == 0][:5]
            for i in orphans:
                create_pod(side, store, f"orph-{i}", cpu="100m", mem="64Mi")
            m1.elect_once()
            m1.scheduler.schedule_pending()
            sticky = (m1.owned_shards(),
                      [store.get("Pod", f"default/orph-{i}").spec.node_name
                       for i in orphans])
            clock.step(20.0)  # the lease expires
            m1.elect_once()
            after = m1.owned_shards()
            m1.scheduler.schedule_pending()
            return (owned0, sticky, after, placed(store), dict(ledger),
                    records(m1.scheduler), orphans)

        owned0, sticky, after, bound, ledger, (restart, fleet), orphans = both(scenario)
        assert owned0 == ({0}, {1})
        assert sticky[0] == {1} and not any(sticky[1])
        assert after == {0, 1}
        assert all(bound[f"orph-{i}"] for i in orphans)
        assert all(n == 1 for n in ledger.values())
        assert any(k.startswith("shard_adopt") for k, _ in restart)
        failovers = [ev for ev in fleet if ev[0] == "failover"]
        assert len(failovers) == 1
        assert failovers[0][1] == 0
        assert 0.0 <= failovers[0][2] <= 20.0

    def test_clean_stop_releases_immediately(self):
        def scenario(side):
            clock = side.FakeClock()
            store = build_store(side)
            members = []
            for i in range(2):
                s = sched(side, store)
                m = side.fleet.FleetMember(s, 2, f"scheduler-{i}", preferred_shard=i,
                                           lease_duration=60.0, retry_period=0.01,
                                           clock=clock)
                m.start()
                members.append(m)
            members[0].stop()
            # a released lease reads as unclaimed; the survivor is not its
            # preferred member, so it scavenges only past the grace window
            members[1].elect_once()
            before = members[1].owned_shards()
            clock.step(120.0)
            members[1].elect_once()
            return before, members[1].owned_shards(), records(members[1].scheduler)

        before, after, _ = both(scenario)
        assert before == {1}
        assert after == {0, 1}


# ------------------------------------------------------------- adopt_shard


class TestAdoptShard:
    def test_scoped_reconcile_and_pending_requeue(self):
        def scenario(side):
            store = build_store(side)
            s0 = sched(side, store)
            m0 = side.fleet.FleetMember(s0, 2, "scheduler-0", static_shards={0})
            m0.start()
            total = 24
            for i in range(total):
                create_pod(side, store, f"fp-{i}", cpu="100m", mem="64Mi")
            s0.schedule_pending()
            shard1 = [i for i in range(total)
                      if side.fleet.shard_of("default", f"fp-{i}", 2) == 1]
            before = [store.get("Pod", f"default/fp-{i}").spec.node_name for i in shard1]
            s1 = sched(side, store)
            m1 = side.fleet.FleetMember(s1, 2, "scheduler-1", static_shards={1})
            m1.start()  # static acquisition runs adopt_shard
            kinds = dict(s1.flight_recorder.restart_events)
            s1.schedule_pending()
            return (shard1, before, kinds, placed(store),
                    s1.cache.assumed_pod_count(), records(s1))

        shard1, before, kinds, bound, assumed, _ = both(scenario)
        assert not any(before)
        assert kinds.get("shard_acquire_pending") == len(shard1)
        assert all(bound[f"fp-{i}"] for i in shard1)
        assert assumed == 0

    def test_adopted_gang_reaches_quorum(self):
        def scenario(side):
            t = side.types
            store = build_store(side)
            s = sched(side, store, feature_gates={"GenericWorkload": True})
            gname = next(c for c in ("ga", "gb", "gc", "gd", "ge")
                         if side.fleet.shard_of("default", f"group:{c}", 2) == 1)
            m = side.fleet.FleetMember(s, 2, "scheduler-0", static_shards={0})
            m.start()
            store.create(t.PodGroup(meta=side.meta.ObjectMeta(name=gname),
                                    spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=3))))
            for i in range(3):
                store.create(side.w.with_gang(
                    side.w.make_pod(f"{gname}-m{i}", cpu="200m", mem="128Mi"), gname))
            s.schedule_pending()  # not the owner: nothing binds
            before = sum(1 for p in store.pods() if p.spec.node_name)
            m._owned_shards.add(1)  # as _shard_acquired does, before adopting
            stats = s.adopt_shard(lambda pod: side.fleet.pod_shard(pod, 2) == 1)
            s.schedule_pending()
            return before, stats, placed(store), records(s)

        before, stats, bound, _ = both(scenario)
        assert before == 0
        assert stats["pending"] == 3
        assert sum(1 for v in bound.values() if v) == 3

    def test_reconcile_shard_pred_scopes_the_sweeps(self):
        def scenario(side):
            store = build_store(side)
            s = sched(side, store)
            side.fleet.install_shard_filter(s, lambda pod: True)
            s.start()
            by_shard = {0: [], 1: []}
            for n in (f"rp-{i}" for i in range(30)):
                by_shard[side.fleet.shard_of("default", n, 2)].append(n)
            assert by_shard[0] and by_shard[1]
            for n in (by_shard[0][0], by_shard[1][0]):
                create_pod(side, store, n, cpu="100m", mem="64Mi")
            stats = s.reconcile(shard_pred=lambda pod: side.fleet.pod_shard(pod, 2) == 0,
                                kind_prefix="test_")
            return stats, records(s)

        stats, _ = both(scenario)
        assert stats["requeued"] <= 1


# ------------------------------------------------------- the renewal edge


class TestRenewalEdge:
    """A renew that lands after our own deadline steps down FIRST, then
    contends for a fresh term — never silently re-stamps the dead term."""

    def _elector(self, store, clock, events):
        return tle.LeaderElector(
            store=store, identity="a", clock=clock,
            lease_duration=15.0, renew_deadline=10.0, retry_period=2.0,
            on_started_leading=lambda: events.append("started"),
            on_stopped_leading=lambda: events.append("stopped"),
        )

    def test_stale_renew_steps_down_then_recontends(self):
        store, clock, events = TStore(), tclock.FakeClock(), []
        e = self._elector(store, clock, events)
        assert e.run_once()
        assert events == ["started"]
        lease = store.get("Lease", "kube-system/kube-scheduler")
        transitions_before = lease.spec.lease_transitions
        clock.step(16.0)  # our own lease expired un-renewed
        assert e.run_once()  # reacquires a FRESH term
        assert events == ["started", "stopped", "started"]
        lease = store.get("Lease", "kube-system/kube-scheduler")
        assert lease.spec.holder_identity == "a"
        assert lease.spec.lease_transitions == transitions_before + 1
        assert lease.spec.acquire_time == clock.now()

    def test_live_renew_keeps_the_term(self):
        store, clock, events = TStore(), tclock.FakeClock(), []
        e = self._elector(store, clock, events)
        assert e.run_once()
        lease = store.get("Lease", "kube-system/kube-scheduler")
        acquired = lease.spec.acquire_time
        clock.step(5.0)  # inside the lease: a plain renew
        assert e.run_once()
        assert events == ["started"]
        lease = store.get("Lease", "kube-system/kube-scheduler")
        assert lease.spec.acquire_time == acquired
        assert lease.spec.renew_time == clock.now()


class TestLeaseRenewFaultPoint:
    """`lease.renew` is a declared, seeded injection point — one CAS round
    per visit, so lease loss replays from the seed."""

    def test_error_fails_the_round_and_retry_recovers(self):
        store, clock = TStore(), tclock.FakeClock()
        e = tle.LeaderElector(store=store, identity="a", clock=clock, lease_duration=15.0)
        r = tfi.registry()
        r.register(tfi.FaultSpec("lease.renew", mode=tfi.ERROR, transient=True,
                                 times=1, message="coordination flake"))
        r.arm()
        assert not e.run_once()  # the flaky round fails closed
        assert r.fired_by_point["lease.renew"] == 1
        assert e.run_once()  # next round acquires normally
        assert store.get("Lease", "kube-system/kube-scheduler").spec.holder_identity == "a"

    def test_partition_window_loses_renewals_until_it_closes(self):
        store, clock = TStore(), tclock.FakeClock()
        e = tle.LeaderElector(store=store, identity="a", clock=clock, lease_duration=15.0)
        assert e.run_once()
        r = tfi.registry()
        r.register(tfi.FaultSpec("lease.renew", mode=tfi.PARTITION, window=2, times=1))
        r.arm()
        assert not e.run_once()  # renewal lost in the partition
        assert not e.is_leader()  # a failed round while leading steps down
        assert not e.run_once()
        assert e.run_once()  # window closed: reclaim our on-record lease

    def test_crash_mode_rips_through(self):
        store, clock = TStore(), tclock.FakeClock()
        e = tle.LeaderElector(store=store, identity="a", clock=clock)
        r = tfi.registry()
        r.register(tfi.FaultSpec("lease.renew", mode=tfi.CRASH, times=1))
        r.arm()
        with pytest.raises(tfi.SchedulerCrashed):
            e.run_once()


# --------------------------------------- TestLeaderElection (the config file's)


class TestLeaderElection:
    """tests/test_config_leaderelection.py::TestLeaderElection against the
    port's elector, each lease record equal to the reference's."""

    @staticmethod
    def _elector(side, store, identity, clock, **kw):
        return side.le.LeaderElector(
            store=store, identity=identity, clock=clock,
            lease_duration=15.0, renew_deadline=10.0, retry_period=2.0, **kw)

    @staticmethod
    def _lease(store):
        spec = store.get("Lease", "kube-system/kube-scheduler").spec
        return (spec.holder_identity, spec.lease_duration_seconds, spec.acquire_time,
                spec.renew_time, spec.lease_transitions)

    def test_single_candidate_acquires(self):
        def scenario(side):
            store, clock = side.Store(), side.FakeClock()
            e = self._elector(side, store, "a", clock)
            return e.run_once(), self._lease(store)

        ok, lease = both(scenario)
        assert ok and lease[0] == "a"

    def test_second_candidate_waits_then_takes_over(self):
        def scenario(side):
            store, clock = side.Store(), side.FakeClock()
            a = self._elector(side, store, "a", clock)
            b = self._elector(side, store, "b", clock)
            steps = [a.run_once(), b.run_once()]
            clock.step(16)  # past lease_duration without renewal
            steps.append(b.run_once())
            lease = self._lease(store)
            steps += [a.run_once(), a.is_leader()]
            return steps, lease

        steps, lease = both(scenario)
        assert steps == [True, False, True, False, False]
        assert lease[0] == "b" and lease[4] == 1

    def test_release_on_stop(self):
        def scenario(side):
            store, clock = side.Store(), side.FakeClock()
            a = self._elector(side, store, "a", clock)
            b = self._elector(side, store, "b", clock)
            steps = [a.run_once()]
            a.release()
            steps += [a.is_leader(), b.run_once()]
            return steps, self._lease(store)

        steps, lease = both(scenario)
        assert steps == [True, False, True]  # a released lease is free at once
        assert lease[0] == "b"

    def test_callbacks(self):
        def scenario(side):
            store, clock = side.Store(), side.FakeClock()
            events = []
            a = self._elector(side, store, "a", clock,
                              on_started_leading=lambda: events.append("started"),
                              on_stopped_leading=lambda: events.append("stopped"),
                              on_new_leader=lambda leader: events.append(f"leader={leader}"))
            a.run_once()
            a.release()
            return events

        assert both(scenario) == ["leader=a", "started", "stopped"]


def test_launch_counts_from_threads():
    """Two schedulers in two threads launch on one card: every wrapper's
    count is taken under a lock (no increment lost), and each thread keeps
    its own (kernels.thread_launches)."""
    from kubernetes_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    per_thread = {}

    def launch(tag, n):
        base = kernels.thread_launches()
        for _ in range(n):
            kernels.count_launch("static_parts")
            kernels.count_launch("assign_scan")
        now = kernels.thread_launches()
        per_thread[tag] = {k: v - base.get(k, 0) for k, v in now.items()}

    threads = [threading.Thread(target=launch, args=(f"t{i}", 20000)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernels.LAUNCHES["static_parts"] - before["static_parts"] == 80000
    assert kernels.LAUNCHES["assign_scan"] - before["assign_scan"] == 80000
    assert all(c == {"static_parts": 20000, "assign_scan": 20000}
               for c in per_thread.values())
    for k, v in before.items():
        kernels.LAUNCHES[k] = v
