"""The port's chaos harness and degradation ladder against the reference's.

Every non-slow case of tests/test_chaos.py (42) runs on the port — the
fault registry, retry/backoff, the dispatcher's retry/close/parking, wave
bind isolation, the circuit breaker, half-open probe waves, startup
reconciliation, informer resync and partition repair, the bind commit
seam, a kubelet's death mid-run, the declared points, the arrival trace,
the seeded soak, the trace soak and the golden run with every point
registered disarmed — with the reference test's own assertions. Where a
case makes decisions (schedules, fault patterns, outcomes), it runs on
both packages — the reference's (kubernetes_tpu) and the port's
(kubernetes_tpu_torch, device="cpu": the kernels' plain versions) — and
the reference's result is asserted equal (tolerance 0: names, integers).
TestGoldenDisarmed drives the port's own golden pipeline (tests/
test_dedup_golden.py's TestFullPipelineGolden._run: dedup and cross-wave
reuse on and off) with a spec registered at every point, disarmed. The
soaks' own reports are held against the reference's in
tests/test_torch_soaks.py.

Beside them: the reference's TestNodeLifecycle (tests/test_controllers.py)
on both packages' NodeLifecycleController, HollowKubelet and Scheduler
(the reference's ReplicaSet, which the port does not have, replaced by
re-creating the evicted pod by hand), and a HollowKubelet case (register,
run to completion, finalize a deletion, stable pod addresses).
"""

from __future__ import annotations

import random
import threading
import time
from types import SimpleNamespace

import pytest

import kubernetes_tpu.client.informer as jinf
import kubernetes_tpu.controllers.lifecycle as jlc
import kubernetes_tpu.kubelet.hollow as jhollow
import kubernetes_tpu.scheduler.api_dispatcher as jdisp
import kubernetes_tpu.scheduler.metrics as jmetrics
import kubernetes_tpu.scheduler.schedule_one as jloop
import kubernetes_tpu.scheduler.tpu.circuitbreaker as jcb
import kubernetes_tpu.testing.chaos as jchaos
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.backoff as jbackoff
import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu_torch.client.informer as tinf
import kubernetes_tpu_torch.controllers.lifecycle as tlc
import kubernetes_tpu_torch.kubelet.hollow as thollow
import kubernetes_tpu_torch.scheduler.api_dispatcher as tdisp
import kubernetes_tpu_torch.scheduler.metrics as tmetrics
import kubernetes_tpu_torch.scheduler.schedule_one as tloop
import kubernetes_tpu_torch.scheduler.tpu.circuitbreaker as tcb
import kubernetes_tpu_torch.testing.chaos as tchaos
import kubernetes_tpu_torch.testing.wrappers as tw
import kubernetes_tpu_torch.utils.backoff as tbackoff
import kubernetes_tpu_torch.utils.clock as tclock
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu.utils.net import stable_pod_ip as jip
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, fi=jfi, disp=jdisp, cb=jcb, backoff=jbackoff,
                           inf=jinf, lc=jlc, hollow=jhollow, clock=jclock, loop=jloop,
                           metrics=jmetrics, chaos=jchaos, Store=JStore,
                           Scheduler=JScheduler, Profile=JProfile, kw={}),
    "port": SimpleNamespace(name="port", w=tw, fi=tfi, disp=tdisp, cb=tcb, backoff=tbackoff,
                            inf=tinf, lc=tlc, hollow=thollow, clock=tclock, loop=tloop,
                            metrics=tmetrics, chaos=tchaos, Store=TStore,
                            Scheduler=TScheduler, Profile=TProfile,
                            kw={"device": "cpu"}),
}
PORT = SIDES["port"]


@pytest.fixture(autouse=True)
def _clean_registries():
    """Both packages' process-wide registries disarmed and empty around
    every test — an armed leftover would poison unrelated tests."""
    for s in SIDES.values():
        s.fi.registry().reset(seed=0)
    yield
    for s in SIDES.values():
        s.fi.registry().reset(seed=0)


def both(case):
    """The case on both packages; the port's result must equal the
    reference's. Returns the port's."""
    out = {name: case(side) for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def fast_policy(s, **kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("base_s", 0.0001)
    kw.setdefault("cap_s", 0.001)
    return s.backoff.RetryPolicy(**kw)


def placed(store):
    return {p.meta.key: p.spec.node_name for p in store.pods()}


# ---------------------------------------------------------------- registry


class TestFaultRegistry:
    @staticmethod
    def _pattern(s, seed, visits=200):
        reg = s.fi.FaultRegistry(seed=seed)
        reg.register(s.fi.FaultSpec("store.update", mode=s.fi.ERROR, transient=True,
                                    probability=0.3, times=20))
        reg.arm()
        out = []
        for _ in range(visits):
            try:
                out.append(reg.fire("store.update"))
            except s.fi.TransientFault:
                out.append("fault")
        return out

    def test_same_seed_replays_same_schedule(self):
        pattern = both(lambda s: self._pattern(s, 7))
        assert pattern == self._pattern(PORT, 7)
        assert "fault" in pattern

    def test_different_seed_differs(self):
        assert both(lambda s: self._pattern(s, 8)) != self._pattern(PORT, 7)

    def test_disarmed_is_inert(self):
        def case(s):
            reg = s.fi.FaultRegistry(seed=1)
            reg.register(s.fi.FaultSpec("tpu.launch", mode=s.fi.ERROR, probability=1.0))
            out = [reg.fire("tpu.launch") for _ in range(10)]
            assert out == [False] * 10
            assert reg.fired_total == 0
            return out

        both(case)

    def test_times_and_start_after_bound_the_spec(self):
        def case(s):
            reg = s.fi.FaultRegistry(seed=1)
            reg.register(s.fi.FaultSpec("tpu.collect", mode=s.fi.ERROR, transient=True,
                                        start_after=2, times=3))
            reg.arm()
            outcomes = []
            for _ in range(8):
                try:
                    reg.fire("tpu.collect")
                    outcomes.append("ok")
                except s.fi.TransientFault:
                    outcomes.append("fault")
            assert outcomes == ["ok", "ok", "fault", "fault", "fault", "ok", "ok", "ok"]
            assert reg.fired_total == 3
            return outcomes

        both(case)

    def test_unknown_point_rejected(self):
        for s in SIDES.values():
            reg = s.fi.FaultRegistry()
            with pytest.raises(KeyError):
                reg.register(s.fi.FaultSpec("no.such.point"))

    def test_drop_and_latency_modes(self):
        def case(s):
            reg = s.fi.FaultRegistry(seed=1)
            reg.register(s.fi.FaultSpec("watch.deliver", mode=s.fi.DROP, times=1))
            reg.register(s.fi.FaultSpec("store.create", mode=s.fi.LATENCY,
                                        latency_s=0.0, times=1))
            reg.arm()
            out = [reg.fire("watch.deliver"), reg.fire("watch.deliver"),
                   reg.fire("store.create")]
            assert out == [True, False, False]  # latency never raises
            assert reg.fired_total == 2
            return out

        both(case)


# ---------------------------------------------------------------- backoff


class TestRetryCall:
    def test_transient_failures_absorbed(self):
        def case(s):
            calls = {"n": 0}
            delays = []

            def flaky():
                calls["n"] += 1
                if calls["n"] < 3:
                    raise s.fi.TransientFault("flake")
                return "ok"

            out = s.backoff.retry_call(flaky, fast_policy(s), random.Random(1),
                                       sleep=lambda d: delays.append(d),
                                       on_backoff=lambda a, d: None)
            assert out == "ok" and calls["n"] == 3
            assert len(delays) == 2
            assert all(0 <= d <= 0.001 for d in delays)
            return delays

        both(case)

    def test_non_retryable_raises_immediately(self):
        for s in SIDES.values():
            calls = {"n": 0}

            def broken():
                calls["n"] += 1
                raise s.fi.PermanentFault("no")

            with pytest.raises(s.fi.PermanentFault):
                s.backoff.retry_call(broken, fast_policy(s), random.Random(1),
                                     sleep=lambda d: None)
            assert calls["n"] == 1

    def test_attempts_exhausted_reraises(self):
        for s in SIDES.values():
            calls = {"n": 0}

            def always():
                calls["n"] += 1
                raise s.fi.TransientFault("still down")

            with pytest.raises(s.fi.TransientFault):
                s.backoff.retry_call(always, fast_policy(s, max_attempts=3),
                                     random.Random(1), sleep=lambda d: None)
            assert calls["n"] == 3

    def test_duck_typed_transient_attribute(self):
        for s in SIDES.values():
            class WeirdError(Exception):
                transient = True

            calls = {"n": 0}

            def flaky():
                calls["n"] += 1
                if calls["n"] == 1:
                    raise WeirdError()
                return "ok"

            assert s.backoff.retry_call(flaky, fast_policy(s), random.Random(1),
                                        sleep=lambda d: None) == "ok"


# ------------------------------------------------------------- dispatcher


class TestDispatcherRetry:
    def test_injected_transient_faults_absorbed(self):
        def case(s):
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("dispatcher.execute", mode=s.fi.ERROR,
                                        transient=True, times=2))
            reg.arm()
            d = s.disp.APIDispatcher(parallelism=0, retry_policy=fast_policy(s))
            executed = {"n": 0}

            def execute():
                executed["n"] += 1

            call = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/p", execute))
            d.drain(timeout=5.0)
            reg.disarm()
            assert call.done.is_set() and call.error is None
            assert executed["n"] == 1
            assert d.retries == 2
            return executed["n"], d.retries

        both(case)

    def test_permanent_fault_surfaces(self):
        for s in SIDES.values():
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("dispatcher.execute", mode=s.fi.ERROR,
                                        transient=False, times=1))
            reg.arm()
            d = s.disp.APIDispatcher(parallelism=0, retry_policy=fast_policy(s))
            finishes = []
            call = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/p", lambda: None,
                                        on_finish=finishes.append))
            d.drain(timeout=5.0)
            reg.reset(seed=0)
            assert isinstance(call.error, s.fi.PermanentFault)
            assert len(finishes) == 1 and isinstance(finishes[0], s.fi.PermanentFault)


class TestDispatcherClose:
    def test_close_fails_queued_calls_terminally(self):
        for s in SIDES.values():
            d = s.disp.APIDispatcher(parallelism=0)  # no workers: calls stay queued
            finishes: list = []
            c1 = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/a", lambda: None,
                                      on_finish=finishes.append))
            c2 = d.add(s.disp.APICall(s.disp.POD_STATUS_PATCH, "default/b", lambda: None,
                                      on_finish=finishes.append))
            d.close()
            for c in (c1, c2):
                assert c.done.is_set()
                assert isinstance(c.error, s.disp.DispatcherClosedError)
            assert len(finishes) == 2
            assert all(isinstance(e, s.disp.DispatcherClosedError) for e in finishes)

    def test_add_after_close_rejected(self):
        for s in SIDES.values():
            d = s.disp.APIDispatcher(parallelism=0)
            d.close()
            finishes: list = []
            c = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/late", lambda: None,
                                     on_finish=finishes.append))
            assert c.done.is_set()
            assert isinstance(c.error, s.disp.DispatcherClosedError)
            assert len(finishes) == 1

    def test_close_is_idempotent_and_on_finish_fires_once(self):
        for s in SIDES.values():
            d = s.disp.APIDispatcher(parallelism=0)
            finishes: list = []
            d.add(s.disp.APICall(s.disp.POD_BINDING, "default/a", lambda: None,
                                 on_finish=finishes.append))
            d.close()
            d.close()
            assert len(finishes) == 1


class TestDispatcherParking:
    def test_deferred_key_runs_after_inflight_finishes(self):
        def case(s):
            d = s.disp.APIDispatcher(parallelism=2, retry_policy=fast_policy(s))
            d.run()
            started = threading.Event()
            release = threading.Event()
            order: list[str] = []

            def slow():
                order.append("first")
                started.set()
                release.wait(timeout=5.0)

            c1 = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/k", slow))
            assert started.wait(timeout=5.0)
            # same key while in flight: must park, not spin, and run after
            c2 = d.add(s.disp.APICall(s.disp.POD_BINDING, "default/k",
                                      lambda: order.append("second")))
            release.set()
            assert c1.done.wait(timeout=5.0) and c2.done.wait(timeout=5.0)
            assert c1.error is None and c2.error is None
            d.close()
            return order

        assert both(case) == ["first", "second"]


# ------------------------------------------------------ wave bind isolation


class TestWaveBindIsolation:
    def test_injected_binding_failure_fails_one_pod_only(self):
        def case(s):
            store = s.Store()
            store.create(s.w.make_node("n0", cpu="8", mem="16Gi"))
            for name in ("a", "b", "c"):
                store.create(s.w.make_pod(name, cpu="100m", mem="64Mi"))
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("store.bind_pod", mode=s.fi.ERROR,
                                        transient=True, times=1))
            reg.arm()
            out = store.bind_pods([("default/a", "n0"), ("default/b", "n0"),
                                   ("default/c", "n0")])
            reg.disarm()
            assert out[0].startswith("error:")
            assert out[1] == "bound" and out[2] == "bound"
            assert store.get("Pod", "default/a").spec.node_name == ""
            assert store.get("Pod", "default/b").spec.node_name == "n0"
            return out, placed(store)

        both(case)


# --------------------------------------------------------- circuit breaker


class TestCircuitBreaker:
    @staticmethod
    def make(s, now, **kw):
        kw.setdefault("threshold", 3)
        kw.setdefault("cooldown_s", 10.0)
        kw.setdefault("probes", 2)
        return s.cb.CircuitBreaker(clock=lambda: now[0], **kw)

    def test_trips_after_threshold_consecutive_failures(self):
        def case(s):
            b = self.make(s, [0.0])
            b.record_failure()
            b.record_success()  # resets the streak
            for _ in range(2):
                b.record_failure()
            assert b.state == s.cb.CLOSED
            b.record_failure()
            assert b.state == s.cb.OPEN and b.trip_count == 1
            assert b.device_blocked() is True
            assert b.allow_device_wave() is False
            return b.state, b.trip_count

        both(case)

    def test_half_open_probes_metered_then_close(self):
        def case(s):
            now = [0.0]
            b = self.make(s, now)
            for _ in range(3):
                b.record_failure()
            now[0] = 11.0
            assert b.device_blocked() is False
            out = [b.allow_device_wave() for _ in range(3)]
            assert out == [True, True, False]  # two probes, then metered
            assert b.state == s.cb.HALF_OPEN
            b.record_success()
            assert b.state == s.cb.HALF_OPEN
            b.record_success()
            assert b.state == s.cb.CLOSED and b.recovery_count == 1
            return out, b.recovery_count

        both(case)

    def test_failed_probe_reopens_and_restarts_cooldown(self):
        def case(s):
            now = [0.0]
            b = self.make(s, now)
            for _ in range(3):
                b.record_failure()
            now[0] = 11.0
            assert b.allow_device_wave() is True
            b.record_failure("probe died")
            assert b.state == s.cb.OPEN and b.trip_count == 2
            now[0] = 20.0  # inside the restarted cooldown
            assert b.allow_device_wave() is False
            now[0] = 22.0
            assert b.allow_device_wave() is True
            return b.trip_count

        both(case)

    def test_benign_outcome_releases_probe_slot(self):
        def case(s):
            now = [0.0]
            b = self.make(s, now, probes=1)
            for _ in range(3):
                b.record_failure()
            now[0] = 11.0
            out = [b.allow_device_wave(), b.allow_device_wave()]
            b.record_benign()  # wave never reached the device: slot freed
            assert b.state == s.cb.HALF_OPEN
            out.append(b.allow_device_wave())
            assert out == [True, False, True]
            return out

        both(case)

    def test_transitions_fan_out(self):
        def case(s):
            seen = []
            b = s.cb.CircuitBreaker(threshold=1, cooldown_s=0.0, probes=1,
                                    clock=lambda: 0.0,
                                    on_transition=lambda *e: seen.append(e))
            b.record_failure()
            b.allow_device_wave()
            b.record_success()
            out = [(o, n) for o, n, _ in seen]
            assert out == [(s.cb.CLOSED, s.cb.OPEN), (s.cb.OPEN, s.cb.HALF_OPEN),
                           (s.cb.HALF_OPEN, s.cb.CLOSED)]
            return out

        both(case)


class TestProbeWaveSizing:
    def test_half_open_caps_wave_at_probe_size(self):
        """While HALF_OPEN the wave popper gives the recovering device a
        PROBE_WAVE_PODS taster; the rest waits for the probe's verdict,
        then drains in full-size waves — the same waves in both."""
        def case(s):
            probe = s.loop.PROBE_WAVE_PODS
            store = s.Store()
            for i in range(4):
                store.create(s.w.make_node(f"n{i}", cpu="32", mem="64Gi"))
            for i in range(probe * 3):
                store.create(s.w.make_pod(f"p{i:02d}", cpu="100m", mem="64Mi",
                                          labels={"app": "probe"}))
            sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu", wave_size=256)],
                                seed=3, **s.kw)
            algo = sched.algorithms["default-scheduler"]
            sched.start()
            sched.pump()
            with algo.breaker._mu:
                algo.breaker.state = s.cb.HALF_OPEN
            sched.loop.schedule_wave()
            infl = sched.loop._inflight_wave
            assert infl is not None, "probe wave must still go to the device"
            probe_pods = len(infl[1].pods)
            assert 0 < probe_pods <= probe
            with algo.breaker._mu:
                algo.breaker.state = s.cb.CLOSED
                algo.breaker._probes_inflight = 0
            sched.schedule_pending()
            sizes = [r.pods for r in sched.flight_recorder.records()]
            assert max(sizes) > probe, sizes
            return probe, probe_pods, sizes, placed(store)

        both(case)


# ---------------------------------------------------------- reconciliation


def cluster(s):
    store = s.Store()
    store.create(s.w.make_node("n0", cpu="8", mem="16Gi"))
    sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu", wave_size=4)],
                        seed=3, **s.kw)
    sched.start()
    return store, sched


class TestStartupReconciliation:
    def test_half_applied_bind_forgotten_and_requeued(self):
        def case(s):
            store, sched = cluster(s)
            store.create(s.w.make_pod("half", cpu="100m", mem="64Mi"))
            sched.pump()
            # a prior incarnation killed mid-bind: popped and assumed, but
            # the store write never landed
            sched.queue.pop_specific("default/half")
            sched.cache.assume_pod(store.get("Pod", "default/half"), "n0")
            stats = sched.reconcile()
            assert stats == {"adopted": 0, "forgotten": 1, "requeued": 1}
            assert sched.cache.assumed_pod_count() == 0
            sched.schedule_pending()
            assert store.get("Pod", "default/half").spec.node_name == "n0"
            return stats, placed(store)

        both(case)

    def test_bound_in_store_adopted(self):
        def case(s):
            store, sched = cluster(s)
            store.create(s.w.make_pod("landed", cpu="100m", mem="64Mi"))
            sched.pump()
            sched.queue.pop_specific("default/landed")
            cur = store.get("Pod", "default/landed")
            sched.cache.assume_pod(cur, "n0")
            # the bind DID land, but the scheduler died before the
            # confirming watch event arrived
            cur.spec.node_name = "n0"
            store.update(cur, check_version=False)
            stats = sched.reconcile()
            assert stats["adopted"] == 1 and stats["requeued"] == 0
            assert sched.cache.assumed_pod_count() == 0
            assert sched.cache.pod_count() == 1
            return stats

        both(case)

    def test_pod_gone_forgotten(self):
        def case(s):
            store, sched = cluster(s)
            store.create(s.w.make_pod("gone", cpu="100m", mem="64Mi"))
            sched.pump()
            sched.queue.pop_specific("default/gone")
            sched.cache.assume_pod(store.get("Pod", "default/gone"), "n0")
            store.delete("Pod", "default/gone")
            stats = sched.reconcile()
            assert stats == {"adopted": 0, "forgotten": 1, "requeued": 0}
            assert sched.cache.assumed_pod_count() == 0
            return stats

        both(case)


# ----------------------------------------------------------- resync repair


class TestInformerResync:
    def test_dropped_delivery_repaired_and_pod_scheduled(self):
        def case(s):
            store, sched = cluster(s)
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("watch.deliver", mode=s.fi.DROP))
            reg.arm()
            store.create(s.w.make_pod("lost", cpu="100m", mem="64Mi"))
            reg.disarm()
            sched.pump()  # ADDED never reached the watch: nothing to pump
            active, backoff, unsched = sched.queue.pending_pods()
            assert active + backoff + unsched == 0
            repaired = sched.informers.resync_all()
            assert repaired >= 1
            sched.schedule_pending()
            assert store.get("Pod", "default/lost").spec.node_name == "n0"
            return repaired, placed(store)

        both(case)

    def test_schedule_pending_self_heals_via_resync(self):
        def case(s):
            store, sched = cluster(s)
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("watch.deliver", mode=s.fi.DROP))
            reg.arm()
            store.create(s.w.make_pod("stranded", cpu="100m", mem="64Mi"))
            reg.disarm()
            # no explicit resync: schedule_pending's idle path repairs it
            sched.schedule_pending()
            assert store.get("Pod", "default/stranded").spec.node_name == "n0"
            return placed(store)

        both(case)


# -------------------------------------------------------- watch partitions


class TestWatchPartition:
    def test_partition_window_drops_consecutive_visits(self):
        def case(s):
            reg = s.fi.FaultRegistry(seed=1)
            reg.register(s.fi.FaultSpec("watch.partition", mode=s.fi.PARTITION,
                                        start_after=2, window=3, times=1))
            reg.arm()
            out = [reg.fire("watch.partition") for _ in range(8)]
            assert out == [False, False, True, True, True, False, False, False]
            assert reg.fired_total == 3
            return out

        both(case)

    def test_tail_gap_detected_and_repaired(self):
        def case(s):
            store = s.Store()
            fac = s.inf.InformerFactory(store)
            inf = fac.informer("Pod")
            events: list = []
            inf.add_handler(lambda et, old, new: events.append(et))
            fac.start_all()
            reg = s.fi.registry()
            reg.reset(seed=3)
            reg.register(s.fi.FaultSpec("watch.partition", mode=s.fi.PARTITION,
                                        window=50, times=1))
            reg.arm()
            store.create(s.w.make_pod("a", cpu="100m", mem="64Mi"))
            store.create(s.w.make_pod("b", cpu="100m", mem="64Mi"))
            reg.disarm()
            assert inf.pump() == 0 and events == []
            repaired = inf.detect_and_repair()
            assert repaired == 2 and inf.partitions_detected == 1
            assert sorted(inf.keys()) == ["default/a", "default/b"]
            # healthy stream: detection is a no-op, not a false positive
            assert inf.detect_and_repair() == 0
            assert inf.partitions_detected == 1
            return repaired, sorted(inf.keys()), events

        both(case)

    def test_interior_gap_detected_after_stream_resumes(self):
        def case(s):
            store = s.Store()
            fac = s.inf.InformerFactory(store)
            inf = fac.informer("Pod")
            fac.start_all()
            store.create(s.w.make_pod("before", cpu="100m", mem="64Mi"))
            inf.pump()
            reg = s.fi.registry()
            reg.reset(seed=3)
            reg.register(s.fi.FaultSpec("watch.partition", mode=s.fi.PARTITION,
                                        window=1, times=1))
            reg.arm()
            store.create(s.w.make_pod("lost", cpu="100m", mem="64Mi"))
            reg.disarm()
            store.create(s.w.make_pod("after", cpu="100m", mem="64Mi"))
            inf.pump()  # 'after' arrives; 'lost' never will
            assert inf.get("default/after") is not None
            assert inf.get("default/lost") is None
            repaired = inf.detect_and_repair()
            assert repaired >= 1 and inf.partitions_detected == 1
            assert inf.get("default/lost") is not None
            return repaired

        both(case)

    def test_scheduler_self_heals_and_records_partition(self):
        def case(s):
            store = s.Store()
            store.create(s.w.make_node("n0", cpu="8", mem="16Gi"))
            metrics = s.metrics.SchedulerMetrics()
            sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu", wave_size=4)],
                                metrics=metrics, seed=3, **s.kw)
            sched.start()
            reg = s.fi.registry()
            reg.reset(seed=5)
            reg.register(s.fi.FaultSpec("watch.partition", mode=s.fi.PARTITION,
                                        window=100, times=1))
            reg.arm()
            store.create(s.w.make_pod("stranded", cpu="100m", mem="64Mi"))
            reg.disarm()
            sched.schedule_pending()
            assert store.get("Pod", "default/stranded").spec.node_name == "n0"
            events = list(sched.flight_recorder.partition_events)
            assert len(events) >= 1
            kind, repaired, latency_s = events[0]
            assert repaired >= 1 and latency_s >= 0.0
            assert sched.flight_recorder.summary()["partitions_detected"] >= 1
            exposed = metrics.expose()
            assert "watch_partitions_detected" in exposed
            assert "watch_partition_repair_latency" in exposed
            return [(k, r) for k, r, _ in events], placed(store)

        both(case)


# ------------------------------------------------- bind commit concurrency


class TestBindCommitConcurrency:
    def test_reader_not_blocked_during_injected_bind_latency(self):
        """Injected bind latency sleeps in the prepare phase OUTSIDE the
        store lock, so concurrent readers proceed while the bind is slow."""
        s = PORT
        store = s.Store()
        store.create(s.w.make_node("n0", cpu="8", mem="16Gi"))
        store.create(s.w.make_pod("slow", cpu="100m", mem="64Mi"))
        reg = s.fi.registry()
        reg.reset(seed=3)
        latency_s = 0.75
        reg.register(s.fi.FaultSpec("store.bind_pod", mode=s.fi.LATENCY,
                                    latency_s=latency_s, times=1))
        reg.arm()
        done = threading.Event()
        t0 = time.perf_counter()

        def binder():
            store.bind_pods([("default/slow", "n0")])
            done.set()

        th = threading.Thread(target=binder)
        th.start()
        while reg.fired_total < 1 and time.perf_counter() - t0 < 5.0:
            time.sleep(0.001)
        assert reg.fired_total >= 1
        r0 = time.perf_counter()
        assert store.get("Pod", "default/slow") is not None
        store.pods()
        store.nodes()
        read_s = time.perf_counter() - r0
        assert not done.is_set(), "bind finished before the latency elapsed"
        assert th.join(timeout=5.0) is None and done.is_set()
        bind_s = time.perf_counter() - t0
        assert read_s < 0.25, f"reads took {read_s:.3f}s during a {latency_s}s bind"
        assert bind_s >= latency_s
        assert store.get("Pod", "default/slow").spec.node_name == "n0"


# --------------------------------------------------- kubelet death mid-run


class TestKubeletDeathMidWave:
    def test_victim_kubelet_death_taints_evicts_and_recovers(self):
        """Kill ONE kubelet via its fault point: its lease goes stale, the
        lifecycle controller taints the node and evicts its pods, the
        scheduler keeps converging on the survivors; reviving the kubelet
        clears the taint and new pods bind again — the same bindings and
        evictions in both packages."""
        def case(s):
            store = s.Store()
            clock = s.clock.FakeClock()
            kubelets = []
            for i in range(3):
                k = s.hollow.HollowKubelet(store, s.w.make_node(f"n{i}", cpu="16",
                                                                mem="32Gi"), clock=clock)
                k.register()
                kubelets.append(k)
            lc = s.lc.NodeLifecycleController(store, clock=clock)
            lc.grace_period = 10.0
            lc.start()
            lc.sweep()
            sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu", wave_size=4)],
                                seed=3, **s.kw)
            sched.start()
            for i in range(6):
                store.create(s.w.make_pod(f"p{i}", cpu="100m", mem="64Mi"))
            sched.schedule_pending()
            first = placed(store)
            assert all(first.values()) and "n0" in first.values()

            reg = s.fi.registry()
            reg.reset(seed=3)
            reg.register(s.fi.FaultSpec("kubelet.sync", mode=s.fi.DROP))
            victim, survivors = kubelets[0], kubelets[1:]
            for _ in range(8):
                clock.step(2.5)
                reg.arm()
                victim.sync_once()  # dropped: no heartbeat, lease goes stale
                reg.disarm()
                for k in survivors:
                    k.sync_once()
                lc.sync_once()
                sched.schedule_pending()
            n0 = store.get("Node", "n0")
            assert any(t.key == s.lc.UNREACHABLE_TAINT for t in n0.spec.taints)
            assert all(p.spec.node_name != "n0" for p in store.pods())
            assert all(p.spec.node_name for p in store.pods())
            after_kill = placed(store)

            for _ in range(6):
                clock.step(2.5)
                for k in kubelets:
                    k.sync_once()
                lc.sync_once()
                sched.schedule_pending()
            n0 = store.get("Node", "n0")
            assert not any(t.key == s.lc.UNREACHABLE_TAINT for t in n0.spec.taints)
            for i in range(2):
                store.create(s.w.make_pod(f"late{i}", cpu="100m", mem="64Mi"))
            sched.schedule_pending()
            assert all(p.spec.node_name for p in store.pods())
            assert sched.cache.assumed_pod_count() == 0
            assert sum(sched.queue.pending_pods()) == 0
            return first, after_kill, placed(store)

        both(case)


# ------------------------------------------------------- new fault points


class TestNewPointsRegistered:
    NEW_POINTS = ("watch.partition", "kubelet.sync", "kubelet.lease",
                  "kubelet.pleg", "controller.reconcile",
                  "controller.lifecycle", "controller.workloads")

    def test_fleet_points_declared(self):
        for p in self.NEW_POINTS:
            assert p in tfi.FAULT_POINTS, p
        assert tfi.POINTS is tfi.FAULT_POINTS
        assert tfi.POINTS == jfi.POINTS

    def test_disarmed_new_points_are_free(self):
        reg = tfi.FaultRegistry(seed=1)
        for p in self.NEW_POINTS:
            reg.register(tfi.FaultSpec(p, mode=tfi.ERROR, transient=True))
        for p in self.NEW_POINTS:
            for _ in range(5):
                assert reg.fire(p) is False
        assert reg.fired_total == 0


# ------------------------------------------------------------ arrival trace


class TestArrivalTrace:
    def test_same_seed_replays_same_trace(self):
        a = tchaos.ArrivalTrace(seed=7).arrivals()
        assert a == tchaos.ArrivalTrace(seed=7).arrivals()
        assert a != tchaos.ArrivalTrace(seed=8).arrivals()
        for shape in ("burst", "poisson", "diurnal"):
            assert (tchaos.ArrivalTrace(seed=7, shape=shape).arrivals()
                    == jchaos.ArrivalTrace(seed=7, shape=shape).arrivals())

    def test_trace_shape(self):
        a = tchaos.ArrivalTrace(seed=7, pods=50).arrivals()
        assert len(a) == 50 and a == sorted(a) and a[0] > 0.0
        gaps = [b - c for b, c in zip(a[1:], a)]
        assert min(gaps) >= 0.0
        assert max(gaps) > 3 * (sum(gaps) / len(gaps))


# ------------------------------------------------------------------- soak


class TestChaosSoak:
    def test_seeded_soak_converges_and_breaker_cycles(self):
        report = tchaos.run_soak(seed=7, device="cpu")
        assert report.ok, report.render()
        assert report.breaker_trips >= 1
        assert report.breaker_recoveries >= 1
        assert report.faults_fired > 0
        assert report.retries > 0


class TestTraceSoak:
    def test_arrival_trace_soak_converges(self):
        report = tchaos.run_trace_soak(seed=7, device="cpu")
        assert report.ok, report.render()
        assert report.partitions_detected >= 1
        assert report.partition_repairs >= 1
        assert report.breaker_trips >= 1
        assert report.breaker_recoveries >= 1
        assert report.nodes_unreachable_seen >= 1
        assert report.evicted >= 1
        assert report.bound >= 1, "post-recovery arrivals must bind"
        assert report.unbound == 0
        assert report.leaked_assumes == 0
        assert report.wall_clock_s <= report.budget_s


# ------------------------------------------------- golden with points armed


def golden(s, dedup, cross_wave=True):
    """tests/test_dedup_golden.py's TestFullPipelineGolden._run in either
    package: 30 mixed pods of three interleaved signatures on 6 nodes (27
    cpu asked of 24), waves of 8, seed 11."""
    store = s.Store()
    for i in range(6):
        store.create(s.w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % 2}"))
    shapes = (("a", "1", "1Gi"), ("b", "900m", "900Mi"), ("c", "800m", "800Mi"))
    for i in range(30):
        app, cpu, mem = shapes[i % 3]
        store.create(s.w.make_pod(f"{app}{i:02d}", cpu=cpu, mem=mem, labels={"app": app}))
    sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu", wave_size=8)],
                        seed=11, **s.kw)
    algo = sched.algorithms["default-scheduler"]
    algo.backend.dedup_enabled = dedup
    algo.backend.cross_wave_enabled = cross_wave
    sched.start()
    sched.schedule_pending()
    sched.event_recorder.flush()
    diags = {}
    for p in store.pods():
        for c in p.status.conditions:
            if c.type == "PodScheduled" and c.status == "False":
                diags[p.meta.name] = f"{c.reason}: {c.message}"
    return ({p.meta.name: p.spec.node_name for p in store.pods()}, diags,
            algo.rng.getstate(), dict(algo.backend.dedup_stats))


def register_everywhere(seed):
    reg = tfi.registry()
    reg.reset(seed=seed)
    for point in tfi.POINTS:
        reg.register(tfi.FaultSpec(point, mode=tfi.ERROR, transient=True))
    assert set(reg.points()) == set(tfi.POINTS)
    assert reg.armed is False
    return reg


class TestGoldenDisarmed:
    def test_bit_compat_holds_with_all_points_registered_disarmed(self):
        reg = register_everywhere(99)
        placed_off, diags_off, rng_off, _ = golden(PORT, dedup=False)
        placed_on, diags_on, rng_on, _ = golden(PORT, dedup=True)
        assert (placed_on, diags_on, rng_on) == (placed_off, diags_off, rng_off)
        assert sum(1 for v in placed_on.values() if v) > 0
        assert reg.fired_total == 0
        assert golden(SIDES["jax"], dedup=True)[:3] == (placed_on, diags_on, rng_on)

    def test_cross_wave_reuse_inert_under_disarmed_points(self):
        reg = register_everywhere(101)
        placed_off, diags_off, rng_off, stats_off = golden(PORT, True, cross_wave=False)
        placed_on, diags_on, rng_on, stats_on = golden(PORT, True, cross_wave=True)
        assert (placed_on, diags_on, rng_on) == (placed_off, diags_off, rng_off)
        assert stats_on["xwave_hits"] > 0, "reuse must be live in the enabled run"
        assert stats_off["xwave_hits"] == 0
        assert reg.fired_total == 0


# -------------------------------------------- node lifecycle, hollow kubelet


class TestNodeLifecycle:
    def test_stale_lease_taints_and_evicts(self):
        """A node's kubelet dies: past the grace period its node turns
        Ready=Unknown, takes the unreachable taint, its pod is evicted and,
        re-created, lands on the surviving node — alike in both."""
        def case(s):
            clock = s.clock.FakeClock()
            store = s.Store()
            nlc = s.lc.NodeLifecycleController(store, clock=clock)
            kubelets = s.hollow.start_hollow_nodes(store, 2, clock=clock)
            sched = s.Scheduler(store, profiles=[s.Profile(backend="tpu")], seed=3, **s.kw)
            sched.start()

            def converge():
                for _ in range(5):
                    for k in kubelets:
                        k.sync_once()
                    nlc.sync_once()
                    if store.try_get("Pod", "default/web") is None:
                        store.create(s.w.make_pod("web", cpu="1"))  # the owner's re-create
                    sched.schedule_pending()

            converge()
            pod = store.get("Pod", "default/web")
            assert pod.spec.node_name and pod.status.phase == "Running"
            victim = pod.spec.node_name
            kubelets = [k for k in kubelets if k.node_name != victim]
            clock.step(60)
            for k in kubelets:
                k.sync_once()  # survivors heartbeat
            nlc.sweep()
            converge()
            node = store.get("Node", victim)
            assert any(t.key == "node.kubernetes.io/unreachable" for t in node.spec.taints)
            ready = next(c for c in node.status.conditions if c.type == "Ready")
            assert ready.status == "Unknown"
            pods = store.pods()
            assert pods and all(p.spec.node_name != victim for p in pods)
            assert all(p.spec.node_name for p in pods)
            return victim, placed(store)

        both(case)


def test_hollow_kubelet_runs_pods_to_completion():
    """register → Ready node + lease; a bound pod goes Running with a
    stable address, a run-seconds pod with restartPolicy Never Succeeds,
    a deleted pod's containers stop — the same objects in both."""

    def case(s):
        stable_ip = thollow.stable_pod_ip if s is PORT else jip
        clock = s.clock.FakeClock()
        store = s.Store()
        k = s.hollow.HollowKubelet(store, s.w.make_node("h0", cpu="4"), clock=clock)
        k.register()
        node = store.get("Node", "h0")
        assert [(c.type, c.status) for c in node.status.conditions] == [("Ready", "True")]
        assert store.get("Lease", "kube-node-lease/h0").spec.holder_identity == "h0"
        svc = s.w.make_pod("svc", cpu="1")
        job = s.w.make_pod("job", cpu="1")
        job.meta.annotations["kubemark.io/run-seconds"] = "5"
        job.spec.restart_policy = "Never"
        for p in (svc, job):
            p.spec.node_name = "h0"
            store.create(p)
        assert k.sync_once() == 2
        # the address is the uid's (uids differ between the two stores)
        phases = {p.meta.name: (p.status.phase, p.status.pod_ip == stable_ip(p.meta.uid))
                  for p in store.pods()}
        assert all(ph == "Running" and same for ph, same in phases.values())
        clock.step(6)
        assert k.sync_once() == 1
        assert store.get("Pod", "default/job").status.phase == "Succeeded"
        store.delete("Pod", "default/svc")
        k.sync_once()
        assert "default/svc" not in k.runtime.containers
        lease = store.get("Lease", "kube-node-lease/h0")
        return phases, lease.spec.renew_time, sorted(k.runtime.containers)

    both(case)
    for uid in ("", "a", "3f2c-uid", "default/web"):
        assert thollow.stable_pod_ip(uid) == jip(uid)
