"""The port's pod latency ledger held to the reference's unit suite.

The reference's tests/test_podlatency.py cases (the streaming quantile
against numpy's inverted-CDF percentile, the ledger's first-wins and
last-wins edges, segments, late status acks, shedding, the on/off golden
and the wave path's entries) run against kubernetes_tpu_torch's copy; the
same stamp sequences go through both packages' ledgers to equal
snapshots; and the port's loop stamps each edge where the reference's
does (per-pod cycles, gang Permit waits, a kubelet's Running report).
TestTraceBenchDeterminism, TestRegressionGate and TestPodLatencyZpage
test the trace bench, the regression gate and the scheduler server, which
wait for ROADMAP A13 and A11b.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from kubernetes_tpu.scheduler.tpu import podlatency as jpodlatency
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics
from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
from kubernetes_tpu_torch.scheduler.tpu import podlatency
from kubernetes_tpu_torch.scheduler.tpu.podlatency import (
    EDGES,
    LEDGER_SERIES,
    SEGMENT_NAMES,
    PodLatencyLedger,
    StreamingQuantile,
)
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

# ------------------------------------------------------- streaming quantile


class TestStreamingQuantileGolden:
    """The ledger's estimator must agree with numpy's inverted-CDF
    percentile — the definition the README promises — on fixed seeds."""

    @pytest.mark.parametrize("seed", [0, 7, 1234])
    @pytest.mark.parametrize("n", [1, 5, 100, 1000])
    def test_matches_numpy_inverted_cdf(self, seed, n):
        rng = random.Random(seed)
        values = [rng.expovariate(3.0) for _ in range(n)]
        est = StreamingQuantile(window=max(n, 2))
        for v in values:
            est.add(v)
        for q in (0.5, 0.9, 0.99):
            expected = float(np.percentile(values, q * 100,
                                           method="inverted_cdf"))
            assert est.quantile(q) == expected

    def test_window_compression_is_deterministic(self):
        """Past the window, the oldest half is dropped — quantiles stay
        exact over the independently-simulated retained slice."""
        rng = random.Random(42)
        values = [rng.expovariate(1.0) for _ in range(1000)]
        est = StreamingQuantile(window=64)
        retained: list[float] = []
        for v in values:
            est.add(v)
            retained.append(v)
            if len(retained) > 64:
                del retained[:32]
        assert est.n() == len(retained)
        assert est.total_n == 1000
        for q in (0.5, 0.99):
            expected = float(np.percentile(retained, q * 100,
                                           method="inverted_cdf"))
            assert est.quantile(q) == expected

    def test_empty_returns_none(self):
        assert StreamingQuantile().quantile(0.5) is None


# ----------------------------------------------------------------- ledger


def stamp_all(ledger, key, t0=100.0, wave_id=None, clock=None):
    """Stamp every edge at exact binary-fraction offsets via a fake clock."""
    offsets = {  # edge -> perf_counter value (all exact in float64)
        "watch_arrival": t0,
        "queue_admission": t0 + 0.5,
        "wave_admission": t0 + 1.0,
        "kernel_verdict": t0 + 1.25,
        "bind_dispatch": t0 + 1.375,
        "bind_commit": t0 + 1.5,
    }
    for edge in EDGES[:-1]:
        if edge not in offsets:  # gang_wait_*: gang pods only
            continue
        clock.now = offsets[edge]
        ledger.stamp(key, edge, wave_id=wave_id)
    return offsets


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(podlatency.time, "perf_counter", c)
    return c


class TestLedger:
    def test_exact_segment_decomposition(self, clock):
        ledger = PodLatencyLedger()
        stamp_all(ledger, "default/p0", wave_id=3, clock=clock)
        entry = ledger.complete("default/p0")
        assert entry.segments == {
            "informer": 0.5,
            "queue_wait": 0.5,
            "kernel": 0.25,
            "bind_dispatch": 0.125,
            "bind_commit": 0.125,
            "e2e": 1.5,
        }
        d = entry.to_dict()
        assert d["wave_id"] == 3
        assert d["span"] == "wave/3"  # exemplar link to the wave span

    def test_first_wins_and_last_wins_edges(self, clock):
        ledger = PodLatencyLedger()
        clock.now = 10.0
        ledger.stamp("default/p0", "watch_arrival")
        clock.now = 20.0
        ledger.stamp("default/p0", "watch_arrival")  # requeue: must not move
        ledger.stamp("default/p0", "wave_admission")
        clock.now = 30.0
        ledger.stamp("default/p0", "wave_admission")  # retry: must move
        entry = ledger._open["default/p0"]
        assert entry.stamps["watch_arrival"] == 10.0
        assert entry.stamps["wave_admission"] == 30.0

    def test_late_status_ack_lands_on_retained_entry(self, clock):
        metrics = SchedulerMetrics()
        ledger = PodLatencyLedger(metrics=metrics)
        stamp_all(ledger, "default/p0", clock=clock)
        ledger.complete("default/p0")
        clock.now = 102.0  # bind_commit was at 101.5
        ledger.stamp("default/p0", "status_ack")
        (entry,) = ledger._completed
        assert entry.segments["status_ack"] == 0.5
        hist = metrics.registry.get(LEDGER_SERIES[0])
        assert hist.count("status_ack") == 1

    def test_histogram_and_gauges_land(self, clock):
        metrics = SchedulerMetrics()
        ledger = PodLatencyLedger(metrics=metrics)
        stamp_all(ledger, "default/p0", clock=clock)
        ledger.complete("default/p0")
        hist = metrics.registry.get(LEDGER_SERIES[0])
        for seg in ("informer", "queue_wait", "kernel", "e2e"):
            assert hist.count(seg) == 1
        ledger.update_gauges()
        gauge = metrics.registry.get(LEDGER_SERIES[1])
        assert gauge.get("e2e", "p50") == 1.5
        assert gauge.get("kernel", "p99") == 0.25

    def test_forget_drops_open_entry(self, clock):
        ledger = PodLatencyLedger()
        clock.now = 1.0
        ledger.stamp("default/p0", "watch_arrival")
        ledger.forget("default/p0")
        assert ledger.complete("default/p0") is None

    def test_open_cap_sheds_oldest_first(self, clock):
        ledger = PodLatencyLedger(open_cap=4)
        for i in range(6):
            clock.now = float(i)
            ledger.stamp(f"default/p{i}", "watch_arrival")
        assert len(ledger._open) == 4
        assert ledger.dropped_open == 2
        assert "default/p0" not in ledger._open  # oldest shed first
        assert "default/p5" in ledger._open

    def test_disabled_ledger_is_inert(self, clock):
        ledger = PodLatencyLedger()
        ledger.enabled = False
        clock.now = 1.0
        ledger.stamp("default/p0", "watch_arrival")
        assert ledger.complete("default/p0") is None
        assert ledger.summary()["pods_completed"] == 0

    def test_snapshot_last_and_slowest(self, clock):
        ledger = PodLatencyLedger()
        for i, t0 in enumerate([100.0, 200.0, 300.0]):
            key = f"default/p{i}"
            stamp_all(ledger, key, t0=t0, clock=clock)
            if i == 1:  # make p1 the slowest e2e
                clock.now = t0 + 9.0
                ledger.stamp(key, "bind_commit")
            ledger.complete(key)
        snap = ledger.snapshot(last=2, slowest=1)
        assert [e["pod"] for e in snap["last"]] == ["default/p1",
                                                    "default/p2"]
        assert snap["slowest"][0]["pod"] == "default/p1"
        assert snap["summary"]["pods_completed"] == 3
        assert set(snap["summary"]["segments"]) <= set(SEGMENT_NAMES)

    def test_completed_ring_bounded(self, clock):
        ledger = PodLatencyLedger(capacity=2)
        for i in range(5):
            key = f"default/p{i}"
            stamp_all(ledger, key, t0=10.0 * i, clock=clock)
            ledger.complete(key)
        assert len(ledger._completed) == 2
        assert ledger.completed_total == 5


# -------------------------------------------------- ledger on/off golden


class TestLedgerBitCompat:
    def test_placements_identical_ledger_on_vs_off(self):
        """The ledger consumes no rng and influences no decision: the same
        seeded wave workload places identically with it on (production
        default) and off."""

        def run(ledger_on: bool) -> dict[str, str]:
            store = Store()
            for i in range(8):
                store.create(make_node(f"n{i}", cpu="4", mem="8Gi",
                                       zone=f"z{i % 2}"))
            sched = Scheduler(
                store,
                profiles=[Profile(backend="tpu", wave_size=16)],
                metrics=SchedulerMetrics(),
                seed=11,
                device="cpu",
            )
            sched.flight_recorder.pod_ledger.enabled = ledger_on
            sched.start()
            for i in range(24):
                kind = i % 3
                cpu, mem = [("1", "1Gi"), ("900m", "900Mi"),
                            ("800m", "800Mi")][kind]
                store.create(make_pod(f"g{i:02d}", cpu=cpu, mem=mem,
                                      labels={"app": "abc"[kind]}))
            sched.pump()
            sched.schedule_pending()
            return {p.meta.key: p.spec.node_name for p in store.pods()}

        on, off = run(True), run(False)
        assert on == off
        assert any(on.values())  # the workload actually scheduled

    def test_ledger_populated_under_wave_path(self):
        """With the ledger on (default), the wave pipeline completes an
        entry per bound pod, with every pipeline segment present."""
        store = Store()
        for i in range(4):
            store.create(make_node(f"n{i}", cpu="8", mem="16Gi"))
        sched = Scheduler(
            store,
            profiles=[Profile(backend="tpu", wave_size=8)],
            metrics=SchedulerMetrics(),
            seed=3,
            device="cpu",
        )
        sched.start()
        for i in range(10):
            store.create(make_pod(f"w{i}", cpu="500m", mem="256Mi"))
        sched.pump()
        sched.schedule_pending()
        ledger = sched.flight_recorder.pod_ledger
        bound = sum(1 for p in store.pods() if p.spec.node_name)
        assert bound == 10
        assert ledger.completed_total == bound
        segs = ledger.segment_quantiles()
        for name in ("informer", "queue_wait", "kernel", "bind_commit",
                     "e2e"):
            assert segs[name]["n"] == bound



# ------------------------------------------------ port == reference ledger


def _replay(mod, monkeypatch):
    """One fixed stamp script (requeues, a gang wait, a forgotten pod, a
    late status ack, open-cap shedding) through a package's ledger on a
    fake clock; returns its snapshot and per-entry stamp order."""
    clock = FakeClock()
    monkeypatch.setattr(mod.time, "perf_counter", clock)
    monkeypatch.setattr(mod.time, "time", lambda: 0.0)
    ledger = mod.PodLatencyLedger(capacity=8, open_cap=6, window=16)
    rng = random.Random(5)
    t = 1.0
    for i in range(12):
        key = f"default/p{i}"
        edges = ["watch_arrival", "queue_admission", "wave_admission"]
        if i % 4 == 1:  # a requeue: the first-wins edges keep the first
            edges += ["watch_arrival", "queue_admission", "wave_admission"]
        edges += ["kernel_verdict"]
        if i % 3 == 2:
            edges += ["gang_wait_start", "gang_wait_end"]
        edges += ["bind_dispatch", "bind_commit"]
        for edge in edges:
            t += rng.choice((0.125, 0.25, 0.5))
            clock.now = t
            ledger.stamp(key, edge, wave_id=i // 4 if edge == "kernel_verdict" else None)
        if i == 7:
            ledger.forget(key)
            continue
        ledger.complete(key)
        if i % 5 == 0:
            clock.now = t + 0.0625
            ledger.stamp(key, "status_ack")
    for i in range(9):  # open entries past the cap shed oldest-first
        clock.now = t + i
        ledger.stamp(f"default/q{i}", "watch_arrival")
    order = [(e.key, list(e.stamps), e.wave_id) for e in ledger._completed]
    return ledger.snapshot(last=8, slowest=3), order, ledger.dropped_open


def test_ledger_equals_the_reference(monkeypatch):
    assert jpodlatency.EDGES == EDGES and jpodlatency.SEGMENTS == podlatency.SEGMENTS
    assert jpodlatency.LEDGER_SERIES == LEDGER_SERIES
    got = _replay(podlatency, monkeypatch)
    want = _replay(jpodlatency, monkeypatch)
    assert got == want
    assert got[2] == 3 and len(got[1]) == 8


# ------------------------------------------------ the port loop's stamps


def test_per_pod_cycle_and_status_ack_stamps():
    """wave_size 0: every pod takes the per-pod cycle (K4's plain version),
    whose admission and verdict stamp like a wave's; a kubelet's Running
    report lands status_ack on the completed entry."""
    store = Store()
    for i in range(3):
        store.create(make_node(f"n{i}", cpu="4", mem="8Gi"))
    s = Scheduler(store, profiles=[Profile(wave_size=0)], seed=1, device="cpu")
    s.start()
    for i in range(4):
        store.create(make_pod(f"p{i}", cpu="1", mem="1Gi"))
    s.schedule_pending()
    ledger = s.flight_recorder.pod_ledger
    assert ledger.completed_total == 4
    want = ["watch_arrival", "queue_admission", "wave_admission",
            "kernel_verdict", "bind_dispatch", "bind_commit"]
    assert [list(e.stamps) for e in ledger._completed] == [want] * 4
    pod = store.get("Pod", "default/p0")
    pod.status.phase = "Running"
    store.update(pod)
    s.pump()
    entry = ledger._recent["default/p0"]
    assert "status_ack" in entry.stamps and entry.segments["status_ack"] >= 0.0


def test_deleted_pending_pod_leaves_no_open_entry():
    store = Store()
    store.create(make_node("n0", cpu="1", mem="1Gi"))
    s = Scheduler(store, profiles=[Profile(wave_size=8)], seed=1, device="cpu",
                  metrics=SchedulerMetrics())
    s.start()
    store.create(make_pod("big", cpu="4", mem="1Gi"))  # fits nowhere
    s.schedule_pending()
    ledger = s.flight_recorder.pod_ledger
    assert "default/big" in ledger._open
    store.delete("Pod", "default/big")
    s.pump()
    assert "default/big" not in ledger._open
    assert ledger.completed_total == 0
