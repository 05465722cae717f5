"""The port's wave recorder held to the reference's flight-recorder suite,
and the telemetry's cross-package and on/off goldens.

The reference's tests/test_flightrecorder.py cases (the ring buffer,
fallback attribution, the span tree, the full-telemetry golden, the
watchdog, the metric exposition, the event recorder's counters, the CLI)
and tests/test_observability.py's TestSlowCycleTrace run against
kubernetes_tpu_torch's WaveRecorder and Scheduler (device="cpu": the
kernels' plain versions).

Cross-package goldens: one store workload through both packages'
Scheduler(backend="tpu") with every telemetry part on (metrics, a tracer
with an exporter) gives equal bindings, diagnoses and rng, every
non-timing field of every wave record equal, each completed pod's ledger
edge sequence equal, and the same plugin observation count per
(extension point, plugin) — in the golden triple's configurations and
modes, on a gang, on breaker-OPEN waves and on collect flakes.

On/off goldens: the port's bindings and rng are identical with each part
on and off (ledger, profiler, device telemetry, metrics, tracer and the
watchdog), at depths 1 and 2, dedup on and off, and on a breaker-OPEN
wave opened by the tpu.launch fault point.
"""

from __future__ import annotations

import json
import logging
import time
from types import SimpleNamespace

import pytest

import kubernetes_tpu.scheduler.metrics as jmetrics
import kubernetes_tpu.utils.tracing as jtracing
import kubernetes_tpu_torch.scheduler.metrics as tmetrics
import kubernetes_tpu_torch.utils.tracing as ttracing
from kubernetes_tpu.utils.faultinject import ERROR as JERROR
from kubernetes_tpu.utils.faultinject import FaultSpec as JFaultSpec
from kubernetes_tpu_torch.api import meta as tmeta
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.scheduler.events import EventRecorder
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics
from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
from kubernetes_tpu_torch.scheduler.tpu.waverecorder import (
    WaveRecord,
    WaveRecorder,
    format_postmortem,
)
from kubernetes_tpu_torch.scheduler.tpu.waverecorder import main as fr_main
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testing.mixed import burst_pods, dedup_nodes
from kubernetes_tpu_torch.testing.mixed import dedup_pods as mixed_pods
from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod
from kubernetes_tpu_torch.utils.faultinject import ERROR as TERROR
from kubernetes_tpu_torch.utils.faultinject import FaultSpec as TFaultSpec
from kubernetes_tpu_torch.utils.tracing import InMemoryExporter, Tracer
from tests.test_torch_loop import SIDES, _port_registry, outcome  # noqa: F401 (autouse)
from tests.test_torch_loop_golden import CONFIGS, MODES, _run_stream
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)


def drain_waves(fr, n, **end_kw):
    recs = []
    for _ in range(n):
        r = fr.begin_wave(pods=8, pad=8)
        recs.append(fr.end_wave(r, **end_kw))
    return recs


# ------------------------------------------------------------- ring buffer


class TestRingBuffer:
    def test_capacity_bounds_under_churn(self):
        fr = WaveRecorder(capacity=4, slow_wave_deadline_s=None)
        drain_waves(fr, 10)
        recs = fr.records()
        assert len(recs) == 4, "ring must cap at capacity"
        assert [r.wave_id for r in recs] == [7, 8, 9, 10], \
            "oldest records must be dropped first"
        assert [r.wave_id for r in fr.records(last=2)] == [9, 10]
        # the cumulative counters keep counting past the ring
        fr.count_wave()
        assert fr.summary()["waves_recorded"] == 4

    def test_record_fields_and_dump_shape(self):
        fr = WaveRecorder(capacity=8, slow_wave_deadline_s=None)
        rec = fr.begin_wave(pods=30, pad=32)
        fr.note_launch(rec, signatures=3, dedup=True)
        with fr.phase("kernel", rec):
            pass
        with fr.wave_phase("dispatch", rec):
            pass
        fr.carry_invalidated()
        fr.end_wave(rec, fallback_reason="resync: planes changed")
        assert rec.clones == 27
        assert rec.distinct_signature_ratio == 0.1
        assert rec.dedup_tier == "dedup"
        assert rec.occupancy == round(30 / 32, 4)
        assert rec.carry_invalidations == 1
        assert set(rec.phases) == {"kernel", "dispatch"}
        payload = json.loads(fr.dump())
        assert set(payload) == {"summary", "phase_totals", "wave_totals",
                                "pod_latency", "device_telemetry", "stalls",
                                "records"}
        (d,) = payload["records"]
        assert d["fallback_reason"] == "resync: planes changed"
        # internal bookkeeping must not leak into the serialized record
        assert not any(k.startswith("_") for k in d)

    def test_phase_accumulates_across_exceptions(self):
        # NeedResync propagates through the "kernel" phase on retry; the
        # stopwatch must still account the aborted attempt
        fr = WaveRecorder(slow_wave_deadline_s=None)
        with pytest.raises(RuntimeError):
            with fr.phase("kernel"):
                raise RuntimeError("resync")
        with fr.phase("kernel"):
            pass
        assert fr.phase_snapshot()["kernel"] > 0.0
        snap = fr.phase_snapshot()
        snap["kernel"] = -1.0  # snapshots are copies, not aliases
        assert fr.phase_snapshot()["kernel"] >= 0.0


# ------------------------------------------------- fallback attribution


class TestFallbackAttribution:
    def test_context_attributes_plugin_time(self):
        fr = WaveRecorder(slow_wave_deadline_s=None)

        class FW:
            plugin_observer = None

        fw = FW()
        rec = fr.begin_wave(pods=2, pad=2)
        with fr.fallback_attribution(fw, record=rec):
            assert fw.plugin_observer is not None
            fw.plugin_observer("Filter", "NodeResourcesFit", 0.05)
            fw.plugin_observer("Score", "NodeResourcesFit", 0.01)
            fw.plugin_observer("Filter", "TaintToleration", 0.02)
        assert fw.plugin_observer is None, "observer must be uninstalled"
        assert rec.phases["fallback/NodeResourcesFit"] == pytest.approx(0.06)
        assert rec.phases["fallback/TaintToleration"] == pytest.approx(0.02)
        snap = fr.phase_snapshot()
        assert snap["fallback/NodeResourcesFit"] == pytest.approx(0.06)

    def test_observer_restored_on_exception(self):
        fr = WaveRecorder(slow_wave_deadline_s=None)

        class FW:
            plugin_observer = None

        fw = FW()
        with pytest.raises(RuntimeError):
            with fr.fallback_attribution(fw):
                raise RuntimeError("fallback blew up")
        assert fw.plugin_observer is None

    def test_breaker_open_wave_attributes_host_plugins(self):
        """End to end: a wave hitting an OPEN breaker drains through the
        host tier with per-plugin attribution — `fallback/<plugin>` phases
        land in the recorder's totals."""
        store = Store()
        store.create(make_node("n0", cpu="8", mem="16Gi"))
        for p in mixed_pods(6, ttypes, tmeta):
            store.create(p)
        s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=8)],
                      seed=2, device="cpu")
        algo = s.algorithms["default-scheduler"]
        s.start()
        with algo.breaker._mu:
            algo.breaker.state = "open"
            algo.breaker._opened_at = algo.breaker._clock()
            algo.breaker.cooldown_s = 120.0
        s.schedule_pending()
        s.event_recorder.flush()
        placed = [p for p in store.pods() if p.spec.node_name]
        assert len(placed) == 6, "host tier must still schedule the wave"
        fallback_phases = [k for k in s.flight_recorder.phase_snapshot()
                           if k.startswith("fallback/")]
        assert fallback_phases, "per-plugin fallback attribution missing"


# --------------------------------------------------------------- span tree


class TestSpanTree:
    def test_multi_wave_run_exports_wave_roots_with_phase_children(self):
        exporter = InMemoryExporter(capacity=4096)
        store = Store()
        for i in range(6):
            store.create(make_node(f"n{i}", cpu="4", mem="8Gi",
                                   zone=f"z{i % 2}"))
        for p in mixed_pods(24, ttypes, tmeta):
            store.create(p)
        s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=8)],
                      seed=11, tracer=Tracer("sched", exporter), device="cpu")
        s.start()
        s.schedule_pending()
        waves = exporter.find("wave/")
        assert len(waves) >= 2, "24 pods at wave_size=8 must trace >1 wave"
        for root in waves:
            child_names = {c.name for c in root.children}
            # collect + finish + bind all nest under the wave root
            assert "phase/kernel" in child_names
            assert "phase/finish" in child_names
            assert "phase/bind" in child_names
            assert root.attributes.get("pods", 0) > 0
            assert root.end > root.start
        # launch-side phases export as their own roots (the launch runs
        # pipelined, outside any wave span)
        assert exporter.find("phase/snapshot")
        # backend wave-path phases ride as descendants or roots, but the
        # device wait must be inside the wave's kernel phase
        kernel = next(c for c in waves[0].children
                      if c.name == "phase/kernel")
        assert any(g.name == "wave_phase/wait" for g in kernel.children)

    def test_flight_records_match_traced_waves(self):
        store = Store()
        for i in range(4):
            store.create(make_node(f"n{i}", cpu="8", mem="16Gi"))
        for p in mixed_pods(16, ttypes, tmeta):
            store.create(p)
        s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=8)],
                      seed=3, device="cpu")
        s.start()
        s.schedule_pending()
        fr = s.flight_recorder
        recs = fr.records()
        assert recs, "completed waves must land in the ring buffer"
        for r in recs:
            assert r.pods > 0 and r.pad >= r.pods
            assert 0.0 < r.occupancy <= 1.0
            assert r.duration_s > 0.0
            assert "bind" in r.phases and "finish" in r.phases
        assert fr.summary()["waves_total"] == fr.phase_snapshot()["waves"]


# ------------------------------------------------- golden bit-compat on/off


class TestRecorderGolden:
    """Full telemetry on vs default-off: byte-identical scheduling outcome.
    Mirrors tests/test_dedup_golden.py TestFullPipelineGolden."""

    @staticmethod
    def _run(telemetry):
        store = Store()
        for i in range(6):
            store.create(make_node(f"n{i}", cpu="4", mem="8Gi",
                                   zone=f"z{i % 2}"))
        for p in mixed_pods(30, ttypes, tmeta):
            store.create(p)
        kw = {}
        if telemetry:
            kw["tracer"] = Tracer("sched", InMemoryExporter(capacity=4096))
            kw["metrics"] = SchedulerMetrics()
        s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=8)],
                      seed=11, device="cpu", **kw)
        if telemetry:
            # arm the watchdog so aggressively every wave trips it — the
            # profile capture thread must not perturb decisions either
            s.flight_recorder.slow_wave_deadline_s = 1e-4
            s.flight_recorder.profile_seconds = 0.01
        s.start()
        s.schedule_pending()
        s.event_recorder.flush()
        placed = {p.meta.name: p.spec.node_name for p in store.pods()}
        diags = {}
        for p in store.pods():
            for c in p.status.conditions:
                if c.type == "PodScheduled" and c.status == "False":
                    diags[p.meta.name] = f"{c.reason}: {c.message}"
        algo = s.algorithms["default-scheduler"]
        rng_state = algo.rng.getstate() if algo.rng is not None else None
        return placed, diags, rng_state, s

    def test_full_telemetry_is_bit_compatible(self):
        placed_off, diags_off, rng_off, _ = self._run(telemetry=False)
        placed_on, diags_on, rng_on, s = self._run(telemetry=True)
        assert placed_on == placed_off
        assert diags_on == diags_off
        assert rng_on == rng_off
        assert sum(1 for v in placed_on.values() if v) > 0
        assert diags_on, "scenario must exercise failures too"
        # and the telemetry run must have actually recorded things
        assert s.flight_recorder.records()
        assert s.flight_recorder.slow_wave_captures > 0
        assert "scheduler_tpu_wave_duration_seconds" in s.metrics.expose()


# ---------------------------------------------------------------- watchdog


class TestWatchdog:
    def test_slow_wave_captures_profile(self):
        fr = WaveRecorder(slow_wave_deadline_s=0.05, profile_seconds=0.05,
                            metrics=SchedulerMetrics())
        rec = fr.begin_wave(pods=8, pad=8)
        time.sleep(0.2)  # blow the deadline while the wave is open
        fr.end_wave(rec)
        assert fr.slow_wave_captures == 1
        assert rec.profile is not None
        assert "slow wave 1" in rec.profile
        assert "sampling profile:" in rec.profile
        assert fr.metrics.slow_wave_captures_total.get() == 1.0
        assert "[profile captured]" in format_postmortem(
            [r.to_dict() for r in fr.records()]
        )

    def test_fast_wave_disarms_watchdog(self):
        fr = WaveRecorder(slow_wave_deadline_s=0.1)
        rec = fr.begin_wave(pods=8, pad=8)
        fr.end_wave(rec)  # well inside the deadline: timer cancelled
        time.sleep(0.25)
        assert fr.slow_wave_captures == 0
        assert rec.profile is None
        assert not fr._watchdogs, "end_wave must disarm its timer"

    def test_watchdog_off_by_default(self):
        assert WaveRecorder().slow_wave_deadline_s is None
        fr = WaveRecorder(slow_wave_deadline_s=0)  # 0 == off, not "instant"
        rec = fr.begin_wave(pods=1)
        assert not fr._watchdogs
        fr.end_wave(rec)


# --------------------------------------------------- exposition goldens


class TestMetricsExposition:
    @staticmethod
    def _completed_record():
        rec = WaveRecord(wave_id=1, started_at=0.0, pods=30, pad=32)
        rec.duration_s = 0.125
        rec.occupancy = 0.9375
        rec.signatures = 3
        rec.clones = 27
        rec.distinct_signature_ratio = 0.1
        rec.dedup_tier = "dedup"
        rec.phases = {"kernel": 0.1, "bind": 0.02}
        rec.fallback_reason = "resync: planes changed"
        return rec

    def test_wave_series_exposed(self):
        m = SchedulerMetrics()
        m.wave_completed(self._completed_record())
        text = m.expose()
        assert "# TYPE scheduler_tpu_wave_duration_seconds histogram" in text
        assert "scheduler_tpu_wave_duration_seconds_count 1" in text
        assert ('scheduler_tpu_wave_phase_duration_seconds_count'
                '{phase="kernel"} 1') in text
        assert ('scheduler_tpu_wave_phase_duration_seconds_count'
                '{phase="bind"} 1') in text
        assert "scheduler_tpu_wave_dedup_ratio 0.1" in text
        assert "scheduler_tpu_signature_cache_hits_total 27.0" in text
        # fallback reason cardinality is bounded: detail after ':' stripped
        assert ('scheduler_tpu_wave_fallbacks_total{reason="resync"} 1.0'
                in text)
        assert "planes changed" not in text

    def test_sli_quantile_gauges(self):
        m = SchedulerMetrics()
        m._sli_samples = [float(i) for i in range(1, 101)]
        m.update_sli_quantiles()
        text = m.expose()
        assert ('scheduler_pod_scheduling_sli_quantile_seconds'
                '{quantile="p50"} 51.0') in text
        assert ('scheduler_pod_scheduling_sli_quantile_seconds'
                '{quantile="p99"} 100.0') in text

    def test_end_wave_lands_series_via_recorder(self):
        m = SchedulerMetrics()
        fr = WaveRecorder(metrics=m, slow_wave_deadline_s=None)
        rec = fr.begin_wave(pods=8, pad=8)
        fr.note_launch(rec, signatures=2, dedup=True)
        fr.end_wave(rec)
        assert m.wave_duration.count() == 1
        assert m.signature_cache_hits.get() == 6.0
        assert m.wave_dedup_ratio.get() == 0.25


# ------------------------------------------------- event recorder counters


class TestEventRecorderMetrics:
    def test_dispositions_counted(self):
        store = Store()
        rec = EventRecorder(store)
        rec.metrics = SchedulerMetrics()
        pod = make_pod("p0", cpu="1", mem="1Gi")
        for _ in range(rec.AGGREGATE_SPILL + 5):
            rec.event(pod, "Normal", "Scheduled", "bound", correlation="w1")
        assert rec.metrics.events_total.get("recorded") == \
            float(rec.AGGREGATE_SPILL)
        assert rec.metrics.events_total.get("aggregated") == 5.0
        assert 'scheduler_events_total{disposition="aggregated"} 5.0' \
            in rec.metrics.expose()

    def test_gc_reports_pruned_count(self):
        from kubernetes_tpu_torch.api.events import Event
        from kubernetes_tpu_torch.api.meta import ObjectMeta

        store = Store()
        rec = EventRecorder(store)
        rec.metrics = SchedulerMetrics()
        stale = Event(meta=ObjectMeta(name="stale"), involved_object="Pod/x",
                      reason="R", message="old",
                      first_timestamp=1.0, last_timestamp=1.0)
        store.create(stale)
        fresh = Event(meta=ObjectMeta(name="fresh"), involved_object="Pod/y",
                      reason="R", message="new",
                      first_timestamp=time.time(),
                      last_timestamp=time.time())
        store.create(fresh)
        assert rec._gc() == 1
        assert rec.metrics.events_gc_pruned.get() == 1.0
        events, _ = store.list("Event")
        assert [e.meta.name for e in events] == ["fresh"]


# --------------------------------------------------------------------- CLI


class TestCli:
    def test_demo_smoke(self, capsys):
        assert fr_main(["--demo"]) == 0
        out = capsys.readouterr().out
        assert "slowest phases" in out  # table header
        assert "[profile captured]" in out  # demo trips the watchdog once
        assert "tie-break draw overflow" in out
        assert "summary:" in out

    def test_demo_waits_for_a_slow_profile(self, capsys, monkeypatch):
        """The watchdog's capture may finish long after its deadline (a
        loaded host): the demo's slow wave stays open until the capture
        lands, so the dump always shows it. A fixed sleep shorter than the
        profile lost it."""
        import kubernetes_tpu_torch.utils.pprof as tpprof

        def slow_profile(seconds=1.0, **kw):
            time.sleep(0.3)
            return "slow stacks"

        monkeypatch.setattr(tpprof, "take_profile", slow_profile)
        assert fr_main(["--demo"]) == 0
        out = capsys.readouterr().out
        assert "[profile captured]" in out

    def test_schema_lists_public_fields_only(self, capsys):
        assert fr_main(["--schema"]) == 0
        fields = capsys.readouterr().out.split()
        assert "wave_id" in fields and "fallback_reason" in fields
        assert not any(f.startswith("_") for f in fields)

    def test_dump_file_roundtrip(self, tmp_path, capsys):
        fr = WaveRecorder(capacity=8, slow_wave_deadline_s=None)
        drain_waves(fr, 5)
        p = tmp_path / "dump.json"
        p.write_text(fr.dump())
        assert fr_main([str(p), "--last", "2"]) == 0
        out = capsys.readouterr().out
        assert "waves_recorded=5" in out
        # --last trims the table to the newest records
        assert " 5 " in out.splitlines()[2] or "5" in out.splitlines()[2]
        assert len([ln for ln in out.splitlines()
                    if ln and ln[0].isdigit()]) == 2

    def test_no_args_prints_usage(self, capsys):
        assert fr_main([]) == 2


# ------------------------------------------------------ slow-cycle trace


class TestSlowCycleTrace:
    """tests/test_observability.py's: the slow-cycle diagnosis rides
    utils.tracing (the loop's per-pod and pod-group cycles export through
    it)."""

    def test_slow_cycle_logs_steps(self, caplog):
        from kubernetes_tpu_torch.utils.tracing import Span, threshold_log_exporter

        sp = Span(name="Scheduling", start=time.perf_counter(),
                  attributes={"pod": "default/slow"})
        sp.event("step one")
        time.sleep(0.12)
        sp.event("step two")
        sp.end = time.perf_counter()
        with caplog.at_level(logging.WARNING, logger="kubernetes_tpu_torch.trace"):
            assert threshold_log_exporter(0.1)(sp)
        assert "Scheduling" in caplog.text
        assert "step two" in caplog.text

    def test_fast_cycle_stays_silent(self, caplog):
        from kubernetes_tpu_torch.utils.tracing import Span, threshold_log_exporter

        sp = Span(name="Scheduling", start=time.perf_counter(),
                  attributes={"pod": "default/fast"})
        sp.event("quick")
        sp.end = time.perf_counter()
        with caplog.at_level(logging.WARNING, logger="kubernetes_tpu_torch.trace"):
            assert not threshold_log_exporter(0.1)(sp)
        assert caplog.text == ""


# ------------------------------------------- the recorder's own additions


def test_wave_phases_feed_totals_records_and_spans():
    exporter = InMemoryExporter()
    fr = WaveRecorder(tracer=Tracer("t", exporter))
    rec = fr.begin_wave(pods=4, pad=8)
    with fr.phase("kernel", rec):
        fr.wave_phases(rec, (("sync", 1.0, 1.25), ("wait", 2.0, 2.5)))
    fr.end_wave(rec)
    assert rec.phases["sync"] == 0.25 and rec.phases["wait"] == 0.5
    assert fr.wave_snapshot()["wait"] == 0.5
    (root,) = exporter.find("phase/kernel")
    assert [(c.name, c.duration_s) for c in root.children] == [
        ("wave_phase/sync", 0.25), ("wave_phase/wait", 0.5)]
    # the base class's stopwatches, which the benchmark reads, still tick
    assert fr.phase_snapshot()["kernel"] > 0.0
    assert set(fr.phase_snapshot()) >= {"snapshot", "kernel", "finish", "bind",
                                        "pump", "harness", "cycle", "waves"}


# ------------------------------------------------ port == reference goldens

NONTIMING = ("wave_id", "pods", "pad", "signatures", "clones",
             "distinct_signature_ratio", "dedup_tier", "occupancy",
             "carry_invalidations", "cache_exports", "xwave_hits",
             "xwave_misses", "xwave_evictions", "fallback_reason",
             "gang_groups", "gang_pods", "gang_fallback_pods", "gang_outcome",
             "injected_faults", "retries", "pipeline_overlap_ratio")


def telemetry_side(side):
    """The side with every telemetry part on: a SchedulerMetrics and a
    tracer with an exporter, each of its own package."""
    metrics, tracing = ((tmetrics, ttracing) if side.name == "port"
                        else (jmetrics, jtracing))
    return SimpleNamespace(**{**vars(side), "kw": {
        **side.kw, "metrics": metrics.SchedulerMetrics(),
        "tracer": tracing.Tracer("sched", tracing.InMemoryExporter(capacity=4096))}})


def telemetry(s):
    """(wave records' non-timing fields, each completed pod's ledger edge
    order, plugin observations per (plugin, extension point))."""
    fr = s.flight_recorder
    records = [{k: getattr(r, k) for k in NONTIMING} for r in fr.records()]
    ledger = [(e.key, list(e.stamps), e.wave_id) for e in fr.pod_ledger._completed]
    obs = {k: st.count for k, st in s.metrics.plugin_execution_duration.values.items()}
    return records, ledger, obs


def assert_same_telemetry(got_s, want_s):
    got, want = telemetry(got_s), telemetry(want_s)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0], "the workload must record waves"
    return got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("config", ["basic", "hard_pts", "ipa_churn_mesh8"])
def test_telemetry_matches_reference(config, mode, monkeypatch):
    kw = {**CONFIGS[config], **MODES[mode]}
    want = _run_stream(telemetry_side(SIDES["jax"]), monkeypatch, **kw)
    got = _run_stream(telemetry_side(SIDES["port"]), monkeypatch, **kw)
    assert got[:3] == want[:3]
    records, ledger, _ = assert_same_telemetry(got[3], want[3])
    assert len(ledger) == min(256, sum(1 for v in got[0].values() if v))
    if MODES[mode]["dedup"]:
        assert any(r["dedup_tier"] == "dedup" and r["clones"] for r in records)


def _gang_run(side, monkeypatch):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    w, t, m = side.w, side.types, side.meta
    store = side.Store()
    for i in range(8):
        store.create(w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % 2}"))
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=8)],
                       seed=5, feature_gates={"GenericWorkload": True,
                                              "TopologyAwareWorkloadScheduling": True},
                       **side.kw)
    s.start()
    for p in burst_pods(w, 0, 12):
        store.create(p)
    topo = t.SchedulingConstraints(topology=(t.TopologyConstraint(
        key="topology.kubernetes.io/zone", mode="Required"),))
    for g, (size, cpu) in enumerate(((3, "100m"), (4, "3"))):
        store.create(t.PodGroup(meta=m.ObjectMeta(name=f"g{g}"),
                                spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=size),
                                                    constraints=topo)))
        for i in range(size):
            store.create(w.with_gang(w.make_pod(f"g{g}m{i}", cpu=cpu, mem="64Mi"),
                                     f"g{g}"))
    for p in burst_pods(w, 12, 20):
        store.create(p)
    s.schedule_pending()
    return outcome(store, s), s


def test_gang_telemetry_matches_reference(monkeypatch):
    want, js = _gang_run(telemetry_side(SIDES["jax"]), monkeypatch)
    got, ts = _gang_run(telemetry_side(SIDES["port"]), monkeypatch)
    assert got == want
    records, _, _ = assert_same_telemetry(ts, js)
    gangs = [r for r in records if r["gang_groups"]]
    assert any(r["gang_outcome"].startswith("device:") for r in gangs)
    assert ts.flight_recorder.gang_pod_totals == js.flight_recorder.gang_pod_totals
    assert ts.flight_recorder.gang_pod_totals.get("device", 0) > 0


def _fault_run(side, monkeypatch, spec_cls, error, point, times, start_after=0):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    w = side.w
    store = side.Store()
    for i in range(4):
        store.create(w.make_node(f"n{i}", cpu="32", mem="64Gi", zone=f"z{i % 2}"))
    for p in burst_pods(w, 0, 40):
        store.create(p)
    reg = side.fi.registry()
    reg.reset(seed=0)
    reg.register(spec_cls(point, mode=error, transient=True,
                          start_after=start_after, times=times))
    reg.arm()
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=8)],
                       seed=3, **side.kw)
    s.start()
    s.schedule_pending()
    reg.disarm()
    return outcome(store, s), s


@pytest.mark.parametrize("point,times,start_after", [
    ("tpu.launch", 3, 2),   # two waves, then three launch flakes open the breaker
    ("tpu.collect", 3, 1),  # collect flakes trip it with a successor in flight
])
def test_fault_telemetry_matches_reference(point, times, start_after, monkeypatch):
    want, js = _fault_run(telemetry_side(SIDES["jax"]), monkeypatch, JFaultSpec,
                          JERROR, point, times, start_after)
    got, ts = _fault_run(telemetry_side(SIDES["port"]), monkeypatch, TFaultSpec,
                         TERROR, point, times, start_after)
    assert got == want
    assert all(got[0].values())
    records, _, _ = assert_same_telemetry(ts, js)
    fr = ts.flight_recorder
    assert [(o, n) for o, n, _ in fr.breaker_events] == \
        [(o, n) for o, n, _ in js.flight_recorder.breaker_events]
    # the waves that fell back to per-pod cycles are attributed by plugin
    fallback = {k for k in fr.phase_snapshot() if k.startswith("fallback/")}
    assert fallback == {k for k in js.flight_recorder.phase_snapshot()
                        if k.startswith("fallback/")}
    assert fallback, "per-pod fallback cycles must be attributed by plugin"
    if point == "tpu.collect":
        assert any(n == "open" for _, n, _ in fr.breaker_events)
        assert any((r["fallback_reason"] or "").startswith("injected:")
                   for r in records)


# ------------------------------------------------------------- on/off goldens

PARTS = ("ledger", "profiler", "device", "metrics", "tracer", "watchdog")


def _onoff_run(monkeypatch, on: frozenset, depth=2, dedup=True, launch_faults=0):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", str(depth))
    store = Store()
    for n in dedup_nodes(6, ttypes, tmeta):
        store.create(n)
    kw = {}
    if "metrics" in on:
        kw["metrics"] = SchedulerMetrics()
    if "tracer" in on:
        kw["tracer"] = Tracer("sched", InMemoryExporter(capacity=4096))
    reg = None
    if launch_faults:
        from kubernetes_tpu_torch.utils import faultinject

        reg = faultinject.registry()
        reg.reset(seed=0)
        # two waves launch, then the flakes open the breaker
        reg.register(TFaultSpec("tpu.launch", mode=TERROR, transient=True,
                                start_after=2, times=launch_faults))
        reg.arm()
    s = Scheduler(store, profiles=[Profile(wave_size=8)], seed=11, device="cpu", **kw)
    fr = s.flight_recorder
    fr.pod_ledger.enabled = "ledger" in on
    fr.stall_profiler.enabled = "profiler" in on
    fr.device_telemetry.enabled = "device" in on
    if "watchdog" in on:
        fr.slow_wave_deadline_s = 1e-4
        fr.profile_seconds = 0.01
    s.algorithms["default-scheduler"].backend.dedup_enabled = dedup
    s.start()
    pods = mixed_pods(36, ttypes, tmeta)
    for lo in (0, 12, 24):
        for p in pods[lo:lo + 12]:
            store.create(p)
        s.schedule_pending()
    if reg is not None:
        reg.disarm()
    return outcome(store, s), s


@pytest.mark.parametrize("launch_faults", [0, 3])
@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("depth", [1, 2])
def test_decisions_equal_with_each_part_on_and_off(depth, dedup, launch_faults,
                                                   monkeypatch):
    base, s_off = _onoff_run(monkeypatch, frozenset(), depth, dedup, launch_faults)
    every, s_on = _onoff_run(monkeypatch, frozenset(PARTS), depth, dedup, launch_faults)
    assert every == base
    assert sum(1 for v in base[0].values() if v) > 0
    assert base[1], "the workload must exercise failures too"
    for part in PARTS:
        only, _ = _onoff_run(monkeypatch, frozenset({part}), depth, dedup, launch_faults)
        assert only == base, part
    on = s_on.flight_recorder
    assert on.records() and on.pod_ledger.completed_total > 0
    assert on.device_telemetry.summary()["upload_bytes_total"] > 0
    assert s_off.flight_recorder.pod_ledger.completed_total == 0
    assert s_off.flight_recorder.device_telemetry.summary()["upload_bytes_total"] == 0
    if launch_faults:
        assert any(n == "open" for _, n, _ in on.breaker_events)
        assert any(k.startswith("fallback/") for k in on.phase_snapshot())
