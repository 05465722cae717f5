"""The port's pipeline stall profiler held to the reference's unit suite.

The reference's tests/test_stallprofiler.py cases on synthetic-clock
WaveRecord stand-ins (the coverage invariant, the attribution rules, the
critical-path analysis) run against kubernetes_tpu_torch's copy, and the
same synthetic waves go through both packages' profilers to equal
decompositions and summaries. TestCalibration and TestGateNormalization
test the benchmark's calibration and regression gate, which the port does
not have yet (ROADMAP A11b). Then the loop's stamps on the port's
Scheduler (device="cpu"): every recorded wave's wall clock is covered,
and a run with the profiler off binds identically.
"""

from __future__ import annotations

import pytest

from kubernetes_tpu.scheduler.tpu import stallprofiler as jstall
from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics
from kubernetes_tpu_torch.scheduler.tpu.stallprofiler import (
    COVERAGE_FLOOR,
    STALL_REASONS,
    STALL_SERIES,
    StallProfiler,
    _synthetic_record,
    critical_path,
    critical_path_of_row,
    critical_path_of_span,
)
from kubernetes_tpu_torch.api import meta as tmeta
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.store import Store
from kubernetes_tpu_torch.testing.mixed import dedup_nodes, dedup_pods


def _profiler(**kw) -> StallProfiler:
    p = StallProfiler(**kw)
    p.enabled = True  # independent of the ambient env
    return p


def _attributed(rec) -> float:
    return rec.overlap_s_attr + sum(rec.stall_by_reason.values())


def _finalize(prof, rec):
    prof.finalize(rec)
    # finalize caps overlap at prep; recompute the capped value the same
    # way for the invariant checks
    prep = sum(rec.phases.get(p, 0.0)
               for p in ("sync", "features", "upload", "dedup", "tie",
                         "dispatch"))
    rec.overlap_s_attr = min(rec.overlap_s, prep)
    return rec


class TestCoverageInvariant:
    @pytest.mark.parametrize("wall,phases,overlap,mark", [
        # healthy pipeline: prep hidden, device-bound
        (1.0, {"sync": 0.05, "features": 0.15, "dispatch": 0.1,
               "wait": 0.55, "finish": 0.05, "bind": 0.1}, 0.30, None),
        # serial regime: no overlap at all
        (1.0, {"sync": 0.2, "features": 0.3, "wait": 0.4, "bind": 0.1},
         0.0, None),
        # big unmarked gap
        (2.0, {"wait": 0.1}, 0.0, None),
        # big marked gap
        (2.0, {"wait": 0.1}, 0.0, "capacity_gate"),
        # zero-wall edge
        (0.0, {}, 0.0, None),
    ])
    def test_overlap_plus_stalls_covers_wall(self, wall, phases, overlap,
                                             mark):
        prof = _profiler()
        rec = _finalize(prof, _synthetic_record(
            1, wall=wall, phases=phases, overlap_s=overlap, mark=mark))
        total = _attributed(rec)
        assert wall * COVERAGE_FLOOR <= total <= wall * (2 - COVERAGE_FLOOR) \
            or wall == 0.0
        assert rec.stall_coverage >= COVERAGE_FLOOR
        assert set(rec.stall_by_reason) <= set(STALL_REASONS)

    def test_double_counting_shows_as_excess_coverage(self):
        """Coverage is honest both ways: an explicit interval that exceeds
        the wall clock pushes coverage ABOVE 1 rather than being clamped —
        the soak/golden two-sided assertions catch it."""
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={"wait": 0.5})
        prof.note_stall(rec, "bind_backpressure", 2.0)
        prof.finalize(rec)
        assert rec.stall_coverage > 1.05

    def test_zero_wall_coverage_is_one(self):
        prof = _profiler()
        rec = _finalize(prof, _synthetic_record(1, wall=0.0, phases={}))
        assert rec.stall_coverage == 1.0


class TestAttributionRules:
    def test_unmarked_residual_defaults_to_device_busy(self):
        prof = _profiler()
        rec = _finalize(prof, _synthetic_record(
            1, wall=1.0, phases={"sync": 0.1}, overlap_s=0.0))
        # 0.1 prep_serialized + 0.9 residual -> device_busy
        assert rec.stall_by_reason["device_busy"] == pytest.approx(0.9)
        assert rec.stall_dominant == "device_busy"

    def test_marked_residual_lands_on_mark(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={"sync": 0.1})
        prof.mark_gap(rec, "queue_empty")
        prof.finalize(rec)
        assert rec.stall_by_reason["queue_empty"] == pytest.approx(0.9)
        assert rec.stall_dominant == "queue_empty"

    def test_last_mark_wins(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={})
        prof.mark_gap(rec, "queue_empty")
        prof.mark_gap(rec, "flush")
        prof.finalize(rec)
        assert rec.stall_by_reason["flush"] == pytest.approx(1.0)
        # both seam events counted even though only one got the residual
        assert prof.stall_events["queue_empty"] == 1
        assert prof.stall_events["flush"] == 1

    def test_overlap_capped_at_prep(self):
        """overlap_s beyond measured prep can't mint negative
        prep_serialized or over-attribute."""
        prof = _profiler()
        rec = _finalize(prof, _synthetic_record(
            1, wall=1.0, phases={"sync": 0.2, "wait": 0.8}, overlap_s=5.0))
        assert "prep_serialized" not in rec.stall_by_reason
        assert rec.overlap_s_attr == pytest.approx(0.2)
        assert rec.stall_coverage == pytest.approx(1.0)

    def test_explicit_interval_folds_into_record(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={"wait": 0.4})
        prof.note_stall(rec, "bind_backpressure", 0.6)
        prof.finalize(rec)
        assert rec.stall_by_reason["bind_backpressure"] == pytest.approx(0.6)
        assert rec.stall_dominant == "bind_backpressure"

    def test_recordless_interval_lands_on_totals(self):
        prof = _profiler()
        prof.note_stall(None, "bind_backpressure", 0.25)
        assert prof.stall_totals["bind_backpressure"] == pytest.approx(0.25)
        assert prof.stall_events["bind_backpressure"] == 1
        assert prof.waves_profiled == 0

    def test_stall_contextmanager_times_block(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={})
        with prof.stall(rec, "bind_backpressure"):
            pass
        assert rec._stall_acc["bind_backpressure"] >= 0.0
        assert prof.stall_events["bind_backpressure"] == 1

    def test_undeclared_reason_rejected(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={})
        with pytest.raises(ValueError):
            prof.mark_gap(rec, "coffee_break")
        with pytest.raises(ValueError):
            prof.note_stall(rec, "coffee_break", 0.1)

    def test_finalize_idempotent(self):
        prof = _profiler()
        rec = _synthetic_record(1, wall=1.0, phases={"wait": 1.0})
        prof.finalize(rec)
        prof.finalize(rec)
        assert prof.waves_profiled == 1
        assert prof.wall_s_total == pytest.approx(1.0)

    def test_disabled_profiler_is_inert(self, monkeypatch):
        monkeypatch.setenv("KUBE_TPU_STALL_PROFILER", "0")
        prof = StallProfiler()
        assert not prof.enabled
        rec = _synthetic_record(1, wall=1.0, phases={"wait": 1.0})
        prof.mark_gap(rec, "flush")
        prof.note_stall(rec, "flush", 0.5)
        with prof.stall(rec, "flush"):
            pass
        prof.finalize(rec)
        assert prof.waves_profiled == 0
        assert rec.stall_by_reason == {}
        assert rec.stall_coverage == 0.0
        assert all(v == 0 for v in prof.stall_events.values())


class TestCriticalPath:
    def _rows(self):
        prof = _profiler()
        r1 = _synthetic_record(1, wall=1.0, phases={"wait": 0.9,
                                                    "sync": 0.1})
        r2 = _synthetic_record(2, wall=3.0, phases={"sync": 0.2},
                               mark="capacity_gate")
        r3 = _synthetic_record(3, wall=0.5, phases={}, mark="flush")
        for r in (r1, r2, r3):
            prof.finalize(r)
        return prof, [{
            "wave_id": r.wave_id, "duration_s": r.duration_s,
            "overlap_s": r.overlap_s, "stall_by_reason": r.stall_by_reason,
            "stall_dominant": r.stall_dominant,
        } for r in (r1, r2, r3)]

    def test_guilty_is_largest_summed_reason(self):
        _, rows = self._rows()
        cp = critical_path(rows)
        assert cp["guilty"] == "capacity_gate"
        assert cp["waves"] == 3
        assert cp["critical_wave"]["wave_id"] == 2
        assert cp["chain"][0]["edge"] == "capacity_gate"

    def test_empty_records(self):
        cp = critical_path([])
        assert cp == {"waves": 0, "guilty": None, "chain": []}
        assert critical_path([{"wave_id": 9}])["waves"] == 0

    def test_row_chain_ordered_by_seconds(self):
        path = critical_path_of_row({
            "wave_id": 7, "wall_s": 1.0, "overlap_s": 0.2,
            "stall_by_reason": {"flush": 0.1, "device_busy": 0.7},
            "dominant": "device_busy",
        })
        edges = [e["edge"] for e in path["chain"]]
        assert edges == ["overlap", "device_busy", "flush"]
        assert path["dominant"] == "device_busy"

    def test_span_chain_descends_longest_child(self):
        class N:
            def __init__(self, name, duration_s, children=()):
                self.name = name
                self.duration_s = duration_s
                self.children = list(children)

        root = N("wave/1", 1.0, [
            N("phase/kernel", 0.8, [N("wave_phase/wait", 0.7)]),
            N("phase/bind", 0.1),
        ])
        chain = critical_path_of_span(root)
        assert [e["edge"] for e in chain] == ["phase/kernel",
                                              "wave_phase/wait"]

    def test_snapshot_and_bench_columns_schema(self):
        prof, _ = self._rows()
        snap = prof.snapshot(last=2)
        assert snap["summary"]["waves_profiled"] == 3
        assert len(snap["last"]) == 2
        assert snap["critical_path"]["wave_id"] == 2
        cols = prof.bench_columns()
        assert cols["stall_dominant"] == "capacity_gate"
        for reason in STALL_REASONS:
            assert f"stall_{reason}_s" in cols
        assert cols["stall_total_s"] > 0

    def test_metrics_emission_uses_declared_series(self):
        metrics = SchedulerMetrics()
        prof = _profiler(metrics=metrics)
        rec = _synthetic_record(1, wall=1.0, phases={"wait": 1.0})
        prof.finalize(rec)
        hist = metrics.registry.get(STALL_SERIES[0])
        gauge = metrics.registry.get(STALL_SERIES[1])
        assert hist.count("device_busy") == 1
        assert gauge.get("device_busy") == pytest.approx(1.0)


# --------------------------------------------------------------------------
# port == reference on the same synthetic waves
# --------------------------------------------------------------------------

WAVES = (
    (1, 1.0, {"sync": 0.05, "features": 0.15, "dispatch": 0.1, "wait": 0.55,
              "finish": 0.05, "bind": 0.1}, 0.30, None, ()),
    (2, 2.0, {"sync": 0.02, "features": 0.08, "wait": 0.1, "finish": 0.05,
              "bind": 0.05}, 0.0, "capacity_gate", ()),
    (3, 0.5, {"wait": 0.05}, 0.0, "flush", ()),
    (4, 1.5, {"upload": 0.3, "tie": 0.01}, 0.0, None,
     (("bind_backpressure", 0.25),)),
    (5, 0.75, {"dedup": 0.2, "wait": 0.1}, 0.1, "queue_empty", ()),
)


def _drive(mod):
    prof = mod.StallProfiler()
    prof.enabled = True
    rows = []
    for wid, wall, phases, overlap, mark, stalls in WAVES:
        rec = mod._synthetic_record(wid, wall=wall, phases=phases,
                                    overlap_s=overlap)
        if mark:
            prof.mark_gap(rec, mark)
        for reason, seconds in stalls:
            prof.note_stall(rec, reason, seconds)
        prof.note_handoff(rec, chained=bool(overlap))
        prof.finalize(rec)
        rows.append({"wave_id": rec.wave_id, "duration_s": rec.duration_s,
                     "overlap_s": rec.overlap_s,
                     "stall_by_reason": rec.stall_by_reason,
                     "stall_coverage": rec.stall_coverage,
                     "stall_dominant": rec.stall_dominant})
    prof.note_stall(None, "bind_backpressure", 0.125)
    return rows, prof.summary(), prof.snapshot(last=3), prof.bench_columns(), \
        mod.critical_path(rows)


def test_decomposition_equals_the_reference():
    assert jstall.STALL_REASONS == STALL_REASONS
    assert jstall.STALL_SERIES == STALL_SERIES
    assert jstall._PREP_PHASES == ("sync", "features", "upload", "dedup", "tie",
                                   "dispatch")
    from kubernetes_tpu_torch.scheduler.tpu import stallprofiler as tstall

    assert tstall._PREP_PHASES == jstall._PREP_PHASES
    assert tstall._DEVICE_PHASES == jstall._DEVICE_PHASES
    assert _drive(tstall) == _drive(jstall)


def test_smoke_cli():
    from kubernetes_tpu_torch.scheduler.tpu.stallprofiler import main

    assert main(["--smoke"]) == 0


# --------------------------------------------------------------------------
# the loop's stamps, on the port's Scheduler
# --------------------------------------------------------------------------


def _run(profiler_on: bool, depth: int, monkeypatch, pods=30, wave_size=8):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", str(depth))
    store = Store()
    for n in dedup_nodes(6, ttypes, tmeta):
        store.create(n)
    s = Scheduler(store, profiles=[Profile(wave_size=wave_size)], seed=11,
                  metrics=SchedulerMetrics(), device="cpu")
    s.flight_recorder.stall_profiler.enabled = profiler_on
    s.start()
    for i in range(3):
        for p in dedup_pods(pods, ttypes, tmeta)[i * pods // 3:(i + 1) * pods // 3]:
            store.create(p)
        s.schedule_pending()
    s.event_recorder.flush()
    placed = {p.meta.name: p.spec.node_name for p in store.pods()}
    return placed, s.algorithms["default-scheduler"].rng.getstate(), s


@pytest.mark.parametrize("depth", [1, 2])
def test_loop_stamps_cover_every_wave_and_change_nothing(depth, monkeypatch):
    on = _run(True, depth, monkeypatch)
    off = _run(False, depth, monkeypatch)
    assert on[0] == off[0] and on[1] == off[1]
    assert sum(1 for v in on[0].values() if v) > 0
    fr = on[2].flight_recorder
    recs = fr.records()
    assert recs
    for r in recs:
        total = min(r.overlap_s, sum(r.phases.get(p, 0.0) for p in (
            "sync", "features", "upload", "dedup", "tie", "dispatch")))
        total += sum(r.stall_by_reason.values())
        assert r.duration_s * COVERAGE_FLOOR <= total <= \
            r.duration_s * (2 - COVERAGE_FLOOR)
        assert set(r.stall_by_reason) <= set(STALL_REASONS)
    summary = fr.stall_profiler.summary()
    assert summary["waves_profiled"] == len(recs)
    # depth 2 chains every launch after the first of a burst; depth 1 never
    chained = summary["handoffs"]["chained"]
    assert (chained > 0) == (depth == 2)
    off_prof = off[2].flight_recorder.stall_profiler
    assert off_prof.waves_profiled == 0 and not any(off_prof.stall_events.values())
