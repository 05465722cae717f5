"""Pipeline stall profiler: critical-path attribution for streaming waves.

`pipeline_overlap_ratio` says WHETHER the double-buffer engaged; this
profiler says WHY NOT. Every completed wave's wall clock is decomposed
into **overlap** (host prep hidden under an in-flight predecessor — the
good time the pipeline exists to create) plus a closed set of named
**stall reasons**, with the invariant

    overlap_s + sum(stall_by_reason.values()) ~= wave wall clock

(coverage >= 95%, asserted by the unit suite and the chaos trace soaks).
The decomposition is derived from the wave's own phase stopwatches plus
gap marks stamped at the loop/backend seams, so it costs no extra clock
reads on the hot path:

- ``prep_serialized``   launch-side host prep that ran with the device
  idle (prep seconds not covered by `WaveRecord.overlap_s`) — the
  pipeline_depth<=1 / cold-start regime.
- ``device_busy``       the host blocked on device results (the backend's
  `wait` phase), plus any unmarked open-record gap: after launch returns
  the device owns the wave until collect, so un-stamped time defaults
  here rather than silently vanishing.
- ``bind_backpressure`` the bind-side host segment: per-pod finish
  cycles, PreBind, the batched bind dispatch, and dispatcher in-flight
  waits — time spent pushing results out instead of prepping a successor.
- ``queue_empty``       the record sat open because the queue had no pods
  to prep a successor from (marked by `schedule_wave`'s empty-pop flush).
- ``capacity_gate``     the wave-size controller's target was clipped by
  the per-call cap — the ticked trace regime's one-wave-per-tick gate,
  the dominant reason behind the burst-trace overlap collapse.
- ``flush``             forced pipeline drains: breaker OPEN, poisoned
  carry, incompatible in-flight wave, trailer ordering, shutdown.

Like the pod ledger and device telemetry, the profiler is owned by the
wave recorder (waverecorder.py) and is HOST-SIDE ONLY: stamps are plain float
arithmetic behind the recorder's already-paid phase clocks, no rng is
consumed, and no scheduling decision reads profiler state — the
bit-compat goldens hold with the profiler armed or disarmed.

Every stall stamp at a seam names a literal from STALL_REASONS below, and
the stall fields on WaveRecord (`stall_by_reason` & co.) are written only
in this module — seams report through `mark_gap`/`note_stall`, never by
poking record state. Every metric series this module emits is declared in
STALL_SERIES and registered in scheduler/metrics.py.

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/stallprofiler.py). The port's backend
names its timers after the reference's wave phases: launch_batched
records sync, features, upload (the carry overlay or device_inputs with
K3, and kernel_config), dedup, tie and dispatch (the staged copy, the K1
+ K2 enqueue and the result copy enqueued) — the prep phases below — and
collect records wait, the host's wait on the wave's result event, the
device phase.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from contextlib import contextmanager

from .podlatency import StreamingQuantile

# The closed set of stall reasons; every mark_gap/note_stall call site
# names a literal member. Adding a reason is an API change: update the
# consumers (the recorder's dump, chip_smoke) together.
STALL_REASONS = (
    "queue_empty",
    "capacity_gate",
    "prep_serialized",
    "device_busy",
    "flush",
    "bind_backpressure",
)

# Series this profiler emits; registered in scheduler/metrics.py.
STALL_SERIES = (
    "scheduler_tpu_pipeline_stall_seconds",
    "scheduler_tpu_pipeline_stall_total_seconds",
)

# launch-side host-prep phases (mirrors waverecorder.PREP_PHASES; kept
# literal here so the profiler never imports its owner)
_PREP_PHASES = ("sync", "features", "upload", "dedup", "tie", "dispatch")
_DEVICE_PHASES = ("wait",)
_BIND_PHASES = ("finish", "bind")

DEFAULT_CAPACITY = 256  # per-wave attribution rows retained for the zpage
DEFAULT_WINDOW = 4096   # coverage/stall quantile sample window
_RESIDUAL_FLOOR_S = 1e-9

# the coverage invariant the tests/soaks assert: attributed time must
# cover at least this share of every wave's wall clock (and not exceed
# it by more than the same slack — double counting is as much a bug as
# a gap)
COVERAGE_FLOOR = 0.95


class StallProfiler:
    """Per-wave wall-clock decomposition into overlap + named stalls.

    Owned by the WaveRecorder (one per scheduler). Seams stamp through
    `mark_gap` (attribute the record's open-but-untimed gap) and
    `note_stall`/`stall` (explicit timed intervals); `finalize` runs once
    per wave from WaveRecorder.end_wave and writes the record's
    `stall_by_reason`/`stall_coverage`/`stall_dominant` — the ONLY place
    stall state lands on a record. `enabled` exists for the
    bit-compat golden's off arm; production keeps it armed
    (KUBE_TPU_STALL_PROFILER=0 disarms).
    """

    def __init__(self, metrics=None, capacity: int = DEFAULT_CAPACITY,
                 window: int = DEFAULT_WINDOW):
        self.enabled = os.environ.get("KUBE_TPU_STALL_PROFILER", "1") != "0"
        self.metrics = metrics
        self.capacity = capacity
        self._lock = threading.Lock()
        # cumulative seconds per reason (finalized waves + record-less
        # explicit stamps such as the per-pod bind wait)
        self.stall_totals: dict[str, float] = {r: 0.0 for r in STALL_REASONS}
        # how many times each reason was stamped/marked at a seam — the
        # chaos soaks' "flush appears exactly when the breaker trips" hook
        self.stall_events: dict[str, int] = {r: 0 for r in STALL_REASONS}
        self.waves_profiled = 0
        self.wall_s_total = 0.0
        self.overlap_s_total = 0.0
        # TorchBackend double-buffer handoffs: how many launches swapped in
        # over a live predecessor (chained) vs into an idle device
        self.handoffs_total = 0
        self.handoffs_chained = 0
        self.coverage_min: float | None = None
        self._coverage = StreamingQuantile(window)
        self._rows: collections.deque[dict] = collections.deque(
            maxlen=capacity
        )

    # -- emission (every name literal, declared in STALL_SERIES) -------------

    def _series(self, name: str):
        m = self.metrics
        registry = getattr(m, "registry", None) if m is not None else None
        return registry.get(name) if registry is not None else None

    # -- seam stamps ---------------------------------------------------------

    def mark_gap(self, record, reason: str) -> None:
        """Attribute `record`'s open-but-untimed gap to `reason` (last
        mark wins; `finalize` assigns the residual). `record` may be None
        — flush seams with nothing in flight still count the event."""
        if not self.enabled:
            return
        if reason not in STALL_REASONS:
            raise ValueError(f"undeclared stall reason {reason!r}")
        with self._lock:
            self.stall_events[reason] += 1
        if record is not None:
            record._stall_mark = reason

    def note_handoff(self, record, chained: bool) -> None:
        """TorchBackend buffer handoff: a launch swapped into the double
        buffer over a live predecessor (`chained`) or into an idle device
        — the per-wave pipeline-engagement bit behind overlap_s."""
        if not self.enabled:
            return
        with self._lock:
            self.handoffs_total += 1
            if chained:
                self.handoffs_chained += 1

    def note_stall(self, record, reason: str, seconds: float) -> None:
        """Record an explicitly timed stall interval. With a record, it
        folds into that wave's decomposition at finalize; without one
        (per-pod paths) it lands straight on the cumulative totals."""
        if not self.enabled or seconds < 0.0:
            return
        if reason not in STALL_REASONS:
            raise ValueError(f"undeclared stall reason {reason!r}")
        with self._lock:
            self.stall_events[reason] += 1
            if record is None:
                self.stall_totals[reason] += seconds
                self._land_histogram(reason, seconds)
                return
        acc = record._stall_acc
        acc[reason] = acc.get(reason, 0.0) + seconds

    @contextmanager
    def stall(self, record, reason: str):
        """Time a block as an explicit stall interval (note_stall)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_stall(record, reason, time.perf_counter() - t0)

    # -- finalization (the one writer of record stall state) -----------------

    def finalize(self, record) -> None:
        """Decompose `record.duration_s` into overlap + stalls; called
        once per wave from WaveRecorder.end_wave, after duration_s and
        phases are final. Idempotence guard: a record finalizes once."""
        if not self.enabled or getattr(record, "_stall_done", False):
            return
        record._stall_done = True
        wall = record.duration_s
        phases = record.phases
        prep = sum(phases.get(p, 0.0) for p in _PREP_PHASES)
        overlap = min(record.overlap_s, prep)
        stalls = {r: 0.0 for r in STALL_REASONS}
        for reason, seconds in record._stall_acc.items():
            stalls[reason] += seconds
        stalls["prep_serialized"] += max(prep - overlap, 0.0)
        stalls["device_busy"] += sum(
            phases.get(p, 0.0) for p in _DEVICE_PHASES
        )
        stalls["bind_backpressure"] += sum(
            phases.get(p, 0.0) for p in _BIND_PHASES
        )
        attributed = overlap + sum(stalls.values())
        residual = wall - attributed
        if residual > _RESIDUAL_FLOOR_S:
            # the record sat open with nothing stamping a phase: a seam
            # mark names the cause; unmarked gaps default to device_busy
            # (post-launch, the device owns the wave until collect)
            stalls[record._stall_mark or "device_busy"] += residual
            attributed = wall
        stalls = {r: s for r, s in stalls.items() if s > 0.0}
        coverage = (attributed / wall) if wall > 0.0 else 1.0
        dominant = max(stalls, key=stalls.get) if stalls else None
        record.stall_by_reason = {r: round(s, 9) for r, s in stalls.items()}
        record.stall_coverage = round(coverage, 6)
        record.stall_dominant = dominant
        with self._lock:
            self.waves_profiled += 1
            self.wall_s_total += wall
            self.overlap_s_total += overlap
            for reason, seconds in stalls.items():
                self.stall_totals[reason] += seconds
            self._coverage.add(coverage)
            if self.coverage_min is None or coverage < self.coverage_min:
                self.coverage_min = coverage
            self._rows.append({
                "wave_id": record.wave_id,
                "wall_s": round(wall, 9),
                "overlap_s": round(overlap, 9),
                "stall_by_reason": dict(record.stall_by_reason),
                "coverage": record.stall_coverage,
                "dominant": dominant,
            })
        for reason, seconds in stalls.items():
            self._land_histogram(reason, seconds)
        self._update_total_gauge()

    def _land_histogram(self, reason: str, seconds: float) -> None:
        hist = self._series("scheduler_tpu_pipeline_stall_seconds")
        if hist is not None:
            hist.observe(seconds, reason)

    def _update_total_gauge(self) -> None:
        gauge = self._series("scheduler_tpu_pipeline_stall_total_seconds")
        if gauge is None:
            return
        with self._lock:
            totals = dict(self.stall_totals)
        for reason, seconds in totals.items():
            gauge.set(seconds, reason)

    # -- queries / snapshots -------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            totals = {r: round(s, 6) for r, s in self.stall_totals.items()
                      if s > 0.0}
            stalled = sum(self.stall_totals.values())
            dominant = (max(self.stall_totals, key=self.stall_totals.get)
                        if stalled > 0.0 else None)
            cov_p50 = self._coverage.quantile(0.50)
            return {
                "waves_profiled": self.waves_profiled,
                "wall_s": round(self.wall_s_total, 6),
                "overlap_s": round(self.overlap_s_total, 6),
                "stall_s": totals,
                "dominant": dominant,
                "dominant_share": (
                    round(self.stall_totals[dominant] / self.wall_s_total, 4)
                    if dominant is not None and self.wall_s_total > 0.0
                    else None
                ),
                "coverage_p50": (round(cov_p50, 4)
                                 if cov_p50 is not None else None),
                "coverage_min": (round(self.coverage_min, 4)
                                 if self.coverage_min is not None else None),
                "handoffs": {"total": self.handoffs_total,
                             "chained": self.handoffs_chained},
                "events": {r: n for r, n in self.stall_events.items() if n},
            }

    def snapshot(self, last: int | None = None) -> dict:
        """The /debug/stalls zpage payload: cumulative summary, the last N
        per-wave attribution rows, and the critical path of the slowest
        retained wave."""
        with self._lock:
            rows = list(self._rows)
        out = {"summary": self.summary()}
        if last:
            out["last"] = rows[-last:]
        if rows:
            worst = max(rows, key=lambda r: r["wall_s"])
            out["critical_path"] = critical_path_of_row(worst)
        return out

    def bench_columns(self) -> dict:
        """Flat stall_* columns for bench/trace_bench/bench_suite rows.
        Wall-clock derived — NEVER add these to DETERMINISTIC_KEYS."""
        s = self.summary()
        cols = {
            "stall_dominant": s["dominant"],
            "stall_coverage_p50": s["coverage_p50"],
            "stall_total_s": round(sum(self.stall_totals.values()), 6),
        }
        for reason in STALL_REASONS:
            cols[f"stall_{reason}_s"] = round(
                self.stall_totals.get(reason, 0.0), 6
            )
        return cols


# -- critical-path analysis ----------------------------------------------------


def critical_path_of_row(row: dict) -> dict:
    """Edge chain for one per-wave attribution row: overlap plus each
    stall reason as an ordered edge, dominant edge flagged."""
    chain = []
    if row.get("overlap_s"):
        chain.append({"edge": "overlap", "seconds": row["overlap_s"]})
    for reason, seconds in sorted(row.get("stall_by_reason", {}).items(),
                                  key=lambda kv: -kv[1]):
        chain.append({"edge": reason, "seconds": seconds})
    return {
        "wave_id": row.get("wave_id"),
        "wall_s": row.get("wall_s"),
        "dominant": row.get("dominant"),
        "chain": chain,
    }


def critical_path(records: list[dict]) -> dict:
    """Critical-path analysis over to_dict()-shaped wave records (the
    flight recorder dump / ring buffer): per burst, the guilty stall kind
    (largest summed reason) and the dominant edge chain of the single
    slowest wave. Pure function — usable on post-mortem dumps."""
    waves = [r for r in records if r.get("stall_by_reason")]
    if not waves:
        return {"waves": 0, "guilty": None, "chain": []}
    totals: dict[str, float] = {}
    wall = 0.0
    overlap = 0.0
    for r in waves:
        wall += r.get("duration_s", 0.0)
        overlap += r.get("overlap_s", 0.0)
        for reason, seconds in r["stall_by_reason"].items():
            totals[reason] = totals.get(reason, 0.0) + seconds
    guilty = max(totals, key=totals.get) if totals else None
    worst = max(waves, key=lambda r: r.get("duration_s", 0.0))
    worst_path = critical_path_of_row({
        "wave_id": worst.get("wave_id"),
        "wall_s": worst.get("duration_s"),
        "overlap_s": worst.get("overlap_s", 0.0),
        "stall_by_reason": worst["stall_by_reason"],
        "dominant": worst.get("stall_dominant"),
    })
    return {
        "waves": len(waves),
        "wall_s": round(wall, 6),
        "overlap_s": round(overlap, 6),
        "stall_s": {r: round(s, 6) for r, s in sorted(
            totals.items(), key=lambda kv: -kv[1])},
        "guilty": guilty,
        "guilty_share": (round(totals[guilty] / wall, 4)
                         if guilty is not None and wall > 0.0 else None),
        "critical_wave": worst_path,
        "chain": worst_path["chain"],
    }


def critical_path_of_span(root) -> list[dict]:
    """Dominant edge chain through one `wave/<id>` root of the recorder's
    span tree (utils.tracing.Span): at every level, descend into the
    longest child. Works on live Span objects from an InMemoryExporter."""
    chain: list[dict] = []
    node = root
    while getattr(node, "children", None):
        node = max(node.children, key=lambda c: c.duration_s)
        chain.append({
            "edge": node.name,
            "seconds": round(node.duration_s, 9),
        })
    return chain


# -- CLI: smoke / demo ---------------------------------------------------------


def _synthetic_record(wave_id: int, wall: float, phases: dict,
                      overlap_s: float = 0.0, mark: str | None = None):
    """A WaveRecord-shaped stand-in driven by a synthetic clock — the
    smoke and the unit suite decompose known wall clocks, no sleeping."""

    class _Rec:
        pass

    rec = _Rec()
    rec.wave_id = wave_id
    rec.duration_s = wall
    rec.phases = dict(phases)
    rec.overlap_s = overlap_s
    rec._stall_acc = {}
    rec._stall_mark = mark
    rec.stall_by_reason = {}
    rec.stall_coverage = 0.0
    rec.stall_dominant = None
    return rec


def _smoke(demo: bool = False) -> int:
    """Deterministic critical-path smoke: feed
    synthetic waves through the full decompose -> analyze path and assert
    the coverage invariant and dominant-edge selection."""
    prof = StallProfiler()
    prof.enabled = True
    # wave 1: healthy pipeline — prep fully hidden, device-bound
    r1 = _synthetic_record(
        1, wall=1.0,
        phases={"sync": 0.05, "features": 0.15, "dispatch": 0.10,
                "wait": 0.55, "finish": 0.05, "bind": 0.10},
        overlap_s=0.30,
    )
    # wave 2: the burst-trace collapse — cap-gated gap dominates
    r2 = _synthetic_record(
        2, wall=2.0,
        phases={"sync": 0.02, "features": 0.08, "wait": 0.10,
                "finish": 0.05, "bind": 0.05},
        overlap_s=0.0, mark="capacity_gate",
    )
    prof.mark_gap(r2, "capacity_gate")
    # wave 3: breaker drain
    r3 = _synthetic_record(
        3, wall=0.5, phases={"wait": 0.05}, overlap_s=0.0, mark=None,
    )
    prof.mark_gap(r3, "flush")
    for rec in (r1, r2, r3):
        prof.finalize(rec)
        total = rec.overlap_s + sum(rec.stall_by_reason.values())
        assert rec.duration_s * COVERAGE_FLOOR <= total <= \
            rec.duration_s * (2.0 - COVERAGE_FLOOR), (
                f"wave {rec.wave_id}: attribution {total} vs wall "
                f"{rec.duration_s}"
            )
        assert rec.stall_coverage >= COVERAGE_FLOOR
    assert r1.stall_dominant == "device_busy", r1.stall_dominant
    assert r2.stall_dominant == "capacity_gate", r2.stall_dominant
    assert r3.stall_dominant == "flush", r3.stall_dominant
    rows = [{
        "wave_id": r.wave_id, "duration_s": r.duration_s,
        "overlap_s": r.overlap_s, "stall_by_reason": r.stall_by_reason,
        "stall_dominant": r.stall_dominant,
    } for r in (r1, r2, r3)]
    cp = critical_path(rows)
    assert cp["guilty"] == "capacity_gate", cp
    assert cp["critical_wave"]["wave_id"] == 2, cp
    assert cp["chain"] and cp["chain"][0]["edge"] == "capacity_gate", cp
    # span-tree flavor: the dominant edge chain must descend into the
    # longest child at every level
    from ...utils.tracing import InMemoryExporter, Tracer

    exporter = InMemoryExporter()
    tracer = Tracer("stall-smoke", exporter=exporter)
    with tracer.span("wave/9"):
        with tracer.span("phase/kernel"):
            with tracer.span("wave_phase/wait"):
                time.sleep(0.002)
        with tracer.span("phase/bind"):
            pass
    chain = critical_path_of_span(exporter.find("wave/")[0])
    assert [e["edge"] for e in chain] == ["phase/kernel", "wave_phase/wait"], \
        chain
    summary = prof.summary()
    assert summary["dominant"] == "capacity_gate", summary
    assert summary["coverage_min"] >= COVERAGE_FLOOR, summary
    if demo:
        print(json.dumps({
            "summary": summary,
            "critical_path": cp,
            "snapshot": prof.snapshot(last=3),
        }, indent=2))
    else:
        print("stall profiler smoke OK: "
              f"guilty={cp['guilty']} share={cp['guilty_share']} "
              f"coverage_min={summary['coverage_min']}")
    return 0


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.scheduler.tpu.stallprofiler",
        description="Streaming-wave stall attribution / critical path",
    )
    parser.add_argument("dump", nargs="?",
                        help="flight-recorder JSON dump to analyze "
                             "('-' reads stdin)")
    parser.add_argument("--smoke", action="store_true",
                        help="run the deterministic critical-path smoke")
    parser.add_argument("--demo", action="store_true",
                        help="print the smoke profiler's summary JSON")
    parser.add_argument("--last", type=int, default=None,
                        help="limit record analysis to the last N waves")
    args = parser.parse_args(argv)

    if args.smoke:
        return _smoke()
    if args.demo:
        return _smoke(demo=True)
    if args.dump:
        import sys

        raw = (sys.stdin.read() if args.dump == "-"
               else open(args.dump).read())
        payload = json.loads(raw)
        records = payload.get("records", [])
        if args.last:
            records = records[-args.last:]
        print(json.dumps(critical_path(records), indent=2))
        return 0
    parser.print_usage()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
