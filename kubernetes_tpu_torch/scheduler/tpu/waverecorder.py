"""The wave recorder: per-wave flight records, the pod latency ledger, the
stall profiler, device telemetry, fallback attribution, spans and the
slow-wave watchdog, over the loop's phase stopwatches.

The counterpart of the reference package's flight recorder
(kubernetes_tpu/scheduler/tpu/flightrecorder.py:63-725). It is a module
of its own because `scheduler/tpu/flightrecorder.py` is one of the
benchmark's files (BENCHMARK.json `paths`): the bench imports its
`LOOP_PHASES`, times `phase("harness")` and diffs `phase_snapshot()`.
`WaveRecorder` subclasses that `FlightRecorder`, so the stopwatches the
benchmark reads stay its code; `phase(name, record=None, **attrs)` opens
the `phase/<name>` span and adds the time to `record` around
`super().phase(name)`.

Every batched wave is self-describing: the loop and backend time their
phases through this recorder (each stopwatch doubles as a span on the
shared `utils.tracing.Tracer`), and each wave leaves a structured
`WaveRecord` in a bounded ring buffer — pod/clone counts, dedup tier,
pad/occupancy, carry invalidations, fallback reason, per-phase durations,
transfer bytes, stall attribution — queryable after the fact via `python
-m kubernetes_tpu_torch.scheduler.tpu.waverecorder` or the SIGUSR1 dump
hook. A slow-wave watchdog (off unless KUBE_TPU_SLOW_WAVE_S is set) arms
a timer per open wave and attaches a `utils.pprof.take_profile` sample of
every thread to a wave still open past its deadline.

Restart and fleet records, as in the reference: `restart_recovery` keeps
each outcome of `Scheduler.reconcile`/`adopt_shard` in `restart_events`,
`shard_ownership` and `shard_failover` the fleet member's lease
transitions in `fleet_events`; each lands on its SchedulerMetrics series.

All recording is HOST-SIDE ONLY: phases close after device results are
collected, nothing here runs inside a kernel, and no decision reads it,
so the seeded tie-break stream and every binding are identical with the
recorder's parts on or off. With no tracer exporter the span side costs
one attribute lookup per phase; the ring buffer append is a dict build
and a deque append per wave, not per pod.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from ...utils import faultinject
from ...utils.envknob import float_env, int_env
from ...utils.tracing import Tracer
from .devicetelemetry import DeviceTelemetry
from .flightrecorder import FlightRecorder
from .podlatency import PodLatencyLedger
from .stallprofiler import StallProfiler

# backend wave-path phases (the reference's wave_profile): the port's
# launch_batched times sync, features, upload, dedup, tie and dispatch,
# collect times wait, run_gang sync, features, masks, upload, kernel, wait
WAVE_PHASES = ("sync", "features", "tie", "dispatch", "upload", "wait",
               "dedup")
# launch-side host-prep phases: with the pipeline on, these run while the
# PREDECESSOR wave executes on device — the overlap the streaming-waves
# pipeline exists to create (pipeline_overlap_ratio = hidden prep / prep)
PREP_PHASES = ("sync", "features", "upload", "dedup", "tie", "dispatch")

# watchdog defaults (the reference's knobs)
DEFAULT_CAPACITY = int_env("KUBE_TPU_FLIGHT_CAPACITY", 256)
# None/0 = watchdog off (the default: host-fallback waves legitimately run
# long, and profile capture is not free)
DEFAULT_SLOW_WAVE_S = float_env("KUBE_TPU_SLOW_WAVE_S", None)
DEFAULT_PROFILE_S = float_env("KUBE_TPU_SLOW_WAVE_PROFILE_S", 0.25)


@dataclass
class WaveRecord:
    """One batched wave's (or gang wave's) flight record: the reference's
    WaveRecord, field for field."""

    wave_id: int
    started_at: float  # wall clock, for post-mortem correlation
    pods: int = 0
    pad: int = 0  # padded program slots (pow2 bucket)
    signatures: int = 0  # distinct feature signatures (0 = dedup off)
    clones: int = 0  # pods that rode the cheap carry-replay tier
    distinct_signature_ratio: float | None = None
    dedup_tier: str = "off"  # "dedup" | "off"
    occupancy: float = 0.0  # pods / pad
    carry_invalidations: int = 0  # invalidations during this wave's flight
    cache_exports: int = 0  # signature hints exported to the BatchCache
    # cross-wave signature reuse (device-resident score cache): signatures
    # of this wave replayed from / missing in / evicted from the previous
    # chained wave's resident table
    xwave_hits: int = 0
    xwave_misses: int = 0
    xwave_evictions: int = 0
    fallback_reason: str | None = None  # resync/fallback diagnosis, if any
    # gang waves: PodGroups admitted to this wave,
    # their member counts, members that fell back to the host gang cycle,
    # and the per-group outcome ("device:<domain>" | "fallback:<reason>")
    gang_groups: int = 0
    gang_pods: int = 0
    gang_fallback_pods: int = 0
    gang_outcome: str | None = None
    injected_faults: int = 0  # faults fired during this wave's flight
    retries: int = 0  # dispatcher retry attempts during this wave's flight
    # host prep seconds that ran while a predecessor wave was in flight on
    # device (the pipelined overlap), and the per-wave ratio of prep hidden
    overlap_s: float = 0.0
    pipeline_overlap_ratio: float = 0.0
    # device transfer ledger (devicetelemetry.py): bytes this wave moved
    # across the host<->device boundary, attributed per TRANSFER_PLANES name
    upload_bytes: int = 0
    fetch_bytes: int = 0
    upload_by_plane: dict = field(default_factory=dict)
    fetch_by_plane: dict = field(default_factory=dict)
    # per-wave high-water mark of device-resident plane-buffer bytes
    mem_watermark_bytes: int = 0
    phases: dict = field(default_factory=dict)  # phase -> seconds
    duration_s: float = 0.0
    # stall attribution (stallprofiler.py — the only writer of these
    # fields): wall-clock decomposition
    # into named stall reasons, its coverage of duration_s, and the
    # largest contributor
    stall_by_reason: dict = field(default_factory=dict)
    stall_coverage: float = 0.0
    stall_dominant: str | None = None
    profile: str | None = None  # watchdog pprof capture, when triggered
    # internal bookkeeping (not serialized)
    _t0: float = 0.0
    _inv_base: int = 0
    _fault_base: int = 0
    _retry_base: int = 0
    # stall-profiler scratch (written only in stallprofiler.py)
    _stall_acc: dict = field(default_factory=dict)
    _stall_mark: str | None = None
    _stall_done: bool = False

    def to_dict(self) -> dict:
        d = {
            "wave_id": self.wave_id,
            "started_at": self.started_at,
            "duration_s": round(self.duration_s, 6),
            "pods": self.pods,
            "pad": self.pad,
            "occupancy": round(self.occupancy, 4),
            "signatures": self.signatures,
            "clones": self.clones,
            "distinct_signature_ratio": self.distinct_signature_ratio,
            "dedup_tier": self.dedup_tier,
            "carry_invalidations": self.carry_invalidations,
            "cache_exports": self.cache_exports,
            "xwave_hits": self.xwave_hits,
            "xwave_misses": self.xwave_misses,
            "xwave_evictions": self.xwave_evictions,
            "fallback_reason": self.fallback_reason,
            "gang_groups": self.gang_groups,
            "gang_pods": self.gang_pods,
            "gang_fallback_pods": self.gang_fallback_pods,
            "gang_outcome": self.gang_outcome,
            "injected_faults": self.injected_faults,
            "retries": self.retries,
            "overlap_s": round(self.overlap_s, 6),
            "pipeline_overlap_ratio": round(self.pipeline_overlap_ratio, 4),
            "upload_bytes": self.upload_bytes,
            "fetch_bytes": self.fetch_bytes,
            "upload_by_plane": dict(self.upload_by_plane),
            "fetch_by_plane": dict(self.fetch_by_plane),
            "mem_watermark_bytes": self.mem_watermark_bytes,
            "phases": {k: round(v, 6) for k, v in self.phases.items()},
            "stall_by_reason": {k: round(v, 6)
                                for k, v in self.stall_by_reason.items()},
            "stall_coverage": round(self.stall_coverage, 4),
            "stall_dominant": self.stall_dominant,
        }
        if self.profile is not None:
            d["profile"] = self.profile
        return d


class WaveRecorder(FlightRecorder):
    """The benchmark's phase stopwatches + per-wave ring buffer + watchdog.

    One instance is shared by the ScheduleOneLoop and every TorchBackend
    of a Scheduler: `phase_totals` is the loop's phase_profile dict (the
    base class's), `wave_totals` the backend wave-path phases' sums."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, tracer=None,
                 metrics=None,
                 slow_wave_deadline_s: float | None = DEFAULT_SLOW_WAVE_S,
                 profile_seconds: float = DEFAULT_PROFILE_S):
        super().__init__()
        self.tracer = tracer or Tracer("flight-recorder")  # no-op by default
        self.metrics = metrics
        # per-pod e2e latency decomposition
        self.pod_ledger = PodLatencyLedger(metrics=metrics)
        # device-side accounting: transfer ledger, compile tracker, memory
        # watermark
        self.device_telemetry = DeviceTelemetry(metrics=metrics)
        # streaming-wave stall attribution: per-wave wall clock decomposed
        # into overlap + named stall reasons
        self.stall_profiler = StallProfiler(metrics=metrics)
        self.slow_wave_deadline_s = slow_wave_deadline_s or None
        self.profile_seconds = profile_seconds
        self.wave_totals: dict = {k: 0.0 for k in WAVE_PHASES}
        self._records: "collections.deque[WaveRecord]" = collections.deque(
            maxlen=capacity
        )
        self._wave_seq = 0
        self.invalidations = 0  # cumulative carry invalidations
        self.retries_total = 0  # cumulative dispatcher retry attempts
        # gang routing totals: path ("device" | "host") -> member count
        self.gang_pod_totals: dict = {}
        # streaming-wave pipeline accounting: cumulative launch-side host
        # prep seconds, and how many of them ran under an in-flight
        # predecessor (see note_pipeline); wave-size histogram by pad
        self.prep_s_total = 0.0
        self.overlap_s_total = 0.0
        self.wave_sizes: dict[int, int] = {}
        self.slow_wave_captures = 0
        self._watchdogs: dict[int, threading.Timer] = {}
        # crash-restart reconcile outcomes (kind, count), bounded: one entry
        # per recovery kind per reconcile pass, not per pod
        self.restart_events: "collections.deque[tuple]" = collections.deque(
            maxlen=64
        )
        # fleet shard ownership/failover transitions: ("ownership", owned,
        # fleet_size) on acquire/release, ("failover", shard, latency_s) on
        # a dead peer's shard adoption; bounded
        self.fleet_events: "collections.deque[tuple]" = collections.deque(
            maxlen=64
        )

    # -- phase stopwatches (span-backed) --------------------------------------

    @contextmanager
    def phase(self, name: str, record: WaveRecord | None = None, **attrs):
        """Time a loop-level phase: the base class's stopwatch (into
        phase_totals) inside a `phase/<name>` span, and the time added to
        the wave record when one is given."""
        t0 = time.perf_counter()
        try:
            with self.tracer.span(f"phase/{name}", **attrs):
                with super().phase(name):
                    yield
        finally:
            if record is not None:
                dt = time.perf_counter() - t0
                with self._lock:
                    record.phases[name] = record.phases.get(name, 0.0) + dt

    @contextmanager
    def wave_phase(self, name: str, record: WaveRecord | None = None):
        """Time a backend wave-path phase (sync/features/.../wait)."""
        t0 = time.perf_counter()
        try:
            with self.tracer.span(f"wave_phase/{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.wave_totals[name] = self.wave_totals.get(name, 0.0) + dt
                if record is not None:
                    record.phases[name] = record.phases.get(name, 0.0) + dt

    def wave_phases(self, record: WaveRecord | None, marks) -> None:
        """Wave-path phases the backend already timed: (name, t_start,
        t_end) perf_counter readings, each added as wave_phase would add
        it and traced as a `wave_phase/<name>` span. One clock, so the
        backend's own phase dicts and the records agree exactly."""
        with self._lock:
            for name, a, b in marks:
                dt = b - a
                self.wave_totals[name] = self.wave_totals.get(name, 0.0) + dt
                if record is not None:
                    record.phases[name] = record.phases.get(name, 0.0) + dt
        if self.tracer.exporter is not None:
            for name, a, b in marks:
                self.tracer.add_span(f"wave_phase/{name}", a, b)

    # -- per-wave records -----------------------------------------------------

    def begin_wave(self, pods: int, pad: int = 0) -> WaveRecord:
        """Open a flight record at wave launch; arms the slow-wave watchdog
        when a deadline is configured."""
        with self._lock:
            self._wave_seq += 1
            rec = WaveRecord(wave_id=self._wave_seq, started_at=time.time(),
                             pods=pods, pad=pad or pods)
            rec._t0 = time.perf_counter()
            rec._inv_base = self.invalidations
            rec._fault_base = faultinject.fired_total()
            rec._retry_base = self.retries_total
        if self.slow_wave_deadline_s:
            t = threading.Timer(self.slow_wave_deadline_s,
                                self._capture_slow_wave, args=(rec,))
            t.daemon = True
            with self._lock:
                self._watchdogs[rec.wave_id] = t
            t.start()
        return rec

    def note_launch(self, rec: WaveRecord, signatures: int = 0,
                    dedup: bool = False) -> None:
        """Attach launch-side wave composition (dedup grouping outcome)."""
        rec.signatures = signatures
        rec.dedup_tier = "dedup" if dedup else "off"
        if dedup and rec.pods:
            rec.clones = rec.pods - signatures
            rec.distinct_signature_ratio = round(signatures / rec.pods, 4)

    def note_pipeline(self, rec: WaveRecord, overlapped: bool) -> None:
        """Attach launch-side pipeline accounting: `overlapped` is True
        when a predecessor wave was in flight on device while this wave's
        host prep (the PREP_PHASES stopwatches) ran — the prep was hidden
        under the predecessor's `wait`. Called by the backend at the end of
        launch_batched, before collect."""
        prep = sum(rec.phases.get(p, 0.0) for p in PREP_PHASES)
        rec.overlap_s = prep if overlapped else 0.0
        rec.pipeline_overlap_ratio = 1.0 if (overlapped and prep) else 0.0
        with self._lock:
            self.prep_s_total += prep
            self.overlap_s_total += rec.overlap_s

    def note_cross_wave(self, rec: WaveRecord, hits: int, misses: int,
                        evictions: int) -> None:
        """Attach the launch-side cross-wave cache outcome: how many of
        this wave's signatures replayed a previous chained wave's resident
        score row (hits) vs paid a fresh full pass (misses), and how many
        resident rows fell out of the single-generation table."""
        rec.xwave_hits = hits
        rec.xwave_misses = misses
        rec.xwave_evictions = evictions

    @contextmanager
    def fallback_attribution(self, framework, record: WaveRecord | None = None):
        """Per-plugin phase attribution for host-fallback scheduling: while
        active, every plugin call the framework times lands in
        `fallback/<plugin>` buckets (phase_totals + the wave record)
        UNSAMPLED, so a fallback regression is attributable to the plugin
        that caused it instead of vanishing into one "finish" span."""
        if framework is None:
            yield
            return
        prev = getattr(framework, "plugin_observer", None)

        def observe(point: str, plugin: str, dt: float) -> None:
            key = f"fallback/{plugin}"
            with self._lock:
                self.phase_totals[key] = self.phase_totals.get(key, 0.0) + dt
                if record is not None:
                    record.phases[key] = record.phases.get(key, 0.0) + dt

        framework.plugin_observer = observe
        try:
            yield
        finally:
            framework.plugin_observer = prev

    def carry_invalidated(self) -> None:
        """The device carry was dropped (resync/divergence/external event);
        open records count the invalidations that happened in their window."""
        with self._lock:
            self.invalidations += 1

    def note_retries(self, n: int) -> None:
        """The dispatcher absorbed n retry attempts (called from worker
        threads); open wave records count retries in their window."""
        with self._lock:
            self.retries_total += n

    def count_gang_pods(self, path: str, n: int) -> None:
        """Count gang members routed down `path` ("device" = admitted to a
        gang wave, "host" = handed to the host pod-group cycle). The one
        emission point for scheduler_tpu_gang_pods_total."""
        if n <= 0:
            return
        with self._lock:
            self.gang_pod_totals[path] = self.gang_pod_totals.get(path, 0) + n
        m = self.metrics
        if m is not None and hasattr(m, "gang_pods"):
            m.gang_pods(path, n)

    def breaker_transition(self, old: str, new: str, reason: str) -> None:
        """Record a circuit-breaker state transition and land it on the
        metrics registry (state gauge + transition counter)."""
        super().breaker_transition(old, new, reason)
        m = self.metrics
        if m is not None and hasattr(m, "breaker_transition"):
            m.breaker_transition(old, new)

    def partition_detected(self, kind: str, repaired: int,
                           latency_s: float) -> None:
        """An informer detected (and just repaired) a watch-stream
        partition; lands the detection counter + repair-latency histogram
        on the metrics registry."""
        super().partition_detected(kind, repaired, latency_s)
        m = self.metrics
        if m is not None and hasattr(m, "partition_detected"):
            m.partition_detected(kind, latency_s)

    def restart_recovery(self, kind: str, n: int = 1) -> None:
        """A startup reconcile resolved n pieces of mid-flight crash state
        of `kind` (adopted/forgotten/requeued/gang_adopt/gang_release/
        permit_cleared, with the fleet's shard_adopt_/shard_acquire_
        prefixes); lands the restart-recovery counter on the metrics
        registry. Scheduler.reconcile's outcome sink."""
        if n <= 0:
            return
        with self._lock:
            self.restart_events.append((kind, n))
        m = self.metrics
        if m is not None and hasattr(m, "restart_recovery"):
            m.restart_recovery(kind, n)

    def shard_ownership(self, owned: int, fleet_size: int) -> None:
        """This fleet member's shard count changed (lease acquired or
        lost); lands the ownership gauges on the metrics registry."""
        with self._lock:
            self.fleet_events.append(("ownership", owned, fleet_size))
        m = self.metrics
        if m is not None and hasattr(m, "fleet_ownership"):
            m.fleet_ownership(owned, fleet_size)

    def shard_failover(self, shard: int, latency_s: float) -> None:
        """A dead peer's shard adopted (lease expiry -> takeover latency);
        lands the failover counter and latency histogram."""
        with self._lock:
            self.fleet_events.append(("failover", shard, latency_s))
        m = self.metrics
        if m is not None and hasattr(m, "fleet_failover"):
            m.fleet_failover(shard, latency_s)

    def end_wave(self, rec: WaveRecord,
                 fallback_reason: str | None = None) -> WaveRecord:
        """Finalize and ring-buffer a record; disarms the watchdog, attaches
        any captured profile, and lands the wave's metrics series."""
        with self._lock:
            timer = self._watchdogs.pop(rec.wave_id, None)
        if timer is not None:
            timer.cancel()
        rec.duration_s = time.perf_counter() - rec._t0
        rec.occupancy = round(rec.pods / rec.pad, 4) if rec.pad else 0.0
        if fallback_reason is not None:
            rec.fallback_reason = fallback_reason
        with self._lock:
            rec.carry_invalidations = self.invalidations - rec._inv_base
            rec.injected_faults = faultinject.fired_total() - rec._fault_base
            rec.retries = self.retries_total - rec._retry_base
            self.wave_sizes[rec.pad] = self.wave_sizes.get(rec.pad, 0) + 1
            self._records.append(rec)
        # stall attribution closes with the record: duration/phases are
        # final here, and the decomposition must land before the metrics
        # pass reads stall_by_reason
        self.stall_profiler.finalize(rec)
        m = self.metrics
        if m is not None:
            if hasattr(m, "wave_completed"):
                m.wave_completed(rec)
            if hasattr(m, "update_sli_quantiles"):
                m.update_sli_quantiles()
        # ledger/telemetry gauges refresh once per wave, not per pod
        self.pod_ledger.update_gauges()
        self.device_telemetry.update_gauges()
        return rec

    def _capture_slow_wave(self, rec: WaveRecord) -> None:
        """Watchdog fire: the wave blew its deadline and is still open —
        sample every thread's stack so the record explains where the time
        went. Runs on the timer thread; purely observational."""
        from ...utils.pprof import take_profile

        try:
            profile = take_profile(seconds=self.profile_seconds)
        except Exception as e:  # noqa: BLE001 - diagnostics are best-effort
            profile = f"profile capture failed: {type(e).__name__}: {e}"
        rec.profile = (
            f"slow wave {rec.wave_id}: exceeded "
            f"{self.slow_wave_deadline_s}s deadline\n{profile}"
        )
        with self._lock:
            self.slow_wave_captures += 1
        if self.metrics is not None and hasattr(self.metrics,
                                                "slow_wave_captured"):
            self.metrics.slow_wave_captured()

    # -- queries / snapshots --------------------------------------------------

    def records(self, last: int | None = None) -> list[WaveRecord]:
        with self._lock:
            recs = list(self._records)
        return recs[-last:] if last else recs

    def wave_snapshot(self) -> dict:
        with self._lock:
            return dict(self.wave_totals)

    def wave_size_histogram(self) -> dict:
        """Completed-wave count per pow2 pad bucket (the adaptive wave-size
        controller's observable output), keyed by stringified pad size."""
        with self._lock:
            return {str(k): v for k, v in sorted(self.wave_sizes.items())}

    def pipeline_overlap_ratio(self) -> float | None:
        """Fraction of cumulative launch-side host prep that ran under an
        in-flight predecessor wave. None until any prep has been timed."""
        with self._lock:
            if not self.prep_s_total:
                return None
            return round(self.overlap_s_total / self.prep_s_total, 4)

    def summary(self) -> dict:
        recs = self.records()
        durations = sorted(r.duration_s for r in recs)
        return {
            "waves_recorded": len(recs),
            "waves_total": self.phase_snapshot().get("waves", 0),
            "slow_wave_captures": self.slow_wave_captures,
            "carry_invalidations": self.invalidations,
            "retries_total": self.retries_total,
            "breaker_transitions": len(self.breaker_events),
            "partitions_detected": len(self.partition_events),
            "fallbacks": sum(1 for r in recs if r.fallback_reason),
            "wave_p50_s": (round(durations[len(durations) // 2], 4)
                           if durations else None),
            "wave_max_s": round(durations[-1], 4) if durations else None,
            "pipeline_overlap_ratio": self.pipeline_overlap_ratio(),
            "wave_size_hist": self.wave_size_histogram(),
            "stalls": self.stall_profiler.summary(),
        }

    # -- dump hook ------------------------------------------------------------

    def dump(self, last: int | None = None) -> str:
        """JSON post-mortem dump: summary + the ring buffer's records."""
        return json.dumps({
            "summary": self.summary(),
            "phase_totals": {
                k: (v if k == "waves" else round(v, 6))
                for k, v in self.phase_snapshot().items()
            },
            "wave_totals": {k: round(v, 6)
                            for k, v in self.wave_snapshot().items()},
            "pod_latency": self.pod_ledger.snapshot(slowest=8),
            "device_telemetry": self.device_telemetry.snapshot(),
            "stalls": self.stall_profiler.snapshot(last=8),
            "records": [r.to_dict() for r in self.records(last)],
        }, indent=2)

    def install(self, signum=None):
        """Install a signal handler dumping flight records to the log
        (SIGUSR1 by default). Returns the previous handler. Raises
        ValueError off the main thread."""
        import logging
        import signal as _signal

        if signum is None:
            signum = _signal.SIGUSR1
        log = logging.getLogger("kubernetes_tpu_torch.flightrecorder")

        def handler(_sig, _frame):
            log.warning("flight-recorder dump:\n%s", self.dump())

        return _signal.signal(signum, handler)


# -- CLI: post-mortem reader / smoke ------------------------------------------


def format_postmortem(records: list[dict]) -> str:
    """Human-readable wave table from to_dict()-shaped records."""
    if not records:
        return "(no flight records)"
    cols = ("wave", "pods", "pad", "occ", "sigs", "tier", "inval",
            "fallback", "ms", "slowest phases")
    rows = []
    for r in records:
        phases = sorted(r.get("phases", {}).items(), key=lambda kv: -kv[1])
        top = " ".join(f"{k}={v * 1000:.1f}ms" for k, v in phases[:3])
        if r.get("profile"):
            top += "  [profile captured]"
        rows.append((
            str(r["wave_id"]), str(r["pods"]), str(r["pad"]),
            f"{r.get('occupancy', 0):.2f}", str(r.get("signatures", 0)),
            r.get("dedup_tier", "off"),
            str(r.get("carry_invalidations", 0)),
            (r.get("fallback_reason") or "-")[:32],
            f"{r.get('duration_s', 0) * 1000:.1f}", top,
        ))
    widths = [max(len(c), *(len(row[i]) for row in rows))
              for i, c in enumerate(cols)]
    out = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    for row in rows:
        out.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    return "\n".join(out)


def _demo() -> WaveRecorder:
    """Synthetic multi-wave run exercising the full recorder surface (no
    device, no kernel): the CLI's --demo smoke."""
    rec = WaveRecorder(capacity=8, slow_wave_deadline_s=0.05,
                       profile_seconds=0.05)
    tel = rec.device_telemetry
    for i in range(10):
        wr = rec.begin_wave(pods=30 + i, pad=32)
        with rec.wave_phase("sync", wr):
            pass
        # device telemetry, driven as the backend drives it: accounted
        # transfers per plane, a compile span per kernel signature (only
        # wave 0's is a first use), resident-buffer bytes
        tel.account_upload("features", 4096, wr)
        tel.account_upload("carry_scatter", 1024, wr)
        tel.note_resident("planes", 1 << 20, wr)
        with tel.compile_span("batched_assign", ("demo", 32),
                              label="pad32", record=wr):
            pass
        with rec.wave_phase("dispatch", wr):
            pass
        tel.account_fetch("results", 8 * 4, wr)
        rec.note_launch(wr, signatures=3, dedup=True)
        rec.note_cross_wave(wr, hits=(3 if i else 0),
                            misses=(0 if i else 3), evictions=0)
        # wave 0 launches into an idle device; every later wave's prep
        # overlaps the (synthetic) in-flight predecessor
        rec.note_pipeline(wr, overlapped=bool(i))
        # stall attribution, driven exactly as the loop drives it: gap
        # marks at the seams (queue ran dry, per-tick cap, forced drain)
        if i == 2:
            rec.stall_profiler.mark_gap(wr, "queue_empty")
        elif i == 5:
            rec.stall_profiler.mark_gap(wr, "capacity_gate")
        elif i == 7:
            rec.stall_profiler.mark_gap(wr, "flush")
        with rec.phase("kernel", wr):
            if i == 4:
                # trip the watchdog once: hold the wave open until the timer
                # has fired and attached its profile (a fixed sleep raced
                # the timer thread on a loaded host)
                give_up = time.monotonic() + 10.0
                while (rec.slow_wave_captures == 0
                       and time.monotonic() < give_up):
                    time.sleep(0.01)
        rec.count_wave()
        rec.end_wave(wr, fallback_reason=(
            "tie-break draw overflow" if i == 7 else None
        ))
    return rec


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.scheduler.tpu.waverecorder",
        description="Wave flight-recorder post-mortem reader",
    )
    parser.add_argument("dump", nargs="?",
                        help="JSON dump file (from WaveRecorder.dump() / "
                             "the SIGUSR1 hook); '-' reads stdin")
    parser.add_argument("--last", type=int, default=None,
                        help="show only the last N waves")
    parser.add_argument("--demo", action="store_true",
                        help="run a synthetic multi-wave smoke and print its "
                             "post-mortem (no device needed)")
    parser.add_argument("--schema", action="store_true",
                        help="print the flight-record field schema")
    args = parser.parse_args(argv)

    if args.schema:
        for f in WaveRecord.__dataclass_fields__:
            if not f.startswith("_"):
                print(f)
        return 0
    if args.demo:
        rec = _demo()
        payload = json.loads(rec.dump(last=args.last))
        # smoke-assert the device-telemetry block's presence and schema
        # (the SIGUSR1 payload's contract)
        telemetry = payload.get("device_telemetry")
        if not isinstance(telemetry, dict):
            print("FAIL: dump payload is missing 'device_telemetry'")
            return 1
        missing = [k for k in ("transfers", "compiles", "memory")
                   if k not in telemetry]
        records = payload.get("records", [])
        bad_records = [r["wave_id"] for r in records
                       if "upload_bytes" not in r
                       or "mem_watermark_bytes" not in r
                       or sum(r.get("upload_by_plane", {}).values())
                       != r["upload_bytes"]]
        if missing or bad_records:
            print(f"FAIL: device telemetry schema: missing={missing} "
                  f"bad_records={bad_records}")
            return 1
        if telemetry["transfers"]["upload"]["total_bytes"] <= 0 \
                or telemetry["compiles"]["total"] != 1 \
                or telemetry["memory"]["watermark_bytes"] <= 0:
            print("FAIL: device telemetry totals: "
                  + json.dumps(telemetry, indent=2))
            return 1
        # stall-attribution block: every wave decomposed, coverage holds
        stalls = payload.get("stalls", {}).get("summary")
        if not isinstance(stalls, dict):
            print("FAIL: dump payload is missing 'stalls'")
            return 1
        uncovered = [r["wave_id"] for r in records
                     if "stall_by_reason" not in r
                     or r.get("stall_coverage", 0.0) < 0.95]
        if uncovered or stalls.get("waves_profiled", 0) <= 0 \
                or (stalls.get("coverage_min") or 0.0) < 0.95:
            print(f"FAIL: stall attribution: uncovered={uncovered} "
                  f"summary={json.dumps(stalls)}")
            return 1
    elif args.dump:
        import sys

        raw = (sys.stdin.read() if args.dump == "-"
               else open(args.dump).read())
        payload = json.loads(raw)
        if args.last:
            payload["records"] = payload.get("records", [])[-args.last:]
    else:
        parser.print_usage()
        return 2
    print(format_postmortem(payload.get("records", [])))
    summary = payload.get("summary", {})
    print("\nsummary: " + ", ".join(f"{k}={v}" for k, v in summary.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
