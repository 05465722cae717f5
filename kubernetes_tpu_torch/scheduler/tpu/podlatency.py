"""Pod latency ledger: per-pod end-to-end latency decomposition.

The wave flight recorder answers "where did wave k spend its time"; this
ledger answers "where did *pod p* spend its 4.55 seconds". Every pod gets
an entry stamped at each lifecycle edge — watch arrival (informer
deliver), queue admission, wave admission, kernel verdict, bind dispatch,
bind commit, and (when a kubelet is in the loop) status ack — so e2e
latency decomposes into exact per-segment durations instead of one
opaque SLI number.

Like the flight recorder, all recording is HOST-SIDE ONLY: stamps are
perf_counter reads behind a lock, nothing runs inside a kernel, no rng is
consumed, and no scheduling decision reads the ledger — the
bit-compat goldens hold with the ledger on or off. Per-pod cost is one
dict write per edge; quantile gauges update once per wave, not per pod.

Edge semantics: `watch_arrival`/`queue_admission` are first-wins (a
requeue after backoff must not erase when the pod really arrived), the
later edges are last-wins — a pod that fails binding and retries reports
the *successful* attempt's decomposition, with the retry time absorbed
into its queue_wait segment. `status_ack` lands after completion, onto
the retained entry.

Every metric series this module emits is declared in LEDGER_SERIES and
registered in scheduler/metrics.py. A copy of the reference package's
module (kubernetes_tpu/scheduler/tpu/podlatency.py).
"""

from __future__ import annotations

import collections
import math
import threading
import time

# Series this ledger emits: every name here is registered in
# scheduler/metrics.py, and every _series() call site names one of them.
LEDGER_SERIES = (
    "scheduler_pod_e2e_latency_seconds",
    "scheduler_pod_e2e_latency_quantile_seconds",
)

# lifecycle edges, in pipeline order
EDGES = (
    "watch_arrival",    # informer delivered the ADDED event
    "queue_admission",  # pod entered the scheduling queue
    "wave_admission",   # pod popped into a batched wave (or host cycle)
    "kernel_verdict",   # device kernel / host algorithm picked a node
    "gang_wait_start",  # gang member entered the Permit wait (gang pods only)
    "gang_wait_end",    # gang quorum allowed the member (or wait rejected)
    "bind_dispatch",    # bind call handed to the dispatcher
    "bind_commit",      # bind durably applied to the store
    "status_ack",       # kubelet reported the pod Running (when present)
)

# segment name -> (from_edge, to_edge); e2e spans the whole pipeline
SEGMENTS = (
    ("informer", "watch_arrival", "queue_admission"),
    ("queue_wait", "queue_admission", "wave_admission"),
    ("kernel", "wave_admission", "kernel_verdict"),
    # gang pods only: time parked at Permit until quorum (subset of the
    # bind_dispatch segment, which keeps its kernel_verdict anchor)
    ("gang_wait", "gang_wait_start", "gang_wait_end"),
    ("bind_dispatch", "kernel_verdict", "bind_dispatch"),
    ("bind_commit", "bind_dispatch", "bind_commit"),
    ("status_ack", "bind_commit", "status_ack"),
    ("e2e", "watch_arrival", "bind_commit"),
)
SEGMENT_NAMES = tuple(s[0] for s in SEGMENTS)

_FIRST_WINS = ("watch_arrival", "queue_admission")

DEFAULT_CAPACITY = 256   # completed entries retained for the zpage/dump
DEFAULT_OPEN_CAP = 8192  # open entries before oldest-first shedding
DEFAULT_WINDOW = 8192    # per-segment quantile sample window


class StreamingQuantile:
    """Exact quantiles over a bounded streaming window.

    Samples accumulate up to `window`; on overflow the oldest half is
    dropped (deterministic — no sampling, no rng), so quantiles are exact
    over the retained window. `quantile(q)` uses the inverted-CDF
    definition (`sorted[ceil(q*n) - 1]`), matching
    `numpy.percentile(..., method="inverted_cdf")` — the golden test pins
    this equivalence on fixed seeds.
    """

    __slots__ = ("window", "_samples", "_sorted", "total_n")

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = max(int(window), 2)
        self._samples: list[float] = []
        self._sorted: list[float] | None = None
        self.total_n = 0  # lifetime count, survives window compression

    def add(self, value: float) -> None:
        self._samples.append(value)
        self._sorted = None
        self.total_n += 1
        if len(self._samples) > self.window:
            del self._samples[: self.window // 2]

    def n(self) -> int:
        return len(self._samples)

    def quantile(self, q: float) -> float | None:
        """Inverted-CDF quantile over the retained window; None if empty."""
        if not self._samples:
            return None
        if self._sorted is None:
            self._sorted = sorted(self._samples)
        n = len(self._sorted)
        idx = max(math.ceil(q * n) - 1, 0)
        return self._sorted[min(idx, n - 1)]


class PodLedgerEntry:
    """One pod's lifecycle stamps (perf_counter seconds) and, once
    completed, its per-segment decomposition."""

    __slots__ = ("key", "stamps", "wave_id", "arrived_at", "segments")

    def __init__(self, key: str):
        self.key = key
        self.stamps: dict[str, float] = {}
        self.wave_id: int | None = None  # exemplar link -> wave/<id> span
        self.arrived_at = time.time()    # wall clock, for correlation
        self.segments: dict[str, float] = {}

    def to_dict(self) -> dict:
        d = {
            "pod": self.key,
            "arrived_at": self.arrived_at,
            "segments": {k: round(v, 6) for k, v in self.segments.items()},
        }
        if self.wave_id is not None:
            d["wave_id"] = self.wave_id
            d["span"] = f"wave/{self.wave_id}"  # trace exemplar link
        return d


class PodLatencyLedger:
    """Per-pod lifecycle stamps -> exact segment decomposition + quantiles.

    Owned by the FlightRecorder (one per scheduler); stamped from the
    informer callback, the wave loop, and the binding path. `enabled`
    exists for the bit-compat golden — production keeps it on.
    """

    def __init__(self, metrics=None, capacity: int = DEFAULT_CAPACITY,
                 open_cap: int = DEFAULT_OPEN_CAP,
                 window: int = DEFAULT_WINDOW):
        self.enabled = True
        self.metrics = metrics
        self.capacity = capacity
        self.open_cap = open_cap
        self._lock = threading.Lock()
        self._open: dict[str, PodLedgerEntry] = {}
        # completed ring + by-key view of it (for late status acks)
        self._completed: collections.deque[PodLedgerEntry] = collections.deque()
        self._recent: dict[str, PodLedgerEntry] = {}
        self._estimators = {
            name: StreamingQuantile(window) for name in SEGMENT_NAMES
        }
        self.completed_total = 0
        self.dropped_open = 0  # open entries shed at open_cap

    # -- emission (every name literal, declared in LEDGER_SERIES) ------------

    def _series(self, name: str):
        m = self.metrics
        registry = getattr(m, "registry", None) if m is not None else None
        return registry.get(name) if registry is not None else None

    # -- stamping ------------------------------------------------------------

    def stamp(self, key: str, edge: str, wave_id: int | None = None) -> None:
        """Record that `key` crossed `edge` now. Cheap and decision-free."""
        if not self.enabled:
            return
        now = time.perf_counter()
        with self._lock:
            entry = self._open.get(key)
            if entry is None:
                if edge == "status_ack":
                    self._late_status_ack(key, now)
                    return
                entry = self._open[key] = PodLedgerEntry(key)
                if len(self._open) > self.open_cap:
                    oldest = next(iter(self._open))
                    del self._open[oldest]
                    self.dropped_open += 1
            if edge in _FIRST_WINS:
                entry.stamps.setdefault(edge, now)
            else:
                entry.stamps[edge] = now
            if wave_id is not None:
                entry.wave_id = wave_id

    def _late_status_ack(self, key: str, now: float) -> None:
        """Kubelet ack arriving after bind_commit completed the entry
        (the common case) — stamp the retained entry. Lock held."""
        entry = self._recent.get(key)
        if entry is None or "status_ack" in entry.stamps:
            return
        entry.stamps["status_ack"] = now
        commit = entry.stamps.get("bind_commit")
        if commit is None:
            return
        dt = max(now - commit, 0.0)
        entry.segments["status_ack"] = dt
        self._estimators["status_ack"].add(dt)
        hist = self._series("scheduler_pod_e2e_latency_seconds")
        if hist is not None:
            hist.observe(dt, "status_ack")

    def complete(self, key: str) -> PodLedgerEntry | None:
        """Close the pod's entry at bind commit: compute segments, feed
        the quantile estimators, land the histogram, retain for the zpage."""
        if not self.enabled:
            return None
        with self._lock:
            entry = self._open.pop(key, None)
            if entry is None:
                return None
            stamps = entry.stamps
            for name, frm, to in SEGMENTS:
                if frm in stamps and to in stamps:
                    entry.segments[name] = max(stamps[to] - stamps[frm], 0.0)
            for name, value in entry.segments.items():
                self._estimators[name].add(value)
            self.completed_total += 1
            self._completed.append(entry)
            self._recent[entry.key] = entry
            while len(self._completed) > self.capacity:
                old = self._completed.popleft()
                if self._recent.get(old.key) is old:
                    del self._recent[old.key]
            segments = dict(entry.segments)
        hist = self._series("scheduler_pod_e2e_latency_seconds")
        if hist is not None:
            for name, value in segments.items():
                hist.observe(value, name)
        return entry

    def forget(self, key: str) -> None:
        """Pod left the system unscheduled (deleted) — drop its open entry
        so churn of never-scheduled pods doesn't leak state."""
        with self._lock:
            self._open.pop(key, None)

    # -- gauges (once per wave, from FlightRecorder.end_wave) ----------------

    def update_gauges(self) -> None:
        gauge = self._series("scheduler_pod_e2e_latency_quantile_seconds")
        if gauge is None:
            return
        for name, p50, p99 in self._quantile_rows():
            gauge.set(p50, name, "p50")
            gauge.set(p99, name, "p99")

    def _quantile_rows(self) -> list[tuple[str, float, float]]:
        with self._lock:
            out = []
            for name in SEGMENT_NAMES:
                est = self._estimators[name]
                if est.n():
                    out.append((name, est.quantile(0.50), est.quantile(0.99)))
            return out

    # -- queries / snapshots -------------------------------------------------

    def segment_quantiles(self) -> dict:
        """{segment: {p50, p99, n}} over each estimator's retained window."""
        with self._lock:
            out = {}
            for name in SEGMENT_NAMES:
                est = self._estimators[name]
                if est.n():
                    out[name] = {
                        "p50": round(est.quantile(0.50), 6),
                        "p99": round(est.quantile(0.99), 6),
                        "n": est.total_n,
                    }
            return out

    def summary(self) -> dict:
        with self._lock:
            open_entries = len(self._open)
        return {
            "pods_completed": self.completed_total,
            "open_entries": open_entries,
            "dropped_open": self.dropped_open,
            "segments": self.segment_quantiles(),
        }

    def snapshot(self, last: int | None = None,
                 slowest: int | None = None) -> dict:
        """The /debug/podlatency zpage payload: summary + recent entries
        + the slowest retained entries by e2e."""
        with self._lock:
            completed = list(self._completed)
        out = {"summary": self.summary()}
        if last:
            out["last"] = [e.to_dict() for e in completed[-last:]]
        if slowest:
            ranked = sorted(completed,
                            key=lambda e: e.segments.get("e2e", 0.0),
                            reverse=True)
            out["slowest"] = [e.to_dict() for e in ranked[:slowest]]
        return out
