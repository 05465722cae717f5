"""Device telemetry: transfer ledger, compile tracker, memory watermark.

The wave recorder answers "where did wave k spend its time" and the pod
ledger answers "where did pod p spend its seconds"; this module answers
the device-side questions those two cannot see: how many bytes crossed
the host<->device boundary (and for which plane), how often a kernel met
a static configuration for the first time (and for which shape), and how
many bytes of plane buffers are resident on the device right now.

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/devicetelemetry.py) for torch. Three
instruments, one owner (the WaveRecorder, like the pod ledger):

- **Transfer ledger** — every host->device upload and device->host fetch
  in scheduler/tpu/backend.py is counted at its seam: `accounted_put`
  wraps a placement function (the execution context's `put`),
  `accounted_fetch` a blocking `.cpu()`, and the accounting-only
  `account_upload`/`account_fetch` count the bytes of a copy the backend
  already makes (its pinned staging buffers, the wave's asynchronous
  result copy). Each call names a plane from TRANSFER_PLANES; bytes are
  `nbytes` of the host array or tensor, summed per plane and direction
  and per wave onto `WaveRecord.upload_bytes` / `fetch_bytes` /
  `*_by_plane`. No seam adds a copy, a `.item()` or a synchronisation.
- **Compile tracker** — `compile_span(kernel, signature)` wraps each
  kernel entry point. The first time a (kernel, signature) pair is seen
  the call is a first use: the signature is the call site's static
  configuration and bucket shapes (the reference's jit cache key), and
  on a card the span's seconds are what that first use costs — the nvcc
  build through ops/cuda.py when the library is not built yet, its load,
  and the first launch. It is counted, labelled with a compact shape
  label, and recorded as a `compile/<kernel>` phase on the wave record.
- **Memory watermark** — `note_resident(group, nbytes)` tracks the
  bytes of each device-resident buffer group (base planes, affinity
  tables, carry overlay, signature table); live bytes are the sum, the
  watermark is the running max. On a card `torch.cuda.memory_allocated`
  is emitted beside it as a cross-check (source "torch"), read once per
  wave and in snapshots, never per launch; on the CPU nothing.

Everything here is HOST-SIDE ONLY: accounting happens around device
calls, never inside a kernel, consumes no rng, and no scheduling decision
reads the telemetry — the bit-compat goldens hold with telemetry on or
off. `accounted_put` returns exactly what the placement function returns,
so routing a transfer through the seam cannot change a binding.

Every metric series this module emits is declared in LEDGER_SERIES and
registered in scheduler/metrics.py.
"""

from __future__ import annotations

import contextlib
import hashlib
import sys
import threading
import time

# Series this telemetry emits: every name here is registered in
# scheduler/metrics.py, and every _series() call site names one of them.
LEDGER_SERIES = (
    "scheduler_tpu_transfer_bytes_total",
    "scheduler_tpu_compiles_total",
    "scheduler_tpu_compiled_shapes",
    "scheduler_tpu_device_memory_bytes",
)

# Named planes a seam call may attribute transfer bytes to; every seam
# call site names one of these as a string literal.
TRANSFER_PLANES = (
    "node_planes",      # full base-mirror upload of every node plane
    "carry_scatter",    # legacy name for the base-mirror row scatter
    "delta_rows",       # O(churn) gathered rows of the K3 delta scatter
    "delta_idx",        # row-index vector of the K3 delta scatter
    "affinity_tables",  # interned (anti-)affinity signature tables
    "ipa_term_key",     # global IPA term-key table refresh
    "features",         # the wave's packed pod features + tie words (+ the
                        # signature ids, slot map and cross-wave map)
    "gang_masks",       # gang wave's [D, Nb] topology-domain mask stack
    "results",          # packed winners/cursor fetch at collect
    "scores",           # per-node score/fail rows (single-pod, sig export)
    "log_weights",      # PodTopologySpread's log-weight table (the port's
                        # kernels read it from device memory)
)

# Device-resident buffer groups for the memory watermark.
RESIDENT_GROUPS = ("planes", "tables", "carry", "sig_table")

UPLOAD = "upload"
FETCH = "fetch"


def tree_nbytes(tree) -> int:
    """Total nbytes of an array or tensor, or of every value of a dict of
    them (metadata only: no device read)."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return int(getattr(tree, "nbytes", 0) or 0)


def _shape_label(signature) -> str:
    """Deterministic compact fallback label for a compile signature.

    Call sites pass an explicit structural label (e.g. "pad32/g8");
    this digest is only the fallback, and it must be stable across
    processes (str hashing is salted, hashlib is not) so bench
    artifacts compare across runs.
    """
    digest = hashlib.md5(repr(signature).encode()).hexdigest()[:10]
    return f"sig-{digest}"


class DeviceTelemetry:
    """Accounted transfer seam + compile tracker + memory watermark.

    Owned by the WaveRecorder (one per scheduler); called from the
    backend around its device seams. `enabled` exists for the
    bit-compat golden — production keeps it on. When disabled the seam
    still performs the underlying put/fetch (the backend depends on the
    return value) and only the accounting is skipped. `device` is set by
    a backend that runs on a card: the memory cross-check reads it.
    """

    def __init__(self, metrics=None):
        self.enabled = True
        self.metrics = metrics
        self.device = None
        self._lock = threading.Lock()
        # direction -> {plane: cumulative bytes}
        self._transfers: dict[str, dict[str, int]] = {UPLOAD: {}, FETCH: {}}
        self._totals: dict[str, int] = {UPLOAD: 0, FETCH: 0}
        # compile tracker: first-seen (kernel, signature) == first use
        self._compiled: set = set()
        self._compiles: dict[str, int] = {}
        self._compile_seconds: dict[str, float] = {}
        self._shapes: dict[str, set[str]] = {}
        # memory watermark: group -> currently resident bytes
        self._resident: dict[str, int] = {}
        self._watermark = 0
        # warm-start baseline: the compile count at the end of the warmup
        # phase (scheduler/tpu/warmup.py); compile_count_since_warm() is
        # the warm start's "no first use left" check
        self._warm_compile_base = 0

    # -- emission (every name literal, declared in LEDGER_SERIES) ------------

    def _series(self, name: str):
        m = self.metrics
        registry = getattr(m, "registry", None) if m is not None else None
        return registry.get(name) if registry is not None else None

    # -- transfer ledger -----------------------------------------------------

    def accounted_put(self, plane: str, tree, put, record=None):
        """Host->device upload through the accounted seam.

        `put` is the device placement function (a context's `put(value,
        name=None)` seam); it is applied per leaf — for a dict the leaf's
        key rides along as `name` so a sharded context can check the
        plane's node axis — and the returned mirror is exactly what a
        direct put produces: the seam is bit-compatible by construction.
        Bytes are the host arrays' nbytes, attributed to `plane` (and to
        `record` when the upload belongs to a wave).
        """
        if isinstance(tree, dict):
            out = {k: put(v, k) for k, v in tree.items()}
        else:
            out = put(tree)
        self._account(UPLOAD, plane, tree_nbytes(tree), record)
        return out

    def accounted_fetch(self, plane: str, value, record=None):
        """Device->host fetch through the accounted seam: `value.cpu()`
        (the blocking copy the caller would make), its nbytes counted."""
        host = value.cpu()
        self._account(FETCH, plane, int(host.nbytes), record)
        return host

    def account_upload(self, plane: str, nbytes: int, record=None) -> None:
        """Accounting-only upload entry, for a copy the backend makes
        itself (one pinned staging buffer, a feature row)."""
        self._account(UPLOAD, plane, nbytes, record)

    def account_fetch(self, plane: str, nbytes: int, record=None) -> None:
        """Accounting-only fetch entry (value already on host: the wave's
        asynchronous result copy, read after its event)."""
        self._account(FETCH, plane, nbytes, record)

    def _account(self, direction: str, plane: str, nbytes, record) -> None:
        if not self.enabled:
            return
        nbytes = int(nbytes)
        if nbytes <= 0:
            return
        with self._lock:
            by_plane = self._transfers[direction]
            by_plane[plane] = by_plane.get(plane, 0) + nbytes
            self._totals[direction] += nbytes
        if record is not None:
            if direction == UPLOAD:
                record.upload_bytes += nbytes
                record.upload_by_plane[plane] = (
                    record.upload_by_plane.get(plane, 0) + nbytes)
            else:
                record.fetch_bytes += nbytes
                record.fetch_by_plane[plane] = (
                    record.fetch_by_plane.get(plane, 0) + nbytes)
            self.stamp_watermark(record)
        counter = self._series("scheduler_tpu_transfer_bytes_total")
        if counter is not None:
            counter.inc(direction, plane, by=float(nbytes))

    # -- compile tracker -----------------------------------------------------

    @contextlib.contextmanager
    def compile_span(self, kernel: str, signature, label: str | None = None,
                     record=None):
        """Wrap a kernel entry point; first-seen signature == first use.

        `signature` is the call site's static configuration and bucket
        shapes (the reference's jit cache key), never a tensor identity,
        so the first call with a fresh signature is the configuration's
        first use — on a card the library build when it is not built yet,
        its load and the first launch — and its wall time is recorded as
        the `compile/<kernel>` phase. Later calls with a seen signature
        yield with zero overhead beyond a set lookup. The span times the
        host's enqueue, not the kernel's run: nothing here synchronises.
        """
        if not self.enabled:
            yield
            return
        key = (kernel, signature)
        with self._lock:
            seen = key in self._compiled
        if seen:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            shape = label if label is not None else _shape_label(signature)
            with self._lock:
                first = key not in self._compiled
                if first:
                    self._compiled.add(key)
                    self._compiles[kernel] = self._compiles.get(kernel, 0) + 1
                    self._compile_seconds[kernel] = (
                        self._compile_seconds.get(kernel, 0.0) + elapsed)
                    self._shapes.setdefault(kernel, set()).add(shape)
            if first:
                if record is not None:
                    phase = f"compile/{kernel}"
                    record.phases[phase] = (
                        record.phases.get(phase, 0.0) + elapsed)
                counter = self._series("scheduler_tpu_compiles_total")
                if counter is not None:
                    counter.inc(kernel, shape)

    def compile_count(self, kernel: str | None = None) -> int:
        with self._lock:
            if kernel is not None:
                return self._compiles.get(kernel, 0)
            return sum(self._compiles.values())

    def compiled_shapes(self, kernel: str) -> list[str]:
        with self._lock:
            return sorted(self._shapes.get(kernel, ()))

    def mark_warm(self) -> None:
        """Take the compile count as the warm baseline (called once, at
        the end of the backend's warmup phase)."""
        with self._lock:
            self._warm_compile_base = sum(self._compiles.values())

    def compile_count_since_warm(self) -> int:
        """First uses paid after the warmup: a warm Scheduler re-entering
        service keeps this at 0."""
        with self._lock:
            return sum(self._compiles.values()) - self._warm_compile_base

    # -- memory watermark ----------------------------------------------------

    def note_resident(self, group: str, nbytes: int, record=None) -> None:
        """Record that buffer `group` now holds `nbytes` on the device
        (0 == freed). Live bytes are the sum across groups; the
        watermark is the running max of the live total."""
        if not self.enabled:
            return
        nbytes = max(int(nbytes), 0)
        with self._lock:
            self._resident[group] = nbytes
            live = sum(self._resident.values())
            if live > self._watermark:
                self._watermark = live
        if record is not None:
            self.stamp_watermark(record)

    def stamp_watermark(self, record) -> None:
        """Fold the current live total into the wave's high-water mark."""
        if not self.enabled or record is None:
            return
        with self._lock:
            live = sum(self._resident.values())
        if live > record.mem_watermark_bytes:
            record.mem_watermark_bytes = live

    def _torch_memory_bytes(self) -> int | None:
        """torch.cuda.memory_allocated on the card the backend runs on, as
        a cross-check on the ledger; None on the CPU. The allocator's own
        count: no device read and no synchronisation."""
        dev = self.device
        if dev is None or getattr(dev, "type", None) != "cuda":
            return None
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        try:
            return int(torch.cuda.memory_allocated(dev))
        except Exception:
            return None

    # -- gauges (once per wave, from FlightRecorder.end_wave) ----------------

    def update_gauges(self) -> None:
        mem = self._series("scheduler_tpu_device_memory_bytes")
        shapes = self._series("scheduler_tpu_compiled_shapes")
        if mem is None and shapes is None:
            return
        with self._lock:
            live = sum(self._resident.values())
            shape_counts = {k: len(v) for k, v in self._shapes.items()}
        if mem is not None:
            mem.set(float(live), "ledger")
            torch_bytes = self._torch_memory_bytes()
            if torch_bytes is not None:
                mem.set(float(torch_bytes), "torch")
        if shapes is not None:
            for kernel, count in shape_counts.items():
                shapes.set(float(count), kernel)

    # -- queries / snapshots -------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            return {
                "upload_bytes_total": self._totals[UPLOAD],
                "fetch_bytes_total": self._totals[FETCH],
                "compiles_total": sum(self._compiles.values()),
                "distinct_shapes": {k: len(v)
                                    for k, v in sorted(self._shapes.items())},
                "mem_live_bytes": sum(self._resident.values()),
                "mem_watermark_bytes": self._watermark,
            }

    def snapshot(self) -> dict:
        """The /debug/devicetelemetry zpage payload (also embedded in
        the flight-recorder dump and SIGUSR1 log line)."""
        with self._lock:
            out = {
                "transfers": {
                    UPLOAD: {
                        "total_bytes": self._totals[UPLOAD],
                        "by_plane": dict(sorted(
                            self._transfers[UPLOAD].items())),
                    },
                    FETCH: {
                        "total_bytes": self._totals[FETCH],
                        "by_plane": dict(sorted(
                            self._transfers[FETCH].items())),
                    },
                },
                "compiles": {
                    "total": sum(self._compiles.values()),
                    "by_kernel": dict(sorted(self._compiles.items())),
                    "seconds_by_kernel": {
                        k: round(v, 6)
                        for k, v in sorted(self._compile_seconds.items())},
                    "distinct_shapes": {
                        k: sorted(v)
                        for k, v in sorted(self._shapes.items())},
                },
                "memory": {
                    "resident_bytes": dict(sorted(self._resident.items())),
                    "live_bytes": sum(self._resident.values()),
                    "watermark_bytes": self._watermark,
                },
            }
        torch_bytes = self._torch_memory_bytes()
        if torch_bytes is not None:
            out["memory"]["torch_memory_allocated"] = torch_bytes
        return out

    def bench_columns(self, waves: int) -> dict:
        """The three device columns of the reference's bench rows (lower
        is better for all three)."""
        with self._lock:
            upload = self._totals[UPLOAD]
            compiles = sum(self._compiles.values())
            watermark = self._watermark
        return {
            "upload_bytes_per_wave": int(round(upload / waves)) if waves else 0,
            "compile_count": compiles,
            "mem_watermark_bytes": watermark,
        }
