"""Warm start: build, load and launch every kernel before the first real pod.

A cold scheduler pays every first use on the first wave that meets it: on
a card, the nvcc build of a library `ops/cuda.py` has not built yet (the
hash-keyed `_build/` directory), its ctypes load, the module load of the
kernel's first launch, and the pinned staging and allocator growth of the
first transfers at each shape — seconds of dead air exactly when a
restarted scheduler should be re-entering service. `warm_backend` pays
them inside `start()` instead: it builds and loads every library, then
walks the pow2 wave-size buckets through the REAL launch/collect path
(the cold-carry and the chained + cross-wave-replay launch of each
bucket), the single-pod `run` (K4), the K3 scatter row buckets and the
gang shapes the workload uses (K1 + K5), all inside a named `warmup`
recorder phase, so a warm Scheduler's steady state runs with
`compile_count_since_warm() == 0`: no compile span (the telemetry's
first-use tracker, keyed on each call site's static configuration) opens
after it.

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/warmup.py) for torch, with three departures:

- each bucket's first round starts from a dropped carry, so it is a
  cold-carry launch. The reference's first round of every bucket past the
  first chains on the previous bucket's carry, so the cold-carry launch of
  those buckets, which the first real wave after start() makes, is never
  warmed (its compile_count_since_warm() is 1 after that wave);
- the warm pods take the namespace and labels of a pending pod when the
  caller passes one (`template`; Scheduler._run_warmup passes the oldest
  pending pod in the store), else the reference's label-less pods in
  `default`. System-default spread interns a (namespace, selector) pair
  per label set: label-less warm pods intern one that labelled traffic
  never uses, so SchedulingBasic's `app: perf` pods grow the selector
  bucket on their first wave and meet plane shapes the warmup never
  launched at. With no pending pod at start() there is no shape to take,
  and traffic that arrives later meets those first uses, as the
  reference's does (ROADMAP C16);
- only `OutOfSlice` (a bucket or shape this configuration refuses) is
  recorded in `summary["skipped"]` and passed over. A failed build, a
  failed library load or a launch error raises out of `start()`: a kernel
  that fails must not stay hidden until the first real wave.

Warmup never touches host planes or the live rng (it draws from its own
throwaway stream), scatters device rows onto themselves (the mirror stays
byte-identical), and ends by dropping the carry, so the first real wave
starts from the same device state as a cold scheduler's and binds alike.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ...ops.kernels import OutOfSlice, scatter_rows
from ...ops.planes import SLICE_PLANES
from ...ops.vocab import next_pow2

# the smallest wave/scatter bucket the backend emits (pow2 floors)
_FLOOR = 8

# default gang shapes to warm: (members, n_constrained, has_fallback) —
# the plugin-less gang plan (one all-node placement as the fallback) with
# up to 4 members is the shape every topology-free PodGroup produces
DEFAULT_GANG_SHAPES = ((4, 0, True),)


def _warm_pods(n: int, template=None):
    """Synthetic pods with a plain-pod kernel configuration — the same cfg
    wave traffic launches with. They ride the real register path, so they
    must intern the SAME vocab entries traffic will: a namespace or label
    set traffic never uses would grow a vocabulary bucket traffic never
    grows. With a template pod they take its namespace and labels, else
    they are label-less in `default`."""
    from ...testing.wrappers import make_pod

    namespace, labels = "default", None
    if template is not None:
        namespace, labels = template.meta.namespace, template.meta.labels
    return [
        make_pod(f"warm-{i}", namespace=namespace, cpu="100m", mem="128Mi",
                 labels=labels)
        for i in range(n)
    ]


def _pow2_buckets(top: int) -> list[int]:
    buckets, b = [], _FLOOR
    top = max(top, _FLOOR)
    while b <= top:
        buckets.append(b)
        b *= 2
    return buckets


def _build_and_load(backend, summary: dict) -> None:
    """On a card: build every kernel library that is missing and load each
    (the reference's persistent compilation cache step); the build
    directory is the summary's cache_dir. On the CPU nothing is built."""
    if backend.device.type != "cuda":
        return
    from ...ops import cuda

    t0 = time.perf_counter()
    cuda.build_all()
    t1 = time.perf_counter()
    for name in cuda.SOURCES:
        cuda.load(name)
    summary["build_s"] = t1 - t0
    summary["load_s"] = time.perf_counter() - t1
    summary["cache_dir"] = str(cuda.BUILD_DIR)


def warm_backend(backend, snapshot, wave_size: int, rng_seed: int = 0,
                 gang_shapes=DEFAULT_GANG_SHAPES, template=None) -> dict:
    """Launch every kernel the wave pipeline reaches once per static
    configuration.

    Per pow2 bucket up to next_pow2(wave_size): TWO launch_batched/collect
    rounds from a dropped carry — the first a cold-carry launch, the second
    (same signatures, carry live) the chained + cross-wave-replay one.
    Then one single-pod `run` (K4), the K3 row buckets and one `run_gang`
    per gang shape (K1 + K5). `template` is a pending pod whose namespace
    and labels the warm pods take. Returns a summary dict."""
    summary: dict = {"buckets": [], "scatter": [], "gangs": [],
                     "skipped": [], "cache_dir": None, "compiles": 0}
    if snapshot.num_nodes() == 0:
        # nothing to launch against: bucket sizes come from the node planes
        summary["skipped"].append("no nodes in snapshot")
        backend.telemetry.mark_warm()
        return summary
    _build_and_load(backend, summary)
    tele = backend.telemetry
    base_compiles = tele.compile_count()
    rng = random.Random(rng_seed)  # throwaway: the live rng never moves
    t0 = time.perf_counter()
    with backend.recorder.phase("warmup"):
        for b in _pow2_buckets(next_pow2(max(wave_size, 1))):
            backend.invalidate_carry()
            try:
                for _ in range(2):  # cold-carry, then chained + replay
                    fl = backend.launch_batched(
                        _warm_pods(2, template), snapshot, rng=rng, pad_to=b)
                    backend.collect(fl, rng=rng)
                summary["buckets"].append(b)
            except OutOfSlice as e:
                backend.invalidate_carry()
                summary["skipped"].append(f"wave{b}: {e}")
        try:
            backend.run(_warm_pods(1, template)[0], snapshot)
        except OutOfSlice as e:
            summary["skipped"].append(f"single: {e}")
        _warm_scatter(backend, snapshot, wave_size, summary)
        for shape in gang_shapes:
            _warm_gang(backend, snapshot, shape, rng, summary, template)
        # the carry holds warmup placements no host state backs: drop it so
        # the base mirror (untouched — warmup binds nothing) stays truth
        backend.invalidate_carry()
        if backend.device.type == "cuda":
            torch.cuda.synchronize(backend.device)
    summary["launch_s"] = time.perf_counter() - t0
    summary["compiles"] = tele.compile_count() - base_compiles
    tele.mark_warm()
    return summary


def _warm_scatter(backend, snapshot, wave_size: int, summary: dict) -> None:
    """K3 at each pow2 row bucket a wave's binds can dirty, under the
    compile span the real path opens (TorchBackend.device_inputs: the key
    pads the dirty-row count to a pow2, floor 8). Each launch scatters rows
    gathered from the device planes back onto the same rows, so the mirror
    stays byte-identical."""
    planes = backend.sync(snapshot)
    dev = backend._device_planes
    if dev is None:
        summary["skipped"].append("scatter: no device planes")
        return
    tel = backend.telemetry
    # binds dirty up to ~wave_size rows between uploads; one extra bucket
    # covers a wave of stragglers accumulating on top
    for size in _pow2_buckets(2 * next_pow2(max(wave_size, 1))):
        idx_np = (np.arange(size) % planes.n).astype(np.int32)
        idx = torch.from_numpy(idx_np).to(backend.device)
        rows = {k: dev[k].index_select(0, idx.long()) for k in SLICE_PLANES}
        with tel.compile_span("scatter_rows", ("scatter", planes.bucket_sizes, size),
                              label=f"rows{size}"):
            scatter_rows(dev, rows, idx)
        summary["scatter"].append(size)


def _warm_gang(backend, snapshot, shape, rng, summary: dict, template=None) -> None:
    """One gang launch at `shape` = (members, n_constrained, has_fallback),
    as a GangPlan gives it: domain rows are all-node placements (mask
    content never changes the launch's configuration, only the row count
    does)."""
    from ..cache.snapshot import Placement

    n_pods, n_constrained, has_fallback = shape
    names = [ni.name for ni in snapshot.list_nodes()]
    placements = [Placement(f"warm-d{i}", names) for i in range(n_constrained)]
    if has_fallback:
        placements.append(Placement("warm-all", names))
    try:
        backend.run_gang(_warm_pods(n_pods, template), snapshot, placements,
                         n_constrained, bool(has_fallback), rng)
    except OutOfSlice as e:
        summary["skipped"].append(f"gang{shape}: {e}")
        return
    summary["gangs"].append(shape)
