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
first-use tracker, keyed on each call site's static configuration and
the scan's launch plan) opens after it. The warm launches take the real
path at the store's node bucket, so they run the instance the plan picks
there (`ops.kernels.scan_plan`): K2's single block up to 16384 slots, its
cluster route past them (past the card's largest cluster, its passes), and
K5's per-row blocks for each warmed gang shape (a fallback row over every
node takes a cluster past 16384 nodes).

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/warmup.py) for torch, with four departures:

- each bucket's first round starts from a dropped carry, so it is a
  cold-carry launch. The reference's first round of every bucket past the
  first chains on the previous bucket's carry, so the cold-carry launch of
  those buckets, which the first real wave after start() makes, is never
  warmed (its compile_count_since_warm() is 1 after that wave);
- the warm pods take the namespace, labels, topology spread constraints
  and affinity of a pending pod when the caller passes one (`template`;
  Scheduler._run_warmup passes the oldest pending pod in the store), else
  the reference's label-less pods in `default`. System-default spread
  interns a (namespace, selector) pair per label set, so the first label
  set the vocabulary has not seen (SchedulingBasic's `app: perf` after
  label-less warm pods, over an empty backlog) grows the selector bucket
  S to the next power of two and meets plane shapes of its own. The
  reference's warm start leaves those first uses to the first labelled
  waves; this one repeats every warm launch at that grown bucket too, on
  device inputs it owns (the mirror's planes with sel_counts padded by
  zero columns, and a host planes view of the same shapes), so traffic
  that arrives after start() meets none (ROADMAP C16);
- the planes are synced against the snapshot before the first warm pod
  registers, so the running pods' terms intern their topology keys first,
  in the order the cluster holds them, and the template's keys take the
  slots the cluster's vocabulary leaves them (any number of keys, scored
  resources and shape points launches: a profile scoring ten resources
  over a 21-point shape, or a fleet of 20 or 40 keys, warms the launches
  its waves make);
- only `OutOfSlice` (a bucket or shape this configuration refuses) is
  recorded in `summary["skipped"]` and passed over. A failed build, a
  failed library load or a launch error raises out of `start()`: a kernel
  that fails must not stay hidden until the first real wave.

Over several cards (a MeshContext whose mesh spans them) the warm
launches are the card level's: K1 and K6 on every card through the real
launch/collect path, K4 through `run`, K3 on every card's range of rows
under the key the backend's routed scatter opens; gang shapes are skipped
(recorded in `summary["skipped"]`), since a mesh backend sends every gang
to the host cycle.

Warmup never touches host planes or the live rng (it draws from its own
throwaway stream), scatters device rows onto themselves (the mirror stays
byte-identical; at the grown selector bucket it scatters into its own
padded copy), and ends by dropping the carry, so the first real wave
starts from the same device state as a cold scheduler's and binds alike.
"""

from __future__ import annotations

import contextlib
import copy
import random
import time

import numpy as np
import torch

from ...ops.cards import CardTensor
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
    """Synthetic pods with the kernel configuration wave traffic launches
    with. They ride the real register path, so they must intern the SAME
    vocab entries traffic will: a namespace or label set traffic never uses
    would grow a vocabulary bucket traffic never grows. With a template pod
    they take its namespace, labels, topology spread constraints and
    affinity (so a backlog spread or anti-affine by a key of thousands of
    domains warms the launch plan its waves pick: the slot counts and the
    domain tables' placement), else they are label-less plain pods in
    `default`."""
    from dataclasses import replace

    from ...testing.wrappers import make_pod

    namespace, labels = "default", None
    if template is not None:
        namespace, labels = template.meta.namespace, template.meta.labels
    pods = [
        make_pod(f"warm-{i}", namespace=namespace, cpu="100m", mem="128Mi",
                 labels=labels)
        for i in range(n)
    ]
    if template is not None and (template.spec.topology_spread_constraints
                                 or template.spec.affinity is not None):
        for pod in pods:
            pod.spec = replace(pod.spec, affinity=template.spec.affinity,
                               topology_spread_constraints=template.spec
                               .topology_spread_constraints)
    return pods


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
        # the running pods' terms intern their keys before the warm pods'
        backend.sync(snapshot)
        _warm_launches(backend, snapshot, wave_size, rng, gang_shapes, template, summary)
        # the same launches at the selector bucket the next new label set
        # grows into (its own summary: the buckets and shapes it warmed)
        grown = {"buckets": [], "scatter": [], "gangs": [], "skipped": []}
        with _grown_selector_bucket(backend, snapshot) as s_grown:
            if s_grown is not None:
                _warm_launches(backend, snapshot, wave_size, rng, gang_shapes, template,
                               grown)
                summary["grown_selectors"] = dict(grown, S=s_grown)
        # the carry holds warmup placements no host state backs: drop it so
        # the base mirror (untouched — warmup binds nothing) stays truth
        backend.invalidate_carry()
        if backend.device.type == "cuda":
            torch.cuda.synchronize(backend.device)
    summary["launch_s"] = time.perf_counter() - t0
    summary["compiles"] = tele.compile_count() - base_compiles
    tele.mark_warm()
    return summary


def _warm_launches(backend, snapshot, wave_size: int, rng, gang_shapes, template,
                   summary: dict) -> None:
    """Every warm launch at the planes backend.sync gives: per pow2 wave
    bucket a cold-carry and a chained + replay launch_batched/collect
    round, one single-pod `run`, the K3 row buckets and one `run_gang` per
    gang shape. What a bucket or shape refuses goes to summary["skipped"]."""
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


@contextlib.contextmanager
def _grown_selector_bucket(backend, snapshot):
    """Yield the selector bucket S' that the next label set the vocabulary
    has not seen grows into (next_pow2 of one more selector), with the
    backend reading warmup-owned inputs of that width for the duration:
    backend.sync gives a view of the host planes with sel_counts padded by
    zero columns and S' in its bucket sizes (the host planes stay as they
    are), and the device mirror is a copy of the mirror's planes with
    sel_counts padded the same way (the mirror stays as it is). Yields
    None, and changes nothing, where one more selector keeps the bucket or
    there is no mirror. On exit the carry is dropped and the backend reads
    its own planes and mirror again."""
    planes = backend.sync(snapshot)
    dev = backend._device_planes
    s = planes.bucket_sizes[5]
    s_grown = next_pow2(len(backend.extractor.vocabs.selectors) + 1, 1)
    if dev is None or s_grown == s:
        yield None
        return
    view = copy.copy(planes)
    view.sel_counts = np.pad(planes.sel_counts, ((0, 0), (0, s_grown - s)))
    view.bucket_sizes = planes.bucket_sizes[:5] + (s_grown,) + planes.bucket_sizes[6:]
    pad = lambda t: torch.nn.functional.pad(t, (0, s_grown - s))  # noqa: E731
    sel = dev["sel_counts"]
    own = dict(dev, sel_counts=sel.map(pad) if isinstance(sel, CardTensor) else pad(sel))
    backend.invalidate_carry()
    saved = (backend._device_planes, backend._device_buckets, backend._pending_dirty)
    backend._device_planes, backend._device_buckets = own, view.bucket_sizes
    backend._pending_dirty = set()
    backend.sync = lambda _snapshot: view
    try:
        yield s_grown
    finally:
        backend.invalidate_carry()
        del backend.sync
        backend._device_planes, backend._device_buckets, backend._pending_dirty = saved


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
        if backend.cards > 1:
            # K3 on every card, each on its own range's rows, under the key
            # TorchBackend._scatter_cards opens
            for c in range(backend.cards):
                part = {k: dev[k].parts[c] for k in SLICE_PLANES}
                nbc = part["alloc"].shape[0]
                idx_np = (np.arange(size) % max(1, min(planes.n, nbc))).astype(np.int32)
                idx = torch.from_numpy(idx_np).to(part["alloc"].device)
                rows = {k: part[k].index_select(0, idx.long()) for k in SLICE_PLANES}
                with tel.compile_span("scatter_rows",
                                      ("scatter", planes.bucket_sizes, size, backend.cards),
                                      label=f"rows{size}/x{backend.cards}"):
                    scatter_rows(part, rows, idx)
            summary["scatter"].append(size)
            continue
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
    if backend.cards > 1:
        # a mesh backend sends every gang to the host cycle (gangplanner)
        summary["skipped"].append(f"gang{shape}: the host cycle on a mesh")
        return
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
