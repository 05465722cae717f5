"""K1 static_parts and K3 scatter_rows: their launch plans, and K1's plain
version against the reference's JAX kernel at the gang path's shape.

The CUDA kernels run only on a card. What they compute per element is the
plain version's (held against JAX here and in test_torch_kernels.py); how
their threads split the work is the plan the wrappers compute in Python
(kernels.static_plan, kernels.scatter_plan) and hand to the kernel. These
tests walk each plan as the kernel's threads do: K1's blocks must cover
every (output row, node) pair exactly once within their shared memory,
and K3's threads, each copying its units as the kernel does, must give
scatter_rows_ref's planes and JAX _scatter_rows_jit's on every plane.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
from kubernetes_tpu.api.resource import ResourceNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import stack_features
from kubernetes_tpu.scheduler.cache.cache import Cache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, _scatter_rows_jit
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    SLICE_PLANES,
    features_from_reference,
    planes_from_reference,
)
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

# --- K1's plan ---------------------------------------------------------------


def _walk_static_plan(plan, n_out, nb):
    """How often the kernel's threads write each (output row, node) pair:
    block (bx, by) takes rows [by * chunk, +chunk) of n_out, warp w of it
    rows w, w + warps, ..., and lane l of every warp nodes bx * K1_TILE +
    K1_NPT * l + q, q < K1_NPT, of nb."""
    npt = tk.K1_NPT
    warps = plan.threads // 32
    count = np.zeros((n_out, nb), np.int32)
    lanes = (npt * np.arange(32)[:, None] + np.arange(npt)[None, :]).reshape(-1)
    for bx in range(plan.grid[0]):
        nodes = bx * tk.K1_TILE + lanes
        nodes = nodes[nodes < nb]
        for by in range(plan.grid[1]):
            n_rows = min(plan.chunk, n_out - by * plan.chunk)
            for w in range(warps):
                rows = by * plan.chunk + np.arange(w, n_rows, warps)
                count[np.ix_(rows, nodes)] += 1
    return count


def _check_memory_plan(plan, T, Tp, W, I=1, A=1, G=1):
    """The shared memory the launch asks for holds the staged affinity
    tables, the mw-0 instance's node rows at the plan's pitches and chunk
    records of rec ints, within K1_SMEM; the instance holds the widest
    vocabulary in registers (mw) or takes runtime widths (0); each pitch
    is odd (a warp's reads over 32 banks) or 0 (read from device memory)
    and fits its plane's row."""
    words = (2 * A * G * plan.tab + tk.K1_TILE * sum(plan.pitch)
             + plan.chunk * plan.rec)
    assert plan.smem == 4 * words <= tk.K1_SMEM
    assert plan.tab == (A * G <= min(tk.K1_TAB, tk.K1_TAB_PER_THREAD * plan.threads))
    if plan.mw:
        assert max(T, Tp, W, I) <= plan.mw and plan.pitch == (0, 0, 0)
        assert plan.rec == 3 * plan.mw + 14
    else:
        assert max(T, Tp, W, I) > tk.K1_REG_WIDTH
        assert plan.rec in (0, T + Tp + W + 14)
    for pitch, width in zip(plan.pitch, (T, Tp, W)):
        assert pitch == 0 or (pitch % 2 == 1 and pitch >= width)


@pytest.mark.parametrize("nb", [8, 512, 8192, 32768])
@pytest.mark.parametrize("n_out", [1, 3, 4, 8, 128, 512])
def test_static_plan_covers_every_pair_once(n_out, nb):
    """K1's default plan at the paths' shapes (8 signature rows, gangs of 4
    and 128, a 512-pod wave; buckets of 8 to 32768 rows): every (row,
    node) pair written by exactly one thread, the grid the launcher
    computes (ceil(Nb / tile) x ceil(P / chunk)), one record per row."""
    plan = tk.static_plan(n_out, nb, 1, 1, 1, 1, 1, 1)
    assert plan.mw == 1
    assert plan.grid == (-(-nb // tk.K1_TILE), -(-n_out // plan.chunk))
    assert plan.threads == 32 * min(tk.K1_WARPS, n_out)
    assert (_walk_static_plan(plan, n_out, nb) == 1).all()
    _check_memory_plan(plan, 1, 1, 1)


@pytest.mark.parametrize("tables", [(1, 1), (4, 64), (64, 64)])
@pytest.mark.parametrize("widths", [(2, 1, 1, 1), (4, 4, 2, 1), (1, 1, 1, 8), (8, 8, 4, 2),
                                    (64, 32, 16, 4), (4096, 4096, 64, 64)])
@pytest.mark.parametrize("n_out,nb", [(8, 8192), (128, 8192), (512, 512), (3, 32768)])
def test_static_plan_holds_wide_vocabularies(widths, tables, n_out, nb):
    """Wider taint, prefer-taint, port and image vocabularies (the plane
    builder's pow2 buckets) and affinity tables past K1_TAB fit the plan's shared
    memory by the runtime-width instance, fewer rows per block, or node
    rows, records and tables read from device memory — never a refusal —
    and the blocks still cover every pair once."""
    T, Tp, W, I = widths
    plan = tk.static_plan(n_out, nb, T, Tp, W, I, *tables)
    _check_memory_plan(plan, T, Tp, W, I, *tables)
    assert (_walk_static_plan(plan, n_out, nb) == 1).all()
    if T + Tp + W < 64:
        assert plan.rec > 0 and (plan.mw or plan.pitch != (0, 0, 0))
    assert plan.mw == (tk.K1_REG_WIDTH if max(widths) <= tk.K1_REG_WIDTH else 0)


# The crafted planes chip_smoke.py's phase 4 holds K1 on (P 37, a 1024-row
# bucket): (T, Tp, W, I, A, G) and the instance static_plan picks, (mw,
# tables in shared memory, node rows in shared memory, records staged).
# With the planes one element off their allocation (the wrapper's vec 0)
# each runs the K1_ANY instance of its mw.
K1_CRAFTED = [
    ((8, 16, 4, 8, 4, 64), (0, True, True, True)),
    ((2, 2, 1, 2, 3, 2048), (0, False, True, True)),
    ((200, 3, 2, 2, 2, 16), (0, True, False, True)),
    ((4096, 4096, 4096, 2, 2, 16), (0, True, False, False)),
    ((1, 1, 1, 1, 4, 64), (1, True, False, True)),
    ((1, 1, 1, 1, 1, 8192), (1, False, False, True)),
    ((1, 1, 1, 1, 3, 2048), (1, False, False, True)),
]


@pytest.mark.parametrize("widths,instance", K1_CRAFTED,
                         ids=["-".join(map(str, w)) for w, _ in K1_CRAFTED])
def test_static_plan_reaches_each_instance(widths, instance):
    """The crafted cases reach what they are meant to: runtime widths with
    node rows and records in shared memory, node rows from device memory,
    rows and records both from device memory; one-entry rows in registers
    with the tables staged, one signature's entries, or tables per pod; and
    each plan covers every pair once."""
    T, Tp, W, I, A, G = widths
    plan = tk.static_plan(37, 1024, T, Tp, W, I, A, G)
    assert (plan.mw, plan.tab, plan.pitch != (0, 0, 0), plan.rec > 0) == instance
    _check_memory_plan(plan, T, Tp, W, I, A, G)
    assert (_walk_static_plan(plan, 37, 1024) == 1).all()


# --- K3's plan ---------------------------------------------------------------


def _apply_scatter_plan(plan, dst, rows, idx):
    """The kernel's threads, walked: thread t takes plane k = t >>
    part_log, row i = (t & (part - 1)) >> lane_log and lane t & (lanes -
    1), and copies units lane, lane + lanes, ... of width[k] bytes from
    rows[k][i] into dst[k][idx[i]] when 0 <= idx[i] < dst rows. Checks each
    copy's alignment, and that the lane groups cover every unit of every
    row exactly once, on the way."""
    lanes = 1 << plan.lane_log
    t = np.arange(plan.n_threads)
    plane = t >> plan.part_log
    local = t & ((1 << plan.part_log) - 1)
    idx_np = idx.numpy()
    n = idx_np.size
    assert (1 << plan.part_log) >= max(32, n * lanes)
    for k, name in enumerate(dst):
        d, s = dst[name], rows[name]
        w, units = plan.width[k], plan.units[k]
        nbytes = d[0].numel() * d.element_size() if d.shape[0] else 0
        assert d.data_ptr() % w == 0 and s.data_ptr() % w == 0 and nbytes % w == 0
        assert units == (nbytes // w if d.shape[0] else 0)
        i = local[plane == k] >> plan.lane_log
        lane = local[plane == k] & (lanes - 1)
        live = i < n
        i, lane = i[live], lane[live]
        rounds = -(-units // lanes)
        if units:
            got = np.zeros((n, units), np.int32)
            for r in range(rounds):
                u = lane + r * lanes
                np.add.at(got, (i[u < units], u[u < units]), 1)
            assert (got == 1).all(), name
        row = idx_np[i]
        keep = (row >= 0) & (row < d.shape[0])
        db = d.view(torch.uint8).reshape(d.shape[0], -1)
        sb = s.view(torch.uint8).reshape(n, -1)
        for r in range(rounds):
            u = lane + r * lanes
            sel = keep & (u < units)
            for b in range(w):
                col = torch.from_numpy(u[sel] * w + b)
                db[torch.from_numpy(row[sel]), col] = sb[torch.from_numpy(i[sel]), col]


def _slice_planes(nb, seed):
    """Random planes of the 15 SLICE_PLANES at a real build's dtypes and
    widths (the reference's planes of a small mixed cluster), nb rows."""
    spec = mixed_spec(seed, 12, 4)
    cache = Cache(ResourceNames())
    for n in build_nodes(spec, jtypes, jmeta):
        cache.add_node(n)
    snap = Snapshot()
    cache.update_snapshot(snap)
    host = TPUBackend(ResourceNames()).sync(snap).as_dict()
    rng = np.random.default_rng(seed)
    out = {}
    for k in SLICE_PLANES:
        shape = (nb,) + host[k].shape[1:]
        if host[k].dtype == np.bool_:
            out[k] = rng.random(shape) < 0.5
        elif host[k].dtype == np.uint32:
            out[k] = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
        else:
            out[k] = rng.integers(-5, 1000, shape).astype(host[k].dtype)
    return out


def _off_by_one_row(t):
    """t's copy whose rows start one row past a fresh allocation (a guard
    row before and after): unaligned for the byte planes and for rows of 4
    or 8 bytes."""
    buf = torch.zeros((t.shape[0] + 2,) + tuple(t.shape[1:]), dtype=t.dtype)
    buf[1:-1] = t
    return buf[1:-1]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-row"])
@pytest.mark.parametrize("n", [1, 4, 128, 512])
def test_scatter_plan_matches_reference(n, aligned):
    """K3's plan walked over all 15 planes equals scatter_rows_ref and JAX
    _scatter_rows_jit: one row (the single-pod path), 4 and 128 rows (the
    gang path), 512 rows (a wave), with a duplicate index carrying the same
    row and an index past the end; byte planes, 16-byte rows and, off by
    one row, unaligned ones."""
    nb = 1024
    dev = _slice_planes(nb, n)
    rng = np.random.default_rng(100 + n)
    idx = np.sort(rng.choice(nb, n, replace=False)).astype(np.int32)
    src_rows = idx.copy()
    if n >= 4:
        idx[2] = idx[1]
        src_rows[2] = src_rows[1]  # a duplicate carries the same row
        idx[-1] = nb               # past the end: dropped
    rows = {k: np.ascontiguousarray(dev[k][src_rows]) for k in SLICE_PLANES}
    want = _scatter_rows_jit({k: jnp.asarray(v) for k, v in dev.items()},
                             {k: jnp.asarray(v) for k, v in rows.items()}, jnp.asarray(idx))
    got = planes_from_reference(dev, "cpu")
    ref = planes_from_reference(dev, "cpu")
    src = planes_from_reference(rows, "cpu")
    if not aligned:
        got = {k: _off_by_one_row(v) for k, v in got.items()}
        src = {k: _off_by_one_row(v) for k, v in src.items()}
    idx_t = torch.from_numpy(idx)
    plan = tk.scatter_plan(got, src, n)
    assert plan.grid[0] * plan.threads >= plan.n_threads == len(SLICE_PLANES) << plan.part_log
    _apply_scatter_plan(plan, got, src, idx_t)
    tk.scatter_rows_ref(ref, src, idx_t)
    widths = dict(zip(SLICE_PLANES, plan.width))
    assert widths["valid"] == widths["unsched"] == 1
    if aligned:
        assert 16 in plan.width
    else:
        assert widths["group_id"] == 4
    for k in SLICE_PLANES:
        w = np.asarray(want[k])
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert torch.equal(got[k], ref[k]), k
        assert np.array_equal(got[k].numpy(), w), k


def test_scatter_plan_drops_a_negative_index():
    """A negative index (the backend never passes one) is dropped by the
    walked plan as by scatter_rows_ref, where JAX would count from the
    end; a plane with no rows copies nothing."""
    nb = 64
    dev = _slice_planes(nb, 7)
    idx = torch.tensor([5, -1, 9], dtype=torch.int32)
    rows = planes_from_reference({k: v[[5, 6, 9]] for k, v in dev.items()}, "cpu")
    got = planes_from_reference(dev, "cpu")
    ref = planes_from_reference(dev, "cpu")
    _apply_scatter_plan(tk.scatter_plan(got, rows, 3), got, rows, idx)
    tk.scatter_rows_ref(ref, rows, idx)
    for k in got:
        assert torch.equal(got[k], ref[k]), k
    empty = {"valid": torch.zeros(0, dtype=torch.bool), "alloc": got["alloc"]}
    plan = tk.scatter_plan(empty, {"valid": torch.zeros(3, dtype=torch.bool),
                                   "alloc": rows["alloc"]}, 3)
    assert plan.units[0] == 0 and plan.units[1] > 0 and plan.n_threads == 2 * 32


def test_scatter_plan_block_sizes():
    """One block of the whole thread space up to SCATTER_ONE_BLOCK threads
    (one dirty row over the 15 planes: a warp a plane), blocks of
    SCATTER_BLOCK past it."""
    dev = planes_from_reference(_slice_planes(1024, 3), "cpu")
    one = tk.scatter_plan(dev, {k: v[:1] for k, v in dev.items()}, 1)
    assert one.n_threads == 32 * len(SLICE_PLANES) and one.grid == (1, 1)
    assert one.threads == one.n_threads
    wave = tk.scatter_plan(dev, {k: v[:512] for k, v in dev.items()}, 512)
    assert wave.threads == tk.SCATTER_BLOCK
    assert wave.grid == (-(-wave.n_threads // tk.SCATTER_BLOCK), 1)


@pytest.mark.parametrize("fault", ["dtype", "shape", "rows", "strided"])
def test_scatter_plan_checks_the_planes(fault):
    """The wrapper's one pass over the planes raises on a row buffer of
    another dtype, another row shape or another row count than the index,
    and on a strided plane, as the per-tensor check does."""
    dev = planes_from_reference(_slice_planes(64, 5), "cpu")
    rows = {k: v[:2].clone() for k, v in dev.items()}
    if fault == "dtype":
        rows["alloc"] = rows["alloc"].to(torch.int64)
    elif fault == "shape":
        rows["alloc"] = rows["alloc"][:, :-1].contiguous()
    elif fault == "rows":
        rows["alloc"] = rows["alloc"][:1]
    else:
        dev["alloc"] = dev["alloc"][::2]
    with pytest.raises((TypeError, ValueError)):
        tk.scatter_plan(dev, rows, 2)


# --- K1 against JAX at the gang path's shape --------------------------------


def _gang_inputs(n_nodes, mixed, seed=11):
    """The reference's planes, affinity tables and 128 members' features on
    a mixed cluster of n_nodes (NoSchedule and PreferNoSchedule taints, an
    unschedulable node, node images, disk labels for node affinity) with
    some host-port pods placed: 128 mixed members (tolerations, required
    and preferred node affinity, a name pin, host ports, images) or 128
    copies of one member."""
    spec = mixed_spec(seed, n_nodes, 128 + 16)
    pods_spec = spec["pods"]
    for s in pods_spec[128:]:
        s.update(port=8080, pin=None)  # the placed pods hold the host port
    if not mixed:
        one = dict(pods_spec[0], tolerate=True, prefer_ssd=5, image="img-a", port=0)
        pods_spec[:128] = [dict(one, name=f"m{i}") for i in range(128)]
    else:
        pods_spec[0].update(pin=f"n{n_nodes - 1}")
        pods_spec[1].update(port=8080)
        pods_spec[2].update(require_ssd=True, pin=None)
    names = ResourceNames()
    cache = Cache(names)
    nodes = build_nodes(spec, jtypes, jmeta)
    for n in nodes:
        cache.add_node(n)
    pods = build_pods(spec, jtypes, jmeta)
    backend = TPUBackend(names)
    for i, pod in enumerate(pods[128:]):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(5 * i) % n_nodes].meta.name)
    snap = Snapshot()
    cache.update_snapshot(snap)
    members = pods[:128]
    for pod in members:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = stack_features([backend.extractor.features(p, planes) for p in members])
    tables = backend.extractor.affinity_tables(planes)
    cfg = backend.kernel_config(planes, feats)
    return cfg, planes, {**planes.as_dict(), **tables}, feats


@pytest.mark.parametrize("mixed", [False, True], ids=["identical", "mixed"])
@pytest.mark.parametrize("n_nodes,nb", [(6, 8), (300, 512), (5000, 8192)])
def test_static_parts_matches_reference_on_a_gang(n_nodes, nb, mixed):
    """static_parts_ref == JAX _static_pod_parts vmapped over 128 gang
    members, every output, on buckets of 8, 512 and 8192 rows; the mixed
    members reach the taint, port, image, affinity, pin and unschedulable
    branches."""
    cfg, planes, arrays, feats = _gang_inputs(n_nodes, mixed)
    assert planes.nb == nb
    want = jax.vmap(lambda f: jk._static_pod_parts(cfg, arrays, f))(
        {k: jnp.asarray(v) for k, v in feats.items()})
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    got = tk.static_parts(dplanes, dtables, packed_f, layout)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    ok = got["static_ok"].numpy()
    assert ok.any() and not ok.all()
    if mixed:
        assert arrays["unsched"].any() and (arrays["taints"] >= 0).any()
        assert (feats["has_ports"] != 0).any() and (feats["aff_pin"] >= 0).any()
        assert (got["img"] > 0).any() and (got["taint_cnt"] > 0).any()
        assert (got["aff_raw"] > 0).any()
