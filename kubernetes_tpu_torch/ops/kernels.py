"""Dense scheduling kernels: plain PyTorch versions and the wrappers of
their hand-written CUDA kernels.

The reference package (kubernetes_tpu/ops/kernels.py) expresses the
scheduler's filter and score plugins as vectorized int32/float32 arithmetic
over the node axis and a wave of pods as a lax.scan. This module ports:

- static_parts  (K1, csrc/static_parts.cu) — the vmapped _static_pod_parts,
  over the wave's pods or over its signature rows only
- assign_scan   (K2, csrc/assign_scan.cu)  — _batched_assign_jit's scan:
  the non-dedup tier and the signature two-tier replay, with hard spread
  constraints and inter-pod affinity, the chained wave's cross-wave seed of
  the signature table and its device tie cursor
- scatter_rows  (K3, csrc/scatter_rows.cu) — backend._scatter_rows_jit
- fit_and_score (K4, csrc/fit_and_score.cu) — _fit_and_score_jit: one pod
  against every node, every filter (hard spread and inter-pod affinity
  included) and every score; one pod is a thread-block cluster of
  FIT_CLUSTER blocks, each owning a share of the live rows and of the
  padding (fit_partition)
- gang_assign   (K5, csrc/gang_assign.cu)  — _gang_assign_jit with
  _gang_placement_score: a gang's member scan over every placement mask at
  once (K2's step, shared) and the all-or-nothing domain pick
- sharded_assign (K6, csrc/sharded_assign.cu) — parallel/mesh.py's
  _sharded_assign_jit: K2's scan with the node axis cut into 1, 2, 4 or 8
  shards, one block of a thread-block cluster each (K2's step, shared)
- wave_fit_and_score (K7, csrc/fit_and_score.cu) — parallel/mesh.py's
  _wave_fit_and_score_jit: the pods x nodes feasible / total matrix, K4's
  device code with WAVE_FIT_CLUSTER blocks per pod

Each has a plain version beside it (`*_ref`) computing the same function
with torch ops; the plain versions take the reference's reduction scope
(LocalComm, or ShardComm for node shards). A wrapper runs the plain version only when its tensors lie
on the CPU; on CUDA tensors it launches the kernel or raises. The plain
versions are the CPU tests' subject and the chip smoke run's oracle.

Bit-exact contract (as in the reference): int32 arithmetic with FLOOR
division, float32 with the host op order (BalancedAllocation; the spread
cost), the PodTopologySpread log weight read from a float32 numpy table,
and the tie-break word stream consumed exactly as CPython randrange does.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..api.resource import CPU, MEM, PODS

MAX_NODE_SCORE = 100

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"
_STRATEGY_CODE = {LEAST_ALLOCATED: 0, MOST_ALLOCATED: 1,
                  REQUESTED_TO_CAPACITY_RATIO: 2}

# image_locality.go:34-35 thresholds, in KiB (planes carry image KiB)
_IMG_MIN_KIB = 23 * 1024
_IMG_MAX_PER_CONTAINER_KIB = 1024 * 1024

# max getrandbits(32) words one scan step may consume for its tie draw
# (CPython _randbelow rejection sampling: P(reject) < 1/2 per word). A step
# that exhausts them sets tie_overflow and the caller discards the wave.
MAX_TIE_DRAWS = 16

# no-rng sentinel: all-zero words make every draw resolve to r=0, i.e. the
# first max-score node
ZERO_TIE_WORDS = np.zeros(MAX_TIE_DRAWS, np.uint32)

_INT32_MAX = 2**31 - 1

# launches of each CUDA kernel; every wrapper adds one where it launches its
# kernel and nowhere else (count_launch; reset_launches() zeroes them). The
# count is taken under a lock, and each thread also keeps its own
# (thread_launches()): schedulers in several threads launch on one card
LAUNCHES = {"static_parts": 0, "assign_scan": 0, "scatter_rows": 0,
            "fit_and_score": 0, "gang_assign": 0, "sharded_assign": 0,
            "wave_fit_and_score": 0}
_LAUNCH_LOCK = threading.Lock()
_THREAD_LAUNCHES = threading.local()

# K6's node-shard counts: the blocks of one portable thread-block cluster
CLUSTER_SHARDS = (1, 2, 4, 8)

# Filter mask rows (first-failure priority == host plugin order); the PTS
# missing-key and skew rows (one per constraint slot) and the three
# InterPodAffinity rows follow these
FILTER_NAMES = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodePorts", "NodeResourcesFit",
)

# per_plugin rows of fit_and_score, in the reference's summation order
PLUGIN_NAMES = (
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration",
    "NodeAffinity", "PodTopologySpread", "InterPodAffinity", "ImageLocality",
)


def reset_launches() -> None:
    """Zero the global counts and the calling thread's."""
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
    _THREAD_LAUNCHES.counts = {}


def count_launch(kernel: str) -> None:
    """One launch of `kernel`: the global count and the calling thread's."""
    with _LAUNCH_LOCK:
        LAUNCHES[kernel] += 1
    counts = getattr(_THREAD_LAUNCHES, "counts", None)
    if counts is None:
        counts = _THREAD_LAUNCHES.counts = {}
    counts[kernel] = counts.get(kernel, 0) + 1


def thread_launches() -> dict:
    """The calling thread's launches by kernel since its last reset."""
    return dict(getattr(_THREAD_LAUNCHES, "counts", None) or {})


class OutOfSlice(NotImplementedError):
    """The caller asks for what this port does not compute yet: a slot or
    domain count past the kernels' fixed capacities (topology keys of more
    than 1024 domains, scan buckets past 16384 node slots, more than 8
    scored resources or 16 shape points: ROADMAP B1-B3), or an op the
    scheduler_perf harness does not build (perf/harness.py; the volume and
    claim templates, CSI nodes and resource slices are
    testing/storage_workloads.py's). Raised instead of computing an answer,
    and never routed to the host tier. A nominated pod and a pod the host
    composes (volumes, resource claims, required features, an interested
    extender) do not raise it: they take the nominee fast path and the
    hybrid route."""


# --------------------------------------------------------------------------
# reduction scope: the whole node axis, or node shards
# --------------------------------------------------------------------------
#
# The reference routes every cross-node reduction of its kernels through a
# comm object (kubernetes_tpu/ops/kernels.py:81-131): LocalComm on one
# device, AxisComm inside a shard_map over the nodes axis, where each
# reduction becomes a psum/pmax/pmin of shard partials and the winner pick
# one all_gather of per-shard tie counts. The plain versions here take the
# same argument. Their tensors always hold the whole node axis; ShardComm
# cuts it into n equal, contiguous shard ranges, reduces each range first
# and then folds the n partials in shard order, as K6's cluster of n CTAs
# does on the card; under fit_split it takes K4's partition instead (each
# block a share of the live rows and a share of the padding). Every
# reduction is a max, a min or an int32 sum, so the result is the same
# whatever the shard count or partition: the sharded scan equals the
# unsharded one bit for bit (float32 is summed only per node).


class LocalComm:
    """The whole node axis as one shard: plain reductions."""

    n_shards = 1

    def vmax(self, x: torch.Tensor) -> torch.Tensor:
        return x.max()

    def vmin(self, x: torch.Tensor) -> torch.Tensor:
        return x.min()

    def vsum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dtype=torch.int64)

    def seg(self, idx: torch.Tensor, vals: torch.Tensor, size: int) -> torch.Tensor:
        """Per-segment int32 sums of vals [Nb, ...] by segment id idx [Nb]."""
        out = torch.zeros((size,) + tuple(vals.shape[1:]), dtype=torch.int32,
                          device=vals.device)
        return out.index_add_(0, idx, vals.to(torch.int32))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Each shard's sum of x [Nb] (the reference's all_gather of the
        per-shard tie counts): [n_shards] int64."""
        return x.sum(dtype=torch.int64)[None]

    def publish(self, col: torch.Tensor, row: int) -> int:
        """col[row] as every shard learns it from the row's owner."""
        return int(col[row])

    def fit_split(self, valid: torch.Tensor) -> "LocalComm":
        """This scope over K4's partition of the node axis (one block)."""
        return self


class ShardComm(LocalComm):
    """n_shards contiguous node ranges of equal size (the reference's
    AxisComm over the nodes axis): every reduction runs per range, then
    across the ranges in shard order. With `parts`, shard r holds the row
    ranges parts[r] instead (K4's partition, fit_split): possibly uneven,
    possibly empty."""

    def __init__(self, n_shards: int, parts=None):
        if n_shards < 1:
            raise ValueError(f"{n_shards} node shards")
        self.n_shards = int(n_shards)
        self.parts = parts

    def _ranges(self, x: torch.Tensor):
        if self.parts is not None:
            return [torch.cat([x[a:b] for a, b in part]) for part in self.parts]
        nb = x.shape[0]
        if nb % self.n_shards:
            raise ValueError(f"node bucket {nb} not divisible by "
                             f"{self.n_shards} node shards")
        return x.reshape((self.n_shards, nb // self.n_shards) + tuple(x.shape[1:]))

    def _fold(self, parts, op):
        out = parts[0]
        for part in parts[1:]:
            out = op(out, part)
        return out

    def vmax(self, x):
        # a shard with no rows adds the identity: it drops out
        return self._fold([r.max() for r in self._ranges(x) if r.numel()], torch.maximum)

    def vmin(self, x):
        return self._fold([r.min() for r in self._ranges(x) if r.numel()], torch.minimum)

    def vsum(self, x):
        return self._fold([r.sum(dtype=torch.int64) for r in self._ranges(x)],
                          torch.add)

    def seg(self, idx, vals, size):
        parts = [LocalComm.seg(self, i, v, size)
                 for i, v in zip(self._ranges(idx), self._ranges(vals))]
        return self._fold(parts, torch.add)

    def gather(self, x):
        return torch.stack([r.sum(dtype=torch.int64) for r in self._ranges(x)])

    def publish(self, col, row):
        # the owner adds col[row] + 1, every other shard 0 (kernels.py:1162)
        iota = torch.arange(col.shape[0], device=col.device)
        return int(self.vsum(torch.where(iota == row, col.to(torch.int64) + 1, 0))) - 1

    def fit_split(self, valid):
        """n_shards blocks over K4's partition of the node axis, as the
        kernel cuts it for this `valid` (fit_partition)."""
        parts = fit_partition(valid.shape[0], valid_extent(valid), self.n_shards)
        return ShardComm(self.n_shards, [((lo, hi), (plo, phi))
                                         for lo, hi, plo, phi in parts])


LOCAL_COMM = LocalComm()


def valid_extent(valid: torch.Tensor) -> int:
    """One past the last valid row: K4's live extent (an invalid row joins
    none of its reductions; fit_and_score.cu finds it in its prologue)."""
    idx = torch.nonzero(valid).flatten()
    return int(idx[-1]) + 1 if idx.numel() else 0


def fit_partition(nb: int, extent: int, n_blocks: int) -> list[tuple[int, int, int, int]]:
    """K4's and K7's rows per block of one pod's cluster of n_blocks
    (csrc/fit_and_score.cu): block r owns the live rows [lo, hi) =
    [r * extent // n_blocks, (r + 1) * extent // n_blocks) and the padding
    rows [plo, phi) past the extent that bring it to ceil(nb / n_blocks)
    rows at most, so every block walks live rows once the extent reaches
    n_blocks. Together the blocks own every row once."""
    q = -(-nb // n_blocks)
    out = []
    for r in range(n_blocks):
        lo, hi = r * extent // n_blocks, (r + 1) * extent // n_blocks
        out.append((lo, hi, extent + min(r * q - lo, nb - extent),
                    extent + min((r + 1) * q - hi, nb - extent)))
    return out


@dataclass(frozen=True)
class KernelConfig:
    """Static kernel parameters (same fields as the reference's)."""

    strategy: str = LEAST_ALLOCATED
    # (resource column, weight) for the Fit score (NodeResourcesFitArgs)
    fit_resources: tuple[tuple[int, int], ...] = ((CPU, 1), (MEM, 1))
    # RequestedToCapacityRatio (utilization%, score) breakpoints
    rtc_shape: tuple[tuple[int, int], ...] = ((0, 0), (100, MAX_NODE_SCORE))
    # BalancedAllocation resource columns (exactly 2)
    balanced_resources: tuple[int, int] = (CPU, MEM)
    # plugin weights (apis/config/v1/default_plugins.go:29-73)
    weights: tuple[tuple[str, int], ...] = (
        ("TaintToleration", 3), ("NodeAffinity", 2), ("PodTopologySpread", 2),
        ("InterPodAffinity", 2),
        ("NodeResourcesFit", 1), ("NodeResourcesBalancedAllocation", 1),
        ("ImageLocality", 1),
    )
    # per-topology-key domain treatment: 0 = singleton (every domain holds
    # one node, e.g. hostname), else the padded domain-vocab size
    topo_domains: tuple[int, ...] = (16, 0)
    matmul_domain_cap: int = 2048
    max_constraints: int = 4
    # constraint slots in use by the wave (hard / soft)
    n_hard: int = 4
    n_soft: int = 4
    # inter-pod affinity statics (see the reference's KernelConfig)
    ipa_existing_anti: bool = False
    ipa_existing_pref: bool = False
    n_ipa_aff: int = 0
    n_ipa_anti: int = 0
    n_ipa_pref: int = 0
    max_ipa_terms: int = 4
    max_ipa_pref: int = 8
    ipa_ignore_preferred_existing: bool = False

    def weight(self, name: str) -> int:
        return dict(self.weights).get(name, 1)

    @property
    def ipa_active(self) -> bool:
        return (self.ipa_existing_anti or self.ipa_existing_pref
                or self.n_ipa_aff > 0 or self.n_ipa_anti > 0
                or self.n_ipa_pref > 0)


def check_slice(cfg: KernelConfig) -> None:
    """The wave scan's gate (K1 + K2): hard spread and inter-pod affinity
    are computed; raise OutOfSlice only past the kernels' fixed slot and
    domain capacities. Everything that passes is computed bit-exactly."""
    traced = min(cfg.max_constraints, max(cfg.n_hard, cfg.n_soft))
    if traced > 4:
        raise OutOfSlice(f"{traced} spread constraint slots (max 4)")
    _check_common(cfg)


def check_fit_slice(cfg: KernelConfig) -> None:
    """K4's gate: as the wave's, with the spread slot count taken from the
    feature width (K4 writes a fails row per slot)."""
    if cfg.max_constraints > 4:
        raise OutOfSlice(f"{cfg.max_constraints} spread constraint slots (max 4)")
    _check_common(cfg)


def _check_common(cfg: KernelConfig) -> None:
    if cfg.max_ipa_terms > 4 or cfg.max_ipa_pref > 8:
        raise OutOfSlice("inter-pod affinity term slots (max 4 required, "
                         "8 preferred)")
    if len(cfg.topo_domains) > 16 or any(d > 1024 for d in cfg.topo_domains):
        raise OutOfSlice(f"topology domains {cfg.topo_domains} (max 16 keys "
                         "of at most 1024 domains)")
    if cfg.strategy not in _STRATEGY_CODE:
        raise OutOfSlice(f"scoring strategy {cfg.strategy!r}")
    if not 1 <= len(cfg.fit_resources) <= 8 or not 1 <= len(cfg.rtc_shape) <= 16:
        raise OutOfSlice("fit resources (1..8) or rtc shape (1..16 points)")


def log_weight_table(nb: int) -> np.ndarray:
    """float32 log(n + 2) for n in [0, nb]: PodTopologySpread's
    topologyNormalizingWeight for a domain count n, computed once with numpy
    (np.log of a float32), as the host plugin computes it
    (kubernetes_tpu/scheduler/plugins/pod_topology_spread.py:242).

    The one exception to bit-exactness with the reference kernel: its
    jnp.log differs from this table by one ulp at 527 values of n + 2 in
    2..20001 (the first 37, 49, 179, 217), and where count * weight lands
    next to an integer the spread score differs. On 47 nodes with 379, 389
    and 374 matching pods on n0, n1 and the rest, n0 scores 67 here and in
    the host plugin, 65 in JAX fit_and_score (tests/test_torch_fit.py,
    test_spread_log_weight_follows_the_host_plugin). jnp.log is XLA's on
    the platform it runs on; the host plugin's value is the one a port
    can pin."""
    return np.log(np.arange(2, nb + 3, dtype=np.float32))


def floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """Integer floor division (jnp `//`). The CUDA kernels use floordiv()
    from csrc/common.cuh, since C's `/` truncates toward zero."""
    return torch.div(a, b, rounding_mode="floor")


# --------------------------------------------------------------------------
# K1 static_parts
# --------------------------------------------------------------------------


def _image_score(planes: dict, f: dict) -> torch.Tensor:
    """image_locality.go:93-105 over KiB totals → [P, Nb] int32."""
    img_idx = f["img_idx"]                                    # [P, 8]
    present = img_idx >= 0
    sizes = planes["image_kib"][:, img_idx.clamp(min=0).long()]   # [Nb, P, 8]
    total = torch.where(present[None], sizes, 0).sum(-1, dtype=torch.int32).T
    max_thr = _IMG_MAX_PER_CONTAINER_KIB * f["num_containers"][:, None]
    span = (max_thr - _IMG_MIN_KIB).clamp(min=1)
    mid = floordiv(MAX_NODE_SCORE * (total - _IMG_MIN_KIB), span)
    return torch.where(total < _IMG_MIN_KIB, 0,
                       torch.where(total > max_thr, MAX_NODE_SCORE, mid)
                       ).to(torch.int32).contiguous()


def static_parts_ref(planes: dict, tables: dict, f: dict) -> dict:
    """Plain version of K1: every filter/score input independent of the
    scan carry, for all pods × nodes. f is unpack_features' int32 views."""
    valid = planes["valid"]
    nb = valid.shape[0]
    iota = torch.arange(nb, dtype=torch.int32, device=valid.device)[None]
    f_unsched = planes["unsched"][None] & (f["tol_unsched"] == 0)[:, None]
    name_idx = f["name_idx"][:, None]
    f_name = (name_idx != -1) & (iota != name_idx)
    pin = f["aff_pin"][:, None]
    f_pin = (pin != -1) & (iota != pin)
    tid = planes["taints"]
    tol = (f["tol"] != 0)[:, tid.clamp(min=0).long()]         # [P, Nb, T]
    f_taint = ((tid >= 0)[None] & ~tol).any(-1)
    sig = f["aff_sig"].long()
    gid = planes["group_id"].long()
    f_aff = ~(tables["aff_match"][sig][:, gid] & tables["aff_allow"][sig])
    conflict = (planes["port_words"][None] & f["ports"][:, None]) != 0
    f_ports = (f["has_ports"] != 0)[:, None] & conflict.any(-1)
    static_ok = valid[None] & ~(f_unsched | f_name | f_pin | f_taint | f_aff
                                | f_ports)
    ptid = planes["prefer_taints"]
    tolp = (f["tol_prefer"] != 0)[:, ptid.clamp(min=0).long()]
    taint_cnt = ((ptid >= 0)[None] & ~tolp).sum(-1, dtype=torch.int32)
    return {
        "static_ok": static_ok,
        "taint_cnt": taint_cnt,
        "aff_raw": tables["aff_pref"][sig][:, gid].contiguous(),
        "aff_has_pref": tables["aff_has_pref"][sig],
        "img": _image_score(planes, f),
    }


def _field_offsets(layout, widths: dict[str, int]) -> dict[str, int]:
    """Column offsets of the named packed-feature fields, after checking
    each field's width against what the kernel will read."""
    cols = {name: (off, w) for name, off, w, _nd, _tag in layout}
    for name, want in widths.items():
        if name not in cols:
            raise ValueError(f"packed features lack {name!r}")
        if cols[name][1] != want:
            raise ValueError(f"feature {name!r} is {cols[name][1]} wide, the "
                             f"planes need {want}")
    return {name: cols[name][0] for name in widths}


def _check(t: torch.Tensor, name: str, device, dtype, shape=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# a scan's sync output (csrc/scan_step.cuh write_syncs): the counted block
# barriers, folds, cluster barriers, exchanges and tie picks, then thread
# 0's thousands of clock cycles in each of the step's 8 phases
SCAN_SYNC_WORDS = 5 + 8


def _syncs_ptr(syncs, device) -> int:
    """The pointer of a scan's sync output (int32 [SCAN_SYNC_WORDS]), or 0."""
    if syncs is None:
        return 0
    _check(syncs, "syncs", device, torch.int32, (SCAN_SYNC_WORDS,))
    return syncs.data_ptr()


def scan_floor(syncs: torch.Tensor, span: int, n_blocks: int = 1) -> None:
    """The latency floor of a scan (CUDA only, a measurement yardstick that
    no path runs): one launch that makes the counted synchronisations a
    scan wrote into `syncs` (assign_scan's, gang_assign's or
    sharded_assign's), its tie picks over the ballots of a block walking
    `span` node slots, with no node work; on one block, or on a cluster of
    n_blocks (K6's shard count)."""
    from . import cuda

    if syncs.device.type != "cuda":
        raise ValueError("scan_floor runs on cuda only")
    _check(syncs, "syncs", syncs.device, torch.int32, (SCAN_SYNC_WORDS,))
    npt = 8
    while npt * SCAN_THREADS < span:
        npt *= 2
    sink = torch.empty(1, dtype=torch.int32, device=syncs.device)
    cuda.launch_floor([int(x) for x in syncs.tolist()[:5]], npt, n_blocks, sink.data_ptr(),
                      _stream(syncs.device))


# K1's launch (csrc/static_parts.cu): nodes per lane, nodes per block (a
# warp's lanes), warps per block (each takes its own rows), the rows a warp
# takes at most before the launch adds blocks instead (the records one
# pass stages), the blocks a launch aims for, the widest vocabulary whose
# node rows ride in registers (the kernel instance MW = 1: one entry),
# the affinity-table entries staged in shared memory (in all, and a
# thread's share of the one staging pass), and the shared memory a block
# plans with (what a block takes without opting in)
K1_NPT = 4
K1_TILE = 32 * K1_NPT
K1_WARPS = 2
K1_RPW = 4  # the kernel's records per pass (csrc K1_RPW)
K1_TARGET_BLOCKS = 256
K1_REG_WIDTH = 1
K1_TAB = 1024
K1_TAB_PER_THREAD = 8  # csrc K1_TAB_PER_THREAD; the launcher refuses more
K1_SMEM = 48 * 1024


@dataclass(frozen=True)
class StaticPlan:
    """K1's launch: threads per block (32 per warp), output rows per block
    (its warps take them in turn), the kernel instance (mw: node rows of at
    most mw entries in registers, 0 runtime widths), ints per staged pod
    record (0: the feature rows are read from device memory), whether the
    affinity tables sit in shared memory, the mw-0 instance's
    shared-memory row pitch of the tile's taints, prefer_taints and
    port_words (0: read from device memory), the grid (node tiles, row
    chunks) and the shared-memory bytes."""

    threads: int
    chunk: int
    mw: int
    rec: int
    tab: bool
    pitch: tuple[int, int, int]
    grid: tuple[int, int]
    smem: int


def static_plan(n_out: int, nb: int, T: int, Tp: int, W: int, I: int, A: int,
                G: int) -> StaticPlan:
    """K1's launch plan; launch_static_parts (csrc/static_parts.cu) takes
    the grid and the shared memory from the same formulas. A block owns a
    tile of K1_TILE consecutive nodes (K1_NPT per lane) and a chunk of
    output rows, which its warps take in turn. mw: K1_REG_WIDTH when it
    holds the taint, prefer-taint, port and image vocabularies (each record
    3 * mw + 14 ints), else 0: records of T + Tp + W + 14 ints and the
    tile's node rows in shared memory at an odd pitch (a warp's reads hit
    32 banks) when they fit K1_SMEM beside one record, else read from
    device memory. The affinity tables (2 * A * G ints) sit in shared
    memory up to K1_TAB entries and K1_TAB_PER_THREAD a thread (one
    staging pass). warps: K1_WARPS, at most one per row. chunk: whole rounds of the warps, enough that the grid holds about
    K1_TARGET_BLOCKS blocks but at most K1_RPW rows a warp, and at most the
    records the rest of K1_SMEM holds (an mw-0 record too wide for it is
    read from device memory)."""
    w = min(K1_WARPS, max(1, n_out))
    words = K1_SMEM // 4
    tab = A * G <= min(K1_TAB, K1_TAB_PER_THREAD * 32 * w)
    if tab:
        words -= 2 * A * G
    mw = K1_REG_WIDTH if max(T, Tp, W, I) <= K1_REG_WIDTH else 0
    pitch = (0, 0, 0)
    if mw:
        rec = 3 * mw + 14
    else:
        rec = T + Tp + W + 14  # tol, tol_prefer, ports, img_idx, 6 scalars
        if K1_TILE * ((T | 1) + (Tp | 1) + (W | 1)) + rec <= words:
            pitch = (T | 1, Tp | 1, W | 1)
    room = words - K1_TILE * sum(pitch)
    if rec > room:
        rec = 0
    tiles = -(-nb // K1_TILE)
    c = w * min(K1_RPW, -(-n_out * tiles // (K1_TARGET_BLOCKS * w)))
    if rec:
        c = min(c, room // rec)
    c = max(1, min(c, n_out))
    return StaticPlan(threads=32 * w, chunk=c, mw=mw, rec=rec, tab=tab, pitch=pitch,
                      grid=(tiles, -(-n_out // c)),
                      smem=(2 * A * G * tab + K1_TILE * sum(pitch) + c * rec) * 4)


def static_store_floor(out: dict) -> None:
    """The store floor beside K1 (CUDA only, a measurement yardstick that no
    path runs): K1's static_ok, taint_cnt, aff_raw and img written in K1's
    layout by a kernel that reads nothing."""
    from . import cuda

    ok = out["static_ok"]
    if ok.device.type != "cuda":
        raise ValueError("static_store_floor runs on cuda only")
    n_out, nb = ok.shape
    if nb % 4:
        raise ValueError(f"static_store_floor writes 4 nodes a thread; {nb} nodes")
    for k, dt in (("static_ok", torch.bool), ("taint_cnt", torch.int32),
                  ("aff_raw", torch.int32), ("img", torch.int32)):
        _check(out[k], k, ok.device, dt, (n_out, nb))
    cuda.launch_store_floor(n_out, nb, [out[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img")], _stream(ok.device))


def static_parts(planes: dict, tables: dict, packed_f: torch.Tensor,
                 layout, rows: torch.Tensor | None = None) -> dict:
    """K1 wrapper: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors. packed_f is the wave's [P, F] int32 feature buffer; with rows
    (int32 [G], signature dedup's uniq_idx) the outputs cover those feature
    rows only, [G, ...], as the reference vmaps over uniq_f."""
    from .planes import unpack_features

    device = packed_f.device
    if device.type == "cpu":
        f_rows = packed_f if rows is None else packed_f[rows.long()]
        return static_parts_ref(planes, tables, unpack_features(f_rows, layout))
    if device.type != "cuda":
        raise ValueError(f"static_parts runs on cpu or cuda, not {device}")
    from . import cuda

    P, F = packed_f.shape
    if rows is not None:
        _check(rows, "rows", device, torch.int32)
        if rows.dim() != 1:
            raise ValueError("rows must be one-dimensional")
    n_out = P if rows is None else rows.shape[0]
    nb = planes["valid"].shape[0]
    T = planes["taints"].shape[1]
    Tp = planes["prefer_taints"].shape[1]
    W = planes["port_words"].shape[1]
    I = planes["image_kib"].shape[1]
    A, G = tables["aff_match"].shape
    i32, b8 = torch.int32, torch.bool
    _check(packed_f, "packed features", device, i32)
    for name, dt, shape in (
        ("valid", b8, (nb,)), ("unsched", b8, (nb,)), ("group_id", i32, (nb,)),
        ("taints", i32, (nb, T)), ("prefer_taints", i32, (nb, Tp)),
        ("port_words", i32, (nb, W)), ("image_kib", i32, (nb, I)),
    ):
        _check(planes[name], name, device, dt, shape)
    for name, dt, shape in (
        ("aff_match", b8, (A, G)), ("aff_pref", i32, (A, G)),
        ("aff_allow", b8, (A, nb)), ("aff_has_pref", b8, (A,)),
    ):
        _check(tables[name], name, device, dt, shape)
    offs = _field_offsets(layout, {
        "tol_unsched": 1, "name_idx": 1, "aff_pin": 1, "tol": T, "aff_sig": 1,
        "ports": W, "has_ports": 1, "tol_prefer": Tp, "img_idx": 8,
        "num_containers": 1})
    out = {
        "static_ok": torch.empty((n_out, nb), dtype=b8, device=device),
        "taint_cnt": torch.empty((n_out, nb), dtype=i32, device=device),
        "aff_raw": torch.empty((n_out, nb), dtype=i32, device=device),
        "aff_has_pref": torch.empty((n_out,), dtype=b8, device=device),
        "img": torch.empty((n_out, nb), dtype=i32, device=device),
    }
    plan = static_plan(n_out, nb, T, Tp, W, I, A, G)
    # 4-node vectors: 4-byte bool rows, 16-byte int32 rows (and, one entry
    # a row, the node planes' rows)
    vec = nb % K1_NPT == 0 and all(t.data_ptr() % a == 0 for t, a in (
        (planes["valid"], 4), (planes["unsched"], 4), (planes["group_id"], 16),
        (planes["taints"], 16), (planes["prefer_taints"], 16), (planes["port_words"], 16),
        (planes["image_kib"], 16), (tables["aff_allow"], 4), (out["static_ok"], 4),
        (out["taint_cnt"], 16), (out["aff_raw"], 16), (out["img"], 16)))
    p = cuda.StaticParams(P=n_out, P_feats=P, Nb=nb, T=T, Tp=Tp, W=W, I=I, A=A,
                          G=G, F=F, **{f"f_{k}": v for k, v in offs.items()},
                          threads=plan.threads, chunk=plan.chunk, mw=plan.mw,
                          rec=plan.rec, tab=int(plan.tab), pitch_t=plan.pitch[0],
                          pitch_tp=plan.pitch[1],
                          pitch_w=plan.pitch[2], vec=int(vec))
    ptrs = [planes[k].data_ptr() for k in (
        "valid", "unsched", "group_id", "taints", "prefer_taints",
        "port_words", "image_kib")]
    ptrs += [tables[k].data_ptr() for k in (
        "aff_match", "aff_pref", "aff_allow", "aff_has_pref")]
    ptrs += [packed_f.data_ptr(), 0 if rows is None else rows.data_ptr()]
    ptrs += [out[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img", "aff_has_pref")]
    if n_out and nb:
        cuda.launch("static_parts", p, ptrs, _stream(device))
        count_launch("static_parts")
    return out


# --------------------------------------------------------------------------
# K2 assign_scan
# --------------------------------------------------------------------------


def _requested_for(used, nz_used, req, nz_req, col):
    """Requested-including-pod per node; cpu/mem use NonZero accounting
    (resource_allocation.go:138). req [R] / nz_req [2] for one pod, or one
    request per row ([rows, R] / [rows, 2]) against broadcast node rows."""
    if col == CPU:
        return nz_used[:, 0] + nz_req[..., 0]
    if col == MEM:
        return nz_used[:, 1] + nz_req[..., 1]
    return used[:, col] + req[..., col]


def _strategy_score(cfg: KernelConfig, requested, capacity):
    """least_allocated.go:30-52, most_allocated.go, and the RTC piecewise
    line (requested_to_capacity_ratio.go), int32 with floor division."""
    cap = capacity.clamp(min=1)
    if cfg.strategy == LEAST_ALLOCATED:
        return floordiv((cap - requested) * MAX_NODE_SCORE, cap)
    if cfg.strategy == MOST_ALLOCATED:
        return floordiv(requested * MAX_NODE_SCORE, cap)
    util = floordiv(requested * 100, cap)
    shape = cfg.rtc_shape
    out = torch.full_like(requested, shape[-1][1])
    for (x0, y0), (x1, y1) in reversed(list(zip(shape, shape[1:]))):
        seg = (torch.full_like(util, y1) if x1 == x0
               else y0 + floordiv((y1 - y0) * (util - x0), x1 - x0))
        out = torch.where(util <= x1, seg, out)
    return torch.where(util <= shape[0][0], shape[0][1], out)


def _fit_score(cfg, alloc, used, nz_used, req, nz_req):
    """resource_allocation.go:52 — weighted mean of strategy scores over the
    resources a node has."""
    total = torch.zeros(alloc.shape[0], dtype=torch.int32, device=alloc.device)
    tw = torch.zeros_like(total)
    for col, w in cfg.fit_resources:
        a = alloc[:, col]
        ok = a > 0
        requested = torch.minimum(_requested_for(used, nz_used, req, nz_req, col), a)
        s = _strategy_score(cfg, requested, a)
        total = total + torch.where(ok, s * w, 0)
        tw = tw + ok.to(torch.int32) * w
    return torch.where(tw > 0, floordiv(total, tw.clamp(min=1)), 0)


def _balanced_score(cfg, alloc, used, nz_used, req, nz_req):
    """balanced_allocation.go:204-230 in float32, one rounding per op. sqrt
    is taken in float64 and rounded once to float32 (correctly rounded;
    torch's CPU float32 sqrt is not)."""
    ca, cb = cfg.balanced_resources
    f32 = torch.float32
    fa = (_requested_for(used, nz_used, req, nz_req, ca).to(f32)
          / alloc[:, ca].clamp(min=1).to(f32)).clamp(max=1.0)
    fb = (_requested_for(used, nz_used, req, nz_req, cb).to(f32)
          / alloc[:, cb].clamp(min=1).to(f32)).clamp(max=1.0)
    mean = (fa + fb) / 2.0
    da = fa - mean
    db = fb - mean
    var = (da * da + db * db) / 2.0
    std = torch.sqrt(var.to(torch.float64)).to(f32)
    score = ((1.0 - std) * float(MAX_NODE_SCORE)).to(torch.int32)
    both = (alloc[:, ca] > 0) & (alloc[:, cb] > 0)
    return torch.where(both, score, 0)


def _fit_fail(alloc, used, req):
    """NodeResourcesFit's filter on the carried `used` (kernels.py:1068-1072;
    on one node row it is _fit_filter_row, :914): [rows] bool. req is one
    pod's [R], or one request per row [rows, R] against broadcast rows."""
    insufficient = (req > 0) & (req > alloc - used)
    insufficient[..., PODS] = False
    too_many = used[:, PODS] + 1 > alloc[:, PODS]
    return insufficient.any(-1) | too_many


def _pts_domain_stats(cfg, domain, sel_counts, mask, key_i: int, sel_i: int,
                      dseg: int = 0, comm=LOCAL_COMM):
    """One spread constraint's domain statistics (kernels.py:198):
    (has_key [Nb], count_at_node [Nb], min_count, ndom), the last two
    0-dim tensors. `mask` selects the participating nodes: every valid node
    for the hard filter (PreFilter), the feasible nodes for the soft score
    (PreScore). count_at_node means something only where mask & has_key.
    Per-domain sums are exact int32 (index_add_); a key slot outside the
    planes matches no node, as the reference's per-key select finds none.
    With dseg > 0 also the per-domain (segment count, participant count)
    tables padded to dseg, as the signature scan captures them: zeros for
    a singleton key or a key outside the planes."""
    nb, dev = domain.shape[0], domain.device
    zseg = torch.zeros(max(dseg, 1), dtype=torch.int32, device=dev)
    tables = (zseg, zseg.clone()) if dseg else ()
    if not 0 <= key_i < domain.shape[1]:
        z = torch.zeros(nb, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return (z.bool(), z, zero, zero) + tables
    cnt = sel_counts[:, sel_i]
    dom = domain[:, key_i]
    has_key = dom >= 0
    part = mask & has_key
    dk = cfg.topo_domains[key_i]
    if dk == 0:  # singleton key (hostname): the domain is the node
        count = cnt
        min_c = torch.where(comm.vmax(part),
                            comm.vmin(torch.where(part, cnt, _INT32_MAX)), 0)
        ndom = comm.vsum(part)
    else:
        dom_c = dom.clamp(0, dk - 1).long()
        seg = comm.seg(dom_c, torch.where(part, cnt, 0), dk)
        pc = comm.seg(dom_c, part, dk)
        present = pc > 0
        count = seg[dom_c]
        min_c = torch.where(present.any(), torch.where(present, seg, _INT32_MAX).min(), 0)
        ndom = present.sum()
        if dseg:
            tables[0][:dk], tables[1][:dk] = seg, pc
    return (has_key, count, min_c, ndom) + tables


def _pts_normalize(raw, any_active, feasible, comm=LOCAL_COMM):
    """scoring.go:266-305: inverted min/max normalization over the feasible
    set (kernels.py:614). int32 throughout: with no feasible node the
    spread wraps as the reference's does."""
    mx = comm.vmax(torch.where(feasible, raw, -_INT32_MAX))
    mn = comm.vmin(torch.where(feasible, raw, _INT32_MAX))
    spread = mx - mn
    normed = torch.where(spread == 0, MAX_NODE_SCORE,
                         floordiv((mx - raw) * MAX_NODE_SCORE, spread.clamp(min=1)))
    return torch.where(any_active, normed, 0)


def _pts_score_core(cfg, domain, sel_counts, feasible, f, p, logtab,
                    capture=None, comm=LOCAL_COMM):
    """podtopologyspread scoring.go:118-305 over the live feasible set
    (kernels.py:630): per-domain counts weighted by log(domains + 2),
    inverted min/max normalization. Returns (score [Nb], segs, pcs): with
    capture = (slots, dseg), segs/pcs [slots, dseg] hold every traced
    slot's per-domain tables (inactive slots too, from their key and
    selector columns), as the signature scan captures them; else None."""
    nb = feasible.shape[0]
    dev = feasible.device
    segs = pcs = None
    if capture is not None:
        segs = torch.zeros(capture, dtype=torch.int32, device=dev)
        pcs = torch.zeros(capture, dtype=torch.int32, device=dev)
    if cfg.n_soft == 0:
        return torch.zeros(nb, dtype=torch.int32, device=dev), segs, pcs
    active = f["soft_active"][p] != 0
    cost = torch.zeros(nb, dtype=torch.float32, device=dev)
    for c in range(min(cfg.max_constraints, cfg.n_soft)):
        on = bool(active[c])
        if not on and capture is None:
            continue  # the reference adds +0.0 for an inactive slot
        stats = _pts_domain_stats(
            cfg, domain, sel_counts, feasible, int(f["soft_key"][p, c]),
            int(f["soft_sel"][p, c]), dseg=0 if capture is None else capture[1],
            comm=comm)
        if capture is not None:
            segs[c], pcs[c] = stats[4], stats[5]
        if on:
            has_key, count, _, nd = stats[:4]
            cost = cost + torch.where(has_key, count.to(torch.float32) * logtab[nd], 0.0)
    return _pts_normalize(cost.to(torch.int32), active.any(), feasible, comm), segs, pcs


def _pts_score(cfg, domain, sel_counts, feasible, f, p, logtab, comm=LOCAL_COMM):
    return _pts_score_core(cfg, domain, sel_counts, feasible, f, p, logtab,
                           comm=comm)[0]


def _pts_score_carried(cfg, domain, sel_counts, feasible, f, p, logtab, segs, pcs,
                       comm=LOCAL_COMM):
    """The spread score of a replayed step (kernels.py:673) from the
    signature's carried per-domain tables: a singleton key reads the live
    sel_counts and counts its domains over the feasible set, any other key
    gathers from segs and counts the domains with pcs > 0. Against the
    same feasible set it equals _pts_score_core bit for bit."""
    nb = feasible.shape[0]
    dev = feasible.device
    if cfg.n_soft == 0:
        return torch.zeros(nb, dtype=torch.int32, device=dev)
    dseg = segs.shape[1]
    active = f["soft_active"][p] != 0
    cost = torch.zeros(nb, dtype=torch.float32, device=dev)
    for c in range(min(cfg.max_constraints, cfg.n_soft)):
        key_i = int(f["soft_key"][p, c])
        if not bool(active[c]) or not 0 <= key_i < domain.shape[1]:
            continue  # adds +0.0: no slot, or no node has the key
        dom = domain[:, key_i]
        has_key = dom >= 0
        if cfg.topo_domains[key_i] == 0:
            count = sel_counts[:, int(f["soft_sel"][p, c])]
            nd = comm.vsum(feasible & has_key)
        else:
            count = segs[c][dom.clamp(0, dseg - 1).long()]
            nd = (pcs[c] > 0).sum()
        cost = cost + torch.where(has_key, count.to(torch.float32) * logtab[nd], 0.0)
    return _pts_normalize(cost.to(torch.int32), active.any(), feasible, comm)


_POW2 = 2 ** torch.arange(32, dtype=torch.int64)


def _bit_length(n: torch.Tensor) -> torch.Tensor:
    """int.bit_length of a positive int64 scalar by comparisons (torch has
    no count-leading-zeros)."""
    return (n >= _POW2.to(n.device)).sum()


def dedup_fast_capable(cfg: KernelConfig) -> bool:
    """Whether the two-tier signature replay applies (kernels.py:1253): it
    does for every configuration the scan computes. The carry-dependent
    masks the winner-column patch cannot track (hard spread, inter-pod
    affinity) are recomputed each step and a replay is taken only where the
    resident row's feasibility equals the live one."""
    del cfg
    return True


def _dom_counts_init(cfg: KernelConfig, planes: dict, comm=LOCAL_COMM):
    """The hard-spread carry (kernels.py:820): dom_counts [K, Dmax, S], the
    sum of sel_counts over each domain's valid nodes carrying the key, and
    the static present [K, Dmax]; (None, None) without hard slots or
    without a non-singleton key."""
    dmax = max((dk for dk in cfg.topo_domains if dk > 0), default=0)
    if dmax == 0 or cfg.n_hard == 0:
        return None, None
    valid, domain, sel = planes["valid"], planes["domain"], planes["sel_counts"]
    K, dev = len(cfg.topo_domains), valid.device
    counts = torch.zeros((K, dmax, sel.shape[1]), dtype=torch.int32, device=dev)
    present = torch.zeros((K, dmax), dtype=torch.bool, device=dev)
    for k, dk in enumerate(cfg.topo_domains):
        if dk == 0:
            continue
        dom = domain[:, k]
        part = valid & (dom >= 0)
        dom_c = dom.clamp(0, dk - 1).long()
        counts[k, :dk] = comm.seg(dom_c, torch.where(part[:, None], sel, 0), dk)
        present[k, :dk] = comm.seg(dom_c, part, dk) > 0
    return counts, present


def _pts_hard_carried(cfg, planes, sel_counts, dom_counts, present,
                      key_i: int, sel_i: int, comm=LOCAL_COMM):
    """A hard constraint's (has_key, count_at_node, min_count) from the
    carried dom_counts (kernels.py:855): a singleton key takes the min over
    the valid nodes carrying it, any other key over its present domains."""
    domain = planes["domain"]
    nb = domain.shape[0]
    if not 0 <= key_i < domain.shape[1]:
        z = torch.zeros(nb, dtype=torch.int32, device=domain.device)
        return z.bool(), z, 0
    dom = domain[:, key_i]
    has_key = dom >= 0
    if cfg.topo_domains[key_i] == 0:
        cnt = sel_counts[:, sel_i]
        part = planes["valid"] & has_key
        return has_key, cnt, torch.where(
            comm.vmax(part), comm.vmin(torch.where(part, cnt, _INT32_MAX)), 0)
    seg = dom_counts[key_i][:, sel_i]
    pres = present[key_i]
    return (has_key, seg[dom.clamp(0, dom_counts.shape[1] - 1).long()],
            torch.where(pres.any(), torch.where(pres, seg, _INT32_MAX).min(), 0))


def _live_fail(cfg, live: dict, fp: dict, dom_counts, present, comm=LOCAL_COMM):
    """The carry-dependent filters of a scan step (kernels.py:974-1003,
    :1073-1094), OR-ed into one [Nb] reject row: each active hard spread
    slot (missing key, or skew over maxSkew) and InterPodAffinity's three
    checks. live holds the carried planes of this step."""
    fail = torch.zeros_like(live["valid"])
    for c in range(min(cfg.max_constraints, cfg.n_hard)):
        if not bool(fp["hard_active"][c]):
            continue
        key_i, sel_i = int(fp["hard_key"][c]), int(fp["hard_sel"][c])
        if dom_counts is not None:
            has_key, count, min_c = _pts_hard_carried(
                cfg, live, live["sel_counts"], dom_counts, present, key_i, sel_i, comm)
        else:
            has_key, count, min_c, _ = _pts_domain_stats(
                cfg, live["domain"], live["sel_counts"], live["valid"], key_i, sel_i,
                comm=comm)
        skew = count + fp["hard_self"][c] - min_c
        fail = fail | ~has_key | (skew > fp["hard_skew"][c])
    if cfg.ipa_active:
        for row in _ipa_filters(cfg, live, fp, comm):
            fail = fail | row
    return fail


def _finish_total(cfg, ew, pts, static: dict, s: int, feasible, comm=LOCAL_COMM):
    """kernels.py:887: the fit + balanced partial, the spread score and the
    static raws of static row s normalized over the live feasible set."""
    tc = static["taint_cnt"][s]
    max_tc = comm.vmax(torch.where(feasible, tc, 0))
    taint = torch.where(max_tc > 0, MAX_NODE_SCORE - floordiv(
        tc * MAX_NODE_SCORE, max_tc.clamp(min=1)), MAX_NODE_SCORE)
    ar = static["aff_raw"][s]
    mx_aff = comm.vmax(torch.where(feasible, ar, 0))
    aff = torch.where(mx_aff > 0, floordiv(ar * MAX_NODE_SCORE, mx_aff.clamp(min=1)), ar)
    return (ew + pts * cfg.weight("PodTopologySpread")
            + static["img"][s] * cfg.weight("ImageLocality")
            + taint * cfg.weight("TaintToleration")
            + torch.where(static["aff_has_pref"][s], aff, 0) * cfg.weight("NodeAffinity"))


def _tie_draw(nw: int, words, cursor: int, draw_slots):
    """CPython randrange(nw) on the cloned word stream: the top k =
    nw.bit_length() bits of successive words, reject r >= nw, at most
    MAX_TIE_DRAWS words, reads clamped to the stream's end. Returns
    (r, new cursor, overflowed)."""
    if nw <= 1:
        return 0, cursor, False
    k = _bit_length(torch.tensor(nw, dtype=torch.int64, device=words.device))
    r = words[(cursor + draw_slots).clamp(0, words.shape[0] - 1)] >> (32 - k)
    accept = r < nw
    if not bool(accept.any()):
        return 0, cursor + MAX_TIE_DRAWS, True
    first = int(accept.to(torch.int32).argmax())
    return int(r[first]), cursor + first + 1, False


def _patch_rows(cfg, planes, live, tab, uf, static, win: int, sel_prev,
                comm=LOCAL_COMM):
    """kernels.py:1174-1237: after a placement at `win`, every resident
    signature row takes that column's new fit score, fit filter and
    feasibility (from the updated used row and the signature's own
    request), and each traced soft slot's tables the winner's delta at its
    domain of the slot's key. No soft_active check: the tables of an
    inactive slot move too, as the reference's do."""
    sl = slice(win, win + 1)
    alloc_w, used_w, nz_w = planes["alloc"][sl], live["used"][sl], live["nonzero_used"][sl]
    ew_w = (_fit_score(cfg, alloc_w, used_w, nz_w, uf["req"], uf["nz_req"])
            * cfg.weight("NodeResourcesFit")
            + _balanced_score(cfg, alloc_w, used_w, nz_w, uf["req"], uf["nz_req"])
            * cfg.weight("NodeResourcesBalancedAllocation"))
    ffit_w = _fit_fail(alloc_w, used_w, uf["req"])
    feas_w = static["static_ok"][:, win] & ~ffit_w
    ok = tab["valid"]
    feas_old = tab["feas"][:, win].clone()
    tab["ew"][:, win] = torch.where(ok, ew_w, tab["ew"][:, win])
    tab["ffit"][:, win] = torch.where(ok, ffit_w, tab["ffit"][:, win])
    tab["feas"][:, win] = torch.where(ok, feas_w, feas_old)
    dseg = tab["segs"].shape[2]
    sel_new = live["sel_counts"][win]
    for c in range(min(cfg.max_constraints, cfg.n_soft)):
        key_c = uf["soft_key"][:, c]
        sel_c = uf["soft_sel"][:, c].long()
        seg_d = (torch.where(feas_w, sel_new[sel_c], 0)
                 - torch.where(feas_old, sel_prev[sel_c], 0))
        pc_d = feas_w.to(torch.int32) - feas_old.to(torch.int32)
        for k, dk in enumerate(cfg.topo_domains):
            if dk == 0:
                continue  # singleton keys replay from sel_counts directly
            d = comm.publish(planes["domain"][:, k], win)
            if d < 0:
                continue
            in_k = ok & (key_c == k)
            d = min(d, dseg - 1)
            tab["segs"][:, c, d] += torch.where(in_k, seg_d, 0)
            tab["pcs"][:, c, d] += torch.where(in_k, pc_d, 0)


def _seed_table(carry_map: torch.Tensor, sig_table: dict) -> dict:
    """The cross-wave seed (kernels.py:1314-1328): slot c copies row
    carry_map[c] of the previous wave's table where it is >= 0 (valid),
    and starts zeroed and invalid elsewhere. New tensors: the previous
    table is never aliased."""
    ok = carry_map >= 0
    m = carry_map.long().clamp(0, sig_table["ew"].shape[0] - 1)
    tab = {k: torch.where(ok.view((-1,) + (1,) * (v.dim() - 1)), v[m], torch.zeros_like(v[m]))
           for k, v in sig_table.items()}
    tab["valid"] = ok.clone()
    return tab


def assign_scan_ref(cfg: KernelConfig, planes: dict, static: dict, f: dict,
                    tie_words: torch.Tensor, cursor_init, logtab: torch.Tensor,
                    sig_ids: torch.Tensor | None = None,
                    uniq_idx: torch.Tensor | None = None, frame_shift: int = 0,
                    carry_map: torch.Tensor | None = None,
                    sig_table: dict | None = None, comm=LOCAL_COMM) -> dict:
    """Plain version of K2: a Python loop over the wave's pods following the
    reference's _assign_step (kernels.py:925-1250) branch by branch. With
    comm=ShardComm(n) it is the plain version of K6 (sharded_assign_ref):
    every pass over the nodes reduces per shard range, then across shards.

    Without sig_ids, the non-dedup tier: static row p for pod p. With
    sig_ids [P] / uniq_idx [C] (signature dedup), static holds one row per
    signature slot and the step is two-tier over a resident per-signature
    table: a signature with a resident row whose feasibility equals the
    live one (checked only with hard spread or IPA) replays it; else the
    full tier recomputes and installs it. After each placement every
    resident row is patched at the winner column.

    Cross-wave reuse (with dedup): carry_map [C] int32 and sig_table, the
    previous chained wave's {ew, ffit, feas, segs, pcs}, seed the resident
    table (_seed_table) instead of an empty one. The cursor starts at
    cursor_init (an int, or a 0-d int32 tensor: the predecessor's final
    cursor, packed[P_prev]) minus frame_shift.

    Returns the reference's output dict: packed [P + 2] int32 = winners ++
    [tie_consumed, tie_overflow]; the carried used, nonzero_used,
    sel_counts and, with IPA, ipa_counts/ipa_anti/ipa_pref (new tensors);
    with dedup also sig_scores [C, Nb], sig_table {ew, ffit, feas, segs,
    pcs} and tiers [2] int32 (steps that took the full tier, replays)."""
    alloc, domain = planes["alloc"], planes["domain"]
    dev = alloc.device
    live = dict(planes)
    carried = ["used", "nonzero_used", "sel_counts"]
    if cfg.ipa_active:
        carried += ["ipa_counts", "ipa_anti", "ipa_pref"]
    for k in carried:
        live[k] = planes[k].clone()
    dom_counts, present = _dom_counts_init(cfg, planes, comm)
    # the words as unsigned values in int64 (torch lacks uint32 shifts)
    words = tie_words.to(torch.int64) & 0xFFFFFFFF
    draw_slots = torch.arange(MAX_TIE_DRAWS, dtype=torch.int64, device=dev)
    w_fit = cfg.weight("NodeResourcesFit")
    w_bal = cfg.weight("NodeResourcesBalancedAllocation")
    gated = cfg.n_hard > 0 or cfg.ipa_active
    fast = sig_ids is not None
    if fast:
        C, nb = uniq_idx.shape[0], alloc.shape[0]
        ct = max(1, min(cfg.max_constraints, cfg.n_soft))
        dmax = max((dk for dk in cfg.topo_domains if dk > 0), default=1)
        if carry_map is not None:
            tab = _seed_table(carry_map, sig_table)
        else:
            tab = {"ew": torch.zeros((C, nb), dtype=torch.int32, device=dev),
                   "ffit": torch.zeros((C, nb), dtype=torch.bool, device=dev),
                   "feas": torch.zeros((C, nb), dtype=torch.bool, device=dev),
                   "segs": torch.zeros((C, ct, dmax), dtype=torch.int32, device=dev),
                   "pcs": torch.zeros((C, ct, dmax), dtype=torch.int32, device=dev),
                   "valid": torch.zeros(C, dtype=torch.bool, device=dev)}
        sig_scores = torch.full((C, nb), -1, dtype=torch.int32, device=dev)
        uf = {k: v[uniq_idx.long()] for k, v in f.items()}
        tiers = [0, 0]
    P = f["active"].shape[0]
    winners = []
    cursor, overflow = int(cursor_init) - int(frame_shift), False
    for p in range(P):
        active = bool(f["active"][p])
        if not fast and not active:
            winners.append(-1)  # pad slot: places nothing, draws nothing
            continue
        fp = {k: v[p] for k, v in f.items()}
        s = int(sig_ids[p]) if fast else p
        req, nz_req = fp["req"], fp["nz_req"]
        used, nz_used = live["used"], live["nonzero_used"]
        fail = _live_fail(cfg, live, fp, dom_counts, present, comm)
        replay = fast and bool(tab["valid"][s])
        if replay and gated:
            # the resident t_ffit column is exact, so this IS the full
            # tier's feasibility; replay only where the row agrees with it
            # on every shard (kernels.py:1012-1016)
            feas_live = static["static_ok"][s] & ~tab["ffit"][s] & ~fail
            replay = not bool(comm.vsum(feas_live != tab["feas"][s]))
        if replay:
            feasible, ew = tab["feas"][s], tab["ew"][s]
            pts = _pts_score_carried(cfg, domain, live["sel_counts"], feasible, f,
                                     p, logtab, tab["segs"][s], tab["pcs"][s], comm)
        else:
            f_fit = _fit_fail(alloc, used, req)
            feasible = static["static_ok"][s] & ~f_fit & ~fail
            ew = (_fit_score(cfg, alloc, used, nz_used, req, nz_req) * w_fit
                  + _balanced_score(cfg, alloc, used, nz_used, req, nz_req) * w_bal)
            pts, segs, pcs = _pts_score_core(
                cfg, domain, live["sel_counts"], feasible, f, p, logtab,
                capture=(ct, dmax) if fast else None, comm=comm)
            if fast:
                tab["ew"][s], tab["ffit"][s], tab["feas"][s] = ew, f_fit, feasible
                tab["segs"][s], tab["pcs"][s] = segs, pcs
                tab["valid"][s] = True
        total = _finish_total(cfg, ew, pts, static, s, feasible, comm)
        if cfg.ipa_active:
            total = total + _ipa_score(cfg, live, fp, feasible, comm) * cfg.weight(
                "InterPodAffinity")
        if fast:
            tiers[int(replay)] += 1
            if not replay:
                sig_scores[s] = torch.where(feasible, total, -1)
        best = int(comm.vmax(torch.where(feasible, total, -1)))
        if best < 0 or not active:
            winners.append(-1)
            continue
        # the winner pick (kernels.py:1116-1150): each shard's tie count,
        # the global count, the replicated draw, the shard whose prefix
        # range holds it and its local index; node order is shard-major
        mask = feasible & (total == best)
        ties = comm.gather(mask)
        r, cursor, over = _tie_draw(int(ties.sum()), words, cursor, draw_slots)
        overflow |= over
        prefix = torch.cumsum(ties, 0) - ties
        owner = int(((prefix <= r) & (r < prefix + ties)).to(torch.int32).argmax())
        nb_local = mask.shape[0] // comm.n_shards
        local = mask[owner * nb_local: (owner + 1) * nb_local]
        win = owner * nb_local + int(torch.nonzero(local)[r - int(prefix[owner]), 0])
        sel_prev = live["sel_counts"][win].clone()
        used[win] += req
        nz_used[win] += nz_req
        live["sel_counts"][win] += fp["sig_match"]
        if dom_counts is not None:
            # replicated: every shard learns the winner's domain ids
            for k, dk in enumerate(cfg.topo_domains):
                d = comm.publish(domain[:, k], win) if dk else -1
                if 0 <= d < dom_counts.shape[1]:
                    dom_counts[k, d] += fp["sig_match"]
        if cfg.ipa_active:
            live["ipa_counts"][win] += fp["ipa_match"]
            live["ipa_anti"][win] += fp["ipa_anti_add"]
            live["ipa_pref"][win] += fp["ipa_pref_add"]
        if fast:
            _patch_rows(cfg, planes, live, tab, uf, static, win, sel_prev, comm)
        winners.append(win)
    out = {"packed": torch.tensor(winners + [cursor, int(overflow)],
                                  dtype=torch.int32, device=dev)}
    out.update({k: live[k] for k in carried})
    if fast:
        out["sig_scores"] = sig_scores
        out["sig_table"] = {k: tab[k] for k in ("ew", "ffit", "feas", "segs", "pcs")}
        out["tiers"] = torch.tensor(tiers, dtype=torch.int32, device=dev)
    return out


def _scan_params(cfg: KernelConfig, planes: dict, static: dict,
                 packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                 logtab: torch.Tensor, n_static: int, G: int, cursor0: int):
    """Check the inputs K2 and K5 share (the row planes, K1's n_static rows,
    the packed features, tie words, log table) and build their ScanParams.
    G is the signature row count (0: the non-dedup tier)."""
    from . import cuda

    device = packed_f.device
    P, F = packed_f.shape
    nb, R = planes["alloc"].shape
    K = planes["domain"].shape[1]
    S = planes["sel_counts"].shape[1]
    Ta = planes["ipa_term_key"].shape[0] if cfg.ipa_active else 0
    i32, b8 = torch.int32, torch.bool
    _check(packed_f, "packed features", device, i32)
    plane_specs = [
        ("alloc", i32, (nb, R)), ("used", i32, (nb, R)),
        ("nonzero_used", i32, (nb, 2)), ("domain", i32, (nb, K)),
        ("sel_counts", i32, (nb, S)), ("valid", b8, (nb,)),
    ]
    if cfg.ipa_active:
        plane_specs += [("ipa_counts", i32, (nb, Ta)), ("ipa_anti", i32, (nb, Ta)),
                        ("ipa_pref", i32, (nb, Ta)), ("ipa_term_key", i32, (Ta,))]
    for name, dt, shape in plane_specs:
        _check(planes[name], name, device, dt, shape)
    for name, dt, shape in (
        ("static_ok", b8, (n_static, nb)), ("taint_cnt", i32, (n_static, nb)),
        ("aff_raw", i32, (n_static, nb)), ("img", i32, (n_static, nb)),
        ("aff_has_pref", b8, (n_static,)),
    ):
        _check(static[name], name, device, dt, shape)
    _check(tie_words, "tie_words", device, i32)
    _check(logtab, "logtab", device, torch.float32, (nb + 1,))
    if tie_words.numel() == 0:
        raise ValueError("tie_words is empty")
    if len(cfg.topo_domains) != K:
        raise ValueError(f"config has {len(cfg.topo_domains)} topology keys, "
                         f"planes {K}")
    if max(PODS, *(c for c, _ in cfg.fit_resources), *cfg.balanced_resources) >= R:
        raise ValueError("config names a resource column beyond the planes")
    mc = next((w for n, _o, w, _d, _t in layout if n == "soft_active"), 0)
    widths = {"req": R, "nz_req": 2, "soft_active": mc, "soft_key": mc,
              "soft_sel": mc, "hard_active": mc, "hard_key": mc, "hard_sel": mc,
              "hard_skew": mc, "hard_self": mc, "sig_match": S, "active": 1}
    if cfg.ipa_active:
        widths.update({"ipa_match": Ta, "ipa_anti_add": Ta, "ipa_pref_add": Ta,
                       "ipa_aff_t": cfg.max_ipa_terms,
                       "ipa_aff_self": cfg.max_ipa_terms,
                       "ipa_anti_t": cfg.max_ipa_terms,
                       "ipa_pref_t": cfg.max_ipa_pref,
                       "ipa_pref_w": cfg.max_ipa_pref})
    offs = {k: 0 for k in ("ipa_match", "ipa_anti_add", "ipa_pref_add", "ipa_aff_t",
                           "ipa_aff_self", "ipa_anti_t", "ipa_pref_t", "ipa_pref_w")}
    offs.update(_field_offsets(layout, widths))
    if min(cfg.max_constraints, max(cfg.n_soft, cfg.n_hard)) > mc:
        raise ValueError(f"config traces {max(cfg.n_soft, cfg.n_hard)} spread "
                         f"slots, features hold {mc}")
    dmax = max((dk for dk in cfg.topo_domains if dk > 0), default=0)
    p = cuda.ScanParams(
        P=P, Nb=nb, R=R, K=K, S=S, F=F, MC=mc, L=tie_words.numel(), Ta=Ta,
        D=max(1, dmax), G=G, CT=max(1, min(cfg.max_constraints, cfg.n_soft)),
        cursor0=int(cursor0), strategy=_STRATEGY_CODE[cfg.strategy],
        n_fit=len(cfg.fit_resources), n_rtc=len(cfg.rtc_shape),
        bal_a=cfg.balanced_resources[0], bal_b=cfg.balanced_resources[1],
        w_fit=cfg.weight("NodeResourcesFit"),
        w_bal=cfg.weight("NodeResourcesBalancedAllocation"),
        w_pts=cfg.weight("PodTopologySpread"),
        w_ipa=cfg.weight("InterPodAffinity"),
        w_img=cfg.weight("ImageLocality"),
        w_taint=cfg.weight("TaintToleration"),
        w_aff=cfg.weight("NodeAffinity"),
        n_hard=min(cfg.max_constraints, cfg.n_hard),
        n_soft=min(cfg.max_constraints, cfg.n_soft),
        n_ipa_aff=min(cfg.max_ipa_terms, cfg.n_ipa_aff),
        n_ipa_anti=min(cfg.max_ipa_terms, cfg.n_ipa_anti),
        n_ipa_pref=min(cfg.max_ipa_pref, cfg.n_ipa_pref),
        ipa_active=int(cfg.ipa_active),
        ex_anti=int(cfg.ipa_existing_anti), ex_pref=int(cfg.ipa_existing_pref),
        ex_pref_add=int(cfg.ipa_existing_pref and not cfg.ipa_ignore_preferred_existing),
        dom_carry=int(dmax > 0 and cfg.n_hard > 0),
        **{f"f_{k}": v for k, v in offs.items()})
    for i, (col, w) in enumerate(cfg.fit_resources):
        p.fit_col[i], p.fit_w[i] = col, w
    for i, (x, y) in enumerate(cfg.rtc_shape):
        p.rtc_x[i], p.rtc_y[i] = x, y
    for i, dk in enumerate(cfg.topo_domains):
        p.topo_dk[i] = dk
    return p


# a scanning block's threads, and the node slots it walks at most: each
# thread owns up to 16 positions (SCAN_NT, SCAN_MAX_NPT in
# csrc/scan_step.cuh)
SCAN_THREADS = 1024
SCAN_MAX_SLOTS = SCAN_THREADS * 16


def _check_span(kernel: str, span: int) -> None:
    """A scanning block of K2, K5 or K6 has an instance for up to 16 node
    slots per thread: a bucket (K6: a shard) past that is refused before
    the launch, never computed wrong."""
    if span > SCAN_MAX_SLOTS:
        raise OutOfSlice(f"{kernel}: {span} node slots per block, the scan walks at "
                         f"most {SCAN_MAX_SLOTS}")


def live_extent(planes: dict, sig_table: dict | None = None,
                carry_map: torch.Tensor | None = None, lo: int = 0,
                hi: int | None = None) -> int:
    """The node rows K2 (and each K6 shard, over [lo, hi)) walks: one past
    the last row of the range that any input marks live — valid, a nonzero
    alloc, used or nonzero_used entry, or (a chained wave) a feasible entry
    in a row of the previous table that carry_map seeds. Past it every node
    is invalid with all-zero rows (K1's static_ok, which includes valid, is
    False there), so the scan's answer there is fixed: nothing is feasible
    or participates, and a captured table row holds ew 0, ffit True, feas
    False and sig_scores -1. Returns the extent relative to lo. The kernel
    computes the same in its prologue (scan_step.cuh); this plain version
    states the rule for the tests."""
    hi = planes["alloc"].shape[0] if hi is None else hi
    live = planes["valid"][lo:hi].clone()
    for k in ("alloc", "used", "nonzero_used"):
        live |= (planes[k][lo:hi] != 0).any(dim=1)
    if sig_table is not None and carry_map is not None:
        rows = carry_map[carry_map >= 0].long()
        if rows.numel():
            live |= sig_table["feas"][rows][:, lo:hi].any(dim=0)
    idx = torch.nonzero(live).flatten()
    return int(idx[-1]) + 1 if idx.numel() else 0


def mask_node_lists(masks: torch.Tensor) -> list[torch.Tensor]:
    """The node list K5's block for each mask row walks: the row's mask
    nodes in ascending order (the kernel builds it in shared memory with a
    ballot and a prefix count). Ascending order keeps the tie ballots and
    the draw in node order, so a scan over the list picks the nodes a scan
    over every slot picks."""
    return [torch.nonzero(m).flatten() for m in masks]


def assign_scan(cfg: KernelConfig, planes: dict, static: dict,
                packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                cursor_init, logtab: torch.Tensor,
                sig_ids: torch.Tensor | None = None,
                uniq_idx: torch.Tensor | None = None, frame_shift: int = 0,
                carry_map: torch.Tensor | None = None,
                sig_table: dict | None = None,
                syncs: torch.Tensor | None = None) -> dict:
    """K2 wrapper: the greedy wave scan, the output dict of assign_scan_ref.
    The carry planes out are copies of the inputs, which stay untouched.
    planes holds the row planes and, with IPA, ipa_term_key; static is
    K1's output over the pods, or over the signature rows with dedup.

    cursor_init is a host int or a 0-d int32 tensor on the device (a
    chained wave's predecessor's packed[P_prev]), which the kernel reads
    itself: no device-to-host copy. With carry_map [C] and sig_table (the
    previous chained wave's table, with dedup only) the kernel seeds this
    wave's table from it; the output table is new memory either way.

    syncs (CUDA only: an int32 [SCAN_SYNC_WORDS] tensor) receives the
    scan's counted synchronisations (block barriers, folds, cluster
    barriers, exchanges, tie picks), which scan_floor replays with no node
    work, and thread 0's clock cycles by step phase."""
    return _assign(cfg, planes, static, packed_f, layout, tie_words, cursor_init,
                   logtab, None, sig_ids, uniq_idx, frame_shift, carry_map, sig_table,
                   syncs)


def sharded_assign_ref(cfg: KernelConfig, planes: dict, static: dict, f: dict,
                       tie_words: torch.Tensor, cursor_init, logtab: torch.Tensor,
                       n_shards: int, sig_ids: torch.Tensor | None = None,
                       uniq_idx: torch.Tensor | None = None, frame_shift: int = 0,
                       carry_map: torch.Tensor | None = None,
                       sig_table: dict | None = None) -> dict:
    """Plain version of K6: the plain scan with the node axis cut into
    n_shards ranges (ShardComm), as the reference's _sharded_assign_jit runs
    _batched_assign_core under AxisComm. Same outputs as assign_scan_ref;
    node indices (winners, sig_scores columns) are global."""
    return assign_scan_ref(cfg, planes, static, f, tie_words, cursor_init, logtab,
                           sig_ids, uniq_idx, frame_shift, carry_map, sig_table,
                           comm=ShardComm(n_shards))


def check_shards(n_shards: int, nb: int) -> None:
    """K6's shard count: the blocks of one cluster, dividing the bucket."""
    if n_shards not in CLUSTER_SHARDS:
        raise ValueError(f"{n_shards} node shards: a shard is one block of a "
                         f"thread-block cluster, which holds 1, 2, 4 or 8 "
                         f"(the portable cluster sizes)")
    if nb % n_shards:
        raise ValueError(f"node bucket {nb} not divisible by {n_shards} node shards")


def sharded_assign(cfg: KernelConfig, planes: dict, static: dict,
                   packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                   cursor_init, logtab: torch.Tensor, n_shards: int,
                   sig_ids: torch.Tensor | None = None,
                   uniq_idx: torch.Tensor | None = None, frame_shift: int = 0,
                   carry_map: torch.Tensor | None = None,
                   sig_table: dict | None = None,
                   syncs: torch.Tensor | None = None) -> dict:
    """K6 wrapper: assign_scan's inputs and output dict over n_shards node
    shards, one block of a thread-block cluster each (the plain version,
    sharded_assign_ref, for CPU tensors). The chained-wave arguments are
    K2's: cursor_init as a device tensor, frame_shift, carry_map and
    sig_table; syncs as K2's (rank 0's counts)."""
    check_shards(n_shards, planes["alloc"].shape[0])
    return _assign(cfg, planes, static, packed_f, layout, tie_words, cursor_init,
                   logtab, n_shards, sig_ids, uniq_idx, frame_shift, carry_map,
                   sig_table, syncs)


def _assign(cfg, planes, static, packed_f, layout, tie_words, cursor_init, logtab,
            n_shards, sig_ids, uniq_idx, frame_shift, carry_map, sig_table,
            syncs=None) -> dict:
    """K2 (n_shards None) or K6: the checks, the plain version on the CPU,
    else the outputs' allocation and the launch."""
    from .planes import unpack_features

    check_slice(cfg)
    if (sig_ids is None) != (uniq_idx is None):
        raise ValueError("sig_ids and uniq_idx go together")
    if (carry_map is None) != (sig_table is None):
        raise ValueError("carry_map and sig_table go together")
    if carry_map is not None and sig_ids is None:
        raise ValueError("cross-wave reuse needs signature dedup")
    device = packed_f.device
    kernel = "assign_scan" if n_shards is None else "sharded_assign"
    if device.type == "cpu":
        return assign_scan_ref(cfg, planes, static,
                               unpack_features(packed_f, layout), tie_words,
                               cursor_init, logtab, sig_ids, uniq_idx,
                               frame_shift, carry_map, sig_table,
                               comm=LOCAL_COMM if n_shards is None else ShardComm(n_shards))
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on cpu or cuda, not {device}")
    from . import cuda

    P = packed_f.shape[0]
    nb = planes["alloc"].shape[0]
    _check_span(kernel, nb // (n_shards or 1))
    fast = sig_ids is not None
    xwave = carry_map is not None
    Ps = uniq_idx.shape[0] if fast else P  # static rows
    i32, b8 = torch.int32, torch.bool
    if fast:
        _check(sig_ids, "sig_ids", device, i32, (P,))
        _check(uniq_idx, "uniq_idx", device, i32)
    cursor_dev = isinstance(cursor_init, torch.Tensor)
    if cursor_dev:
        _check(cursor_init, "cursor_init", device, i32)
        if cursor_init.numel() != 1:
            raise ValueError("cursor_init must hold one word")
    p = _scan_params(cfg, planes, static, packed_f, layout, tie_words, logtab,
                     n_static=Ps, G=Ps if fast else 0,
                     cursor0=0 if cursor_dev else int(cursor_init))
    p.frame_shift = int(frame_shift)
    K, S, dmax, ct = p.K, p.S, p.D, p.CT
    if xwave:
        g_prev = sig_table["ew"].shape[0]
        _check(carry_map, "carry_map", device, i32, (Ps,))
        for name, dt, shape in (("ew", i32, (g_prev, nb)), ("ffit", b8, (g_prev, nb)),
                                ("feas", b8, (g_prev, nb)), ("segs", i32, (g_prev, ct, dmax)),
                                ("pcs", i32, (g_prev, ct, dmax))):
            _check(sig_table[name], f"sig_table.{name}", device, dt, shape)
        if g_prev == 0:
            raise ValueError("sig_table has no rows")
        p.xwave, p.G_prev = 1, g_prev
    out = {"packed": torch.empty(P + 2, dtype=i32, device=device)}
    carried = ["used", "nonzero_used", "sel_counts"]
    if cfg.ipa_active:
        carried += ["ipa_counts", "ipa_anti", "ipa_pref"]
    for k in carried:
        out[k] = planes[k].clone()
    empty = torch.empty(0, dtype=i32, device=device)
    dom = (torch.empty((K, dmax, S), dtype=i32, device=device) if p.dom_carry
           else empty)
    if fast:
        out["sig_scores"] = torch.full((Ps, nb), -1, dtype=i32, device=device)
        # the seed writes every entry of a seeded table; a fresh one starts zeroed
        alloc_tab = torch.empty if xwave else torch.zeros
        tab = {"ew": alloc_tab((Ps, nb), dtype=i32, device=device),
               "ffit": alloc_tab((Ps, nb), dtype=b8, device=device),
               "feas": alloc_tab((Ps, nb), dtype=b8, device=device),
               "segs": alloc_tab((Ps, ct, dmax), dtype=i32, device=device),
               "pcs": alloc_tab((Ps, ct, dmax), dtype=i32, device=device)}
        out["sig_table"] = tab
        out["tiers"] = torch.zeros(2, dtype=i32, device=device)
        t_valid = alloc_tab(Ps, dtype=b8, device=device)
    ipa_ptrs = ([out[k].data_ptr() for k in ("ipa_counts", "ipa_anti", "ipa_pref")]
                + [planes["ipa_term_key"].data_ptr()] if cfg.ipa_active else [0] * 4)
    ptrs = [planes[k].data_ptr() for k in ("alloc", "domain", "valid")]
    ptrs += [static[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img", "aff_has_pref")]
    ptrs += [packed_f.data_ptr(), tie_words.data_ptr(), logtab.data_ptr()]
    ptrs += [out[k].data_ptr() for k in ("used", "nonzero_used", "sel_counts")]
    ptrs += ipa_ptrs + [dom.data_ptr(), out["packed"].data_ptr()]
    if fast:
        ptrs += [sig_ids.data_ptr(), uniq_idx.data_ptr(), t_valid.data_ptr()]
        ptrs += [tab[k].data_ptr() for k in ("ew", "ffit", "feas", "segs", "pcs")]
        ptrs += [out["sig_scores"].data_ptr(), out["tiers"].data_ptr()]
    else:
        ptrs += [0] * 10
    ptrs.append(cursor_init.data_ptr() if cursor_dev else 0)
    if xwave:
        ptrs += [carry_map.data_ptr()] + [sig_table[k].data_ptr() for k in (
            "ew", "ffit", "feas", "segs", "pcs")]
    else:
        ptrs += [0] * 6
    ptrs.append(_syncs_ptr(syncs, device))
    if n_shards is None:
        cuda.launch("assign_scan", p, ptrs, _stream(device))
    else:
        cuda.launch("sharded_assign", cuda.ShardParams(scan=p, n_shards=n_shards), ptrs,
                    _stream(device))
    count_launch(kernel)
    return out


# --------------------------------------------------------------------------
# K5 gang_assign
# --------------------------------------------------------------------------


def gang_placement_score_ref(planes: dict, mask: torch.Tensor) -> torch.Tensor:
    """The reference's _gang_placement_score (kernels.py:1448), the device
    replica of TopologyPlacementGenerator.score_placement: the mean
    free-capacity score (0-100, LeastAllocated shape, int32 floor math) of
    the mask's nodes that have cpu or memory capacity, on the PRE-scan
    planes. valid is not read. Returns an int32 scalar tensor."""
    alloc, used = planes["alloc"], planes["used"]
    score = torch.zeros(alloc.shape[0], dtype=torch.int32, device=alloc.device)
    parts = torch.zeros_like(score)
    for col in (CPU, MEM):
        cap = alloc[:, col]
        ok = cap > 0
        req = torch.minimum(used[:, col], cap)
        s = floordiv((cap - req) * MAX_NODE_SCORE, cap.clamp(min=1))
        score = score + torch.where(ok, s, 0)
        parts = parts + ok.to(torch.int32)
    node_val = torch.where(parts > 0, floordiv(score, parts.clamp(min=1)), 0)
    counted = mask & (parts > 0)
    n = counted.sum(dtype=torch.int32)
    total = torch.where(counted, node_val, 0).sum(dtype=torch.int32)
    return torch.where(n > 0, floordiv(total, n.clamp(min=1)), 0).to(torch.int32)


def gang_assign_ref(cfg: KernelConfig, planes: dict, static: dict, f: dict,
                    masks: torch.Tensor, tie_words: torch.Tensor, logtab: torch.Tensor,
                    n_constrained: int, has_fallback: bool) -> torch.Tensor:
    """Plain version of K5 (the reference's _gang_assign_jit,
    kernels.py:1472-1543): for each mask row, K2's non-dedup scan
    (assign_scan_ref) over the placement-narrowed snapshot — valid & mask,
    and K1's static_ok (the one K1 output that reads valid) & mask — from
    cursor 0 of the same tie stream; then per row the members placed, the
    placement score on the pre-scan planes, and the all-or-nothing pick.

    Returns the packed int32 vector [D*P + 4*D + 3]: winners [D, P] ++
    consumed [D] ++ overflow [D] ++ placed [D] ++ score [D] ++ [win_d, ok,
    n_active]."""
    active = f["active"] != 0
    n_active = int(active.sum())
    winners, consumed, overflow, placed, scores = [], [], [], [], []
    for mask in masks:
        narrowed = dict(planes, valid=planes["valid"] & mask)
        st = dict(static, static_ok=static["static_ok"] & mask[None])
        packed = assign_scan_ref(cfg, narrowed, st, f, tie_words, 0, logtab)["packed"]
        w = packed[:-2]
        winners.append(w)
        consumed.append(int(packed[-2]))
        overflow.append(int(packed[-1]))
        placed.append(int(((w >= 0) & active).sum()))
        scores.append(int(gang_placement_score_ref(planes, mask)))
    # host winner semantics: the first max of the score over the constrained
    # rows where the whole gang placed without a draw overflow; only when
    # none fits does the fallback row (index n_constrained) get the gang
    key = [sc if pl == n_active and not ov else -1
           for sc, pl, ov in zip(scores, placed, overflow)]
    cbest, cwin = -1, 0
    if n_constrained > 0:
        ckey = [k if d < n_constrained else -1 for d, k in enumerate(key)]
        cbest = max(ckey)
        cwin = ckey.index(cbest)
    if has_fallback:
        fb_ok = placed[n_constrained] == n_active and not overflow[n_constrained]
        win_d = cwin if cbest >= 0 else n_constrained
        ok = cbest >= 0 or fb_ok
    else:
        win_d, ok = cwin, cbest >= 0
    tail = torch.tensor(consumed + overflow + placed + scores + [win_d, int(ok), n_active],
                        dtype=torch.int32, device=masks.device)
    return torch.cat([torch.stack(winners).reshape(-1).to(torch.int32), tail])


def gang_work_words(p) -> int:
    """int32 words of one mask row's work slice in K5 (gang_work_words in
    csrc/gang_assign.cu): the carry planes and the hard-spread domain
    counts."""
    return (p.Nb * (p.R + 2 + p.S) + (3 * p.Nb * p.Ta if p.ipa_active else 0)
            + (p.K * p.D * p.S if p.dom_carry else 0))


def gang_assign(cfg: KernelConfig, planes: dict, static: dict,
                packed_f: torch.Tensor, layout, masks: torch.Tensor,
                tie_words: torch.Tensor, logtab: torch.Tensor,
                n_constrained: int, has_fallback: bool,
                syncs: torch.Tensor | None = None) -> torch.Tensor:
    """K5 wrapper: whole-gang placement over a [D, Nb] bool stack of
    placement masks in host placement order — rows [0, n_constrained) the
    topology domains, row n_constrained (with has_fallback) the
    unconstrained parent, the rest all-False padding. static is K1's output
    over the gang's P members (one launch for every row). Returns the
    packed int32 vector of gang_assign_ref; the planes stay untouched.
    syncs (CUDA only) receives row 0's counted synchronisations, as
    assign_scan's."""
    from .planes import unpack_features

    check_slice(cfg)
    D = masks.shape[0]
    if n_constrained < 0 or n_constrained + int(bool(has_fallback)) > D:
        raise ValueError(f"{n_constrained} constrained rows and fallback "
                         f"{bool(has_fallback)} do not fit {D} mask rows")
    device = packed_f.device
    if device.type == "cpu":
        return gang_assign_ref(cfg, planes, static, unpack_features(packed_f, layout),
                               masks, tie_words, logtab, n_constrained, has_fallback)
    if device.type != "cuda":
        raise ValueError(f"gang_assign runs on cpu or cuda, not {device}")
    from . import cuda

    P = packed_f.shape[0]
    nb = planes["alloc"].shape[0]
    _check_span("gang_assign", nb)
    p = _scan_params(cfg, planes, static, packed_f, layout, tie_words, logtab,
                     n_static=P, G=0, cursor0=0)
    _check(masks, "masks", device, torch.bool, (D, nb))
    g = cuda.GangParams(scan=p, rows=D, n_constrained=int(n_constrained),
                        has_fallback=int(bool(has_fallback)))
    work = torch.empty(D * gang_work_words(p), dtype=torch.int32, device=device)
    out = torch.empty(D * P + 4 * D + 3, dtype=torch.int32, device=device)
    ptrs = [planes[k].data_ptr() for k in ("alloc", "domain", "valid")]
    ptrs += [static[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img", "aff_has_pref")]
    ptrs += [packed_f.data_ptr(), tie_words.data_ptr(), logtab.data_ptr()]
    ptrs += [planes[k].data_ptr() for k in ("used", "nonzero_used", "sel_counts")]
    ptrs += ([planes[k].data_ptr() for k in ("ipa_counts", "ipa_anti", "ipa_pref",
                                             "ipa_term_key")]
             if cfg.ipa_active else [0] * 4)
    ptrs += [masks.data_ptr(), work.data_ptr(), out.data_ptr(), _syncs_ptr(syncs, device)]
    cuda.launch("gang_assign", g, ptrs, _stream(device))
    count_launch("gang_assign")
    return out


# --------------------------------------------------------------------------
# K3 scatter_rows
# --------------------------------------------------------------------------


def scatter_rows_ref(dst: dict, rows: dict, idx: torch.Tensor) -> None:
    """Plain version of K3: dst[k][idx] = rows[k] in place for every plane.
    An index at or past a plane's end is dropped, as the reference's
    scatter drops it; a negative one (the backend never passes one) is
    dropped too, where the reference would count from the end."""
    for k, t in dst.items():
        ok = (idx >= 0) & (idx < t.shape[0])
        t[idx[ok].long()] = rows[k][ok]


# K3's launch: up to SCATTER_ONE_BLOCK threads the copy is one block;
# past it, blocks of SCATTER_BLOCK threads
SCATTER_ONE_BLOCK = 1024
SCATTER_BLOCK = 128


@dataclass(frozen=True)
class ScatterPlan:
    """K3's launch: per plane the copy width in bytes and the copies per
    row; log2 of the lanes per row and of each plane's part of the flat
    thread space; the thread space, the threads per block and the grid."""

    width: tuple[int, ...]
    units: tuple[int, ...]
    lane_log: int
    part_log: int
    n_threads: int
    threads: int
    grid: tuple[int, int]


@functools.lru_cache(maxsize=1024)
def _scatter_plan(row_bytes: tuple, dst_rows: tuple, align: tuple, n_rows: int) -> ScatterPlan:
    width, units = [], []
    for nb, rows, a in zip(row_bytes, dst_rows, align):
        w = next(w for w in (16, 8, 4, 1) if nb % w == 0 and a % w == 0)
        width.append(w)
        units.append(nb // w if rows else 0)
    most = max(units, default=0)
    lane_log = min(5, (most - 1).bit_length()) if most else 0
    part_log = max(5, ((n_rows << lane_log) - 1).bit_length())
    t = len(row_bytes) << part_log
    block = t if t <= SCATTER_ONE_BLOCK else SCATTER_BLOCK
    return ScatterPlan(tuple(width), tuple(units), lane_log, part_log, t, block,
                       (-(-t // block), 1))


def _scatter_planes(dst: dict, rows: dict, n_rows: int, device) -> tuple:
    """One pass over the planes, checked: per plane its row bytes, its
    rows, both pointers and their common alignment (at most 16)."""
    rb, dr, dp, sp, al = [], [], [], [], []
    for k, t in dst.items():
        r = rows[k]
        if not (t.device == device and r.device == device and r.dtype == t.dtype
                and t.is_contiguous() and r.is_contiguous() and r.shape[0] == n_rows
                and r.shape[1:] == t.shape[1:]):
            _check(t, k, device, t.dtype)
            _check(r, f"rows[{k}]", device, t.dtype, (n_rows,) + tuple(t.shape[1:]))
        m = t.shape[0]
        d, s = t.data_ptr(), r.data_ptr()
        rb.append(t.nbytes // m if m else 0)
        dr.append(m)
        dp.append(d)
        sp.append(s)
        a = d | s
        al.append(min(16, a & -a) if a else 16)
    return rb, dr, dp, sp, al


def scatter_plan(dst: dict, rows: dict, n_rows: int) -> ScatterPlan:
    """K3's copy plan over the planes in dst's order (csrc/scatter_rows.cu
    reads it from ScatterParams; its launch takes the grid by the same
    formula). Per plane: the widest copy of 16, 8, 4 or 1 bytes that
    divides the row and both planes' pointers, and its copies per row (0
    for a plane with no rows). Every row takes the same lanes, the power of
    two at or above the most copies of any plane's row, at most a warp (so
    one lane per row, 32 rows a warp, when every row is one copy), and
    every plane the same part of the flat thread space, the power of two
    at or above rows x lanes, at least a warp: a thread's row comes from
    these two sizes alone, its plane from its part. The grid: one block of
    the whole space up to SCATTER_ONE_BLOCK threads (one dirty row over
    every plane), else blocks of SCATTER_BLOCK."""
    device = next(iter(dst.values())).device if dst else None
    rb, dr, _, _, al = _scatter_planes(dst, rows, n_rows, device)
    return _scatter_plan(tuple(rb), tuple(dr), tuple(al), n_rows)


def scatter_rows(dst: dict, rows: dict, idx: torch.Tensor) -> None:
    """K3 wrapper: one launch scatters every plane's rows in place. The
    host's part is one checked pass over the planes and a cached plan."""
    device = idx.device
    if device.type == "cpu":
        scatter_rows_ref(dst, rows, idx)
        return
    if device.type != "cuda":
        raise ValueError(f"scatter_rows runs on cpu or cuda, not {device}")
    from . import cuda

    m = len(dst)
    if m > cuda.MAX_PLANES:
        raise ValueError(f"{m} planes; the kernel takes {cuda.MAX_PLANES}")
    _check(idx, "idx", device, torch.int32)
    n = idx.numel()
    rb, dr, dp, sp, al = _scatter_planes(dst, rows, n, device)
    if not n:
        return
    plan = _scatter_plan(tuple(rb), tuple(dr), tuple(al), n)
    p = cuda.ScatterParams(n_planes=m, n_rows=n, n_threads=plan.n_threads,
                           block=plan.threads, part_log=plan.part_log,
                           lane_log=plan.lane_log)
    p.row_bytes[:m] = rb
    p.dst_rows[:m] = dr
    p.width[:m] = plan.width
    p.units[:m] = plan.units
    p.dst[:m] = dp
    p.src[:m] = sp
    cuda.launch("scatter_rows", p, [idx.data_ptr()], _stream(device))
    count_launch("scatter_rows")


# --------------------------------------------------------------------------
# K4 fit_and_score
# --------------------------------------------------------------------------


def _domain_sum_at_node(cfg, domain, k: int, col, part, comm=LOCAL_COMM):
    """kernels.py:303 — (has_key [Nb], at_node [Nb]): at_node[i] sums col
    over the participating nodes of i's domain of key slot k; a singleton
    key's domain sum is the node's own (masked) value."""
    dk = cfg.topo_domains[k]
    dom = domain[:, k]
    has_key = dom >= 0
    masked = torch.where(part & has_key, col, 0)
    if dk == 0:
        return has_key, masked
    dom_c = dom.clamp(0, dk - 1).long()
    return has_key, comm.seg(dom_c, masked, dk)[dom_c]


def _ipa_term_stats(cfg, planes, t: int, part, comm=LOCAL_COMM):
    """kernels.py:328 — one interned term's (has_key [Nb], count_at_node
    [Nb], anywhere): its matching-pod counts summed per domain of the term's
    topology key over the participating nodes. The term slot is clamped
    into the table (jnp.take of clip(t, 0)); a key slot outside the planes
    (a stale -1) matches no node."""
    tc = min(max(t, 0), planes["ipa_term_key"].shape[0] - 1)
    cnt = planes["ipa_counts"][:, tc]
    key_i = int(planes["ipa_term_key"][tc])
    if not 0 <= key_i < len(cfg.topo_domains):
        z = torch.zeros_like(cnt)
        return z.bool(), z, False
    has_key, at = _domain_sum_at_node(cfg, planes["domain"], key_i, cnt, part, comm)
    anywhere = bool(comm.vsum(torch.where(part & has_key, cnt, 0)) > 0)
    return has_key, at, anywhere


def _existing_term_cols(cfg, planes, plane: str, fp):
    """The existing pods' side (kernels.py:359-368, :419-429): for each
    topology key slot k, the per-node sum of `plane` over the terms on key
    k that match the incoming pod — the reference's float32 matvec, as an
    exact int32 sum. Keys no matching term uses give an all-zero column and
    are skipped (they add nothing)."""
    tkey = planes["ipa_term_key"]
    match = fp["ipa_match"] != 0
    for k in range(len(cfg.topo_domains)):
        w = (match & (tkey == k)).to(torch.int32)
        if bool(w.any()):
            yield k, (planes[plane] * w).sum(1, dtype=torch.int32)


def _ipa_filters(cfg, planes, fp, comm=LOCAL_COMM):
    """InterPodAffinity's three checks (filtering.go:352-412, kernels.py:347):
    (existing pods' anti-affinity, the pod's anti-affinity, the pod's
    affinity) reject rows over every valid node."""
    valid = planes["valid"]
    fail1 = torch.zeros_like(valid)
    fail2 = torch.zeros_like(valid)
    fail3 = torch.zeros_like(valid)
    if cfg.ipa_existing_anti:
        for k, col in _existing_term_cols(cfg, planes, "ipa_anti", fp):
            has_key, at = _domain_sum_at_node(cfg, planes["domain"], k, col, valid, comm)
            fail1 = fail1 | (has_key & (at > 0))
    for s in range(min(cfg.max_ipa_terms, cfg.n_ipa_anti)):
        t = int(fp["ipa_anti_t"][s])
        if t < 0:
            continue  # inactive slot
        has_key, at, _ = _ipa_term_stats(cfg, planes, t, valid, comm)
        fail2 = fail2 | (has_key & (at > 0))
    for s in range(min(cfg.max_ipa_terms, cfg.n_ipa_aff)):
        t = int(fp["ipa_aff_t"][s])
        if t < 0:
            continue
        has_key, at, anywhere = _ipa_term_stats(cfg, planes, t, valid, comm)
        # self-match bootstrap: a term that matches nowhere passes when the
        # pod matches its own term
        if anywhere or not bool(fp["ipa_aff_self"][s]):
            fail3 = fail3 | ~(has_key & (at > 0))
    return fail1, fail2, fail3


def _ipa_score(cfg, planes, fp, feasible, comm=LOCAL_COMM):
    """InterPodAffinity score (scoring.go:81-257, kernels.py:396): weighted
    preferred-term matches per domain over the feasible nodes, min/max
    normalized; an all-equal spread scores 100 only when positive."""
    nb = feasible.shape[0]
    if cfg.n_ipa_pref == 0 and not cfg.ipa_existing_pref:
        return torch.zeros(nb, dtype=torch.int32, device=feasible.device)
    raw = torch.zeros(nb, dtype=torch.int32, device=feasible.device)
    for s in range(min(cfg.max_ipa_pref, cfg.n_ipa_pref)):
        t = int(fp["ipa_pref_t"][s])
        if t < 0:
            continue
        has_key, at, _ = _ipa_term_stats(cfg, planes, t, feasible, comm)
        raw = raw + torch.where(has_key, int(fp["ipa_pref_w"][s]) * at, 0)
    if cfg.ipa_existing_pref and not cfg.ipa_ignore_preferred_existing:
        for k, col in _existing_term_cols(cfg, planes, "ipa_pref", fp):
            has_key, at = _domain_sum_at_node(cfg, planes["domain"], k, col, feasible,
                                              comm)
            raw = raw + torch.where(has_key, at, 0)
    mx = comm.vmax(torch.where(feasible, raw, -_INT32_MAX))
    mn = comm.vmin(torch.where(feasible, raw, _INT32_MAX))
    spread = mx - mn
    return torch.where(
        spread == 0, torch.where(mx > 0, MAX_NODE_SCORE, 0),
        floordiv(MAX_NODE_SCORE * (raw - mn), spread.clamp(min=1)))


def _taint_score(planes, fp, feasible, comm=LOCAL_COMM):
    """taint_toleration.go:180-215 (kernels.py:590): intolerable
    PreferNoSchedule taints, inverted over the feasible set."""
    ptid = planes["prefer_taints"]
    tolp = (fp["tol_prefer"] != 0)[ptid.clamp(min=0).long()]
    count = ((ptid >= 0) & ~tolp).sum(1, dtype=torch.int32)
    max_count = comm.vmax(torch.where(feasible, count, 0))
    return torch.where(
        max_count > 0,
        MAX_NODE_SCORE - floordiv(count * MAX_NODE_SCORE, max_count.clamp(min=1)),
        MAX_NODE_SCORE)


def _node_affinity_score(planes, tables, fp, feasible, comm=LOCAL_COMM):
    """node_affinity.go:272 normalized to max 100 over the feasible set
    (kernels.py:604); the raw value where that max is 0."""
    sig = int(fp["aff_sig"])
    raw = tables["aff_pref"][sig][planes["group_id"].long()]
    mx = comm.vmax(torch.where(feasible, raw, 0))
    normed = torch.where(mx > 0, floordiv(raw * MAX_NODE_SCORE, mx.clamp(min=1)), raw)
    return torch.where(tables["aff_has_pref"][sig], normed, 0)


def filter_masks_ref(cfg: KernelConfig, planes: dict, tables: dict, fp: dict,
                     comm=LOCAL_COMM):
    """Every filter plugin for one pod (kernels.py:442) → (fails [NF, Nb]
    bool, feasible [Nb], insufficient [R, Nb], too_many_pods [Nb]). fails
    rows: FILTER_NAMES, then the hard-spread missing-key rows and skew rows
    (one per constraint slot), then the three InterPodAffinity rows. fp is
    one pod's feature views (int32)."""
    valid = planes["valid"]
    nb = valid.shape[0]
    iota = torch.arange(nb, dtype=torch.int32, device=valid.device)
    f_unsched = planes["unsched"] & (fp["tol_unsched"] == 0)
    f_name = (fp["name_idx"] != -1) & (iota != fp["name_idx"])
    f_pin = (fp["aff_pin"] != -1) & (iota != fp["aff_pin"])
    tid = planes["taints"]
    tol = (fp["tol"] != 0)[tid.clamp(min=0).long()]
    f_taint = ((tid >= 0) & ~tol).any(1)
    sig = int(fp["aff_sig"])
    gid = planes["group_id"].long()
    f_aff = ~(tables["aff_match"][sig][gid] & tables["aff_allow"][sig])
    conflict = (planes["port_words"] & fp["ports"][None]) != 0
    f_ports = (fp["has_ports"] != 0) & conflict.any(1)
    req = fp["req"]
    free = planes["alloc"] - planes["used"]
    insufficient = (req[None] > 0) & (req[None] > free)
    insufficient[:, PODS] = False
    too_many = planes["used"][:, PODS] + 1 > planes["alloc"][:, PODS]
    f_fit = insufficient.any(1) | too_many
    false_row = torch.zeros_like(valid)
    missing, skewed = [], []
    for c in range(cfg.max_constraints):
        if c >= cfg.n_hard or not bool(fp["hard_active"][c]):
            missing.append(false_row)
            skewed.append(false_row)
            continue
        has_key, count, min_c, _ = _pts_domain_stats(
            cfg, planes["domain"], planes["sel_counts"], valid,
            int(fp["hard_key"][c]), int(fp["hard_sel"][c]), comm=comm)
        skew = count + fp["hard_self"][c] - min_c
        missing.append(~has_key)
        skewed.append(has_key & (skew > fp["hard_skew"][c]))
    ipa1, ipa2, ipa3 = _ipa_filters(cfg, planes, fp, comm)
    fails = torch.stack([f_unsched, f_name, f_taint, f_aff | f_pin, f_ports, f_fit]
                        + missing + skewed + [ipa1, ipa2, ipa3])
    feasible = valid & ~fails.any(0)
    return fails, feasible, insufficient.T.contiguous(), too_many


def scores_ref(cfg: KernelConfig, planes: dict, tables: dict, f: dict, p: int,
               feasible, logtab, comm=LOCAL_COMM):
    """Every score plugin for pod p of the feature views f (kernels.py:731):
    (weighted total [Nb], per-plugin scores) on every row, infeasible and
    pad rows included."""
    fp = {k: v[p] for k, v in f.items()}
    alloc, used, nz = planes["alloc"], planes["used"], planes["nonzero_used"]
    per = {
        "NodeResourcesFit": _fit_score(cfg, alloc, used, nz, fp["req"], fp["nz_req"]),
        "NodeResourcesBalancedAllocation": _balanced_score(
            cfg, alloc, used, nz, fp["req"], fp["nz_req"]),
        "TaintToleration": _taint_score(planes, fp, feasible, comm),
        "NodeAffinity": _node_affinity_score(planes, tables, fp, feasible, comm),
        "PodTopologySpread": _pts_score(cfg, planes["domain"], planes["sel_counts"],
                                        feasible, f, p, logtab, comm),
        "InterPodAffinity": _ipa_score(cfg, planes, fp, feasible, comm),
        "ImageLocality": _image_score(planes, {k: v[p: p + 1] for k, v in f.items()})[0],
    }
    total = torch.zeros_like(per["NodeResourcesFit"])
    for name in PLUGIN_NAMES:
        total = total + per[name] * cfg.weight(name)
    return total, per


def fit_and_score_ref(cfg: KernelConfig, planes: dict, tables: dict, f: dict,
                      logtab, p: int = 0, comm=LOCAL_COMM) -> dict:
    """Plain version of K4 (the reference's _fit_and_score_jit) for pod p of
    the feature views f: fails, feasible, insufficient, too_many_pods,
    total (-1 where infeasible) and per_plugin (every row, unmasked). Under
    ShardComm(C) every reduction runs over the kernel's cluster of C blocks
    (fit_split): the answer is the same for every C."""
    comm = comm.fit_split(planes["valid"])
    fp = {k: v[p] for k, v in f.items()}
    fails, feasible, insufficient, too_many = filter_masks_ref(cfg, planes, tables, fp,
                                                               comm)
    total, per = scores_ref(cfg, planes, tables, f, p, feasible, logtab, comm)
    return {"fails": fails, "feasible": feasible, "insufficient": insufficient,
            "too_many_pods": too_many, "total": torch.where(feasible, total, -1),
            "per_plugin": per}


def fit_output_bytes(nb: int, n_fails: int, r: int) -> tuple[int, int]:
    """(bool bytes, total bytes) of one pod's packed K4 output: fails,
    feasible, insufficient and too_many_pods as bytes, then total and the
    seven per_plugin rows as int32 (nb is a multiple of 8, so the int32
    part starts aligned)."""
    nbool = (n_fails + 1 + r + 1) * nb
    return nbool, nbool + (1 + len(PLUGIN_NAMES)) * nb * 4


def unpack_fit_outputs(row: torch.Tensor, nb: int, n_fails: int, r: int) -> dict:
    """Views of one pod's packed K4 output (a [bytes] uint8 tensor) as the
    output dict of fit_and_score_ref."""
    nbool, _ = fit_output_bytes(nb, n_fails, r)
    b = row[:nbool].view(torch.bool)
    ints = row[nbool:].view(torch.int32).view(1 + len(PLUGIN_NAMES), nb)
    o = n_fails * nb
    return {
        "fails": b[:o].view(n_fails, nb),
        "feasible": b[o: o + nb],
        "insufficient": b[o + nb: o + nb + r * nb].view(r, nb),
        "too_many_pods": b[o + nb + r * nb: o + 2 * nb + r * nb],
        "total": ints[0],
        "per_plugin": {name: ints[1 + i] for i, name in enumerate(PLUGIN_NAMES)},
    }


def _pack_fit_outputs(out: dict) -> torch.Tensor:
    """fit_and_score_ref's dict → one pod's packed bytes (the CPU side of
    the K4 wrapper, so both devices hand back the same buffer)."""
    parts = [out[k].reshape(-1).view(torch.uint8)
             for k in ("fails", "feasible", "insufficient", "too_many_pods")]
    parts.append(out["total"].view(torch.uint8))
    parts += [out["per_plugin"][name].contiguous().view(torch.uint8)
              for name in PLUGIN_NAMES]
    return torch.cat(parts)


# K4's sync output (csrc/fit_and_score.cu): the counted block barriers,
# folds, cluster barriers, exchanges, table folds and their words, then
# thread 0's clock cycles in each of the kernel's phases (pod 0, block 0):
# the prologue, A's pass, A's fold, the hard minima, B's pass (fused, C's
# adds), B's fold, C's own pass and fold, the soft domain counts, D's pass,
# D's fold, E's pass and the exit fence
FIT_COUNTS = 6
FIT_PHASE_NAMES = ("prologue", "A pass", "A fold", "hard min", "B pass", "B fold", "C",
                   "soft domains", "D pass", "D fold", "E pass", "exit")
FIT_SYNC_WORDS = FIT_COUNTS + len(FIT_PHASE_NAMES)

# blocks per pod (one thread-block cluster): K4's and K7's, measured on the
# main path's shapes (PERF.md §5g); the kernels take 1, 2, 4, 8 or 16 (K7:
# 1, 2 or 4)
FIT_CLUSTER = 16
WAVE_FIT_CLUSTER = 1
FIT_CLUSTERS = (1, 2, 4, 8, 16)
WAVE_FIT_CLUSTERS = (1, 2, 4)
# K4's block (FIT_NT in csrc/fit_and_score.cu; K7's is SCAN_THREADS)
FIT_THREADS = 512


def _fit_syncs_ptr(syncs, device) -> int:
    if syncs is None:
        return 0
    _check(syncs, "syncs", device, torch.int32, (FIT_SYNC_WORDS,))
    return syncs.data_ptr()


def fit_and_score(cfg: KernelConfig, planes: dict, tables: dict,
                  packed_f: torch.Tensor, layout, logtab: torch.Tensor,
                  cluster: int | None = None,
                  syncs: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper: each pod of the [P, F] packed features against every
    node, one thread-block cluster of `cluster` blocks per pod (default
    FIT_CLUSTER). Returns the packed outputs [P, bytes] uint8 (views by
    unpack_fit_outputs) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (it raises when the card cannot hold the
    cluster). planes holds the row planes and ipa_term_key. syncs (CUDA
    only: an int32 [FIT_SYNC_WORDS] tensor) receives pod 0's counted
    synchronisations and thread 0's clock by phase."""
    from .planes import unpack_features

    check_fit_slice(cfg)
    cluster = FIT_CLUSTER if cluster is None else cluster
    if cluster not in FIT_CLUSTERS:
        raise ValueError(f"fit_and_score runs on a cluster of {FIT_CLUSTERS} blocks, "
                         f"not {cluster}")
    device = packed_f.device
    nb, R = planes["alloc"].shape
    nf = len(FILTER_NAMES) + 2 * cfg.max_constraints + 3
    if device.type == "cpu":
        f = unpack_features(packed_f, layout)
        return torch.stack([
            _pack_fit_outputs(fit_and_score_ref(cfg, planes, tables, f, logtab, p))
            for p in range(packed_f.shape[0])])
    if device.type != "cuda":
        raise ValueError(f"fit_and_score runs on cpu or cuda, not {device}")
    from . import cuda

    p, ptrs = _fit_inputs(cfg, planes, tables, packed_f, layout, logtab, nf, cluster)
    _, per_pod = fit_output_bytes(nb, nf, R)
    out = torch.empty((packed_f.shape[0], per_pod), dtype=torch.uint8, device=device)
    if packed_f.shape[0]:
        cuda.launch("fit_and_score", p,
                    ptrs + [out.data_ptr(), _fit_syncs_ptr(syncs, device)], _stream(device))
        count_launch("fit_and_score")
    return out


def wave_fit_and_score_ref(cfg: KernelConfig, planes: dict, tables: dict, f: dict,
                           logtab, comm=LOCAL_COMM) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (the reference's _wave_fit_and_score_jit): K4's
    plain version for every pod of the feature views f against the same
    planes (under comm, as K7's blocks per pod), keeping (feasible [P, Nb]
    bool, total [P, Nb] int32, -1 where infeasible)."""
    outs = [fit_and_score_ref(cfg, planes, tables, f, logtab, p, comm)
            for p in range(f["active"].shape[0])]
    nb = planes["valid"].shape[0]
    dev = planes["valid"].device
    if not outs:
        return (torch.zeros((0, nb), dtype=torch.bool, device=dev),
                torch.zeros((0, nb), dtype=torch.int32, device=dev))
    return (torch.stack([o["feasible"] for o in outs]),
            torch.stack([o["total"] for o in outs]).to(torch.int32))


def wave_fit_and_score(cfg: KernelConfig, planes: dict, tables: dict,
                       packed_f: torch.Tensor, layout, logtab: torch.Tensor,
                       cluster: int | None = None,
                       syncs: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 wrapper: the pods x nodes matrix, every pod of the [P, F] packed
    features against the same planes with no assumes between them ->
    (feasible [P, Nb] bool, total [P, Nb] int32, -1 where infeasible). The
    plain version for CPU tensors, the kernel (K4's device code, `cluster`
    blocks per pod, default WAVE_FIT_CLUSTER, only these two outputs) for
    CUDA tensors; syncs as K4's."""
    from .planes import unpack_features

    check_fit_slice(cfg)
    cluster = WAVE_FIT_CLUSTER if cluster is None else cluster
    if cluster not in WAVE_FIT_CLUSTERS:
        raise ValueError(f"wave_fit_and_score runs on {WAVE_FIT_CLUSTERS} blocks per pod, "
                         f"not {cluster}")
    device = packed_f.device
    if device.type == "cpu":
        return wave_fit_and_score_ref(cfg, planes, tables,
                                      unpack_features(packed_f, layout), logtab)
    if device.type != "cuda":
        raise ValueError(f"wave_fit_and_score runs on cpu or cuda, not {device}")
    from . import cuda

    nf = len(FILTER_NAMES) + 2 * cfg.max_constraints + 3
    p, ptrs = _fit_inputs(cfg, planes, tables, packed_f, layout, logtab, nf, cluster)
    P, nb = packed_f.shape[0], planes["alloc"].shape[0]
    feasible = torch.empty((P, nb), dtype=torch.bool, device=device)
    total = torch.empty((P, nb), dtype=torch.int32, device=device)
    raw = torch.empty((P, 2, nb), dtype=torch.int32, device=device)
    if P:
        cuda.launch("wave_fit_and_score", p,
                    ptrs + [feasible.data_ptr(), total.data_ptr(), raw.data_ptr(),
                            _fit_syncs_ptr(syncs, device)],
                    _stream(device), lib="fit_and_score")
        count_launch("wave_fit_and_score")
    return feasible, total


def fit_floor(syncs: torch.Tensor, n_pods: int = 1, cluster: int = FIT_CLUSTER,
              wave: bool = False) -> None:
    """The latency floor of a K4 launch (wave: K7's) (CUDA only, a
    measurement yardstick that no path runs): one launch on n_pods pods of
    `cluster` blocks of the kernel's size that makes the counted
    synchronisations a launch wrote into `syncs` (per pod: block barriers,
    folds, cluster barriers, exchanges, table folds over their words), with
    no node work."""
    from . import cuda

    if syncs.device.type != "cuda":
        raise ValueError("fit_floor runs on cuda only")
    _check(syncs, "syncs", syncs.device, torch.int32, (FIT_SYNC_WORDS,))
    sink = torch.empty(1, dtype=torch.int32, device=syncs.device)
    cuda.launch_fit_floor([int(x) for x in syncs.tolist()[:FIT_COUNTS]], n_pods, cluster,
                          SCAN_THREADS if wave else FIT_THREADS, not (wave and cluster == 1),
                          sink.data_ptr(), _stream(syncs.device))


def _fit_inputs(cfg: KernelConfig, planes: dict, tables: dict, packed_f: torch.Tensor,
                layout, logtab: torch.Tensor, nf: int, cluster: int):
    """Check K4's and K7's inputs; their FitParams and input pointers."""
    from . import cuda

    device = packed_f.device
    nb, R = planes["alloc"].shape
    P, F = packed_f.shape
    K = planes["domain"].shape[1]
    S = planes["sel_counts"].shape[1]
    T = planes["taints"].shape[1]
    Tp = planes["prefer_taints"].shape[1]
    W = planes["port_words"].shape[1]
    I = planes["image_kib"].shape[1]
    Ta = planes["ipa_term_key"].shape[0]
    A, G = tables["aff_match"].shape
    i32, b8 = torch.int32, torch.bool
    _check(packed_f, "packed features", device, i32)
    for name, dt, shape in (
        ("alloc", i32, (nb, R)), ("used", i32, (nb, R)),
        ("nonzero_used", i32, (nb, 2)), ("valid", b8, (nb,)),
        ("unsched", b8, (nb,)), ("group_id", i32, (nb,)),
        ("taints", i32, (nb, T)), ("prefer_taints", i32, (nb, Tp)),
        ("domain", i32, (nb, K)), ("sel_counts", i32, (nb, S)),
        ("port_words", i32, (nb, W)), ("image_kib", i32, (nb, I)),
        ("ipa_counts", i32, (nb, Ta)), ("ipa_anti", i32, (nb, Ta)),
        ("ipa_pref", i32, (nb, Ta)), ("ipa_term_key", i32, (Ta,)),
    ):
        _check(planes[name], name, device, dt, shape)
    for name, dt, shape in (
        ("aff_match", b8, (A, G)), ("aff_pref", i32, (A, G)),
        ("aff_allow", b8, (A, nb)), ("aff_has_pref", b8, (A,)),
    ):
        _check(tables[name], name, device, dt, shape)
    _check(logtab, "logtab", device, torch.float32, (nb + 1,))
    if len(cfg.topo_domains) != K:
        raise ValueError(f"config has {len(cfg.topo_domains)} topology keys, "
                         f"planes {K}")
    if max(PODS, *(c for c, _ in cfg.fit_resources), *cfg.balanced_resources) >= R:
        raise ValueError("config names a resource column beyond the planes")
    mc = cfg.max_constraints
    offs = _field_offsets(layout, {
        "req": R, "nz_req": 2, "name_idx": 1, "tol_unsched": 1, "aff_pin": 1,
        "tol": T, "tol_prefer": Tp, "aff_sig": 1, "ports": W, "has_ports": 1,
        "hard_active": mc, "hard_key": mc, "hard_sel": mc, "hard_skew": mc,
        "hard_self": mc, "soft_active": mc, "soft_key": mc, "soft_sel": mc,
        "img_idx": 8, "num_containers": 1, "ipa_match": Ta,
        "ipa_aff_t": cfg.max_ipa_terms, "ipa_aff_self": cfg.max_ipa_terms,
        "ipa_anti_t": cfg.max_ipa_terms, "ipa_pref_t": cfg.max_ipa_pref,
        "ipa_pref_w": cfg.max_ipa_pref})
    p = cuda.FitParams(
        P=P, Nb=nb, R=R, K=K, S=S, T=T, Tp=Tp, W=W, I=I, Ta=Ta, A=A, G=G, F=F,
        MC=mc, NF=nf, D=max(1, *cfg.topo_domains),
        strategy=_STRATEGY_CODE[cfg.strategy],
        n_fit=len(cfg.fit_resources), n_rtc=len(cfg.rtc_shape),
        bal_a=cfg.balanced_resources[0], bal_b=cfg.balanced_resources[1],
        w_fit=cfg.weight("NodeResourcesFit"),
        w_bal=cfg.weight("NodeResourcesBalancedAllocation"),
        w_taint=cfg.weight("TaintToleration"),
        w_aff=cfg.weight("NodeAffinity"),
        w_pts=cfg.weight("PodTopologySpread"),
        w_ipa=cfg.weight("InterPodAffinity"),
        w_img=cfg.weight("ImageLocality"),
        n_hard=min(mc, cfg.n_hard), n_soft=min(mc, cfg.n_soft),
        n_ipa_aff=min(cfg.max_ipa_terms, cfg.n_ipa_aff),
        n_ipa_anti=min(cfg.max_ipa_terms, cfg.n_ipa_anti),
        n_ipa_pref=min(cfg.max_ipa_pref, cfg.n_ipa_pref),
        ex_anti=int(cfg.ipa_existing_anti), ex_pref=int(cfg.ipa_existing_pref),
        ex_pref_add=int(cfg.ipa_existing_pref and not cfg.ipa_ignore_preferred_existing),
        cluster=cluster, **{f"f_{k}": v for k, v in offs.items()})
    for i, (col, w) in enumerate(cfg.fit_resources):
        p.fit_col[i], p.fit_w[i] = col, w
    for i, (x, y) in enumerate(cfg.rtc_shape):
        p.rtc_x[i], p.rtc_y[i] = x, y
    for i, dk in enumerate(cfg.topo_domains):
        p.topo_dk[i] = dk
    ptrs = [planes[k].data_ptr() for k in (
        "alloc", "used", "nonzero_used", "valid", "unsched", "group_id",
        "taints", "prefer_taints", "domain", "sel_counts", "port_words",
        "image_kib", "ipa_counts", "ipa_anti", "ipa_pref", "ipa_term_key")]
    ptrs += [tables[k].data_ptr() for k in (
        "aff_match", "aff_pref", "aff_allow", "aff_has_pref")]
    return p, ptrs + [packed_f.data_ptr(), logtab.data_ptr()]


# --------------------------------------------------------------------------
# the wave: K1 then K2
# --------------------------------------------------------------------------


def batched_assign(cfg: KernelConfig, planes: dict, tables: dict,
                   packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                   logtab: torch.Tensor, cursor_init=0,
                   sig_ids: torch.Tensor | None = None,
                   uniq_idx: torch.Tensor | None = None, frame_shift: int = 0,
                   carry_map: torch.Tensor | None = None,
                   sig_table: dict | None = None, n_shards: int | None = None) -> dict:
    """Greedy assignment of one padded pod wave (the reference's
    batched_assign): K1 over the pods, or with sig_ids/uniq_idx (signature
    dedup: sig_ids [P] int32 group ids, uniq_idx [C] int32 first-occurrence
    slots) over the signature rows only, then K2; with n_shards, K6 over
    that many node shards (the reference's sharded_batched_assign; K1's
    outputs do not depend on the sharding: the reference's
    _static_pod_parts uses its comm only for the global node index). Decisions, tie stream and
    planes are the same with and without dedup. Returns assign_scan's
    output dict: packed [P + 2] int32 = winners ++ [tie_consumed,
    tie_overflow], the carried planes, and with dedup sig_scores,
    sig_table and tiers.

    A chained wave (the pipelined launch) passes cursor_init as the
    predecessor's final cursor (a 0-d device tensor) with the host's
    frame_shift, and with cross-wave reuse carry_map [C] int32 (each
    signature slot's row in the previous table, -1 a miss) and sig_table,
    the previous chained wave's table, which must have been scored against
    this wave's input planes (the backend's gate, SignatureScoreCache)."""
    check_slice(cfg)
    if n_shards is not None:
        check_shards(n_shards, planes["alloc"].shape[0])
    static = static_parts(planes, tables, packed_f, layout, rows=uniq_idx)
    return _assign(cfg, planes, static, packed_f, layout, tie_words, cursor_init,
                   logtab, n_shards, sig_ids, uniq_idx, frame_shift, carry_map,
                   sig_table)
