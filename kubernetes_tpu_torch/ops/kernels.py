"""Dense scheduling kernels: plain PyTorch versions and the wrappers of
their hand-written CUDA kernels.

The reference package (kubernetes_tpu/ops/kernels.py) expresses the
scheduler's filter and score plugins as vectorized int32/float32 arithmetic
over the node axis and a wave of pods as a lax.scan. This module ports:

- static_parts  (K1, csrc/static_parts.cu) — the vmapped _static_pod_parts
- assign_scan   (K2, csrc/assign_scan.cu)  — _batched_assign_jit's scan,
  non-dedup tier, without hard spread constraints or inter-pod affinity
- scatter_rows  (K3, csrc/scatter_rows.cu) — backend._scatter_rows_jit
- fit_and_score (K4, csrc/fit_and_score.cu) — _fit_and_score_jit: one pod
  against every node, every filter (hard spread and inter-pod affinity
  included) and every score

Each has a plain version beside it (`*_ref`) computing the same function
with torch ops. A wrapper runs the plain version only when its tensors lie
on the CPU; on CUDA tensors it launches the kernel or raises. The plain
versions are the CPU tests' subject and the chip smoke run's oracle.

Bit-exact contract (as in the reference): int32 arithmetic with FLOOR
division, float32 with the host op order (BalancedAllocation; the spread
cost), the PodTopologySpread log weight read from a float32 numpy table,
and the tie-break word stream consumed exactly as CPython randrange does.
"""

from __future__ import annotations

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
# kernel and nowhere else (reset_launches() zeroes them)
LAUNCHES = {"static_parts": 0, "assign_scan": 0, "scatter_rows": 0,
            "fit_and_score": 0}

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
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class OutOfSlice(NotImplementedError):
    """The caller asks for a configuration or a path this port does not run
    yet (in the wave scan: hard spread constraints, inter-pod affinity,
    signature dedup or cross-wave reuse; in the single-pod cycle: the host
    framework's paths). Raised instead of computing an answer."""


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
    """The wave scan's gate (K1 + K2): raise OutOfSlice for any
    configuration they do not compute; everything that passes is computed
    bit-exactly."""
    if cfg.n_hard > 0:
        raise OutOfSlice(f"hard spread constraints (n_hard={cfg.n_hard})")
    if cfg.ipa_active:
        raise OutOfSlice("inter-pod affinity")
    if min(cfg.max_constraints, cfg.n_soft) > 4:
        raise OutOfSlice(f"{cfg.n_soft} soft spread constraint slots (max 4)")
    _check_common(cfg)


def check_fit_slice(cfg: KernelConfig) -> None:
    """K4's gate: hard spread and inter-pod affinity are computed; raise
    OutOfSlice only past the kernel's fixed slot and domain capacities."""
    if cfg.max_constraints > 4:
        raise OutOfSlice(f"{cfg.max_constraints} spread constraint slots (max 4)")
    if cfg.max_ipa_terms > 4 or cfg.max_ipa_pref > 8:
        raise OutOfSlice("inter-pod affinity term slots (max 4 required, "
                         "8 preferred)")
    _check_common(cfg)


def _check_common(cfg: KernelConfig) -> None:
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
    (np.log of a float32), as the host plugin computes it. The reference
    kernel's jnp.log differs from it by one ulp at some n; see the tests."""
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


def static_parts(planes: dict, tables: dict, packed_f: torch.Tensor,
                 layout) -> dict:
    """K1 wrapper: plain version for CPU tensors, the CUDA kernel for CUDA
    tensors. packed_f is the wave's [P, F] int32 feature buffer."""
    from .planes import unpack_features

    device = packed_f.device
    if device.type == "cpu":
        return static_parts_ref(planes, tables, unpack_features(packed_f, layout))
    if device.type != "cuda":
        raise ValueError(f"static_parts runs on cpu or cuda, not {device}")
    from . import cuda

    P, F = packed_f.shape
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
    p = cuda.StaticParams(P=P, Nb=nb, T=T, Tp=Tp, W=W, I=I, A=A, G=G, F=F,
                          **{f"f_{k}": v for k, v in offs.items()})
    out = {
        "static_ok": torch.empty((P, nb), dtype=b8, device=device),
        "taint_cnt": torch.empty((P, nb), dtype=i32, device=device),
        "aff_raw": torch.empty((P, nb), dtype=i32, device=device),
        "aff_has_pref": torch.empty((P,), dtype=b8, device=device),
        "img": torch.empty((P, nb), dtype=i32, device=device),
    }
    ptrs = [planes[k].data_ptr() for k in (
        "valid", "unsched", "group_id", "taints", "prefer_taints",
        "port_words", "image_kib")]
    ptrs += [tables[k].data_ptr() for k in (
        "aff_match", "aff_pref", "aff_allow", "aff_has_pref")]
    ptrs += [packed_f.data_ptr()] + [out[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img", "aff_has_pref")]
    if P and nb:
        cuda.launch("static_parts", p, ptrs, _stream(device))
        LAUNCHES["static_parts"] += 1
    return out


# --------------------------------------------------------------------------
# K2 assign_scan
# --------------------------------------------------------------------------


def _requested_for(used, nz_used, req, nz_req, col):
    """Requested-including-pod per node; cpu/mem use NonZero accounting
    (resource_allocation.go:138)."""
    if col == CPU:
        return nz_used[:, 0] + nz_req[0]
    if col == MEM:
        return nz_used[:, 1] + nz_req[1]
    return used[:, col] + req[col]


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


def _pts_domain_stats(cfg, domain, sel_counts, mask, key_i: int, sel_i: int):
    """One spread constraint's domain statistics (kernels.py:198):
    (has_key [Nb], count_at_node [Nb], min_count, ndom), the last two
    0-dim tensors. `mask` selects the participating nodes: every valid node
    for the hard filter (PreFilter), the feasible nodes for the soft score
    (PreScore). count_at_node means something only where mask & has_key.
    Per-domain sums are exact int32 (index_add_); a key slot outside the
    planes matches no node, as the reference's per-key select finds none."""
    nb, dev = domain.shape[0], domain.device
    if not 0 <= key_i < domain.shape[1]:
        z = torch.zeros(nb, dtype=torch.int32, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z.bool(), z, zero, zero
    cnt = sel_counts[:, sel_i]
    dom = domain[:, key_i]
    has_key = dom >= 0
    part = mask & has_key
    dk = cfg.topo_domains[key_i]
    if dk == 0:  # singleton key (hostname): the domain is the node
        count = cnt
        min_c = torch.where(part.any(), torch.where(part, cnt, _INT32_MAX).min(), 0)
        ndom = part.sum()
    else:
        dom_c = dom.clamp(0, dk - 1).long()
        seg = torch.zeros(dk, dtype=torch.int32, device=dev).index_add_(
            0, dom_c, torch.where(part, cnt, 0))
        pc = torch.zeros(dk, dtype=torch.int32, device=dev).index_add_(
            0, dom_c, part.to(torch.int32))
        present = pc > 0
        count = seg[dom_c]
        min_c = torch.where(present.any(), torch.where(present, seg, _INT32_MAX).min(), 0)
        ndom = present.sum()
    return has_key, count, min_c, ndom


def _pts_normalize(raw, any_active, feasible):
    """scoring.go:266-305: inverted min/max normalization over the feasible
    set (kernels.py:614). int32 throughout: with no feasible node the
    spread wraps as the reference's does."""
    mx = torch.where(feasible, raw, -_INT32_MAX).max()
    mn = torch.where(feasible, raw, _INT32_MAX).min()
    spread = mx - mn
    normed = torch.where(spread == 0, MAX_NODE_SCORE,
                         floordiv((mx - raw) * MAX_NODE_SCORE, spread.clamp(min=1)))
    return torch.where(any_active, normed, 0)


def _pts_score(cfg, domain, sel_counts, feasible, f, p, logtab):
    """podtopologyspread scoring.go:118-305 over the live feasible set:
    per-domain counts weighted by log(domains + 2), inverted min/max
    normalization."""
    nb = feasible.shape[0]
    dev = feasible.device
    if cfg.n_soft == 0:
        return torch.zeros(nb, dtype=torch.int32, device=dev)
    active = f["soft_active"][p] != 0
    cost = torch.zeros(nb, dtype=torch.float32, device=dev)
    for c in range(min(cfg.max_constraints, cfg.n_soft)):
        if not bool(active[c]):
            continue  # the reference adds +0.0 for an inactive slot
        has_key, count, _, nd = _pts_domain_stats(
            cfg, domain, sel_counts, feasible, int(f["soft_key"][p, c]),
            int(f["soft_sel"][p, c]))
        w = logtab[nd]
        cost = cost + torch.where(has_key, count.to(torch.float32) * w, 0.0)
    return _pts_normalize(cost.to(torch.int32), active.any(), feasible)


_POW2 = 2 ** torch.arange(32, dtype=torch.int64)


def _bit_length(n: torch.Tensor) -> torch.Tensor:
    """int.bit_length of a positive int64 scalar by comparisons (torch has
    no count-leading-zeros)."""
    return (n >= _POW2.to(n.device)).sum()


def assign_scan_ref(cfg: KernelConfig, planes: dict, static: dict, f: dict,
                    tie_words: torch.Tensor, cursor0: int, logtab: torch.Tensor):
    """Plain version of K2: a Python loop over the wave's pods, mirroring
    the reference's _assign_step (non-dedup branch, no hard spread, no IPA).
    Returns (packed [P + 2] int32 = winners ++ [tie_consumed, tie_overflow],
    used, nonzero_used, sel_counts) — the carry planes are new tensors."""
    alloc = planes["alloc"]
    domain = planes["domain"]
    used = planes["used"].clone()
    nz_used = planes["nonzero_used"].clone()
    sel_counts = planes["sel_counts"].clone()
    dev = alloc.device
    # the words as unsigned values in int64 (torch lacks uint32 shifts)
    words = tie_words.to(torch.int64) & 0xFFFFFFFF
    n_words = words.shape[0]
    draw_slots = torch.arange(MAX_TIE_DRAWS, dtype=torch.int64, device=dev)
    w_fit = cfg.weight("NodeResourcesFit")
    w_bal = cfg.weight("NodeResourcesBalancedAllocation")
    P = f["active"].shape[0]
    winners = []
    cursor, overflow = int(cursor0), False
    for p in range(P):
        if not bool(f["active"][p]):
            winners.append(-1)  # pad slot: places nothing, draws nothing
            continue
        req, nz_req = f["req"][p], f["nz_req"][p]
        # dynamic filter: NodeResourcesFit on the carried `used`
        insufficient = (req[None] > 0) & (req[None] > alloc - used)
        insufficient[:, PODS] = False
        too_many = used[:, PODS] + 1 > alloc[:, PODS]
        feasible = static["static_ok"][p] & ~(insufficient.any(1) | too_many)
        ew = (_fit_score(cfg, alloc, used, nz_used, req, nz_req) * w_fit
              + _balanced_score(cfg, alloc, used, nz_used, req, nz_req) * w_bal)
        pts = _pts_score(cfg, domain, sel_counts, feasible, f, p, logtab)
        # _finish_total: static raws normalized over the live feasible set
        tc = static["taint_cnt"][p]
        max_tc = torch.where(feasible, tc, 0).max()
        taint = torch.where(max_tc > 0, MAX_NODE_SCORE - floordiv(
            tc * MAX_NODE_SCORE, max_tc.clamp(min=1)), MAX_NODE_SCORE)
        ar = static["aff_raw"][p]
        mx_aff = torch.where(feasible, ar, 0).max()
        aff = torch.where(mx_aff > 0, floordiv(ar * MAX_NODE_SCORE,
                                               mx_aff.clamp(min=1)), ar)
        total = (ew + pts * cfg.weight("PodTopologySpread")
                 + static["img"][p] * cfg.weight("ImageLocality")
                 + taint * cfg.weight("TaintToleration")
                 + torch.where(static["aff_has_pref"][p], aff, 0)
                 * cfg.weight("NodeAffinity"))
        best = int(torch.where(feasible, total, -1).max())
        if best < 0:
            winners.append(-1)
            continue
        mask = feasible & (total == best)
        nw = mask.sum().to(torch.int64)
        r_final = 0
        if int(nw) > 1:
            # CPython randrange(nw): top k = nw.bit_length() bits of each
            # word, reject r >= nw, at most MAX_TIE_DRAWS words
            k = _bit_length(nw)
            idx = (cursor + draw_slots).clamp(0, n_words - 1)
            r = words[idx] >> (32 - k)
            accept = r < nw
            if bool(accept.any()):
                first = int(accept.to(torch.int32).argmax())
                r_final = int(r[first])
                cursor += first + 1
            else:
                cursor += MAX_TIE_DRAWS
                overflow = True
        win = int(torch.nonzero(mask)[r_final, 0])
        used[win] += req
        nz_used[win] += nz_req
        sel_counts[win] += f["sig_match"][p]
        winners.append(win)
    packed = torch.tensor(winners + [cursor, int(overflow)], dtype=torch.int32,
                          device=dev)
    return packed, used, nz_used, sel_counts


def assign_scan(cfg: KernelConfig, planes: dict, static: dict,
                packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                cursor0: int, logtab: torch.Tensor):
    """K2 wrapper: the greedy wave scan. Returns (packed [P + 2] int32,
    used, nonzero_used, sel_counts); the carry planes are copies of the
    inputs, which stay untouched."""
    from .planes import unpack_features

    check_slice(cfg)
    device = packed_f.device
    if device.type == "cpu":
        return assign_scan_ref(cfg, planes, static,
                               unpack_features(packed_f, layout), tie_words,
                               cursor0, logtab)
    if device.type != "cuda":
        raise ValueError(f"assign_scan runs on cpu or cuda, not {device}")
    from . import cuda

    P, F = packed_f.shape
    nb, R = planes["alloc"].shape
    K = planes["domain"].shape[1]
    S = planes["sel_counts"].shape[1]
    i32, b8 = torch.int32, torch.bool
    _check(packed_f, "packed features", device, i32)
    for name, dt, shape in (
        ("alloc", i32, (nb, R)), ("used", i32, (nb, R)),
        ("nonzero_used", i32, (nb, 2)), ("domain", i32, (nb, K)),
        ("sel_counts", i32, (nb, S)),
    ):
        _check(planes[name], name, device, dt, shape)
    for name, dt, shape in (
        ("static_ok", b8, (P, nb)), ("taint_cnt", i32, (P, nb)),
        ("aff_raw", i32, (P, nb)), ("img", i32, (P, nb)),
        ("aff_has_pref", b8, (P,)),
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
    offs = _field_offsets(layout, {
        "req": R, "nz_req": 2, "soft_active": mc, "soft_key": mc,
        "soft_sel": mc, "sig_match": S, "active": 1})
    if min(cfg.max_constraints, cfg.n_soft) > mc:
        raise ValueError(f"config traces {cfg.n_soft} soft slots, features hold {mc}")
    p = cuda.ScanParams(
        P=P, Nb=nb, R=R, K=K, S=S, F=F, MC=mc, L=tie_words.numel(),
        cursor0=int(cursor0), strategy=_STRATEGY_CODE[cfg.strategy],
        n_fit=len(cfg.fit_resources), n_rtc=len(cfg.rtc_shape),
        bal_a=cfg.balanced_resources[0], bal_b=cfg.balanced_resources[1],
        w_fit=cfg.weight("NodeResourcesFit"),
        w_bal=cfg.weight("NodeResourcesBalancedAllocation"),
        w_pts=cfg.weight("PodTopologySpread"),
        w_img=cfg.weight("ImageLocality"),
        w_taint=cfg.weight("TaintToleration"),
        w_aff=cfg.weight("NodeAffinity"),
        n_soft=min(cfg.max_constraints, cfg.n_soft),
        **{f"f_{k}": v for k, v in offs.items()})
    for i, (col, w) in enumerate(cfg.fit_resources):
        p.fit_col[i], p.fit_w[i] = col, w
    for i, (x, y) in enumerate(cfg.rtc_shape):
        p.rtc_x[i], p.rtc_y[i] = x, y
    for i, dk in enumerate(cfg.topo_domains):
        p.topo_dk[i] = dk
    used = planes["used"].clone()
    nz_used = planes["nonzero_used"].clone()
    sel_counts = planes["sel_counts"].clone()
    scratch = {
        "feas": torch.empty(nb, dtype=torch.uint8, device=device),
        "ew": torch.empty(nb, dtype=i32, device=device),
        "raw": torch.empty(nb, dtype=i32, device=device),
        "total": torch.empty(nb, dtype=i32, device=device),
    }
    packed = torch.empty(P + 2, dtype=i32, device=device)
    ptrs = [planes["alloc"].data_ptr(), planes["domain"].data_ptr()]
    ptrs += [static[k].data_ptr() for k in (
        "static_ok", "taint_cnt", "aff_raw", "img", "aff_has_pref")]
    ptrs += [packed_f.data_ptr(), tie_words.data_ptr(), logtab.data_ptr(),
             used.data_ptr(), nz_used.data_ptr(), sel_counts.data_ptr()]
    ptrs += [scratch[k].data_ptr() for k in ("feas", "ew", "raw", "total")]
    ptrs += [packed.data_ptr()]
    cuda.launch("assign_scan", p, ptrs, _stream(device))
    LAUNCHES["assign_scan"] += 1
    return packed, used, nz_used, sel_counts


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


def scatter_rows(dst: dict, rows: dict, idx: torch.Tensor) -> None:
    """K3 wrapper: one launch scatters every plane's rows in place."""
    device = idx.device
    if device.type == "cpu":
        scatter_rows_ref(dst, rows, idx)
        return
    if device.type != "cuda":
        raise ValueError(f"scatter_rows runs on cpu or cuda, not {device}")
    from . import cuda

    if len(dst) > cuda.MAX_PLANES:
        raise ValueError(f"{len(dst)} planes; the kernel takes {cuda.MAX_PLANES}")
    _check(idx, "idx", device, torch.int32)
    n = idx.numel()
    p = cuda.ScatterParams(n_planes=len(dst), n_rows=n)
    for i, (k, t) in enumerate(dst.items()):
        _check(t, k, device, t.dtype)
        _check(rows[k], f"rows[{k}]", device, t.dtype, (n,) + tuple(t.shape[1:]))
        p.row_bytes[i] = t[0].numel() * t.element_size() if t.shape[0] else 0
        p.dst_rows[i] = t.shape[0]
        p.dst[i] = t.data_ptr()
        p.src[i] = rows[k].data_ptr()
    if n:
        cuda.launch("scatter_rows", p, [idx.data_ptr()], _stream(device))
        LAUNCHES["scatter_rows"] += 1


# --------------------------------------------------------------------------
# K4 fit_and_score
# --------------------------------------------------------------------------


def _domain_sum_at_node(cfg, domain, k: int, col, part):
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
    seg = torch.zeros(dk, dtype=torch.int32, device=dom.device).index_add_(
        0, dom_c, masked)
    return has_key, seg[dom_c]


def _ipa_term_stats(cfg, planes, t: int, part):
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
    has_key, at = _domain_sum_at_node(cfg, planes["domain"], key_i, cnt, part)
    anywhere = bool(torch.where(part & has_key, cnt, 0).sum() > 0)
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


def _ipa_filters(cfg, planes, fp):
    """InterPodAffinity's three checks (filtering.go:352-412, kernels.py:347):
    (existing pods' anti-affinity, the pod's anti-affinity, the pod's
    affinity) reject rows over every valid node."""
    valid = planes["valid"]
    fail1 = torch.zeros_like(valid)
    fail2 = torch.zeros_like(valid)
    fail3 = torch.zeros_like(valid)
    if cfg.ipa_existing_anti:
        for k, col in _existing_term_cols(cfg, planes, "ipa_anti", fp):
            has_key, at = _domain_sum_at_node(cfg, planes["domain"], k, col, valid)
            fail1 = fail1 | (has_key & (at > 0))
    for s in range(min(cfg.max_ipa_terms, cfg.n_ipa_anti)):
        t = int(fp["ipa_anti_t"][s])
        if t < 0:
            continue  # inactive slot
        has_key, at, _ = _ipa_term_stats(cfg, planes, t, valid)
        fail2 = fail2 | (has_key & (at > 0))
    for s in range(min(cfg.max_ipa_terms, cfg.n_ipa_aff)):
        t = int(fp["ipa_aff_t"][s])
        if t < 0:
            continue
        has_key, at, anywhere = _ipa_term_stats(cfg, planes, t, valid)
        # self-match bootstrap: a term that matches nowhere passes when the
        # pod matches its own term
        if anywhere or not bool(fp["ipa_aff_self"][s]):
            fail3 = fail3 | ~(has_key & (at > 0))
    return fail1, fail2, fail3


def _ipa_score(cfg, planes, fp, feasible):
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
        has_key, at, _ = _ipa_term_stats(cfg, planes, t, feasible)
        raw = raw + torch.where(has_key, int(fp["ipa_pref_w"][s]) * at, 0)
    if cfg.ipa_existing_pref and not cfg.ipa_ignore_preferred_existing:
        for k, col in _existing_term_cols(cfg, planes, "ipa_pref", fp):
            has_key, at = _domain_sum_at_node(cfg, planes["domain"], k, col, feasible)
            raw = raw + torch.where(has_key, at, 0)
    mx = torch.where(feasible, raw, -_INT32_MAX).max()
    mn = torch.where(feasible, raw, _INT32_MAX).min()
    spread = mx - mn
    return torch.where(
        spread == 0, torch.where(mx > 0, MAX_NODE_SCORE, 0),
        floordiv(MAX_NODE_SCORE * (raw - mn), spread.clamp(min=1)))


def _taint_score(planes, fp, feasible):
    """taint_toleration.go:180-215 (kernels.py:590): intolerable
    PreferNoSchedule taints, inverted over the feasible set."""
    ptid = planes["prefer_taints"]
    tolp = (fp["tol_prefer"] != 0)[ptid.clamp(min=0).long()]
    count = ((ptid >= 0) & ~tolp).sum(1, dtype=torch.int32)
    max_count = torch.where(feasible, count, 0).max()
    return torch.where(
        max_count > 0,
        MAX_NODE_SCORE - floordiv(count * MAX_NODE_SCORE, max_count.clamp(min=1)),
        MAX_NODE_SCORE)


def _node_affinity_score(planes, tables, fp, feasible):
    """node_affinity.go:272 normalized to max 100 over the feasible set
    (kernels.py:604); the raw value where that max is 0."""
    sig = int(fp["aff_sig"])
    raw = tables["aff_pref"][sig][planes["group_id"].long()]
    mx = torch.where(feasible, raw, 0).max()
    normed = torch.where(mx > 0, floordiv(raw * MAX_NODE_SCORE, mx.clamp(min=1)), raw)
    return torch.where(tables["aff_has_pref"][sig], normed, 0)


def filter_masks_ref(cfg: KernelConfig, planes: dict, tables: dict, fp: dict):
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
            int(fp["hard_key"][c]), int(fp["hard_sel"][c]))
        skew = count + fp["hard_self"][c] - min_c
        missing.append(~has_key)
        skewed.append(has_key & (skew > fp["hard_skew"][c]))
    ipa1, ipa2, ipa3 = _ipa_filters(cfg, planes, fp)
    fails = torch.stack([f_unsched, f_name, f_taint, f_aff | f_pin, f_ports, f_fit]
                        + missing + skewed + [ipa1, ipa2, ipa3])
    feasible = valid & ~fails.any(0)
    return fails, feasible, insufficient.T.contiguous(), too_many


def scores_ref(cfg: KernelConfig, planes: dict, tables: dict, f: dict, p: int,
               feasible, logtab):
    """Every score plugin for pod p of the feature views f (kernels.py:731):
    (weighted total [Nb], per-plugin scores) on every row, infeasible and
    pad rows included."""
    fp = {k: v[p] for k, v in f.items()}
    alloc, used, nz = planes["alloc"], planes["used"], planes["nonzero_used"]
    per = {
        "NodeResourcesFit": _fit_score(cfg, alloc, used, nz, fp["req"], fp["nz_req"]),
        "NodeResourcesBalancedAllocation": _balanced_score(
            cfg, alloc, used, nz, fp["req"], fp["nz_req"]),
        "TaintToleration": _taint_score(planes, fp, feasible),
        "NodeAffinity": _node_affinity_score(planes, tables, fp, feasible),
        "PodTopologySpread": _pts_score(cfg, planes["domain"], planes["sel_counts"],
                                        feasible, f, p, logtab),
        "InterPodAffinity": _ipa_score(cfg, planes, fp, feasible),
        "ImageLocality": _image_score(planes, {k: v[p: p + 1] for k, v in f.items()})[0],
    }
    total = torch.zeros_like(per["NodeResourcesFit"])
    for name in PLUGIN_NAMES:
        total = total + per[name] * cfg.weight(name)
    return total, per


def fit_and_score_ref(cfg: KernelConfig, planes: dict, tables: dict, f: dict,
                      logtab, p: int = 0) -> dict:
    """Plain version of K4 (the reference's _fit_and_score_jit) for pod p of
    the feature views f: fails, feasible, insufficient, too_many_pods,
    total (-1 where infeasible) and per_plugin (every row, unmasked)."""
    fp = {k: v[p] for k, v in f.items()}
    fails, feasible, insufficient, too_many = filter_masks_ref(cfg, planes, tables, fp)
    total, per = scores_ref(cfg, planes, tables, f, p, feasible, logtab)
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


def fit_and_score(cfg: KernelConfig, planes: dict, tables: dict,
                  packed_f: torch.Tensor, layout, logtab: torch.Tensor) -> torch.Tensor:
    """K4 wrapper: one block per pod of the [P, F] packed features against
    every node. Returns the packed outputs [P, bytes] uint8 (views by
    unpack_fit_outputs) — the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. planes holds the row planes and ipa_term_key."""
    from .planes import unpack_features

    check_fit_slice(cfg)
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
        **{f"f_{k}": v for k, v in offs.items()})
    for i, (col, w) in enumerate(cfg.fit_resources):
        p.fit_col[i], p.fit_w[i] = col, w
    for i, (x, y) in enumerate(cfg.rtc_shape):
        p.rtc_x[i], p.rtc_y[i] = x, y
    for i, dk in enumerate(cfg.topo_domains):
        p.topo_dk[i] = dk
    _, per_pod = fit_output_bytes(nb, nf, R)
    out = torch.empty((P, per_pod), dtype=torch.uint8, device=device)
    ptrs = [planes[k].data_ptr() for k in (
        "alloc", "used", "nonzero_used", "valid", "unsched", "group_id",
        "taints", "prefer_taints", "domain", "sel_counts", "port_words",
        "image_kib", "ipa_counts", "ipa_anti", "ipa_pref", "ipa_term_key")]
    ptrs += [tables[k].data_ptr() for k in (
        "aff_match", "aff_pref", "aff_allow", "aff_has_pref")]
    ptrs += [packed_f.data_ptr(), logtab.data_ptr(), out.data_ptr()]
    if P:
        cuda.launch("fit_and_score", p, ptrs, _stream(device))
        LAUNCHES["fit_and_score"] += 1
    return out


# --------------------------------------------------------------------------
# the wave: K1 then K2
# --------------------------------------------------------------------------


def batched_assign(cfg: KernelConfig, planes: dict, tables: dict,
                   packed_f: torch.Tensor, layout, tie_words: torch.Tensor,
                   logtab: torch.Tensor, cursor_init: int = 0):
    """Greedy assignment of one padded pod wave (the reference's
    batched_assign with sig_ids=None): returns (packed [P + 2] int32 =
    winners ++ [tie_consumed, tie_overflow], dict with the output
    used/nonzero_used/sel_counts planes)."""
    check_slice(cfg)
    static = static_parts(planes, tables, packed_f, layout)
    packed, used, nz_used, sel_counts = assign_scan(
        cfg, planes, static, packed_f, layout, tie_words, cursor_init, logtab)
    return packed, {"used": used, "nonzero_used": nz_used,
                    "sel_counts": sel_counts}
