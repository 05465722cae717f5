"""Dense scheduling kernels of the wave path: plain PyTorch versions and the
wrappers of their hand-written CUDA kernels.

The reference package (kubernetes_tpu/ops/kernels.py) expresses the
scheduler's filter and score plugins as vectorized int32/float32 arithmetic
over the node axis and a wave of pods as a lax.scan. This module ports the
slice the SchedulingBasic wave path runs:

- static_parts  (K1, csrc/static_parts.cu) — the vmapped _static_pod_parts
- assign_scan   (K2, csrc/assign_scan.cu)  — _batched_assign_jit's scan,
  non-dedup tier, without hard spread constraints or inter-pod affinity
- scatter_rows  (K3, csrc/scatter_rows.cu) — backend._scatter_rows_jit

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
LAUNCHES = {"static_parts": 0, "assign_scan": 0, "scatter_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class OutOfSlice(NotImplementedError):
    """The wave asks for a kernel configuration this port does not run yet
    (hard spread constraints, inter-pod affinity, signature dedup or
    cross-wave reuse). Raised instead of computing an answer."""


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
    """Raise OutOfSlice for any configuration the ported kernels do not
    compute; everything that passes is computed bit-exactly."""
    if cfg.n_hard > 0:
        raise OutOfSlice(f"hard spread constraints (n_hard={cfg.n_hard})")
    if cfg.ipa_active:
        raise OutOfSlice("inter-pod affinity")
    if min(cfg.max_constraints, cfg.n_soft) > 4:
        raise OutOfSlice(f"{cfg.n_soft} soft spread constraint slots (max 4)")
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
        tw = tw + torch.where(ok, w, 0)
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


def _pts_score(cfg, domain, sel_counts, feasible, f, p, logtab):
    """podtopologyspread scoring.go:118-305 over the live feasible set:
    per-domain counts weighted by log(domains + 2), inverted min/max
    normalization. Segment keys sum exactly in int32 (index_add_)."""
    nb = feasible.shape[0]
    dev = feasible.device
    if cfg.n_soft == 0:
        return torch.zeros(nb, dtype=torch.int32, device=dev)
    active = f["soft_active"][p] != 0
    cost = torch.zeros(nb, dtype=torch.float32, device=dev)
    for c in range(min(cfg.max_constraints, cfg.n_soft)):
        if not bool(active[c]):
            continue  # the reference adds +0.0 for an inactive slot
        k = int(f["soft_key"][p, c])
        cnt = sel_counts[:, int(f["soft_sel"][p, c])]
        dom = domain[:, k]
        has_key = dom >= 0
        part = feasible & has_key
        dk = cfg.topo_domains[k]
        if dk == 0:
            count = cnt
            nd = part.sum()
        else:
            dom_c = dom.clamp(0, dk - 1).long()
            seg = torch.zeros(dk, dtype=torch.int32, device=dev).index_add_(
                0, dom_c, torch.where(part, cnt, 0))
            pc = torch.zeros(dk, dtype=torch.int32, device=dev).index_add_(
                0, dom_c, part.to(torch.int32))
            count = seg[dom_c]
            nd = (pc > 0).sum()
        w = logtab[nd]
        cost = cost + torch.where(has_key, count.to(torch.float32) * w, 0.0)
    raw = cost.to(torch.int32)
    mx = torch.where(feasible, raw, -_INT32_MAX).max()
    mn = torch.where(feasible, raw, _INT32_MAX).min()
    spread = mx - mn
    normed = torch.where(spread == 0, MAX_NODE_SCORE,
                         floordiv((mx - raw) * MAX_NODE_SCORE, spread.clamp(min=1)))
    return torch.where(active.any(), normed, 0)


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
