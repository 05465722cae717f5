"""The walk claims of the redesigned scan step (K2, K5 and K6 in
csrc/scan_step.cuh), on the CPU against the reference package.

The kernels no longer visit every node slot of the bucket: K2 (and each K6
shard) walks [0, live extent) of its range, and each K5 row walks the
ascending list of its mask's nodes. These tests state the two launch
arguments' rules as plain helpers (kernels.live_extent and
kernels.mask_node_lists, which the kernels compute the same way on the
device) and show that a scan over the walked nodes alone equals the
reference over the whole bucket:

- each K5 row's scan over its mask list (the planes gathered to the list,
  the winners mapped back) equals the full masked scan of the plain
  version and JAX gang_assign on every output, on masks whose nodes are
  not contiguous, with deleted nodes inside them, hard spread and IPA
  members, a tie stream that runs out, and a Preferred fallback row;
- K2's scan over [0, live extent) with the padding constants past it
  equals JAX batched_assign on every output array, on a bucket with
  deleted nodes and padding rows.

Every comparison is exact (integers and bools: tolerance 0).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.scheduler.tpu.backend import clone_tie_words
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    unpack_features,
)
from tests.test_torch_gang import _kernel_inputs as _gang_inputs
from tests.test_torch_gang import _unpack
from tests.test_torch_pipeline import _assert_equal_outputs
from tests.test_torch_pipeline import _kernel_inputs as _wave_inputs

# node-indexed planes a scan reads (ipa_term_key is per term, not per node)
_NODE_PLANES = ("alloc", "used", "nonzero_used", "domain", "sel_counts", "valid",
                "ipa_counts", "ipa_anti", "ipa_pref")
_STATIC_ROWS = ("static_ok", "taint_cnt", "aff_raw", "img")


def _delete(arrays, rows, zero=False):
    """Mark node rows deleted in the reference's plane arrays: invalid,
    with their rows zeroed when `zero` (a slot past the last live node)."""
    out = {k: np.array(v) for k, v in arrays.items()}
    for i in rows:
        out["valid"][i] = False
        if zero:
            for k in ("alloc", "used", "nonzero_used"):
                out[k][i] = 0
    return out


def _gather(planes, static, idx):
    """The planes and K1 rows at node indices idx, in that order."""
    g = {k: (v[idx] if k in _NODE_PLANES else v) for k, v in planes.items()}
    s = {k: (v[:, idx] if k in _STATIC_ROWS else v) for k, v in static.items()}
    return g, s


def _port_side(cfg, arrays, feats):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    return pcfg, dplanes, dtables, packed_f, layout


def test_mask_node_lists_are_ascending_mask_nodes():
    """Each row's list is exactly its mask's nodes, ascending; an empty
    mask gives an empty list."""
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(rng.random((5, 77)) < 0.3)
    masks[2] = False
    lists = tk.mask_node_lists(masks)
    for m, lst in zip(masks, lists):
        assert lst.tolist() == np.flatnonzero(m.numpy()).tolist()
        assert (lst[1:] > lst[:-1]).all()
    assert lists[2].numel() == 0


def test_live_extent_rule():
    """The extent ends at the last row that is valid or holds a nonzero
    alloc, used or nonzero_used entry, or a feasible entry of a seeded
    previous table row; a shard's extent is relative to its range."""
    nb = 16
    planes = {"valid": torch.zeros(nb, dtype=torch.bool),
              "alloc": torch.zeros((nb, 4), dtype=torch.int32),
              "used": torch.zeros((nb, 4), dtype=torch.int32),
              "nonzero_used": torch.zeros((nb, 2), dtype=torch.int32)}
    assert tk.live_extent(planes) == 0
    planes["valid"][:5] = True
    assert tk.live_extent(planes) == 5
    planes["used"][9, 3] = 1  # a deleted node's stale row
    assert tk.live_extent(planes) == 10
    table = {"feas": torch.zeros((3, nb), dtype=torch.bool)}
    table["feas"][2, 12] = True
    assert tk.live_extent(planes, table, torch.tensor([0, -1], dtype=torch.int32)) == 10
    assert tk.live_extent(planes, table, torch.tensor([2, -1], dtype=torch.int32)) == 13
    assert tk.live_extent(planes, lo=8, hi=16) == 2
    assert tk.live_extent(planes, lo=12, hi=16) == 0


def test_scan_refuses_a_block_past_its_slots():
    """One block takes up to SCAN_MAX_SLOTS node slots, and up to the
    largest thread-block cluster the card holds the plan cuts a bucket (or
    a K6 shard) into blocks of at most SCAN_MAX_SLOTS, one pass each. Past
    that cap a block walks its range in passes of SCAN_MAX_SLOTS positions
    (the pass instance) instead of being refused."""
    cfg = tk.KernelConfig()
    assert tk.scan_plan("assign_scan", cfg, tk.SCAN_MAX_SLOTS, R=4, S=8, max_blocks=8) == (1, 16)
    for cap in (8, 16):
        top = cap * tk.SCAN_MAX_SLOTS
        plan = tk.scan_plan("assign_scan", cfg, top, R=4, S=8, max_blocks=cap)
        assert plan == (cap, 16) and plan.passes == 1 and not plan.scratch
        for kernel in ("assign_scan", "gang_assign"):
            plan = tk.scan_plan(kernel, cfg, 2 * top, R=4, S=8, max_blocks=cap)
            assert plan == (cap, 16) and plan.passes == 2 and plan.scratch


GANG_CASES = ["mixed-existing", "pads-3-words"]


@pytest.mark.parametrize("case", GANG_CASES)
def test_gang_row_walks_its_mask_list(case):
    """K5's rows over their mask lists == the full masked scan == JAX
    gang_assign, every element of the packed vector, with two nodes deleted
    inside the masks (invalid, their rows kept)."""
    cfg, planes, arrays, feats, masks, words, nc, hf = _gang_inputs(case)
    live = np.flatnonzero(arrays["valid"])
    arrays = _delete(arrays, [int(live[1]), int(live[-2])])
    want = np.asarray(jk.gang_assign(cfg, arrays, feats, masks, words, nc, hf))
    pcfg, dplanes, dtables, packed_f, layout = _port_side(cfg, arrays, feats)
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    tmasks = torch.from_numpy(masks)
    tw = torch.from_numpy(words.view(np.int32))
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    fv = unpack_features(packed_f, layout)
    full = tk.gang_assign_ref(pcfg, dplanes, static, fv, tmasks, tw, logtab, nc, hf)
    assert np.array_equal(full.numpy(), want)
    d, p = masks.shape[0], feats["active"].shape[0]
    ref = _unpack(want, d, p)
    active = fv["active"] != 0
    walked = []
    for row, idx in enumerate(tk.mask_node_lists(tmasks)):
        if idx.numel() == 0:  # a pad row: nothing to walk, nothing placed or drawn
            assert (ref["winners"][row] == -1).all() and ref["consumed"][row] == 0
            assert ref["overflow"][row] == 0 and ref["score"][row] == 0
            continue
        gp, gs = _gather(dplanes, static, idx)
        packed = tk.assign_scan_ref(pcfg, gp, gs, fv, tw, 0, logtab)["packed"]
        pos = packed[:-2]
        wins = torch.where(pos >= 0, idx[pos.clamp(min=0).long()], -1)
        assert wins.tolist() == ref["winners"][row].tolist()
        assert int(packed[-2]) == ref["consumed"][row] and int(packed[-1]) == ref["overflow"][row]
        assert int(((wins >= 0) & active).sum()) == ref["placed"][row]
        score = tk.gang_placement_score_ref(gp, torch.ones(idx.numel(), dtype=torch.bool))
        assert int(score) == ref["score"][row]
        walked.append(idx.numel())
    # the rows walk their masks only: fewer nodes than the bucket
    assert max(walked) < planes.nb
    if case == "mixed-existing":  # Preferred: the fallback row walks every mask node
        assert cfg.n_hard and cfg.ipa_active and hf
        assert walked[nc] == int(masks[nc].sum()) > max(walked[:nc])
    if case == "pads-3-words":
        assert ref["overflow"][: nc + int(hf)].any()


WAVE_CASES = ["basic", "hard-zone"]


@pytest.mark.parametrize("case", WAVE_CASES)
def test_wave_walks_the_live_extent(case):
    """K2 over [0, live extent) — the planes and K1's rows cut there, the
    padding constants past it (ew 0, ffit True, feas False, sig_scores -1)
    and the untouched rows of the carry — equals JAX batched_assign on
    every output array, on a bucket with padding rows, an interior deleted
    node and a deleted last node (its rows zeroed)."""
    cfg, planes, arrays, feats, sig_ids, uniq = _wave_inputs(case)
    n = planes.n
    assert n < planes.nb or case == "hard-zone"  # padding rows (hard-zone: the deleted last)
    arrays = _delete(arrays, [2], zero=False)
    arrays = _delete(arrays, [n - 1], zero=True)
    pad = feats["active"].shape[0]
    words = clone_tie_words(random.Random(31), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, want = jk.batched_assign(cfg, arrays, feats, words, sig_ids=sig_ids, uniq_idx=uniq)
    pcfg, dplanes, dtables, packed_f, layout = _port_side(cfg, arrays, feats)
    as_t = (lambda a: torch.from_numpy(np.asarray(a, np.int32)))
    sig_t, uniq_t = as_t(sig_ids), as_t(uniq)
    static = tk.static_parts(dplanes, dtables, packed_f, layout, rows=uniq_t)
    hi = tk.live_extent(dplanes)
    assert hi == n - 1
    cut, cut_static = _gather(dplanes, static, torch.arange(hi))
    tw = torch.from_numpy(words.view(np.int32))
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    got = tk.assign_scan_ref(pcfg, cut, cut_static, unpack_features(packed_f, layout), tw, 0, logtab,
                             sig_t, uniq_t)
    # the walk's outputs, widened back to the bucket
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        if k in got:
            got[k] = torch.cat([got[k], dplanes[k][hi:]])
    g = got["sig_scores"].shape[0]
    tail = planes.nb - hi
    got["sig_scores"] = torch.cat([got["sig_scores"],
                                   torch.full((g, tail), -1, dtype=torch.int32)], dim=1)
    tab = got["sig_table"]
    # a fresh table's rows are captured once their signature takes a step
    captured = torch.zeros((g, 1), dtype=torch.bool)
    captured[sig_t.long()] = True
    tab["ew"] = torch.cat([tab["ew"], torch.zeros((g, tail), dtype=torch.int32)], dim=1)
    tab["ffit"] = torch.cat([tab["ffit"], captured.expand(g, tail)], dim=1)
    tab["feas"] = torch.cat([tab["feas"], torch.zeros((g, tail), dtype=torch.bool)], dim=1)
    _assert_equal_outputs(got, want)
    assert int((got["packed"][:-2] >= 0).sum()) > 0
