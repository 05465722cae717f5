"""The scans past the card's largest cluster (ROADMAP B5): the pass plan.

Up to the card's largest thread-block cluster (16 blocks of 16384 node
slots on an H100, `kernels.scan_limits`) the launch plan of K2, K5 and K6
(`kernels.scan_plan`) is what it was, one pass a block. Past it the plan
keeps that many blocks and each walks its range in passes of
SCAN_MAX_SLOTS positions, its position words in a device-memory scratch
(`kernels.scan_pass_words`, csrc `scan_pass_words`). This file holds, on
the CPU: the pass plan for every bucket up to 2**21 slots at caps 8 and 16
on the configurations of tests/test_torch_scale.py, the scratch's words,
K5's per-pass node lists (`kernels.mask_pass_lists`) on a sparse row whose
block range passes the one-pass list's 65536 slots, and the first-use
label of a pass plan. The pass instances run only on a card: chip_smoke.py
phase 29 (e) holds them against the plain versions there.
"""

import random

import pytest
import torch

import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu_torch.ops import cuda
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing import synthetic_cluster as tsynthetic
from tests.test_torch_scale import CONFIGS, SHARDS, _config, _pass_plan

WIDE_BUCKETS = [1 << k for k in range(3, 22)]  # 8 .. 2097152 node slots


@pytest.mark.parametrize("name", CONFIGS)
def test_pass_plan_for_every_bucket_and_cap(name):
    """At caps 8 and 16, every bucket whose one-pass plan fits the cap keeps
    it (passes 1, no scratch); every other takes the cap's blocks of the
    pass instance with the fewest power-of-two passes of SCAN_MAX_SLOTS
    positions covering a block's walk, its tables in shared memory where
    they fit beside the words that are not per position. Nothing is
    refused, and the passes cover the walk exactly as _pass_plan says."""
    cfg, R, S = _config(name)
    for nb in WIDE_BUCKETS:
        for n_shards in SHARDS:
            if n_shards and n_shards > nb:
                continue
            for kernel, masked, pops in (
                    ("sharded_assign" if n_shards else "assign_scan", False, [None]),
                    ("gang_assign", True, [nb, max(1, nb // 8), 1])):
                if masked and n_shards:
                    continue
                for pop in pops:
                    free = tk.scan_plan(kernel, cfg, nb, n_shards, R=R, S=S, population=pop)
                    for cap in (8, 16):
                        plan = tk.scan_plan(kernel, cfg, nb, n_shards, R=R, S=S,
                                            population=pop, max_blocks=cap)
                        if free.blocks <= cap:
                            assert plan == free and plan.gtab == free.gtab
                            assert plan.passes == 1 and not plan.scratch
                            continue
                        assert plan == (cap, tk.SCAN_MAX_NPT) and plan.scratch
                        passes, gtab = _pass_plan(cfg, R, S, nb, cap, masked, pop or nb)
                        assert (plan.passes, plan.gtab) == (passes, gtab)
                        span = nb // cap
                        walk = span if not masked else min(span, pop or nb)
                        assert plan.passes * tk.SCAN_MAX_SLOTS >= walk
                        assert plan.passes == 1 or plan.passes * tk.SCAN_MAX_SLOTS // 2 < walk
    # the widths the chip's phase 29 (e) runs: two and four passes on 16
    if name != "widest":
        for nb, passes in ((524288, 2), (1048576, 4)):
            plan = tk.scan_plan("assign_scan", cfg, nb, R=R, S=S, max_blocks=16)
            assert plan == (16, 16) and plan.passes == passes and not plan.gtab
            plan = tk.scan_plan("sharded_assign", cfg, nb, 8, R=R, S=S, max_blocks=16)
            assert plan == (16, 16) and plan.passes == passes


def test_scan_pass_words_mirror_the_scratch():
    """scan_pass_words counts csrc scan_pass_words' layout field for field:
    3 (K5: 4) words by node slot, then per block passes x 1024 bit words and
    2 x passes x 16 x 32 ballot words; 0 for a one-pass scan. The pass
    instance keeps no position word in shared memory (scan_smem_words)."""
    cfg, R, S = _config("IPA wave")
    p = cuda.ScanParams(R=R, S=S, Nb=1 << 20, **tk._cfg_scan_fields(cfg))
    assert tk.scan_pass_words(p, 16, False) == 0
    one = tk.scan_smem_words(p, 16384, True)
    p.passes = 4
    per_block = 4 * 1024 + 2 * 4 * 16 * 32
    assert tk.scan_pass_words(p, 16, False) == 3 * (1 << 20) + 16 * per_block
    assert tk.scan_pass_words(p, 16, True) == 4 * (1 << 20) + 16 * per_block
    # the total, both raw scores (IPA and spread on) and the uint16 list
    assert tk.scan_smem_words(p, 16384, True) == one - 3 * 16384 - 8192
    assert tk.scan_smem_words(p, 65536, True) == tk.scan_smem_words(p, 16384, True)


def _sparse_masks(nb):
    """A row of every node of [0, nb * 3 / 4), and a sparse row whose last
    block range's nodes (more than one pass's 16384) sit past the one-pass
    list's 65536 slots, with a few nodes in every other range."""
    n_nodes = 3 * nb // 4
    full = torch.zeros(nb, dtype=torch.bool)
    full[:n_nodes] = True
    sparse = torch.zeros(nb, dtype=torch.bool)
    sparse[torch.arange(5, nb, 9973)] = True
    span = nb // 16
    last = 15 * span
    sparse[last + 70000:last + 70000 + 20000] = True
    sparse[last + 3] = True
    return torch.stack([full, sparse, torch.zeros(nb, dtype=torch.bool)])


@pytest.mark.parametrize("row", [0, 1])
def test_mask_pass_lists_cover_each_mask_node_once_in_order(row):
    """At 2**21 slots on 16 blocks (ranges of 131072, past the one-pass
    list's 65536) each block's passes list its range's mask nodes, each
    once and ascending, at most SCAN_MAX_SLOTS a pass and in as many passes
    as the plan gives; blocks in rank order, passes in order, are the row's
    mask nodes, the node order one block over every slot walks."""
    nb = 1 << 21
    masks = _sparse_masks(nb)
    population = int(masks.sum(dim=1).max())
    cfg, R, S = _config("SchedulingBasic")
    plan = tk.scan_plan("gang_assign", cfg, nb, R=R, S=S, population=population, max_blocks=16)
    span = nb // plan.blocks
    assert plan == (16, 16) and plan.scratch and span > tk.SCAN_MAX_RANGE
    assert plan.passes == 8  # min(131072, population) positions
    lists = tk.mask_pass_lists(masks, plan.blocks, plan.passes)
    m = masks[row]
    nodes = []
    for r, passes in enumerate(lists[row]):
        assert len(passes) == plan.passes
        for rel in passes:
            assert rel.numel() <= tk.SCAN_MAX_SLOTS
            assert (rel >= 0).all() and (rel < span).all()
            nodes.append(rel.to(torch.int64) + r * span)
    nodes = torch.cat(nodes)
    assert torch.equal(nodes, torch.nonzero(m).flatten())
    if row == 1:
        # the sparse row's last block walks two passes, past slot 65536
        last = lists[1][15]
        assert last[0].numel() == tk.SCAN_MAX_SLOTS and last[1].numel() > 0
        assert int(last[1].max()) >= tk.SCAN_MAX_RANGE


def test_a_new_pass_count_is_a_new_first_use(monkeypatch):
    """The backend's compile spans key K2's launches on the plan's pass
    count beside its blocks (kernels.plan_key): a pass plan is labelled
    /p<passes>/c<blocks>, and the same wave at another pass count is
    another first use."""
    cache, snap = tsynthetic(24, n_zones=4)
    backend = TorchBackend(cache.names, device="cpu")
    tel = backend.telemetry
    pods = [tw.make_pod(f"p{i}", cpu="100m", mem="64Mi", labels={"app": "x"})
            for i in range(4)]
    passes = {"n": 2}
    monkeypatch.setattr(tbackend, "scan_plan_for",
                        lambda *a, **k: tk.ScanPlan(16, 16, passes=passes["n"], scratch=True))
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    assert tel.compile_count("batched_assign") == 1
    passes["n"] = 4
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    assert tel.compile_count("batched_assign") == 2
    labels = tel.compiled_shapes("batched_assign")
    assert any(lb.endswith("/p2/c16") for lb in labels)
    assert any(lb.endswith("/p4/c16") for lb in labels)
    assert tk.plan_key(tk.ScanPlan(16, 16, passes=4, scratch=True)) == (16, 4)
    assert tk.plan_key(tk.ScanPlan(2, 16)) == (2, 0)
