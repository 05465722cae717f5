"""The wave and gang scans past one block's 16384 node slots (ROADMAP B2).

The port's scans K2, K5 and K6 walk a bucket of node slots with one block
of 1024 threads, at most 16 positions a thread. Past that the launch plan
(`kernels.scan_plan`) cuts the bucket into the blocks of one thread-block
cluster: this file holds the plan on the CPU (its block counts, positions
and shared memory for the configurations the port runs, and its refusal
only past the card's largest cluster), K5's per-block node lists, the
first-use signature that carries the block count, and the port's plain
versions and Scheduler against the reference package past the old cap:
batched_assign (dedup on, a seeded cross-wave chain) and gang_assign
(Preferred with the fallback row over every node) at 16500 nodes (bucket
32768), and a Scheduler(device="cpu") stream over a 17000-node store.
Every comparison is exact: the outputs are integers and bools. The
kernels themselves run only on a card (chip_smoke.py phase 29 holds them
against these plain versions there).
"""

import contextlib
import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features as jpad
from kubernetes_tpu.ops.planes import placement_masks as jmasks
from kubernetes_tpu.ops.planes import stack_features as jstack
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu.testing import make_node as jmake_node
from kubernetes_tpu.testing import make_pod as jmake_pod
from kubernetes_tpu.testing import synthetic_cluster as jsynthetic
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import cuda
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    pack_features,
    pad_features,
    planes_from_reference,
    stack_features,
)
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing import synthetic_cluster as tsynthetic
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, ipa_pods, mixed_spec
from tests.test_torch_loop import SIDES, _port_registry  # noqa: F401 (autouse)
from tests.test_torch_loop_golden import _run_stream
from tests.test_torch_pipeline import (  # noqa: F401 (autouse, C12)
    _assert_equal_outputs,
    _crafted_map,
    _own_process_state,
    _port_wave,
)
from kubernetes_tpu_torch.ops.planes import sig_table_from_reference

BUCKETS = [1 << k for k in range(3, 20)]  # 8 .. 524288 node slots
SHARDS = [None, 1, 2, 4, 8]


# --------------------------------------------------------------------------
# the launch plan
# --------------------------------------------------------------------------


def _port_inputs(nodes, existing, wave):
    """(backend, planes, features) of the port's backend for `wave` over
    `nodes` with `existing` pods assumed round-robin."""
    cache = TCache(TNames())
    for n in nodes:
        cache.add_node(n)
    backend = TorchBackend(cache.names, device="cpu")
    for i, pod in enumerate(existing):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(7 * i) % len(nodes)].meta.name)
    snap = TSnapshot()
    cache.update_snapshot(snap)
    for pod in wave:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    return backend, planes, stack_features([backend.extractor.features(p, planes)
                                            for p in wave])


def _port_config(nodes, existing, wave):
    """(KernelConfig, R, S) the port's backend builds for the wave."""
    backend, planes, feats = _port_inputs(nodes, existing, wave)
    return backend.kernel_config(planes, feats), planes.alloc.shape[1], planes.sel_counts.shape[1]


def _ipa_wave():
    spec = mixed_spec(41, 96, 160, constraints=True)
    pods = build_pods(spec, ttypes, tmeta)
    wave = [p for pair in zip(ipa_pods(16, ttypes, tmeta), pods[100:116]) for p in pair]
    return build_nodes(spec, ttypes, tmeta), pods[:100], wave


def _config(name):
    if name == "SchedulingBasic":
        nodes = [tw.scheduling_basic_node(i, 8) for i in range(64)]
        return _port_config(nodes, [], [tw.scheduling_basic_pod(i) for i in range(16)])
    if name == "TopologySpreading":
        nodes = [tw.scheduling_basic_node(i, 8) for i in range(64)]
        return _port_config(nodes, [], [tw.topology_spreading_pod(i) for i in range(16)])
    if name == "IPA wave":
        return _port_config(*_ipa_wave())
    # the widest configuration the gates passed before keys of more than
    # 1024 domains were computed: 16 keys of 1024 domains, four hard and
    # four soft slots, every IPA term slot and both existing-term flags
    return (tk.KernelConfig(topo_domains=(1024,) * 16, n_hard=4, n_soft=4,
                            ipa_existing_anti=True, ipa_existing_pref=True, n_ipa_aff=4,
                            n_ipa_anti=4, n_ipa_pref=8), 16, 256)


CONFIGS = ["SchedulingBasic", "TopologySpreading", "IPA wave", "widest"]


def _fits(cfg, R, S, nb, blocks, masked, population, gtab=False):
    """Whether a block of `blocks` over nb slots fits: its positions within
    one block's instances, its shared memory (the domain tables among it,
    but in the GTAB instance) within the budget, and (K5) its range within
    the uint16 list."""
    p = cuda.ScanParams(R=R, S=S, gtab=int(gtab), **tk._cfg_scan_fields(cfg))
    span = nb // blocks
    slots = span if not masked else max(1, min(span, population))
    return (tk.scan_npt(slots) > 0
            and 4 * tk.scan_smem_words(p, slots, masked) <= tk.SCAN_SMEM_BUDGET
            and (not masked or span <= tk.SCAN_MAX_RANGE))


def _pass_plan(cfg, R, S, nb, cap, masked, population):
    """The pass plan on a card of `cap` blocks: (passes, gtab) — the fewest
    power-of-two passes of SCAN_MAX_SLOTS positions covering a block's walk
    (its range, or K5's min(range, population) list positions), and the
    tables in device memory only where they pass the budget beside the
    pass instance's words (none of them per position)."""
    span = nb // cap
    slots = span if not masked else max(1, min(span, population))
    passes = 1
    while passes * tk.SCAN_MAX_SLOTS < slots:
        passes *= 2
    p = cuda.ScanParams(R=R, S=S, passes=passes, **tk._cfg_scan_fields(cfg))
    return passes, 4 * tk.scan_smem_words(p, slots, masked) > tk.SCAN_SMEM_BUDGET


@pytest.mark.parametrize("name", CONFIGS)
def test_scan_plan_covers_every_bucket_within_shared_memory(name):
    """For every bucket from 8 to 524288 slots and every shard count, the
    plan's blocks are the fewest powers of two (at least the shard count)
    whose block covers its range with one instance inside the opt-in shared
    memory, one pass each; past the cap the plan is the cap's blocks of the
    pass instance (_pass_plan). The configurations the port's cells run
    keep one block (K6: the shard count) up to 16384."""
    cfg, R, S = _config(name)
    if name == "IPA wave":
        assert cfg.ipa_active and cfg.ipa_existing_anti and cfg.n_ipa_aff and cfg.n_ipa_pref
    if name == "TopologySpreading":
        assert cfg.n_hard >= 1
    p = cuda.ScanParams(R=R, S=S, **tk._cfg_scan_fields(cfg))
    for nb in BUCKETS:
        for n_shards in SHARDS:
            if n_shards and n_shards > nb:
                continue
            for kernel, masked, pops in (
                    ("sharded_assign" if n_shards else "assign_scan", False, [None]),
                    ("gang_assign", True, [nb, max(1, nb // 8), 1])):
                if masked and n_shards:
                    continue
                for pop in pops:
                    plan = tk.scan_plan(kernel, cfg, nb, n_shards, R=R, S=S, population=pop)
                    blocks, npt = plan
                    low = n_shards or 1
                    assert blocks >= low and blocks & (blocks - 1) == 0 and nb % blocks == 0
                    assert _fits(cfg, R, S, nb, blocks, masked, pop or nb, plan.gtab)
                    if blocks > low:
                        assert not _fits(cfg, R, S, nb, blocks // 2, masked, pop or nb,
                                         plan.gtab)
                    # the tables leave shared memory only where no count up
                    # to the largest cluster holds them there
                    assert plan.gtab == (not any(
                        _fits(cfg, R, S, nb, b, masked, pop or nb)
                        for b in (1, 2, 4, 8, 16) if low <= b <= nb))
                    span = nb // blocks
                    slots = span if not masked else max(1, min(span, pop))
                    assert npt == tk.scan_npt(slots) and npt * tk.SCAN_THREADS >= slots
                    p.gtab = int(plan.gtab)
                    words = tk.scan_smem_words(p, slots, masked)
                    assert 4 * words + tk.SCAN_STATIC_RESERVE <= tk.SCAN_SMEM_OPTIN
                    if name != "widest" and nb <= tk.SCAN_MAX_SLOTS and not masked:
                        assert blocks == low
                    assert plan.passes == 1 and not plan.scratch
                    for cap in (8, 16):
                        capped = tk.scan_plan(kernel, cfg, nb, n_shards, R=R, S=S,
                                              population=pop, max_blocks=cap)
                        if blocks <= cap:
                            assert capped == (blocks, npt) and capped.gtab == plan.gtab
                            assert capped.passes == 1 and not capped.scratch
                        else:
                            passes, gtab = _pass_plan(cfg, R, S, nb, cap, masked, pop or nb)
                            assert capped == (cap, tk.SCAN_MAX_NPT) and capped.scratch
                            assert (capped.passes, capped.gtab) == (passes, gtab)
    # the sweep's buckets on the cells' configurations: 16384 slots a block
    if name != "widest":
        for nb, blocks in ((32768, 2), (65536, 4), (131072, 8)):
            assert tk.scan_plan("assign_scan", cfg, nb, R=R, S=S) == (blocks, 16)
            assert tk.scan_plan("sharded_assign", cfg, nb, 8, R=R, S=S)[0] == max(8, blocks)
        assert tk.scan_plan("sharded_assign", cfg, 65536, 2, R=R, S=S)[0] == 4


# configurations with a rack key of 1250 or 5556 domains (topo_dk 2048 and
# 8192) beside zone and hostname, as phase 30 of chip_smoke runs them: a
# wave spread by rack (TopologySpreading's DoNotSchedule constraint on
# rack), the mixed wave (and anti-affinity by rack over existing pods with
# such terms), and every slot at once
RACK_CONFIGS = {
    f"rack {what} {dk}": (tk.KernelConfig(topo_domains=(16, 0, dk), **kw), 4, 8)
    for dk in (2048, 8192) for what, kw in (
        ("spread", dict(n_hard=1, n_soft=0)),
        ("mixed", dict(n_hard=1, n_soft=0, n_ipa_anti=1, ipa_existing_anti=True)),
        ("every slot", dict(n_hard=4, n_soft=4, n_ipa_aff=4, n_ipa_anti=4, n_ipa_pref=8,
                            ipa_existing_anti=True, ipa_existing_pref=True)))}


def _plan_before(cfg, R, S, kernel, nb, n_shards, population):
    """The plan as it was before the per-key tables and the GTAB instance:
    every table set kept per key slot K x D words, the tables always in
    shared memory; (blocks, npt), or None past every count."""
    p = cuda.ScanParams(R=R, S=S, **tk._cfg_scan_fields(cfg))
    masked = kernel == "gang_assign"
    filt = p.n_ipa_anti + p.n_ipa_aff + (p.K if p.ex_anti else 0)
    score = p.n_ipa_pref + (p.K if p.ex_pref_add else 0)
    ipa_raw = p.n_ipa_pref > 0 or (p.ipa_active and p.ex_pref)
    blocks = n_shards or 1
    while blocks <= nb and nb % blocks == 0:
        span = nb // blocks
        slots = span if not masked else max(1, min(span, population or span))
        words = (2 * p.n_soft * p.D + max(filt, score) * p.D
                 + ((p.K * p.D + 31) // 32 if p.dom_carry else 0)
                 + slots + (slots if p.n_soft > 0 else 0) + (slots if ipa_raw else 0)
                 + ((slots + 1) // 2 if masked else 0) + 2 * p.R + 2 + p.S)
        if (tk.scan_npt(slots) and 4 * words <= tk.SCAN_SMEM_BUDGET
                and (not masked or span <= tk.SCAN_MAX_RANGE)):
            return blocks, tk.scan_npt(slots)
        blocks *= 2
    return None


@pytest.mark.parametrize("name", CONFIGS + list(RACK_CONFIGS))
def test_plans_keep_shared_memory_where_it_holds_the_tables(name):
    """Every configuration the gates passed before keeps its plan on a card
    of 16 blocks: the same blocks and NPT, its tables in shared memory (the
    per-key tables only shrink them). A rack configuration takes the GTAB
    instance, its tables in device memory, exactly where no count of up to
    16 blocks holds them in shared memory (_fits on the new layout)."""
    cfg, R, S = RACK_CONFIGS[name] if name in RACK_CONFIGS else _config(name)
    gtabs = []
    for nb in BUCKETS:
        for kernel, n_shards, pops in (("assign_scan", None, [None]),
                                       ("sharded_assign", 8, [None]),
                                       ("gang_assign", None, [nb, max(1, nb // 8)])):
            if n_shards and n_shards > nb:
                continue
            for pop in pops:
                low = n_shards or 1
                plan = tk.scan_plan(kernel, cfg, nb, n_shards, R=R, S=S, population=pop,
                                    max_blocks=16)
                masked = kernel == "gang_assign"
                if name in CONFIGS:
                    before = _plan_before(cfg, R, S, kernel, nb, n_shards, pop)
                    if before is None or before[0] > 16:
                        # past the cap: the pass plan (no refusal)
                        assert plan.gtab or plan.scratch
                    else:
                        assert plan == before and not plan.gtab, (kernel, nb, pop)
                    assert not plan.scratch or (plan.passes, plan.gtab) == _pass_plan(
                        cfg, R, S, nb, 16, masked, pop or nb)
                    continue
                shared = any(_fits(cfg, R, S, nb, b, masked, pop or nb)
                             for b in (1, 2, 4, 8, 16) if low <= b <= nb)
                if plan.scratch:
                    assert not shared
                    assert (plan.passes, plan.gtab) == _pass_plan(cfg, R, S, nb, 16, masked,
                                                                  pop or nb)
                else:
                    assert plan.gtab == (not shared)
                    gtabs.append((kernel, nb, plan.gtab))
    if name in RACK_CONFIGS:
        got = {(k, nb): g for k, nb, g in gtabs}
        # 5000 nodes (bucket 8192): a rack-spread wave keeps its one
        # block's shared memory; 100000 nodes at 8192 domains with every
        # slot: the tables take device memory
        if "spread" in name:
            assert got[("assign_scan", 8192)] is False
            assert tk.scan_plan("assign_scan", cfg, 8192, R=R, S=S) == (1, 8)
        if name == "rack every slot 8192":
            assert got[("assign_scan", 131072)] is True
            assert got[("sharded_assign", 131072)] is True


def test_tables_in_device_memory_forces_the_gtab_instance():
    """Within kernels.tables_in_device_memory() every scan plan takes the
    GTAB instance at the block count of its positions alone; outside it the
    plan is back (the memoized plans are dropped both ways)."""
    cfg, R, S = _config("TopologySpreading")
    shared = tk.scan_plan("assign_scan", cfg, 8192, R=R, S=S)
    assert shared == (1, 8) and not shared.gtab
    with tk.tables_in_device_memory():
        forced = tk.scan_plan("assign_scan", cfg, 8192, R=R, S=S)
        gang = tk.scan_plan("gang_assign", cfg, 8192, R=R, S=S, population=700)
        assert forced == (1, 8) and forced.gtab and gang.gtab
        assert forced.blocks == 1
    again = tk.scan_plan("assign_scan", cfg, 8192, R=R, S=S)
    assert again == shared and not again.gtab


def test_per_key_tables_and_the_gtab_layouts():
    """The per-key tables take each key's own words (topo_layout); the
    GTAB instance's shared memory holds no table (scan_smem_words,
    fit_smem_words), K5's work slice holds the row's tables
    (gang_work_words), and K4 takes the GTAB instance exactly where its
    shared layout passes the budget (fit_gtab)."""
    offs, words = tk.topo_layout((8, 0, 8192, 16))
    assert offs == [0, 8, 8, 8200] and words == 8216
    cfg = tk.KernelConfig(topo_domains=(8, 0, 8192), n_hard=4, n_soft=4, n_ipa_anti=4,
                          n_ipa_aff=4, n_ipa_pref=8, ipa_existing_anti=True,
                          ipa_existing_pref=True)
    p = cuda.ScanParams(R=4, S=8, Nb=8192, Ta=6, **tk._cfg_scan_fields(cfg))
    assert p.topo_words == 8200 and p.D == 8192
    tables = tk.scan_table_words(p)
    assert tables == 2 * 4 * 8192 + max(8 * 8192 + 8200, 8 * 8192 + 8200) + (8200 + 31) // 32
    positions = tk.scan_smem_words(p, 1000, True)
    p.gtab = 1
    assert tk.scan_smem_words(p, 1000, True) == positions - tables
    work = tk.gang_work_words(p)
    p.gtab = 0
    assert work == tk.gang_work_words(p) + tables
    f = cuda.FitParams(Nb=8192, cluster=16, R=4, K=3, S=8, F=200, D=8192, n_hard=1,
                       topo_words=8200)
    t, dyn = tk.fit_smem_words(f, 1, tk.FIT_THREADS)
    assert t == 2 * 8192 and dyn > t and not tk.fit_gtab(f)
    f.n_hard, f.n_soft, f.n_ipa_anti, f.ex_anti = 4, 4, 4, 1
    assert tk.fit_gtab(f) and tk.fit_gtab(f, wave=True)
    f.gtab = 1
    t2, dyn2 = tk.fit_smem_words(f, 1, tk.FIT_THREADS)
    # the feature row and the staged node rows only (2R + 3 + K + S words a row)
    assert t2 == (8 + 4) * 8192 + 8200 + 8 * 8192 and dyn2 == 200 + (2 * 4 + 3 + 3 + 8) * 512
    with tk.tables_in_device_memory():
        f.n_hard, f.n_soft, f.n_ipa_anti, f.ex_anti, f.gtab = 1, 0, 0, 0, 0
        assert tk.fit_gtab(f)
    assert not tk.fit_gtab(f)


def test_scan_plan_mirrors_the_launch_parameters():
    """The plan reads the ScanParams fields the launch builds for the same
    wave (_cfg_scan_fields, shared by both, and the planes' widths), and its
    shared memory words follow scan_smem's layout in csrc/scan_step.cuh."""
    backend, planes, feats = _port_inputs(*_ipa_wave())
    cfg = backend.kernel_config(planes, feats)
    dp, dt = backend.device_inputs(planes)
    rows, layout = pack_features(pad_features(feats, 32))
    packed_f = torch.from_numpy(rows)
    static = tk.static_parts(dp, dt, packed_f, layout)
    launch = tk._scan_params(cfg, dp, static, packed_f, layout,
                             torch.zeros(16, dtype=torch.int32),
                             torch.from_numpy(tk.log_weight_table(planes.nb)),
                             n_static=32, G=0, cursor0=0)
    R, S = planes.alloc.shape[1], planes.sel_counts.shape[1]
    plan = cuda.ScanParams(R=R, S=S, **tk._cfg_scan_fields(cfg))
    fields = set(tk._cfg_scan_fields(cfg)) | {"R", "S"}
    assert {"K", "D", "n_soft", "ex_anti", "ex_pref_add", "dom_carry"} <= fields
    for f in fields:
        got, want = getattr(plan, f), getattr(launch, f)
        assert got == want, f
    assert launch.ipa_active and launch.n_ipa_pref and launch.walk == 0
    for slots in (1, 700, 16384):
        for masked in (False, True):
            assert tk.scan_smem_words(plan, slots, masked) == tk.scan_smem_words(
                launch, slots, masked)
    # scan_smem, by hand: SchedulingBasic's one block at 16384 slots
    cfg, R, S = _config("SchedulingBasic")
    p = cuda.ScanParams(R=R, S=S, **tk._cfg_scan_fields(cfg))
    assert p.n_soft == 2 and not p.dom_carry and not p.ipa_active
    assert tk.scan_smem_words(p, 16384, False) == 2 * 2 * p.D + 2 * 16384 + 2 * R + 2 + S
    assert tk.scan_smem_words(p, 16384, True) == tk.scan_smem_words(p, 16384, False) + 8192


def test_scan_limits_is_asked_once_and_held_to_the_budget(monkeypatch):
    """The card's cap comes from scan_limits (cudaOccupancyMaxActiveClusters
    in csrc/sharded_assign.cu), asked once per card; a card whose static
    shared memory passes the reserve, or whose opt-in is below the H100's,
    is refused rather than planned for."""
    calls = []

    def fake(dyn, answer):
        calls.append(dyn)
        return dict(answer)

    monkeypatch.setattr(torch.cuda, "device", lambda idx: contextlib.nullcontext())
    monkeypatch.setattr(tk, "_SCAN_LIMITS", {})
    ok = {"max_blocks": 16, "static_smem": 8304, "smem_optin": 232448}
    monkeypatch.setattr(cuda, "scan_limits", lambda dyn: fake(dyn, ok))
    assert tk.scan_limits("cuda:0") == ok and tk.scan_limits("cuda:0") == ok
    assert calls == [tk.SCAN_SMEM_BUDGET]
    for bad in ({**ok, "static_smem": tk.SCAN_STATIC_RESERVE + 1},
                {**ok, "smem_optin": 101376}, {**ok, "max_blocks": 0}):
        monkeypatch.setattr(tk, "_SCAN_LIMITS", {})
        monkeypatch.setattr(cuda, "scan_limits", lambda dyn, b=bad: fake(dyn, b))
        with pytest.raises(RuntimeError, match="does not hold on this card"):
            tk.scan_limits("cuda:1")


def test_scan_plan_refuses_unknown_kernels_and_undivided_buckets():
    cfg = tk.KernelConfig()
    with pytest.raises(ValueError, match="no scan kernel"):
        tk.scan_plan("fit_and_score", cfg, 1024, R=4, S=8)
    # the widest configuration past 16 blocks (its tables in device memory,
    # its positions 16384 a block: 32 blocks) takes 16 blocks of 2 passes
    # on a card of 16; with no position word in shared memory its tables
    # fit there again
    wide, R, S = _config("widest")
    blocks, _ = tk.scan_plan("assign_scan", wide, 524288, R=R, S=S)
    assert blocks > tk.SCAN_MAX_BLOCKS
    assert tk.scan_plan("assign_scan", wide, 262144, R=R, S=S, max_blocks=16).gtab
    plan = tk.scan_plan("assign_scan", wide, 524288, R=R, S=S, max_blocks=16)
    assert plan == (16, 16) and plan.scratch and plan.passes == 2 and not plan.gtab
    with tk.tables_in_device_memory():
        plan = tk.scan_plan("assign_scan", wide, 524288, R=R, S=S, max_blocks=16)
        assert plan == (16, 16) and plan.scratch and plan.passes == 2 and plan.gtab


# --------------------------------------------------------------------------
# K5's per-block node lists
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nb", [32768, 131072])
@pytest.mark.parametrize("row", ["zone", "fallback", "sparse-tail"])
def test_mask_block_lists_cover_each_mask_node_once_in_order(nb, row):
    """Each block of a row's cluster lists its range's mask nodes as
    positions relative to the range (below 2**16), at most the positions
    the plan gives it; in rank order the blocks' lists are the row's mask
    nodes, each once, ascending: the node order a single block walks."""
    n_nodes = nb // 2 + 1 + nb // 4
    mask = torch.zeros(nb, dtype=torch.bool)
    if row == "zone":
        mask[torch.arange(3, n_nodes, 8)] = True
    elif row == "fallback":
        mask[:n_nodes] = True
    else:
        mask[torch.tensor([0, 5, nb // 2 - 1, nb // 2, n_nodes - 1])] = True
    masks = torch.stack([mask, torch.zeros(nb, dtype=torch.bool)])
    population = int(masks.sum(dim=1).max())
    cfg, R, S = _config("SchedulingBasic")
    blocks, npt = tk.scan_plan("gang_assign", cfg, nb, R=R, S=S, population=population)
    walk = min(nb // blocks, population)
    assert walk <= npt * tk.SCAN_THREADS
    if row == "fallback":
        assert blocks == nb // tk.SCAN_MAX_SLOTS
    else:
        assert blocks == max(1, nb // tk.SCAN_MAX_RANGE)
    lists = tk.mask_block_lists(masks, blocks)
    span = nb // blocks
    for m, per_block in zip(masks, lists):
        assert len(per_block) == blocks
        nodes = []
        for r, rel in enumerate(per_block):
            assert rel.numel() <= walk
            assert (rel >= 0).all() and (rel < min(span, 1 << 16)).all()
            nodes.append(rel.to(torch.int64) + r * span)
        nodes = torch.cat(nodes)
        assert torch.equal(nodes, torch.nonzero(m).flatten())
        assert torch.equal(nodes, tk.mask_node_lists(m[None])[0])


def test_gang_assign_refuses_a_population_below_a_row():
    """A K5 launch's population sizes each block's node list, so one below
    a mask row's count would walk that row in part. The CPU path raises
    (the exact count runs), and the reader of a card's output raises on a
    row whose overflow word reports the truncated list (GANG_LIST_TRUNCATED;
    a tie-draw overflow, 1, is the backend's fallback, not an error)."""
    from kubernetes_tpu_torch.ops.planes import placement_masks

    cache, snap = tsynthetic(24, n_zones=4)
    backend = TorchBackend(cache.names, device="cpu")
    pods = [tw.make_pod(f"g{i}", cpu="100m", mem="64Mi") for i in range(3)]
    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = pad_features(stack_features([backend.extractor.features(p, planes)
                                         for p in pods]), 4)
    cfg = backend.kernel_config(planes, feats)
    dp, dt = backend.device_inputs(planes)
    rows, layout = pack_features(feats)
    packed_f = torch.from_numpy(rows)
    zones = [[f"node-{i}" for i in range(z, 24, 4)] for z in range(4)]
    masks = torch.from_numpy(placement_masks(planes, zones + [[f"node-{i}" for i in range(24)]],
                                             8))
    words = torch.from_numpy(tbackend.clone_tie_words(random.Random(5), 64).view(np.int32))
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    static = tk.static_parts(dp, dt, packed_f, layout)
    call = functools.partial(tk.gang_assign, cfg, dp, static, packed_f, layout, masks, words,
                             logtab, 4, True)
    out = call(population=24)
    assert torch.equal(out, call())
    with pytest.raises(ValueError, match="below a mask row"):
        call(population=23)
    tk.check_gang_rows([0, 1, 0])
    with pytest.raises(ValueError, match=r"rows \[1\]"):
        tk.check_gang_rows([0, tk.GANG_LIST_TRUNCATED, 1])


# --------------------------------------------------------------------------
# the first-use signature carries the block count
# --------------------------------------------------------------------------


def test_a_new_block_count_is_a_new_first_use(monkeypatch):
    """The backend's compile spans key K2's and K5's launches on the plan's
    block count (a cluster of another size is another kernel instance):
    the same wave at a new count is a first use, labelled /c<blocks>."""
    cache, snap = tsynthetic(24, n_zones=4)
    backend = TorchBackend(cache.names, device="cpu")
    tel = backend.telemetry
    pods = [tw.make_pod(f"p{i}", cpu="100m", mem="64Mi", labels={"app": "x"})
            for i in range(4)]
    blocks = {"n": 1}
    real = tbackend.scan_plan_for
    monkeypatch.setattr(tbackend, "scan_plan_for",
                        lambda *a, **k: (blocks["n"], real(*a, **k)[1]))
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    assert tel.compile_count("batched_assign") == 1
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    assert tel.compile_count("batched_assign") == 1
    blocks["n"] = 4
    backend.run_batched(pods, snap, rng=random.Random(1), pad_to=8)
    assert tel.compile_count("batched_assign") == 2
    assert any(lb.endswith("/c4") for lb in tel.compiled_shapes("batched_assign"))
    assert not any("/c1" in lb for lb in tel.compiled_shapes("batched_assign"))


# --------------------------------------------------------------------------
# synthetic_cluster and the node tree it fills
# --------------------------------------------------------------------------


def test_node_tree_keeps_the_reference_order():
    """The port's NodeTree (zone membership in sets, so a 100000-node
    cluster builds in linear time) lists the nodes in the reference's
    order through adds, repeated adds, zone moves and removals."""
    from kubernetes_tpu.scheduler.cache.node_tree import NodeTree as JTree
    from kubernetes_tpu_torch.scheduler.cache.node_tree import NodeTree as TTree

    rng = random.Random(5)
    jt, tt = JTree(), TTree()
    jnodes, tnodes = {}, {}
    for step in range(600):
        name = f"n{rng.randrange(80)}"
        zone = f"z{rng.randrange(5)}"
        op = rng.random()
        jn = jmake_node(name, zone=zone)
        tn = tw.make_node(name, zone=zone)
        if op < 0.5 or name not in jnodes:
            jt.add_node(jn)
            tt.add_node(tn)
            jnodes.setdefault(name, jn)
            tnodes.setdefault(name, tn)
        elif op < 0.8:
            jt.update_node(jnodes[name], jn)
            tt.update_node(tnodes[name], tn)
            jnodes[name], tnodes[name] = jn, tn
        else:
            jt.remove_node(jnodes.pop(name))
            tt.remove_node(tnodes.pop(name))
        assert tt.list() == jt.list() and tt.num_nodes == jt.num_nodes


def test_synthetic_cluster_equals_the_reference():
    """The port's copy of the reference's synthetic_cluster makes the same
    nodes (names, labels, capacity) and initial pods."""
    jc, js = jsynthetic(40, n_zones=8, init_pods_per_node=2, cpu="16", mem="32Gi")
    tc, ts = tsynthetic(40, n_zones=8, init_pods_per_node=2, cpu="16", mem="32Gi")
    jn, tn = js.list_nodes(), ts.list_nodes()
    assert [n.name for n in jn] == [n.name for n in tn]
    for a, b in zip(jn, tn):
        assert a.node.meta.labels == b.node.meta.labels
        assert dict(a.node.status.allocatable) == dict(b.node.status.allocatable)
        assert list(a.pods) == list(b.pods)
        for key in a.pods:
            pa, pb = a.pods[key].pod, b.pods[key].pod
            assert pa.meta.labels == pb.meta.labels
            assert pa.spec.node_name == pb.spec.node_name
            assert {k: str(v) for k, v in pa.spec.containers[0].requests.items()} == \
                {k: str(v) for k, v in pb.spec.containers[0].requests.items()}
    assert js.num_nodes() == ts.num_nodes() == 40


# --------------------------------------------------------------------------
# the plain versions against the reference past 16384 slots
# --------------------------------------------------------------------------

BIG_NODES = 16500  # bucket 32768


def _big_wave(names, backend, snap, lo, hi):
    pods = [jmake_pod(f"p{i}", cpu="500m", mem="512Mi", labels={"app": f"g{i % 4}"})
            for i in range(lo, hi)]
    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = jstack([backend.extractor.features(p, planes) for p in pods])
    return planes, feats


def test_batched_assign_chain_past_one_block_matches_reference():
    """At 16500 nodes (bucket 32768: two blocks of 16384 slots on the card)
    the port's batched_assign (K1 + K2 plain versions, dedup on) equals JAX
    batched_assign on every output of a wave, and of a second wave chained
    on its output planes and signature table (a crafted slot map: a hit, a
    miss, a rotation), its final cursor and a frame shift."""
    names = JNames()
    cache, snap = jsynthetic(BIG_NODES, n_zones=8, init_pods_per_node=0, names=names)
    # every node of the first block's range loaded but every 97th: the empty
    # nodes, in both blocks' ranges, score highest
    for i in range(tk.SCAN_MAX_SLOTS):
        if i % 97:
            cache.add_pod(jmake_pod(f"init-{i}", cpu="3", mem="1Gi", labels={"app": "init"},
                                    node_name=f"node-{i}"))
    cache.update_snapshot(snap)
    backend = TPUBackend(names)
    planes, feats = _big_wave(names, backend, snap, 0, 24)
    assert planes.nb == 32768 and planes.n == BIG_NODES
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    sig_ids, uniq, _ = backend._group_wave(feats, 24)
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    assert tk.scan_plan("assign_scan", pcfg, planes.nb, R=planes.alloc.shape[1],
                        S=planes.sel_counts.shape[1]) == (2, 16)
    pad = feats["active"].shape[0]
    words1 = clone_tie_words(random.Random(21), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, first = jk.batched_assign(cfg, arrays, feats, words1, sig_ids=sig_ids, uniq_idx=uniq)
    port_first = _port_wave(cfg, planes, arrays, feats, words1, sig_ids, uniq)
    _assert_equal_outputs(port_first, first)
    winners = np.asarray(first["packed"])[:-2]
    assert (winners >= tk.SCAN_MAX_SLOTS).any() and (winners < tk.SCAN_MAX_SLOTS).any()
    chained = dict(arrays)
    for k in ("used", "nonzero_used", "sel_counts"):
        chained[k] = np.asarray(first[k])
    cmap = _crafted_map(len(uniq))
    cursor = int(first["tie_consumed"])
    words2 = clone_tie_words(random.Random(22), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, want = jk.batched_assign(cfg, chained, feats, words2, cursor_init=first["tie_consumed"],
                                frame_shift=min(3, cursor), sig_ids=sig_ids, uniq_idx=uniq,
                                carry_map=cmap, sig_table=first["sig_table"])
    table, tcmap = sig_table_from_reference(first["sig_table"], cmap, "cpu")
    got = _port_wave(cfg, planes, chained, feats, words2, sig_ids, uniq,
                     cursor_init=torch.tensor(cursor, dtype=torch.int32),
                     frame_shift=min(3, cursor), carry_map=tcmap, sig_table=table)
    _assert_equal_outputs(got, want)
    full, replay = got["tiers"].tolist()
    assert replay > 0 and full + replay == pad


def test_gang_assign_past_one_block_matches_reference():
    """At 16500 nodes a Preferred gang's rows (8 zones of ~2060 nodes and the
    fallback row over every node, padded to 16): the port's gang_assign (K1
    once + K5 plain versions) equals JAX gang_assign element for element;
    on the card the fallback row takes a cluster of two blocks."""
    names = JNames()
    cache, snap = jsynthetic(BIG_NODES, n_zones=8, names=names)
    for i in range(0, BIG_NODES, 89):
        cache.add_pod(jmake_pod(f"init-{i}", cpu="30", mem="1Gi", labels={"app": "init"},
                                node_name=f"node-{i}"))
    cache.update_snapshot(snap)
    backend = TPUBackend(names)
    members = [jmake_pod(f"m{i}", cpu="2", mem="1Gi", labels={"app": "gang"})
               for i in range(6)]
    for pod in members:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = jpad(jstack([backend.extractor.features(p, planes) for p in members]), 8)
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    zones = [[f"node-{i}" for i in range(z, BIG_NODES, 8)] for z in range(8)]
    parent = [f"node-{i}" for i in range(BIG_NODES)]
    masks = jmasks(planes, zones + [parent], 16)
    words = clone_tie_words(random.Random(31), 8 * jk.MAX_TIE_DRAWS + jk.MAX_TIE_DRAWS)
    want = np.asarray(jk.gang_assign(cfg, arrays, feats, masks, words, 8, True))
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    got = tk.gang_assign(pcfg, dplanes, static, packed_f, layout, torch.from_numpy(masks),
                         torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(tk.log_weight_table(planes.nb)), 8, True,
                         population=BIG_NODES).numpy()
    assert np.array_equal(got, want)
    assert got[-2] == 1 and got[-3] < 8  # a zone row holds the whole gang
    assert tk.scan_plan("gang_assign", pcfg, planes.nb, R=planes.alloc.shape[1],
                        S=planes.sel_counts.shape[1], population=BIG_NODES) == (2, 16)


def test_scheduler_past_one_block_matches_reference(monkeypatch):
    """The port's Scheduler(device="cpu") and the reference's Scheduler over
    one 17000-node store shape (4 zones of 4-CPU nodes), the golden bursts
    pipelined at depth 2 with dedup on: equal bindings, PodScheduled=False
    diagnoses and final rng state."""
    kw = dict(depth=2, dedup=True, nodes=17000, zones=4,
              bursts=((0, 24), (24, 48)), wave_size=16)
    want = _run_stream(SIDES["jax"], monkeypatch, **kw)
    got = _run_stream(SIDES["port"], monkeypatch, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert sum(1 for v in got[0].values() if v) == 48
    backend = got[3].algorithms["default-scheduler"].backend
    assert backend._device_planes["alloc"].shape[0] == 32768
