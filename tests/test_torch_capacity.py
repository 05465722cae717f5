"""Any number of scored resources, shape points and topology keys (ROADMAP
B3 and B4).

The kernels' parameter block holds 8 scored resources, 16
RequestedToCapacityRatio shape points and 16 topology key slots; a
configuration past them passes its tables beside it (the launch tables,
csrc/common.cuh), and the matched key mask of the existing pods' terms
takes a word per 32 key slots. The configuration is
kubernetes_tpu_torch/testing/capacity.py's H100 fleet: ten scored
resources (cpu, memory, ephemeral-storage, nvidia.com/gpu and six MIG
profiles) under LeastAllocated and under a 21-point
RequestedToCapacityRatio shape (B3, on a cluster of 4 keys), and 20 keys
(K 32, the traffic's constraints and terms on slots 16-19) and 40 keys (K
64, on slots 33-36), the existing anchors' terms on every key (B4). The
port's plain versions are held against the JAX package, every output
equal (PodTopologySpread's log weight, the known exception, does not show
at these sizes): batched_assign on both tiers, K6's plain version on 8
shards, K7's, fit_and_score through schedule_pod (FitError diagnoses
among the results), gangs in both modes, the backend on LocalContext and
MeshContext and the store-driven loop. The slot ids are asserted where
the cases build their planes. A configuration within the old caps keeps
its parameter bytes, plans and instances.

Each case runs once with a B3 configuration here (the loop in
tests/test_torch_capacity_loop.py) and once with a B4 configuration in
tests/test_torch_capacity_k32.py, _mesh.py, _gang.py, _loop.py or
_k64.py (the case functions below, _case_*, are theirs too). The JAX
package compiles a program per configuration and shape whose cost grows
with the key slots it unrolls (35-85 s a program at K 32 and 64 on one
core against 5-15 s at K 4), so the wide cases take one configuration
each, share programs where their shapes agree (K2's dedup wave and the
backend's run_batched: the same tie words), and sit in files of their
own, which the suite's workers run side by side. The wide configurations'
traffic is capacity.wide_pod alone (every role on the high slots, every
other one a MIG pod), whose one spread slot each way keeps the
reference's unrolled program smallest.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features as jpad
from kubernetes_tpu.ops.planes import stack_features as jstack
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import cuda
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import features_from_reference, planes_from_reference
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing import capacity as cap
from tests.test_torch_gang import _Jax, _Port, _plan_view, _qpis
from tests.test_torch_host_tier import _drive, _sides
from tests.test_torch_loop import SIDES, _port_registry, outcome  # noqa: F401 (autouse)
from tests.test_torch_mesh import _jax_sharded, _port_sharded
from tests.test_torch_pipeline import (  # noqa: F401 (autouse, C12)
    _assert_equal_outputs,
    _own_process_state,
    _port_wave,
)

N_NODES = 40
WAVE = 16
# variant -> (plugin args, key count): B3 (ten scored resources, 4 keys)
# and B4 (20 and 40 keys)
VARIANTS = {
    "least10": (cap.least_allocated_args(), 4),
    "rtc21": (cap.rtc_args(), 4),
    "k32": (cap.rtc_args(), 20),
    "k64": (None, 40),
}
NAMES = list(VARIANTS)


def _types(pkg):
    return (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)


def _check_config(cfg, variant):
    """The configuration reaches past the parameter block where the
    variant says: ten scored resources and (rtc) 21 shape points, or K 32
    / 64 key slots."""
    args, n_keys = VARIANTS[variant]
    if args is not None:
        assert len(cfg.fit_resources) == 10
        rtc = args["NodeResourcesFit"]["strategy"] == "RequestedToCapacityRatio"
        assert cfg.strategy == args["NodeResourcesFit"]["strategy"]
        assert len(cfg.rtc_shape) == (21 if rtc else 2)
    assert len(cfg.topo_domains) == {4: 4, 20: 32, 40: 64}[n_keys]
    past = len(cfg.fit_resources) > 8 or len(cfg.rtc_shape) > 16 or len(cfg.topo_domains) > 16
    assert past and tk.launch_table_values(cfg) is not None


def _check_slots(vocabs, n_keys):
    """Every key takes its KEYS slot; the traffic's roles sit past the
    parameter block's 16 slots (K 32) and one mask word's 32 (K 64)."""
    for slot, key in enumerate(cap.KEYS[n_keys]):
        assert vocabs.topo_keys.get(key) == slot, key
    slots = [s for _k, s in cap.key_slots(n_keys).values()]
    if n_keys == 20:
        assert min(slots) >= 16
    if n_keys == 40:
        assert min(slots) >= 32


def _cluster(pkg, n_keys, n=N_NODES):
    """(names, cache, snapshot) of the fleet with its anchors running."""
    types, meta = _types(pkg)
    names = JNames() if pkg == "jax" else TNames()
    cache = (JCache if pkg == "jax" else TCache)(names)
    for node in cap.capacity_nodes(n, n_keys, types, meta):
        cache.add_node(node)
    for pod, node in cap.anchor_pods(n, n_keys, types, meta):
        cache.assume_pod(pod, node)
    snap = (JSnapshot if pkg == "jax" else TSnapshot)()
    cache.update_snapshot(snap)
    return names, cache, snap


_MIG = {"cpu": "1", "memory": "4Gi", cap.MIG[0]: 1}


def _traffic(variant, lo, hi, types, meta):
    """Pods lo..hi-1 of the variant's traffic: the mixed kinds
    (capacity_pods) within 16 keys, capacity.wide_pod past them (every
    other one a MIG pod)."""
    n_keys = VARIANTS[variant][1]
    if n_keys <= 16:
        return cap.capacity_pods(lo, hi, n_keys, types, meta)
    return [cap.wide_pod(i, n_keys, types, meta, _MIG if i % 2 else None)
            for i in range(lo, hi)]


def _reference_wave(variant):
    """(cfg, planes, arrays, feats, sig_ids, uniq) of the reference's backend
    for a wave of the variant's traffic."""
    args, n_keys = VARIANTS[variant]
    names, cache, snap = _cluster("jax", n_keys)
    backend = TPUBackend(names, plugin_args=args)
    backend.sync(snap)  # the anchors' terms intern the keys first
    pods = _traffic(variant, 0, WAVE, jtypes, jmeta)
    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    _check_slots(backend.builder.vocabs, n_keys)
    feats = jpad(jstack([backend.extractor.features(p, planes) for p in pods]), WAVE)
    cfg = backend.kernel_config(planes, feats)
    _check_config(cfg, variant)
    assert cfg.n_hard and cfg.n_soft and cfg.n_ipa_anti and cfg.n_ipa_pref
    assert cfg.ipa_existing_anti and cfg.ipa_existing_pref
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    sig_ids, uniq, _ = backend._group_wave(feats, WAVE)
    return cfg, planes, arrays, feats, sig_ids, uniq


@pytest.fixture(scope="module")
def waves():
    return {}


def _wave(waves, variant):
    if variant not in waves:
        waves[variant] = _reference_wave(variant)
    return waves[variant]


# --------------------------------------------------------------------------
# the parameter block within the old caps
# --------------------------------------------------------------------------


def _seed_bytes_fill(p, cfg):
    """The parameter block's table fill as it was before the launch tables
    (every entry in the block's arrays)."""
    for i, (col, w) in enumerate(cfg.fit_resources):
        p.fit_col[i], p.fit_w[i] = col, w
    for i, (x, y) in enumerate(cfg.rtc_shape):
        p.rtc_x[i], p.rtc_y[i] = x, y
    for i, (dk, off) in enumerate(zip(cfg.topo_domains, tk.topo_layout(cfg.topo_domains)[0])):
        p.topo_dk[i], p.topo_off[i] = dk, off


WITHIN = [
    tk.KernelConfig(),
    tk.KernelConfig(strategy="RequestedToCapacityRatio",
                    fit_resources=tuple((c, 1 + c) for c in range(8)),
                    rtc_shape=tuple((6 * k, 100 - 6 * k) for k in range(16)),
                    topo_domains=(8, 0) + (4,) * 14, n_ipa_anti=2, n_ipa_pref=3,
                    ipa_existing_anti=True, ipa_existing_pref=True),
]


# what dadc65e (before the launch tables) planned for WITHIN's configs at
# R 16, S 8: the scan's (blocks, npt) at buckets 8, 5000, 16384 and 65536
# for K2, K6 on 8 shards and K5 (population nb // 3), all in shared
# memory; scan_smem_words at 100, 8192 and 16384 slots, unmasked and
# masked; fit_smem_words of a K4 block at (npt 1, 512 threads), (4, 512)
# and K7's (1, 1024)
_PLANS = {"assign_scan": ((1, 8), (1, 8), (1, 16), (4, 16)),
          "sharded_assign": ((8, 8),) * 4,
          "gang_assign": ((1, 8), (1, 8), (1, 8), (4, 16))}
_SEED = [
    (_PLANS, (371, 421, 16555, 20651, 32939, 41131), ((256, 23752), (256, 712), (256, 46792))),
    (dict(_PLANS, gang_assign=((1, 8), (1, 8), (1, 8), (8, 8))),
     (496, 546, 24772, 28868, 49348, 57540), ((256, 30920), (256, 712), (256, 712))),
]


@pytest.mark.parametrize("i", range(len(WITHIN)))
def test_within_the_old_caps_the_block_plan_and_instance_are_unchanged(i):
    """A configuration within 8 scored resources, 16 shape points and 16
    keys: no launch tables, the parameter block's bytes as when the block
    held every entry (ScanParams and FitParams), and the plans and shared
    memory dadc65e computed (so the same instances launch)."""
    cfg = WITHIN[i]
    plans, smem, fit = _SEED[i]
    assert tk.launch_table_values(cfg) is None
    assert tk.launch_tables(cfg, "cpu") is None
    for cls in (cuda.ScanParams, cuda.FitParams):
        new, old = cls(n_fit=len(cfg.fit_resources)), cls(n_fit=len(cfg.fit_resources))
        tk._fill_block_tables(new, cfg)
        _seed_bytes_fill(old, cfg)
        assert bytes(new) == bytes(old)
    for kernel, want in plans.items():
        for nb, (blocks, npt) in zip((8, 5000, 16384, 65536), want):
            plan = tk.scan_plan(kernel, cfg, nb, 8 if kernel == "sharded_assign" else None,
                                R=16, S=8, population=nb // 3 or 1)
            assert (plan.blocks, plan[1], plan.gtab) == (blocks, npt, False), (kernel, nb)
    p = cuda.ScanParams(R=16, S=8, **tk._cfg_scan_fields(cfg))
    assert tuple(tk.scan_smem_words(p, slots, masked) for slots in (100, 8192, 16384)
                 for masked in (False, True)) == smem
    f = cuda.FitParams(K=len(cfg.topo_domains), R=16, S=8, F=200, D=8, n_hard=4, n_soft=4,
                       cluster=16, Nb=8192, topo_words=64, ex_anti=1, ex_pref_add=1)
    assert tuple(tk.fit_smem_words(f, npt, nt) for npt, nt in ((1, 512), (4, 512), (1, 1024))) \
        == fit


def test_launch_tables_hold_every_entry_past_the_caps():
    """Past a cap the launch tables hold every entry in their layout
    (fit_col, fit_w, rtc_x, rtc_y, topo_dk, topo_off), the block the first
    8 / 16 / 16; uploaded once per table (memoized by value)."""
    fit = tuple((c, c % 3 + 1) for c in range(10))
    shape = tuple((5 * k, k) for k in range(21))
    topo = (8, 0) + tuple(2 + k for k in range(30))
    cfg = tk.KernelConfig(strategy="RequestedToCapacityRatio", fit_resources=fit,
                          rtc_shape=shape, topo_domains=topo)
    vals = tk.launch_table_values(cfg)
    offs, _ = tk.topo_layout(topo)
    assert vals == ([c for c, _ in fit] + [w for _, w in fit] + [x for x, _ in shape]
                    + [y for _, y in shape] + list(topo) + offs)
    t = tk.launch_tables(cfg, "cpu")
    assert t.dtype == torch.int32 and t.tolist() == vals
    assert tk.launch_tables(dataclasses.replace(cfg, n_hard=1), "cpu") is t
    p = cuda.ScanParams(n_fit=10, n_rtc=21, K=32)
    tk._fill_block_tables(p, cfg)
    assert list(p.fit_col) == [c for c, _ in fit[:8]] and list(p.rtc_y) == list(range(16))
    assert list(p.topo_dk) == list(topo[:16]) and list(p.topo_off) == offs[:16]
    # the kernels stage the launch tables at the start of their shared
    # memory: the plans count them (none within the caps)
    q = cuda.ScanParams(R=16, S=8, **tk._cfg_scan_fields(cfg))
    assert tk.launch_table_words(q) == len(vals)
    assert tk.launch_table_words(cuda.ScanParams(R=16, S=8, **tk._cfg_scan_fields(
        tk.KernelConfig()))) == 0
    base = cuda.ScanParams.from_buffer_copy(q)
    base.n_fit, base.n_rtc, base.K = 8, 16, 16
    assert tk.scan_smem_words(q, 1000, False) - tk.scan_smem_words(base, 1000, False) == len(vals)
    # the key mask's words: one up to 32 slots, two at 64
    assert [tk.key_words(k) for k in (2, 16, 32, 33, 64)] == [1, 1, 1, 2, 2]
    # an empty resource list or shape, and an unknown strategy, still refused
    for bad in (dataclasses.replace(cfg, fit_resources=()),
                dataclasses.replace(cfg, rtc_shape=()),
                dataclasses.replace(cfg, strategy="Balanced")):
        with pytest.raises(tk.OutOfSlice):
            tk.check_slice(bad)


# --------------------------------------------------------------------------
# the cases (each file parametrizes them with its configurations)
# --------------------------------------------------------------------------


def _equal_no_dedup(got, want):
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert "sig_table" not in got


def _case_batched_assign(waves, variant, dedup):
    """K1 + K2's plain versions == JAX batched_assign on a wave of capacity
    pods: the packed winners and tie stream's cursor, the carried planes
    and, with dedup, sig_scores and the signature table."""
    cfg, planes, arrays, feats, sig_ids, uniq = _wave(waves, variant)
    # run_batched's tie words at a wave of WAVE: its program is this one's
    words = clone_tie_words(random.Random(3), (WAVE + 1) * jk.MAX_TIE_DRAWS)
    if dedup:
        _, want = jk.batched_assign(cfg, arrays, feats, words, sig_ids=sig_ids, uniq_idx=uniq)
        got = _port_wave(cfg, planes, arrays, feats, words, sig_ids, uniq)
        _assert_equal_outputs(got, want)
    else:
        _, want = jk.batched_assign(cfg, arrays, feats, words)
        pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
        dplanes = planes_from_reference(
            {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
        dtables = planes_from_reference(
            {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
        packed_f, layout = features_from_reference(feats, "cpu")
        got = tk.batched_assign(pcfg, dplanes, dtables, packed_f, layout,
                                torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(tk.log_weight_table(planes.nb)))
        _equal_no_dedup(got, want)
    # the wide traffic's MIG pods run out of GPU nodes their hard spread
    # allows: some stay unplaced
    assert (np.asarray(want["packed"])[:-2] >= 0).sum() >= WAVE // 2


def _case_sharded_assign(waves, variant):
    """K6's plain version on 8 node shards == K2's plain version == JAX
    sharded_batched_assign on 8 shards, every output."""
    cfg, planes, arrays, feats, sig_ids, uniq = _wave(waves, variant)
    words = clone_tie_words(random.Random(5), (2 * WAVE + 1) * jk.MAX_TIE_DRAWS)
    want = _jax_sharded(cfg, 8, arrays, feats, words, sig_ids, uniq)
    got = _port_sharded(cfg, 8, arrays, feats, words, planes.nb, sig_ids, uniq)
    _assert_equal_outputs(got, want)
    k2 = _port_wave(cfg, planes, arrays, feats, words, sig_ids, uniq)
    for k in ("packed", "used", "sel_counts", "ipa_anti", "sig_scores"):
        assert torch.equal(got[k], k2[k]), k


def _case_wave_matrix(waves, variant):
    """K7's plain version == the reference's wave_fit_and_score (wave 2 on
    4 node shards): feasible and total of every capacity pod against every
    node."""
    cfg, planes, arrays, feats, _sig, _uniq = _wave(waves, variant)
    jm = jmesh.scheduler_mesh(n_devices=8, wave=2)
    want_f, want_t = jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays), feats)
    tm = tmesh.scheduler_mesh(8, wave=2, device="cpu")
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    tplanes = tmesh.shard_planes(tm, {k: v for k, v in arrays.items()
                                      if not k.startswith("aff_")})
    ttables = tmesh.shard_planes(tm, {k: v for k, v in arrays.items() if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    got_f, got_t = tmesh.wave_fit_and_score(pcfg, tm, tplanes, ttables, packed_f, layout,
                                            torch.from_numpy(tk.log_weight_table(planes.nb)))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_f.any() and not got_f.all()


def _case_backend_waves(variant):
    """Two waves of capacity pods through TPUBackend.run_batched and
    TorchBackend.run_batched on LocalContext and on MeshContext(8), each
    wave's hosts assumed before the next: equal hosts and rng state after
    every wave."""
    args, n_keys = VARIANTS[variant]
    sides = {}
    for name in ("jax", "local", "mesh"):
        pkg = "jax" if name == "jax" else "port"
        names, cache, snap = _cluster(pkg, n_keys)
        if pkg == "jax":
            backend = TPUBackend(names, plugin_args=args)
        else:
            ctx = (tmesh.MeshContext(tmesh.scheduler_mesh(8, device="cpu")) if name == "mesh"
                   else tmesh.LocalContext("cpu"))
            backend = TorchBackend(names, plugin_args=args, device="cpu", context=ctx)
        backend.sync(snap)
        sides[name] = (pkg, cache, snap, backend, random.Random(7))
    for wave in range(2):
        hosts = {}
        for name, (pkg, cache, snap, backend, rng) in sides.items():
            pods = _traffic(variant, WAVE * wave, WAVE * wave + WAVE, *_types(pkg))
            got, _ = backend.run_batched(pods, snap, rng=rng, pad_to=WAVE)
            hosts[name] = (got, rng.getstate())
            for pod, node in zip(pods, got):
                if node is not None:
                    cache.assume_pod(pod, node)
            cache.update_snapshot(snap)
        assert hosts["local"] == hosts["jax"] and hosts["mesh"] == hosts["jax"], wave
        assert sum(h is not None for h in hosts["jax"][0]) >= WAVE // 2
    _check_slots(sides["local"][3].builder.vocabs, n_keys)


def _case_schedule_pod(variant):
    """fit_and_score's plain version through schedule_pod == the
    reference's TPUSchedulingAlgorithm on the fleet with its anchors: each
    pod's host, evaluated and feasible counts, or its FitError (message,
    diagnosis, every node's status), the rotation index, the kernel and
    fallback counts and the final rng. The pods carry every role on the
    high slots, half of them MIG pods (one configuration: one program of
    the reference's); the last asks for more 7g.80gb slices than any node
    has (a FitError)."""
    args, n_keys = VARIANTS[variant]
    sides = _sides(lambda types, meta: cap.capacity_nodes(24, n_keys, types, meta),
                   plugin_args=args)
    for side in sides:
        for pod, node in cap.anchor_pods(24, n_keys, side.types, side.meta):
            side.assume(pod, node)
        side.backend.sync(side.snapshot)
    big = {"cpu": "1", "memory": "4Gi", cap.MIG[-1]: 5}

    def pods(side):
        return [cap.wide_pod(i, n_keys, side.types, side.meta, _MIG if i % 2 else None)
                for i in range(7)] + [cap.wide_pod(7, n_keys, side.types, side.meta, big)]

    recs = _drive(sides, pods)
    assert recs[-1][0] == "fit" and f"Insufficient {cap.MIG[-1]}" in recs[-1][1]
    assert all(r[0] != "fit" for r in recs[:-1])
    _check_slots(sides[1].backend.builder.vocabs, n_keys)


def _case_gang(variant, mode):
    """Gangs of 4 placed by zone whose members spread by the hard key
    (maxSkew 1, DoNotSchedule), one a MIG pod, through both packages'
    planner and run_gang (K1 + K5's plain versions), each gang's hosts
    bound before the next: the plan, hosts, winning row, outcome and rng
    equal."""
    args, n_keys = VARIANTS[variant]
    results = []
    for pkg, side_cls, backend_cls in (("jax", _Jax, TPUBackend), ("port", _Port, TorchBackend)):
        types, meta = _types(pkg)
        side = side_cls(cap.capacity_nodes(N_NODES, n_keys, types, meta))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        side.backend = backend_cls(side.names, plugin_args=args, **kw)
        for pod, node in cap.anchor_pods(N_NODES, n_keys, types, meta):
            side.cache.assume_pod(pod, node)
        side.cache.update_snapshot(side.snapshot)
        side.backend.sync(side.snapshot)
        rng = random.Random(11)
        got = []
        for g in range(2):
            group, pods = cap.capacity_gang(f"g{g}", mode, 4, n_keys, types, meta)
            side.add_group(group, pods)
            side.cache.update_snapshot(side.snapshot)
            plan = side.plan_gang(side, side.fw, _qpis(pods))
            res = side.backend.run_gang(pods, side.snapshot, plan.gang_placements,
                                        plan.gang_n_constrained, plan.gang_has_fallback, rng)
            got.append((_plan_view(plan), None if res is None else res[:2], side.outcome(),
                        rng.getstate()))
            if res is not None:
                for pod, node in zip(pods, res[0]):
                    side.bind(group, pod, node)
        results.append(got)
        if pkg == "port":
            _check_slots(side.backend.builder.vocabs, n_keys)
    want, got = results
    assert got == want
    assert all(r[1] is not None and r[2].startswith("device:") for r in got)


def _case_store_loop(variant, monkeypatch, wave=WAVE):
    """The store-driven loop (informer, queue, the wave pipeline at depth
    2, the batched bind) over the fleet with its anchors, the planes synced
    once after start() (the anchors' terms intern the keys in KEYS order):
    32 pods of the variant's traffic in waves of `wave` (two: a cold launch
    and a chained one; one: a program of the reference's fewer): equal
    bindings, PodScheduled=False diagnoses and rng."""
    args, n_keys = VARIANTS[variant]
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    out = {}
    for name, side in SIDES.items():
        store = side.Store()
        for node in cap.capacity_nodes(N_NODES, n_keys, side.types, side.meta):
            store.create(node)
        for pod, node in cap.anchor_pods(N_NODES, n_keys, side.types, side.meta):
            pod.spec.node_name = node
            store.create(pod)
        prof = side.Profile(backend="tpu", wave_size=wave, plugin_args=args or {})
        sched = side.Scheduler(store, profiles=[prof], **side.kw)
        sched.start()
        sched.cache.update_snapshot(sched.snapshot)
        sched.algorithms["default-scheduler"].backend.sync(sched.snapshot)
        for pod in _traffic(variant, 0, 2 * WAVE, side.types, side.meta):
            store.create(pod)
        sched.schedule_pending()
        out[name] = (outcome(store, sched), sched)
    (want, _), (got, tsched) = out["jax"], out["port"]
    assert got == want
    assert sum(1 for k, v in got[0].items() if v and k[0] in "pw") >= WAVE
    _check_slots(tsched.algorithms["default-scheduler"].backend.builder.vocabs, n_keys)


# --------------------------------------------------------------------------
# the B3 configurations: ten scored resources, LeastAllocated and a
# 21-point RequestedToCapacityRatio shape, over 4 keys
# --------------------------------------------------------------------------


def test_batched_assign_matches_reference(waves):
    _case_batched_assign(waves, "least10", True)


def test_backend_waves_match_reference_on_both_contexts():
    _case_backend_waves("least10")


def test_batched_assign_without_dedup_matches_reference(waves):
    _case_batched_assign(waves, "rtc21", False)


def test_sharded_assign_on_8_shards_matches_k2_and_reference(waves):
    _case_sharded_assign(waves, "rtc21")


def test_wave_matrix_matches_reference(waves):
    _case_wave_matrix(waves, "least10")


def test_schedule_pod_matches_reference():
    _case_schedule_pod("rtc21")


@pytest.mark.parametrize("variant,mode", [("least10", "Required"), ("rtc21", "Preferred")])
def test_gang_matches_reference(variant, mode):
    _case_gang(variant, mode)
