"""Topology keys of more than 1024 domains (ROADMAP B1).

A rack key over a large cluster has thousands of domains: 1050 racks of 2
nodes give topo_dk 2048 (next_pow2 of the vocabulary: the reference's
one-hot matmul width, `matmul_domain_cap`), 2100 racks give 4096 (its
`segment_sum` branch). The port's kernels count any number of domains
(their tables past shared memory in a device-memory scratch, the GTAB
instances, which only a card runs); this file holds the port's plain
versions against the JAX package at both widths, every output compared
for exact equality: the three domain helpers on seeded planes,
batched_assign on both tiers (the signature table and the tie stream
among its outputs) and through the backends with an rng, K6's plain
version on 8 node shards against K2's and the reference, K7's plain
version against the reference's wave matrix, fit_and_score through
schedule_pod (FitError messages among the results), gang placement with
members spread by rack, and the store-driven loop.
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
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features as jpad
from kubernetes_tpu.ops.planes import stack_features as jstack
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import features_from_reference, planes_from_reference
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing.mixed import build_gangs, gang, gang_member
from tests.test_torch_gang import _Jax, _Port, _plan_view, _qpis
from tests.test_torch_host_tier import _drive, _sides
from tests.test_torch_loop import SIDES, _port_registry, run_both  # noqa: F401 (autouse)
from tests.test_torch_mesh import _jax_sharded, _port_sharded
from tests.test_torch_pipeline import (  # noqa: F401 (autouse, C12)
    _assert_equal_outputs,
    _own_process_state,
    _port_wave,
)

RACK = "rack"
# the rack key's width: (nodes, nodes a rack) giving that topo_dk
CLUSTERS = {2048: (2100, 2), 4096: (4200, 2)}
WIDTHS = list(CLUSTERS)


def _wr(types):
    return jw if types is jtypes else tw


def _rack_nodes(w, n, per):
    return [w.make_node(f"node-{i}", zone=f"zone-{i % 4}", labels={RACK: f"r{i // per}"})
            for i in range(n)]


def _rack_pods(w, lo, hi):
    """Pods spread by rack (DoNotSchedule and ScheduleAnyway), anti-affine
    by rack to their own app, and plain ones, in turn."""
    out = []
    for i in range(lo, hi):
        kind = i % 4
        app = ("spread", "soft", "anti", "web")[kind]
        p = w.make_pod(f"p{i:04d}", cpu="500m", mem="256Mi", labels={"app": app})
        if kind == 0:
            p = w.with_spread(p, max_skew=1, key=RACK, when="DoNotSchedule")
        elif kind == 1:
            p = w.with_spread(p, max_skew=1, key=RACK, when="ScheduleAnyway")
        elif kind == 2:
            p = w.with_pod_affinity(p, "app", "anti", RACK, anti=True)
        out.append(p)
    return out


def _existing(w, n_nodes, count):
    """(pod, node) pairs: running pods anti-affine by rack to their own app."""
    out = []
    for i in range(count):
        p = w.make_pod(f"ex{i:03d}", cpu="250m", mem="128Mi", labels={"app": f"ex{i % 3}"})
        out.append((w.with_pod_affinity(p, "app", f"ex{i % 3}", RACK, anti=True),
                    f"node-{(7 * i) % n_nodes}"))
    return out


# --------------------------------------------------------------------------
# the domain helpers
# --------------------------------------------------------------------------


def _helper_planes(dk, seed):
    """Seeded planes over a bucket of 2 * dk rows: zone (8 domains),
    hostname (singleton) and a rack key of dk domains, each missing on some
    rows; selector counts, IPA term counts and keys, a participation mask."""
    rng = np.random.default_rng(seed)
    nb = 2 * dk
    dom = np.stack([rng.integers(0, 8, nb), np.arange(nb), rng.integers(0, dk, nb)], 1)
    dom[rng.random((nb, 3)) < 0.05] = -1
    return {"domain": dom.astype(np.int32),
            "sel_counts": rng.integers(0, 6, (nb, 4)).astype(np.int32),
            "valid": rng.random(nb) < 0.9,
            "ipa_counts": rng.integers(0, 4, (nb, 5)).astype(np.int32),
            "ipa_term_key": np.array([0, 1, 2, 2, -1], np.int32),
            "col": rng.integers(-3, 9, nb).astype(np.int32)}


@pytest.mark.parametrize("dk", WIDTHS)
def test_domain_helpers_match_reference(dk):
    """_pts_domain_stats (with its captured tables), _domain_sum_at_node and
    _ipa_term_stats of the port == the reference's on every key slot: at
    dk 2048 the reference takes its one-hot matmul, at 4096 segment_sum."""
    pl = _helper_planes(dk, seed=dk)
    jcfg = jk.KernelConfig(topo_domains=(8, 0, dk))
    tcfg = tk.KernelConfig(topo_domains=(8, 0, dk))
    tpl = {k: torch.from_numpy(v) for k, v in pl.items()}
    mask = pl["valid"]
    for key_i in range(3):
        for sel_i in range(4):
            want = jk._pts_domain_stats(jcfg, pl, mask, key_i, sel_i, capture_dseg=dk)
            got = tk._pts_domain_stats(tcfg, tpl["domain"], tpl["sel_counts"], tpl["valid"],
                                       key_i, sel_i, dseg=dk)
            assert len(got) == len(want) == 6
            for g, w in zip(got, want):
                assert np.array_equal(np.asarray(g), np.asarray(w)), (key_i, sel_i)
        want = jk._domain_sum_at_node(jcfg, pl, key_i, pl["col"], mask)
        got = tk._domain_sum_at_node(tcfg, tpl["domain"], key_i, tpl["col"], tpl["valid"])
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w)), key_i
    for t in range(5):
        want = jk._ipa_term_stats(jcfg, pl, pl["ipa_counts"][:, t], int(pl["ipa_term_key"][t]),
                                  mask)
        got = tk._ipa_term_stats(tcfg, tpl, t, tpl["valid"])
        assert np.array_equal(got[0].numpy(), np.asarray(want[0])), t
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])), t
        assert bool(got[2]) == bool(want[2]), t


# --------------------------------------------------------------------------
# the wave: K1 + K2, K6 on 8 shards, K7
# --------------------------------------------------------------------------


def _reference_wave(dk, n_pods=16):
    """(cfg, planes, arrays, feats, sig_ids, uniq) of the reference's backend
    for a wave of rack pods over the cluster of width dk, with its existing
    anti-affine pods."""
    n, per = CLUSTERS[dk]
    names = JNames()
    cache = JCache(names)
    for node in _rack_nodes(jw, n, per):
        cache.add_node(node)
    backend = TPUBackend(names)
    for pod, node in _existing(jw, n, 24):
        backend.extractor.register(pod)
        cache.assume_pod(pod, node)
    snap = JSnapshot()
    cache.update_snapshot(snap)
    pods = _rack_pods(jw, 0, n_pods)
    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = jpad(jstack([backend.extractor.features(p, planes) for p in pods]), n_pods)
    cfg = backend.kernel_config(planes, feats)
    assert max(cfg.topo_domains) == dk and cfg.n_hard and cfg.n_soft and cfg.n_ipa_anti
    assert cfg.ipa_existing_anti
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    sig_ids, uniq, _ = backend._group_wave(feats, n_pods)
    return cfg, planes, arrays, feats, sig_ids, uniq


@pytest.fixture(scope="module")
def waves():
    return {dk: _reference_wave(dk) for dk in WIDTHS}


def _equal_no_dedup(got, want):
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert "sig_table" not in got


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("dk", WIDTHS)
def test_batched_assign_matches_reference(waves, dk, dedup):
    """K1 + K2's plain versions == JAX batched_assign on a wave of rack
    pods, both tiers: the packed winners and tie stream's cursor, the
    carried planes and, with dedup, sig_scores and the signature table
    (its per-domain segs and pcs dk words a slot)."""
    cfg, planes, arrays, feats, sig_ids, uniq = waves[dk]
    pad = feats["active"].shape[0]
    words = clone_tie_words(random.Random(dk), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    if dedup:
        _, want = jk.batched_assign(cfg, arrays, feats, words, sig_ids=sig_ids, uniq_idx=uniq)
        got = _port_wave(cfg, planes, arrays, feats, words, sig_ids, uniq)
        _assert_equal_outputs(got, want)
        assert got["sig_table"]["segs"].shape[2] == dk
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
    assert (np.asarray(want["packed"])[:-2] >= 0).all()


@pytest.mark.parametrize("dk", WIDTHS)
def test_sharded_assign_on_8_shards_matches_k2_and_reference(waves, dk):
    """K6's plain version on 8 node shards (ShardComm: every per-domain
    table a fold of 8 shard partials) == K2's plain version == JAX
    sharded_batched_assign on 8 shards, every output."""
    cfg, planes, arrays, feats, sig_ids, uniq = waves[dk]
    pad = feats["active"].shape[0]
    words = clone_tie_words(random.Random(dk + 1), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    want = _jax_sharded(cfg, 8, arrays, feats, words, sig_ids, uniq)
    got = _port_sharded(cfg, 8, arrays, feats, words, planes.nb, sig_ids, uniq)
    _assert_equal_outputs(got, want)
    k2 = _port_wave(cfg, planes, arrays, feats, words, sig_ids, uniq)
    for k in ("packed", "used", "sel_counts", "ipa_anti", "sig_scores"):
        assert torch.equal(got[k], k2[k]), k
    for k in ("segs", "pcs", "feas"):
        assert torch.equal(got["sig_table"][k], k2["sig_table"][k]), k


@pytest.mark.parametrize("dk", WIDTHS)
def test_wave_matrix_matches_reference(waves, dk):
    """K7's plain version == the reference's _wave_fit_and_score_jit (JAX
    wave_fit_and_score, wave 2 on 4 node shards): feasible and total of
    every rack pod against every node."""
    cfg, planes, arrays, feats, _sig, _uniq = waves[dk]
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


@pytest.mark.parametrize("dk", WIDTHS)
def test_backend_waves_match_reference_on_both_contexts(waves, dk):
    """Two waves of rack pods through TPUBackend.run_batched and
    TorchBackend.run_batched on LocalContext and on MeshContext(8) over the
    wave fixture's cluster, each wave's hosts assumed before the next:
    equal hosts and equal rng state after every wave."""
    n, per = CLUSTERS[dk]
    sides = {}
    for name in ("jax", "local", "mesh"):
        jax = name == "jax"
        w = jw if jax else tw
        names = JNames() if jax else TNames()
        cache = (JCache if jax else TCache)(names)
        for node in _rack_nodes(w, n, per):
            cache.add_node(node)
        if jax:
            backend = TPUBackend(names)
        else:
            ctx = (tmesh.MeshContext(tmesh.scheduler_mesh(8, device="cpu")) if name == "mesh"
                   else tmesh.LocalContext("cpu"))
            backend = TorchBackend(names, device="cpu", context=ctx)
        for pod, node in _existing(w, n, 24):
            backend.extractor.register(pod)
            cache.assume_pod(pod, node)
        snap = (JSnapshot if jax else TSnapshot)()
        cache.update_snapshot(snap)
        sides[name] = (w, cache, snap, backend, random.Random(7))
    for wave in range(2):
        hosts = {}
        for name, (w, cache, snap, backend, rng) in sides.items():
            pods = _rack_pods(w, 16 * wave, 16 * wave + 16)
            got, _ = backend.run_batched(pods, snap, rng=rng, pad_to=16)
            hosts[name] = (got, rng.getstate())
            for pod, node in zip(pods, got):
                if node is not None:
                    cache.assume_pod(pod, node)
            cache.update_snapshot(snap)
        assert hosts["local"] == hosts["jax"] and hosts["mesh"] == hosts["jax"], wave
        assert all(h is not None for h in hosts["jax"][0])


# --------------------------------------------------------------------------
# K4 through schedule_pod, the gang path, the loop
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dk", WIDTHS)
def test_schedule_pod_matches_reference(dk):
    """fit_and_score's plain version through schedule_pod == the
    reference's TPUSchedulingAlgorithm over rack nodes with existing pods
    anti-affine by rack: each pod's host, evaluated and feasible counts, or
    its FitError (message, diagnosis, every node's status), the rotation
    index, the kernel and fallback counts and the final rng."""
    n, per = CLUSTERS[dk]
    sides = _sides(lambda types, meta: _rack_nodes(_wr(types), n, per))
    for side in sides:
        for pod, node in _existing(_wr(side.types), n, 12):
            side.assume(pod, node)

    def pods(side):
        w = _wr(side.types)
        out = [p for p in _rack_pods(w, 0, 12) if p.meta.labels["app"] in ("spread", "anti")]
        # spread by rack and too large for any node: a FitError
        big = w.make_pod("big", cpu="64", mem="1Gi", labels={"app": "spread"})
        return out + [w.with_spread(big, max_skew=1, key=RACK, when="DoNotSchedule")]

    recs = _drive(sides, pods)
    assert recs[-1][0] == "fit" and "Insufficient cpu" in recs[-1][1]
    assert all(r[0] != "fit" for r in recs[:-1])


@pytest.mark.parametrize("dk,mode", [(2048, "Required"), (4096, "Preferred")])
def test_gang_with_members_spread_by_rack_matches_reference(dk, mode):
    """Gangs of 4 placed by zone whose members spread by rack (maxSkew 1,
    DoNotSchedule) through both packages' planner and run_gang (K1 + K5's
    plain versions: every mask row a rack table of dk words), each gang's
    hosts bound before the next: the plan, hosts, winning row, outcome and
    rng equal."""
    n, per = CLUSTERS[dk]
    spec = {"nodes": [], "gangs": [
        gang(f"g{g}", mode, [gang_member(f"g{g}-{i}", spread=(1, RACK)) for i in range(4)],
             labelled=True) for g in range(2)]}
    results = []
    for types, meta, side_cls in ((jtypes, jmeta, _Jax), (ttypes, tmeta, _Port)):
        side = side_cls(_rack_nodes(_wr(types), n, per))
        rng = random.Random(11)
        got = []
        for group, pods in build_gangs(spec, types, meta):
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
    want, got = results
    assert got == want
    assert all(r[1] is not None and r[2].startswith("device:") for r in got)


@pytest.mark.parametrize("dk", WIDTHS)
def test_store_loop_matches_reference(dk, monkeypatch):
    """The store-driven loop (informer, queue, the wave pipeline at depth
    2, the batched bind) over rack nodes: 32 rack pods in two waves of 16
    (spread by rack, anti-affine by rack, plain): equal bindings,
    PodScheduled=False diagnoses and rng."""
    n, per = CLUSTERS[dk]

    def build(side, store, sched):
        w = side.w
        for node in _rack_nodes(w, n, per):
            store.create(node)
        for pod in _rack_pods(w, 0, 32):
            store.create(pod)
        sched.schedule_pending()

    out = run_both(build, monkeypatch, wave_size=16)
    want, got = out["jax"][0], out["port"][0]
    assert got == want
    assert sum(1 for v in got[0].values() if v) == 32
