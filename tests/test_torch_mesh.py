"""Node shards in the port: K6's plain version (the plain scan under
ShardComm) against the reference package's JAX sharded_batched_assign on a
mesh of n node shards (the conftest gives 8 virtual CPU devices), the shard
invariance of the plain scan, K7's plain version (the pods x nodes
matrix) against JAX wave_fit_and_score, the mesh helpers and their errors,
context_from_env, and the mesh gate of the gang path on both packages.

Each case lets the reference backend make planes, tables, features and
signature groups, and both sides get the same numpy arrays; the JAX
outputs are node-sharded and gather to numpy. Every output array is
compared exactly (integers and bools: tolerance 0): packed (winners, tie
words consumed, overflow), the carried planes, the IPA planes, sig_scores
and the whole sig_table. The JAX sharded program compiles once per shard
count and configuration (about 10-15 s each on one CPU core), so the cases
share a few shapes.
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
from kubernetes_tpu.api.resource import ResourceNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import stack_features
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu.testing import (
    make_pod,
    synthetic_cluster,
    with_preferred_node_affinity,
    with_spread,
)
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    sig_table_from_reference,
    unpack_features,
)
from kubernetes_tpu_torch.parallel.mesh import SchedulerMesh
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from tests.test_torch_dedup import _assert_equal_outputs
from tests.test_torch_pipeline import _kernel_inputs


def _spread_inputs():
    """tests/test_parallel.py's cluster: 40 nodes in 4 zones with one pod
    each, 8 pods with a zone hard spread and a preferred zone affinity."""
    names = ResourceNames()
    _, snapshot = synthetic_cluster(40, n_zones=4, init_pods_per_node=1, names=names)
    backend = TPUBackend(names)
    pods = []
    for i in range(8):
        p = make_pod(f"p{i}", cpu=f"{1 + i % 3}", mem="2Gi", labels={"app": "x"})
        p = with_spread(p, max_skew=2, key="topology.kubernetes.io/zone",
                        when="DoNotSchedule")
        pods.append(with_preferred_node_affinity(p, 5, "topology.kubernetes.io/zone",
                                                 ("zone-1",)))
    for p in pods:
        backend.extractor.register(p)
    planes = backend.builder.sync(snapshot)
    feats = stack_features([backend.extractor.features(p, planes) for p in pods])
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    sig_ids, uniq, _ = backend._group_wave(feats, len(pods))
    return cfg, planes, arrays, feats, sig_ids, uniq


def _inputs(case):
    return _spread_inputs() if case == "spread" else _kernel_inputs(case)


def _words(feats, seed):
    pad = feats["active"].shape[0]
    return clone_tie_words(random.Random(seed), (2 * pad + 1) * jk.MAX_TIE_DRAWS)


def _port_sharded(cfg, n, arrays, feats, words, nb, sig_ids=None, uniq=None, **kw):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    mesh = tmesh.scheduler_mesh(n, device="cpu")
    planes = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if not k.startswith("aff_")})
    tables = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    as_t = (lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.int32)))
    return tmesh.sharded_batched_assign(
        pcfg, mesh, planes, tables, packed_f, layout,
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(tk.log_weight_table(nb)),
        sig_ids=as_t(sig_ids), uniq_idx=as_t(uniq), **kw)


def _jax_sharded(cfg, n, arrays, feats, words, sig_ids=None, uniq=None, **kw):
    mesh = jmesh.scheduler_mesh(n_devices=n, wave=1)
    _, out = jmesh.sharded_batched_assign(cfg, mesh, jmesh.shard_planes(mesh, arrays),
                                          feats, words, sig_ids=sig_ids,
                                          uniq_idx=uniq, **kw)
    return out


@pytest.mark.parametrize("case,n,dedup", [
    ("spread", 2, True), ("spread", 4, True), ("spread", 8, True),
    ("spread", 4, False), ("hard-zone", 2, True), ("ipa-existing", 4, True),
])
def test_sharded_batched_assign_matches_reference(case, n, dedup):
    """K6's plain version on n node shards == JAX sharded_batched_assign on
    a mesh of n node shards, every output array."""
    cfg, planes, arrays, feats, sig_ids, uniq = _inputs(case)
    words = _words(feats, 3 + n)
    groups = (sig_ids, uniq) if dedup else (None, None)
    want = _jax_sharded(cfg, n, arrays, feats, words, *groups)
    got = _port_sharded(cfg, n, arrays, feats, words, planes.nb, *groups)
    _assert_equal_outputs(got, want)
    assert ("tiers" in got) == dedup
    assert (np.asarray(want["packed"])[:-2] >= 0).any()


def test_chained_sharded_wave_matches_reference():
    """A chained second wave at 8 shards on the first wave's node-sharded
    output planes and signature table (gathered to numpy and converted by
    planes_from_reference / sig_table_from_reference), with a crafted slot
    map, the first wave's cursor as a device tensor and a frame shift:
    every output equal to JAX's, the input table left as it was."""
    cfg, planes, arrays, feats, sig_ids, uniq = _inputs("spread")
    first = _jax_sharded(cfg, 8, arrays, feats, _words(feats, 21), sig_ids, uniq)
    chained = dict(arrays)
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        if k in first:
            chained[k] = first[k]
    g_pad = len(uniq)
    cmap = np.arange(g_pad, dtype=np.int32)
    cmap[1] = -1
    cursor = int(first["tie_consumed"])
    shift = min(2, cursor)
    words = _words(feats, 22)
    want = _jax_sharded(cfg, 8, chained, feats, words, sig_ids, uniq,
                        cursor_init=first["tie_consumed"], frame_shift=shift,
                        carry_map=cmap, sig_table=first["sig_table"])
    table, tcmap = sig_table_from_reference(first["sig_table"], cmap, "cpu")
    converted = {k: planes_from_reference({k: v}, "cpu")[k].numpy()
                 for k, v in chained.items()}
    got = _port_sharded(cfg, 8, converted, feats, words, planes.nb, sig_ids, uniq,
                        cursor_init=torch.tensor(cursor, dtype=torch.int32),
                        frame_shift=shift, carry_map=tcmap, sig_table=table)
    _assert_equal_outputs(got, want)
    for k, v in first["sig_table"].items():
        assert np.array_equal(table[k].numpy(), np.asarray(v))


def _port_inputs(cfg, arrays, feats, mesh):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    planes = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if not k.startswith("aff_")})
    tables = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    return pcfg, planes, tables, packed_f, layout


def test_wave_matrix_matches_reference():
    """K7's plain version == JAX wave_fit_and_score (wave=2: 4 node
    shards), feasible and total; each row == K4's feasible and total for
    that pod alone; an indivisible batch raises the reference's error on
    both packages."""
    cfg, planes, arrays, feats, _sig, _uniq = _spread_inputs()
    jm = jmesh.scheduler_mesh(n_devices=8, wave=2)
    want_f, want_t = jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays),
                                              feats)
    tm = tmesh.scheduler_mesh(8, wave=2, device="cpu")
    pcfg, tplanes, ttables, packed_f, layout = _port_inputs(cfg, arrays, feats, tm)
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    got_f, got_t = tmesh.wave_fit_and_score(pcfg, tm, tplanes, ttables, packed_f, layout,
                                            logtab)
    assert got_f.dtype == torch.bool and got_t.dtype == torch.int32
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_f.any() and not got_f.all()
    nf = len(tk.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    for p in range(packed_f.shape[0]):
        one = tk.fit_and_score(pcfg, tplanes, ttables, packed_f[p: p + 1], layout, logtab)
        row = tk.unpack_fit_outputs(one[0], planes.nb, nf, planes.r)
        assert torch.equal(row["feasible"], got_f[p]) and torch.equal(row["total"], got_t[p])
    three = {k: v[:3] for k, v in feats.items()}
    with pytest.raises(ValueError, match="not divisible by wave") as jerr:
        jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays), three)
    packed3, layout3 = features_from_reference(three, "cpu")
    with pytest.raises(ValueError, match="not divisible by wave") as terr:
        tmesh.wave_fit_and_score(pcfg, tm, tplanes, ttables, packed3, layout3, logtab)
    assert str(terr.value) == str(jerr.value)


def _plain_scan(case, words, n=None):
    cfg, planes, arrays, feats, sig_ids, uniq = _inputs(case)
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference({k: v for k, v in arrays.items()
                                     if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference({k: v for k, v in arrays.items()
                                     if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    f = unpack_features(packed_f, layout)
    sig = torch.from_numpy(np.asarray(sig_ids, np.int32))
    un = torch.from_numpy(np.asarray(uniq, np.int32))
    static = tk.static_parts(dplanes, dtables, packed_f, layout, rows=un)
    w = torch.from_numpy(words.view(np.int32))
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    if n is None:
        return tk.assign_scan_ref(pcfg, dplanes, static, f, w, 0, logtab, sig, un)
    return tk.sharded_assign_ref(pcfg, dplanes, static, f, w, 0, logtab, n, sig, un)


def _flat(out):
    flat = {k: v for k, v in out.items() if k != "sig_table"}
    flat.update({f"sig_table.{k}": v for k, v in out["sig_table"].items()})
    return flat


@pytest.mark.parametrize("words", ["rng", "overflow"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_scan_is_shard_invariant(n, words):
    """The plain scan on n shards equals the unsharded plain scan, every
    output, on SchedulingBasic's shape (32 equal node slots: every step a
    tie over several shards) with a seeded word stream and with a stream
    of three all-ones words (every draw rejects: a tie overflow)."""
    cfg, planes, arrays, feats, sig_ids, uniq = _inputs("basic")
    stream = (_words(feats, 5) if words == "rng"
              else np.full(3, 0xFFFFFFFF, np.uint32))
    want = _flat(_plain_scan("basic", stream))
    got = _flat(_plain_scan("basic", stream, n))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    winners = want["packed"][:-2]
    owners = {int(w) // (planes.nb // n) for w in winners if w >= 0}
    assert n == 1 or len(owners) > 1  # the winners lie on several shards
    assert int(want["packed"][-1]) == int(words == "overflow")


def test_shard_comm_reductions():
    """ShardComm reduces each range, then folds the ranges in order: the
    same values as the whole axis, the per-shard tie counts, the owner's
    published value; a bucket it does not divide raises."""
    x = torch.tensor([3, -1, 7, 2, 0, 9, -4, 5], dtype=torch.int32)
    m = x > 1
    for n in (1, 2, 4, 8):
        c = tk.ShardComm(n)
        assert int(c.vmax(x)) == 9 and int(c.vmin(x)) == -4 and int(c.vsum(x)) == 21
        assert bool(c.vmax(m)) and c.gather(m).tolist() == (
            m.view(n, -1).sum(1).tolist())
        seg = c.seg(torch.tensor([0, 1, 0, 1, 2, 2, 0, 1]), x, 3)
        assert seg.tolist() == [6, 6, 9]
        assert c.publish(x, 5) == 9 and c.publish(x, 6) == -4
    with pytest.raises(ValueError, match="not divisible by 3 node shards"):
        tk.ShardComm(3).vmax(x)


def test_mesh_helpers_and_their_errors():
    """scheduler_mesh's axis arithmetic and its limits; shard_planes'
    and MeshContext.put's texts equal the reference's for a bucket the
    shard count does not divide and for an unknown plane."""
    m = tmesh.scheduler_mesh(8, wave=2, device="cpu")
    assert m.shape == {"wave": 2, "nodes": 4}
    assert tmesh.scheduler_mesh(device="cpu").shape == {"wave": 1, "nodes": 8}
    with pytest.raises(ValueError, match="does not divide device count 8"):
        tmesh.scheduler_mesh(8, wave=3, device="cpu")
    for n in (3, 6, 16):
        with pytest.raises(ValueError, match="thread-block cluster"):
            tmesh.scheduler_mesh(n, device="cpu")
    jm = jmesh.scheduler_mesh(n_devices=8, wave=1)
    tm = tmesh.scheduler_mesh(8, device="cpu")
    for bad in ({"used": np.zeros((12, 2), np.int32)},
                {"aff_allow": np.zeros((2, 12), np.bool_)},
                {"nope": np.zeros(8, np.int32)}):
        with pytest.raises(ValueError) as jerr:
            jmesh.shard_planes(jm, bad)
        with pytest.raises(ValueError) as terr:
            tmesh.shard_planes(tm, bad)
        assert str(terr.value) == str(jerr.value)
    ctx = tmesh.MeshContext(tm)
    with pytest.raises(ValueError, match="not divisible by 8 node shards"):
        ctx.put(np.zeros((12, 2), np.int32), "used")
    assert ctx.put_replicated(np.zeros((12, 2), np.int32)).shape == (12, 2)
    rep = tmesh.replicate(tm, {"a": np.arange(3, dtype=np.int32)})
    assert rep["a"].tolist() == [0, 1, 2]


def test_context_from_env():
    """Unset, empty, not an integer and <= 1 give LocalContext, as in the
    reference; 2, 4 and 8 a MeshContext; any other count raises (the
    reference would fall back). A context on another device than the
    backend's raises."""
    for env in ({}, {"KUBE_TPU_MESH_DEVICES": ""}, {"KUBE_TPU_MESH_DEVICES": "1"},
                {"KUBE_TPU_MESH_DEVICES": "x"}, {"KUBE_TPU_MESH_DEVICES": "0"}):
        ctx = tmesh.context_from_env(env, device="cpu")
        assert isinstance(ctx, tmesh.LocalContext) and ctx.n_shards == 1
        assert isinstance(jmesh.context_from_env(env), jmesh.LocalContext)
    for n in (2, 4, 8):
        ctx = tmesh.context_from_env({"KUBE_TPU_MESH_DEVICES": str(n)}, device="cpu")
        assert isinstance(ctx, tmesh.MeshContext) and ctx.n_shards == n and ctx.is_sharded
    for raw in ("3", "16"):
        with pytest.raises(ValueError, match="thread-block cluster"):
            tmesh.context_from_env({"KUBE_TPU_MESH_DEVICES": raw}, device="cpu")
    from kubernetes_tpu_torch.api.resource import ResourceNames as TNames

    b = TorchBackend(TNames(), device="cpu")
    assert isinstance(b._ctx, tmesh.LocalContext)
    away = tmesh.MeshContext(SchedulerMesh(1, 4, torch.device("cuda")))
    with pytest.raises(ValueError, match="the context runs on cuda"):
        TorchBackend(TNames(), device="cpu", context=away)


def test_gang_wave_declines_on_a_mesh():
    """Both packages' try_gang_wave on a mesh backend: None, the members
    counted on the host side, the rng untouched, no kernel run."""
    from kubernetes_tpu.scheduler.tpu import gangplanner as jplanner
    from kubernetes_tpu.scheduler.tpu.backend import TPUSchedulingAlgorithm
    from kubernetes_tpu_torch.scheduler.tpu import gangplanner as tplanner
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchSchedulingAlgorithm
    from kubernetes_tpu_torch.testing.mixed import (
        build_gang_nodes,
        build_gangs,
        gang_wave_spec,
    )
    from tests.test_torch_gang import _Jax, _Port, _qpis

    spec = gang_wave_spec()
    out = []
    for pkg in ("jax", "port"):
        types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
        side = (_Jax if pkg == "jax" else _Port)(build_gang_nodes(spec, types, meta))
        if pkg == "jax":
            side.backend = TPUBackend(side.names, context=jmesh.MeshContext(
                jmesh.scheduler_mesh(n_devices=4)))
            algo = TPUSchedulingAlgorithm(side.fw, side.backend, rng=random.Random(9))
            totals = lambda: side.backend.recorder.gang_pod_totals  # noqa: E731
            planner = jplanner
        else:
            side.backend = TorchBackend(side.names, device="cpu", context=tmesh.MeshContext(
                tmesh.scheduler_mesh(4, device="cpu")))
            algo = TorchSchedulingAlgorithm(side.fw, side.backend, rng=random.Random(9))
            totals = lambda: side.backend.gang_pod_totals  # noqa: E731
            planner = tplanner
        group, pods = build_gangs(spec, types, meta)[0]
        side.add_group(group, pods)
        side.cache.update_snapshot(side.snapshot)
        state = algo.rng.getstate()
        hosts = planner.try_gang_wave(side, side.fw, algo, group.meta.key, _qpis(pods))
        assert hosts is None and algo.rng.getstate() == state
        out.append(dict(totals()))
    assert out[1] == out[0] == {"host": len(build_gangs(spec, ttypes, tmeta)[0][1])}
