"""The reference's default wave in the port: signature dedup (the two-tier
replay scan), hard spread and inter-pod affinity in K2's plain version (run
on the CPU), against the reference package's JAX batched_assign on the
same inputs.

Each case builds a cluster and a wave in the reference package's types,
lets the reference backend make planes, tables, features and signature
groups, and hands both sides the same numpy arrays. Every output array is
compared exactly — winners, tie words consumed, overflow, the carried
planes, the IPA planes, sig_scores and the whole sig_table (the entries of
inactive spread slots included): all are integers or bools, so the
tolerance is zero. The spread domain counts stay off the points where
the JAX kernel's log weight differs from the host plugin's, which the port
follows (tests/test_torch_fit.py shows the difference).
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
from kubernetes_tpu.api.resource import ResourceNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features, stack_features
from kubernetes_tpu.scheduler.cache.cache import Cache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot
from kubernetes_tpu.scheduler.tpu.backend import (
    TPUBackend,
    clone_tie_words,
    group_feature_rows as jgroup,
)
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import features_from_reference, planes_from_reference
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend, group_feature_rows
from kubernetes_tpu_torch.testing.mixed import (
    build_nodes,
    build_pods,
    dedup_nodes,
    dedup_pods,
    ipa_pods,
    mixed_spec,
)


def _mixed(seed, n_nodes, n_pods):
    spec = mixed_spec(seed, n_nodes, n_pods, constraints=True)
    return build_nodes(spec, jtypes, jmeta), build_pods(spec, jtypes, jmeta)


def _case(name):
    """(nodes, existing pods assumed round-robin, wave, pad_to, tie words
    kind, seed) in the reference package's types."""
    if name == "mixed":  # 39 pods want ~35 CPU of 32: clone runs fail late
        return dedup_nodes(8, jtypes, jmeta), [], dedup_pods(39, jtypes, jmeta), 0, "rng", 7
    if name == "hard-zone":
        return (dedup_nodes(8, jtypes, jmeta), [],
                dedup_pods(27, jtypes, jmeta, spread=(3, "zone")), 0, "rng", 13)
    if name == "hard-hostname":  # a singleton key: the min over valid nodes
        return (dedup_nodes(8, jtypes, jmeta), [],
                dedup_pods(30, jtypes, jmeta, spread=(1, "hostname")), 0, "rng", 17)
    if name == "ipa-existing":  # existing pods carry every kind of term
        nodes, pods = _mixed(31, 24, 60)
        return nodes, pods[:24], pods[24:], 40, "rng", 19
    if name == "ipa-wave-adds-first-anti":  # no existing term: the wave's own
        return dedup_nodes(12, jtypes, jmeta, cpu="8"), [], ipa_pods(36, jtypes, jmeta), 0, "rng", 23
    if name == "pads-3-words":
        return (dedup_nodes(8, jtypes, jmeta), [],
                dedup_pods(20, jtypes, jmeta, spread=(2, "zone")), 32, "short", 29)
    raise KeyError(name)


CASES = ["mixed", "hard-zone", "hard-hostname", "ipa-existing",
         "ipa-wave-adds-first-anti", "pads-3-words"]


def _reference_inputs(name):
    nodes, existing, wave, pad_to, words_kind, seed = _case(name)
    names = ResourceNames()
    cache = Cache(names)
    for n in nodes:
        cache.add_node(n)
    backend = TPUBackend(names)
    for i, pod in enumerate(existing):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(5 * i) % len(nodes)].meta.name)
    snap = Snapshot()
    cache.update_snapshot(snap)
    for pod in wave:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = stack_features([backend.extractor.features(p, planes) for p in wave])
    if pad_to:
        feats = pad_features(feats, pad_to)
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    n_words = feats["active"].shape[0] * jk.MAX_TIE_DRAWS + jk.MAX_TIE_DRAWS
    words = clone_tie_words(random.Random(seed), 3 if words_kind == "short" else n_words)
    sig_ids, uniq, _ = backend._group_wave(feats, len(wave))
    return cfg, planes, arrays, feats, words, sig_ids, uniq


def _port(cfg, planes, arrays, feats, words, sig_ids=None, uniq=None):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    as_t = (lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.int32)))
    return tk.batched_assign(
        pcfg, dplanes, dtables, packed_f, layout,
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(tk.log_weight_table(planes.nb)),
        sig_ids=as_t(sig_ids), uniq_idx=as_t(uniq))


def _assert_equal_outputs(got, want):
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    keys = ["used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti",
            "ipa_pref", "sig_scores"]
    for k in keys:
        assert (k in got) == (k in want), k
        if k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert ("sig_table" in got) == ("sig_table" in want)
    if "sig_table" in want:
        assert set(got["sig_table"]) == set(want["sig_table"])
        for k, v in want["sig_table"].items():
            assert np.array_equal(got["sig_table"][k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("dedup", [True, False], ids=["dedup-on", "dedup-off"])
@pytest.mark.parametrize("case", CASES)
def test_batched_assign_matches_reference(case, dedup):
    """The port's batched_assign (K1 + K2 plain versions) == JAX
    batched_assign on every output array, with and without dedup."""
    cfg, planes, arrays, feats, words, sig_ids, uniq = _reference_inputs(case)
    assert jk.dedup_fast_capable(cfg) and tk.dedup_fast_capable(cfg)
    if not dedup:
        sig_ids = uniq = None
    _, want = jk.batched_assign(cfg, arrays, feats, words, sig_ids=sig_ids, uniq_idx=uniq)
    got = _port(cfg, planes, arrays, feats, words, sig_ids, uniq)
    _assert_equal_outputs(got, want)
    winners = np.asarray(want["packed"])[:-2]
    assert (winners >= 0).any()
    # each case exercises what its name says
    if case == "mixed":
        assert (winners[: feats["active"].sum()] < 0).any()  # late clones fail
    if case.startswith("hard"):
        assert cfg.n_hard == 1
    if case.startswith("ipa"):
        assert cfg.ipa_active and cfg.ipa_existing_anti and cfg.n_ipa_aff and cfg.n_ipa_pref
    if case == "ipa-wave-adds-first-anti":
        assert not arrays["ipa_anti"].any()  # only the wave's pods add anti terms
    if case == "pads-3-words":
        assert (~feats["active"]).any() and int(want["tie_consumed"]) > len(words)
    if dedup:
        full, replay = got["tiers"].tolist()
        assert full + replay == feats["active"].shape[0]
        assert replay > 0 and full >= int(sig_ids.max()) + 1


@pytest.mark.parametrize("case", CASES)
def test_dedup_on_equals_dedup_off(case):
    """The port's dedup-on scan decides exactly as its dedup-off scan."""
    cfg, planes, arrays, feats, words, sig_ids, uniq = _reference_inputs(case)
    on = _port(cfg, planes, arrays, feats, words, sig_ids, uniq)
    off = _port(cfg, planes, arrays, feats, words)
    for k, v in off.items():
        assert torch.equal(on[k], v), k


def test_group_feature_rows_first_appearance_order():
    packed = np.array([[1, 2], [3, 4], [1, 2], [5, 6], [3, 4]], dtype=np.int32)
    ids, uniq = group_feature_rows(packed)
    assert ids.tolist() == [0, 1, 0, 2, 1]
    assert uniq.tolist() == [0, 1, 3]
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 3, (64, 2)).astype(np.int32)
    for got, want in zip(group_feature_rows(rows), jgroup(rows)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_group_wave_pads_uniq_to_pow2(case):
    """The port's grouping of a wave equals the reference backend's: same
    sig_ids, uniq_idx padded to a power of two (floor 8) by repeating the
    first group's slot, same dedup_stats."""
    cfg, planes, arrays, feats, words, sig_ids, uniq = _reference_inputs(case)
    from kubernetes_tpu_torch.ops.planes import pack_features

    backend = TorchBackend(TNames(), device="cpu")
    n_real = int(feats["active"].sum())
    got = backend._group_wave(pack_features(feats)[0], n_real)
    assert np.array_equal(got[0], sig_ids) and np.array_equal(got[1], uniq)
    g = int(sig_ids.max()) + 1
    assert len(uniq) == max(8, 1 << (g - 1).bit_length())
    assert (uniq[g:] == uniq[0]).all()
    assert backend.dedup_stats == {"pods": n_real,
                                   "signatures": int(sig_ids[:n_real].max()) + 1,
                                   "waves": 1, "xwave_hits": 0, "xwave_misses": 0,
                                   "xwave_evictions": 0}
    backend.dedup_enabled = False
    assert backend._group_wave(pack_features(feats)[0], n_real) is None


def _drive(backend, cache, snap, pods, size, seed):
    rng = random.Random(seed)
    out = []
    for w in range(0, len(pods), size):
        wave = pods[w: w + size]
        got, _ = backend.run_batched(wave, snap, rng=rng, pad_to=size)
        for pod, node in zip(wave, got):
            if node is not None:
                cache.assume_pod(pod, node)
        cache.update_snapshot(snap)
        out.append(got)
    return out, rng.getstate()


@pytest.mark.parametrize("kind", ["hard-zone", "ipa"])
def test_run_batched_hard_spread_and_ipa_match_reference(kind):
    """Waves with hard spread or IPA pods through TPUBackend.run_batched
    and TorchBackend.run_batched (dedup on in both): equal bindings, equal
    final rng state, and the port's dedup grouped its waves."""
    build = ((lambda types, meta: dedup_pods(40, types, meta, spread=(1, "zone")))
             if kind == "hard-zone" else (lambda types, meta: ipa_pods(40, types, meta)))
    results = []
    for types, meta, names, cache_cls, snap_cls, make in (
            (jtypes, jmeta, ResourceNames, Cache, Snapshot, TPUBackend),
            (ttypes, tmeta, TNames, TCache, TSnapshot,
             lambda n: TorchBackend(n, device="cpu"))):
        names_ = names()
        cache = cache_cls(names_)
        for n in dedup_nodes(10, types, meta, cpu="8"):
            cache.add_node(n)
        snap = snap_cls()
        cache.update_snapshot(snap)
        backend = make(names_)
        results.append((_drive(backend, cache, snap, build(types, meta), 16, 3), backend))
    (want, jb), (got, tb) = results
    assert got == want
    assert any(n for wave in got[0] for n in wave)
    assert tb.dedup_stats["waves"] == 3
    assert 0 < tb.dedup_stats["signatures"] < tb.dedup_stats["pods"]
    full, replay = tb.tier_steps.tolist()
    assert full + replay == 48 and replay > 0
