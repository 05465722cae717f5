"""The port's wave kernels (plain PyTorch versions, run on the CPU) against
the reference package's JAX kernels on the same inputs.

The inputs are built once by the reference package (planes, affinity
tables, stacked features from a numpy-seeded mixed workload) and handed to
both sides as numpy arrays; every output is compared exactly — they are
integers, and the contract is bit-exact.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
from kubernetes_tpu.api.resource import ResourceNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features, stack_features
from kubernetes_tpu.scheduler.cache.cache import Cache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot
from kubernetes_tpu.scheduler.tpu.backend import (
    TPUBackend,
    _scatter_rows_jit,
    clone_tie_words,
)
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    unpack_features,
)
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

RTC_DECREASING = {"NodeResourcesFit": {
    "strategy": "RequestedToCapacityRatio",
    "shape": [[0, 100], [50, 20], [100, 0]]}}
MOST = {"NodeResourcesFit": {"strategy": "MostAllocated"}}


def _reference_wave(seed, plugin_args=None, n_nodes=32, n_pods=40,
                    n_existing=14, pad_to=32):
    """A mixed cluster in the reference package with some pods already
    placed, and the next wave's inputs: (cfg, planes+tables numpy dict,
    stacked padded features)."""
    spec = mixed_spec(seed, n_nodes, n_pods)
    names = ResourceNames()
    cache = Cache(names)
    nodes = build_nodes(spec, jtypes, jmeta)
    for n in nodes:
        cache.add_node(n)
    pods = build_pods(spec, jtypes, jmeta)
    backend = TPUBackend(names, plugin_args=plugin_args)
    # existing pods: round-robin assumes (ports, selector counts, usage)
    for i, pod in enumerate(pods[:n_existing]):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(3 * i) % n_nodes].meta.name)
    snap = Snapshot()
    cache.update_snapshot(snap)
    wave = pods[n_existing:]
    for pod in wave:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = stack_features([backend.extractor.features(p, planes) for p in wave])
    feats = pad_features(feats, pad_to)
    tables = backend.extractor.affinity_tables(planes)
    cfg = backend.kernel_config(planes, feats)
    return cfg, planes, {**planes.as_dict(), **tables}, feats


def _port_cfg(cfg):
    import dataclasses

    return tk.KernelConfig(**dataclasses.asdict(cfg))


def _split(arrays):
    planes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    tables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    return planes, tables


def _jax_static(cfg, arrays, feats):
    import jax

    return jax.vmap(lambda f: jk._static_pod_parts(cfg, arrays, f))(
        {k: jnp.asarray(v) for k, v in feats.items()})


CASES = {
    # (seed, plugin args, tie words: "rng" | "zero" | "short" | "ones")
    "least-rng": (1, None, "rng"),
    "least-rng-2": (2, None, "rng"),
    "most-rng": (3, MOST, "rng"),
    "rtc-decreasing-rng": (4, RTC_DECREASING, "rng"),
    "least-no-rng": (5, None, "zero"),
    "least-cursor-past-stream": (20, None, "short"),
    "least-tie-overflow": (6, None, "ones"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wave_scan_matches_reference(case):
    """static_parts_ref + assign_scan_ref == JAX batched_assign(sig_ids=None)
    on winners, tie_consumed, tie_overflow, used, nonzero_used, sel_counts,
    and K1's five outputs == the vmapped _static_pod_parts."""
    seed, pa, words_kind = CASES[case]
    cfg, planes, arrays, feats = _reference_wave(seed, pa)
    n_words = feats["active"].shape[0] * jk.MAX_TIE_DRAWS + jk.MAX_TIE_DRAWS
    words = {
        "rng": clone_tie_words(random.Random(seed), n_words),
        "zero": jk.ZERO_TIE_WORDS,
        "short": clone_tie_words(random.Random(seed), 3),
        "ones": np.full(n_words, 0xFFFFFFFF, np.uint32),
    }[words_kind]
    winners, info = jk.batched_assign(cfg, arrays, feats, words)

    pcfg = _port_cfg(cfg)
    dplanes, dtables = _split(arrays)
    packed_f, layout = features_from_reference(feats, "cpu")
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    ref_static = _jax_static(cfg, arrays, feats)
    for k, v in ref_static.items():
        assert np.array_equal(static[k].numpy(), np.asarray(v)), k
    out = tk.assign_scan(pcfg, dplanes, static, packed_f, layout,
                         torch.from_numpy(words.view(np.int32)), 0, logtab)
    packed, used, nz_used, sel_counts = (
        out[k] for k in ("packed", "used", "nonzero_used", "sel_counts"))
    P = feats["active"].shape[0]
    assert packed[:P].tolist() == np.asarray(winners).tolist()
    assert int(packed[P]) == int(info["tie_consumed"])
    assert bool(packed[P + 1]) == bool(info["tie_overflow"])
    assert np.array_equal(used.numpy(), np.asarray(info["used"]))
    assert np.array_equal(nz_used.numpy(), np.asarray(info["nonzero_used"]))
    assert np.array_equal(sel_counts.numpy(), np.asarray(info["sel_counts"]))
    # the case must exercise what its name says
    if words_kind == "ones":
        assert bool(info["tie_overflow"])
    if words_kind == "short":  # reads clamp to the last word (C5)
        assert int(info["tie_consumed"]) > len(words)
    assert (np.asarray(winners) >= 0).any()


def test_mixed_workload_reaches_every_branch():
    """Together, the parametrized waves above exercise taints,
    prefer-taints, images, used host ports, required/preferred affinity,
    pins, unschedulable nodes, nodes without a zone, an extended resource
    column past PODS, explicit spread over a third, partly absent topology
    key, pods that fit nowhere and pad slots."""
    seen = {}
    for seed, pa, _words in CASES.values():
        cfg, planes, a, f = _reference_wave(seed, pa)
        n, act = planes.n, f["active"]
        flags = {
            "taints": (a["taints"][:n] >= 0).any(),
            "prefer_taints": (a["prefer_taints"][:n] >= 0).any(),
            "images": (a["image_kib"][:n] > 0).any(),
            "used_ports": (a["port_words"][:n] != 0).any(),
            "unschedulable": a["unsched"][:n].any(),
            "no_zone": (a["domain"][:n, 0] < 0).any(),
            "preferred_affinity": a["aff_has_pref"].any(),
            "required_affinity": not a["aff_match"].all(),
            "pin": (f["aff_pin"][act] >= 0).any(),
            "pod_ports": f["has_ports"][act].any(),
            "tolerations": f["tol"][act].any() and f["tol_prefer"][act].any(),
            "extended": (a["alloc"][:n, 4] > 0).any() and (f["req"][act, 4] > 0).any(),
            "fits_nowhere": (f["req"][act, 0] > a["alloc"][:n, 0].max()).any(),
            "third_key": (len(cfg.topo_domains) > 2 and cfg.topo_domains[2] > 0
                          and (a["domain"][:n, 2] < 0).any()
                          and ((f["soft_key"][act] == 2) & f["soft_active"][act]).any()),
            "pad_slots": (~act).any(),
        }
        for k, v in flags.items():
            seen[k] = seen.get(k, False) or bool(v)
    assert all(seen.values()), [k for k, v in seen.items() if not v]


def test_scatter_rows_matches_reference():
    """scatter_rows_ref == the reference's _scatter_rows_jit, including a
    duplicated index (pow2 padding repeats the first row) and an index past
    the end, which both drop."""
    rng = np.random.default_rng(0)
    nb = 16
    dev = {
        "alloc": rng.integers(0, 100, (nb, 4)).astype(np.int32),
        "valid": rng.random(nb) < 0.5,
        "port_words": rng.integers(0, 2**32, (nb, 2), dtype=np.uint64).astype(np.uint32),
    }
    idx = np.array([3, 7, 3, nb], np.int32)
    rows = {k: np.ascontiguousarray(v[rng.integers(0, nb, idx.size)]) for k, v in dev.items()}
    rows["alloc"][2] = rows["alloc"][0]  # duplicate index carries the same row
    rows["valid"][2] = rows["valid"][0]
    rows["port_words"][2] = rows["port_words"][0]
    want = _scatter_rows_jit({k: jnp.asarray(v) for k, v in dev.items()},
                             {k: jnp.asarray(v) for k, v in rows.items()},
                             jnp.asarray(idx))
    got = planes_from_reference(dev, "cpu")
    tk.scatter_rows(got, planes_from_reference(rows, "cpu"), torch.from_numpy(idx))
    for k in dev:
        w = np.asarray(want[k])
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert np.array_equal(got[k].numpy(), w), k


# --- where a wrong bit is likely (ROADMAP C1-C5) ---------------------------


def test_log_weight_table_takes_the_numpy_side():
    """C1: jnp.log and np.log of float32 disagree by one ulp at 527 of the
    integers 2..20001 (first 37, 49, 179, 217). The port's weight table is
    np.log of float32 — the host plugin's side — and so differs from the
    reference kernel at exactly those points."""
    n = np.arange(2, 20002, dtype=np.float32)
    jx = np.asarray(jnp.log(n))
    npl = np.log(n)
    diff = n[jx != npl].astype(int)
    assert len(diff) == 527
    assert diff[:4].tolist() == [37, 49, 179, 217]
    table = tk.log_weight_table(19999)  # table[k] = log(k + 2), k <= 19999
    assert table.dtype == np.float32
    assert np.array_equal(table, npl)


def test_floordiv_floors_negative_operands():
    """C3: floor division for both signs (C/CUDA `/` truncates)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-10**6, 10**6, 4096).astype(np.int32)
    b = rng.integers(1, 1000, 4096).astype(np.int32) * rng.choice([-1, 1], 4096).astype(np.int32)
    got = tk.floordiv(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(got, a // b)


def test_rtc_decreasing_shape_matches_reference():
    """C3 in place: the RTC segment goes negative on a decreasing shape."""
    shape = ((0, 100), (30, 70), (50, 20), (100, 0))
    jcfg = jk.KernelConfig(strategy=jk.REQUESTED_TO_CAPACITY_RATIO, rtc_shape=shape)
    pcfg = tk.KernelConfig(strategy=tk.REQUESTED_TO_CAPACITY_RATIO, rtc_shape=shape)
    cap = np.full(4001, 4000, np.int32)
    req = np.arange(4001, dtype=np.int32)
    want = np.asarray(jk._strategy_score(jcfg, jnp.asarray(req), jnp.asarray(cap)))
    got = tk._strategy_score(pcfg, torch.from_numpy(req), torch.from_numpy(cap)).numpy()
    assert np.array_equal(got, want)


def test_balanced_score_float32_matches_reference():
    """C2: BalancedAllocation's float32 divisions and sqrt round as the
    reference's (sqrt via float64 in the plain version)."""
    rng = np.random.default_rng(3)
    nb = 20000
    alloc = rng.integers(0, 1 << 20, (nb, 4)).astype(np.int32)
    nz = rng.integers(0, 1 << 20, (nb, 2)).astype(np.int32)
    used = rng.integers(0, 1 << 20, (nb, 4)).astype(np.int32)
    req = rng.integers(0, 5000, 4).astype(np.int32)
    nz_req = rng.integers(1, 5000, 2).astype(np.int32)
    cfg = jk.KernelConfig()
    want = np.asarray(jk._balanced_score(
        cfg, {"alloc": alloc, "used": used, "nonzero_used": nz},
        {"req": req, "nz_req": nz_req}))
    got = tk._balanced_score(
        tk.KernelConfig(), torch.from_numpy(alloc), torch.from_numpy(used),
        torch.from_numpy(nz), torch.from_numpy(req), torch.from_numpy(nz_req))
    assert np.array_equal(got.numpy(), want)


def test_bit_length_by_comparisons():
    """C4: the plain version's bit length equals int.bit_length."""
    vals = [1, 2, 3, 4, 5, 7, 8, 255, 256, 5000, 8191, 8192, 2**31 - 1]
    for v in vals:
        assert int(tk._bit_length(torch.tensor(v, dtype=torch.int64))) == v.bit_length()


def test_wrappers_dispatch_by_device():
    """CPU tensors run the plain versions and count no launch; a device
    other than cpu/cuda raises instead of falling back."""
    _cfg, planes, arrays, feats = _reference_wave(1)
    dplanes, dtables = _split(arrays)
    packed_f, layout = features_from_reference(feats, "cpu")
    tk.reset_launches()
    out = tk.static_parts(dplanes, dtables, packed_f, layout)
    ref = tk.static_parts_ref(dplanes, dtables, unpack_features(packed_f, layout))
    for k in ref:
        assert torch.equal(out[k], ref[k])
    assert tk.LAUNCHES == {"static_parts": 0, "assign_scan": 0, "scatter_rows": 0,
                           "fit_and_score": 0, "gang_assign": 0, "sharded_assign": 0,
                           "wave_fit_and_score": 0}
    with pytest.raises(ValueError):
        tk.static_parts(dplanes, dtables, packed_f.to("meta"), layout)
    with pytest.raises(ValueError):
        tk.scatter_rows({}, {}, torch.zeros(1, dtype=torch.int32, device="meta"))


def test_out_of_slice_configs_raise():
    """The wave gate admits hard spread and IPA over any number of keys of
    any number of domains, with any number of scored resources and shape
    points, and refuses only past the kernels' slot capacities (4 spread
    slots, 4 required and 8 preferred IPA terms), an empty resource list
    or shape, and a strategy it does not name."""
    for cfg in (tk.KernelConfig(n_hard=1, n_soft=2),
                tk.KernelConfig(n_hard=0, n_ipa_aff=1),
                tk.KernelConfig(n_hard=0, ipa_existing_anti=True),
                tk.KernelConfig(n_hard=4, n_soft=4, topo_domains=(1024,) * 16),
                tk.KernelConfig(n_hard=0, n_soft=2, topo_domains=(8, 0)),
                tk.KernelConfig(n_hard=0, topo_domains=(2048, 0)),
                tk.KernelConfig(n_hard=1, n_soft=1, topo_domains=(8, 0, 8192)),
                tk.KernelConfig(topo_domains=(8,) * 17),
                tk.KernelConfig(n_hard=0, fit_resources=tuple((0, 1) for _ in range(9))),
                tk.KernelConfig(strategy="RequestedToCapacityRatio",
                                rtc_shape=tuple((5 * k, k) for k in range(21)))):
        tk.check_slice(cfg)
    for cfg in (tk.KernelConfig(max_constraints=5, n_hard=5, n_soft=0),
                tk.KernelConfig(n_hard=0, max_ipa_terms=5, n_ipa_aff=1),
                tk.KernelConfig(n_hard=0, fit_resources=()),
                tk.KernelConfig(n_hard=0, rtc_shape=()),
                tk.KernelConfig(n_hard=0, strategy="Balanced")):
        with pytest.raises(tk.OutOfSlice):
            tk.check_slice(cfg)
