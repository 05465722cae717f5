"""The port's plain scans against the reference at 524288 node slots.

At this bucket the card's launch plan runs K2, K5 and K6 as 16 blocks of
two passes (ROADMAP B5, tests/test_torch_scan_passes.py). The plain
versions, which the card's kernels are held to (chip_smoke.py phase 29
(e)), have no cap: here they meet the reference package at that width.
The planes are numpy arrays, built once from a small cluster's rows
tiled over 524288 slots (300000 of them live, every cpu load one of 13
levels and the emptiest level only past slot 262144, so the best nodes'
tie sets run to thousands of nodes in the card's second pass), with four
pods, so no Python node cache of that size is built. Every output is compared exactly (integers and bools): the port's
batched_assign (K1 + K2, dedup on) against JAX batched_assign, with its
tie cursor, and the port's gang_assign (K1 once + K5) against JAX
gang_assign on two zone rows and the fallback row over every live node.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features as jpad
from kubernetes_tpu.ops.planes import stack_features as jstack
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu.testing import make_pod as jmake_pod
from kubernetes_tpu.testing import synthetic_cluster as jsynthetic
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import features_from_reference, planes_from_reference
from tests.test_torch_pipeline import (  # noqa: F401 (autouse, C12)
    _assert_equal_outputs,
    _own_process_state,
    _port_wave,
)

NB = 524288
LIVE = 300000
SMALL = 64  # the small cluster's nodes: 8 zones, tiled over NB
HALF = 16 * 16384  # the slots of one pass on 16 blocks


class _Planes:
    """What the helpers read of a Planes: its bucket."""

    nb = NB


@pytest.fixture(scope="module")
def wide():
    """(cfg, arrays, feats, pods' count, the wave's signature groups) at NB
    slots: the small cluster's rows tiled (node i takes row i % SMALL: its
    zone is i % 8), the first LIVE valid with a cpu load of (i * 7919 % 13)
    x 2 cpus (one level more below slot 262144), the rest padding (invalid,
    zero rows)."""
    names = JNames()
    cache, snap = jsynthetic(SMALL, n_zones=8, names=names)
    backend = TPUBackend(names)
    pods = [jmake_pod(f"p{i}", cpu="700m", mem="512Mi", labels={"app": f"g{i % 2}"})
            for i in range(4)]
    for pod in pods:
        backend.extractor.register(pod)
    small = backend.sync(snap)
    feats = jpad(jstack([backend.extractor.features(p, small) for p in pods]), 4)
    cfg = backend.kernel_config(small, feats)
    groups = backend._group_wave(feats, len(pods))[:2]
    arrays = {}
    for k, v in {**small.as_dict(), **backend.extractor.affinity_tables(small)}.items():
        v = np.asarray(v)
        node_rows = v.ndim and v.shape[0] == small.nb and k != "ipa_term_key"
        if node_rows and not k.startswith("aff_"):
            rows = np.take(v, np.arange(NB) % SMALL, axis=0)
            rows[LIVE:] = 0 if v.dtype != np.bool_ else False
            if k in ("domain", "taints", "prefer_taints"):
                rows[LIVE:] = -1
            v = rows
        elif k == "aff_allow":  # [signatures, nodes]
            v = np.take(v, np.arange(NB) % SMALL, axis=1)
            v[:, LIVE:] = False
        arrays[k] = np.ascontiguousarray(v)
    i = np.arange(LIVE)
    load = (i * 7919 % 13 + (i < HALF)) * 2000
    arrays["used"][:LIVE, 0] = load
    arrays["nonzero_used"][:LIVE, 0] = load
    return cfg, arrays, feats, len(pods), groups


def test_batched_assign_at_two_passes_matches_reference(wide):
    """K1 + K2 (dedup on, two signatures) over 524288 slots: every output,
    the sig_table and the tie cursor equal the reference's, and the winners
    lie past slot 262144 (in the card's second pass)."""
    cfg, arrays, feats, n, (sig_ids, uniq) = wide
    pad = feats["active"].shape[0]
    words = clone_tie_words(random.Random(41), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, want = jk.batched_assign(cfg, arrays, feats, words, sig_ids=sig_ids, uniq_idx=uniq)
    got = _port_wave(cfg, _Planes, arrays, feats, words, sig_ids, uniq)
    _assert_equal_outputs(got, want)
    packed = got["packed"].numpy()
    assert int(packed[-2]) == int(want["tie_consumed"]) > n and not packed[-1]
    winners = packed[:n]
    assert (winners >= HALF).all()
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    plan = tk.scan_plan("assign_scan", pcfg, NB, R=arrays["alloc"].shape[1],
                        S=arrays["sel_counts"].shape[1], max_blocks=16)
    assert plan == (16, 16) and plan.passes == 2


def test_gang_assign_at_two_passes_matches_reference(wide):
    """K1 once + K5 over two zone rows and the fallback row over every live
    node (padded to 4 rows): the packed vector equals the reference's
    element for element, and the fallback row's plan walks two passes."""
    cfg, arrays, feats, n, _ = wide
    zone = np.arange(NB) % 8
    live = np.arange(NB) < LIVE
    masks = np.stack([live & (zone == 0), live & (zone == 3), live,
                      np.zeros(NB, np.bool_)])
    words = clone_tie_words(random.Random(43), 4 * jk.MAX_TIE_DRAWS + jk.MAX_TIE_DRAWS)
    want = np.asarray(jk.gang_assign(cfg, arrays, feats, masks, words, 2, True))
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    got = tk.gang_assign(pcfg, dplanes, static, packed_f, layout, torch.from_numpy(masks),
                         torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(tk.log_weight_table(NB)), 2, True,
                         population=LIVE).numpy()
    assert np.array_equal(got, want)
    assert got[-1] == n and got[-2] == 1
    plan = tk.scan_plan("gang_assign", pcfg, NB, R=arrays["alloc"].shape[1],
                        S=arrays["sel_counts"].shape[1], population=LIVE, max_blocks=16)
    assert plan == (16, 16) and plan.passes == 2
