"""K4's and K7's cluster partition: one pod's node axis cut over the C
blocks of a thread-block cluster (csrc/fit_and_score.cu) cannot change a
result.

The plain versions run under ShardComm(C).fit_split, which reduces over
each block's rows as the kernel cuts them (fit_partition: a share of the
live extent and a share of the padding per block) and then across the
blocks. Every output of fit_and_score_ref at C = 2, 4, 8 and 16 must equal
the reference package's JAX fit_and_score (_fit_and_score_jit) on
tests/test_torch_fit.py's cases, and two more: a zone key whose nodes
crowd into one domain (what the kernel's warp-aggregated table adds fold)
and a bucket whose live extent, with deleted rows inside it, is no multiple
of C. K7's plain version at C = 4 must equal JAX wave_fit_and_score. Every
output is an integer or a bool: the tolerance is zero. The JAX results are
computed once per case and shared by the cluster sizes.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    stack_features,
    unpack_features,
)
from tests.test_torch_fit import CASES as FIT_CASES
from tests.test_torch_fit import IPA, ZONE, _reference_inputs
from tests.test_torch_mesh import _port_inputs, _spread_inputs
from tests.wrappers import make_node, make_pod, with_spread

CLUSTERS = (2, 4, 8, 16)


def _crowded_zone():
    """40 nodes, 37 of them in zone z0 (the rest one each in z1-z3), pods
    of app=c on the first nodes; the pod spreads over the zone key both
    ways and prefers zones with app=c pods: every warp's table adds land
    on one or two words."""
    nodes = [make_node(f"n{i}", cpu="8", mem="16Gi",
                       zone="z0" if i < 37 else f"z{i - 36}") for i in range(40)]
    existing = [make_pod(f"ex{i}", cpu="100m", node_name=f"n{(5 * i) % 40}",
                         labels={"app": "c"}) for i in range(30)]
    pod = make_pod("p", cpu="100m", labels={"app": "c"})
    pod = with_spread(pod, max_skew=40, key=ZONE, when="DoNotSchedule")
    pod = with_spread(pod, max_skew=1, key=ZONE, when="ScheduleAnyway")
    pod.spec.affinity = IPA._affinity(preferred=[IPA._weighted(5, IPA._term({"app": "c"}))])
    return nodes, existing, pod, None


def _ragged_extent():
    """13 nodes (a 16-row bucket), nodes n4 and n12 deleted after the
    planes took their rows: the live extent is 12, no multiple of 8 or 16
    (nor of 4 or 2 past a hole), with an invalid row inside it."""
    nodes = [make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % 3}") for i in range(13)]
    existing = [make_pod(f"ex{i}", cpu="500m", node_name=f"n{i % 13}",
                         labels={"app": "r"}) for i in range(9)]
    pod = with_spread(make_pod("p", cpu="1", labels={"app": "r"}), max_skew=1,
                      key=ZONE, when="DoNotSchedule")
    return nodes, existing, pod, None, (), ("n4", "n12")


CASES = {**FIT_CASES, "crowded-zone": _crowded_zone, "ragged-extent": _ragged_extent}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(cfg, planes, tables, features, JAX fit_and_score's outputs)."""
    nodes, existing, pod, pa, *rest = CASES[case]()
    assumed = rest[0] if rest else ()
    deleted = rest[1] if len(rest) > 1 else ()
    cfg, planes, tables, f = _reference_inputs(nodes, existing, pod, pa, assumed)
    if deleted:  # the rows stay in the bucket, invalid and zeroed
        for name in deleted:
            i = planes.node_index[name]
            planes.valid[i] = False
            for plane in (planes.alloc, planes.used, planes.nonzero_used):
                plane[i] = 0
    want = jk.fit_and_score(cfg, {**planes.as_dict(), **tables}, f)
    return cfg, planes, tables, f, want


def _plain(cfg, planes, tables, f, comm):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    packed_f, layout = features_from_reference(stack_features([f]), "cpu")
    return tk.fit_and_score_ref(
        pcfg, planes_from_reference(planes.as_dict(), "cpu"),
        planes_from_reference(tables, "cpu"), unpack_features(packed_f, layout),
        torch.from_numpy(tk.log_weight_table(planes.nb)), 0, comm)


@pytest.mark.parametrize("n", CLUSTERS)
@pytest.mark.parametrize("case", list(CASES))
def test_cluster_plain_version_matches_reference(case, n):
    """fit_and_score_ref over a cluster of n blocks == JAX fit_and_score,
    every output array."""
    cfg, planes, tables, f, want = _case(case)
    got = _plain(cfg, planes, tables, f, tk.ShardComm(n))
    for k in ("fails", "feasible", "insufficient", "too_many_pods", "total"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert sorted(got["per_plugin"]) == sorted(want["per_plugin"])
    for name, v in want["per_plugin"].items():
        assert np.array_equal(got["per_plugin"][name].numpy(), np.asarray(v)), name


def test_special_cases_reach_their_shapes():
    """The crowded zone puts 37 of 40 nodes in one domain of the spread
    and IPA key, with hard and soft spread and a preferred term on it; the
    ragged bucket's extent (12 of 16 rows, a deleted row inside) is no
    multiple of 8 or 16, and at 4 blocks each block walks live rows and
    padding both."""
    cfg, planes, _, f, want = _case("crowded-zone")
    zones = planes.domain[: planes.n, int(f["hard_key"][0])]
    assert np.bincount(zones).max() == 37
    assert cfg.n_hard and cfg.n_soft and cfg.n_ipa_pref
    assert np.asarray(want["feasible"]).sum() == 40
    cfg, planes, _, _, want = _case("ragged-extent")
    valid = torch.from_numpy(planes.valid)
    extent = tk.valid_extent(valid)
    assert (planes.nb, extent) == (16, 12) and not planes.valid[4]
    parts = tk.fit_partition(planes.nb, extent, 4)
    assert all(hi > lo and phi > plo for lo, hi, plo, phi in parts)
    assert 0 < np.asarray(want["feasible"]).sum() < 11


@pytest.mark.parametrize("nb", [8, 16, 1024, 8192, 32768])
def test_fit_partition_covers_every_row_once(nb):
    """For every cluster size and live extent the blocks own each row
    once, none more than ceil(nb / C) rows; the live rows are split as
    evenly as integers allow, so every block walks live rows once the
    extent reaches C."""
    rng = np.random.default_rng(nb)
    for extent in sorted({0, 1, nb // 3, nb - 1, nb, *rng.integers(0, nb + 1, 4).tolist()}):
        for n in tk.FIT_CLUSTERS:
            parts = tk.fit_partition(nb, extent, n)
            rows = [i for lo, hi, plo, phi in parts for i in (*range(lo, hi), *range(plo, phi))]
            assert sorted(rows) == list(range(nb)), (extent, n)
            for lo, hi, plo, phi in parts:
                assert (hi - lo) + (phi - plo) <= -(-nb // n)
                assert 0 <= lo <= hi <= extent <= plo <= phi <= nb
                assert extent // n <= hi - lo <= -(-extent // n)
                assert extent < n or hi > lo


def test_wave_plain_version_matches_reference_on_a_cluster():
    """K7's plain version over clusters of 4 blocks per pod == JAX
    wave_fit_and_score (wave=2: 4 node shards), feasible and total."""
    cfg, planes, arrays, feats, _sig, _uniq = _spread_inputs()
    jm = jmesh.scheduler_mesh(n_devices=8, wave=2)
    want_f, want_t = jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays), feats)
    tm = tmesh.scheduler_mesh(8, wave=2, device="cpu")
    pcfg, tplanes, ttables, packed_f, layout = _port_inputs(cfg, arrays, feats, tm)
    got_f, got_t = tk.wave_fit_and_score_ref(
        pcfg, tplanes, ttables, unpack_features(packed_f, layout),
        torch.from_numpy(tk.log_weight_table(planes.nb)), tk.ShardComm(4))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    assert got_f.any() and not got_f.all()


def test_cluster_sizes_are_checked():
    """The wrappers take the cluster sizes the kernels have and refuse any
    other before touching a device."""
    cfg, planes, tables, f, _ = _case("hard-spread-zone")
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    packed_f, layout = features_from_reference(stack_features([f]), "cpu")
    dplanes = planes_from_reference(planes.as_dict(), "cpu")
    dtables = planes_from_reference(tables, "cpu")
    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    assert tk.FIT_CLUSTER in tk.FIT_CLUSTERS and tk.WAVE_FIT_CLUSTER in tk.WAVE_FIT_CLUSTERS
    with pytest.raises(ValueError, match="cluster of"):
        tk.fit_and_score(pcfg, dplanes, dtables, packed_f, layout, logtab, cluster=3)
    with pytest.raises(ValueError, match="blocks per pod"):
        tk.wave_fit_and_score(pcfg, dplanes, dtables, packed_f, layout, logtab, cluster=8)
    a = tk.fit_and_score(pcfg, dplanes, dtables, packed_f, layout, logtab, cluster=16)
    b = tk.fit_and_score(pcfg, dplanes, dtables, packed_f, layout, logtab, cluster=1)
    assert torch.equal(a, b)
