"""K4 and K7 at the card level on the CPU ("cards" are CPU devices): the
plain versions (the cards' parts joined, K4's or K7's plain version, each
card's outputs cut back out) over 2 and 4 cards against the reference's
JAX sharded_fit_and_score and wave_fit_and_score on a mesh of as many
virtual CPU devices (the conftest gives 8), on the spread, hard-spread and
IPA cases; each card's part of the packed K4 outputs unpacked at the card's
bucket and joined. A file of its own: each JAX program compiles per mesh
and configuration. Integers and bools: bit equality (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.ops import cards as tc
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import features_from_reference
from tests.test_torch_mesh import _inputs


def _port_inputs(cfg, arrays, feats, ctx):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    planes = tmesh.shard_planes(ctx.mesh, {k: v for k, v in arrays.items()
                                           if not k.startswith("aff_")})
    tables = tmesh.shard_planes(ctx.mesh, {k: v for k, v in arrays.items()
                                           if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    return pcfg, planes, tables, ctx.put_replicated(packed_f), layout


@pytest.mark.parametrize("case,cards", [
    ("spread", 2), ("spread", 4), ("hard-zone", 4), ("ipa-existing", 2),
])
def test_card_level_k4_matches_reference(case, cards):
    """K4 at the card level over `cards` CPU cards == JAX
    sharded_fit_and_score on a mesh of as many devices, for every pod of
    the wave one at a time: fails, feasible, insufficient, too_many_pods,
    total and every plugin's row, joined over the cards."""
    cfg, planes, arrays, feats, _s, _u = _inputs(case)
    jm = jmesh.scheduler_mesh(n_devices=cards, wave=1)
    jdev = jmesh.shard_planes(jm, arrays)
    ctx = tmesh.MeshContext(tmesh.scheduler_mesh(cards, devices=["cpu"] * cards))
    pcfg, tplanes, ttables, _pf, layout = _port_inputs(cfg, arrays, feats, ctx)
    logtab = ctx.put_replicated(torch.from_numpy(tk.log_weight_table(planes.nb)))
    nf = len(tk.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    n_pods = feats["active"].shape[0]
    for p in range(min(n_pods, 4)):
        one = {k: v[p] for k, v in feats.items()}
        want = jmesh.sharded_fit_and_score(cfg, jm, jdev, one)
        f1, _ = features_from_reference({k: v[p:p + 1] for k, v in feats.items()}, "cpu")
        out = tmesh.sharded_fit_and_score(pcfg, ctx.mesh, tplanes, ttables,
                                          ctx.put_replicated(f1), layout, logtab, ctx)
        assert isinstance(out, tc.CardTensor) and len(out.parts) == cards
        got = tc.fit_outputs(out, 0, nf, planes.r)
        for k in ("fails", "feasible", "insufficient", "too_many_pods", "total"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (p, k)
        for name in tk.PLUGIN_NAMES:
            assert np.array_equal(got["per_plugin"][name].numpy(),
                                  np.asarray(want["per_plugin"][name])), (p, name)


@pytest.mark.parametrize("cards", [2, 4])
def test_card_level_k7_matches_reference(cards):
    """K7 at the card level (the mesh's wave_fit_and_score, wave 2: the pod
    batch in two parts over the node axis's cards) == JAX
    wave_fit_and_score on a (2, 4) mesh: feasible and total joined over the
    cards, each part on its card; an indivisible batch raises the
    reference's error."""
    cfg, planes, arrays, feats, _s, _u = _inputs("spread")
    jm = jmesh.scheduler_mesh(n_devices=8, wave=2)
    want_f, want_t = jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays), feats)
    ctx = tmesh.MeshContext(tmesh.scheduler_mesh(2 * cards, wave=2,
                                                 devices=["cpu"] * cards))
    assert ctx.cards == cards and ctx.mesh.shape == {"wave": 2, "nodes": cards}
    pcfg, tplanes, ttables, pf, layout = _port_inputs(cfg, arrays, feats, ctx)
    logtab = ctx.put_replicated(torch.from_numpy(tk.log_weight_table(planes.nb)))
    got_f, got_t = tmesh.wave_fit_and_score(pcfg, ctx.mesh, tplanes, ttables, pf, layout,
                                            logtab, ctx)
    assert got_f.dim == 1 and len(got_f.parts) == cards
    assert np.array_equal(got_f.cpu().numpy(), np.asarray(want_f))
    assert np.array_equal(got_t.cpu().numpy(), np.asarray(want_t))
    assert got_f.cpu().any() and not got_f.cpu().all()
    three = {k: v[:3] for k, v in feats.items()}
    with pytest.raises(ValueError, match="not divisible by wave") as jerr:
        jmesh.wave_fit_and_score(cfg, jm, jmesh.shard_planes(jm, arrays), three)
    p3, l3 = features_from_reference(three, "cpu")
    with pytest.raises(ValueError, match="not divisible by wave") as terr:
        tmesh.wave_fit_and_score(pcfg, ctx.mesh, tplanes, ttables, ctx.put_replicated(p3), l3,
                                 logtab, ctx)
    assert str(terr.value) == str(jerr.value)


def test_card_level_shifts_node_indices():
    """A pod's NodeName and affinity pin are node indices: each card gets
    them moved into its range, -1 kept, and -2 (no node) where the node is
    another card's."""
    layout = [("name_idx", 0, 1, 1, "i"), ("aff_pin", 1, 1, 1, "i"), ("x", 2, 1, 1, "i")]
    f = torch.tensor([[5, -1, 7], [12, 3, 7], [-1, 15, 7]], dtype=torch.int32)
    assert tc._shift_feats(f, layout, 0, 8).tolist() == [[5, -1, 7], [-2, 3, 7], [-1, -2, 7]]
    assert tc._shift_feats(f, layout, 8, 8).tolist() == [[-2, -1, 7], [4, -2, 7], [-1, 7, 7]]
    assert f.tolist() == [[5, -1, 7], [12, 3, 7], [-1, 15, 7]]  # the input untouched
