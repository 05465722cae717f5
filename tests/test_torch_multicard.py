"""The mesh over several cards on the CPU: "cards" are CPU devices
(scheduler_mesh(devices=["cpu"] * C)), each holding a contiguous range of
the node axis as a tensor of its own (ops/cards.py CardTensor).

The layout rule and its errors; MeshContext.put's split of every node
plane and its copies of the rest; the backend's routing of dirty rows to
the cards that own them against the reference's _scatter_rows_jit on a
node-sharded mesh; and K6's card-level plain version (the cards' parts
joined, the plain scan under ShardComm(cards x shards), the outputs split
back) over 2 and 4 cards at 1 and 2 shards a card against JAX
sharded_batched_assign on a mesh of cards x shards virtual CPU devices
(the conftest gives 8), a chained wave included. Every output is compared,
each card-level output joined over the cards (a copy on every card
compared on each): integers and bools, bit equality (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.scheduler.tpu.backend import _scatter_rows_jit
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.cards import CardTensor, card_ranges
from kubernetes_tpu_torch.ops.planes import (
    SLICE_PLANES,
    features_from_reference,
    planes_from_reference,
)
from kubernetes_tpu_torch.parallel.mesh import SchedulerMesh
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from tests.test_torch_dedup import _assert_equal_outputs
from tests.test_torch_mesh import _inputs, _jax_sharded, _words


def _cards(c):
    return ["cpu"] * c


def _ctx(cards, shards):
    return tmesh.MeshContext(tmesh.scheduler_mesh(cards * shards, devices=_cards(cards)))


def joined(out):
    """A card-level output dict with every CardTensor joined over its cards
    (a copy on every card: each card's copy checked equal to card 0's)."""
    res = {}
    for k, v in out.items():
        if isinstance(v, dict):
            res[k] = joined(v)
        elif isinstance(v, CardTensor):
            if v.dim is None:
                for p in v.parts[1:]:
                    assert torch.equal(p, v.parts[0]), k
            res[k] = v.cpu()
        else:
            res[k] = v
    return res


@pytest.mark.parametrize("n,cards,nodes,shards", [
    (2, 2, 2, 1), (4, 2, 4, 2), (4, 4, 4, 1), (8, 4, 8, 2), (16, 2, 16, 8), (8, 1, 8, 8),
])
def test_layout_rule(n, cards, nodes, shards):
    """C = min(n, cards) cards, n node shards, n / C of them a card; one
    card keeps the one-card mesh (no devices tuple)."""
    m = tmesh.scheduler_mesh(n, devices=_cards(cards))
    assert m.shape == {"wave": 1, "nodes": nodes}
    assert len(m.cards) == min(n, cards) and m.shards_per_card == shards
    assert m.devices == (() if min(n, cards) == 1 else tuple(torch.device("cpu")
                                                             for _ in range(min(n, cards))))


@pytest.mark.parametrize("n,cards,wave,match", [
    (6, 4, 1, "do not divide over 4 cards"),
    (32, 2, 1, "16 node shards a card"),
    (12, 4, 1, "3 node shards a card"),
    (8, 4, 3, "does not divide device count 8"),
    (0, 2, 1, "no devices for mesh"),
])
def test_layout_errors(n, cards, wave, match):
    """A layout the cards and their clusters cannot hold raises; nothing
    falls back to fewer cards or to one card."""
    with pytest.raises(ValueError, match=match):
        tmesh.scheduler_mesh(n, wave=wave, devices=_cards(cards))


def test_one_card_unchanged_and_env():
    """With one card nothing changes (the positional SchedulerMesh of one
    card, 8 shards by default); KUBE_TPU_MESH_DEVICES spreads over the
    visible cards (the CPU: one) and a count they cannot hold raises with
    the variable named."""
    assert tmesh.scheduler_mesh(device="cpu") == SchedulerMesh(1, 8, torch.device("cpu"))
    assert tmesh.scheduler_mesh(device="cpu").cards == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="KUBE_TPU_MESH_DEVICES=16: 16 node shards a card"):
        tmesh.context_from_env({"KUBE_TPU_MESH_DEVICES": "16"}, device="cpu")
    ctx = tmesh.context_from_env({"KUBE_TPU_MESH_DEVICES": "4"}, device="cpu")
    assert ctx.cards == 1 and ctx.n_shards == 4
    m = tmesh.scheduler_mesh(devices=_cards(4))
    assert m.shape["nodes"] == 4 and m.shards_per_card == 1


@pytest.mark.parametrize("cards", [2, 4])
def test_put_splits_node_planes_and_copies_the_rest(cards):
    """put cuts a node plane's node axis (the affinity table's columns) into
    the cards' contiguous ranges, each its own tensor, and copies anything
    else onto every card; upload_bytes counts each card's share."""
    ctx = _ctx(cards, 1)
    used = np.arange(64, dtype=np.int32).reshape(16, 4)
    t = ctx.put(used, "used")
    assert isinstance(t, CardTensor) and t.dim == 0 and t.shape == (16, 4)
    for c, (lo, hi) in enumerate(card_ranges(16, cards)):
        assert np.array_equal(t.parts[c].numpy(), used[lo:hi])
    allow = np.random.default_rng(0).random((3, 16)) > 0.5
    a = ctx.put(allow, "aff_allow")
    assert a.dim == 1 and a.parts[0].dtype == torch.bool
    assert np.array_equal(np.concatenate([p.numpy() for p in a.parts], 1), allow)
    key = ctx.put(np.arange(5, dtype=np.int32), "ipa_term_key")
    assert key.dim is None and all(np.array_equal(p.numpy(), np.arange(5)) for p in key.parts)
    assert len({p.data_ptr() for p in key.parts}) == cards  # copies, not one tensor
    rep = ctx.put_replicated(np.ones((2, 3), np.int32))
    assert rep.dim is None and rep.shape == (2, 3) and rep[1].shape == (3,)
    per = used.nbytes // cards + allow.nbytes // cards + 5 * 4 + 6 * 4
    assert ctx.upload_bytes == [per] * cards
    with pytest.raises(ValueError, match="not divisible by 4 node shards"):
        _ctx(2, 2).put(np.zeros((6, 2), np.int32), "used")


class _HostPlanes:
    """What _scatter_cards reads of the host planes."""

    def __init__(self, arrays, nb, bucket_sizes):
        self.arrays, self.nb, self.bucket_sizes = arrays, nb, bucket_sizes

    def as_dict(self):
        return self.arrays


@pytest.mark.parametrize("cards", [2, 4])
def test_dirty_rows_route_to_their_cards(cards):
    """The backend's delta upload over several cards (each dirty row to the
    card that owns it, card-local indices, K3's plain version per card)
    against the reference's _scatter_rows_jit on a node-sharded mesh of as
    many devices: every plane equal; a card that owns no dirty row gets no
    upload."""
    _cfg, planes, arrays, _f, _s, _u = _inputs("basic")
    nb = planes.nb
    host = {k: np.array(arrays[k]) for k in SLICE_PLANES}
    rng = np.random.default_rng(cards)
    per = nb // cards
    idx = np.array(sorted({1, 2, per + 3, nb - 1}), np.int32)
    idx = idx[idx < nb - per] if cards == 4 else idx  # the last card: no dirty row
    new = {k: v.copy() for k, v in host.items()}
    for k, v in new.items():
        if v.dtype == np.bool_:
            v[idx] = ~v[idx]
        else:
            v[idx] = rng.integers(0, 50, size=v[idx].shape).astype(v.dtype)
    jm = jmesh.scheduler_mesh(n_devices=cards, wave=1)
    dev = jmesh.shard_planes(jm, host)
    rows = jmesh.replicate(jm, {k: v[idx] for k, v in new.items()})
    want = _scatter_rows_jit(dev, rows, jmesh.replicate(jm, idx))
    ctx = _ctx(cards, 1)
    backend = TorchBackend(_names(), device="cpu", context=ctx)
    backend._device_planes = {k: ctx.put(planes_from_reference({k: host[k]}, "cpu")[k], k)
                              for k in SLICE_PLANES}
    before = list(ctx.upload_bytes)
    tk.reset_launches()
    backend._scatter_cards(_HostPlanes(new, nb, planes.bucket_sizes), idx)
    for k in SLICE_PLANES:
        got = backend._device_planes[k].cpu().numpy()
        assert np.array_equal(got, np.asarray(want[k])), k
    owners = {int(i) // per for i in idx}
    grew = [c for c in range(cards) if ctx.upload_bytes[c] > before[c]]
    assert grew == sorted(owners)
    assert backend.upload_stats["scatter"] == len(owners)
    assert backend.upload_stats["rows"] == len(idx)


def _names():
    from kubernetes_tpu_torch.api.resource import ResourceNames

    return ResourceNames()


def _port_cards(cfg, cards, shards, arrays, feats, words, nb, sig_ids=None, uniq=None, **kw):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    ctx = _ctx(cards, shards)
    mesh = ctx.mesh
    planes = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if not k.startswith("aff_")})
    tables = tmesh.shard_planes(mesh, {k: v for k, v in arrays.items()
                                       if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    rep = (lambda a: None if a is None
           else ctx.put_replicated(torch.from_numpy(np.asarray(a, np.int32))))
    out = tmesh.sharded_batched_assign(
        pcfg, mesh, planes, tables, ctx.put_replicated(packed_f), layout,
        ctx.put_replicated(torch.from_numpy(words.view(np.int32))),
        ctx.put_replicated(torch.from_numpy(tk.log_weight_table(nb))),
        sig_ids=rep(sig_ids), uniq_idx=rep(uniq), ctx=ctx, **kw)
    assert isinstance(out["packed"], CardTensor) and len(out["used"].parts) == cards
    return out


@pytest.mark.parametrize("case,cards,shards,dedup", [
    ("spread", 2, 1, True), ("spread", 4, 1, True), ("spread", 2, 2, True),
    ("spread", 4, 2, True), ("spread", 2, 1, False), ("hard-zone", 4, 1, True),
    ("ipa-existing", 2, 2, True), ("basic", 4, 2, True),
])
def test_card_level_k6_matches_reference(case, cards, shards, dedup):
    """K1 + K6 at the card level (the plain version) over `cards` CPU cards
    at `shards` shards a card == JAX sharded_batched_assign on a mesh of
    cards x shards node shards: every output, joined over the cards."""
    cfg, planes, arrays, feats, sig_ids, uniq = _inputs(case)
    n = cards * shards
    words = _words(feats, 3 + n)
    groups = (sig_ids, uniq) if dedup else (None, None)
    want = _jax_sharded(cfg, n, arrays, feats, words, *groups)
    got = _port_cards(cfg, cards, shards, arrays, feats, words, planes.nb, *groups)
    _assert_equal_outputs(joined(got), want)
    assert ("tiers" in got) == dedup
    if dedup:  # the signature table's columns split by card, segs/pcs one copy
        assert got["sig_table"]["ew"].dim == 1
        assert isinstance(got["sig_table"]["segs"], torch.Tensor)


def test_card_level_chained_wave_matches_reference():
    """A chained second wave over 4 cards x 2 shards on the first wave's
    card-level outputs (carry planes and signature table columns on their
    cards, the cursor as each card's copy of packed[P]), with a crafted slot
    map and a frame shift: every output equal to JAX's chained wave on 8
    shards."""
    from tests.test_torch_mesh import _inputs as inputs

    cfg, planes, arrays, feats, sig_ids, uniq = inputs("spread")
    jfirst = _jax_sharded(cfg, 8, arrays, feats, _words(feats, 21), sig_ids, uniq)
    first = _port_cards(cfg, 4, 2, arrays, feats, _words(feats, 21), planes.nb, sig_ids, uniq)
    _assert_equal_outputs(joined(first), jfirst)
    chained = dict(arrays)
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        if k in jfirst:
            chained[k] = jfirst[k]
    cmap = np.arange(len(uniq), dtype=np.int32)
    cmap[1] = -1
    cursor = int(jfirst["tie_consumed"])
    shift = min(2, cursor)
    words = _words(feats, 22)
    want = _jax_sharded(cfg, 8, chained, feats, words, sig_ids, uniq,
                        cursor_init=jfirst["tie_consumed"], frame_shift=shift,
                        carry_map=cmap, sig_table=jfirst["sig_table"])
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    ctx = _ctx(4, 2)
    tplanes = {k: v for k, v in tmesh.shard_planes(ctx.mesh, {
        k: v for k, v in arrays.items() if not k.startswith("aff_")}).items()}
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        if k in first:
            tplanes[k] = first[k]
    tables = tmesh.shard_planes(ctx.mesh, {k: v for k, v in arrays.items()
                                           if k.startswith("aff_")})
    packed_f, layout = features_from_reference(feats, "cpu")
    rep = lambda a: ctx.put_replicated(torch.from_numpy(np.asarray(a, np.int32)))  # noqa: E731
    p = first["packed"]
    got = tmesh.sharded_batched_assign(
        pcfg, ctx.mesh, tplanes, tables, ctx.put_replicated(packed_f), layout,
        rep(words.view(np.int32)), ctx.put_replicated(torch.from_numpy(
            tk.log_weight_table(planes.nb))),
        cursor_init=p[p.shape[0] - 2], frame_shift=shift, sig_ids=rep(sig_ids),
        uniq_idx=rep(uniq), carry_map=rep(cmap), sig_table=first["sig_table"], ctx=ctx)
    _assert_equal_outputs(joined(got), want)


def test_card_tensor_views():
    """CardTensor: the joined value, its shape, bytes, and the views the
    backend takes of a copy on every card (slices, views); a node-split
    one refuses them."""
    ctx = _ctx(2, 1)
    flat = ctx.put_replicated(torch.arange(12, dtype=torch.int32))
    v = flat[2:8].view((2, 3))
    assert v.shape == (2, 3) and v.cpu().tolist() == [[2, 3, 4], [5, 6, 7]]
    assert flat.nbytes == 2 * 48 and flat.numel() == 12
    split = ctx.put(np.arange(16, dtype=np.int32).reshape(8, 2), "used")
    assert np.array_equal(np.asarray(split), np.arange(16).reshape(8, 2))
    with pytest.raises(ValueError, match="node-split"):
        split[0]
    with pytest.raises(ValueError, match="node-split"):
        split.view(16)
    assert split.clone().parts[0].data_ptr() != split.parts[0].data_ptr()
