"""Node sharding on one card and over several, and the execution-context
seam (the reference's kubernetes_tpu/parallel/mesh.py).

The reference shards the node axis of every plane over a jax Mesh of
(wave, nodes) devices: the greedy wave scan becomes an explicit shard_map
whose only cross-shard traffic is the scalar and segment collectives of
AxisComm (_sharded_assign_jit), and the pods x nodes matrix a vmap over the
wave axis (_wave_fit_and_score_jit). One process drives every device.

The port does the same over cards. `scheduler_mesh(n, wave, devices)`
takes C = min(n, len(devices)) cards (default: every visible card) and
n // wave node shards; each card holds (n // wave) / C of them as blocks
of one thread-block cluster, which must be a cluster size (1, 2, 4 or 8).
On one card a node shard is one block of K6's cluster: a shard past one
block's 16384 node slots takes m blocks of the same cluster, n * m from
the launch plan (ops/kernels.py scan_plan): MeshContext(2) over 50000
nodes runs 4 blocks. The planes stay one contiguous tensor each; block r
of K6's cluster of c blocks owns the node range [r*Nb/c, (r+1)*Nb/c) of
every plane and of the signature table's columns, and the collectives are
exchanges through distributed shared memory.

Over several cards (ops/cards.py) card c holds the contiguous range
[c*Nb/C, (c+1)*Nb/C) of every node plane as a tensor of its own on its
card (CardTensor; the affinity table's columns likewise) and a copy of
everything else; K6, K4 and K7 run one instance per card, all launched
before anything waits, their reductions crossing cards inside the kernels
through peer memory over NVLink (csrc/comm.cuh CardComm), one level above
the cluster's. devices=["cpu"] * C gives C "cards" on the CPU, where the
plain versions run; devices=[cuda:0, cuda:0] gives two card ranks on one
card (never chosen by context_from_env). The wave axis's pod parts each
run over the node axis's cards. The decisions equal the unsharded scan's
bit for bit whatever the card and block counts, as the reference's do.

The backend holds one context for its life and routes every plane upload
and kernel entry through it: LocalContext runs K1 + K2 and K4 as before the
seam, MeshContext runs K1 + K6 and K4 (at the card level over several
cards). KUBE_TPU_MESH_DEVICES selects it (context_from_env). Deviation
from the reference: a count of node shards the cards and their clusters
cannot hold raises, where the reference falls back to LocalContext
whenever the count exceeds the visible devices; a silent fallback would
hide that K6 is not running. A pair of cards without peer access raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import kernels as _k
from ..ops.cards import (
    CardSet,
    CardTensor,
    card_ranges,
    cards_assign,
    cards_fit_and_score,
    cards_wave_fit_and_score,
)
from ..ops.kernels import CLUSTER_SHARDS, KernelConfig
from ..ops.planes import _to_device

NODE_AXIS = "nodes"
WAVE_AXIS = "wave"

# which dim of each kernel-input array is the nodes axis (None = replicated)
_NODE_DIM = {
    "alloc": 0, "used": 0, "nonzero_used": 0, "valid": 0, "unsched": 0,
    "group_id": 0, "taints": 0, "prefer_taints": 0, "domain": 0,
    "sel_counts": 0, "port_words": 0, "image_kib": 0,
    "ipa_counts": 0, "ipa_anti": 0, "ipa_pref": 0,
    # global term -> topology-key table replicates
    "ipa_term_key": None,
    # affinity signature tables: [A, G] rows replicate, [A, Nb] shards dim 1
    "aff_match": None, "aff_pref": None, "aff_has_pref": None,
    "aff_allow": 1,
}


@dataclass(frozen=True)
class SchedulerMesh:
    """(wave, nodes) axes over the mesh's cards: `nodes` node shards (blocks
    of one cluster in K6), cut over `devices` (the card ranks, one or more;
    a card may carry two ranks), each card holding nodes / len(devices) of
    them, and `wave` parts of a pod batch (K7's blocks)."""

    wave: int
    nodes: int
    device: torch.device
    devices: tuple = ()

    @property
    def shape(self) -> dict[str, int]:
        return {WAVE_AXIS: self.wave, NODE_AXIS: self.nodes}

    @property
    def cards(self) -> tuple:
        """The card ranks of the node axis (the one device where none given)."""
        return self.devices or (self.device,)

    @property
    def shards_per_card(self) -> int:
        return self.nodes // len(self.cards)


def _visible_cards(device) -> list:
    """Every visible card for a CUDA device given without an index, else the
    device itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        n = torch.cuda.device_count()
        if n > 1:
            return [torch.device("cuda", i) for i in range(n)]
    return [dev]


def scheduler_mesh(n_devices: int | None = None, wave: int = 1, devices=None,
                   device="cuda") -> SchedulerMesh:
    """A (wave, nodes) mesh of n_devices shards over the cards `devices`
    (default: every visible card of `device`; devices=["cpu"] * C gives C
    cards on the CPU, [cuda:0, cuda:0] two card ranks on one card). The
    mesh takes C = min(n_devices, len(devices)) cards; n_devices // wave
    node shards, each card holding (n_devices // wave) / C of them as
    blocks of its cluster. n_devices defaults to one shard per card where
    there are several, else 8 (the largest portable cluster). Raises
    ValueError when wave does not divide n_devices, when the node shards do
    not divide over the cards, or when a card's share is not a cluster size
    (1, 2, 4 or 8): nothing falls back."""
    from ..scheduler.tpu.backend import resolve_device

    cards = [resolve_device(d) for d in (_visible_cards(device) if devices is None
                                         else devices)]
    if not cards:
        raise ValueError("no devices for mesh")
    if n_devices is None:
        n = len(cards) if len(cards) > 1 else max(CLUSTER_SHARDS)
    else:
        n = int(n_devices)
    if n < 1:
        raise ValueError("no devices for mesh")
    if n % wave:
        raise ValueError(f"wave={wave} does not divide device count {n}")
    cards = cards[:min(n, len(cards))]
    nodes = n // wave
    if nodes % len(cards):
        raise ValueError(f"{nodes} node shards do not divide over {len(cards)} cards")
    if nodes // len(cards) not in CLUSTER_SHARDS:
        raise ValueError(
            f"{nodes // len(cards)} node shards a card: on one card a node shard is one "
            "block of a thread-block cluster, and a cluster holds 1, 2, 4 or 8 "
            "blocks (the portable limit)")
    return SchedulerMesh(wave, nodes, cards[0], tuple(cards) if len(cards) > 1 else ())


def _as_tensor(value, device) -> torch.Tensor:
    """numpy -> a new device tensor (the planes' dtypes mapped as
    planes_from_reference maps them; float32 kept); a tensor -> on the
    device, non-blocking (a pinned staging buffer stays the caller's)."""
    if isinstance(value, torch.Tensor):
        return value.to(device, non_blocking=True)
    a = np.ascontiguousarray(value)
    if a.dtype == np.float32:
        return torch.from_numpy(a).to(device, copy=True)
    return _to_device(a, device)


def _check_node_dim(name, shape, n_shards: int) -> None:
    if name not in _NODE_DIM:
        raise ValueError(
            f"unknown kernel input {name!r}: add it to _NODE_DIM so its "
            "node axis (or replication) is explicit")
    dim = _NODE_DIM[name]
    if dim is not None and shape[dim] % n_shards:
        raise ValueError(
            f"plane {name!r} node bucket {shape[dim]} not divisible "
            f"by {n_shards} node shards")


def shard_planes(mesh: SchedulerMesh, planes_dict: dict) -> dict:
    """Every plane on the mesh's card, its node axis checked against the
    shard count. On one card the planes stay contiguous: a shard is a node
    range that one block of K6 owns; over several cards each plane's node
    axis is cut into the cards' ranges (MeshContext.put)."""
    ctx = MeshContext(mesh) if len(mesh.cards) > 1 else None
    out = {}
    for k, a in planes_dict.items():
        _check_node_dim(k, tuple(a.shape), mesh.nodes)
        out[k] = ctx.put(a, k) if ctx else _as_tensor(a, mesh.device)
    return out


def replicate(mesh: SchedulerMesh, tree):
    """Pod features, tie words and other small inputs on the mesh's card (a
    dict of arrays, or one array)."""
    if len(mesh.cards) > 1:
        ctx = MeshContext(mesh)
        if isinstance(tree, dict):
            return {k: ctx.put_replicated(v) for k, v in tree.items()}
        return ctx.put_replicated(tree)
    if isinstance(tree, dict):
        return {k: _as_tensor(v, mesh.device) for k, v in tree.items()}
    return _as_tensor(tree, mesh.device)


# -- sharded kernel entry points ---------------------------------------------


def _card_set(mesh: SchedulerMesh, ctx=None) -> CardSet:
    return ctx.card_set if ctx is not None else CardSet(mesh.cards)


def sharded_fit_and_score(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                          tables: dict, packed_f, layout, logtab, ctx=None):
    """One pod against the node-sharded cluster: K4 over the whole node
    axis (in the reference the same _fit_and_score_jit program over sharded
    planes). Returns fit_and_score's packed outputs; over several cards
    (CardTensor inputs) each card's over its range (ops/cards.py
    cards_fit_and_score)."""
    if len(mesh.cards) > 1:
        return cards_fit_and_score(cfg, planes, tables, packed_f, layout, logtab,
                                   _card_set(mesh, ctx))
    return _k.fit_and_score(cfg, planes, tables, packed_f, layout, logtab)


def sharded_batched_assign(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                           tables: dict, packed_f: torch.Tensor, layout,
                           tie_words: torch.Tensor, logtab: torch.Tensor,
                           cursor_init=0, frame_shift: int = 0, sig_ids=None,
                           uniq_idx=None, carry_map=None, sig_table=None,
                           ctx=None) -> dict:
    """The greedy wave over the mesh's node shards: K1 + K6, decisions and
    every output equal to batched_assign's (K1 + K2). The chained-wave
    arguments (a device cursor_init, frame_shift, carry_map, sig_table) are
    batched_assign's. Over several cards (CardTensor inputs) the card level
    (ops/cards.py cards_assign), the mesh's shards per card on each."""
    if len(mesh.cards) > 1:
        return cards_assign(cfg, planes, tables, packed_f, layout, tie_words, logtab,
                            _card_set(mesh, ctx), mesh.shards_per_card,
                            cursor_init=cursor_init, sig_ids=sig_ids, uniq_idx=uniq_idx,
                            frame_shift=frame_shift, carry_map=carry_map,
                            sig_table=sig_table)
    return _k.batched_assign(
        cfg, planes, tables, packed_f, layout, tie_words, logtab, cursor_init=cursor_init,
        sig_ids=sig_ids, uniq_idx=uniq_idx, frame_shift=frame_shift, carry_map=carry_map,
        sig_table=sig_table, n_shards=mesh.nodes)


def wave_fit_and_score(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                       tables: dict, packed_f, layout, logtab, ctx=None):
    """The pods x nodes matrix (K7): every pod against the same snapshot,
    no assumes between pods. The pod batch splits over the wave axis, so
    it must divide by it. Returns (feasible [P, Nb] bool, total [P, Nb]
    int32 with -1 infeasible)."""
    n_pods = packed_f.shape[0]
    if n_pods % mesh.wave:
        raise ValueError(f"pod batch {n_pods} not divisible by wave={mesh.wave}; "
                         "pad the batch")
    if len(mesh.cards) > 1:
        # the wave axis's pod parts, each over the node axis's cards
        cards = _card_set(mesh, ctx)
        per = n_pods // mesh.wave
        parts = [cards_wave_fit_and_score(cfg, planes, tables, packed_f[g * per:(g + 1) * per],
                                          layout, logtab, cards)
                 for g in range(mesh.wave)]
        if len(parts) == 1:
            return parts[0]
        return tuple(CardTensor([torch.cat([q[i].parts[c] for q in parts])
                                 for c in range(cards.n)], 1) for i in range(2))
    return _k.wave_fit_and_score(cfg, planes, tables, packed_f, layout, logtab)


# -- execution-context seam ---------------------------------------------------


class LocalContext:
    """The whole node axis in one block: K1 + K2 and K4, byte for byte what
    the backend ran before the seam."""

    mesh = None
    n_shards = 1
    is_sharded = False

    def __init__(self, device="cuda"):
        from ..scheduler.tpu.backend import resolve_device

        self.device = resolve_device(device)

    def put(self, value, name=None):
        del name
        return _as_tensor(value, self.device)

    put_replicated = put

    def fit_and_score(self, cfg, planes, tables, packed_f, layout, logtab):
        return _k.fit_and_score(cfg, planes, tables, packed_f, layout, logtab)

    def batched_assign(self, cfg, planes, tables, packed_f, layout, tie_words, logtab,
                       cursor_init=0, frame_shift=0, sig_ids=None, uniq_idx=None,
                       carry_map=None, sig_table=None):
        return _k.batched_assign(cfg, planes, tables, packed_f, layout, tie_words,
                                 logtab, cursor_init=cursor_init, sig_ids=sig_ids,
                                 uniq_idx=uniq_idx, frame_shift=frame_shift,
                                 carry_map=carry_map, sig_table=sig_table)


class MeshContext:
    """Node-sharded execution over a scheduler_mesh: `put` checks each
    plane's node axis against the shard count, the wave runs K1 + K6 and
    the single-pod cycle K4. One backend holds one context for its life.

    On one card the base mirror, the carry and the signature table are the
    same contiguous tensors, each block of K6 owning its column range. Over
    several cards (`cards` > 1) `put` cuts a node plane's node axis into
    the cards' contiguous ranges, each its own tensor on its card, and puts
    a copy of anything else on every card (ops/cards.py CardTensor): the
    backend sees one object per plane with the global bucket size, and K6,
    K4 and K7 run at the card level. upload_bytes counts each card's
    uploads (the node planes' ranges, the copies, the routed rows)."""

    is_sharded = True

    def __init__(self, mesh: SchedulerMesh):
        self.mesh = mesh
        self.n_shards = int(mesh.shape[NODE_AXIS])
        self.device = mesh.device
        self.cards = len(mesh.cards)
        self.upload_bytes = [0] * self.cards
        self._set = None

    @property
    def card_set(self) -> CardSet:
        """The cards' peer access and exchange buffers, made at first use."""
        if self._set is None:
            self._set = CardSet(self.mesh.cards)
        return self._set

    def _count(self, c, nbytes: int) -> None:
        for k in (range(self.cards) if c is None else (c,)):
            self.upload_bytes[k] += int(nbytes)

    def put(self, value, name=None):
        if name in _NODE_DIM:
            _check_node_dim(name, tuple(np.shape(value)), self.n_shards)
        if self.cards == 1:
            return _as_tensor(value, self.device)
        dim = _NODE_DIM.get(name)
        if dim is None:
            return self.put_replicated(value, name)
        ranges = card_ranges(value.shape[dim], self.cards)
        parts = []
        for c, (lo, hi) in enumerate(ranges):
            if isinstance(value, torch.Tensor):
                t = value.narrow(dim, lo, hi - lo).to(self.mesh.cards[c], copy=True)
                t = t.contiguous()
            else:
                cut = [slice(None)] * np.ndim(value)
                cut[dim] = slice(lo, hi)
                t = _as_tensor(np.asarray(value)[tuple(cut)], self.mesh.cards[c])
            self._count(c, t.numel() * t.element_size())
            parts.append(t)
        return CardTensor(parts, dim)

    def put_replicated(self, value, name=None):
        del name
        if self.cards == 1:
            return _as_tensor(value, self.device)
        parts = [_as_tensor(value, d) for d in self.mesh.cards]
        self._count(None, parts[0].numel() * parts[0].element_size())
        return CardTensor(parts, None)

    def put_card(self, value, c: int):
        """value (a host array or tensor) on card c alone (routed rows)."""
        t = _as_tensor(value, self.mesh.cards[c])
        self._count(c, t.numel() * t.element_size())
        return t

    def ranges(self, nb: int) -> list[tuple[int, int]]:
        return card_ranges(nb, self.cards)

    def fit_and_score(self, cfg, planes, tables, packed_f, layout, logtab):
        return sharded_fit_and_score(cfg, self.mesh, planes, tables, packed_f,
                                     layout, logtab, self)

    def batched_assign(self, cfg, planes, tables, packed_f, layout, tie_words, logtab,
                       cursor_init=0, frame_shift=0, sig_ids=None, uniq_idx=None,
                       carry_map=None, sig_table=None):
        return sharded_batched_assign(cfg, self.mesh, planes, tables, packed_f, layout,
                                      tie_words, logtab, cursor_init=cursor_init,
                                      frame_shift=frame_shift, sig_ids=sig_ids,
                                      uniq_idx=uniq_idx, carry_map=carry_map,
                                      sig_table=sig_table, ctx=self)

    def check(self) -> None:
        """Raise where a card rank never arrived at a card exchange."""
        if self.cards > 1 and self._set is not None:
            self._set.check()


def context_from_env(environ=None, device="cuda"):
    """The deployment seam: KUBE_TPU_MESH_DEVICES=N asks for N node shards.
    Unset, empty, not an integer, or N <= 1 gives LocalContext, as in the
    reference; else a MeshContext of N shards spread over the visible cards
    by scheduler_mesh's rule (C = min(N, cards) cards, N / C shards each,
    a cluster size). A count the cards and their clusters cannot hold
    raises (the reference falls back to LocalContext past its visible
    devices; see the module docstring). Two ranks on one card are never
    chosen here."""
    env = environ if environ is not None else os.environ
    raw = env.get("KUBE_TPU_MESH_DEVICES", "").strip()
    if not raw:
        return LocalContext(device)
    try:
        n = int(raw)
    except ValueError:
        return LocalContext(device)
    if n <= 1:
        return LocalContext(device)
    try:
        mesh = scheduler_mesh(n, device=device)
    except ValueError as e:
        raise ValueError(f"KUBE_TPU_MESH_DEVICES={n}: {e}") from None
    return MeshContext(mesh)
