"""Node sharding on one card, and the execution-context seam (the
reference's kubernetes_tpu/parallel/mesh.py).

The reference shards the node axis of every plane over a jax Mesh of
(wave, nodes) devices: the greedy wave scan becomes an explicit shard_map
whose only cross-shard traffic is the scalar and segment collectives of
AxisComm (_sharded_assign_jit), and the pods x nodes matrix a vmap over the
wave axis (_wave_fit_and_score_jit). On one H100 a node shard is one block
of a thread-block cluster: `scheduler_mesh(n)` describes n // wave node
shards, which must be a cluster size (1, 2, 4 or 8). A shard past one
block's 16384 node slots takes m blocks of the same cluster, n * m from the
launch plan (ops/kernels.py scan_plan): MeshContext(2) over 50000 nodes
runs 4 blocks. The planes stay one contiguous tensor each; block r of K6's
cluster of c blocks owns the node range [r*Nb/c, (r+1)*Nb/c) of every plane
and of the signature table's columns, and the collectives are exchanges
through distributed shared memory. The decisions equal the unsharded
scan's bit for bit whatever the block count, as the reference's do.

The backend holds one context for its life and routes every plane upload
and kernel entry through it: LocalContext runs K1 + K2 and K4 as before the
seam, MeshContext runs K1 + K6 and K4. KUBE_TPU_MESH_DEVICES selects it
(context_from_env). Deviation from the reference: a count of node shards
this card cannot hold (anything but 1, 2, 4 or 8) raises, where the
reference falls back to LocalContext whenever the count exceeds the visible
devices; a silent fallback would hide that K6 is not running.

The multi-card layer (several cards, torch.distributed) is not here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import kernels as _k
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
    """(wave, nodes) axes on one card: `nodes` node shards (blocks of one
    cluster in K6) and `wave` parts of a pod batch (K7's blocks)."""

    wave: int
    nodes: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {WAVE_AXIS: self.wave, NODE_AXIS: self.nodes}


def scheduler_mesh(n_devices: int | None = None, wave: int = 1,
                   device="cuda") -> SchedulerMesh:
    """A (wave, nodes) mesh of n_devices shards (default 8, the largest
    portable cluster): n_devices // wave node shards. Raises ValueError
    when wave does not divide n_devices, or when the node-shard count is
    not a cluster size (1, 2, 4 or 8)."""
    from ..scheduler.tpu.backend import resolve_device

    dev = resolve_device(device)
    n = max(CLUSTER_SHARDS) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError("no devices for mesh")
    if n % wave:
        raise ValueError(f"wave={wave} does not divide device count {n}")
    if n // wave not in CLUSTER_SHARDS:
        raise ValueError(
            f"{n // wave} node shards: on one card a node shard is one block "
            "of a thread-block cluster, and a cluster holds 1, 2, 4 or 8 "
            "blocks (the portable limit)")
    return SchedulerMesh(wave, n // wave, dev)


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
    range that one block of K6 owns."""
    out = {}
    for k, a in planes_dict.items():
        _check_node_dim(k, tuple(a.shape), mesh.nodes)
        out[k] = _as_tensor(a, mesh.device)
    return out


def replicate(mesh: SchedulerMesh, tree):
    """Pod features, tie words and other small inputs on the mesh's card (a
    dict of arrays, or one array)."""
    if isinstance(tree, dict):
        return {k: _as_tensor(v, mesh.device) for k, v in tree.items()}
    return _as_tensor(tree, mesh.device)


# -- sharded kernel entry points ---------------------------------------------


def sharded_fit_and_score(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                          tables: dict, packed_f: torch.Tensor, layout,
                          logtab: torch.Tensor) -> torch.Tensor:
    """One pod against the node-sharded cluster: K4 over the whole node
    axis (in the reference the same _fit_and_score_jit program over sharded
    planes). Returns fit_and_score's packed outputs."""
    del mesh  # K4 already cuts the node axis over its cluster's blocks
    return _k.fit_and_score(cfg, planes, tables, packed_f, layout, logtab)


def sharded_batched_assign(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                           tables: dict, packed_f: torch.Tensor, layout,
                           tie_words: torch.Tensor, logtab: torch.Tensor,
                           cursor_init=0, frame_shift: int = 0, sig_ids=None,
                           uniq_idx=None, carry_map=None, sig_table=None) -> dict:
    """The greedy wave over the mesh's node shards: K1 + K6, decisions and
    every output equal to batched_assign's (K1 + K2). The chained-wave
    arguments (a device cursor_init, frame_shift, carry_map, sig_table) are
    batched_assign's."""
    return _k.batched_assign(
        cfg, planes, tables, packed_f, layout, tie_words, logtab, cursor_init=cursor_init,
        sig_ids=sig_ids, uniq_idx=uniq_idx, frame_shift=frame_shift, carry_map=carry_map,
        sig_table=sig_table, n_shards=mesh.nodes)


def wave_fit_and_score(cfg: KernelConfig, mesh: SchedulerMesh, planes: dict,
                       tables: dict, packed_f: torch.Tensor, layout,
                       logtab: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pods x nodes matrix (K7): every pod against the same snapshot,
    no assumes between pods. The pod batch splits over the wave axis, so
    it must divide by it. Returns (feasible [P, Nb] bool, total [P, Nb]
    int32 with -1 infeasible)."""
    n_pods = packed_f.shape[0]
    if n_pods % mesh.wave:
        raise ValueError(f"pod batch {n_pods} not divisible by wave={mesh.wave}; "
                         "pad the batch")
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
    the single-pod cycle K4. One backend holds one context for its life;
    the base mirror, the carry and the signature table are the same
    contiguous tensors, each block of K6 owning its column range."""

    is_sharded = True

    def __init__(self, mesh: SchedulerMesh):
        self.mesh = mesh
        self.n_shards = int(mesh.shape[NODE_AXIS])
        self.device = mesh.device

    def put(self, value, name=None):
        if name in _NODE_DIM:
            _check_node_dim(name, tuple(np.shape(value)), self.n_shards)
        return _as_tensor(value, self.device)

    def put_replicated(self, value, name=None):
        del name
        return _as_tensor(value, self.device)

    def fit_and_score(self, cfg, planes, tables, packed_f, layout, logtab):
        return sharded_fit_and_score(cfg, self.mesh, planes, tables, packed_f,
                                     layout, logtab)

    def batched_assign(self, cfg, planes, tables, packed_f, layout, tie_words, logtab,
                       cursor_init=0, frame_shift=0, sig_ids=None, uniq_idx=None,
                       carry_map=None, sig_table=None):
        return sharded_batched_assign(cfg, self.mesh, planes, tables, packed_f, layout,
                                      tie_words, logtab, cursor_init=cursor_init,
                                      frame_shift=frame_shift, sig_ids=sig_ids,
                                      uniq_idx=uniq_idx, carry_map=carry_map,
                                      sig_table=sig_table)


def context_from_env(environ=None, device="cuda"):
    """The deployment seam: KUBE_TPU_MESH_DEVICES=N asks for N node shards.
    Unset, empty, not an integer, or N <= 1 gives LocalContext, as in the
    reference; N = 2, 4 or 8 a MeshContext on the one card. Any other N
    raises (the reference falls back to LocalContext past its visible
    devices; see the module docstring)."""
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
    if n not in CLUSTER_SHARDS:
        raise ValueError(
            f"KUBE_TPU_MESH_DEVICES={n}: on one card a node shard is one block "
            "of a thread-block cluster, and a cluster holds 1, 2, 4 or 8 "
            "blocks")
    return MeshContext(scheduler_mesh(n, device=device))
