"""The execution-context seam and node sharding of the scan (the
reference's kubernetes_tpu/parallel): on one card a node shard is one
block of a thread-block cluster (K6), over several cards each card holds a
contiguous range of the node axis (ops/cards.py), and the pods x nodes
matrix is K7."""

from ..ops.cards import CardTensor
from .mesh import (
    NODE_AXIS,
    WAVE_AXIS,
    LocalContext,
    MeshContext,
    context_from_env,
    replicate,
    scheduler_mesh,
    shard_planes,
    sharded_batched_assign,
    sharded_fit_and_score,
    wave_fit_and_score,
)

__all__ = [
    "CardTensor", "NODE_AXIS", "WAVE_AXIS", "LocalContext", "MeshContext",
    "context_from_env", "replicate", "scheduler_mesh", "shard_planes",
    "sharded_batched_assign", "sharded_fit_and_score", "wave_fit_and_score",
]
