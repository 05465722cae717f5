"""Dense kernel layer of the port: vocabularies, tensor planes, and the wave
path's kernels (plain PyTorch versions and hand-written CUDA kernels).

Importing this package builds nothing and touches no device; the CUDA
libraries are compiled at first launch (ops/cuda.py).
"""

from .vocab import ClusterVocabs, Vocab, next_pow2
from .planes import (
    DeviceFlakeError,
    FallbackNeeded,
    Planes,
    PlaneBuilder,
    PodFeatureExtractor,
    features_from_reference,
    pack_features,
    pad_features,
    planes_from_reference,
    stack_features,
    unpack_features,
)
from .kernels import KernelConfig, OutOfSlice, batched_assign

__all__ = [
    "ClusterVocabs", "Vocab", "next_pow2", "DeviceFlakeError", "FallbackNeeded", "Planes",
    "PlaneBuilder", "PodFeatureExtractor", "features_from_reference",
    "pack_features", "pad_features", "planes_from_reference",
    "stack_features", "unpack_features", "KernelConfig", "OutOfSlice",
    "batched_assign",
]
