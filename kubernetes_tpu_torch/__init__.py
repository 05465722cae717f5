"""kubernetes_tpu_torch: the scheduler's device half in PyTorch and CUDA.

A port of kubernetes_tpu (JAX on a TPU, kept beside it as the reference) to
PyTorch with hand-written CUDA kernels for an NVIDIA H100. It imports
nothing of the reference package and never imports jax. Entry points run on
the CUDA device unless the caller passes device="cpu", which runs the
kernels' plain PyTorch versions.
"""
