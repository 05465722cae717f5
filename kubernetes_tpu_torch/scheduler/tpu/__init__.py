"""The device scheduling backend (PyTorch + hand-written CUDA kernels)."""
