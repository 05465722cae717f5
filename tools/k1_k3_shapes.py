"""K1's block shapes and the K3 wrapper's host time, on one CUDA card.

    python3 tools/k1_k3_shapes.py                        # both, this checkout
    python3 tools/k1_k3_shapes.py --package DIR --host-only

K1 (static_parts): at the shapes the paths run it — the signature rows of
a SchedulingBasic wave, 128 and 512 of its pods on 5000 nodes (an
8192-row bucket), 4 pods on 500 nodes (a 512-row bucket) — every block
shape (warps per block x output rows per warp) is launched through the
wrapper with kernels.K1_WARPS, K1_RPW and K1_TARGET_BLOCKS set for it,
held equal to the default plan's outputs and timed by torch.profiler.

K3 (scatter_rows): the host's microseconds per wrapper call on one dirty
row of the 15 mirrored planes of a 5000-node SchedulingBasic cluster (the
single-pod path's shape, the row staged as the backend stages it), over
2000 calls back to back, best of 5. With --package DIR the package is
imported from the checkout at DIR (an older commit, for a comparison in
one call); --host-only skips K1. Only the scatter_rows library is built.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def cluster(n_nodes, zones=8):
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node

    names = ResourceNames()
    cache = Cache(names)
    for i in range(n_nodes):
        cache.add_node(scheduling_basic_node(i, zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    return TorchBackend(names, device="cuda"), snap


def k3_host_us(reps=2000, rounds=5):
    """Host microseconds per scatter_rows call on one staged row."""
    from kubernetes_tpu_torch.ops import kernels

    backend, snap = cluster(5000)
    planes = backend.sync(snap)
    backend.device_inputs(planes)
    idx = np.array([1234], np.int32)
    rows = backend._upload_rows(planes.as_dict(), idx)
    idx_dev = backend._pinned_copy(idx)
    dst = backend._device_planes
    kernels.scatter_rows(dst, rows, idx_dev)
    torch.cuda.synchronize()
    best = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(reps):
            kernels.scatter_rows(dst, rows, idx_dev)
        best.append((time.perf_counter() - t) / reps * 1e6)
        torch.cuda.synchronize()
    return sorted(best)


def k1_sweep(label, dp, dt, packed_f, layout, rows=None, warps=(1, 2, 4, 8, 16),
             per_warp=(1, 2, 4, 8)):
    """Each (warps, rows per warp) shape equal to the default plan's
    outputs and timed; returns the line."""
    import chip_smoke
    from kubernetes_tpu_torch.ops import kernels

    base = kernels.static_parts(dp, dt, packed_f, layout, rows=rows)
    n_out, nb = base["static_ok"].shape
    default = kernels.static_plan(n_out, nb, dp["taints"].shape[1],
                                  dp["prefer_taints"].shape[1], dp["port_words"].shape[1],
                                  dp["image_kib"].shape[1], *dt["aff_match"].shape)
    saved = kernels.K1_WARPS, kernels.K1_RPW, kernels.K1_TARGET_BLOCKS
    cells = []
    try:
        for w in warps:
            for r in per_warp:
                if w > n_out or (r > 1 and w * r > n_out):
                    continue
                kernels.K1_WARPS, kernels.K1_RPW, kernels.K1_TARGET_BLOCKS = w, r, 1
                got = kernels.static_parts(dp, dt, packed_f, layout, rows=rows)
                torch.cuda.synchronize()
                for k in base:
                    if not torch.equal(got[k], base[k]):
                        raise SystemExit(f"static_parts.{k} at {w} warps x {r} rows differs "
                                         f"({label})")
                ms = chip_smoke.kernel_ms(
                    lambda: kernels.static_parts(dp, dt, packed_f, layout, rows=rows),
                    "static_parts_kernel", 10)
                cells.append(f"{w}x{r} {ms:.5f}")
    finally:
        kernels.K1_WARPS, kernels.K1_RPW, kernels.K1_TARGET_BLOCKS = saved
    w = default.threads // 32
    return (f"static_parts block shapes at {label} ({n_out} x {nb}; warps x rows per warp, "
            f"ms; all equal): " + ", ".join(cells)
            + f"; the default plan: {w}x{-(-default.chunk // w)}")


def k1_shapes():
    import chip_smoke
    from kubernetes_tpu_torch.ops import cuda
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_pod

    cuda.build_all()
    backend, snap = cluster(5000)
    w = chip_smoke.wave_inputs(backend, [scheduling_basic_pod(i) for i in range(512)], snap, 512)
    packed128 = w.packed_f[:128].contiguous()
    print(k1_sweep(f"{len(w.uniq)} signature rows", w.dp, w.dt, w.packed_f, w.layout,
                   rows=w.uniq))
    print(k1_sweep("128 pods", w.dp, w.dt, packed128, w.layout))
    print(k1_sweep("512 pods", w.dp, w.dt, w.packed_f, w.layout))
    backend, snap = cluster(500)
    g = chip_smoke.wave_inputs(backend, [scheduling_basic_pod(i) for i in range(4)], snap, 4)
    print(k1_sweep("4 pods on 500 nodes", g.dp, g.dt, g.packed_f, g.layout,
                   warps=(1, 2, 4), per_warp=(1, 2, 4)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", type=Path, default=ROOT,
                    help="the checkout whose kubernetes_tpu_torch is measured")
    ap.add_argument("--host-only", action="store_true", help="time K3's wrapper only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this measurement needs a CUDA card")
    sys.path[:0] = [str(args.package.resolve()), str(ROOT)]
    from kubernetes_tpu_torch.ops import cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; package {args.package}")
    if not args.host_only:
        k1_shapes()
    cuda.SOURCES = {k: v for k, v in cuda.SOURCES.items() if k == "scatter_rows"}
    us = k3_host_us()
    print(f"scatter_rows host us per call on one row, 15 planes, 5000 nodes (5 rounds of "
          f"2000, sorted): {', '.join(f'{u:.2f}' for u in us)}")


if __name__ == "__main__":
    main()
