"""chip_smoke.py's phase 26 alone (the telemetry on the card), at its
full sizes, after building the kernels.

    python3 tools/telemetry_phase.py

A short first call after a change to the telemetry: it builds the six
libraries (`cuda.build_all`) and runs `chip_smoke.telemetry_phase` —
SchedulingBasic and NDF with the telemetry on and off, the gang and
breaker runs, card == CPU — without phases 1-25.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.ops import cuda

    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    args = argparse.Namespace(nodes=5000, zones=8, init_pods=1000, pods=10000, wave=512, seed=1,
                              ndf_nodes=1000, ndf_pods=1000, gang_nodes=500, gang_groups=100,
                              loop_nodes=40, phase_timeout=420.0)
    chip_smoke.telemetry_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
