"""chip_smoke.py's phase 27 alone (the restart path on the card), at its
full sizes, after building the kernels.

    python3 tools/restart_phase.py                # as chip_smoke runs it
    python3 tools/restart_phase.py --full-depth   # (a)'s five children

A short call after a change to the restart path: it builds the six
libraries (`cuda.build_all`) and runs `chip_smoke.restart_phase` — cold
and warm starts each in a fresh process, a crash at `loop.wave` and a
warm restart, the crashes a Scheduler reconciles on itself (card == CPU at
the small size), and the two-member fleet's failover — without phases
1-26. The sizes are chip_smoke's own defaults. chip_smoke runs (a)'s
cold, warm and late-backlog children (RESTART_CHILDREN) for its time
limit; `--full-depth` runs all five (cold, warm, warm, cold, late).
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

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full-depth", action="store_true",
                    help="run 27 (a)'s five children (cold, warm, warm, cold, late)")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    if own.full_depth:
        chip_smoke.RESTART_CHILDREN = chip_smoke.RESTART_CHILDREN_FULL
    args = chip_smoke.build_parser().parse_args([])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    chip_smoke.restart_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
