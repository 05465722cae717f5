"""chip_smoke.py's phase 28 alone (the entry point and the chaos rungs on
the card), at its full sizes, after building the kernels.

    python3 tools/entrypoint_phase.py              # phase 28
    python3 tools/entrypoint_phase.py --full-depth # phase 25 (a)-(d) uncut

A short call after a change to the entry point or the soaks: it builds the
six libraries (`cuda.build_all`) and runs `chip_smoke.entrypoint_phase` —
SchedulerServer from a configuration file over SchedulingBasic's cluster
against a plain Scheduler, its mux, the CacheDebugger, the server's CLI in
a child process, and the four seeded soaks — without phases 1-27. The
sizes are chip_smoke's own defaults.

`--full-depth` runs chip_smoke's phase 25 (a)-(d) instead, with 25 (b)
(SchedulingCSIPVs/5000Nodes_5000Pods, 5000 + 5000 pods) and (c)
(SchedulingWithResourceClaims/5000pods_500nodes) at the depth chip_smoke
cuts to stay inside its time limit. Phase 24 (a)'s full depth:
`python3 tools/preemption_scaling.py --pods 5000`.
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
                    help="run phase 25 (a)-(d) at the workloads' full depth instead")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    args = chip_smoke.build_parser().parse_args([])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    if own.full_depth:
        chip_smoke.storage_full_width(args, smi, full_depth=True)
    else:
        chip_smoke.entrypoint_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
