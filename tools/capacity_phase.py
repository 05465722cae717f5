"""chip_smoke.py's phase 31 alone (any number of scored resources, shape
points and topology keys, on the card), after building the kernels.

    python3 tools/capacity_phase.py                # phase 31 as chip_smoke runs it
    python3 tools/capacity_phase.py --full-depth   # its comparisons uncut

A short call after a change to the launch tables or the matched key mask:
it builds every library (`cuda.build_all`, printing ptxas's registers,
spills and shared memory of the scan and fit instances) and runs
`chip_smoke.capacity_phase` without phases 1-30: (a) testing/capacity.py's
fleet at 5000 nodes under each configuration of CAP_CONFIGS (ten scored
resources under LeastAllocated and a 21-point RequestedToCapacityRatio
shape, 20 keys, 40 keys), K1, K2 (both tiers, seeded and chained), K4,
K5, K6 and K7 against their plain versions, the K 32 configuration on the
GTAB instances too, K2 and K4 timed; (b) the Scheduler over the K 32 fleet
with warm start, and the card against the CPU. Phase 20's step times are
not measured in this call, so (c) prints the wide configurations' alone.
chip_smoke cuts the comparisons in depth (CAP_CMP_PODS, CAP_GANG,
CAP_K7_PODS, CAP_CPU_PODS); `--full-depth` holds the kernels on waves of
512 pods, gangs of 32 and 64 K7 pods, and the card against the CPU on
512 pods (~6 min of command on an H100).

The sizes are chip_smoke's module constants (CAP_*); for a shorter call
set them before `main()`, e.g. `python3 -c "import sys; sys.path[:0] =
['.', 'tools']; import chip_smoke as c; c.CAP_NODES = 1000;
c.CAP_LOOP_PODS = 512; c.CAP_CPU_PODS = 128; import capacity_phase;
sys.argv = ['capacity_phase']; capacity_phase.main()"`.
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
                    help="hold the kernels on chip_smoke's uncut depths")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    if own.full_depth:
        chip_smoke.CAP_CMP_PODS, chip_smoke.CAP_GANG = 512, 32
        chip_smoke.CAP_K7_PODS, chip_smoke.CAP_CPU_PODS = 64, 512
    args = chip_smoke.build_parser().parse_args([])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    reports = cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(reports)} libraries")
    entries = chip_smoke.ptxas_entries(reports, ("assign_scan_kernel", "gang_assign_kernel",
                                                 "sharded_assign_kernel", "fit_and_score_kernel"))
    for name, e in sorted(entries.items()):
        print(f"ptxas {name}: {e.get('registers')} registers, {e.get('spill_stores')}/"
              f"{e.get('spill_loads')} bytes spill stores/loads, {e.get('smem')} bytes smem")
    from kubernetes_tpu_torch.ops import kernels

    print(f"scan_limits: {kernels.scan_limits('cuda')}")
    chip_smoke.capacity_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
