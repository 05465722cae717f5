"""chip_smoke.py's phase 29 alone (the wave and gang scans past one block's
16384 node slots, on the card), after building the kernels.

    python3 tools/scale_phase.py                 # phase 29 at chip_smoke's sizes
    python3 tools/scale_phase.py --full-depth    # phase 29 uncut
    python3 tools/scale_phase.py --cap           # 29 (e) alone: the cap and the passes

A short call after a change to the scan's launch plan or its cluster
instances: it builds the libraries (`cuda.build_all`, printing ptxas's
registers, spills and shared memory of the scan instances) and runs
`chip_smoke.scale_phase` without phases 1-28: the plan's cap and the pass
instance past it at 524288 and 1048576 node slots (e), the scale-out
sweep over LocalContext and MeshContext(8) (b), the gangs (c),
SchedulingBasic at 50000 nodes through the harness (a) and the card
against the CPU (d); with --cap (e) alone (`chip_smoke.scale_cap`). Phase
22 (a)'s 5000-node rate, which chip_smoke prints beside (a)'s, is not run
here.

The sizes are chip_smoke's module constants (SCALE_*). `--full-depth`
runs the phase uncut, where chip_smoke cuts it to stay inside its time
limit: gang.json's 100 PodGroups in (c) (SCALE_GANG_GROUPS, 20 in
chip_smoke), (d)'s bursts of 64 pods (SCALE_BURST, 32), (b)'s 4 bursts
a sweep point (SCALE_BURSTS, 3), (a)'s 10000 measured pods (SCALE_PODS,
2500) and (e)'s timed waves of 512 pods (SCALE_PASS_WAVE, 128).
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
                    help="run (a)-(e) uncut: (c)'s 100 PodGroups, (d)'s bursts of 64, "
                         "(b)'s 4 bursts, (a)'s 10000 pods, (e)'s waves of 512")
    ap.add_argument("--cap", action="store_true",
                    help="run (e) alone: the plan's cap and the passes past it")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    args = chip_smoke.build_parser().parse_args([])
    if own.full_depth:
        chip_smoke.SCALE_GANG_GROUPS = 100
        chip_smoke.SCALE_BURST = 64
        chip_smoke.SCALE_BURSTS = 4
        chip_smoke.SCALE_PODS = 10000
        chip_smoke.SCALE_PASS_WAVE = 512
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sys.stdout.reconfigure(line_buffering=True)
    t0 = time.perf_counter()
    reports = cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    entries = chip_smoke.ptxas_entries(reports, ("assign_scan_kernel", "gang_assign_kernel",
                                                 "sharded_assign_kernel"))
    for name, e in sorted(entries.items()):
        print(f"ptxas {name}: {e.get('registers')} registers, {e.get('spill_stores')}/"
              f"{e.get('spill_loads')} bytes spill stores/loads, {e.get('smem')} bytes smem")
    if own.cap:
        cap, err, waves = chip_smoke.scale_cap(args)
        print(f"29 (e): cap {cap} blocks; K2 waves past it {waves}; max |kernel - plain| {err}")
    else:
        chip_smoke.scale_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
