"""chip_smoke.py's phase 30 alone (topology keys of more than 1024
domains, on the card), after building the kernels.

    python3 tools/domains_phase.py                # phase 30 as chip_smoke runs it
    python3 tools/domains_phase.py --full-depth   # (c) timed at 512, gangs of 128,
                                                  # (d) 5000 and (e) 1024 pods

A short call after a change to the domain tables: it builds every library
(`cuda.build_all`, printing ptxas's registers, spills and shared memory of
the scan and fit instances, the GTAB ones among them) and runs
`chip_smoke.domains_phase` without phases 1-29: (a) 5000 nodes in 1250
racks on one block, (b) 50000 nodes in 1250 racks on a cluster of blocks,
(c) 100000 nodes in 5556 racks, each kernel on its plan and on the GTAB
instance against its plain version; (d) the Scheduler over 50000 rack
nodes on LocalContext and MeshContext(8); (e) the card against the CPU.

The sizes are chip_smoke's module constants (RACK_*); for a shorter call
set them before `main()`, e.g. `python3 -c "import sys; sys.path[:0] =
['.', 'tools']; import chip_smoke as c; c.RACK_B = (20000, 16);
c.RACK_C = (20000, 3); c.RACK_LOOP_PODS = 1000; import domains_phase;
domains_phase.main()"`.
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
                    help="time (c)'s K2 and K5, which chip_smoke leaves untimed, "
                         "on gangs of 128 (RACK_BIG_GANG, 32 in chip_smoke), with (c)'s "
                         "waves of 512, (d)'s 5000 and (e)'s 1024 pods (128, 2500 and "
                         "512 in chip_smoke)")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    chip_smoke.RACK_TIME_C = own.full_depth
    if own.full_depth:
        chip_smoke.RACK_BIG_GANG = 128
        chip_smoke.RACK_LOOP_PODS = 5000
        chip_smoke.RACK_CPU_PODS = 1024
        chip_smoke.RACK_C_WAVE = 512
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
    chip_smoke.domains_phase(args, smi)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
