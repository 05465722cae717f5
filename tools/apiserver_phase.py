"""chip_smoke.py's phase 33 alone (the API server in front of the
Scheduler on the card), after building the kernels.

    python3 tools/apiserver_phase.py                 # phase 33 at chip_smoke's depth
    python3 tools/apiserver_phase.py --full-depth    # (a) with 11000 pods, (b) 128

It builds the CUDA libraries (`cuda.build_all`) and runs
`chip_smoke.apiserver_phase`: (a) the port's APIServer with the default
admission chain over a Store, the Scheduler on that Store with waves of
256, SchedulingBasic's 5000 nodes and its pods created through RESTStore,
held against an in-process twin, kubectl through the port's
cmd/kubectl.main; (b) the Scheduler over the REST client, per pod. The
nodes are always SchedulingBasic's 5000; chip_smoke cuts (a)'s pods to
API_PODS for its time limit, `--full-depth` runs SchedulingBasic's
11000 (1000 initial + 10000 measured); it cuts (b)'s pods to
API_REST_PODS (64), `--full-depth` runs 128.
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
                    help="run (a) with SchedulingBasic's 11000 pods")
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
    pods = args.init_pods + args.pods if own.full_depth else None
    if own.full_depth:
        chip_smoke.API_REST_PODS = chip_smoke.API_REST_PODS_FULL
    chip_smoke.apiserver_phase(args, smi, n_pods=pods)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
