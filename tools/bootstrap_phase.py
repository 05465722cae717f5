"""chip_smoke.py's phase 34 alone (kubeadm init: the bootstrapped cluster
on the card), after building the kernels.

    python3 tools/bootstrap_phase.py                 # phase 34 at chip_smoke's depth
    python3 tools/bootstrap_phase.py --full-depth    # (a) with 1024 replicas

It builds the CUDA libraries (`cuda.build_all`) and runs
`chip_smoke.bootstrap_phase`: (a) `ClusterBootstrap(nodes=5000,
device="cuda").init()` (the API server, the Scheduler with bootstrap's
`Profile(backend="tpu", wave_size=256)`, the controller manager, a hollow
kubelet and a proxy per node), a ClusterIP Service and a Deployment
through the admin client, `converge()` until every pod runs, held
against an in-process twin; (b) `python -m
kubernetes_tpu_torch.cmd.bootstrap --nodes 3 --port 0` and `python -m
kubernetes_tpu_torch.cmd.controller_manager --leader-elect` in child
processes. The nodes are always 5000; chip_smoke cuts (a)'s replicas to
BOOT_PODS for its time limit, `--full-depth` runs 1024 (four waves of
256).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BOOT_FULL_TIMEOUT = 2400.0


def main() -> int:
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.ops import cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full-depth", action="store_true",
                    help="run (a) with a Deployment of 1024 replicas")
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
    pods = chip_smoke.BOOT_FULL_PODS if own.full_depth else None
    # a kubelet round lists every pod on every node: at 1024 replicas a
    # round takes minutes, past chip_smoke's --phase-timeout
    limit = BOOT_FULL_TIMEOUT if own.full_depth else args.phase_timeout
    with chip_smoke.watchdog("phase 34 (kubeadm init)", limit):
        chip_smoke.bootstrap_phase(args, smi, n_pods=pods)
    print(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
