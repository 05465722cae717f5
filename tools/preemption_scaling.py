"""DefaultPreemption's cost against the number of preemptors, on one CUDA
card.

    python3 tools/preemption_scaling.py                  # 250,500,1000
    python3 tools/preemption_scaling.py --pods 100,250 --workload PreemptionAsync/500Nodes

Runs scheduler_perf PreemptionAsync/5000Nodes_AsyncAPICallsEnabled (5000
nodes, 20000 priority-0 victims) through the port's WorkloadExecutor
(waves of 512) once per preemptor count, each in a process of its own
(chip_smoke.py's preemption_run: launches zeroed where the harness starts
collecting; DefaultPreemption's methods wrapped to count and time them),
ascending, and prints per count the measured span, preemptors/s,
PostFilter calls, candidates, evictions, K4 launches, scheduling
attempts, the dry run's and the executor's host seconds and the loop's
stopwatches. A count whose run does not end within --timeout seconds is
reported as such and ends the sweep.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def one(workload: str, pods: int, wave: int) -> dict:
    """One run in this process; returns its figures."""
    import chip_smoke

    r = chip_smoke.preemption_run(workload, "cuda", wave, pods)
    chip_smoke.check_preemption(f"{workload} with {pods} preemptors", r)
    pr = r["probe"]
    return {"preemptors": pods, "span_s": r["span_s"], "preemptors_per_s": pods / r["span_s"],
            "post_filter": pr["post_filter"], "candidates": pr["candidates"],
            "batched_nodes": pr["batched_nodes"], "per_node": pr["per_node"],
            "evictions": len(r["evicted"]), "attempts": sum(r["counts"]),
            "kernel_fallback": r["counts"], "launches": r["launches"],
            "dry_run_s": pr["post_filter_s"] - pr["executor_s"], "executor_s": pr["executor_s"],
            "loop_phases_s": r["phases"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="PreemptionAsync/5000Nodes_AsyncAPICallsEnabled")
    ap.add_argument("--pods", default="250,500,1000")
    ap.add_argument("--wave", type=int, default=512)
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--one", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.workload, args.one, args.wave)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("preemption_scaling: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    from kubernetes_tpu_torch.ops import cuda

    cuda.build_all()
    for pods in sorted(int(p) for p in args.pods.split(",")):
        try:
            out = subprocess.run([sys.executable, __file__, "--workload", args.workload,
                                  "--wave", str(args.wave), "--one", str(pods)],
                                 cwd=ROOT, capture_output=True, text=True,
                                 timeout=args.timeout)
        except subprocess.TimeoutExpired:
            print(json.dumps({"preemptors": pods, "ended": False,
                              "timeout_s": args.timeout}), flush=True)
            break
        if out.returncode != 0:
            sys.exit(f"{pods} preemptors: exit {out.returncode}: "
                     f"{(out.stdout + out.stderr)[-3000:]}")
        print(out.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
