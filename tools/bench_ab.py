"""A/B of the benchmark's cells against another checkout, on one CUDA card.

    python3 tools/bench_ab.py --parent _parent --rounds 5
    python3 tools/bench_ab.py --parent _parent --rounds 4 \
        --cells SchedulingNodeDeclaredFeatures_1000Nodes \
        --variants parent,change,change_off

Each round runs every cell once per variant through `python3 -m
kubernetes_tpu_torch.perf.bench --cell NAME --seed S`, one process each,
the variants' order rotating by one from round to round (with two
variants: alternating). Variants: `parent`, the bench of the checkout at
--parent (a `git archive` of the commit to compare with, unpacked into a
directory of this checkout that .gitignore lists); `change`, this
checkout's; `change_off`, this checkout's with the wave recorder's pod
latency ledger, stall profiler and device telemetry disabled (the
telemetry's `enabled` attributes). Every run's line — pods/s, `correct`,
the loop's host microseconds per pod by stage, the K4 path's phases, the
dispatcher's — is appended to --out (a file of JSON lines) and
summarised on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELLS = ("SchedulingBasic_5000Nodes_10000Pods", "SchedulingNodeDeclaredFeatures_1000Nodes")
TELEMETRY_OFF = (
    "import kubernetes_tpu_torch.scheduler.tpu.waverecorder as w\n"
    "init = w.WaveRecorder.__init__\n"
    "def patched(self, *a, **k):\n"
    "    init(self, *a, **k)\n"
    "    for part in ('pod_ledger', 'stall_profiler', 'device_telemetry'):\n"
    "        getattr(self, part).enabled = False\n"
    "w.WaveRecorder.__init__ = patched\n")


def bench_code(cell: str, seed: int) -> str:
    return ("import sys\nfrom kubernetes_tpu_torch.perf import bench\n"
            f"sys.exit(bench.main(['--cell', {cell!r}, '--seed', '{seed}']))\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--variants", default="parent,change")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="bench_ab.jsonl", help="JSON lines, appended")
    args = ap.parse_args()
    roots = {"parent": Path(args.parent).resolve(), "change": ROOT, "change_off": ROOT}
    variants = args.variants.split(",")
    env = {k: v for k, v in os.environ.items() if not k.startswith("KUBE_TPU_")}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with open(args.out, "a") as out:
        for i in range(args.rounds):
            order = variants[i % len(variants):] + variants[:i % len(variants)]
            for cell in args.cells.split(","):
                for v in order:
                    code = (TELEMETRY_OFF if v == "change_off" else "") + bench_code(cell, args.seed)
                    t = time.time()
                    r = subprocess.run([sys.executable, "-c", code], cwd=roots[v], env=env,
                                       capture_output=True, text=True, timeout=900)
                    if r.returncode != 0:
                        print(f"{v} {cell}: exit {r.returncode}\n{(r.stdout + r.stderr)[-2000:]}")
                        return 1
                    line = json.loads(r.stdout.strip().splitlines()[-1])
                    rec = {"round": i, "variant": v, "cell": cell,
                           "wall_s": round(time.time() - t, 1),
                           "pods_per_s": line["pods_per_s"], "correct": line["correct"],
                           "host_us_per_pod": line["host_us_per_pod"],
                           "run_us_per_pod": line["run_us_per_pod"],
                           "dispatcher_exec_us_per_pod": line["dispatcher_exec_us_per_pod"],
                           "device": line["device"], "power_limit": line["power_limit"]}
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
                    stages = ", ".join(f"{k} {v_:.1f}" for k, v_ in line["host_us_per_pod"].items())
                    print(f"round {i} {v:10} {cell[:28]:28} {line['pods_per_s']:.2f} pods/s "
                          f"correct {line['correct']} ({rec['wall_s']} s); host us per pod: "
                          f"{stages}", flush=True)
    print(f"bench_ab: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
