"""The kernels' build and the step times of configurations within the
parameter block's caps, for this checkout or another, and an A/B of two
checkouts in one call (one card).

    python3 tools/step_ab.py                       # this checkout
    python3 tools/step_ab.py --package DIR         # the checkout at DIR
    python3 tools/step_ab.py --ab DIR --out FILE   # DIR, this, this, DIR

Each run builds its checkout's kernel libraries (every nvcc at once, as
`ops/cuda.build_all` does, each library's seconds kept) and times, at
chip_smoke's full sizes on 5000 SchedulingBasic nodes: K2 (dedup on) per
step on a wave of 512 SchedulingBasic pods, on a wave of 512
TopologySpreading pods (hard zone spread) and on phase 8's IPA wave (the
mixed cluster with its existing (anti)affinity pods); K4 per pod at 16
blocks on a TopologySpreading pod (phase 9's (a)). These are phase 20's
step times and K4 (a): the launches of every configuration the kernels'
parameter block held before the launch tables. `--ab` runs the two
checkouts in turn, each in a process of its own (DIR's kubernetes_tpu_torch
and chip_smoke.py, e.g. a parent unpacked by `git archive` into
`chip_ab/parent`), and prints each run's JSON line and the change's ratio
to DIR on each time.
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
KEYS = ("build_s", "sb_us", "ts_us", "ipa_us", "k4_us")


def build(cuda) -> tuple[dict, dict]:
    """Every missing library of `cuda` (the checkout's ops/cuda.py) built at
    once: ({library: seconds until its process was reaped}, with the wall
    seconds under "all"; {library: ptxas report})."""
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out, logs, t0 = {}, {}, {}, time.perf_counter()
    for name, src in cuda.SOURCES.items():
        lib = cuda._lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, *cuda.DEFINES.get(name, ()), "-o", str(tmp),
               str(cuda.CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        os.replace(tmp, lib)
        logs[name] = log
    out["all"] = time.perf_counter() - t0
    return out, logs


def measure(package: Path) -> dict:
    sys.path.insert(0, str(package))
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import cuda, kernels
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import (
        scheduling_basic_node, scheduling_basic_pod, topology_spreading_pod)

    if Path(cuda.__file__).resolve().parents[2] != package.resolve():
        raise SystemExit(f"imported {cuda.__file__}, not {package}'s")
    args = cs.build_parser().parse_args([])
    libs, logs = build(cuda)
    ptx = cs.ptxas_entries(logs, ("assign_scan_kernel", "fit_and_score_kernel"))

    def k2_step(w, seed):
        k1 = cs.k1_call(w, True)
        words = cs.tie_words(seed, args.wave)
        ms = cs.kernel_ms(lambda: cs.k2_call(w, k1, words, True), "assign_scan_kernel", 5)
        return ms * 1e3 / w.packed_f.shape[0]

    def cluster():
        cache = Cache(ResourceNames())
        for i in range(args.nodes):
            cache.add_node(scheduling_basic_node(i, args.zones))
        snap = Snapshot()
        cache.update_snapshot(snap)
        return snap, TorchBackend(cache.names, device="cuda")

    snap, backend = cluster()
    sb = k2_step(cs.wave_inputs(backend, [scheduling_basic_pod(i) for i in range(args.wave)],
                                snap, args.wave), args.seed)
    snap, backend = cluster()
    ts_pods = [topology_spreading_pod(i) for i in range(args.wave)]
    ts = k2_step(cs.wave_inputs(backend, ts_pods, snap, args.wave), args.seed + 2)
    cfg, _planes, dp, dt, packed_f, layout = cs._k4_case(backend, ts_pods[:1], snap)
    one = packed_f[:1].contiguous()
    k4 = 1e3 * cs.kernel_ms(lambda: kernels.fit_and_score(cfg, dp, dt, one, layout,
                                                          backend._logtab, cluster=16),
                            "fit_and_score_kernel", 50)
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import ipa_pods

    backend, snap, _spec, rest = cs.ipa_cluster(args)
    half = args.wave // 2
    wave = [p for pair in zip(ipa_pods(half, types, meta), rest[64: 64 + half]) for p in pair]
    ipa = k2_step(cs.wave_inputs(backend, wave, snap, args.wave), args.seed + 3)
    torch.cuda.synchronize()
    return {"package": str(package), "build_s": libs.get("all", 0.0),
            "libs_s": {k: round(v, 1) for k, v in libs.items() if k != "all"},
            "spills": {k: f"{e.get('registers')} regs, {e.get('spill_stores')}/"
                          f"{e.get('spill_loads')} spill bytes" for k, e in sorted(ptx.items())},
            "sb_us": sb, "ts_us": ts, "ipa_us": ipa, "k4_us": k4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", type=Path, default=ROOT, help="the checkout to time")
    ap.add_argument("--ab", type=Path, help="a checkout to time against this one in turns")
    ap.add_argument("--out", type=Path, help="where --ab writes its JSON lines")
    own = ap.parse_args()
    if own.ab is None:
        print(json.dumps(measure(own.package)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    runs = []
    for pkg in (own.ab, ROOT, ROOT, own.ab):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--package",
                            str(pkg)], capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"the run of {pkg} failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append(line)
        print(json.dumps(line), flush=True)
    if own.out is not None:
        own.out.parent.mkdir(parents=True, exist_ok=True)
        own.out.write_text("".join(json.dumps(r) + "\n" for r in runs))
    base, change = (runs[0], runs[3]), (runs[1], runs[2])
    for k in KEYS:
        if k == "build_s":  # the first run of each side builds
            b, c = base[0][k], change[0][k]
        else:
            b, c = sum(r[k] for r in base) / 2, sum(r[k] for r in change) / 2
        print(f"{k}: {own.ab.name} {b:.2f}, this checkout {c:.2f}, ratio {c / b:.4f} on {smi}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
