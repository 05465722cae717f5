"""chip_smoke.py's phase 32 at full depth over several cards: the mesh's
node axis cut into one contiguous range per card, K6, K4 and K7 exchanging
across cards through peer memory (kubernetes_tpu_torch/ops/cards.py).

    python3 tools/multicard_phase.py                     # four cards
    python3 tools/multicard_phase.py --ranks 2 --short   # two ranks on one card
    python3 tools/multicard_phase.py --kernels-only 2,4  # K6 (also chained) and K4 timed

On four cards: every kernel at the card level against its plain version
and one card's kernels (SchedulingBasic's 512-pod wave, TopologySpreading's
pod, K7's matrix, a rack-spread wave), the per-card launch memo, the 11000
SchedulingBasic pods through the Scheduler (bindings and rng equal to one
card's), TopologySpreading's single-pod cycle through K4 (equal to one
card's) and the reference's --nodes-sweep (5000, 25000, 50000, 100000
nodes, launch/collect bursts with churn, each card's per-burst upload flat).
With fewer cards than --ranks the ranks share cuda:0. --short cuts the
depth for a first call after a kernel edit. Appends its rows to --out
(multicard.jsonl by default).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def chained_k6(w, words, first, shards):
    """K6 at the card level on a wave chained on `first` (the same wave's
    card-level outputs: its carry planes, signature table and cursor, every
    slot resident, frame shift 5): equal to the card-level plain version
    and to one card's K1 + K2 on the joined inputs; the kernel timed beside
    one card's K2 and the card-exchange floor. Returns the numbers."""
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.ops import cards as mc
    from kubernetes_tpu_torch.ops import kernels

    cs = w.ctx.card_set
    P = w.packed_f.shape[0]
    planes = dict(w.dp, **{k: first[k] for k in ("used", "nonzero_used", "sel_counts")})
    cursor = first["packed"][P]
    cmap = w.ctx.put_replicated(torch.arange(w.uniq.shape[0], dtype=torch.int32))
    kw = dict(sig_ids=w.sig, uniq_idx=w.uniq, frame_shift=5, carry_map=cmap,
              sig_table=first["sig_table"], cursor_init=cursor)
    got = mc.cards_assign(w.cfg, planes, w.dt, w.packed_f, w.layout, words, w.logtab, cs,
                          shards, **kw)
    torch.cuda.synchronize()
    cs.check()
    n_xch = cs.card_exchanges()
    want = mc.cards_assign_ref(w.cfg, planes, w.dt, w.packed_f, w.layout, words, w.logtab,
                               cs.n, shards, **kw)
    err = chip_smoke.card_compare("sharded_assign card level (chained wave)", got, want)
    one_planes = {k: v.whole() if isinstance(v, mc.CardTensor) else v
                  for k, v in planes.items()}
    one_tables = {k: v.whole() for k, v in w.dt.items()}
    one_kw = dict(sig_ids=w.sig.parts[0], uniq_idx=w.uniq.parts[0], frame_shift=5,
                  carry_map=cmap.parts[0], cursor_init=cursor.parts[0],
                  sig_table={k: v.whole() if isinstance(v, mc.CardTensor) else v
                             for k, v in first["sig_table"].items()})
    one = kernels.batched_assign(w.cfg, one_planes, one_tables, w.packed_f.parts[0], w.layout,
                                 words.parts[0], w.logtab.parts[0], **one_kw)
    torch.cuda.synchronize()
    for k in ("packed", "used", "nonzero_used", "sel_counts", "sig_scores"):
        if not torch.equal(got[k].cpu(), one[k].cpu()):
            chip_smoke.fail(f"chained card-level wave: {k} differs from one card's K2")
    ms = chip_smoke.kernel_ms(lambda: mc.cards_assign(
        w.cfg, planes, w.dt, w.packed_f, w.layout, words, w.logtab, cs, shards, **kw),
        "sharded_assign_cards_kernel", 3)
    one_ms = chip_smoke.kernel_ms(lambda: kernels.batched_assign(
        w.cfg, one_planes, one_tables, w.packed_f.parts[0], w.layout, words.parts[0],
        w.logtab.parts[0], **one_kw), "assign_scan_kernel", 3)
    floor = chip_smoke.kernel_ms(lambda: mc.card_floor(cs, n_xch), "card_floor_kernel", 3)
    cs.check()
    print(f"K6 card level, chained 512-pod SchedulingBasic wave ({cs.n} ranks): equal to the "
          f"plain version and one card's K2; tiers {got['tiers'].parts[0].tolist()}; "
          f"{n_xch} card exchanges; {ms:.4f} ms, one card's K2 {one_ms:.4f} ms, "
          f"card-exchange floor {floor:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "one_ms": one_ms, "floor_ms": floor,
            "exchanges": n_xch}


def kernels_only(args, smi, ranks_list):
    """K6 (the SchedulingBasic wave, then a wave chained on it) and K4
    (TopologySpreading's pod) at the card level on 2 and 4 distinct cards,
    each against its plain version and one card's kernels, timed."""
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import cards as mc
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import (
        scheduling_basic_node, scheduling_basic_pod, topology_spreading_pod)

    out = {}
    for n in ranks_list:
        devices, how = chip_smoke.mc_devices(n)
        print(f"{how}: {', '.join(map(str, devices))} on {smi}")
        floor = chip_smoke.mc_floor_check(devices)
        names = ResourceNames()
        cache = Cache(names)
        for i in range(args.nodes):
            cache.add_node(scheduling_basic_node(i, args.zones))
            if i < args.init_pods:
                cache.assume_pod(scheduling_basic_pod(i), f"node-{(7 * i) % args.nodes}")
        snap = Snapshot()
        cache.update_snapshot(snap)
        backend = TorchBackend(names, device="cuda", context=chip_smoke.mc_context(devices))
        pods = [scheduling_basic_pod(10**6 + i) for i in range(args.wave)]
        w = chip_smoke.mc_wave(backend, pods, snap, args.wave)
        words = w.ctx.put_replicated(chip_smoke.tie_words(args.seed + 32, args.wave).cpu())
        shards = w.ctx.mesh.shards_per_card
        k6 = chip_smoke.mc_k6("SchedulingBasic wave", w, words, shards, time_it=True)
        first = mc.cards_assign(w.cfg, w.dp, w.dt, w.packed_f, w.layout, words, w.logtab,
                                w.ctx.card_set, shards, sig_ids=w.sig, uniq_idx=w.uniq)
        torch.cuda.synchronize()
        words2 = w.ctx.put_replicated(chip_smoke.tie_words(args.seed + 33, args.wave).cpu())
        chained = chained_k6(w, words2, first, shards)
        names4 = ResourceNames()
        cache4 = Cache(names4)
        for i in range(args.spread_nodes):
            cache4.add_node(scheduling_basic_node(i, args.zones))
            cache4.assume_pod(scheduling_basic_pod(2 * 10**6 + i), f"node-{i}")
        snap4 = Snapshot()
        cache4.update_snapshot(snap4)
        backend4 = TorchBackend(names4, device="cuda", context=chip_smoke.mc_context(devices))
        k4 = chip_smoke.mc_k4("TopologySpreading pod", backend4, [topology_spreading_pod(0)],
                              snap4, time_it=True)
        out[n] = {"how": how, "floor_1000_ms": floor, "k6": k6, "k6_chained": chained,
                  "k4": k4}
    return out


def _append(path: str, row: dict) -> None:
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a") as f:
        f.write(json.dumps(row, default=str) + "\n")


def main() -> int:
    import torch

    import chip_smoke
    from kubernetes_tpu_torch.ops import cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--short", action="store_true",
                    help="600-node clusters, 256 Scheduler pods, no sweep")
    ap.add_argument("--sweep", default="5000,25000,50000,100000")
    ap.add_argument("--single-pods", type=int, default=1000)
    ap.add_argument("--kernels-only", default=None,
                    help="card counts (e.g. 2,4): K6 on SchedulingBasic's wave and a wave "
                         "chained on it, and K4 on TopologySpreading's pod, each timed, and "
                         "nothing else")
    ap.add_argument("--out", default="multicard.jsonl", help="JSON lines, appended")
    own = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("this tool needs a CUDA card")
    sys.stdout.reconfigure(line_buffering=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"cards: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(reports)} libraries")
    for name in ("sharded_assign_cards", "fit_and_score_cards"):
        for line in reports.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    args = chip_smoke.build_parser().parse_args([])
    if own.kernels_only:
        res = kernels_only(args, smi[0], [int(x) for x in own.kernels_only.split(",")])
        _append(own.out, {"smi": smi, "kernels_only": res})
        print(json.dumps({"multicard_kernels": res}, default=str))
        return 0
    sweep = [int(x) for x in own.sweep.split(",") if x.strip()]
    loop = (args.init_pods, args.pods)
    single = own.single_pods
    if own.short:
        args.nodes = args.spread_nodes = args.spread_init = 600
        args.init_pods = 200
        chip_smoke.MC_RACK = (1200, 4)
        chip_smoke.MC_RACK_PODS = 128
        chip_smoke.RACK_EXISTING = 200
        chip_smoke.MC_K7_PODS = 16
        loop, sweep, single = (200, 256), [], 64
    res = chip_smoke.multicard_phase(args, smi[0], own.ranks, loop_init=loop[0],
                                     loop_pods=loop[1], sweep=sweep, single_pods=single)
    _append(own.out, {"smi": smi, "ranks": own.ranks, "short": own.short, **res})
    print(json.dumps({"multicard": {k: v for k, v in res.items() if k != "sweep"}},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
