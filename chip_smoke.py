"""Smoke run of kubernetes_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # full size, as the check runs it

Phases (any failure exits non-zero; nothing is caught and ignored):
1. build the four CUDA kernels from kubernetes_tpu_torch/ops/csrc (nvcc,
   one process per source, all at once);
2. build scheduler_perf SchedulingBasic/5000Nodes_10000Pods in the port's
   Cache: 5000 nodes of 32 CPU / 64Gi / 110 pods over 8 zones;
3. the main path: place the 1000 initial and 10000 measured pods through
   TorchBackend.run_batched in waves of 512 (signature dedup on, the
   reference's default), assuming each wave's winners into the cache
   between waves; every pod must land and every kernel must have launched
   (counts zeroed just before this phase, read just after); signatures per
   wave and K2's full-tier and replay steps are printed;
4. on one more full-width wave, run K1 (over the signature rows) and K2
   and their plain PyTorch versions on the card on the same inputs, with
   dedup and without, and require exact equality of every output (the
   signature table and sig_scores included; K2 also with an all-rejecting
   and a 3-word tie stream); K3 on that wave's dirty rows; then time them
   (the kernels alone by torch.profiler, the plain versions by events);
5. hold the card's decisions against the CPU plain path on mixed clusters
   of 16 to 1500 nodes (taints, affinity, images, ports, spread, hard
   spread and inter-pod affinity, an extended resource, three scoring
   strategies) through run_batched with dedup on: equal bindings and equal
   final rng state;
6. the single-pod cycle at full width: scheduler_perf
   TopologySpreading/5000Nodes_5000Pods in a fresh Cache — 5000 initial
   pods through run_batched in waves, then 5000 app: spread pods (one
   DoNotSchedule zone constraint) one at a time through
   TorchSchedulingAlgorithm.schedule_pod (K4 + K3) with an assume and a
   snapshot update after each; every pod must land, K4 must launch once
   per measured pod, and the zone skew must end <= 1;
7. TopologySpreading through waves: a fresh Cache, the 5000 initial pods,
   then the 5000 app: spread pods through run_batched in waves of 512
   (hard spread in the scan, dedup on; counts zeroed before the measured
   pods, read after); every pod must land and the zone skew end <= 1; K1
   and K2 equal to their plain versions on one more full-width wave, both
   tiers; K2 timed;
8. inter-pod affinity in the scan: on a mixed 5000-node cluster with 2000
   existing pods carrying (anti)affinity terms, one 512-pod wave of IPA
   pods (required affinity with the self-match bootstrap, required
   anti-affinity on hostname and zone, preferred terms both ways) and mixed
   pods; K1 and K2 equal to their plain versions, both tiers; K2 timed;
9. K4 against its plain version on the card at full width, exact equality
   of every output array, on a TopologySpreading pod, a SchedulingBasic
   pod, pods with every IPA term kind on phase 8's cluster, a pod that fits
   nowhere, and three pods in one launch; then K4 and its plain version
   timed;
10. the card against the CPU plain path through schedule_pod on mixed
   clusters of 16 to 1500 nodes with hard spread and IPA: equal results,
   equal final rng state, equal FitError messages;
then print the card, the timings, the kernels line and the result line.

It imports nothing of the reference JAX package and never imports jax.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time

import numpy as np
import torch


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# published peaks of one H100 SXM (dense): HBM3 3.35 TB/s, float32 outside
# the tensor cores 67 TFLOP/s — the bound of each kernel is the larger of
# its bytes over the first and its float32 operations over the second
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn() on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_ms(fn, kernel: str, reps: int) -> float | None:
    """Median device duration of the CUDA kernel named `kernel` over `reps`
    calls of fn(), from a torch.profiler (CUPTI) trace: the kernel alone,
    without the wrapper's host time that CUDA events around the call
    include. None when the trace shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = sorted(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                   if kernel in e.name)
    return times[len(times) // 2] if times else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(pairs) -> float:
    """Largest |kernel - plain| over every element of every output pair."""
    return max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def place_waves(backend, cache, snap, pods, wave, rng, label):
    """run_batched in waves of `wave`, assuming winners between waves as the
    scheduling loop does; returns the wall seconds of each wave
    (run_batched ends in a device-to-host copy, so each wave's time
    includes its kernels)."""
    walls = []
    for w in range(0, len(pods), wave):
        chunk = pods[w: w + wave]
        t = time.perf_counter()
        got, _ = backend.run_batched(chunk, snap, rng=rng, pad_to=wave)
        walls.append(time.perf_counter() - t)
        for pod, node in zip(chunk, got):
            if node is None:
                fail(f"{label}: {pod.meta.name} was not placed")
            cache.assume_pod(pod, node)
        cache.update_snapshot(snap)
    return walls


def wave_inputs(backend, pods, snap, pad):
    """One wave's kernel inputs on the card, as run_batched builds them:
    planes, tables, config, packed features, signature groups."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.ops.planes import (
        pack_features, pad_features, stack_features, unpack_features)

    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = pad_features(stack_features(
        [backend.extractor.features(p, planes) for p in pods]), pad)
    dp, dt = backend.device_inputs(planes)
    rows, layout = pack_features(feats)
    sig, uniq = backend._group_wave(rows, len(pods))
    packed_f = torch.from_numpy(rows).cuda()
    return SimpleNamespace(
        cfg=backend.kernel_config(planes, feats), planes=planes, dp=dp, dt=dt,
        packed_f=packed_f, layout=layout, fv=unpack_features(packed_f, layout),
        sig=torch.from_numpy(sig).cuda(), uniq=torch.from_numpy(uniq).cuda(),
        logtab=backend._logtab)


def _flat(out, prefix=""):
    for k, v in out.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def k1_call(w, dedup):
    from kubernetes_tpu_torch.ops import kernels

    return kernels.static_parts(w.dp, w.dt, w.packed_f, w.layout,
                                rows=w.uniq if dedup else None)


def k2_call(w, k1, words, dedup, plain=False):
    """K2 on the wave's inputs (its plain version with plain=True)."""
    from kubernetes_tpu_torch.ops import kernels

    kw = dict(sig_ids=w.sig, uniq_idx=w.uniq) if dedup else {}
    if plain:
        return kernels.assign_scan_ref(w.cfg, w.dp, k1, w.fv, words, 0, w.logtab, **kw)
    return kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout, words, 0,
                               w.logtab, **kw)


def compare_wave(label, w, words, dedup):
    """K1 (over the signature rows with dedup) and K2 against their plain
    versions on the card on the same inputs: every output array exactly
    equal. Returns (max |K1 - plain|, max |K2 - plain|, K1 out, K2 out)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features

    k1 = k1_call(w, dedup)
    f1 = w.fv if not dedup else unpack_features(w.packed_f[w.uniq.long()], w.layout)
    k1_ref = kernels.static_parts_ref(w.dp, w.dt, f1)
    torch.cuda.synchronize()
    for k in k1:
        if not torch.equal(k1[k], k1_ref[k]):
            fail(f"static_parts.{k} differs from its plain version ({label})")
    got = k2_call(w, k1, words, dedup)
    want = k2_call(w, k1, words, dedup, plain=True)
    torch.cuda.synchronize()
    g, r = dict(_flat(got)), dict(_flat(want))
    if g.keys() != r.keys():
        fail(f"assign_scan outputs {sorted(g)} vs plain {sorted(r)} ({label})")
    for k in g:
        if not torch.equal(g[k], r[k]):
            fail(f"assign_scan {k} differs from its plain version ({label})")
    return (max_abs_err((k1[k], k1_ref[k]) for k in k1),
            max_abs_err((g[k], r[k]) for k in g), k1, got)


def k2_work(w, k1, words, out, dedup):
    """(bytes, float32 operations) K2 must spend on this wave, from what
    this run's data needs: K1's rows of the signatures (dedup) or active
    pods that take a step, read once; the node planes it reads (alloc,
    domain, valid, the IPA term keys with IPA) and the carried planes read
    and written once; features, tie words, log table and the packed
    result; with dedup the signature table, sig_scores and groups written
    once. Operations: per node the balanced score (~11) on each full-tier
    step and 2 per active soft slot on every step."""
    nb, n = w.planes.nb, w.planes.n
    active = w.fv["active"] != 0
    rows_read = int(w.sig.max()) + 1 if dedup else int(active.sum())
    b = rows_read * (nb * (1 + 4 + 4 + 4) + 1)
    b += nbytes(w.dp["alloc"], w.dp["domain"], w.dp["valid"])
    carried = ["used", "nonzero_used", "sel_counts"]
    if w.cfg.ipa_active:
        carried += ["ipa_counts", "ipa_anti", "ipa_pref"]
        b += nbytes(w.dp["ipa_term_key"])
    b += 2 * nbytes(*(w.dp[k] for k in carried))
    b += nbytes(w.packed_f, words, w.logtab, out["packed"])
    if dedup:
        b += nbytes(out["sig_scores"], *out["sig_table"].values(), w.sig, w.uniq)
    full = int(out["tiers"][0]) if dedup else int(active.sum())
    soft_on = int(w.fv["soft_active"][active][:, : max(1, w.cfg.n_soft)].sum())
    return b, n * (11 * full + 2 * soft_on)


def time_k2(label, w, k1, words, out, dedup, reps):
    """K2's profiler time, its plain version's event time and its bound on
    this wave's inputs."""
    ms = kernel_ms(lambda: k2_call(w, k1, words, dedup), "assign_scan_kernel", reps)
    if ms is None:
        fail("the profiler trace shows no device time for assign_scan")
    plain = time_ms(lambda: k2_call(w, k1, words, dedup, plain=True), 1, warmup=0)
    bd, by = bound_ms(*k2_work(w, k1, words, out, dedup))
    tiers = out["tiers"].tolist() if dedup else "-"
    print(f"assign_scan ({label}, dedup {'on' if dedup else 'off'}): {ms:.4f} ms "
          f"(plain {plain:.1f} ms, bound {bd:.5f} ms by {by}); {w.planes.n} nodes, "
          f"n_hard {w.cfg.n_hard} n_soft {w.cfg.n_soft} ipa {int(w.cfg.ipa_active)}, "
          f"signatures {int(w.sig.max()) + 1}, tiers [full, replay] {tiers}")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bd, "bound_by": by}


def tie_words(seed, n_slots):
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.tpu.backend import clone_tie_words

    words = clone_tie_words(random.Random(seed),
                            n_slots * kernels.MAX_TIE_DRAWS + kernels.MAX_TIE_DRAWS)
    return torch.from_numpy(words.view("int32")).cuda()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--zones", type=int, default=8)
    ap.add_argument("--init-pods", type=int, default=1000)
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--wave", type=int, default=512)
    ap.add_argument("--seed", type=int, default=1)
    # phases 6-10: TopologySpreading/5000Nodes_5000Pods (both paths), the
    # IPA cluster, and how many card-vs-CPU cycle clusters (16, 64, 300, 1500)
    ap.add_argument("--spread-nodes", type=int, default=5000)
    ap.add_argument("--spread-init", type=int, default=5000)
    ap.add_argument("--spread-pods", type=int, default=5000)
    ap.add_argument("--ipa-nodes", type=int, default=5000)
    ap.add_argument("--ipa-existing", type=int, default=2000)
    ap.add_argument("--cycle-cases", type=int, default=4)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")

    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import cuda, kernels
    from kubernetes_tpu_torch.ops.planes import SLICE_PLANES, planes_from_reference
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    reports = cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s, {len(reports)} libraries")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2. cluster
    t0 = time.perf_counter()
    names = ResourceNames()
    cache = Cache(names)
    for i in range(args.nodes):
        cache.add_node(scheduling_basic_node(i, args.zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(names, device="cuda")
    rng = random.Random(args.seed)
    print(f"cluster: {args.nodes} nodes, {args.zones} zones, "
          f"{time.perf_counter() - t0:.1f} s")

    # 3. the main path (dedup on, the reference's default)
    init = [scheduling_basic_pod(i) for i in range(args.init_pods)]
    measured = [scheduling_basic_pod(args.init_pods + i) for i in range(args.pods)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    place_waves(backend, cache, snap, init, args.wave, rng, "main path")
    tiers0 = backend.tier_steps.tolist()
    stats0 = dict(backend.dedup_stats)
    t1 = time.perf_counter()
    phase0 = dict(backend.phase_s)
    walls = place_waves(backend, cache, snap, measured, args.wave, rng, "main path")
    t2 = time.perf_counter()
    phases = {k: v - phase0[k] for k, v in backend.phase_s.items()}
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the main path: {launches}")
    for k in ("static_parts", "assign_scan", "scatter_rows"):
        if launches[k] <= 0:
            fail(f"kernel {k} never launched on the main path")
    placed = cache.pod_count()
    if placed != args.init_pods + args.pods:
        fail(f"{placed} pods in the cache, expected {args.init_pods + args.pods}")
    n_waves = len(walls)
    tiers = [a - b for a, b in zip(backend.tier_steps.tolist(), tiers0)]
    stats = {k: v - stats0[k] for k, v in backend.dedup_stats.items()}
    print(f"main path: {placed} pods placed; initial {t1 - t0:.3f} s; measured "
          f"{args.pods} pods in {n_waves} waves, {t2 - t1:.3f} s = "
          f"{args.pods / (t2 - t1):.1f} pods/s (incl. host assume + snapshot)")
    print(f"signature dedup on the measured waves: {stats['signatures']} signatures in "
          f"{stats['waves']} waves ({stats['signatures'] / max(stats['waves'], 1):.2f} per "
          f"wave); K2 steps by tier [full, replay] {tiers}")
    if stats["waves"] != n_waves or tiers[1] <= 0:
        fail("the main path's waves did not run the signature replay tier")
    wave_sorted = sorted(walls)
    print(f"wave wall (run_batched): median {wave_sorted[len(walls) // 2] * 1e3:.2f} ms, "
          f"max {wave_sorted[-1] * 1e3:.2f} ms, sum {sum(walls):.3f} s")
    print("measured waves, host-clock seconds by run_batched phase: "
          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; outside run_batched (assume + snapshot) {t2 - t1 - sum(walls):.4f}")
    print(f"upload: {backend.upload_stats}")
    # the device mirror must equal host truth after one more sync
    planes = backend.sync(snap)
    dev_planes, _ = backend.device_inputs(planes)
    host = planes.as_dict()
    for k, t in dev_planes.items():
        h = torch.from_numpy(host[k].view("int32") if host[k].dtype.name == "uint32" else host[k])
        if not torch.equal(t.cpu(), h):
            fail(f"device plane {k} differs from the host plane")
    used = planes.used[: planes.n]
    if (used > planes.alloc[: planes.n]).any():
        fail("a node's requests exceed its allocatable")
    print(f"pods per node: min {int(used[:, 3].min())} max {int(used[:, 3].max())}")

    # 4. kernels vs plain versions on one full-width wave, both tiers
    cmp_pods = [scheduling_basic_pod(10**6 + i) for i in range(args.wave)]
    w = wave_inputs(backend, cmp_pods, snap, args.wave)
    words = tie_words(args.seed + 1, args.wave)
    err1 = err2 = 0.0
    out = {}
    for dedup in (True, False):
        e1, e2, k1, o = compare_wave(f"SchedulingBasic, dedup {dedup}", w, words, dedup)
        err1, err2 = max(err1, e1), max(err2, e2)
        out[dedup] = (k1, o)
        # the tie stream's edge cases on the same wave: every draw rejected
        # (overflow), and a 3-word stream whose reads clamp to its last word
        for label, edge in (("all-ones words", torch.full_like(words, -1)),
                            ("3-word stream", words[:3].clone())):
            _, e, _, got = compare_wave(f"{label}, dedup {dedup}", w, edge, dedup)
            err2 = max(err2, e)
            print(f"compare wave, {label}, dedup {dedup}: tie words consumed "
                  f"{int(got['packed'][-2])}, overflow {int(got['packed'][-1])}")
    winners = out[True][1]["packed"][: args.wave]
    if not torch.equal(winners, out[False][1]["packed"][: args.wave]):
        fail("the compare wave's dedup and non-dedup winners differ")
    print(f"compare wave: {int((winners >= 0).sum())}/{args.wave} placed, tie words "
          f"consumed {int(out[True][1]['packed'][-2])}, signatures {int(w.sig.max()) + 1}, "
          f"K2 tiers [full, replay] {out[True][1]['tiers'].tolist()}")
    if int((winners >= 0).sum()) != args.wave:
        fail("the compare wave did not place every pod")

    # K3 on the rows that wave's placements dirty
    planes = w.planes
    for pod, win in zip(cmp_pods, winners.tolist()):
        cache.assume_pod(pod, planes.node_names[win])
    cache.update_snapshot(snap)
    planes = backend.sync(snap)
    idx_np = np.array(sorted(set(winners.tolist())), np.int32)
    host = planes.as_dict()
    rows = planes_from_reference({k: host[k][idx_np] for k in SLICE_PLANES}, "cuda")
    idx = torch.from_numpy(idx_np).cuda()
    k3 = {k: w.dp[k].clone() for k in SLICE_PLANES}
    k3_ref = {k: w.dp[k].clone() for k in SLICE_PLANES}
    kernels.scatter_rows(k3, rows, idx)
    kernels.scatter_rows_ref(k3_ref, rows, idx)
    torch.cuda.synchronize()
    err3 = max_abs_err((k3[k], k3_ref[k]) for k in k3)
    for k in k3:
        if not torch.equal(k3[k], k3_ref[k]):
            fail(f"scatter_rows plane {k} differs from its plain version")
        h = host[k].view("int32") if host[k].dtype.name == "uint32" else host[k]
        if not torch.equal(k3[k].cpu(), torch.from_numpy(np.ascontiguousarray(h))):
            fail(f"scattered plane {k} differs from the host plane")
    print(f"compare: static_parts, assign_scan (both tiers), scatter_rows equal to their "
          f"plain versions, tolerance 0 (exact; integer outputs) ({len(idx_np)} dirty rows)")

    # timings on the same inputs: K1 as the main path calls it (over the
    # signature rows) and over every pod; K2 with dedup (the main path) and
    # without; K3 on the wave's dirty rows and on one row
    from kubernetes_tpu_torch.ops.planes import unpack_features

    f_sig = unpack_features(w.packed_f[w.uniq.long()], w.layout)
    ms1 = kernel_ms(lambda: k1_call(w, True), "static_parts_kernel", 20)
    ms1_all = kernel_ms(lambda: k1_call(w, False), "static_parts_kernel", 20)
    ms1p = time_ms(lambda: kernels.static_parts_ref(w.dp, w.dt, f_sig), 5)
    k2 = {dedup: time_k2("SchedulingBasic", w, out[dedup][0], words, out[dedup][1], dedup,
                         5 if dedup else 3) for dedup in (True, False)}
    ms3 = kernel_ms(lambda: kernels.scatter_rows(k3, rows, idx), "scatter_rows_kernel", 50)
    ms3p = time_ms(lambda: kernels.scatter_rows_ref(k3_ref, rows, idx), 20)
    rows1, idx1 = {k: v[:1] for k, v in rows.items()}, idx[:1]
    ms3_row = kernel_ms(lambda: kernels.scatter_rows(k3, rows1, idx1),
                        "scatter_rows_kernel", 50)
    if None in (ms1, ms1_all, ms3, ms3_row):
        fail("the profiler trace shows no device time for a kernel")
    print(f"static_parts over {len(w.uniq)} signature rows {ms1:.4f} ms, over "
          f"{args.wave} pods {ms1_all:.4f} ms; scatter_rows on one dirty row "
          f"{ms3_row:.5f} ms")

    b1 = (nbytes(*(w.dp[k] for k in ("valid", "unsched", "group_id", "taints",
                                      "prefer_taints", "port_words", "image_kib")))
          + nbytes(*w.dt.values()) + len(w.uniq) * w.packed_f.shape[1] * 4
          + nbytes(w.uniq, *out[True][0].values()))
    b3 = nbytes(idx) + 2 * nbytes(*rows.values())
    rows_out = []
    for name, src, repl, err, ms, msp, (bd, by) in (
        ("static_parts", "kubernetes_tpu_torch/ops/csrc/static_parts.cu",
         "kubernetes_tpu/ops/kernels.py:774", err1, ms1, ms1p, bound_ms(b1, 0)),
        ("assign_scan", "kubernetes_tpu_torch/ops/csrc/assign_scan.cu",
         "kubernetes_tpu/ops/kernels.py:1369", err2, k2[True]["ms"], k2[True]["plain_ms"],
         (k2[True]["bound_ms"], k2[True]["bound_by"])),
        ("scatter_rows", "kubernetes_tpu_torch/ops/csrc/scatter_rows.cu",
         "kubernetes_tpu/scheduler/tpu/backend.py:58", err3, ms3, ms3p, bound_ms(b3, 0)),
    ):
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                         "launches": launches[name], "max_abs_err": err, "ms": ms,
                         "plain_ms": msp, "bound_ms": bd, "bound_by": by,
                         "library_ms": None})
        print(f"{name}: {ms:.4f} ms (plain {msp:.3f} ms, bound {bd:.5f} ms by {by}), "
              f"{launches[name]} launches on the main path")
    # estimate: each measured wave runs K1 + K2 and one K3
    busy = (ms1 + k2[True]["ms"] + ms3) * n_waves
    print(f"device busy share of the measured waves ((K1 + K2 + K3 kernel time) "
          f"x waves / wave wall): {busy / (sum(walls) * 1e3):.3f}")

    # 5. mixed clusters: card vs CPU plain path, hard spread and IPA in the waves
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

    cases = [(mixed_spec(7, 64, 120, constraints=True), pa) for pa in (
        None, {"NodeResourcesFit": {"strategy": "MostAllocated"}},
        {"NodeResourcesFit": {"strategy": "RequestedToCapacityRatio",
                              "shape": [[0, 100], [50, 20], [100, 0]]}})]
    # 16 nodes: one partly used ballot word; 300 and 1500 nodes: 512- and
    # 2048-row buckets (the latter two 1024-node rounds with a ragged tail)
    cases += [(mixed_spec(9, 16, 40, constraints=True), None),
              (mixed_spec(10, 300, 200, constraints=True), None),
              (mixed_spec(8, 1500, 240, constraints=True), None)]
    # a repeated RTC breakpoint and fit weights over an extended resource
    cases.append((mixed_spec(11, 64, 120, constraints=True), {"NodeResourcesFit": {
        "strategy": "RequestedToCapacityRatio",
        "shape": [[0, 100], [40, 60], [40, 30], [100, 0]],
        "resources": {"cpu": 1, "memory": 2, "example.com/dev": 3}}}))
    t0 = time.perf_counter()
    for spec, pa in cases:
        results = []
        for device in ("cuda", "cpu"):
            c = Cache(ResourceNames())
            for n in build_nodes(spec, types, meta):
                c.add_node(n)
            s = Snapshot()
            c.update_snapshot(s)
            b = TorchBackend(c.names, plugin_args=pa, device=device)
            # the 16-node case runs without an rng: 16 zero words, first
            # max-score node, reads clamped past the stream
            r = None if len(spec["nodes"]) == 16 else random.Random(3)
            got_all = []
            pods = build_pods(spec, types, meta)
            for i in range(0, len(pods), 24):
                chunk = pods[i: i + 24]
                got, _ = b.run_batched(chunk, s, rng=r, pad_to=32)
                for pod, node in zip(chunk, got):
                    if node is not None:
                        c.assume_pod(pod, node)
                c.update_snapshot(s)
                got_all += got
            results.append((got_all, r and r.getstate(), b.tier_steps.tolist()))
        if results[0] != results[1]:
            fail(f"mixed cluster ({len(spec['nodes'])} nodes, {pa}): card and "
                 "CPU plain path disagree")
    print(f"mixed clusters with hard spread and IPA, dedup on: card == CPU plain path "
          f"(64 nodes x 4 scoring configs; 16 nodes without an rng; 300 and 1500 "
          f"nodes), {time.perf_counter() - t0:.1f} s")

    # 6-10. TopologySpreading (single-pod path, then waves), IPA, K4
    launches6, state6 = topology_spreading(args)
    waves7 = spreading_waves(args)
    print(f"TopologySpreading measured pods/s: waves {waves7['pods_s']:.1f} "
          f"(run_batched alone {waves7['run_pods_s']:.1f}), single-pod path "
          f"{state6['pods_s']:.1f}")
    ipa8, cluster8 = ipa_wave(args)
    k4 = k4_against_plain(args, state6, cluster8)
    cycle_card_vs_cpu(args)
    rows_out.append({"name": "fit_and_score", "route": "cuda",
                     "source": "kubernetes_tpu_torch/ops/csrc/fit_and_score.cu",
                     "replaces": "kubernetes_tpu/ops/kernels.py:754",
                     "launches": launches6["fit_and_score"], **k4})
    print(f"device busy share of the measured single-pod cycle ((K4 + one-row K3 "
          f"kernel time) x pods / wall): "
          f"{(k4['ms'] + ms3_row) * args.spread_pods / (state6['wall_s'] * 1e3):.4f}")
    print("assign_scan per configuration (profiler ms, plain ms, bound ms): "
          + "; ".join(f"{k} {v['ms']:.4f} / {v['plain_ms']:.1f} / {v['bound_ms']:.5f}"
                      for k, v in (("SchedulingBasic dedup", k2[True]),
                                   ("SchedulingBasic no dedup", k2[False]),
                                   ("TopologySpreading dedup", waves7["k2"]),
                                   ("IPA wave dedup", ipa8))))
    print(f"launches on the TopologySpreading wave path: {waves7['launches']}")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows_out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# --------------------------------------------------------------------------
# 6-10: TopologySpreading, inter-pod affinity, the single-pod cycle
# --------------------------------------------------------------------------


def topology_spreading(args):
    """6. scheduler_perf TopologySpreading/5000Nodes_5000Pods in a fresh
    Cache: the initial pods through run_batched in waves (K1-K3), the
    measured app: spread pods one at a time through schedule_pod (K4, K3),
    assuming each and updating the snapshot as the scheduling loop does.
    Returns (the path's launch counts, state for phase 7)."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import CycleState
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)
    from kubernetes_tpu_torch.testing.wrappers import (
        scheduling_basic_node, scheduling_basic_pod, topology_spreading_pod)

    t0 = time.perf_counter()
    names = ResourceNames()
    cache = Cache(names)
    for i in range(args.spread_nodes):
        cache.add_node(scheduling_basic_node(i, args.zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(names, device="cuda")
    algo = TorchSchedulingAlgorithm(backend, rng=random.Random(args.seed))
    print(f"TopologySpreading: {args.spread_nodes} nodes, {args.zones} zones, "
          f"{time.perf_counter() - t0:.1f} s")

    init = [scheduling_basic_pod(i) for i in range(args.spread_init)]
    measured = [topology_spreading_pod(i) for i in range(args.spread_pods)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    for w in range(0, len(init), args.wave):
        wave = init[w: w + args.wave]
        got, _ = backend.run_batched(wave, snap, rng=algo.rng, pad_to=args.wave)
        for pod, node in zip(wave, got):
            if node is None:
                fail(f"initial pod {pod.meta.name} was not placed")
            cache.assume_pod(pod, node)
        cache.update_snapshot(snap)
    t1 = time.perf_counter()
    run0 = dict(backend.run_phase_s)
    sched_s = assume_s = 0.0
    for pod in measured:
        a = time.perf_counter()
        res = algo.schedule_pod(CycleState(), pod, snap)  # a FitError exits
        b = time.perf_counter()
        cache.assume_pod(pod, res.suggested_host)
        cache.update_snapshot(snap)
        sched_s += b - a
        assume_s += time.perf_counter() - b
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the single-pod path: {launches}")
    if launches["fit_and_score"] != args.spread_pods:
        fail(f"fit_and_score launched {launches['fit_and_score']} times for "
             f"{args.spread_pods} measured pods")
    if launches["scatter_rows"] < 1:
        fail("scatter_rows never launched on the single-pod path")
    if cache.pod_count() != args.spread_init + args.spread_pods:
        fail(f"{cache.pod_count()} pods in the cache")
    per_zone = [0] * args.zones
    for pod in measured:
        node = cache._pod_nodes[pod.meta.key]
        per_zone[int(node.split("-")[1]) % args.zones] += 1
    print(f"app: spread pods per zone: {per_zone}")
    if max(per_zone) - min(per_zone) > 1:
        fail(f"zone skew {max(per_zone) - min(per_zone)} > 1")
    wall = t2 - t1
    phases = {k: v - run0[k] for k, v in backend.run_phase_s.items()}
    print(f"single-pod path: {args.spread_init} initial pods in {t1 - t0:.3f} s "
          f"(run_batched); {args.spread_pods} measured pods in {wall:.3f} s = "
          f"{args.spread_pods / wall:.1f} pods/s incl. assume + snapshot "
          f"(upstream threshold 85); schedule_pod alone {sched_s:.3f} s = "
          f"{args.spread_pods / sched_s:.1f} pods/s")
    print("measured pods, host-clock seconds by run phase: "
          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; schedule_pod outside run {sched_s - sum(phases.values()):.4f}"
          + f"; assume + snapshot {assume_s:.4f}")
    print("ms per measured pod: "
          + ", ".join(f"{k} {v * 1e3 / args.spread_pods:.4f}" for k, v in phases.items())
          + f", assume + snapshot {assume_s * 1e3 / args.spread_pods:.4f}")
    print(f"upload: {backend.upload_stats}")
    return launches, {"snap": snap, "backend": backend, "wall_s": wall,
                      "pods_s": args.spread_pods / wall}


def spreading_waves(args):
    """7. TopologySpreading/5000Nodes_5000Pods through the wave path: a
    fresh Cache, the initial pods, then the measured app: spread pods
    through run_batched in waves (hard spread in the scan, dedup on),
    assuming each wave; every pod must land and the zone skew end <= 1.
    Then K1/K2 against their plain versions on one more full-width wave of
    spread pods, both tiers, and K2 timed."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import (
        scheduling_basic_node, scheduling_basic_pod, topology_spreading_pod)

    cache = Cache(ResourceNames())
    for i in range(args.spread_nodes):
        cache.add_node(scheduling_basic_node(i, args.zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(cache.names, device="cuda")
    rng = random.Random(args.seed)
    init = [scheduling_basic_pod(i) for i in range(args.spread_init)]
    measured = [topology_spreading_pod(i) for i in range(args.spread_pods)]
    place_waves(backend, cache, snap, init, args.wave, rng, "TopologySpreading waves")
    tiers0 = backend.tier_steps.tolist()
    stats0 = dict(backend.dedup_stats)
    kernels.reset_launches()
    t1 = time.perf_counter()
    walls = place_waves(backend, cache, snap, measured, args.wave, rng,
                        "TopologySpreading waves")
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    for k in ("static_parts", "assign_scan"):
        if launches[k] <= 0:
            fail(f"kernel {k} never launched on the TopologySpreading wave path")
    if cache.pod_count() != args.spread_init + args.spread_pods:
        fail(f"{cache.pod_count()} pods in the cache")
    per_zone = [0] * args.zones
    for pod in measured:
        per_zone[int(cache._pod_nodes[pod.meta.key].split("-")[1]) % args.zones] += 1
    if max(per_zone) - min(per_zone) > 1:
        fail(f"zone skew {max(per_zone) - min(per_zone)} > 1 on the wave path")
    tiers = [a - b for a, b in zip(backend.tier_steps.tolist(), tiers0)]
    sigs = backend.dedup_stats["signatures"] - stats0["signatures"]
    wall = t2 - t1
    print(f"TopologySpreading through waves: {args.spread_pods} measured pods in "
          f"{len(walls)} waves of {args.wave}, {wall:.3f} s = {args.spread_pods / wall:.1f} "
          f"pods/s incl. assume + snapshot (run_batched alone "
          f"{args.spread_pods / sum(walls):.1f}); pods per zone {per_zone}; "
          f"{sigs} signatures; K2 steps [full, replay] {tiers}; launches {launches}")
    # one more full-width wave of spread pods on the final state
    w = wave_inputs(backend, [topology_spreading_pod(10**6 + i) for i in range(args.wave)],
                    snap, args.wave)
    if w.cfg.n_hard != 1:
        fail(f"the spread compare wave has n_hard {w.cfg.n_hard}")
    words = tie_words(args.seed + 2, args.wave)
    outs = {dedup: compare_wave(f"TopologySpreading wave, dedup {dedup}", w, words, dedup)
            for dedup in (True, False)}
    k1, out = outs[True][2], outs[True][3]
    print(f"TopologySpreading compare wave: K1, K2 == plain (both tiers); "
          f"{int((out['packed'][:-2] >= 0).sum())}/{args.wave} placed")
    return {"pods_s": args.spread_pods / wall, "run_pods_s": args.spread_pods / sum(walls),
            "launches": launches,
            "k2": time_k2("TopologySpreading", w, k1, words, out, True, 3)}


def ipa_cluster(args):
    """The mixed 5000-node cluster with existing (anti)affinity pods that
    phases 8 and 9 share: (backend, snapshot, pods beyond the existing)."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

    t0 = time.perf_counter()
    spec = mixed_spec(args.seed + 40, args.ipa_nodes,
                      args.ipa_existing + 64 + args.wave // 2, constraints=True)
    cache = Cache(ResourceNames())
    nodes = build_nodes(spec, types, meta)
    for n in nodes:
        cache.add_node(n)
    pods = build_pods(spec, types, meta)
    backend = TorchBackend(cache.names, device="cuda")
    for i, pod in enumerate(pods[: args.ipa_existing]):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(7 * i) % len(nodes)].meta.name)
    snap = Snapshot()
    cache.update_snapshot(snap)
    print(f"mixed IPA cluster: {args.ipa_nodes} nodes, {args.ipa_existing} existing "
          f"pods, {time.perf_counter() - t0:.1f} s")
    return backend, snap, spec, pods[args.ipa_existing:]


def ipa_wave(args):
    """8. Inter-pod affinity in the scan: on the mixed cluster, one
    full-width wave interleaving the repeating IPA shapes of ipa_pods and
    the cluster's own mixed pods (hard spread, affinity, anti-affinity,
    preferred terms); K1 and K2 against their plain versions, both tiers;
    K2 timed. Returns (K2 timing, the cluster for phase 9)."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import ipa_pods

    cluster = ipa_cluster(args)
    backend, snap, _spec, rest = cluster
    half = args.wave // 2
    shaped = ipa_pods(half, types, meta)
    mixed = rest[64: 64 + half]
    wave = [p for pair in zip(shaped, mixed) for p in pair]
    w = wave_inputs(backend, wave, snap, args.wave)
    if not (w.cfg.ipa_active and w.cfg.ipa_existing_anti and w.cfg.n_ipa_aff
            and w.cfg.n_ipa_anti and w.cfg.n_ipa_pref):
        fail(f"the IPA wave does not exercise every IPA term kind: {w.cfg}")
    words = tie_words(args.seed + 3, args.wave)
    outs = {dedup: compare_wave(f"IPA wave, dedup {dedup}", w, words, dedup)
            for dedup in (True, False)}
    k1, out = outs[True][2], outs[True][3]
    print(f"IPA compare wave: K1, K2 == plain (both tiers); "
          f"{int((out['packed'][:-2] >= 0).sum())}/{len(wave)} placed; n_hard "
          f"{w.cfg.n_hard}, ipa aff/anti/pref {w.cfg.n_ipa_aff}/{w.cfg.n_ipa_anti}/"
          f"{w.cfg.n_ipa_pref}, existing anti/pref {int(w.cfg.ipa_existing_anti)}/"
          f"{int(w.cfg.ipa_existing_pref)}")
    return time_k2("IPA wave", w, k1, words, out, True, 3), cluster


def _k4_case(backend, pods, snap):
    """K4's inputs for a list of pods (one block each) on the backend's
    current state."""
    from kubernetes_tpu_torch.ops.planes import features_from_reference, stack_features

    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = stack_features([backend.extractor.features(pod, planes) for pod in pods])
    dev_planes, dev_tables = backend.device_inputs(planes)
    cfg = backend.kernel_config(planes, feats)
    packed_f, layout = features_from_reference(feats, "cuda")
    return cfg, planes, dev_planes, dev_tables, packed_f, layout


def _k4_compare(label, backend, pods, snap):
    """Run K4 once for `pods` and its plain version for each pod on the
    card on the same inputs; every output array must be equal. Returns
    (max |kernel - plain|, feasible count of the first pod, inputs)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features

    case = _k4_case(backend, pods, snap)
    cfg, planes, dev_planes, dev_tables, packed_f, layout = case
    logtab = backend._logtab
    nf = len(kernels.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    packed = kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f, layout, logtab)
    f_views = unpack_features(packed_f, layout)
    err, feasible = 0.0, []
    names = ["fails", "feasible", "insufficient", "too_many_pods", "total"]
    for p in range(len(pods)):
        got = kernels.unpack_fit_outputs(packed[p], planes.nb, nf, planes.r)
        want = kernels.fit_and_score_ref(cfg, dev_planes, dev_tables, f_views, logtab, p)
        torch.cuda.synchronize()
        pairs = [(got[k], want[k]) for k in names]
        pairs += [(got["per_plugin"][k], want["per_plugin"][k]) for k in kernels.PLUGIN_NAMES]
        for (a, b), name in zip(pairs, names + list(kernels.PLUGIN_NAMES)):
            if not torch.equal(a, b):
                fail(f"fit_and_score {name} differs from its plain version ({label}, "
                     f"pod {p})")
        err = max(err, max_abs_err(pairs))
        feasible.append(int(got["feasible"].sum()))
    print(f"K4 == plain ({label}): {planes.n} nodes, feasible {feasible}, "
          f"n_hard {cfg.n_hard} n_soft {cfg.n_soft} ipa aff/anti/pref "
          f"{cfg.n_ipa_aff}/{cfg.n_ipa_anti}/{cfg.n_ipa_pref} existing anti/pref "
          f"{int(cfg.ipa_existing_anti)}/{int(cfg.ipa_existing_pref)}")
    return err, feasible[0], case


def k4_work(cfg, planes, tables, f, packed_f, out_bytes):
    """(bytes, float32 operations) K4 must spend on the first pod of `f`,
    from what fit_and_score.cu reads for this pod and config: every element
    it reads once and its packed output written once. Row planes count only
    the columns the pod's active slots index (domain keys, selector
    columns, IPA term columns); the port words, image columns, the existing
    pods' term planes and the log table only when their gates are on; the
    affinity tables only the pod's signature row. Operations: the balanced
    score (~11) and 2 per active soft slot, per node row."""
    nb = planes["valid"].shape[0]
    K = planes["domain"].shape[1]
    A, G = tables["aff_match"].shape
    v = {k: t[0].tolist() for k, t in f.items()}
    tkey = planes["ipa_term_key"].tolist()
    col = nb * 4  # one int32 column of a row plane
    b = nbytes(*(planes[k] for k in ("alloc", "used", "nonzero_used", "valid", "unsched",
                                     "group_id", "taints", "prefer_taints", "ipa_term_key")))
    b += packed_f[0].numel() * 4 + out_bytes
    b += nb + G + 4 * G + 1  # aff_allow, aff_match and aff_pref rows, aff_has_pref
    keys, sels, terms, n_soft_on = set(), set(), set(), 0
    for kind, n in (("hard", cfg.n_hard), ("soft", cfg.n_soft)):
        for c in range(min(cfg.max_constraints, n)):
            if not v[f"{kind}_active"][c]:
                continue
            n_soft_on += kind == "soft"
            if 0 <= v[f"{kind}_key"][c] < K:
                keys.add(v[f"{kind}_key"][c])
                sels.add(v[f"{kind}_sel"][c])
    for kind, m, n in (("anti", cfg.max_ipa_terms, cfg.n_ipa_anti),
                       ("aff", cfg.max_ipa_terms, cfg.n_ipa_aff),
                       ("pref", cfg.max_ipa_pref, cfg.n_ipa_pref)):
        for s in range(min(m, n)):
            t = v[f"ipa_{kind}_t"][s]
            if t >= 0 and 0 <= tkey[t] < K:
                keys.add(tkey[t])
                terms.add(t)
    matched = [t for t, on in enumerate(v["ipa_match"]) if on and 0 <= tkey[t] < K]
    ex_pref_add = cfg.ipa_existing_pref and not cfg.ipa_ignore_preferred_existing
    for on in (cfg.ipa_existing_anti, ex_pref_add):
        if on:
            keys |= {tkey[t] for t in matched}
            b += len(matched) * col  # ipa_anti / ipa_pref columns
    b += (len(keys) + len(sels) + len(terms)) * col  # domain, sel_counts, ipa_counts
    b += len({i for i in v["img_idx"] if i >= 0}) * col  # image_kib
    if v["has_ports"]:
        b += nbytes(planes["port_words"])
    b += 4 * n_soft_on  # logtab
    return b, nb * (11 + 2 * n_soft_on)


def k4_against_plain(args, state, cluster):
    """9. K4 against its plain version on the card at full width, exact
    equality of every output: (a) a TopologySpreading measured pod on the
    final state, (b) a SchedulingBasic pod (system-default soft spread),
    (c) pods with every IPA term kind on phase 8's mixed cluster with
    existing (anti)affinity pods, taints, ports and images, (d) a pod that
    fits nowhere, (e) three of them in one launch (one block per pod). Then
    K4 and its plain version timed on (a)'s inputs."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features
    from kubernetes_tpu_torch.testing.wrappers import (
        make_pod, scheduling_basic_pod, topology_spreading_pod)

    backend, snap = state["backend"], state["snap"]
    err, n_feas, case_a = _k4_compare("a: TopologySpreading pod", backend,
                                      [topology_spreading_pod(10**6)], snap)
    if n_feas == 0:
        fail("the TopologySpreading compare pod fits nowhere")
    e, _, _ = _k4_compare("b: SchedulingBasic pod", backend,
                          [scheduling_basic_pod(10**6)], snap)
    err = max(err, e)
    e, n_feas, _ = _k4_compare("d: fits nowhere", backend,
                               [make_pod("huge", cpu="100000", mem="50Mi")], snap)
    if n_feas:
        fail("the fits-nowhere pod found a node")
    err = max(err, e)
    # the pod grid dimension: three pods, one block each, one launch
    e, _, _ = _k4_compare("e: three pods in one launch", backend,
                          [topology_spreading_pod(10**6 + 1), scheduling_basic_pod(10**6 + 1),
                           make_pod("huge2", cpu="100000", mem="50Mi")], snap)
    err = max(err, e)

    # (c) phase 8's mixed cluster at full width with existing (anti)affinity pods
    mixed, msnap, spec, rest = cluster
    kinds = set()
    for pod in rest:
        s = spec["pods"][int(pod.meta.name[1:])]
        k = {kind for kind in ("aff", "anti", "pref", "hard") if s[kind]}
        if not k - kinds:
            continue
        kinds |= k
        e, _, _ = _k4_compare(f"c: mixed {sorted(k)}", mixed, [pod], msnap)
        err = max(err, e)
    if not {"aff", "anti", "pref", "hard"} <= kinds:
        fail(f"the mixed compare pods lack IPA/spread kinds: {kinds}")

    # timings on (a)'s inputs: the main path's shape
    cfg, planes, dev_planes, dev_tables, packed_f, layout = case_a
    logtab = backend._logtab
    f_views = unpack_features(packed_f, layout)
    ms = time_ms(lambda: kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f,
                                               layout, logtab), 50)
    ms_p = time_ms(lambda: kernels.fit_and_score_ref(cfg, dev_planes, dev_tables,
                                                     f_views, logtab), 10)
    dev = kernel_ms(lambda: kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f,
                                                  layout, logtab),
                    "fit_and_score_kernel", 50)
    print(f"fit_and_score: event ms around the wrapper {ms:.4f}, profiler kernel ms "
          f"{dev}, plain {ms_p:.3f} ms")
    nf = len(kernels.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    out_bytes = kernels.fit_output_bytes(planes.nb, nf, planes.r)[1]
    b4, f4 = k4_work(cfg, dev_planes, dev_tables, f_views, packed_f, out_bytes)
    bd, by = bound_ms(b4, f4)
    ms_k = dev if dev is not None else ms
    print(f"fit_and_score: {ms_k:.4f} ms (plain {ms_p:.3f} ms, bound {bd:.5f} ms by "
          f"{by}, {b4} bytes)")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bd,
            "bound_by": by, "library_ms": None}


def cycle_card_vs_cpu(args):
    """10. The card against the CPU plain path through schedule_pod on mixed
    clusters of 16 to 1500 nodes with hard spread and IPA: equal results,
    equal evaluated/feasible counts, equal final rng state, equal FitError
    messages and failing plugins."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import CycleState, FitError
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)
    from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

    cases = [(16, 48), (64, 96), (300, 96), (1500, 96)]
    for n_nodes, n_pods in cases[: args.cycle_cases]:
        spec = mixed_spec(args.seed + n_nodes, n_nodes, n_pods, constraints=True)
        results = []
        for device in ("cuda", "cpu"):
            cache = Cache(ResourceNames())
            for n in build_nodes(spec, types, meta):
                cache.add_node(n)
            snap = Snapshot()
            cache.update_snapshot(snap)
            algo = TorchSchedulingAlgorithm(TorchBackend(cache.names, device=device),
                                            rng=random.Random(5))
            got = []
            for pod in build_pods(spec, types, meta):
                try:
                    r = algo.schedule_pod(CycleState(), pod, snap)
                except FitError as e:
                    got.append(("FitError", e.error_message(),
                                sorted(e.diagnosis.unschedulable_plugins)))
                    continue
                got.append((r.suggested_host, r.evaluated_nodes, r.feasible_nodes))
                cache.assume_pod(pod, r.suggested_host)
                cache.update_snapshot(snap)
            results.append((got, algo.rng.getstate()))
        if results[0] != results[1]:
            fail(f"single-pod cycle, mixed {n_nodes} nodes: card and CPU plain "
                 "path disagree")
        errs = sum(1 for g in results[0][0] if g[0] == "FitError")
        print(f"single-pod cycle, mixed {n_nodes} nodes, {n_pods} pods: card == CPU "
              f"plain path ({n_pods - errs} placed, {errs} FitErrors)")


if __name__ == "__main__":
    main()
