"""Smoke run of kubernetes_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # full size, as the check runs it

Phases (any failure exits non-zero; nothing is caught and ignored):
1. build the six CUDA libraries (seven kernels) from
   kubernetes_tpu_torch/ops/csrc (nvcc, one process per source, all at once);
2. build scheduler_perf SchedulingBasic/5000Nodes_10000Pods in the port's
   Cache: 5000 nodes of 32 CPU / 64Gi / 110 pods over 8 zones;
3. the serial wave path: place the 1000 initial and 10000 measured pods
   through TorchBackend.run_batched in waves of 512 (signature dedup on),
   assuming each wave's winners into the cache
   between waves; every pod must land and every kernel must have launched
   (counts zeroed just before this phase, read just after); signatures per
   wave and K2's full-tier and replay steps are printed;
4. on one more full-width wave, run K1 (over the signature rows) and K2
   and their plain PyTorch versions on the card on the same inputs, with
   dedup and without, and require exact equality of every output (the
   signature table and sig_scores included; K2 also with an all-rejecting
   and a 3-word tie stream); K1 also over 128 of the wave's pods and on
   crafted planes that reach each of its kernel instances and branches
   (runtime widths with node rows and records in shared memory or read
   from device memory; one-entry rows in registers; affinity tables in
   shared memory, read per pod, or one signature's entries per lane; planes
   aligned for 4-node vectors or one element off their allocation; with
   and without a rows map); K3 on that wave's dirty rows, on one of them
   and on a crafted set (a duplicate, indices past the end and a negative
   one) into planes that start one row past their allocation, every plane
   equal and the guard rows untouched; then time them (the kernels alone
   by torch.profiler, the plain versions by events): K1 at 8 signature
   rows, 128 rows and 512 pods, each beside an empty launch of its grid,
   its store floor (K1's 13 bytes per (row, node) written in K1's layout
   by a kernel that reads nothing) and its bytes over the card's rate;
   K3 on one, 4 and 128 rows and on the wave's dirty rows, each beside an
   empty launch of its grid;
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
   per measured pod (counts zeroed after the initial pods, read after the
   measured ones), and the zone skew must end <= 1; pods/s and the run
   phases' ms per pod (`wait`: K4 behind the result copy);
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
   of every output array at every cluster size (1, 2, 4, 8, 16 blocks per
   pod) and across them, on a TopologySpreading pod, a SchedulingBasic
   pod, pods with every IPA term kind on phase 8's cluster, a pod that fits
   nowhere, three pods in one launch, and (--k4-buckets) empty clusters of
   5, 9000 and 17000 nodes (buckets of 8, 16384 and 32768 rows); then K4
   timed at every cluster size beside its plain version on the first
   three and, on the first, thread 0's clock split by phase and the
   latency floor (the same counted barriers, folds, exchanges and table
   folds with no node work);
10. the card against the CPU plain path through schedule_pod on mixed
   clusters of 16 to 1500 nodes with hard spread and IPA: equal results,
   equal final rng state, equal FitError messages;
11. K5 against its plain version at full width: the SchedulingBasic
   cluster with 1000 initial pods placed through waves, gangs of 4, 32 and
   128 default pods in Required (8 zone rows) and Preferred (9 -> 16 rows)
   mode, a gang no zone holds and a 3-word tie stream; every element of
   the packed output equal, and K1 on each gang equal to its plain
   version; K5 (and K1 on the gang) timed;
12. the gang path through try_gang_wave at gang.yaml's published shapes:
   GangSchedulingTopologyRequired/500Nodes and
   GangSchedulingTopologyPreferred/500Nodes (100 PodGroups of 4), then 16
   gangs of 128 on 5000 nodes in Required mode, each gang's hosts assumed
   before the next; every gang placed whole, each Required gang in one
   zone, every member counted on the device side (counts zeroed before
   each cell, read after); gang pods/s and ms per gang by phase; K1 on
   each cell's gang beside its floors as in phase 4;
13. the card against the CPU plain path through try_gang_wave on a
   600-node mixed cluster (hard spread, inter-pod affinity and host ports
   among the members): equal hosts, winning rows, outcomes and rng state;
(run after phase 5, as they reuse phase 3's results)
14. the main path as the reference runs it by default: a fresh
   SchedulingBasic cache, the same 1000 + 10000 pods through
   kubernetes_tpu_torch/testing/pipeline.py at depth 2 (launch_batched
   chained on the device carry, collect one wave behind, K2 seeded across
   waves and reading its tie cursor on the device), the published traffic
   unchanged; every pod must land with phase 3's bindings and rng state,
   with chained launches and cross-wave hits; K1-K3 counted (zeroed
   before the initial pods, read after the last collect; K1 and K2 must
   have launched; K3 runs only where the carry is dropped and the mirror
   repays its debt, which this traffic does not cause); then the carry
   is dropped and the mirror checked against host truth; pods/s, host
   seconds per launch/collect phase, each wave's launch and collect-wait
   ms;
15. K2 with the cross-wave seed against its plain version at full width,
   on a wave chained on phase 14's carry and resident table (the natural
   slot map and a crafted one: a hit, a miss, a rotation; a device cursor
   with frame shift 5): every output equal; K2 timed with and without the
   seed;
16. the card against the CPU plain path through the pipelined loop on
   mixed clusters of 16 to 1500 nodes (hard spread, IPA) with events
   mid-stream (a node change, churn deletes, a host revert, a 3-word
   all-ones tie frame): equal bindings, rng state, xwave_* counters and
   loop outcomes;
17. K6 (sharded_assign: the scan over n node shards, one block of a
   thread-block cluster each) at every --mesh-shards count against K2 and
   at the largest against its plain version on the card, on phase 4's
   SchedulingBasic wave, phase 7's TopologySpreading wave, phase 8's IPA
   wave (dedup on) and phase 15's chained, seeded wave: every output
   equal; K6 timed per shard count beside K2;
18. the mesh main path: phase 14's run (the same 1000 + 10000 pods through
   WavePipeline at depth 2) over TorchBackend(context=MeshContext(
   scheduler_mesh(8))): bindings and rng equal to phase 3's, K1 and K6
   launched (counts zeroed before, read after), K2 not; pods/s beside
   phase 14's, per-wave launch and collect-wait ms;
19. K7 (wave_fit_and_score, the pods x nodes matrix) at dryrun_multichip's
   shape: 5000 nodes, 512 pods with a zone hard spread, on a (wave 2,
   nodes 4) mesh: equal to its plain version and row by row to K4, and at
   1, 2 and 4 blocks per pod equal to the plain version, each timed beside
   its latency floor; then
   the same pods through sharded_batched_assign (8 shards) equal to
   batched_assign on every output, all placed;
20. the scan step's latency: nvcc's -Xptxas -v registers, spills and shared
   memory for every instance of assign_scan_kernel, gang_assign_kernel,
   sharded_assign_kernel and fit_and_score_kernel; K2's microseconds per
   step on phase 4's, 7's, 8's
   and 15's waves (their tiers beside), K5's per member at each --k5-sizes
   gang, Required and Preferred (phase 11's), and K6's on phase 15's wave at
   the largest shard count; beside each, the latency floor: a kernel that
   makes the scan's counted barriers, folds, cluster barriers, exchanges
   and tie picks (the scan reports them) over the same steps with no node
   work (scan_floor, csrc/assign_scan.cu);
21. the host tier around K4 and K5, each part run on the card and with
   device="cpu" in the same call, the card's decisions (bindings, counts,
   rotation index, rng state, FitError messages) equal to the CPU's:
   (a) SchedulingNodeDeclaredFeatures/1000Nodes (500 plain nodes, 500
   labelled node-class: featured declaring NUMAAlignment; 1000 pods of
   500m requiring it) one pod at a time through schedule_pod (K4 and the
   host NodeDeclaredFeatures tail, the hybrid route) with an assume and a
   snapshot update after each: every pod on a featured node,
   kernel_count +1000, fallback_count +0, K4 launched once per pod;
   pods/s and ms per pod split into run (K4) and the host stage
   (--ndf-cpu-pods cuts the CPU run's pods, never the nodes, and says so);
   (b) phase 2's 5000 nodes, each filled with a priority-0 pod of 31 CPU,
   four freed for priority-100 preemptors nominated onto them: pods that
   outrank every nomination (kernel route), pods of 31 CPU the
   nominations outrank (hybrid route, two-pass protection: none takes a
   nominee), the preemptors (nominee fast path, each on its nominee,
   fallback_count +1 each); (c) on that cluster, pods the extractor
   refuses (a hostIP port, 5 spread constraints) through the host
   algorithm, fallback_count counting exactly them; (d) gang.yaml's
   GangSchedulingTopologyRequired/500Nodes cluster (zone-3 declaring the
   feature) and its 100 PodGroups of 4 through PodGroupCycle on the device
   path (K1 + K5), one more gang with a member requiring the feature
   (declined by try_gang_wave, placed whole in zone-3 by the host cycle's
   per-member K4 runs on placement-narrowed snapshots) and one more plain
   gang;
22. the store-driven loop: (a) the same SchedulingBasic/5000Nodes_10000Pods
   (5000 nodes, 1000 initial + 10000 measured pods, seed 1, waves of 512)
   written into the port's Store and scheduled by the port's Scheduler
   (Profile(backend="tpu", wave_size=512): store -> informer ->
   SchedulingQueue -> ScheduleOneLoop's wave pipeline -> DefaultBinder's
   batched bind into the store) at KUBE_TPU_PIPELINE_DEPTH 1, at depth 2
   and at depth 2 over an 8-shard MeshContext (KUBE_TPU_MESH_DEVICES=8):
   every pod bound in the store with phase 3's bindings and final rng
   state, launch counts zeroed before the measured pods and read after
   (K1 and K2, or K1 and K6 on the mesh), measured pods/s with the card's
   name and power limit beside phases 3, 14 and 18's rates from this
   call, and the loop's phase_profile split; each run follows the
   stand-in (WavePipeline at the same depth and context, bindings equal to
   phase 3's) and prints the loop's own host cost per wave beside it; both
   run after a full collection with the earlier phases' objects frozen
   out of the collector (gc.freeze); (b) a mixed loop stream, the
   card against device="cpu": the golden bursts (three interleaved
   signatures) plain, with hard zone spread, and IPA-active on 8 shards,
   with node churn between bursts, bound-pod deletes, a gang trailer and
   capacity-exhaustion FitErrors: equal bindings, PodScheduled=False
   diagnoses and rng state, the K1-K6 launch counts printed;
23. the benchmark's cells: each cell of BENCHMARK.json
   (SchedulingBasic_5000Nodes_10000Pods, SchedulingNodeDeclaredFeatures_1000Nodes)
   once at full size through `python3 -m kubernetes_tpu_torch.perf.bench
   --cell NAME --seed S`, one process each (the scheduler_perf harness on
   the port's Scheduler): every pod bound and the bench's correctness check
   true, K1 and K2 launched in SchedulingBasic's measured span and K4 in
   NodeDeclaredFeatures'; pods/s, the loop's host us per pod by phase and
   the launches printed; a cell that does not end within --phase-timeout
   is stopped and fails the run;
24. DefaultPreemption: (a) scheduler_perf
   PreemptionAsync/5000Nodes_AsyncAPICallsEnabled (--preempt-workload) at
   full width through the port's WorkloadExecutor(wave_size=512) on the
   card: 5000 nodes, 20000 priority-0 victims of 3 CPU / 1Gi and
   priority-100 preemptors of 25 CPU / 2Gi, evictions on the async
   dispatcher; the preemptors cut from 5000 to --preempt-pods (1000: the
   host's cost per preemptor grows with the backlog, and the workload's
   5000 do not end within the run's limit); every preemptor bound, every
   evicted pod of lower priority than the preemptor on its node, no node
   over its CPU, memory or pod count; K4 launched at least once per preemptor and K1 and K2 launched
   in the measured span (counts zeroed where the harness starts
   collecting, read where it stops); preemptors/s beside upstream's
   threshold, PostFilter calls, candidates per call, nodes decided by the
   batched victim scan and by the per-node path, evictions, launches and
   the dry run's host ms per preemptor (DefaultPreemption's methods
   wrapped to count and time them); (b) PreemptionBasic/20Nodes and
   /500Nodes (--preempt-cpu-workloads; synchronous evictions) on the card
   and with device="cpu" on a virtual clock: bindings, nominations,
   evictions, rng state and kernel/fallback counts equal;
25. the storage, DRA and extender half of the host tier, through the
   port's StorageWorkloadExecutor (testing/storage_workloads.py) and
   Scheduler on the card: (a) SchedulingWFFCVolumes/5000Nodes_2000Pods at
   full size (5000 nodes, 2000 measured pods with a 5Gi
   WaitForFirstConsumer claim each over 10Gi volumes; node-neutral volume
   plans, so every pod on the wave route, K1 and K2 launched); (b)
   SchedulingCSIPVs/5000Nodes_5000Pods at full size (CSINode attach
   limits of 39; the hybrid route: K4 once per pod, K3); (c)
   SchedulingWithResourceClaims/5000pods_500nodes at full size (500 nodes
   of 10 devices, 2500 initial and 2500 measured pods; the hybrid route
   with DynamicResources' allocation); (d) an extender stream over 500
   nodes: 1024 pods in blocks of 64,
   every other block interested in an in-process extender with
   HTTPExtender's interface (filter, prioritize; a second run as binder);
   (e) volumes.json's and dra.json's short workloads and (d) at 256 pods
   over 40 nodes, on the card and with device="cpu" on
   the virtual clock: bindings, volume bindings, device allocations and
   rng equal. Every run is checked from the store (every pod bound, every
   claim bound to one volume of its class, access modes and capacity, no
   volume bound twice, no node over its CSI attach limit, every allocated
   device on its pod's node and none allocated twice); each prints
   pods/s, K1-K4's launches in its measured span and the pods by route
   (wave, hybrid, kernel, host);
26. the telemetry the loop and the backend write (the wave recorder's
   records, the pod latency ledger, the stall profiler, the device
   telemetry, SchedulerMetrics and the tracer): (a) phase 22's
   SchedulingBasic/5000Nodes_10000Pods through the port's Scheduler at
   depth 2 with async API calls, once with every part on (a
   SchedulerMetrics, a tracer with an in-memory exporter) and once with
   every part off (the ledger, profiler and device telemetry disabled, no
   metrics, no tracer): bindings and rng equal, K1 and K2 launched in each
   measured span (counts zeroed before, read after); pods/s of both, the
   wave records, wave-size histogram, pipeline_overlap_ratio, the ledger's
   per-segment p50/p99, the stall coverage and guilty reason, transfer
   bytes by plane and direction, compiles and their seconds per kernel,
   and the ledger's memory watermark beside torch.cuda.max_memory_allocated;
   (b) SchedulingNodeDeclaredFeatures/1000Nodes through the Scheduler
   with metrics on and every part off, then once more with a probe that
   counts and times every Framework._timed call: bindings and rng equal,
   K4 launched once per pod; the host tail split by extension point and
   plugin, the sampled histogram sums scaled by their sample share
   (samples over calls) beside the probe's every-call times; (c)
   GangSchedulingTopologyRequired/500Nodes (100 PodGroups of 4) through
   the Scheduler: a "device:" gang record per group, K5 launched per
   group, the recorder's gang pods all on the device side; then the
   golden bursts with the tpu.launch point armed (three flakes open the
   breaker) and with the tpu.collect point armed after one clean collect
   (records closed with "injected: ..."): every pod bound, the breaker
   opened, fallback/<plugin> time in the recorder; (d) short
   SchedulingBasic, NDF and gang workloads on the card and with
   device="cpu": every non-timing field of every wave record, each pod's
   ledger edge sequence, the plugin observations per (plugin, extension
   point) and the compiles per kernel equal;
27. the restart path: (a) SchedulingBasic's cluster with its initial pods
   already bound and a backlog of RESTART_WAVES waves, through a
   Scheduler started cold and warm (warm_start=True: the libraries
   loaded, K1-K5 launched at every static configuration the waves meet),
   each in a fresh process (cold, warm, warm, cold, and a warm one whose
   backlog arrives after start(); the processes start and import at once
   and then run one at a time), so every first use is paid in the run
   that counts it: start() seconds, start() to the first bind, the first
   uses at start and in all, compile_count_since_warm() after the waves,
   the warmup's launches and summary; every warm run skips nothing, every
   warm run with its backlog pending at start() meets no first use after
   its warmup, and every run binds alike and leaves the same rng; (b)
   CRASH armed at loop.wave on the measured pods' CRASH_WAVE-th wave, then
   a fresh Scheduler(warm_start=True) over the same store: its reconcile
   stats, every pod bound exactly once (a bind ledger on the store), no
   node past its cpu, memory or pod count; the same run at --loop-nodes
   nodes, and two crashes that leave state on the crashed instance, which
   then reconciles itself (loop.bind_commit on a SchedulingBasic stream:
   the landed binds adopted; gang.permit on
   PodGroups of 4 with Required zone topology: the assumed members
   forgotten and requeued, their permit quorum entries reverted), each on
   the card and with device="cpu": equal bindings, stats, restart records
   and rng, every sweep expected to act having acted; (c) two FleetMembers
   over one store and one card, each Scheduler with its own TorchBackend,
   in two threads: member 1 crashes after FLEET_CRASH_WAVES waves and
   member 0 adopts its shard when the lease (FLEET_LEASE s) expires:
   pods/s, failover latency, shard_adopt_ records, each member's launches
   (kernels.thread_launches), every pod bound once, member 0's device
   mirror equal to its host planes;
   phases 6, 9, 10, 17-22, 24 (b), each of 25 (a)-(e), of 26 (a)-(d) and
   of 27 (a)-(c) run under a watchdog (--phase-timeout; 24 (a) under --preempt-timeout) that
   fails the run when a phase does not end, as a kernel hung at a cluster
   barrier would; every phase that builds a TorchSchedulingAlgorithm
   fails if its gang planner met an error (a failed K1/K5 build or launch
   raises on the card; on the CPU the group would go to the host cycle);
then print the card, the timings, the kernels line (K1 and K2 with their
launches on the pipelined main path, K2 at its seeded shape; K3 with its
launches on phase 6's single-pod path, where each assume dirties one
mirror row and K3 launches most, at that path's one-row shape; K6 with its launches
on the mesh main path, at 8 shards on the chained seeded wave; K7 with
its launch in phase 19) and the result line.

It imports nothing of the reference JAX package and never imports jax.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import torch


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


class watchdog:
    """A phase that has not ended after `seconds` fails the run: a kernel
    whose blocks wait at a cluster barrier one of them skipped never
    returns, and torch.cuda.synchronize() would wait for ever. The process
    exits (code 3) from the timer's thread."""

    def __init__(self, label: str, seconds: float):
        self.label, self.seconds = label, seconds

    def _fire(self):
        print(f"chip_smoke: FAIL: {self.label} did not end within {self.seconds:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(3)

    def __enter__(self):
        self.timer = threading.Timer(self.seconds, self._fire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()
        return False


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


def kernel_ms(fn, kernel: str, reps: int) -> float:
    """Median device duration of the CUDA kernel named `kernel` over `reps`
    calls of fn(), from a torch.profiler (CUPTI) trace: the kernel alone,
    without the wrapper's host time that CUDA events around the call
    include."""
    return kernels_ms(fn, (kernel,), reps)[kernel]


def kernels_ms(fn, names, reps: int) -> dict:
    """Median device duration of each named CUDA kernel over calls of fn(),
    from torch.profiler (CUPTI) traces. The H100's traces lose kernel
    records: a trace of a few calls may keep 2 of 3 launches of a kernel,
    or none, while it holds every cudaLaunchKernel. So the records of up
    to four traces, of reps, 4 reps, 16 reps and 64 reps calls, are pooled
    until every name has one. A name none of them holds is timed with CUDA
    events instead: the whole call less the traced kernels is booked to
    the first such name and 0 to the others, and the line says so (the
    launch counts say whether each kernel ran)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for n_calls in (reps, 4 * reps, 16 * reps, 64 * reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        for name in names:
            times[name] += [e.time_range.elapsed_us() / 1e3 for e in events if name in e.name]
        missing = sorted(name for name in names if not times[name])
        if not missing:
            break
        print(f"profiler trace of {n_calls} calls lacks {missing}; it holds "
              f"{sorted({e.name for e in events})[:8]}", flush=True)
    out = {name: sorted(t)[len(t) // 2] for name, t in times.items() if t}
    if missing:
        whole = time_ms(fn, 4 * reps)
        rest = max(whole - sum(out.values()), 0.0)
        print(f"the profiler traces hold no record of {missing}: CUDA events around the "
              f"whole call give {whole:.4f} ms; {rest:.4f} ms of it, less the traced "
              f"kernels, is booked to {missing[0]}", flush=True)
        out.update({name: 0.0 for name in missing})
        out[missing[0]] = rest
    return out


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_abs_err(pairs) -> float:
    """Largest |kernel - plain| over every element of every output pair."""
    return max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def default_framework(names, plugin_args=None, handle=None):
    """The port's default scheduling profile (plugins in the reference's
    order and weights) over a cluster's resource names."""
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins import DEFAULT_WEIGHTS, default_plugins

    return Framework(default_plugins(names, args=plugin_args or {}), dict(DEFAULT_WEIGHTS),
                     handle=handle)


def place_waves(backend, cache, snap, pods, wave, rng, label, bindings=None):
    """run_batched in waves of `wave`, assuming winners between waves as the
    scheduling loop does; returns the wall seconds of each wave
    (run_batched ends in a device-to-host copy, so each wave's time
    includes its kernels). Each pod's node goes into `bindings`."""
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
            if bindings is not None:
                bindings[pod.meta.key] = node
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
    sig, uniq, _ = backend._group_wave(rows, len(pods))
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


def k1_compare(label, dp, dt, packed_f, layout, rows=None):
    """K1 against its plain version on the card on the same inputs: every
    output exactly equal. Returns max |K1 - plain|."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features

    got = kernels.static_parts(dp, dt, packed_f, layout, rows=rows)
    f = unpack_features(packed_f if rows is None else packed_f[rows.long()], layout)
    want = kernels.static_parts_ref(dp, dt, f)
    torch.cuda.synchronize()
    for k in want:
        if not torch.equal(got[k], want[k]):
            fail(f"static_parts.{k} differs from its plain version ({label})")
    return max_abs_err((got[k], want[k]) for k in want)


def k1_shape(label, dp, dt, packed_f, layout, rows=None, reps=20):
    """K1 at one shape: its profiler time beside an empty launch of its
    grid, the store floor (a kernel that writes K1's 13 bytes per (row,
    node) in K1's layout and reads nothing) and its bytes over the card's
    rate (the node planes and tables read once, the feature rows, the
    outputs written once)."""
    from kubernetes_tpu_torch.ops import cuda, kernels

    out = kernels.static_parts(dp, dt, packed_f, layout, rows=rows)
    n_out, nb = out["static_ok"].shape
    plan = kernels.static_plan(n_out, nb, dp["taints"].shape[1], dp["prefer_taints"].shape[1],
                               dp["port_words"].shape[1], dp["image_kib"].shape[1],
                               *dt["aff_match"].shape)
    stream = torch.cuda.current_stream().cuda_stream
    ms = kernel_ms(lambda: kernels.static_parts(dp, dt, packed_f, layout, rows=rows),
                   "static_parts_kernel", reps)
    empty = kernel_ms(lambda: cuda.launch_empty("static_parts", plan.grid, plan.threads,
                                                stream), "empty_kernel", 50)
    store = kernel_ms(lambda: kernels.static_store_floor(out), "static_store_floor_kernel",
                      reps)
    b = (nbytes(*(dp[k] for k in ("valid", "unsched", "group_id", "taints",
                                   "prefer_taints", "port_words", "image_kib")))
         + nbytes(*dt.values()) + n_out * packed_f.shape[1] * 4
         + (nbytes(rows) if rows is not None else 0) + nbytes(*out.values()))
    out_bytes = nbytes(out["static_ok"], out["taint_cnt"], out["aff_raw"], out["img"])
    bd, by = bound_ms(b, 0)
    A, G = dt["aff_match"].shape
    inst = ("runtime widths" if not plan.mw else f"rows of {plan.mw} in registers") + (
        ", tables in shared memory" if plan.tab else
        ", one signature's entries in registers" if A == 1 else ", tables per pod")
    print(f"static_parts at {label} ({n_out} x {nb}; {inst}, A x G {A} x {G}): {ms:.5f} ms; "
          f"empty launch of its grid {plan.grid} x {plan.threads} threads {empty:.5f} ms; "
          f"store floor "
          f"{store:.5f} ms; bound {bd:.5f} ms by {by} ({b} bytes; outputs alone "
          f"{bound_ms(out_bytes, 0)[0]:.5f} ms)")
    return {"ms": ms, "empty_ms": empty, "store_ms": store, "bound_ms": bd, "bytes": b}


def _one_off(t):
    """t's copy one element past a fresh allocation: a pointer no 4-node
    vector load or store may take."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


# (T, Tp, W, I, A, G, planes one element off): runtime widths with node rows
# and records in shared memory and tables staged; tables per pod; node rows
# from device memory; rows and records from device memory; unaligned
# planes (no 4-node vectors); one-entry rows in registers with the tables
# staged, one signature's entries per lane, tables per pod, and unaligned
# with one signature or staged tables (tests/test_torch_static_scatter.py
# holds the plan of each against the instance it names)
K1_CRAFTED = ((8, 16, 4, 8, 4, 64, False), (2, 2, 1, 2, 3, 2048, False),
              (200, 3, 2, 2, 2, 16, False), (4096, 4096, 4096, 2, 2, 16, False),
              (3, 2, 2, 3, 2, 16, True), (1, 1, 1, 1, 4, 64, False),
              (1, 1, 1, 1, 1, 8192, False), (1, 1, 1, 1, 3, 2048, False),
              (1, 1, 1, 1, 1, 8192, True), (1, 1, 1, 1, 4, 64, True))


def k1_crafted(seed):
    """K1 against its plain version on crafted planes (K1_CRAFTED) that
    reach every kernel instance of csrc/static_parts.cu and the branches
    inside them: 1000 nodes in a 1024-row bucket, 37 pods (a ragged last
    chunk), with and without a rows map of 16 rows. Returns max |K1 -
    plain|."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import pack_features, planes_from_reference

    rng = np.random.default_rng(seed)
    nb, n, P = 1024, 1000, 37
    err = 0.0
    for T, Tp, W, I, A, G, off in K1_CRAFTED:
        live = np.arange(nb) < n

        def ids(width):
            return np.where(live[:, None] & (rng.random((nb, width)) < 0.3),
                            rng.integers(0, width, (nb, width)), -1).astype(np.int32)

        planes = {
            "valid": live & (rng.random(nb) < 0.95), "unsched": rng.random(nb) < 0.05,
            "group_id": rng.integers(0, G, nb).astype(np.int32), "taints": ids(T),
            "prefer_taints": ids(Tp),
            "port_words": (rng.integers(0, 2**32, (nb, W), dtype=np.uint64)
                           & rng.integers(0, 2**32, (nb, W), dtype=np.uint64)).astype(np.uint32),
            "image_kib": np.where(rng.random((nb, I)) < 0.5,
                                  rng.integers(0, 2 << 20, (nb, I)), 0).astype(np.int32),
        }
        tables = {
            "aff_match": rng.random((A, G)) < 0.8, "aff_pref": rng.integers(0, 100, (A, G)).astype(np.int32),
            "aff_allow": rng.random((A, nb)) < 0.9, "aff_has_pref": rng.random(A) < 0.5,
        }
        feats = {
            "tol_unsched": rng.random(P) < 0.5,
            "name_idx": np.where(rng.random(P) < 0.1, rng.integers(0, n, P), -1).astype(np.int32),
            "aff_pin": np.where(rng.random(P) < 0.1, rng.integers(0, n, P), -1).astype(np.int32),
            "tol": rng.random((P, T)) < 0.5, "aff_sig": rng.integers(0, A, P).astype(np.int32),
            "ports": (rng.integers(0, 2**32, (P, W), dtype=np.uint64)
                      & rng.integers(0, 2**32, (P, W), dtype=np.uint64)).astype(np.uint32),
            "has_ports": rng.random(P) < 0.5, "tol_prefer": rng.random((P, Tp)) < 0.5,
            "img_idx": np.where(rng.random((P, 8)) < 0.4, rng.integers(0, I, (P, 8)), -1
                                ).astype(np.int32),
            "num_containers": rng.integers(1, 4, P).astype(np.int32),
        }
        packed, layout = pack_features(feats)
        dp = planes_from_reference(planes, "cuda")
        dt = planes_from_reference(tables, "cuda")
        packed_f = torch.from_numpy(packed).cuda()
        if off:
            dp = {k: _one_off(v) for k, v in dp.items()}
            dt = {k: _one_off(v) for k, v in dt.items()}
            packed_f = _one_off(packed_f)
        rows = torch.from_numpy(rng.choice(P, 16, replace=False).astype(np.int32)).cuda()
        label = (f"crafted T {T} Tp {Tp} W {W} I {I}, A x G {A} x {G}"
                 + (", planes one element off" if off else ""))
        for r in (None, rows):
            err = max(err, k1_compare(f"{label}, rows map {r is not None}", dp, dt, packed_f,
                                      layout, rows=r))
        plan = kernels.static_plan(P, nb, T, Tp, W, I, A, G)
        print(f"static_parts {label}: equal to its plain version with and without a rows "
              f"map (mw {plan.mw}, tables in shared memory {plan.tab}, pitch {plan.pitch}, "
              f"record ints {plan.rec})")
    return err


def k3_compare(label, dst, rows, idx, base=None):
    """K3 against its plain version on the card: every plane exactly equal.
    With base (and dst None) each plane is a copy of base's inside a buffer
    with a guard row before and after it, so the plane's rows start one row
    off the allocation (unaligned for the byte planes); the guards must
    come through untouched. Returns max |K3 - plain|."""
    from kubernetes_tpu_torch.ops import kernels

    guarded = {}
    if base is not None:
        dst = {}
        for k, t in base.items():
            buf = torch.full((t.shape[0] + 2,) + tuple(t.shape[1:]), 7, dtype=t.dtype,
                             device=t.device)
            buf[1:-1] = t
            guarded[k] = buf
            dst[k] = buf[1:-1]
    want = {k: v.clone() for k, v in dst.items()}
    kernels.scatter_rows(dst, rows, idx)
    kernels.scatter_rows_ref(want, rows, idx)
    torch.cuda.synchronize()
    for k in dst:
        if not torch.equal(dst[k], want[k]):
            fail(f"scatter_rows plane {k} differs from its plain version ({label})")
        if k in guarded and not (torch.equal(guarded[k][0], torch.full_like(guarded[k][0], 7))
                                 and torch.equal(guarded[k][-1],
                                                 torch.full_like(guarded[k][-1], 7))):
            fail(f"scatter_rows wrote outside plane {k} ({label})")
    return max_abs_err((dst[k], want[k]) for k in dst)


def k3_shape(label, dst, rows, idx, reps=50):
    """K3 at one shape: its profiler time beside an empty launch of its
    grid, and its bytes over the card's rate (the index and the rows read
    once, the rows written once)."""
    from kubernetes_tpu_torch.ops import cuda, kernels

    plan = kernels.scatter_plan(dst, rows, idx.numel())
    stream = torch.cuda.current_stream().cuda_stream
    ms = kernel_ms(lambda: kernels.scatter_rows(dst, rows, idx), "scatter_rows_kernel", reps)
    empty = kernel_ms(lambda: cuda.launch_empty("scatter_rows", plan.grid, plan.threads,
                                                stream), "empty_kernel", 50)
    bd, by = bound_ms(nbytes(idx) + 2 * nbytes(*rows.values()), 0)
    print(f"scatter_rows on {label}: {ms:.5f} ms; empty launch of its grid {plan.grid} x "
          f"{plan.threads} threads {empty:.5f} ms; bound {bd:.6f} ms by {by}; "
          f"{plan.n_threads} threads")
    return {"ms": ms, "empty_ms": empty, "bound_ms": bd, "bound_by": by}


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


def build_parser() -> argparse.ArgumentParser:
    """chip_smoke's arguments; their defaults are the run's full sizes (the
    tools that run one phase alone take them from here)."""
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
    # phase 9: K4 on clusters of these node counts (buckets of 8, 16384 and
    # 32768 rows) besides the full-width cases
    ap.add_argument("--k4-buckets", default="5,9000,17000")
    # phases 11-13: K5 at full width, gang.yaml's cells, the card vs the CPU
    ap.add_argument("--k5-nodes", type=int, default=5000)
    ap.add_argument("--k5-sizes", default="4,32,128")
    ap.add_argument("--gang-nodes", type=int, default=500)
    ap.add_argument("--gang-groups", type=int, default=100)
    ap.add_argument("--big-gang-nodes", type=int, default=5000)
    ap.add_argument("--big-gang-groups", type=int, default=16)
    ap.add_argument("--big-gang-size", type=int, default=128)
    ap.add_argument("--mixed-gang-nodes", type=int, default=600)
    ap.add_argument("--mixed-gangs", type=int, default=24)
    # phase 16: how many pipelined card-vs-CPU clusters (16, 64, 300, 1500)
    ap.add_argument("--pipe-cases", type=int, default=4)
    # phases 17-19: K6's shard counts (K6 vs K2 at each, vs its plain
    # version at the largest, which phase 18's mesh main path runs); K7's
    # matrix at dryrun_multichip's shape
    ap.add_argument("--mesh-shards", default="1,2,4,8")
    ap.add_argument("--matrix-nodes", type=int, default=5000)
    ap.add_argument("--matrix-pods", type=int, default=512)
    # phase 21: SchedulingNodeDeclaredFeatures/1000Nodes (half the nodes
    # featured) and its measured pods; the CPU comparison run's pod count
    # (cut only if the CPU run does not fit the phase's time)
    ap.add_argument("--ndf-nodes", type=int, default=1000)
    ap.add_argument("--ndf-pods", type=int, default=1000)
    ap.add_argument("--ndf-cpu-pods", type=int, default=1000)
    # phase 22 (b): the mixed loop stream's cluster (4 zones of 4-CPU nodes)
    ap.add_argument("--loop-nodes", type=int, default=40)
    # phase 24: the full-width preemption workload, and the workloads run
    # on the card and on the CPU (comma-separated, misc.json's names)
    ap.add_argument("--preempt-workload", default="PreemptionAsync/5000Nodes_AsyncAPICallsEnabled")
    # its preemptors, cut from the workload's 5000: the host cost per
    # preemptor grows with the backlog (tools/preemption_scaling.py), and
    # 2000 already take more than 300 s (PERF.md §5m)
    ap.add_argument("--preempt-pods", type=int, default=1000)
    ap.add_argument("--preempt-cpu-workloads",
                    default="PreemptionBasic/20Nodes,PreemptionBasic/500Nodes")
    # phase 24 (a) may run past --phase-timeout
    ap.add_argument("--preempt-timeout", type=float, default=600.0)
    # a phase that runs past this fails the run (a hung cluster barrier)
    ap.add_argument("--phase-timeout", type=float, default=420.0)
    # phase 27 (a)'s fresh process: one cold or warm start (JSON spec)
    ap.add_argument("--restart-child", default=None, help=argparse.SUPPRESS)
    return ap


def main() -> None:
    args = build_parser().parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA card")
    if args.restart_child is not None:
        restart_child_main(json.loads(args.restart_child))
        return
    sys.stdout.reconfigure(line_buffering=True)  # in order with stderr in one log

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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    serial_bindings = {}
    place_waves(backend, cache, snap, init, args.wave, rng, "main path", serial_bindings)
    tiers0 = backend.tier_steps.tolist()
    stats0 = dict(backend.dedup_stats)
    t1 = time.perf_counter()
    phase0 = dict(backend.phase_s)
    walls = place_waves(backend, cache, snap, measured, args.wave, rng, "main path",
                        serial_bindings)
    t2 = time.perf_counter()
    serial = {"bindings": serial_bindings, "rng": rng.getstate(),
              "pods_s": args.pods / (t2 - t1)}
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

    # K3 on the rows that wave's placements dirty, on one of them, and on a
    # crafted set (a duplicate, indices past the end and a negative one)
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
    err3 = k3_compare("the wave's dirty rows", k3, rows, idx)
    for k in k3:
        h = host[k].view("int32") if host[k].dtype.name == "uint32" else host[k]
        if not torch.equal(k3[k].cpu(), torch.from_numpy(np.ascontiguousarray(h))):
            fail(f"scattered plane {k} differs from the host plane")
    rows1, idx1 = {k: v[:1] for k, v in rows.items()}, idx[:1]
    err3 = max(err3, k3_compare("one row", {k: w.dp[k].clone() for k in SLICE_PLANES},
                                rows1, idx1))
    nb = planes.nb
    pick = np.array([idx_np[0], idx_np[1], idx_np[0], idx_np[2], idx_np[3], idx_np[2]],
                    np.int32)
    crafted = torch.tensor([idx_np[0], idx_np[1], idx_np[0], nb, -1, nb + 1000],
                           dtype=torch.int32, device="cuda")
    rows_c = planes_from_reference({k: host[k][pick] for k in SLICE_PLANES}, "cuda")
    err3 = max(err3, k3_compare("a duplicate, two indices past the end, a negative one",
                                None, rows_c, crafted,
                                base={k: w.dp[k] for k in SLICE_PLANES}))
    print(f"compare: static_parts, assign_scan (both tiers), scatter_rows equal to their "
          f"plain versions, tolerance 0 (exact; integer outputs) ({len(idx_np)} dirty rows; "
          f"K3 also on one row and on the crafted set, every plane)")

    # timings on the same inputs: K1 as the main path calls it (over the
    # signature rows), over 128 of the wave's pods (the gang path's widest
    # shape) and over every pod; K2 with dedup (the main path) and without;
    # K3 on one row (the single-pod path), on 4 and 128 rows (the gang
    # path's) and on the wave's dirty rows; each kernel beside the empty
    # launch of its grid, K1 also beside its store floor
    from kubernetes_tpu_torch.ops.planes import unpack_features

    f_sig = unpack_features(w.packed_f[w.uniq.long()], w.layout)
    packed128 = w.packed_f[:128].contiguous()
    err1 = max(err1, k1_compare("128 of the wave's pods", w.dp, w.dt, packed128, w.layout),
               k1_crafted(args.seed))
    k1_sig = k1_shape(f"{len(w.uniq)} signature rows", w.dp, w.dt, w.packed_f, w.layout,
                      rows=w.uniq)
    k1_shape("128 rows", w.dp, w.dt, packed128, w.layout)
    k1_shape(f"{args.wave} pods (dedup off)", w.dp, w.dt, w.packed_f, w.layout)
    ms1 = k1_sig["ms"]
    ms1p = time_ms(lambda: kernels.static_parts_ref(w.dp, w.dt, f_sig), 5)
    k2 = {dedup: time_k2("SchedulingBasic", w, out[dedup][0], words, out[dedup][1], dedup,
                         5 if dedup else 3) for dedup in (True, False)}
    k3_row = k3_shape("one row", k3, rows1, idx1)
    for n in (4, 128):
        k3_shape(f"{n} rows", k3, {k: v[:n] for k, v in rows.items()}, idx[:n])
    ms3 = k3_shape(f"the wave's {len(idx_np)} dirty rows", k3, rows, idx)["ms"]
    ms3_row = k3_row["ms"]
    ms3p_row = time_ms(lambda: kernels.scatter_rows_ref(k3, rows1, idx1), 20)
    b1 = k1_sig["bytes"]
    # estimate: each measured wave runs K1 + K2 and one K3
    busy = (ms1 + k2[True]["ms"] + ms3) * n_waves
    print(f"device busy share of the measured waves ((K1 + K2 + K3 kernel time) "
          f"x waves / wave wall): {busy / (sum(walls) * 1e3):.3f}")
    print(f"serial main path (run_batched) kernels: static_parts {ms1:.4f} ms, "
          f"assign_scan {k2[True]['ms']:.4f} ms, scatter_rows {ms3:.5f} ms; launches {launches}")

    cell4 = ("SchedulingBasic wave", w, out[True][0], words, 0,
             dict(sig_ids=w.sig, uniq_idx=w.uniq))

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

    # 14-16. streaming waves: the pipelined main path, seeded K2, card vs CPU
    a = pipelined_main_path(args, serial)
    seed = seeded_k2(args, a, ms1)
    pipeline_card_vs_cpu(args)
    rows_out = []
    for name, src, repl, err, ms, msp, (bd, by), (n, path) in (
        ("static_parts", "kubernetes_tpu_torch/ops/csrc/static_parts.cu",
         "kubernetes_tpu/ops/kernels.py:774", err1, ms1, ms1p, bound_ms(b1, 0),
         (a["launches"]["static_parts"], "the pipelined main path")),
        ("assign_scan", "kubernetes_tpu_torch/ops/csrc/assign_scan.cu",
         "kubernetes_tpu/ops/kernels.py:1369", max(err2, seed["max_abs_err"]),
         seed["ms"], seed["plain_ms"], (seed["bound_ms"], seed["bound_by"]),
         (a["launches"]["assign_scan"], "the pipelined main path")),
    ):
        rows_out.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                         "launches": n, "max_abs_err": err, "ms": ms,
                         "plain_ms": msp, "bound_ms": bd, "bound_by": by,
                         "library_ms": None})
        print(f"{name}: {ms:.4f} ms (plain {msp:.3f} ms, bound {bd:.5f} ms by {by}), "
              f"{n} launches on {path}")

    # 6-10. TopologySpreading (single-pod path, then waves), IPA, K4
    with watchdog("phase 6 (the single-pod cycle)", args.phase_timeout):
        launches6, state6 = topology_spreading(args)
    waves7 = spreading_waves(args)
    print(f"TopologySpreading measured pods/s: waves {waves7['pods_s']:.1f} "
          f"(run_batched alone {waves7['run_pods_s']:.1f}), single-pod path "
          f"{state6['pods_s']:.1f}")
    ipa8, cluster8, cell8 = ipa_wave(args)
    with watchdog("phase 9 (K4 against its plain version)", args.phase_timeout):
        k4 = k4_against_plain(args, state6, cluster8)
    with watchdog("phase 10 (the single-pod cycle, card vs CPU)", args.phase_timeout):
        cycle_card_vs_cpu(args)
    # K3 at the single-pod path's shape (one dirty row), where it launches most
    rows_out.append({"name": "scatter_rows", "route": "cuda",
                     "source": "kubernetes_tpu_torch/ops/csrc/scatter_rows.cu",
                     "replaces": "kubernetes_tpu/scheduler/tpu/backend.py:58",
                     "launches": launches6["scatter_rows"], "max_abs_err": err3,
                     "ms": ms3_row, "plain_ms": ms3p_row, "bound_ms": k3_row["bound_ms"],
                     "bound_by": k3_row["bound_by"], "library_ms": None})
    print(f"scatter_rows: {ms3_row:.5f} ms on one row (plain {ms3p_row:.3f} ms, bound "
          f"{k3_row['bound_ms']:.6f} ms by {k3_row['bound_by']}), "
          f"{launches6['scatter_rows']} launches on the single-pod path (phase 6), "
          f"{launches['scatter_rows']} on the serial main path (phase 3)")
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

    # 11-13. gang waves
    k5, cells11 = k5_against_plain(args)
    launches12 = gang_cells(args)
    gang_card_vs_cpu(args)
    rows_out.append({"name": "gang_assign", "route": "cuda",
                     "source": "kubernetes_tpu_torch/ops/csrc/gang_assign.cu",
                     "replaces": "kubernetes_tpu/ops/kernels.py:1472",
                     "launches": launches12["gang_assign"], **k5})

    # 17-19. node shards on one card: K6 against its plain version and K2,
    # the mesh main path, K7's matrix
    t_mesh = time.perf_counter()
    shards = sorted(int(n) for n in args.mesh_shards.split(","))
    with watchdog("phase 17 (K6 against its plain version and K2)", args.phase_timeout):
        k6 = k6_against_plain_and_k2(args, shards, [cell4, waves7["cell"], cell8,
                                                      seed["cell"]])
    with watchdog("phase 18 (the mesh main path)", args.phase_timeout):
        launches18, pods_s18 = mesh_main_path(args, serial, a, max(shards))
    with watchdog("phase 19 (K7, the pods x nodes matrix)", args.phase_timeout):
        k7 = wave_matrix(args, max(shards))
    with watchdog("phase 20 (the scan step's latency)", args.phase_timeout):
        step_latency(reports, [(cell4, k2[True]["ms"]), (waves7["cell"], waves7["k2"]["ms"]),
                               (cell8, ipa8["ms"]), (seed["cell"], seed["ms"])],
                     cells11, max(shards), k6["ms"])
    rows_out.append({"name": "sharded_assign", "route": "cuda",
                     "source": "kubernetes_tpu_torch/ops/csrc/sharded_assign.cu",
                     "replaces": "kubernetes_tpu/parallel/mesh.py:159",
                     "launches": launches18["sharded_assign"], **k6})
    rows_out.append({"name": "wave_fit_and_score", "route": "cuda",
                     "source": "kubernetes_tpu_torch/ops/csrc/fit_and_score.cu",
                     "replaces": "kubernetes_tpu/parallel/mesh.py:262", **k7})
    print(f"phases 17-20: {time.perf_counter() - t_mesh:.1f} s")
    with watchdog("phase 21 (the host tier)", args.phase_timeout):
        host_tier(args)
    with watchdog("phase 22 (the store-driven loop)", args.phase_timeout):
        store_loop(args, serial, {"phase 3 (serial run_batched)": serial["pods_s"],
                                  "phase 14 (WavePipeline, depth 2)": a["pods_s"],
                                  f"phase 18 (WavePipeline, {max(shards)} shards)": pods_s18},
                   smi)
    bench_cells(args)
    with watchdog("phase 24 (a) (DefaultPreemption at full width)", args.preempt_timeout):
        preemption_full_width(args, smi)
    with watchdog("phase 24 (b) (DefaultPreemption, the card against the CPU)",
                  args.phase_timeout):
        preemption_card_vs_cpu(args)
    storage_full_width(args, smi)
    with watchdog("phase 25 (e) (volumes, DRA and extenders, the card against the CPU)",
                  args.phase_timeout):
        storage_card_vs_cpu(args)
    telemetry_phase(args, smi)
    restart_phase(args, smi)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows_out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# --------------------------------------------------------------------------
# 14-16: streaming waves
# --------------------------------------------------------------------------


def run_pipelined(args, context=None, depth=2):
    """A fresh SchedulingBasic cluster; the initial pods, then the measured
    pods, all through WavePipeline at `depth` over a TorchBackend with
    `context` (None: the local one). Returns the state and the measured
    span's counters."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)
    from kubernetes_tpu_torch.testing.pipeline import WavePipeline
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    names = ResourceNames()
    cache = Cache(names)
    for i in range(args.nodes):
        cache.add_node(scheduling_basic_node(i, args.zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(names, device="cuda", context=context)
    algo = TorchSchedulingAlgorithm(default_framework(names), backend,
                                    rng=random.Random(args.seed))
    pipe = WavePipeline(backend, cache, snap, algo, depth=depth)
    init = [scheduling_basic_pod(i) for i in range(args.init_pods)]
    measured = [scheduling_basic_pod(args.init_pods + i) for i in range(args.pods)]
    pipe.schedule(init, args.wave)
    pipe0, drv0, stats0 = dict(backend.pipe_phase_s), dict(pipe.phase_s), dict(backend.dedup_stats)
    kinds0, log0 = dict(backend.pipe_stats), len(backend.wave_log)
    t1 = time.perf_counter()
    pipe.schedule(measured, args.wave)
    wall = time.perf_counter() - t1
    check_tier("the pipelined main path", algo)
    log = list(backend.wave_log)[log0:]
    return {"backend": backend, "cache": cache, "snap": snap, "pipe": pipe, "algo": algo,
            "wall_s": wall, "pods_s": args.pods / wall, "log": log,
            "phases": {k: v - pipe0[k] for k, v in backend.pipe_phase_s.items()},
            "loop": {k: v - drv0[k] for k, v in pipe.phase_s.items()},
            "kinds": {k: v - kinds0[k] for k, v in backend.pipe_stats.items()},
            "stats": {k: v - stats0[k] for k, v in backend.dedup_stats.items()}}


def pipelined_main_path(args, serial):
    """14 (a). The main path as the reference runs it by default
    (run_pipelined: each wave launched on the device carry before the
    previous one is collected; K2 seeded from the previous chained wave's
    signature table, its tie cursor read on the device). Every pod must
    land with the bindings and final rng state of phase 3's serial run;
    chained launches and cross-wave hits must occur, and no resync (the
    traffic changes nothing outside the waves). Counts are zeroed before
    the initial pods and read after the last collect; then the carry is
    dropped and the mirror must equal host truth. Returns the backend,
    cache and snapshot for phase 15, the launch counts, the measured
    waves' wall and their count."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_pod

    kernels.reset_launches()
    r = run_pipelined(args)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    backend, cache, snap, pipe = r["backend"], r["cache"], r["snap"], r["pipe"]
    # drop the carry: the mirror owes the carry's rows (a full put when they
    # pass half the cluster), after which it must equal host truth
    backend.invalidate_carry()
    planes = backend.sync(snap)
    dev_planes, _ = backend.device_inputs(planes)
    host = planes.as_dict()
    for k, t in dev_planes.items():
        h = torch.from_numpy(host[k].view("int32") if host[k].dtype.name == "uint32" else host[k])
        if not torch.equal(t.cpu(), h):
            fail(f"pipelined path: device plane {k} differs from the host plane")
    print(f"launches on the pipelined main path: {launches} (scatter_rows runs only "
          f"where the carry is dropped)")
    for k in ("static_parts", "assign_scan"):
        if launches[k] <= 0:
            fail(f"kernel {k} never launched on the pipelined main path")
    if cache.pod_count() != args.init_pods + args.pods or pipe.handed_back:
        fail(f"pipelined path: {cache.pod_count()} pods in the cache, "
             f"{len(pipe.handed_back)} handed back")
    if pipe.bindings != serial["bindings"]:
        diff = [k for k, v in serial["bindings"].items() if pipe.bindings.get(k) != v]
        fail(f"pipelined bindings differ from the serial run's on {len(diff)} pods "
             f"(first {diff[:3]})")
    if r["algo"].rng.getstate() != serial["rng"]:
        fail("pipelined final rng state differs from the serial run's")
    kinds, stats = r["kinds"], r["stats"]
    if kinds["chained"] <= 0 or stats["xwave_hits"] <= 0:
        fail(f"no chained launch or cross-wave hit on the measured waves: {kinds}, {stats}")
    if pipe.stats["resyncs"] or pipe.stats["fallback_waves"]:
        fail(f"the published traffic resynced or fell back: {pipe.stats}")
    log, phases, drv = r["log"], r["phases"], r["loop"]
    n_waves = len(log)
    print(f"pipelined main path: {cache.pod_count()} pods placed, bindings and rng equal "
          f"to the serial run's; measured {args.pods} pods in {n_waves} waves, "
          f"{r['wall_s']:.3f} s = {r['pods_s']:.1f} pods/s (serial run_batched, phase 3: "
          f"{serial['pods_s']:.1f} pods/s) incl. host assume + snapshot")
    print(f"measured launches {kinds}; cross-wave {stats}; upload {backend.upload_stats}; "
          f"loop {pipe.stats}")
    print("measured waves, host-clock seconds by launch/collect phase: "
          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + "; loop: " + ", ".join(f"{k} {v:.4f}" for k, v in drv.items()))
    print("ms per measured wave: "
          + ", ".join(f"{k} {v * 1e3 / n_waves:.3f}" for k, v in phases.items())
          + ", assume " + f"{drv['assume'] * 1e3 / n_waves:.3f}"
          + ", snapshot " + f"{drv['snapshot'] * 1e3 / n_waves:.3f}")
    print("per measured wave (chained, launch ms, collect wait ms): "
          + " ".join(f"({int(e['chained'])},{e['launch_s'] * 1e3:.2f},{e['wait_s'] * 1e3:.2f})"
                     for e in log))
    waits = sorted(e["wait_s"] for e in log)
    print(f"collect wait that remained per wave: median {waits[len(waits) // 2] * 1e3:.3f} ms, "
          f"max {waits[-1] * 1e3:.3f} ms, sum {sum(waits):.4f} s")
    # one more wave, collected, so phase 15 finds a live carry and table
    pipe.schedule([scheduling_basic_pod(2 * 10**6 + i) for i in range(args.wave)], args.wave)
    return {"backend": backend, "cache": cache, "snap": snap, "launches": launches,
            "wall_s": r["wall_s"], "pods_s": r["pods_s"], "waves": n_waves,
            "xwave_launches": kinds["xwave_launches"]}


def chained_inputs(backend, pods, snap, pad):
    """One wave's K2 inputs as a chained launch builds them: the carry over
    the mirror, the signature groups, and the resident table with this
    wave's slot map into it."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.ops.planes import (
        pack_features, pad_features, stack_features, unpack_features)

    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = pad_features(stack_features(
        [backend.extractor.features(p, planes) for p in pods]), pad)
    dp, dt = backend._overlay(backend._carry)
    rows, layout = pack_features(feats)
    sig, uniq, sig_bytes = backend._group_wave(rows, len(pods))
    cfg = backend.kernel_config(planes, feats)
    cmap = backend.sig_cache.lookup((cfg, planes.bucket_sizes, len(uniq)), sig_bytes, len(uniq))
    if cmap is None:
        fail("the chained wave's signatures found no resident table")
    packed_f = torch.from_numpy(rows).cuda()
    return SimpleNamespace(
        cfg=cfg, planes=planes, dp=dp, dt=dt, packed_f=packed_f, layout=layout,
        fv=unpack_features(packed_f, layout), sig=torch.from_numpy(sig).cuda(),
        uniq=torch.from_numpy(uniq).cuda(), logtab=backend._logtab,
        table=backend.sig_cache.table, cmap=cmap)


def seeded_k2(args, a, ms1):
    """15 (b). K2 with the cross-wave seed against its plain version at full
    width: a wave chained on phase 14's carry and resident table, with the
    natural slot map and a crafted one (a hit, a miss, a rotation), the
    cursor read from a device scalar minus a nonzero frame shift; every
    output equal, sig_table, sig_scores and tiers included. Then K2 timed
    with and without the seed on the same inputs."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_pod

    pods = [scheduling_basic_pod(3 * 10**6 + i) for i in range(args.wave)]
    w = chained_inputs(a["backend"], pods, a["snap"], args.wave)
    k1 = k1_call(w, True)
    frame = tie_words(args.seed + 7, 2 * args.wave)
    cursor = torch.tensor(37, dtype=torch.int32, device="cuda")
    g = len(w.cmap)
    crafted = np.arange(g, dtype=np.int32)
    crafted[2:] = np.roll(crafted[2:], -1)
    crafted[1] = -1
    err = 0.0
    outs = {}
    for label, cmap in (("natural", w.cmap), ("crafted", crafted)):
        cm = torch.from_numpy(cmap).cuda()
        kw = dict(sig_ids=w.sig, uniq_idx=w.uniq, frame_shift=5, carry_map=cm,
                  sig_table=w.table)
        got = kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout, frame, cursor,
                                  w.logtab, **kw)
        want = kernels.assign_scan_ref(w.cfg, w.dp, k1, w.fv, frame, cursor, w.logtab, **kw)
        torch.cuda.synchronize()
        gf, rf = dict(_flat(got)), dict(_flat(want))
        if gf.keys() != rf.keys():
            fail(f"seeded assign_scan outputs {sorted(gf)} vs plain {sorted(rf)}")
        for k in gf:
            if not torch.equal(gf[k], rf[k]):
                fail(f"seeded assign_scan {k} differs from its plain version ({label} map)")
        err = max(err, max_abs_err((gf[k], rf[k]) for k in gf))
        outs[label] = (cm, got)
        print(f"seeded K2 ({label} map {cmap.tolist()}): equal to its plain version on every "
              f"output; tiers [full, replay] {got['tiers'].tolist()}, cursor start 32, "
              f"consumed to {int(got['packed'][-2])}")
    cm, out = outs["natural"]
    seeded = dict(sig_ids=w.sig, uniq_idx=w.uniq, frame_shift=5, carry_map=cm,
                  sig_table=w.table)
    ms = kernel_ms(lambda: kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout, frame,
                                               cursor, w.logtab, **seeded),
                   "assign_scan_kernel", 5)
    ms_cold = kernel_ms(lambda: kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout,
                                                    frame, 32, w.logtab, sig_ids=w.sig,
                                                    uniq_idx=w.uniq),
                        "assign_scan_kernel", 5)
    plain = time_ms(lambda: kernels.assign_scan_ref(w.cfg, w.dp, k1, w.fv, frame, cursor,
                                                    w.logtab, **seeded), 1, warmup=0)
    table_b = nbytes(*w.table.values())
    b, ops = k2_work(w, k1, frame, out, True)
    bd, by = bound_ms(b + table_b + nbytes(cm, cursor), ops)
    seed_bd, _ = bound_ms(table_b + nbytes(cm) + nbytes(*out["sig_table"].values()), 0)
    print(f"assign_scan seeded (chained SchedulingBasic wave): {ms:.4f} ms, unseeded on the "
          f"same inputs {ms_cold:.4f} ms (plain {plain:.1f} ms, bound {bd:.5f} ms by {by}); "
          f"the seed alone: gathered table {table_b} bytes read, bound {seed_bd:.5f} ms by "
          f"bytes; seeded launches on the pipelined main path {a['xwave_launches']}")
    busy = (ms1 + ms) * a["waves"]
    print(f"device busy share of the pipelined measured waves ((K1 + seeded K2 kernel time) "
          f"x waves / wall): {busy / (a['wall_s'] * 1e3):.3f}")
    return {"ms": ms, "ms_unseeded": ms_cold, "plain_ms": plain, "bound_ms": bd,
            "bound_by": by, "max_abs_err": err,
            "cell": ("chained seeded SchedulingBasic wave", w, k1, frame, cursor, seeded)}


def pipeline_events(spec, pa, device, types, meta):
    """The mixed cluster through testing/pipeline.py at depth 2 with events
    mid-stream: a node grows (mark_external → NeedResync), bound pods are
    deleted, the host reverts one winner (its successor poisoned), and one
    launch gets a 3-word all-ones tie frame (overflow at collect); handed-
    back pods re-run one at a time. Returns what the card and the CPU must
    agree on."""
    import kubernetes_tpu_torch.scheduler.tpu.backend as tb
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods
    from kubernetes_tpu_torch.testing.pipeline import WavePipeline

    c = Cache(ResourceNames())
    nodes = build_nodes(spec, types, meta)
    for n in nodes:
        c.add_node(n)
    s = Snapshot()
    c.update_snapshot(s)
    b = tb.TorchBackend(c.names, plugin_args=pa, device=device)
    algo = tb.TorchSchedulingAlgorithm(default_framework(c.names, pa), b, rng=random.Random(3))
    pipe = WavePipeline(b, c, s, algo, depth=2)
    pods = build_pods(spec, types, meta)
    cut = [len(pods) // 4, len(pods) // 2, 3 * len(pods) // 4]

    def waves(chunk):
        for i in range(0, len(chunk), 24):
            pipe.submit(chunk[i: i + 24], 32)

    waves(pods[: cut[0]])
    n = nodes[3]
    c.add_node(types.Node(meta=n.meta, spec=n.spec, status=types.NodeStatus(
        capacity=dict(n.status.capacity), images=n.status.images,
        allocatable=dict(n.status.allocatable, cpu="64"))))
    pipe.external(poison=False)
    waves(pods[cut[0]: cut[1]])
    for pod in pods[:5]:
        if pipe.bindings.get(pod.meta.key):
            c.remove_pod(pod)
    pipe.external(poison=False)
    victim = pods[cut[1] + 1].meta.name
    pipe.reject = lambda pod, host: pod.meta.name == victim
    waves(pods[cut[1]: cut[2]])
    real, calls = tb.clone_tie_words, []

    def frame(rng, n_words):
        calls.append(n_words)
        return np.full(3, 0xFFFFFFFF, np.uint32) if len(calls) == 2 else real(rng, n_words)

    tb.clone_tie_words = frame
    try:
        waves(pods[cut[2]:])
        pipe.flush()
    finally:
        tb.clone_tie_words = real
    for pod in list(pipe.handed_back):
        pipe.schedule_one(pod)
    check_tier(f"pipelined mixed cluster on {device}", algo)
    return (pipe.bindings, algo.rng.getstate(),
            {k: v for k, v in b.dedup_stats.items() if k.startswith("xwave")},
            dict(pipe.stats), [p.meta.name for p in pipe.handed_back],
            b.tier_steps.tolist(), dict(b.pipe_stats))


def pipeline_card_vs_cpu(args):
    """16 (c). The card against the CPU plain path through the pipelined
    loop on mixed clusters of 16 to 1500 nodes (hard spread, IPA) with
    the events of pipeline_events: equal bindings, rng state, xwave_*
    counters, loop outcomes and handed-back pods."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import mixed_spec

    cases = [(mixed_spec(9, 16, 40, constraints=True), None),
             (mixed_spec(7, 64, 120, constraints=True), None),
             (mixed_spec(10, 300, 200, constraints=True), None),
             (mixed_spec(8, 1500, 240, constraints=True),
              {"NodeResourcesFit": {"strategy": "MostAllocated"}})][: args.pipe_cases]
    t0 = time.perf_counter()
    for spec, pa in cases:
        got = [pipeline_events(spec, pa, d, types, meta) for d in ("cuda", "cpu")]
        if got[0] != got[1]:
            which = [i for i, (x, y) in enumerate(zip(*got)) if x != y]
            fail(f"pipelined mixed cluster ({len(spec['nodes'])} nodes): card and CPU "
                 f"plain path disagree on result fields {which}")
        stats = got[0][3]
        print(f"pipelined mixed cluster, {len(spec['nodes'])} nodes: card == CPU plain path; "
              f"loop {stats}, handed back {len(got[0][4])}, {got[0][2]}, launches "
              f"{got[0][6]}")
    print(f"pipelined card vs CPU with events: {len(cases)} clusters, "
          f"{time.perf_counter() - t0:.1f} s")


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
    algo = TorchSchedulingAlgorithm(default_framework(names), backend,
                                    rng=random.Random(args.seed))
    print(f"TopologySpreading: {args.spread_nodes} nodes, {args.zones} zones, "
          f"{time.perf_counter() - t0:.1f} s")

    init = [scheduling_basic_pod(i) for i in range(args.spread_init)]
    measured = [topology_spreading_pod(i) for i in range(args.spread_pods)]
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
    kernels.reset_launches()  # the measured pods' launches alone
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
    print(f"launches on the single-pod path (the measured pods): {launches}")
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
    check_tier("phase 6", algo)
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
            "k2": time_k2("TopologySpreading", w, k1, words, out, True, 3),
            "cell": ("TopologySpreading wave", w, k1, words, 0,
                     dict(sig_ids=w.sig, uniq_idx=w.uniq))}


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
    return (time_k2("IPA wave", w, k1, words, out, True, 3), cluster,
            ("IPA wave", w, k1, words, 0, dict(sig_ids=w.sig, uniq_idx=w.uniq)))


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
    """Run K4 once for `pods` at every cluster size it has and its plain
    version for each pod on the card on the same inputs; every output array
    must be equal to the plain version's, and the packed outputs equal
    across the cluster sizes. Returns (max |kernel - plain|, feasible count
    of the first pod, inputs)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features

    case = _k4_case(backend, pods, snap)
    cfg, planes, dev_planes, dev_tables, packed_f, layout = case
    logtab = backend._logtab
    nf = len(kernels.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    f_views = unpack_features(packed_f, layout)
    want = [kernels.fit_and_score_ref(cfg, dev_planes, dev_tables, f_views, logtab, p)
            for p in range(len(pods))]
    err, feasible, first = 0.0, [], None
    names = ["fails", "feasible", "insufficient", "too_many_pods", "total"]
    for n in kernels.FIT_CLUSTERS:
        packed = kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f, layout, logtab,
                                       cluster=n)
        torch.cuda.synchronize()
        if first is None:
            first = packed
        elif not torch.equal(packed, first):
            fail(f"fit_and_score on a cluster of {n} differs from a cluster of "
                 f"{kernels.FIT_CLUSTERS[0]} ({label})")
        for p in range(len(pods)):
            got = kernels.unpack_fit_outputs(packed[p], planes.nb, nf, planes.r)
            pairs = [(got[k], want[p][k]) for k in names]
            pairs += [(got["per_plugin"][k], want[p]["per_plugin"][k])
                      for k in kernels.PLUGIN_NAMES]
            for (x, y), name in zip(pairs, names + list(kernels.PLUGIN_NAMES)):
                if not torch.equal(x, y):
                    fail(f"fit_and_score {name} differs from its plain version ({label}, "
                         f"pod {p}, cluster of {n})")
            err = max(err, max_abs_err(pairs))
            if n == kernels.FIT_CLUSTERS[0]:
                feasible.append(int(got["feasible"].sum()))
    print(f"K4 == plain ({label}) at clusters of {list(kernels.FIT_CLUSTERS)}, equal across "
          f"them: {planes.n} nodes, feasible {feasible}, "
          f"n_hard {cfg.n_hard} n_soft {cfg.n_soft} ipa aff/anti/pref "
          f"{cfg.n_ipa_aff}/{cfg.n_ipa_anti}/{cfg.n_ipa_pref} existing anti/pref "
          f"{int(cfg.ipa_existing_anti)}/{int(cfg.ipa_existing_pref)}")
    return err, feasible[0], case


def _k4_time(label, backend, case, reps=50):
    """Profiler ms of K4 on `case` at every cluster size, and the plain
    version's event ms: {cluster: ms}, plain ms."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features

    cfg, planes, dev_planes, dev_tables, packed_f, layout = case
    logtab = backend._logtab
    f_views = unpack_features(packed_f, layout)
    ms = {n: kernel_ms(lambda: kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f,
                                                     layout, logtab, cluster=n),
                       "fit_and_score_kernel", reps) for n in kernels.FIT_CLUSTERS}
    plain = time_ms(lambda: kernels.fit_and_score_ref(cfg, dev_planes, dev_tables, f_views,
                                                      logtab), 10)
    print(f"fit_and_score ({label}) profiler ms by cluster size: "
          + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()) + f"; plain {plain:.3f} ms")
    return ms, plain


def fit_split(syncs, ms):
    """K4's or K7's time split by phase: thread 0's clock cycles per phase
    (its view of the critical path; every thread meets it at the barriers)
    as shares of the measured time, with the counts."""
    from kubernetes_tpu_torch.ops import kernels

    sv = syncs.tolist()
    cyc = sv[kernels.FIT_COUNTS:]
    total = max(sum(cyc), 1)
    return ("by phase (us, thread 0's clock shares of the measured time): "
            + ", ".join(f"{name} {ms * 1e3 * c / total:.2f}"
                        for name, c in zip(kernels.FIT_PHASE_NAMES, cyc) if c)
            + f"; counted block barriers, folds, cluster barriers, exchanges, table folds, "
              f"table words {sv[:kernels.FIT_COUNTS]}")


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
    equality of every output at every cluster size (and across them): (a)
    a TopologySpreading measured pod on the final state, (b) a
    SchedulingBasic pod (system-default soft spread), (c) pods with every
    IPA term kind on phase 8's mixed cluster with existing (anti)affinity
    pods, taints, ports and images, (d) a pod that fits nowhere, (e) three
    of them in one launch (one cluster per pod), and a spread pod and a
    default pod on empty clusters of each --k4-buckets node count (every
    bucket size K4 may be handed, 8 rows to past 16384). Then K4 timed at every
    cluster size on (a), (b) and (c) beside the plain version, and on (a)
    thread 0's clock split by phase and the latency floor (fit_floor: the
    same counted barriers, folds, exchanges and table folds with no node
    work) at each size."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.planes import unpack_features
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import (
        make_pod, scheduling_basic_node, scheduling_basic_pod, topology_spreading_pod)

    backend, snap = state["backend"], state["snap"]
    err, n_feas, case_a = _k4_compare("a: TopologySpreading pod", backend,
                                      [topology_spreading_pod(10**6)], snap)
    if n_feas == 0:
        fail("the TopologySpreading compare pod fits nowhere")
    e, _, case_b = _k4_compare("b: SchedulingBasic pod", backend,
                               [scheduling_basic_pod(10**6)], snap)
    err = max(err, e)
    e, n_feas, _ = _k4_compare("d: fits nowhere", backend,
                               [make_pod("huge", cpu="100000", mem="50Mi")], snap)
    if n_feas:
        fail("the fits-nowhere pod found a node")
    err = max(err, e)
    # the pod grid dimension: three pods, one cluster each, one launch
    e, _, _ = _k4_compare("e: three pods in one launch", backend,
                          [topology_spreading_pod(10**6 + 1), scheduling_basic_pod(10**6 + 1),
                           make_pod("huge2", cpu="100000", mem="50Mi")], snap)
    err = max(err, e)

    # (c) phase 8's mixed cluster at full width with existing (anti)affinity pods
    mixed, msnap, spec, rest = cluster
    kinds, cases_c = set(), {}
    for pod in rest:
        s = spec["pods"][int(pod.meta.name[1:])]
        k = {kind for kind in ("aff", "anti", "pref", "hard") if s[kind]}
        if not k - kinds:
            continue
        kinds |= k
        e, _, case = _k4_compare(f"c: mixed {sorted(k)}", mixed, [pod], msnap)
        cases_c[str(sorted(k))] = (mixed, case)
        err = max(err, e)
    if not {"aff", "anti", "pref", "hard"} <= kinds:
        fail(f"the mixed compare pods lack IPA/spread kinds: {kinds}")

    # every bucket K4 may be handed: a few nodes up to past 16384 rows
    for n_nodes in (int(x) for x in args.k4_buckets.split(",") if x):
        bcache = Cache(ResourceNames())
        for i in range(n_nodes):
            bcache.add_node(scheduling_basic_node(i, args.zones))
        bsnap = Snapshot()
        bcache.update_snapshot(bsnap)
        e, n_feas, _ = _k4_compare(f"bucket of {n_nodes} nodes", TorchBackend(
            bcache.names, device="cuda"), [topology_spreading_pod(10**6 + 2),
                                           scheduling_basic_pod(10**6 + 2)], bsnap)
        if n_feas != n_nodes:
            fail(f"the spread pod fits {n_feas} of {n_nodes} empty nodes")
        err = max(err, e)

    # timings on (a)'s inputs, the main path's shape, at every cluster size;
    # (b) and (c) beside their plain versions
    cfg, planes, dev_planes, dev_tables, packed_f, layout = case_a
    logtab = backend._logtab
    f_views = unpack_features(packed_f, layout)
    ms = time_ms(lambda: kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f,
                                               layout, logtab), 50)
    by_c, ms_p = _k4_time("a: TopologySpreading pod", backend, case_a)
    ms_k = by_c[kernels.FIT_CLUSTER]
    _k4_time("b: SchedulingBasic pod", backend, case_b, 20)
    for label, (m_backend, m_case) in cases_c.items():
        _k4_time(f"c: mixed {label}", m_backend, m_case, 20)
    print(f"fit_and_score: event ms around the wrapper {ms:.4f}, profiler kernel ms "
          f"{ms_k:.4f} (a cluster of {kernels.FIT_CLUSTER}), plain {ms_p:.3f} ms")
    syncs = torch.zeros(kernels.FIT_SYNC_WORDS, dtype=torch.int32, device="cuda")
    for n in kernels.FIT_CLUSTERS:
        kernels.fit_and_score(cfg, dev_planes, dev_tables, packed_f, layout, logtab,
                              cluster=n, syncs=syncs)
        torch.cuda.synchronize()
        fl = kernel_ms(lambda: kernels.fit_floor(syncs, 1, n), "fit_floor_kernel", 20)
        print(f"K4 (a) on a cluster of {n}: {by_c[n] * 1e3:.2f} us; latency floor "
              f"{fl * 1e3:.2f} us; {fit_split(syncs, by_c[n])}")
        if n == kernels.FIT_CLUSTER:
            floor = fl
    nf = len(kernels.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    out_bytes = kernels.fit_output_bytes(planes.nb, nf, planes.r)[1]
    b4, f4 = k4_work(cfg, dev_planes, dev_tables, f_views, packed_f, out_bytes)
    bd, by = bound_ms(b4, f4)
    print(f"fit_and_score: {ms_k:.4f} ms (plain {ms_p:.3f} ms, bound {bd:.5f} ms by "
          f"{by}, {b4} bytes; latency floor {floor:.5f} ms)")
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
            algo = TorchSchedulingAlgorithm(default_framework(cache.names),
                                            TorchBackend(cache.names, device=device),
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
            check_tier(f"phase 10 on {device}", algo)
            results.append((got, algo.rng.getstate()))
        if results[0] != results[1]:
            fail(f"single-pod cycle, mixed {n_nodes} nodes: card and CPU plain "
                 "path disagree")
        errs = sum(1 for g in results[0][0] if g[0] == "FitError")
        print(f"single-pod cycle, mixed {n_nodes} nodes, {n_pods} pods: card == CPU "
              f"plain path ({n_pods - errs} placed, {errs} FitErrors)")


# --------------------------------------------------------------------------
# 11-13: gang waves
# --------------------------------------------------------------------------


def gang_cluster(n_nodes, zones, device, init_pods=0, wave=512, seed=1):
    """A SchedulingBasic-shaped cluster (the default node template, zones
    round-robin as scheduler_perf's createNodes) with `init_pods` default
    pods placed through run_batched, and the gang planner around it:
    (cache, snapshot, handle, framework, backend, algorithm)."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import Framework, Handle
    from kubernetes_tpu_torch.scheduler.plugins.topology_placement import (
        TopologyPlacementGenerator)
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    cache = Cache(ResourceNames())
    for i in range(n_nodes):
        cache.add_node(scheduling_basic_node(i, zones))
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(cache.names, device=device)
    handle = Handle(cache=cache, snapshot=snap)
    fw = Framework([TopologyPlacementGenerator()], handle=handle)
    algo = TorchSchedulingAlgorithm(fw, backend, rng=random.Random(seed))
    if init_pods:
        place_waves(backend, cache, snap, [scheduling_basic_pod(10**7 + i)
                                           for i in range(init_pods)],
                    wave, algo.rng, "gang cluster")
    return cache, snap, handle, fw, backend, algo


def admit(handle, group, pods):
    """A PodGroup and its members arrive: the object lookup and the cache's
    gang accounting learn them, as the reference's informer handlers do."""
    handle.store.add(group)
    handle.cache.pod_group_states.set_group(group)
    for pod in pods:
        handle.cache.pod_group_states.pod_added(group.meta.key, pod.meta.key)
    handle.cache.update_snapshot(handle.snapshot)


def assume_gang(handle, group, pods, hosts):
    for pod, node in zip(pods, hosts):
        handle.cache.assume_pod(pod, node)
        handle.cache.pod_group_states.pod_assumed(group.meta.key, pod.meta.key)
    handle.cache.update_snapshot(handle.snapshot)


def qpis(pods):
    from types import SimpleNamespace

    return [SimpleNamespace(pod=p) for p in pods]


def gang_inputs(backend, snap, pods, placements):
    """K5's inputs for one gang on the card, as run_gang builds them."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.ops.planes import (
        pack_features, pad_features, placement_masks, stack_features, unpack_features)
    from kubernetes_tpu_torch.ops.vocab import next_pow2

    for pod in pods:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = pad_features(stack_features([backend.extractor.features(p, planes) for p in pods]),
                         next_pow2(len(pods), floor=4))
    masks = placement_masks(planes, [list(p.node_names) for p in placements],
                            next_pow2(len(placements), floor=2))
    dp, dt = backend.device_inputs(planes)
    rows, layout = pack_features(feats)
    packed_f = torch.from_numpy(rows).cuda()
    return SimpleNamespace(
        cfg=backend.kernel_config(planes, feats), planes=planes, dp=dp, dt=dt,
        packed_f=packed_f, layout=layout, fv=unpack_features(packed_f, layout),
        masks=torch.from_numpy(masks).cuda(), logtab=backend._logtab)


def k5_call(g, k1, words, nc, hf, plain=False):
    from kubernetes_tpu_torch.ops import kernels

    if plain:
        return kernels.gang_assign_ref(g.cfg, g.dp, k1, g.fv, g.masks, words, g.logtab, nc, hf)
    return kernels.gang_assign(g.cfg, g.dp, k1, g.packed_f, g.layout, g.masks, words,
                               g.logtab, nc, hf)


def k5_work(g, k1, words, out, n_real):
    """(bytes, float32 operations, bytes reckoned per row) K5 must spend on
    this gang: every input read once (the planes it reads, K1's rows of the
    active members, the features, masks, tie words and log table) and the
    packed output written once; each row's carry is the kernel's own
    scratch. Operations: per real row and mask node the balanced score
    (~11) per active member and 2 per active soft slot. The per-row
    reckoning counts, as k2_work does for one wave, each real row's scan
    on its own: K1's rows, the planes and the carry read and written."""
    active = g.fv["active"] != 0
    n_act = int(active.sum())
    nb = g.planes.nb
    carried = ["used", "nonzero_used", "sel_counts"]
    if g.cfg.ipa_active:
        carried += ["ipa_counts", "ipa_anti", "ipa_pref"]
    planes = nbytes(*(g.dp[k] for k in ["alloc", "domain", "valid"] + carried))
    if g.cfg.ipa_active:
        planes += nbytes(g.dp["ipa_term_key"])
    k1_rows = n_act * (nb * (1 + 4 + 4 + 4) + 1)
    io = nbytes(g.packed_f, g.masks, words, g.logtab, out)
    soft_on = int(g.fv["soft_active"][active][:, : max(1, g.cfg.n_soft)].sum())
    mask_nodes = int(g.masks[:n_real].sum())
    per_row = n_real * (k1_rows + planes + nbytes(*(g.dp[k] for k in carried))) + io
    return planes + k1_rows + io, mask_nodes * (11 * n_act + 2 * soft_on), per_row


def k5_against_plain(args):
    """11. K5 against its plain version on the card at full width, every
    element of the packed output equal; K5, its tail pick and K1 timed on
    the largest Required gang. Returns the kernels-line numbers."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.tpu.gangplanner import plan_gang
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import build_gangs, gang, gang_member

    t0 = time.perf_counter()
    cache, snap, handle, fw, backend, _algo = gang_cluster(
        args.k5_nodes, args.zones, "cuda", init_pods=args.init_pods, wave=args.wave,
        seed=args.seed)
    print(f"K5 cluster: {args.k5_nodes} nodes, {args.init_pods} initial pods, "
          f"{time.perf_counter() - t0:.1f} s")
    sizes = [int(x) for x in args.k5_sizes.split(",")]
    cases = [(size, mode, "rng") for size in sizes for mode in ("Required", "Preferred")]
    cases += [(4, "Required", "fits nowhere"), (32, "Preferred", "3 words")]
    err, timed, cells = 0.0, None, []
    for i, (size, mode, kind) in enumerate(cases):
        cpu = "33" if kind == "fits nowhere" else "100m"
        spec = {"nodes": [], "gangs": [gang(f"k5-{i}", mode, [
            gang_member(f"k5-{i}-{j}", cpu=cpu) for j in range(size)])]}
        group, pods = build_gangs(spec, types, meta)[0]
        admit(handle, group, pods)
        plan = plan_gang(handle, fw, qpis(pods))
        nc, hf = plan.gang_n_constrained, plan.gang_has_fallback
        g = gang_inputs(backend, snap, pods, plan.gang_placements)
        words = tie_words(args.seed + 10 + i, g.packed_f.shape[0])
        if kind == "3 words":
            words = words[:3].clone()
        k1_compare(f"{size} members, {mode}, {kind}", g.dp, g.dt, g.packed_f, g.layout)
        k1 = kernels.static_parts(g.dp, g.dt, g.packed_f, g.layout)
        got = k5_call(g, k1, words, nc, hf)
        want = k5_call(g, k1, words, nc, hf, plain=True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).nonzero()[0, 0])
            fail(f"gang_assign differs from its plain version ({size} members, {mode}, "
                 f"{kind}): first at element {bad}, {int(got[bad])} vs {int(want[bad])}")
        err = max(err, max_abs_err([(got, want)]))
        d, p = g.masks.shape[0], g.packed_f.shape[0]
        tail = got[-3:].tolist()
        placed = got[d * p + 2 * d: d * p + 3 * d].tolist()
        overflow = got[d * p + d: d * p + 2 * d].tolist()
        t = kernels_ms(lambda: k5_call(g, k1, words, nc, hf),
                       ("gang_assign_kernel", "gang_pick_kernel"), 3)
        print(f"K5 == plain: {size} members ({p} slots), {mode}, {kind}: {d} rows "
              f"({nc} constrained, fallback {int(hf)}), [win_d, ok, n_active] {tail}, "
              f"placed {placed}, overflow {overflow}; K5 {t['gang_assign_kernel']:.4f} ms "
              f"+ pick {t['gang_pick_kernel']:.4f} ms")
        if kind == "fits nowhere" and tail[1]:
            fail("the gang no zone holds was admitted")
        if kind == "rng" and not tail[1]:
            fail(f"the {size}-member {mode} gang found no domain")
        if kind == "rng" and mode == "Required" and size == max(sizes):
            timed = (g, k1, words, nc, hf, got, nc + int(hf), size)
        if kind == "rng":
            cells.append((f"{size} members, {mode}", g, k1, words, nc, hf,
                          t["gang_assign_kernel"], size))
    g, k1, words, nc, hf, out, n_real, size = timed
    t = kernels_ms(lambda: (kernels.static_parts(g.dp, g.dt, g.packed_f, g.layout),
                            k5_call(g, k1, words, nc, hf)),
                   ("static_parts_kernel", "gang_assign_kernel", "gang_pick_kernel"), 5)
    ms, ms_pick, ms_k1 = (t["gang_assign_kernel"], t["gang_pick_kernel"],
                          t["static_parts_kernel"])
    plain = time_ms(lambda: k5_call(g, k1, words, nc, hf, plain=True), 1, warmup=0)
    b5, f5, b5_rows = k5_work(g, k1, words, out, n_real)
    bd, by = bound_ms(b5, f5)
    print(f"gang_assign ({size} members, Required, {g.masks.shape[0]} rows, {g.planes.n} "
          f"nodes): {ms:.4f} ms + pick {ms_pick:.4f} ms (plain {plain:.1f} ms, bound "
          f"{bd:.5f} ms by {by}, {b5} bytes; reckoned per row {b5_rows} bytes, "
          f"{bound_ms(b5_rows, f5)[0]:.5f} ms); static_parts on the gang {ms_k1:.4f} ms")
    return ({"max_abs_err": err, "ms": ms + ms_pick, "plain_ms": plain, "bound_ms": bd,
             "bound_by": by, "library_ms": None}, cells)


def gang_cell(label, n_nodes, zones, n_groups, size, mode, args):
    """One gang.yaml-shaped cell through try_gang_wave on the card; returns
    the cell's launch counts."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.tpu.gangplanner import plan_gang, try_gang_wave
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.testing.mixed import build_gangs, perf_gang_spec

    cache, snap, handle, fw, backend, algo = gang_cluster(n_nodes, zones, "cuda",
                                                          seed=args.seed)
    gangs = build_gangs(perf_gang_spec(0, zones, n_groups + 1, size, mode), types, meta)

    host_s = {"admit": 0.0, "try_gang_wave": 0.0, "assume": 0.0}

    def place(group, pods):
        t0 = time.perf_counter()
        admit(handle, group, pods)
        t1 = time.perf_counter()
        hosts = try_gang_wave(handle, fw, algo, group.meta.key, qpis(pods))
        t2 = time.perf_counter()
        if hosts is None:
            fail(f"{label}: gang {group.meta.name} was not placed "
                 f"({backend.recorder.records()[-1].gang_outcome})")
        if mode == "Required" and len({int(h.split("-")[1]) % zones for h in hosts}) != 1:
            fail(f"{label}: Required gang {group.meta.name} spans zones")
        assume_gang(handle, group, pods, hosts)
        for k, a, b in (("admit", t0, t1), ("try_gang_wave", t1, t2),
                        ("assume", t2, time.perf_counter())):
            host_s[k] += b - a

    place(*gangs[0])  # the first gang warms the path (the kernels are built)
    phase0 = dict(backend.gang_phase_s)
    totals0 = dict(backend.recorder.gang_pod_totals)
    host0, upload0 = dict(host_s), dict(backend.upload_stats)
    kernels.reset_launches()
    walls = []
    t0 = time.perf_counter()
    for group, pods in gangs[1:]:
        t = time.perf_counter()
        place(group, pods)
        walls.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_pods = n_groups * size
    device = backend.recorder.gang_pod_totals.get("device", 0) - totals0.get("device", 0)
    if device != n_pods or backend.recorder.gang_pod_totals.get("host", 0):
        fail(f"{label}: gang pods by path {backend.recorder.gang_pod_totals}, expected "
             f"{n_pods} more on the device")
    for k in ("static_parts", "gang_assign"):
        if launches[k] != n_groups:
            fail(f"{label}: {k} launched {launches[k]} times for {n_groups} gangs")
    phases = {k: (v - phase0[k]) * 1e3 / n_groups for k, v in backend.gang_phase_s.items()}
    host = {k: (v - host0[k]) * 1e3 / n_groups for k, v in host_s.items()}
    uploads = {k: v - upload0[k] for k, v in backend.upload_stats.items()}
    walls.sort()
    # one more gang's kernels, timed alone, for the busy share
    extra = build_gangs(perf_gang_spec(0, zones, n_groups + 2, size, mode), types, meta)[-1]
    admit(handle, *extra)
    plan = plan_gang(handle, fw, qpis(extra[1]))
    g = gang_inputs(backend, snap, extra[1], plan.gang_placements)
    words = tie_words(args.seed, g.packed_f.shape[0])
    k1 = kernels.static_parts(g.dp, g.dt, g.packed_f, g.layout)
    nc, hf = plan.gang_n_constrained, plan.gang_has_fallback
    ms = kernels_ms(lambda: (kernels.static_parts(g.dp, g.dt, g.packed_f, g.layout),
                             k5_call(g, k1, words, nc, hf)),
                    ("static_parts_kernel", "gang_assign_kernel", "gang_pick_kernel"), 5)
    ms1 = ms["static_parts_kernel"]
    ms5 = ms["gang_assign_kernel"] + ms["gang_pick_kernel"]
    k1_shape(f"{label}'s gang of {size}", g.dp, g.dt, g.packed_f, g.layout)
    print(f"{label}: {n_groups} gangs of {size} on {n_nodes} nodes, {mode}: {wall:.3f} s = "
          f"{n_pods / wall:.1f} gang pods/s incl. assume + snapshot; ms per gang median "
          f"{walls[len(walls) // 2] * 1e3:.3f}, max {walls[-1] * 1e3:.3f}; by run_gang phase "
          + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
          + f"; planner (try_gang_wave outside run_gang) "
          f"{host['try_gang_wave'] - sum(phases.values()):.4f}, admit + snapshot "
          f"{host['admit']:.4f}, assume + snapshot {host['assume']:.4f}; uploads {uploads}; "
          f"K5 {ms5:.4f} ms (scan + pick) K1 {ms1:.4f} ms per gang; device busy share "
          f"((K1 + K5) x gangs / wall) {(ms1 + ms5) * n_groups / (wall * 1e3):.4f}; "
          f"launches {launches}")
    check_tier(label, algo)
    return launches


def gang_cells(args):
    """12. gang.yaml's Required and Preferred 500Nodes cells, then the
    5000-node Required cell of 128-member gangs; returns the summed launch
    counts of the measured gangs."""
    total = {}
    for label, n_nodes, groups, size, mode in (
        ("GangSchedulingTopologyRequired/500Nodes", args.gang_nodes, args.gang_groups, 4,
         "Required"),
        ("GangSchedulingTopologyPreferred/500Nodes", args.gang_nodes, args.gang_groups, 4,
         "Preferred"),
        (f"Required gangs of {args.big_gang_size}/{args.big_gang_nodes}Nodes",
         args.big_gang_nodes, args.big_gang_groups, args.big_gang_size, "Required"),
    ):
        for k, v in gang_cell(label, n_nodes, args.zones, groups, size, mode, args).items():
            total[k] = total.get(k, 0) + v
    print(f"launches on the gang path (phase 12, measured gangs): {total}")
    return total


def gang_card_vs_cpu(args):
    """13. The card against the CPU plain path through try_gang_wave on a
    mixed cluster: equal hosts, winning rows, outcome strings and rng
    state after every gang."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import Framework, Handle
    from kubernetes_tpu_torch.scheduler.plugins.topology_placement import (
        TopologyPlacementGenerator)
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)
    from kubernetes_tpu_torch.scheduler.tpu.gangplanner import try_gang_wave
    from kubernetes_tpu_torch.testing.mixed import build_gang_nodes, build_gangs, mixed_gang_spec

    t0 = time.perf_counter()
    spec = mixed_gang_spec(args.seed + 61, args.mixed_gang_nodes, args.zones,
                           args.mixed_gangs, max_size=12)
    results = []
    for device in ("cuda", "cpu"):
        cache = Cache(ResourceNames())
        for n in build_gang_nodes(spec, types, meta):
            cache.add_node(n)
        snap = Snapshot()
        cache.update_snapshot(snap)
        handle = Handle(cache=cache, snapshot=snap)
        fw = Framework([TopologyPlacementGenerator()], handle=handle)
        backend = TorchBackend(cache.names, device=device)
        algo = TorchSchedulingAlgorithm(fw, backend, rng=random.Random(args.seed))
        rows = []
        run_gang = backend.run_gang

        def recording(*a, _run=run_gang, _rows=rows):
            res = _run(*a)
            _rows.append(None if res is None else res[1])
            return res

        backend.run_gang = recording
        got = []
        for group, pods in build_gangs(spec, types, meta):
            admit(handle, group, pods)
            hosts = try_gang_wave(handle, fw, algo, group.meta.key, qpis(pods))
            got.append((hosts, backend.recorder.records()[-1].gang_outcome, algo.rng.getstate()))
            if hosts is not None:
                assume_gang(handle, group, pods, hosts)
        check_tier(f"phase 13 on {device}", algo)
        results.append((got, rows, dict(backend.recorder.gang_pod_totals)))
    if results[0] != results[1]:
        for i, (a, b) in enumerate(zip(results[0][0], results[1][0])):
            if a != b:
                fail(f"gang {i} of the mixed cluster: card and CPU plain path disagree "
                     f"({a[:2]} vs {b[:2]})")
        fail(f"mixed gangs: card and CPU disagree on winning rows or totals "
             f"({results[0][1:]} vs {results[1][1:]})")
    outcomes = [o.split(":")[0] for _h, o, _s in results[0][0]]
    print(f"mixed gangs, {args.mixed_gang_nodes} nodes: card == CPU plain path through "
          f"try_gang_wave ({outcomes.count('device')} placed, {outcomes.count('fallback')} "
          f"fell back; winning rows {results[0][1]}), {time.perf_counter() - t0:.1f} s")
    if not outcomes.count("device"):
        fail("no mixed gang was placed")



# --------------------------------------------------------------------------
# 17-19: node shards on one card (the mesh)
# --------------------------------------------------------------------------


def k6_call(w, k1, words, cursor, kw, n, plain=False):
    """K6 on a wave's inputs over n node shards (its plain version with
    plain=True)."""
    from kubernetes_tpu_torch.ops import kernels

    if plain:
        return kernels.sharded_assign_ref(w.cfg, w.dp, k1, w.fv, words, cursor, w.logtab,
                                          n, **kw)
    return kernels.sharded_assign(w.cfg, w.dp, k1, w.packed_f, w.layout, words, cursor,
                                  w.logtab, n, **kw)


def k6_against_plain_and_k2(args, shards, cells):
    """17. K6 at full width on phase 4's SchedulingBasic wave, phase 7's
    TopologySpreading wave and phase 8's IPA wave (signature dedup on), and
    on phase 15's chained, seeded wave: at every shard count every output
    equal to K2's on the same inputs, at the largest also to K6's plain
    version on the card (sharded_assign_ref). Then K6 timed per shard count
    beside K2 (profiler), the plain version at the largest count (events)
    and the bound (bytes moved once: K2's work). Returns the kernels-line
    numbers of the chained wave (the mesh main path's shape)."""
    from kubernetes_tpu_torch.ops import kernels

    n_max = max(shards)
    out = {}
    for label, w, k1, words, cursor, kw in cells:
        k2 = kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout, words, cursor,
                                 w.logtab, **kw)
        torch.cuda.synchronize()
        ref = dict(_flat(k2))
        err = 0.0
        for n in shards:
            got = dict(_flat(k6_call(w, k1, words, cursor, kw, n)))
            torch.cuda.synchronize()
            if got.keys() != ref.keys():
                fail(f"sharded_assign outputs {sorted(got)} vs assign_scan {sorted(ref)}")
            for k in ref:
                if not torch.equal(got[k], ref[k]):
                    fail(f"sharded_assign {k} at {n} shards differs from assign_scan ({label})")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = dict(_flat(k6_call(w, k1, words, cursor, kw, n_max, plain=True)))
        ev[1].record()
        torch.cuda.synchronize()
        plain = ev[0].elapsed_time(ev[1])
        for k in ref:
            if not torch.equal(got[k], want[k]):
                fail(f"sharded_assign {k} at {n_max} shards differs from its plain version "
                     f"({label})")
        err = max_abs_err((got[k], want[k]) for k in ref)
        ms = {n: kernel_ms(lambda n=n: k6_call(w, k1, words, cursor, kw, n),
                           "sharded_assign_kernel", 3) for n in shards}
        ms_k2 = kernel_ms(lambda: kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout,
                                                      words, cursor, w.logtab, **kw),
                          "assign_scan_kernel", 3)
        b, ops = k2_work(w, k1, words, k2, True)
        if "sig_table" in kw:
            b += nbytes(*kw["sig_table"].values(), kw["carry_map"])
        bd, by = bound_ms(b, ops)
        print(f"sharded_assign ({label}): equal to assign_scan at {shards} shards and to "
              f"its plain version at {n_max}; profiler ms by shard count "
              + ", ".join(f"{n}: {v:.4f}" for n, v in ms.items())
              + f"; assign_scan {ms_k2:.4f} ms; plain ({n_max} shards) {plain:.1f} ms; "
              f"bound {bd:.5f} ms by {by}; tiers [full, replay] {k2['tiers'].tolist()}")
        out[label] = {"max_abs_err": err, "ms": ms[n_max], "plain_ms": plain,
                      "bound_ms": bd, "bound_by": by, "library_ms": None}
    return out["chained seeded SchedulingBasic wave"]


def ptxas_entries(reports, kernels_wanted):
    """{entry: (registers, stack, spill stores, spill loads, smem)} for every
    entry function of the build logs whose name holds one of
    kernels_wanted (nvcc -Xptxas -v prints each entry's lines in order)."""
    import re

    out, entry = {}, None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1) if any(k in m.group(1) for k in kernels_wanted) else None
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out.setdefault(entry, {}).update(
                    stack=int(m.group(1)), spill_stores=int(m.group(2)),
                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
            if m:
                out.setdefault(entry, {}).update(registers=int(m.group(1)),
                                                 smem=int(m.group(2)))
    return out


def floor_ms(syncs, span, n_blocks=1):
    """The latency floor of a scan's counted synchronisations (profiler)."""
    from kubernetes_tpu_torch.ops import kernels

    return kernel_ms(lambda: kernels.scan_floor(syncs, span, n_blocks), "scan_floor_kernel", 5)


STEP_PHASES = ("slots barrier", "filters + table setup", "A pass", "A fold", "B",
               "C pass + publish", "pick + draw", "adds + patch")


def phase_split(syncs, ms, steps):
    """The scan's per-step time split by phase: thread 0's clock cycles per
    phase (the kernel's own marks) as shares of the measured time."""
    cyc = syncs.tolist()[5:]
    total = max(sum(cyc), 1)
    return "per step by phase (us, thread 0's clock shares of the measured time): " + ", ".join(
        f"{name} {ms * 1e3 / steps * c / total:.2f}" for name, c in zip(STEP_PHASES, cyc))


def step_latency(reports, k2_cells, k5_cells, n_shards, k6_ms):
    """20. The scan step's latency: ptxas's registers, spills and shared
    memory for K2's, K5's and K6's instances; microseconds per step (K2,
    K6) or per member (K5) beside the latency floor of the same counted
    synchronisations with no node work."""
    from kubernetes_tpu_torch.ops import kernels

    entries = ptxas_entries(reports, ("assign_scan_kernel", "gang_assign_kernel",
                                      "sharded_assign_kernel", "fit_and_score_kernel"))
    for name, e in sorted(entries.items()):
        print(f"ptxas {name}: {e.get('registers')} registers, {e.get('stack')} bytes stack, "
              f"{e.get('spill_stores')}/{e.get('spill_loads')} bytes spill stores/loads, "
              f"{e.get('smem')} bytes static smem")
    syncs = torch.zeros(kernels.SCAN_SYNC_WORDS, dtype=torch.int32, device="cuda")
    for (label, w, k1, words, cursor, kw), ms in k2_cells:
        out = kernels.assign_scan(w.cfg, w.dp, k1, w.packed_f, w.layout, words, cursor,
                                  w.logtab, syncs=syncs, **kw)
        torch.cuda.synchronize()
        steps = w.packed_f.shape[0]
        fl = floor_ms(syncs, w.planes.nb)
        print(f"K2 step ({label}): {ms * 1e3 / steps:.2f} us per step over {steps} steps, "
              f"tiers [full, replay] {out['tiers'].tolist()}; latency floor "
              f"{fl * 1e3 / steps:.2f} us per step ({fl:.4f} ms; counted barriers, folds, "
              f"picks {syncs.tolist()[:2] + syncs.tolist()[4:5]}); {phase_split(syncs, ms, steps)}")
        if label == "chained seeded SchedulingBasic wave":
            kernels.sharded_assign(w.cfg, w.dp, k1, w.packed_f, w.layout, words, cursor,
                                   w.logtab, n_shards, syncs=syncs, **kw)
            torch.cuda.synchronize()
            fl6 = floor_ms(syncs, w.planes.nb // n_shards, n_shards)
            print(f"K6 step ({label}, {n_shards} shards): {k6_ms * 1e3 / steps:.2f} us per "
                  f"step; latency floor {fl6 * 1e3 / steps:.2f} us per step ({fl6:.4f} ms; "
                  f"counted barriers, folds, cluster barriers, exchanges, picks "
                  f"{syncs.tolist()[:5]})")
    for label, g, k1, words, nc, hf, ms, size in k5_cells:
        kernels.gang_assign(g.cfg, g.dp, k1, g.packed_f, g.layout, g.masks, words, g.logtab,
                            nc, hf, syncs=syncs)
        torch.cuda.synchronize()
        fl = floor_ms(syncs, g.planes.nb)
        print(f"K5 member step ({label}, {g.masks.shape[0]} rows): {ms * 1e3 / size:.2f} us "
              f"per member; latency floor {fl * 1e3 / size:.2f} us per member ({fl:.4f} ms; "
              f"row 0's counted barriers, folds, picks {syncs.tolist()[:2] + syncs.tolist()[4:5]}); "
              f"{phase_split(syncs, ms, size)}")


def mesh_main_path(args, serial, a14, n_shards):
    """18. The main path on the mesh: phase 14's pipelined SchedulingBasic
    run (the same 1000 + 10000 pods, waves of 512, seed 1) through
    WavePipeline at depth 2 over TorchBackend(context=MeshContext(
    scheduler_mesh(n_shards))). Counts zeroed before, read after: K1 and K6
    must have launched and K2 not at all. Bindings and the final rng state
    must equal phase 3's (which phase 14 equals); pods/s beside phase 14's
    from this call, per-wave launch and collect-wait ms. Returns the launch
    counts and the measured pods/s."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel import MeshContext, scheduler_mesh

    kernels.reset_launches()
    r = run_pipelined(args, context=MeshContext(scheduler_mesh(n_shards)))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches on the mesh main path ({n_shards} node shards): {launches}")
    if launches["static_parts"] <= 0 or launches["sharded_assign"] <= 0:
        fail("K1 or K6 never launched on the mesh main path")
    if launches["assign_scan"]:
        fail("K2 launched on the mesh main path")
    pipe, algo = r["pipe"], r["algo"]
    if pipe.bindings != serial["bindings"] or algo.rng.getstate() != serial["rng"]:
        fail("the mesh main path's bindings or rng state differ from phase 3's")
    if pipe.stats["resyncs"] or pipe.stats["fallback_waves"] or pipe.handed_back:
        fail(f"the mesh main path resynced or fell back: {pipe.stats}")
    log = r["log"]
    waits = sorted(e["wait_s"] for e in log)
    print(f"mesh main path: bindings and rng equal to phase 3's and 14's; measured "
          f"{args.pods} pods in {len(log)} waves, {r['wall_s']:.3f} s = {r['pods_s']:.1f} "
          f"pods/s (phase 14, one block: {a14['pods_s']:.1f} pods/s, same call); "
          f"launches {r['kinds']}; cross-wave {r['stats']}")
    n_waves = len(log)
    print("mesh main path, ms per measured wave: "
          + ", ".join(f"{k} {v * 1e3 / n_waves:.3f}" for k, v in r["phases"].items())
          + f", assume {r['loop']['assume'] * 1e3 / n_waves:.3f}"
          + f", snapshot {r['loop']['snapshot'] * 1e3 / n_waves:.3f}")
    print("mesh main path per measured wave (chained, launch ms, collect wait ms): "
          + " ".join(f"({int(e['chained'])},{e['launch_s'] * 1e3:.2f},{e['wait_s'] * 1e3:.2f})"
                     for e in log))
    print(f"mesh main path collect wait: median {waits[len(waits) // 2] * 1e3:.3f} ms, "
          f"max {waits[-1] * 1e3:.3f} ms")
    return launches, r["pods_s"]


def wave_matrix(args, n_shards):
    """19. K7 at dryrun_multichip's shape (__graft_entry__.py:124-185), at
    full width: a SchedulingBasic cluster of --matrix-nodes nodes with one
    pod each, --matrix-pods pods of 1 CPU / 2Gi each with a zone hard
    spread (maxSkew 2). The matrix through parallel.wave_fit_and_score on
    a (wave 2) mesh must equal K7's plain version, and each row K4's
    feasible and total for that pod; then the pods through
    sharded_batched_assign on n_shards shards: every output equal to
    batched_assign's (K1 + K2) and every pod placed, as the dryrun
    asserts. Returns the kernels-line numbers of K7."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel import (
        scheduler_mesh, sharded_batched_assign, wave_fit_and_score)
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
    from kubernetes_tpu_torch.testing.wrappers import (
        make_pod, scheduling_basic_node, scheduling_basic_pod, with_spread)

    cache = Cache(ResourceNames())
    for i in range(args.matrix_nodes):
        cache.add_node(scheduling_basic_node(i, args.zones))
        cache.assume_pod(scheduling_basic_pod(5 * 10**6 + i), f"node-{i}")
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend = TorchBackend(cache.names, device="cuda")
    pods = [with_spread(make_pod(f"wave-{i}", cpu="1", mem="2Gi", labels={"app": "wave"}),
                        max_skew=2, key="topology.kubernetes.io/zone", when="DoNotSchedule")
            for i in range(args.matrix_pods)]
    w = wave_inputs(backend, pods, snap, len(pods))
    mesh = scheduler_mesh(8, wave=2)  # dryrun_multichip(8)'s axes: 2 x 4
    kernels.reset_launches()
    feasible, total = wave_fit_and_score(w.cfg, mesh, w.dp, w.dt, w.packed_f, w.layout,
                                         w.logtab)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["wave_fit_and_score"] != 1:
        fail(f"the matrix did not launch K7 once: {launches}")
    want_f, want_t = kernels.wave_fit_and_score_ref(w.cfg, w.dp, w.dt, w.fv, w.logtab)
    torch.cuda.synchronize()
    if not (torch.equal(feasible, want_f) and torch.equal(total, want_t)):
        fail("wave_fit_and_score differs from its plain version")
    err = max_abs_err([(feasible, want_f), (total, want_t)])
    nf = len(kernels.FILTER_NAMES) + 2 * w.cfg.max_constraints + 3
    k4 = kernels.fit_and_score(w.cfg, w.dp, w.dt, w.packed_f, w.layout, w.logtab)
    torch.cuda.synchronize()
    for p in range(len(pods)):
        row = kernels.unpack_fit_outputs(k4[p], w.planes.nb, nf, w.planes.r)
        if not (torch.equal(row["feasible"], feasible[p])
                and torch.equal(row["total"], total[p])):
            fail(f"wave_fit_and_score row {p} differs from fit_and_score's")
    n_feasible = int(feasible.sum())
    # every cluster size K7 has: equal to the plain version, timed
    by_c = {}
    syncs = torch.zeros(kernels.FIT_SYNC_WORDS, dtype=torch.int32, device="cuda")
    for n in kernels.WAVE_FIT_CLUSTERS:
        got_f, got_t = kernels.wave_fit_and_score(w.cfg, w.dp, w.dt, w.packed_f, w.layout,
                                                  w.logtab, cluster=n, syncs=syncs)
        torch.cuda.synchronize()
        if not (torch.equal(got_f, want_f) and torch.equal(got_t, want_t)):
            fail(f"wave_fit_and_score on {n} blocks per pod differs from its plain version")
        by_c[n] = kernel_ms(lambda: kernels.wave_fit_and_score(
            w.cfg, w.dp, w.dt, w.packed_f, w.layout, w.logtab, cluster=n),
            "fit_and_score_kernel<false", 5)
        fl = kernel_ms(lambda: kernels.fit_floor(syncs, len(pods), n, wave=True),
                       "fit_floor_kernel", 5)
        print(f"K7 on {n} blocks per pod: {by_c[n]:.4f} ms; latency floor {fl:.4f} ms "
              f"({len(pods)} pods); pod 0 {fit_split(syncs, by_c[n])}")
    ms = kernel_ms(lambda: wave_fit_and_score(w.cfg, mesh, w.dp, w.dt, w.packed_f, w.layout,
                                              w.logtab), "fit_and_score_kernel<false", 5)
    ms_k4 = kernel_ms(lambda: kernels.fit_and_score(w.cfg, w.dp, w.dt, w.packed_f, w.layout,
                                                    w.logtab), "fit_and_score_kernel<true", 5)
    plain = time_ms(lambda: kernels.wave_fit_and_score_ref(w.cfg, w.dp, w.dt, w.fv, w.logtab),
                    1, warmup=0)
    nb, P = w.planes.nb, len(pods)
    b0, ops0 = k4_work(w.cfg, w.dp, w.dt, w.fv, w.packed_f, nb * 5)
    bd, by = bound_ms(b0 + (P - 1) * (w.packed_f.shape[1] * 4 + nb * 5), P * ops0)
    print(f"wave_fit_and_score ({args.matrix_nodes} nodes x {P} zone-spread pods, mesh "
          f"{mesh.shape}): equal to its plain version (at {list(kernels.WAVE_FIT_CLUSTERS)} "
          f"blocks per pod) and row by row to fit_and_score; "
          f"{n_feasible} feasible pairs; {ms:.4f} ms at {kernels.WAVE_FIT_CLUSTER} "
          f"(fit_and_score on the same {P} pods "
          f"{ms_k4:.4f} ms; plain {plain:.1f} ms; bound {bd:.5f} ms by {by})")
    # the dryrun's second program: the scan over the same pods on the shards
    words = tie_words(args.seed + 9, P)
    scan_mesh = scheduler_mesh(n_shards)
    got = sharded_batched_assign(w.cfg, scan_mesh, w.dp, w.dt, w.packed_f, w.layout, words,
                                 w.logtab)
    ref = kernels.batched_assign(w.cfg, w.dp, w.dt, w.packed_f, w.layout, words, w.logtab)
    torch.cuda.synchronize()
    g, r = dict(_flat(got)), dict(_flat(ref))
    if g.keys() != r.keys() or not all(torch.equal(g[k], r[k]) for k in r):
        fail("sharded_batched_assign differs from batched_assign on the matrix pods")
    if int((got["packed"][:P] >= 0).sum()) != P:
        fail("the matrix pods did not all place on the shards")
    print(f"sharded_batched_assign ({n_shards} shards) on the matrix pods: every output "
          f"equal to batched_assign's, {P}/{P} placed")
    return {"launches": launches["wave_fit_and_score"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bd, "bound_by": by, "library_ms": None}



# --------------------------------------------------------------------------
# 21: the host tier around K4 and K5
# --------------------------------------------------------------------------


FEATURE = "NUMAAlignment"
NDF_ANNOTATION = "features.k8s.io/required"


def check_tier(label, algo):
    """The gang planner's catch-all must have met no error: on the card it
    raises one (a failed K1/K5 build or launch), on the CPU it would send
    the group to the host cycle."""
    if algo.backend.gang_errors:
        fail(f"{label}: the gang planner degraded {algo.backend.gang_errors} errors to "
             f"the host cycle, the last: {algo.backend.gang_last_error}")


def tier_side(nodes, device, seed):
    """A cache over `nodes`, the default profile with a handle over the
    cache and snapshot, a nominator and TorchSchedulingAlgorithm on
    `device`."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.framework import Handle
    from kubernetes_tpu_torch.scheduler.queue import Nominator
    from kubernetes_tpu_torch.scheduler.tpu.backend import (
        TorchBackend, TorchSchedulingAlgorithm)

    cache = Cache(ResourceNames())
    for n in nodes:
        cache.add_node(n)
    snap = Snapshot()
    cache.update_snapshot(snap)
    handle = Handle(cache=cache, snapshot=snap)
    fw = default_framework(cache.names, handle=handle)
    nominator = Nominator()
    algo = TorchSchedulingAlgorithm(fw, TorchBackend(cache.names, device=device),
                                    rng=random.Random(seed), nominator=nominator)
    return TierSide(cache, snap, handle, fw, algo, nominator)


class TierSide:
    def __init__(self, cache, snap, handle, fw, algo, nominator):
        self.cache, self.snap, self.handle, self.fw = cache, snap, handle, fw
        self.algo, self.nominator = algo, nominator

    def schedule(self, pod):
        """schedule_pod: a comparable record of the result or FitError, the
        rotation index and the counters after it."""
        from kubernetes_tpu_torch.scheduler.framework import CycleState, FitError

        algo = self.algo
        try:
            r = algo.schedule_pod(CycleState(), pod, self.snap)
        except FitError as e:
            rec = ("fit", e.error_message(), sorted(e.diagnosis.unschedulable_plugins))
        else:
            rec = (r.suggested_host, r.evaluated_nodes, r.feasible_nodes)
            self.cache.assume_pod(pod, r.suggested_host)
            self.cache.update_snapshot(self.snap)
        return rec + (algo.next_start_node_index, algo.kernel_count, algo.fallback_count)


def ndf_cell(args, device, n_pods):
    """(a) SchedulingNodeDeclaredFeatures/1000Nodes
    (kubernetes_tpu/perf/configs/nodedeclaredfeatures.yaml:33-35): plain
    nodes, then nodes labelled node-class: featured declaring
    NUMAAlignment (the default node template, zones round-robin), then
    measured pods of 500m requiring it, one at a time through schedule_pod
    (K4 + the host NodeDeclaredFeatures tail) with an assume and a snapshot
    update after each."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

    n_plain = n_feat = args.ndf_nodes // 2
    nodes = [make_node(f"node-{i}", zone=f"zone-{i % args.zones}") for i in range(n_plain)]
    nodes += [make_node(f"node-{i}", zone=f"zone-{i % args.zones}",
                        labels={"node-class": "featured"}, declared_features=(FEATURE,))
              for i in range(n_plain, n_plain + n_feat)]
    side = tier_side(nodes, device, args.seed)
    pods = []
    for i in range(n_pods):
        p = make_pod(f"pod-{i}", cpu="500m")
        p.meta.annotations[NDF_ANNOTATION] = FEATURE
        pods.append(p)
    backend = side.algo.backend
    run0, k0, f0 = dict(backend.run_phase_s), side.algo.kernel_count, side.algo.fallback_count
    kernels.reset_launches()
    log, sched_s = [], 0.0
    t0 = time.perf_counter()
    for pod in pods:
        a = time.perf_counter()
        rec = side.schedule(pod)
        sched_s += time.perf_counter() - a
        log.append(rec)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for pod, rec in zip(pods, log):
        if rec[0] == "fit" or int(rec[0].split("-")[1]) < n_plain:
            fail(f"(a) {device}: {pod.meta.name} placed on {rec[0]}, not a featured node")
    kc, fc = side.algo.kernel_count - k0, side.algo.fallback_count - f0
    if (kc, fc) != (n_pods, 0):
        fail(f"(a) {device}: kernel_count +{kc}, fallback_count +{fc}; expected "
             f"+{n_pods}, +0")
    check_tier(f"(a) {device}", side.algo)
    run = {k: v - run0[k] for k, v in backend.run_phase_s.items()}
    return {"log": log, "rng": side.algo.rng.getstate(), "launches": launches,
            "wall_s": wall, "sched_s": sched_s, "run": run, "side": side}


def nominated_cell(args, device):
    """(b) nominated pods, then (c) the host route, on SchedulingBasic's
    cluster: every node filled with a priority-0 pod of 31 CPU, four of them
    freed for priority-100 preemptors nominated onto them through the
    nominator. Then: pods that outrank every nomination (kernel route),
    pods of 31 CPU that the nominations outrank (hybrid route with the
    two-pass treatment: none may take a nominee), the preemptors (nominee
    fast path), and pods the extractor refuses (host route)."""
    from kubernetes_tpu_torch.testing.wrappers import (
        make_pod, scheduling_basic_node, with_spread)
    from kubernetes_tpu_torch.api.types import Container, ContainerPort

    side = tier_side([scheduling_basic_node(i, args.zones) for i in range(args.nodes)],
                     device, args.seed)
    fillers = [make_pod(f"filler-{i}", cpu="31", mem="1Gi") for i in range(args.nodes)]
    for i, p in enumerate(fillers):
        side.cache.assume_pod(p, f"node-{i}")
    nominees = [f"node-{i * (args.nodes // 4)}" for i in range(4)]
    preemptors = []
    for k, node in enumerate(nominees):
        side.cache.remove_pod(fillers[int(node.split("-")[1])])
        pre = make_pod(f"preemptor-{k}", cpu="31", mem="1Gi")
        pre.spec.priority = 100
        side.nominator.add_nominated_pod(pre, node)
        preemptors.append(pre)
    side.cache.update_snapshot(side.snap)
    parts = {}

    def run(label, pods):
        a = time.perf_counter()
        k0, f0 = side.algo.kernel_count, side.algo.fallback_count
        recs = [side.schedule(p) for p in pods]
        parts[label] = {"recs": recs, "s": time.perf_counter() - a,
                        "kernel": side.algo.kernel_count - k0,
                        "fallback": side.algo.fallback_count - f0}
        return recs

    vips = []
    for i in range(8):
        p = make_pod(f"vip-{i}", cpu="100m", mem="64Mi")
        p.spec.priority = 200
        vips.append(p)
    run("outrank", vips)
    run("outranked", [make_pod(f"low-{i}", cpu="31", mem="1Gi") for i in range(8)])
    for pre, node in zip(preemptors, nominees):
        pre.status.nominated_node_name = node
    recs = run("preemptors", preemptors)
    for pre in preemptors:
        side.nominator.delete_nominated_pod_if_exists(pre)
    refused = []
    for i in range(2):
        p = make_pod(f"port-{i}", cpu="100m")
        p.spec.containers[0] = Container(name="c", requests={"cpu": "100m"}, ports=(
            ContainerPort(80, host_port=80, host_ip=f"10.0.0.{i}"),))
        refused.append(p)
    for i in range(2):
        p = make_pod(f"spread-{i}", cpu="100m", labels={"app": "s"})
        for k in range(5):
            with_spread(p, max_skew=k + 1, when="DoNotSchedule",
                        key="topology.kubernetes.io/zone" if k % 2 else
                        "kubernetes.io/hostname")
        refused.append(p)
    run("host route", refused)
    want = {"outrank": (8, 0), "outranked": (8, 0), "preemptors": (0, 4),
            "host route": (0, 4)}
    for label, (kc, fc) in want.items():
        got = (parts[label]["kernel"], parts[label]["fallback"])
        if got != (kc, fc):
            fail(f"(b/c) {device} {label}: kernel_count, fallback_count +{got}; expected "
                 f"+{(kc, fc)}")
    lows = parts["outranked"]["recs"]
    if any(r[0] != "fit" for r in lows):
        fail(f"(b) {device}: an outranked pod took a nominee: {[r[0] for r in lows]}")
    if [r[0] for r in recs] != nominees:
        fail(f"(b) {device}: preemptors landed on {[r[0] for r in recs]}, not {nominees}")
    if any(r[0] == "fit" for r in parts["host route"]["recs"] + parts["outrank"]["recs"]):
        fail(f"(b/c) {device}: a pod of the kernel or host route was not placed")
    check_tier(f"(b/c) {device}", side.algo)
    return {"parts": parts, "rng": side.algo.rng.getstate()}


def gang_tier_cell(args, device):
    """(d) gang.yaml's GangSchedulingTopologyRequired/500Nodes cluster (the
    default node template over the zones; zone-3's nodes declare the
    feature) and its 100 PodGroups of 4 through PodGroupCycle: the plain
    gangs on the device path (K1 + K5), then one gang whose second member
    requires the feature (try_gang_wave declines it; the host cycle places
    it whole in zone-3 through per-member K4 runs on placement-narrowed
    snapshots), then one more plain gang."""
    import kubernetes_tpu_torch.api.meta as meta
    import kubernetes_tpu_torch.api.types as types
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.schedule_one import PodGroupCycle
    from kubernetes_tpu_torch.testing.mixed import build_gangs, perf_gang_spec
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node

    nodes = [scheduling_basic_node(i, args.zones) for i in range(args.gang_nodes)]
    for i, n in enumerate(nodes):
        if i % args.zones == 3:
            n.status.declared_features = (FEATURE,)
    side = tier_side(nodes, device, args.seed)
    cycle = PodGroupCycle(side.snap, side.fw, side.algo, side.cache.names)
    n = args.gang_groups
    gangs = build_gangs(perf_gang_spec(0, args.zones, n + 2, 4, "Required"), types, meta)
    gangs[n][1][1].meta.annotations[NDF_ANNOTATION] = FEATURE
    backend = side.algo.backend
    log, ndf_launches = [], None
    t0 = time.perf_counter()
    for g, (group, pods) in enumerate(gangs):
        admit(side.handle, group, pods)
        if g == n:
            kernels.reset_launches()
            totals0 = dict(backend.recorder.gang_pod_totals)
        out = cycle.schedule_pod_group(group.meta.key, qpis(pods))
        if out[0] != "success":
            fail(f"(d) {device}: gang {group.meta.name} not placed: {out}")
        hosts = [r.suggested_host for _q, _st, r, _pi in out[1]]
        if len({int(h.split("-")[1]) % args.zones for h in hosts}) != 1:
            fail(f"(d) {device}: Required gang {group.meta.name} spans zones: {hosts}")
        if g == n:
            ndf_launches = dict(kernels.LAUNCHES)
            host = backend.recorder.gang_pod_totals.get("host", 0) - totals0.get("host", 0)
            if host != 4 or {int(h.split("-")[1]) % args.zones for h in hosts} != {3}:
                fail(f"(d) {device}: the declared-features gang went {hosts}, "
                     f"{host} members counted on the host side")
        assume_gang(side.handle, group, pods, hosts)
        log.append((group.meta.name, hosts))
    wall = time.perf_counter() - t0
    if backend.recorder.gang_pod_totals.get("device", 0) != 4 * (n + 1):
        fail(f"(d) {device}: gang pods by path {backend.recorder.gang_pod_totals}")
    check_tier(f"(d) {device}", side.algo)
    return {"log": log, "rng": side.algo.rng.getstate(), "wall_s": wall,
            "counts": (side.algo.kernel_count, side.algo.fallback_count,
                       dict(backend.recorder.gang_pod_totals)),
            "ndf_launches": ndf_launches}


def host_tier(args):
    """21. The host tier (see the module docstring); returns the launch
    counts of (a) on the card."""
    n_cpu = min(args.ndf_cpu_pods, args.ndf_pods)
    t0 = time.perf_counter()
    card = ndf_cell(args, "cuda", args.ndf_pods)
    cpu = ndf_cell(args, "cpu", n_cpu)
    if n_cpu < args.ndf_pods:
        print(f"(a) the CPU run is cut to the first {n_cpu} of {args.ndf_pods} pods "
              f"(the node count is not cut)")
    if card["log"][:n_cpu] != cpu["log"] or (n_cpu == args.ndf_pods
                                              and card["rng"] != cpu["rng"]):
        fail("(a) the card's bindings, rng or rotation differ from the CPU run's")
    la = card["launches"]
    if la["fit_and_score"] != args.ndf_pods:
        fail(f"(a) fit_and_score launched {la['fit_and_score']} times for "
             f"{args.ndf_pods} pods")
    run_s = sum(card["run"].values())
    host_s = card["sched_s"] - run_s
    n = args.ndf_pods
    print(f"(a) SchedulingNodeDeclaredFeatures/{args.ndf_nodes}Nodes: {n} pods, every one on "
          f"a featured node, card == CPU ({n_cpu} pods); {card['wall_s']:.3f} s = "
          f"{n / card['wall_s']:.1f} pods/s incl. assume + snapshot; schedule_pod "
          f"{card['sched_s'] * 1e3 / n:.4f} ms per pod = run (K4) "
          f"{run_s * 1e3 / n:.4f} + host stage {host_s * 1e3 / n:.4f}; run phases ms per "
          f"pod: " + ", ".join(f"{k} {v * 1e3 / n:.4f}" for k, v in card["run"].items())
          + f"; launches {la}; CPU run {cpu['wall_s']:.1f} s")
    bc = [nominated_cell(args, d) for d in ("cuda", "cpu")]
    if any(bc[0]["parts"][k]["recs"] != bc[1]["parts"][k]["recs"] for k in bc[0]["parts"]) \
            or bc[0]["rng"] != bc[1]["rng"]:
        fail("(b/c) the card's decisions differ from the CPU run's")
    parts = bc[0]["parts"]
    print(f"(b) nominated pods on {args.nodes} nodes (every node filled, 4 nominees), "
          f"card == CPU: " + "; ".join(
              f"{k}: {len(v['recs'])} pods, kernel +{v['kernel']}, fallback +{v['fallback']}, "
              f"{v['s'] * 1e3 / len(v['recs']):.2f} ms per pod"
              for k, v in parts.items() if k != "host route"))
    v = parts["host route"]
    print(f"(c) the host route: {len(v['recs'])} pods the extractor refuses (a hostIP "
          f"port, 5 spread constraints), fallback +{v['fallback']}, "
          f"{v['s'] * 1e3 / len(v['recs']):.2f} ms per pod on the card's side")
    gangs = [gang_tier_cell(args, d) for d in ("cuda", "cpu")]
    if any(gangs[0][k] != gangs[1][k] for k in ("log", "rng", "counts")):
        fail("(d) the card's gang placements differ from the CPU run's")
    print(f"(d) {args.gang_groups + 2} gangs of 4 on {args.gang_nodes} nodes, card == CPU: "
          f"the declared-features gang in zone-3 through the host cycle "
          f"(launches {gangs[0]['ndf_launches']}), the others on the device path; counts "
          f"(kernel, fallback, gang pods by path) {gangs[0]['counts']}; "
          f"{gangs[0]['wall_s']:.3f} s on the card's side")
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return la


# --------------------------------------------------------------------------
# 22: the store-driven loop
# --------------------------------------------------------------------------


class StrictClock:
    """Wall-clock seconds that never repeat: each reading is at least 1 us
    past the last, so pods the informer queues in one pump keep their
    store order in the queue (PrioritySort orders equal priorities by queue
    time) on the card and on the CPU alike."""

    def __init__(self):
        self._last = 0.0

    def now(self) -> float:
        self._last = max(time.time(), self._last + 1e-6)
        return self._last

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait_for(self, waiter, timeout: float):
        return waiter(timeout)


def loop_scheduler(store, device, wave, seed, gates=None):
    """The port's Scheduler over `store`, one device profile."""
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler

    s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=wave)], seed=seed,
                  clock=StrictClock(), device=device, feature_gates=gates or {})
    s.start()
    return s


def check_loop(label, s):
    """The breaker saw no device failure (none is injected on the card) and
    the gang planner met no error."""
    algo = s.algorithms["default-scheduler"]
    check_tier(label, algo)
    if algo.breaker.state != "closed" or algo.breaker.consecutive_failures:
        fail(f"{label}: the circuit breaker left CLOSED: {algo.breaker.snapshot()}")
    if s.loop._inflight_wave is not None:
        fail(f"{label}: a wave is left in flight")


def loop_basic_run(args, serial, depth, shards):
    """22 (a), one run: SchedulingBasic through the port's Scheduler at
    pipeline `depth` over `shards` node shards (0: the local context).
    Returns the measured span's numbers."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = str(depth)
    if shards:
        os.environ["KUBE_TPU_MESH_DEVICES"] = str(shards)
    try:
        store = Store()
        for i in range(args.nodes):
            store.create(scheduling_basic_node(i, args.zones), copy_return=False)
        s = loop_scheduler(store, "cuda", args.wave, args.seed)
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
        os.environ.pop("KUBE_TPU_MESH_DEVICES", None)
    algo = s.algorithms["default-scheduler"]
    if s.loop.pipeline_depth != depth or algo.backend._ctx.n_shards != max(shards, 1):
        fail(f"the loop runs at depth {s.loop.pipeline_depth} on "
             f"{algo.backend._ctx.n_shards} shards, not {depth} on {shards}")
    for i in range(args.init_pods):
        store.create(scheduling_basic_pod(i), copy_return=False)
    s.schedule_pending()
    t0 = time.perf_counter()
    for i in range(args.pods):
        store.create(scheduling_basic_pod(args.init_pods + i), copy_return=False)
    create_s = time.perf_counter() - t0
    prof0 = s.loop.phase_profile.copy()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t1 = time.perf_counter()
    n = s.schedule_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    check_loop(f"phase 22 (a), depth {depth}, {shards or 1} shards", s)
    bound = {p.meta.key: p.spec.node_name for p in store.pods()}
    if n != args.pods or not all(bound.values()):
        fail(f"phase 22 (a): {n} pods scheduled, "
             f"{sum(1 for v in bound.values() if not v)} unbound")
    if bound != serial["bindings"]:
        diff = [k for k, v in serial["bindings"].items() if bound.get(k) != v]
        fail(f"phase 22 (a) depth {depth}, {shards or 1} shards: bindings differ from "
             f"phase 3's on {len(diff)} pods (first {diff[:3]})")
    if algo.rng.getstate() != serial["rng"]:
        fail(f"phase 22 (a) depth {depth}, {shards or 1} shards: final rng state differs "
             f"from phase 3's")
    if launches["static_parts"] <= 0:
        fail("phase 22 (a): K1 never launched")
    scan = "sharded_assign" if shards else "assign_scan"
    other = "assign_scan" if shards else "sharded_assign"
    if launches[scan] <= 0 or launches[other]:
        fail(f"phase 22 (a): launches {launches}: {scan} must launch and {other} not")
    prof = {k: v - prof0[k] for k, v in s.loop.phase_profile.items()}
    return {"pods_s": args.pods / wall, "wall_s": wall, "create_s": create_s,
            "launches": launches, "prof": prof}


def loop_stream(args, device, variant):
    """22 (b), one side: the golden bursts through the port's Scheduler on
    `device`. variant "plain", "spread" (hard zone spread) or "ipa_mesh8"
    (IPA-active waves on 8 node shards). Between bursts: 4 fresh nodes
    (churn), then the deletion of 10 bound pods; a PodGroup of 3 rides as a
    trailer behind the second burst; the last burst exceeds what is left
    (capacity-exhaustion FitErrors). Returns what the card and the CPU
    must agree on, and the launch counts."""
    import kubernetes_tpu_torch.testing.wrappers as w
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import GangPolicy, PodGroup, PodGroupSpec
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.mixed import burst_pods

    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
    if variant == "ipa_mesh8":
        os.environ["KUBE_TPU_MESH_DEVICES"] = "8"
    try:
        store = Store()
        nodes, zones = args.loop_nodes, 4
        for i in range(nodes):
            store.create(w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i % zones}"))
        s = loop_scheduler(store, device, 16, 11)
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
        os.environ.pop("KUBE_TPU_MESH_DEVICES", None)
    spread, ipa = variant == "spread", variant == "ipa_mesh8"
    per = nodes * 4 // 3  # a burst fills about a third of the cluster
    kernels.reset_launches()
    t0 = time.perf_counter()
    for k in range(4):
        if k:
            for j in range(4):
                store.create(w.make_node(f"cn{k}-{j}", cpu="4", mem="8Gi",
                                         zone=f"z{j % zones}"))
            bound = sorted((p for p in store.pods() if p.spec.node_name),
                           key=lambda p: p.meta.name)
            for p in bound[:10]:
                store.delete("Pod", p.meta.key)
        for p in burst_pods(w, k * per, (k + 1) * per + (per if k == 3 else 0),
                            spread=spread, ipa=ipa):
            store.create(p)
        if k == 1:
            store.create(PodGroup(meta=ObjectMeta(name=f"g{k}"),
                                  spec=PodGroupSpec(policy=GangPolicy(min_count=3))))
            for i in range(3):
                store.create(w.with_gang(w.make_pod(f"gang{k}-{i}", cpu="500m", mem="512Mi"),
                                         f"g{k}"))
        s.schedule_pending()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_loop(f"phase 22 (b) {variant} on {device}", s)
    s.event_recorder.flush()
    placed = {p.meta.name: p.spec.node_name for p in store.pods()}
    diags = {p.meta.name: f"{c.reason}: {c.message}" for p in store.pods()
             for c in p.status.conditions if c.type == "PodScheduled" and c.status == "False"}
    algo = s.algorithms["default-scheduler"]
    return ({"placed": placed, "diags": diags, "rng": algo.rng.getstate(),
             "counts": (algo.kernel_count, algo.fallback_count),
             "gangs": dict(s.flight_recorder.gang_pod_totals)},
            launches, wall)


def collected(fn, *a):
    """fn(*a) after a full collection, with every object alive before it
    frozen out of the collector's generations: the objects phases 1-21
    left behind do not weigh on the collections the measured run
    triggers, so runs late in this process compare with each other."""
    gc.collect()
    gc.freeze()
    try:
        return fn(*a)
    finally:
        gc.unfreeze()


def store_loop(args, serial, rates, smi):
    """22. The store-driven loop on the card: (a) SchedulingBasic through
    the port's Scheduler at depth 1, depth 2 and depth 2 on 8 shards, each
    equal to phase 3's bindings and rng, each after the stand-in
    (WavePipeline) at the same depth and context, for the loop's own host
    cost per wave; (b) the mixed loop stream, card against device="cpu"."""
    from kubernetes_tpu_torch.parallel import MeshContext, scheduler_mesh

    t0 = time.perf_counter()
    runs = [("depth 1", 1, 0), ("depth 2", 2, 0), ("depth 2, 8 shards", 2, 8)]
    for label, depth, shards in runs:
        ctx = MeshContext(scheduler_mesh(shards)) if shards else None
        stand = collected(run_pipelined, args, ctx, depth)
        if stand["pipe"].bindings != serial["bindings"]:
            fail(f"phase 22 (a) stand-in at {label}: bindings differ from phase 3's")
        stand_waves, stand_wall = len(stand["log"]), stand["wall_s"]
        del stand, ctx
        r = collected(loop_basic_run, args, serial, depth, shards)
        prof = r["prof"]
        waves = max(int(prof.get("waves", 0)), 1)
        split = ", ".join(f"{k} {v * 1e3 / waves:.3f}" for k, v in prof.items()
                          if k != "waves")
        print(f"(a) SchedulingBasic through the port's Scheduler, {label}: every pod bound, "
              f"bindings and rng equal to phase 3's; measured {args.pods} pods in {waves} "
              f"waves, {r['wall_s']:.3f} s = {r['pods_s']:.1f} pods/s on {smi} "
              f"(store writes of the measured pods before it: {r['create_s']:.3f} s); "
              f"launches {r['launches']}")
        print(f"(a) {label}: loop phase_profile, host ms per wave: {split}; "
              f"outside the loop's phases "
              f"{(r['wall_s'] - sum(v for k, v in prof.items() if k != 'waves')) * 1e3 / waves:.3f}")
        print(f"(a) {label}: the stand-in (WavePipeline, same depth and context, just "
              f"before) {args.pods / stand_wall:.1f} pods/s, {stand_wall * 1e3 / stand_waves:.3f} "
              f"ms per wave; the loop's own host cost "
              f"{(r['wall_s'] - stand_wall) * 1e3 / waves:.3f} ms per wave "
              f"({(r['wall_s'] - stand_wall) * 1e6 / args.pods:.1f} us per pod)")
    print("(a) rates of the same traffic in this call (pods/s): "
          + "; ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    for variant in ("plain", "spread", "ipa_mesh8"):
        card, la, wall_c = loop_stream(args, "cuda", variant)
        cpu, _, wall_p = loop_stream(args, "cpu", variant)
        if card != cpu:
            which = [k for k in card if card[k] != cpu[k]]
            fail(f"phase 22 (b) {variant}: card and CPU differ on {which}")
        n_bound = sum(1 for v in card["placed"].values() if v)
        if not card["diags"] or n_bound == 0:
            fail(f"phase 22 (b) {variant}: the stream must bind pods and leave FitErrors")
        if variant != "ipa_mesh8" and not card["gangs"].get("device"):
            fail(f"phase 22 (b) {variant}: the gang trailer did not take the device path")
        print(f"(b) mixed loop stream, {variant}: card == CPU ({len(card['placed'])} pods, "
              f"{n_bound} bound, {len(card['diags'])} FitErrors; kernel/fallback counts "
              f"{card['counts']}, gang members by path {card['gangs']}); launches on the card "
              f"{la}; {wall_c:.2f} s on the card, {wall_p:.2f} s on the CPU")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 23: the benchmark's cells
# --------------------------------------------------------------------------

# BENCHMARK.json's cells and the kernels each must launch in its measured span
BENCH_CELLS = {"SchedulingBasic_5000Nodes_10000Pods": ("static_parts", "assign_scan"),
               "SchedulingNodeDeclaredFeatures_1000Nodes": ("fit_and_score",)}


def bench_cells(args):
    """23. Each BENCHMARK.json cell once at full size through
    kubernetes_tpu_torch/perf/bench.py, in a process of its own (the
    kernels this run built are reused): the bench's correctness check must
    hold and the cell's kernels must have launched in its measured span."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("KUBE_TPU_")}
    for cell, needs in BENCH_CELLS.items():
        t1 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.perf.bench",
                                "--cell", cell, "--seed", str(args.seed)],
                               cwd=root, env=env, capture_output=True, text=True,
                               timeout=args.phase_timeout)
        except subprocess.TimeoutExpired:
            fail(f"phase 23: the bench of {cell} did not end within {args.phase_timeout:.0f} s")
        if r.returncode != 0:
            fail(f"phase 23: the bench of {cell} exited {r.returncode}: "
                 f"{(r.stdout + r.stderr)[-2000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        if not line["correct"] or line["scheduled"] != line["attempted"]:
            fail(f"phase 23 {cell}: correct {line['correct']}, {line['scheduled']} of "
                 f"{line['attempted']} pods bound: {line['violation_examples']}")
        missing = [k for k in needs if line["launches"][k] <= 0]
        if missing:
            fail(f"phase 23 {cell}: {missing} never launched in the measured span "
                 f"(launches {line['launches']})")
        phases = ", ".join(f"{k} {v:.1f}" for k, v in line["host_us_per_pod"].items())
        print(f"(23) {cell}: {line['pods_per_s']} pods/s on {line['device']}, "
              f"{line['power_limit']} (threshold {line['threshold']}, "
              f"passed {line['threshold_passed']}); {line['scheduled']} of "
              f"{line['attempted']} pods bound, correct; SLI p50 {line['sli_p50_s']} s, "
              f"p99 {line['sli_p99_s']} s; launches {line['launches']}; host us per "
              f"measured pod: {phases}; {time.perf_counter() - t1:.1f} s")
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 24: DefaultPreemption
# --------------------------------------------------------------------------


class PreemptionProbe:
    """Counts and host-clock seconds of DefaultPreemption's steps, by
    wrapping the plugin's methods for the duration of a run (the plugin
    itself keeps no counters): PostFilter calls and seconds, the executor's
    seconds and victims, candidates ranked (_candidate_rank runs once per
    candidate), nodes the batched scan decided and nodes the per-node
    path searched."""

    def __init__(self):
        from kubernetes_tpu_torch.scheduler.plugins import default_preemption as dp

        self.dp = dp
        self.n = {"post_filter": 0, "post_filter_s": 0.0, "executor_s": 0.0,
                  "victims": 0, "candidates": 0, "batched_nodes": 0, "per_node": 0}
        self._saved = []

    def _wrap(self, owner, name, make):
        orig = owner.__dict__[name]
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def __enter__(self):
        dp, n = self.dp, self.n

        def post_filter(orig):
            def wrapped(plugin, state, pod, statuses):
                t0 = time.perf_counter()
                try:
                    return orig(plugin, state, pod, statuses)
                finally:
                    n["post_filter"] += 1
                    n["post_filter_s"] += time.perf_counter() - t0
            return wrapped

        def prepare(orig):
            def wrapped(executor, candidate, preemptor, pdbs):
                t0 = time.perf_counter()
                try:
                    return orig(executor, candidate, preemptor, pdbs)
                finally:
                    n["executor_s"] += time.perf_counter() - t0
                    n["victims"] += len(candidate.victims)
            return wrapped

        def batch(orig):
            def wrapped(plugin, *a):
                out = orig(plugin, *a)
                n["batched_nodes"] += len(out)
                return out
            return wrapped

        def per_node(orig):
            def wrapped(plugin, *a, **kw):
                n["per_node"] += 1
                return orig(plugin, *a, **kw)
            return wrapped

        def rank(orig):
            def wrapped(c):
                n["candidates"] += 1
                return orig.__func__(c)
            return staticmethod(wrapped)

        self._wrap(dp.DefaultPreemption, "post_filter", post_filter)
        self._wrap(dp.PreemptionExecutor, "prepare_candidate", prepare)
        self._wrap(dp.DefaultPreemption, "_batch_select_victims", batch)
        self._wrap(dp.DefaultPreemption, "_select_victims_on_node", per_node)
        self._wrap(dp.DefaultPreemption, "_candidate_rank", rank)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        return False


class VirtualClock:
    """The scheduler's clock for runs the card and the CPU must decide
    alike: each reading 1 us past the last, so no backoff expires within a
    run and an idle queue pops its backoff pods by expiry (wall-clock
    expiry would make two runs at different speeds pop in different
    orders)."""

    def __init__(self):
        self.t = 1000.0

    def __enter__(self):
        from kubernetes_tpu_torch.utils import clock

        self._cls, self._now = clock.Clock, clock.Clock.now
        clock.Clock.now = lambda _self: self._tick()
        return self

    def _tick(self):
        self.t += 1e-6
        return self.t

    def __exit__(self, *exc):
        self._cls.now = self._now
        return False


def preemption_run(workload, device, wave, measure_pods=None):
    """One scheduler_perf Preemption workload through the port's
    WorkloadExecutor on `device` (with `measure_pods` preemptors in place
    of the workload's count when given), the launches counted over the
    measured span (zeroed where the harness starts collecting, read where
    it stops), every eviction recorded. Returns the run's facts."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf.harness import WorkloadExecutor, load_config

    case_name, wl_name = workload.split("/")
    root = os.path.dirname(os.path.abspath(__file__))
    cases = load_config(os.path.join(root, "kubernetes_tpu_torch/perf/configs/misc.json"))
    case = next(c for c in cases if c["name"] == case_name)
    wl = next(w for w in case["workloads"] if w["name"] == wl_name)
    if measure_pods is not None:
        wl = dict(wl, params=dict(wl["params"], measurePods=measure_pods))

    class Executor(WorkloadExecutor):
        def _start_collecting(self):
            if device == "cuda":
                torch.cuda.synchronize()
            kernels.reset_launches()
            super()._start_collecting()

        def _stop_collecting(self):
            if device == "cuda":
                torch.cuda.synchronize()
            self.launches = dict(kernels.LAUNCHES)
            super()._stop_collecting()

    ex = Executor(case, wl, wave_size=wave, device=device)
    evicted = []
    delete = ex.store.delete

    def recorded_delete(kind, key):
        out = delete(kind, key)
        if kind == "Pod":
            evicted.append(out)
        return out

    ex.store.delete = recorded_delete
    with PreemptionProbe() as probe:
        result = ex.run()
    algo = ex.scheduler.algorithms["default-scheduler"]
    check_loop(f"phase 24 {workload} on {device}", ex.scheduler)
    pods = ex.store.pods()
    return {"result": result, "pods": pods, "nodes": ex.store.nodes(), "evicted": evicted,
            "launches": ex.launches, "probe": dict(probe.n), "rng": algo.rng.getstate(),
            "counts": (algo.kernel_count, algo.fallback_count),
            "span_s": ex.collect_stopped_at - ex.collect_started_at,
            "phases": {k: v - ex.profile_at_start.get(k, 0)
                       for k, v in ex.profile_at_stop.items()},
            "params": wl["params"]}


def check_preemption(label, r):
    """Every preemptor bound, every evicted pod of lower priority than the
    preemptor on its node, no node over its CPU, memory or pod count (the
    port's Cache over the store's final objects)."""
    from kubernetes_tpu_torch.api.resource import CPU, MEM, PODS, ResourceNames
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot

    pres = [p for p in r["pods"] if p.spec.priority > 0]
    if len(pres) != r["params"]["measurePods"] or not all(p.spec.node_name for p in pres):
        fail(f"{label}: {sum(1 for p in pres if p.spec.node_name)} of "
             f"{r['params']['measurePods']} preemptors bound")
    on_node = {p.spec.node_name: p.spec.priority for p in pres}
    for v in r["evicted"]:
        if v.spec.priority >= on_node.get(v.spec.node_name, -1):
            fail(f"{label}: {v.meta.key} (priority {v.spec.priority}) evicted from "
                 f"{v.spec.node_name}, whose preemptor has priority "
                 f"{on_node.get(v.spec.node_name)}")
    cache = Cache(ResourceNames())
    for n in r["nodes"]:
        cache.add_node(n)
    for p in r["pods"]:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    for ni in snap.list_nodes():
        if (ni.requested[CPU] > ni.allocatable[CPU] or ni.requested[MEM] > ni.allocatable[MEM]
                or len(ni.pods) > ni.allocatable[PODS]):
            fail(f"{label}: node {ni.name} over capacity: {len(ni.pods)} pods, "
                 f"requested {list(ni.requested.v)} of {list(ni.allocatable.v)}")


def preemption_full_width(args, smi):
    """24 (a). PreemptionAsync at full width through the port's
    WorkloadExecutor on the card: its invariants, launches and rates."""
    t0 = time.perf_counter()
    label = f"phase 24 (a) {args.preempt_workload}"
    r = collected(preemption_run, args.preempt_workload, "cuda", args.wave, args.preempt_pods)
    check_preemption(label, r)
    pres = r["params"]["measurePods"]
    la, pr = r["launches"], r["probe"]
    if la["fit_and_score"] < pres:
        fail(f"{label}: K4 launched {la['fit_and_score']} times for {pres} preemptors")
    if la["static_parts"] <= 0 or la["assign_scan"] <= 0:
        fail(f"{label}: K1 and K2 must launch in the measured span: {la}")
    if pr["post_filter"] < pres or not r["evicted"]:
        fail(f"{label}: {pr['post_filter']} PostFilter calls, {len(r['evicted'])} evictions")
    dry_s = pr["post_filter_s"] - pr["executor_s"]
    print(f"(24a) {args.preempt_workload}: {pres} preemptors bound over "
          f"{r['params']['initNodes']} nodes and {r['params']['initPods']} victims, "
          f"{r['result'].throughput} preemptors/s (harness average; {pres / r['span_s']:.1f} "
          f"over the measured span of {r['span_s']:.3f} s) on {smi}; upstream threshold "
          f"{r['result'].threshold}")
    print(f"(24a) PostFilter calls {pr['post_filter']}, candidates per call "
          f"{pr['candidates'] / pr['post_filter']:.1f}, nodes decided by the batched scan "
          f"{pr['batched_nodes']}, by the per-node path {pr['per_node']}; evictions "
          f"{len(r['evicted'])} (victims chosen {pr['victims']}); kernel/fallback counts "
          f"{r['counts']}; launches in the measured span {la}")
    print(f"(24a) host ms per preemptor: dry run {dry_s * 1e3 / pres:.3f}, executor "
          f"{pr['executor_s'] * 1e3 / pres:.3f}; per PostFilter call: dry run "
          f"{dry_s * 1e3 / pr['post_filter']:.3f}; the loop's stopwatches over the "
          f"measured span, s: "
          + ", ".join(f"{k} {v:.3f}" for k, v in r["phases"].items())
          + f"; phase 24 (a) {time.perf_counter() - t0:.1f} s")


def preemption_card_vs_cpu(args):
    """24 (b). PreemptionBasic runs (synchronous evictions) on the card and
    with device="cpu" on the virtual clock: bindings, nominations,
    evictions, rng and counts equal."""
    t0 = time.perf_counter()
    for workload in args.preempt_cpu_workloads.split(","):
        out = {}
        for device in ("cuda", "cpu"):
            with VirtualClock():
                t1 = time.perf_counter()
                r = collected(preemption_run, workload, device, args.wave)
                wall = time.perf_counter() - t1
            check_preemption(f"phase 24 (b) {workload} on {device}", r)
            out[device] = ({p.meta.key: (p.spec.node_name, p.status.nominated_node_name)
                            for p in r["pods"]},
                           sorted(v.meta.key for v in r["evicted"]), r["rng"], r["counts"])
            print(f"(24b) {workload} on {device}: {r['params']['measurePods']} preemptors "
                  f"bound, {len(r['evicted'])} evictions, {r['probe']['post_filter']} "
                  f"PostFilter calls, launches {r['launches']}, {wall:.2f} s")
        if out["cuda"] != out["cpu"]:
            which = [n for n, a, b in zip(("bindings and nominations", "evictions", "rng",
                                           "counts"), out["cuda"], out["cpu"]) if a != b]
            fail(f"phase 24 (b) {workload}: card and CPU differ on {which}")
        print(f"(24b) {workload}: card == CPU (bindings, nominations, evictions, rng, "
              f"kernel/fallback counts)")
    print(f"phase 24 (b): {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 25: the storage, DRA and extender half of the host tier
# --------------------------------------------------------------------------

K1_K4 = ("static_parts", "assign_scan", "scatter_rows", "fit_and_score")
# volumes.json's and dra.json's short workloads, run on the card and the CPU
# the extender stream's nodes and pods at full width, and its size card vs CPU
EXT_NODES, EXT_PODS = 500, 1024
EXT_CPU_NODES, EXT_CPU_PODS = 40, 256
STORAGE_SHORT = ("volumes.json:SchedulingWFFCVolumes/20Nodes",
                 "volumes.json:SchedulingInTreePVs/5Nodes",
                 "volumes.json:SchedulingCSIPVs/5Nodes",
                 "volumes.json:SchedulingMigratedInTreePVs/5Nodes",
                 "dra.json:SchedulingWithResourceClaims/20Nodes")


class RouteProbe:
    """The per-pod cycle's routes, by wrapping TorchSchedulingAlgorithm for
    the duration of a run: schedule_pod calls (the per-pod cycle: kernel,
    hybrid or host) and _schedule_hybrid calls. With the algorithm's
    counters read at the same instants, the pods the waves placed are its
    kernel count less the per-pod cycles that ran K4."""

    def __init__(self):
        from kubernetes_tpu_torch.scheduler.tpu import backend

        self.cls = backend.TorchSchedulingAlgorithm
        self.n = {"per_pod": 0, "hybrid": 0}

    def __enter__(self):
        cls, n = self.cls, self.n
        self._saved = (cls.schedule_pod, cls._schedule_hybrid)
        schedule_pod, hybrid = self._saved

        def counted_schedule_pod(algo, *a, **kw):
            n["per_pod"] += 1
            return schedule_pod(algo, *a, **kw)

        def counted_hybrid(algo, *a, **kw):
            n["hybrid"] += 1
            return hybrid(algo, *a, **kw)

        cls.schedule_pod, cls._schedule_hybrid = counted_schedule_pod, counted_hybrid
        return self

    def snapshot(self, algo):
        return dict(self.n, kernel=algo.kernel_count, host=algo.fallback_count)

    def __exit__(self, *exc):
        self.cls.schedule_pod, self.cls._schedule_hybrid = self._saved
        return False


def route_shares(a, b):
    """Pods by route between two RouteProbe snapshots."""
    d = {k: b[k] - a[k] for k in a}
    per_pod_k4 = d["per_pod"] - d["host"]
    return {"wave": d["kernel"] - per_pod_k4, "hybrid": d["hybrid"],
            "kernel": per_pod_k4 - d["hybrid"], "host": d["host"]}


def fmt_routes(r):
    total = max(sum(r.values()), 1)
    return ", ".join(f"{k} {v} ({100.0 * v / total:.1f} %)" for k, v in r.items())


def check_storage(label, store):
    """From the store: every pod bound; every claim bound to one volume of
    its class, access modes and capacity, no volume bound twice; no node
    over its CSI attach limit; every allocated device on its pod's node and
    no device allocated twice."""
    from kubernetes_tpu_torch.api.storage import pod_claim_names

    pods = store.pods()
    unbound = [p.meta.key for p in pods if not p.spec.node_name]
    if unbound:
        fail(f"{label}: {len(unbound)} of {len(pods)} pods unbound, e.g. {unbound[:3]}")
    pvs = {v.meta.name: v for v in store.list("PersistentVolume")[0]}
    pvcs = {c.meta.key: c for c in store.list("PersistentVolumeClaim")[0]}
    claimed = set()
    for c in pvcs.values():
        pv = pvs.get(c.spec.volume_name)
        if c.status.phase != "Bound" or pv is None or pv.spec.claim_ref != c.meta.key:
            fail(f"{label}: claim {c.meta.key} not bound to a volume that names it "
                 f"({c.status.phase}, {c.spec.volume_name!r})")
        if (pv.spec.storage_class_name != c.spec.storage_class_name
                or not set(c.spec.access_modes) <= set(pv.spec.access_modes)
                or pv.storage_capacity < c.requested_storage):
            fail(f"{label}: claim {c.meta.key} bound to {pv.meta.name} of another class, "
                 f"access mode or a smaller capacity")
        if pv.meta.name in claimed:
            fail(f"{label}: volume {pv.meta.name} bound twice")
        claimed.add(pv.meta.name)
    attached: dict = {}
    for p in pods:
        for name in pod_claim_names(p):
            pv = pvs[pvcs[f"{p.meta.namespace}/{name}"].spec.volume_name]
            if pv.spec.csi_driver:
                attached.setdefault((p.spec.node_name, pv.spec.csi_driver), set()).add(
                    pv.meta.name)
    limits = {c.meta.name: c for c in store.list("CSINode")[0]}
    for (node, driver), vols in attached.items():
        limit = limits[node].limit_for(driver) if node in limits else 0
        if limit and len(vols) > limit:
            fail(f"{label}: node {node} holds {len(vols)} {driver} volumes, limit {limit}")
    where = {}
    for sl in store.list("ResourceSlice")[0]:
        pool = sl.pool if sl.all_nodes else f"{sl.node_name}/{sl.pool}"
        for dev in sl.devices:
            where[(sl.driver, pool, dev.name)] = sl.node_name
    node_of = {p.meta.key: p.spec.node_name for p in pods}
    taken = set()
    for c in store.list("ResourceClaim")[0]:
        a = c.status.allocation
        if a is None or not c.status.reserved_for:
            fail(f"{label}: claim {c.meta.key} not allocated and reserved")
        for key in c.status.reserved_for:
            if node_of.get(key) != a.node_name:
                fail(f"{label}: claim {c.meta.key} allocated on {a.node_name}, its pod "
                     f"{key} on {node_of.get(key)}")
        for d in a.devices:
            k = (d.driver, d.pool, d.device)
            if where.get(k) != a.node_name or k in taken:
                fail(f"{label}: device {k} of {c.meta.key} not on {a.node_name} or taken twice")
            taken.add(k)
    return {"pods": len(pods), "claims": len(pvcs), "csi": sum(map(len, attached.values())),
            "devices": len(taken)}


def storage_run(workload, device, wave):
    """One volumes.json or dra.json workload ("config:case/workload") through
    the port's StorageWorkloadExecutor on `device`; the launches and routes
    counted over the measured span (zeroed where the harness starts
    collecting, read where it stops)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.perf.harness import load_config
    from kubernetes_tpu_torch.testing.storage_workloads import StorageWorkloadExecutor

    config, name = workload.split(":")
    case_name, wl_name = name.split("/")
    root = os.path.dirname(os.path.abspath(__file__))
    cases = load_config(os.path.join(root, "kubernetes_tpu_torch/perf/configs", config))
    case = next(c for c in cases if c["name"] == case_name)
    wl = next(w for w in case["workloads"] if w["name"] == wl_name)
    probe = RouteProbe()

    class Executor(StorageWorkloadExecutor):
        def _start_collecting(self):
            if device == "cuda":
                torch.cuda.synchronize()
            kernels.reset_launches()
            self.routes_at_start = probe.snapshot(self.scheduler.algorithms["default-scheduler"])
            super()._start_collecting()

        def _stop_collecting(self):
            if device == "cuda":
                torch.cuda.synchronize()
            self.launches = dict(kernels.LAUNCHES)
            self.routes = route_shares(self.routes_at_start, probe.snapshot(
                self.scheduler.algorithms["default-scheduler"]))
            super()._stop_collecting()

    with probe:
        ex = Executor(case, wl, wave_size=wave, device=device)
        t0 = time.perf_counter()
        result = ex.run()
        wall = time.perf_counter() - t0
    check_loop(f"phase 25 {workload} on {device}", ex.scheduler)
    algo = ex.scheduler.algorithms["default-scheduler"]
    return {"ex": ex, "result": result, "wall": wall, "params": wl["params"],
            "launches": ex.launches, "routes": ex.routes,
            "span_s": ex.collect_stopped_at - ex.collect_started_at,
            "rng": algo.rng.getstate(), "counts": (algo.kernel_count, algo.fallback_count)}


def storage_outcome(store):
    """Bindings, volume bindings and device allocations, comparable across
    devices (a provisioned volume by its claim)."""
    pods = {p.meta.key: p.spec.node_name for p in store.pods()}
    pvcs = {c.meta.key: c.spec.volume_name for c in store.list("PersistentVolumeClaim")[0]}
    pvs = {v.meta.name: v.spec.claim_ref for v in store.list("PersistentVolume")[0]}
    claims = {c.meta.key: (c.status.allocation.node_name,
                           [(d.request, d.driver, d.pool, d.device)
                            for d in c.status.allocation.devices],
                           tuple(c.status.reserved_for))
              for c in store.list("ResourceClaim")[0] if c.status.allocation is not None}
    return pods, pvcs, pvs, claims


def storage_cell(label, workload, args, smi, needs=()):
    """25 (a)-(c): one workload on the card, its store checks, launches,
    routes and rates."""
    t0 = time.perf_counter()
    r = collected(storage_run, workload, "cuda", args.wave)
    facts = check_storage(f"phase 25 {label}", r["ex"].store)
    measured = r["params"]["measurePods"]
    la, routes = r["launches"], r["routes"]
    missing = [k for k in needs if la[k] <= 0]
    if missing:
        fail(f"phase 25 {label}: {missing} never launched in the measured span ({la})")
    per_pod = routes["hybrid"] + routes["kernel"]
    if per_pod and la["fit_and_score"] < per_pod:
        fail(f"phase 25 {label}: K4 launched {la['fit_and_score']} times for {per_pod} "
             f"per-pod cycles")
    if routes["host"]:
        fail(f"phase 25 {label}: {routes['host']} pods took the host algorithm")
    print(f"(25{label}) {workload} {r['params']}: {measured} measured pods, "
          f"{r['result'].throughput} pods/s (harness average; {measured / r['span_s']:.1f} over "
          f"the measured span of {r['span_s']:.3f} s) on {smi}; upstream threshold "
          f"{r['result'].threshold}; {facts}")
    print(f"(25{label}) launches in the measured span: "
          + ", ".join(f"{k} {la[k]}" for k in K1_K4)
          + f"; pods by route: {fmt_routes(routes)}; run {r['wall']:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s")
    return r


class InProcessExtender:
    """The HTTPExtender interface answered in this process (the HTTP wire
    format is the CPU tests' business): interested in pods with a limit on
    example.com/foo; filter drops every node whose index is a multiple of
    7; prioritize scores node i (37 i mod 11) at weight 2; as a binder it
    writes the binding into the store."""

    name = "in-process"
    MANAGED = "example.com/foo"

    def __init__(self, store, binder=False):
        self.store, self.binder = store, binder
        self.calls = {"filter": 0, "prioritize": 0, "bind": 0}

    def is_ignorable(self):
        return False

    def is_binder(self):
        return self.binder

    def is_filter(self):
        return True

    def is_prioritizer(self):
        return True

    def is_interested(self, pod):
        return any(self.MANAGED in c.limits for c in pod.spec.containers)

    @staticmethod
    def index(name):
        return int(name.rsplit("-", 1)[1])

    def filter(self, pod, nodes):
        self.calls["filter"] += 1
        keep = [ni for ni in nodes if self.index(ni.name) % 7]
        return keep, {ni.name: "reserved by the extender" for ni in nodes
                      if not self.index(ni.name) % 7}, {}

    def prioritize(self, pod, nodes):
        self.calls["prioritize"] += 1
        return {ni.name: (37 * self.index(ni.name)) % 11 for ni in nodes}, 2

    def bind(self, pod, node_name):
        from kubernetes_tpu_torch.scheduler.framework.interface import Status

        self.calls["bind"] += 1
        self.store.bind_pod(pod.meta.key, node_name)
        return Status()


def extender_stream(n_nodes, n_pods, device, wave, binder, seed):
    """25 (d): blocks of 64 plain pods and 64 pods the extender is
    interested in over n_nodes SchedulingBasic nodes, through the port's
    Scheduler with the in-process extender (filter and prioritize; and
    bind when `binder`). Returns the store, the launches and routes over
    the measured pods, the rate and the extender's calls."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    store = Store()
    for i in range(n_nodes):
        store.create(scheduling_basic_node(i), copy_return=False)
    ext = InProcessExtender(store, binder=binder)
    s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=wave)], seed=seed,
                  clock=StrictClock(), device=device, extenders=[ext])
    s.start()
    algo = s.algorithms["default-scheduler"]
    interested = []
    for i in range(n_pods):
        pod = scheduling_basic_pod(i)
        if (i // 64) % 2:
            pod.spec.containers[0].limits = {InProcessExtender.MANAGED: "1"}
            interested.append(pod.meta.key)
        store.create(pod, copy_return=False)
    s.pump()
    with RouteProbe() as probe:
        if device == "cuda":
            torch.cuda.synchronize()
        kernels.reset_launches()
        a = probe.snapshot(algo)
        t0 = time.perf_counter()
        for _ in range(20):
            s.schedule_pending()
            s.pump()
            if all(p.spec.node_name for p in store.pods()):
                break
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        routes = route_shares(a, probe.snapshot(algo))
    check_loop(f"phase 25 (d) on {device}", s)
    for key in interested:
        node = store.get("Pod", key).spec.node_name
        if node and not InProcessExtender.index(node) % 7:
            fail(f"phase 25 (d): {key} on {node}, which the extender filtered out")
    return {"store": store, "launches": launches, "routes": routes, "wall": wall,
            "calls": dict(ext.calls), "interested": len(interested), "rng": algo.rng.getstate()}


def storage_full_width(args, smi):
    """25 (a)-(d) on the card at full width, each under the watchdog."""
    t0 = time.perf_counter()
    for label, workload, needs in (
            ("(a)", "volumes.json:SchedulingWFFCVolumes/5000Nodes_2000Pods",
             ("static_parts", "assign_scan")),
            ("(b)", "volumes.json:SchedulingCSIPVs/5000Nodes_5000Pods",
             ("fit_and_score", "scatter_rows")),
            ("(c)", "dra.json:SchedulingWithResourceClaims/5000pods_500nodes",
             ("fit_and_score", "scatter_rows"))):
        with watchdog(f"phase 25 {label} ({workload})", args.phase_timeout):
            storage_cell(f" {label}", workload, args, smi, needs=needs)
    for binder in (False, True):
        t1 = time.perf_counter()
        with watchdog(f"phase 25 (d) (the extender stream{', binder' if binder else ''})",
                      args.phase_timeout):
            r = collected(extender_stream, EXT_NODES, EXT_PODS, "cuda", args.wave,
                          binder, args.seed)
        facts = check_storage("phase 25 (d)", r["store"])
        la, routes = r["launches"], r["routes"]
        if la["fit_and_score"] < r["interested"] or la["assign_scan"] <= 0:
            fail(f"phase 25 (d): K4 {la['fit_and_score']} launches for {r['interested']} "
                 f"interested pods, K2 {la['assign_scan']}")
        if routes["hybrid"] < r["interested"] or (binder and r["calls"]["bind"] != r["interested"]):
            fail(f"phase 25 (d): routes {routes}, extender calls {r['calls']} for "
                 f"{r['interested']} interested pods")
        print(f"(25 (d)) extender stream{' (binder)' if binder else ''}: {EXT_PODS} pods "
              f"({r['interested']} interested) over {EXT_NODES} nodes, "
              f"{EXT_PODS / r['wall']:.1f} pods/s on {smi}; extender calls {r['calls']}; "
              f"launches " + ", ".join(f"{k} {la[k]}" for k in K1_K4)
              + f"; pods by route: {fmt_routes(routes)}; {facts}; "
              f"{time.perf_counter() - t1:.1f} s")
    print(f"phase 25 (a)-(d): {time.perf_counter() - t0:.1f} s")


def storage_card_vs_cpu(args):
    """25 (e): the short workloads of volumes.json and dra.json, and the
    extender stream at a short size, on the card and with device="cpu" on
    the virtual clock: bindings, volume bindings, device allocations and
    rng equal."""
    t0 = time.perf_counter()
    for workload in STORAGE_SHORT:
        out, launches = {}, {}
        for device in ("cuda", "cpu"):
            with VirtualClock():
                r = collected(storage_run, workload, device, 32)
            check_storage(f"phase 25 (e) {workload} on {device}", r["ex"].store)
            out[device] = storage_outcome(r["ex"].store) + (r["rng"], r["counts"])
            launches[device] = r["launches"]
        if out["cuda"] != out["cpu"]:
            which = [n for n, a, b in zip(("bindings", "claims", "volumes", "devices", "rng",
                                           "counts"), out["cuda"], out["cpu"]) if a != b]
            fail(f"phase 25 (e) {workload}: card and CPU differ on {which}")
        card = launches["cuda"]
        print(f"(25 (e)) {workload}: card == CPU ({len(out['cpu'][0])} pods, "
              f"{len(out['cpu'][1])} claims, {len(out['cpu'][3])} resource claims; "
              f"launches on the card " + ", ".join(f"{k} {card[k]}" for k in K1_K4) + ")")
    for binder in (False, True):
        out = {}
        for device in ("cuda", "cpu"):
            with VirtualClock():
                r = extender_stream(EXT_CPU_NODES, EXT_CPU_PODS, device, 32, binder,
                                    args.seed)
            out[device] = (storage_outcome(r["store"])[0], r["calls"], r["rng"])
        if out["cuda"] != out["cpu"]:
            fail(f"phase 25 (e) extender stream (binder {binder}): card and CPU differ")
        print(f"(25 (e)) extender stream{' (binder)' if binder else ''}, "
              f"{EXT_CPU_PODS} pods over {EXT_CPU_NODES} nodes: card == CPU "
              f"(bindings, extender calls {out['cpu'][1]}, rng)")
    print(f"phase 25 (e): {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 26: the telemetry the loop and the backend write
# --------------------------------------------------------------------------

# every non-timing field of a wave record (WaveRecord.to_dict() less the
# clocks, the phases and the stall attribution drawn from them)
RECORD_TIMING = ("started_at", "duration_s", "overlap_s", "phases", "stall_by_reason",
                 "stall_coverage", "stall_dominant", "profile")
TELEMETRY_PARTS_OFF = ("pod_ledger", "stall_profiler", "device_telemetry")


def telemetry_scheduler(store, device, wave, seed, on, gates=None, async_api=False):
    """The port's Scheduler with every telemetry part on (a SchedulerMetrics,
    a tracer with an in-memory exporter, the recorder's ledger, profiler and
    device telemetry) or every part off."""
    from kubernetes_tpu_torch.scheduler.metrics import SchedulerMetrics
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
    from kubernetes_tpu_torch.utils.tracing import InMemoryExporter, Tracer

    kw = {}
    if on:
        kw = {"metrics": SchedulerMetrics(),
              "tracer": Tracer("chip_smoke", InMemoryExporter(capacity=4096))}
    s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=wave)], seed=seed,
                  clock=StrictClock(), device=device, feature_gates=gates or {},
                  async_api_calls=async_api, **kw)
    for part in TELEMETRY_PARTS_OFF:
        getattr(s.flight_recorder, part).enabled = on
    s.start()
    return s


def telemetry_view(s):
    """What the card and the CPU must agree on: every non-timing field of
    every wave record, each completed pod's ledger edge sequence, the
    plugin observations per (plugin, extension point) and the compiles per
    kernel."""
    fr = s.flight_recorder
    records = [{k: v for k, v in r.to_dict().items() if k not in RECORD_TIMING}
               for r in fr.records()]
    ledger = [(e.key, tuple(e.stamps)) for e in fr.pod_ledger._completed]
    obs = ({k: st.count for k, st in s.metrics.plugin_execution_duration.values.items()}
           if s.metrics is not None else {})
    compiles = fr.device_telemetry.snapshot()["compiles"]["by_kernel"]
    return {"records": records, "ledger": ledger, "observations": obs,
            "compiles": compiles}


def sb_telemetry_run(args, on):
    """26 (a), one run: SchedulingBasic/5000Nodes_10000Pods through the
    port's Scheduler at depth 2 with async API calls (the benchmark cell's
    loop), every telemetry part on or off."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
    try:
        store = Store()
        for i in range(args.nodes):
            store.create(scheduling_basic_node(i, args.zones), copy_return=False)
        s = telemetry_scheduler(store, "cuda", args.wave, args.seed, on, async_api=True)
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
    for i in range(args.init_pods):
        store.create(scheduling_basic_pod(i), copy_return=False)
    s.schedule_pending()
    for i in range(args.pods):
        store.create(scheduling_basic_pod(args.init_pods + i), copy_return=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    n = s.schedule_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_loop(f"phase 26 (a), telemetry {'on' if on else 'off'}", s)
    bound = {p.meta.key: p.spec.node_name for p in store.pods()}
    if n != args.pods or not all(bound.values()):
        fail(f"phase 26 (a): {n} pods scheduled, "
             f"{sum(1 for v in bound.values() if not v)} unbound")
    if launches["static_parts"] <= 0 or launches["assign_scan"] <= 0:
        fail(f"phase 26 (a): K1 and K2 must launch in the measured span: {launches}")
    out = {"bindings": bound, "rng": s.algorithms["default-scheduler"].rng.getstate(),
           "pods_s": args.pods / wall, "launches": launches, "s": s,
           "max_allocated": torch.cuda.max_memory_allocated()}
    if s.api_dispatcher is not None:
        s.api_dispatcher.close()
    return out


def on_off_runs(run, args, label):
    """`run(args, on)` four times, on, off, off, on (one pair each way: a
    run's place in the process moves its rate), every run's bindings and
    rng equal to the first's. Returns the first on run, the first off run
    and the four rates."""
    runs = []
    for on in (True, False, False, True):
        r = collected(run, args, on)
        if runs and (r["bindings"] != runs[0]["bindings"] or r["rng"] != runs[0]["rng"]):
            diff = [k for k, v in runs[0]["bindings"].items() if r["bindings"].get(k) != v]
            fail(f"{label}: telemetry on and off differ: {len(diff)} bindings (first "
                 f"{diff[:3]}), rng equal {r['rng'] == runs[0]['rng']}")
        if len(runs) >= 2:
            r.pop("s")  # keep the first on and off runs' schedulers only
        runs.append(r)
    rates = [r["pods_s"] for r in runs]
    return runs[0], runs[1], rates


def on_off_line(rates):
    on = (rates[0] + rates[3]) / 2
    off = (rates[1] + rates[2]) / 2
    return (f"telemetry on {rates[0]:.1f}, {rates[3]:.1f} pods/s, off {rates[1]:.1f}, "
            f"{rates[2]:.1f} pods/s (on, off, off, on; cost of the means "
            f"{(1 - on / off) * 100:.2f} %)")


def sb_telemetry(args, smi):
    """26 (a): SchedulingBasic at full width with every telemetry part on
    and off (on, off, off, on): identical bindings and rng; the first on
    run's telemetry printed."""
    from kubernetes_tpu_torch.scheduler.tpu.stallprofiler import critical_path

    on, off, rates = on_off_runs(sb_telemetry_run, args, "phase 26 (a)")
    s = on["s"]
    fr = s.flight_recorder
    recs = fr.records()
    if not recs or fr.pod_ledger.completed_total < args.pods:
        fail(f"phase 26 (a): {len(recs)} wave records, "
             f"{fr.pod_ledger.completed_total} ledger entries")
    if off["s"].flight_recorder.pod_ledger.completed_total:
        fail("phase 26 (a): the ledger stamped with its part off")
    print(f"(26 (a)) SchedulingBasic through the port's Scheduler (depth 2, async API "
          f"calls) on {smi}: {on_off_line(rates)}; bindings and rng equal; launches on "
          f"{on['launches']}, off {off['launches']}")
    stalls = critical_path([r.to_dict() for r in recs])
    print(f"(26 (a)) wave records {len(recs)} (of {int(fr.phase_snapshot()['waves'])} "
          f"launched); wave sizes {fr.wave_size_histogram()}; pipeline_overlap_ratio "
          f"{fr.pipeline_overlap_ratio()}; stall coverage min "
          f"{fr.stall_profiler.summary()['coverage_min']}, guilty {stalls['guilty']} "
          f"(share {stalls['guilty_share']}), stall s {stalls['stall_s']}")
    segs = fr.pod_ledger.segment_quantiles()
    print("(26 (a)) pod ledger, ms p50/p99 (n): " + "; ".join(
        f"{k} {v['p50'] * 1e3:.3f}/{v['p99'] * 1e3:.3f} ({v['n']})" for k, v in segs.items()))
    tel = fr.device_telemetry.snapshot()
    print(f"(26 (a)) transfers: upload {tel['transfers']['upload']}, fetch "
          f"{tel['transfers']['fetch']}")
    print(f"(26 (a)) compiles {tel['compiles']['by_kernel']}, seconds "
          f"{tel['compiles']['seconds_by_kernel']}, shapes {tel['compiles']['distinct_shapes']}")
    print(f"(26 (a)) memory: ledger watermark {tel['memory']['watermark_bytes']} B, live "
          f"{tel['memory']['live_bytes']} B by group {tel['memory']['resident_bytes']}; "
          f"torch.cuda.memory_allocated {tel['memory'].get('torch_memory_allocated')} B, "
          f"max_memory_allocated over the measured span {on['max_allocated']} B")
    spans = s.tracer.exporter.find("wave/")
    if not spans or not s.metrics.wave_duration.count():
        fail("phase 26 (a): no wave span or wave metric")
    print(f"(26 (a)) spans exported: {len(s.tracer.exporter.last())} roots, "
          f"{len(spans)} wave/<id> (the exporter keeps its last {s.tracer.exporter.capacity})")


class TimedProbe:
    """Counts and times every Framework._timed call by (plugin, extension
    point): the calls the 1-in-10 sample chose from, and each plugin's
    whole time (two clock reads a call more than the sample takes)."""

    def __init__(self, fw):
        self.calls, self.secs = {}, {}
        inner = fw._timed

        def timed(point, plugin, fn):
            key = (plugin, point)
            t0 = time.perf_counter()
            try:
                return inner(point, plugin, fn)
            finally:
                self.secs[key] = self.secs.get(key, 0.0) + time.perf_counter() - t0
                self.calls[key] = self.calls.get(key, 0) + 1

        fw._timed = timed


def ndf_telemetry_run(args, on, probe=False):
    """26 (b), one run: SchedulingNodeDeclaredFeatures/1000Nodes through the
    port's Scheduler: 500 plain and 500 featured nodes, 1000 pods of 500m
    requiring NUMAAlignment (the hybrid route: K4 and the host tail)."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod

    store = Store()
    n_plain = args.ndf_nodes // 2
    for i in range(args.ndf_nodes):
        featured = i >= n_plain
        store.create(make_node(f"node-{i}", zone=f"zone-{i % args.zones}",
                               labels={"node-class": "featured"} if featured else None,
                               declared_features=(FEATURE,) if featured else ()),
                     copy_return=False)
    s = telemetry_scheduler(store, "cuda", args.wave, args.seed, on,
                            gates={"NodeDeclaredFeatures": True})
    fw = s.frameworks["default-scheduler"]
    tp = TimedProbe(fw) if probe else None
    for i in range(args.ndf_pods):
        p = make_pod(f"pod-{i}", cpu="500m")
        p.meta.annotations[NDF_ANNOTATION] = FEATURE
        store.create(p, copy_return=False)
    algo = s.algorithms["default-scheduler"]
    run0, cycle0 = dict(algo.backend.run_phase_s), s.loop.phase_profile["cycle"]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    s.schedule_pending()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check_loop(f"phase 26 (b), telemetry {'on' if on else 'off'}", s)
    bound = {p.meta.key: p.spec.node_name for p in store.pods()}
    if not all(bound.values()) or any(int(v.split("-")[1]) < n_plain for v in bound.values()):
        fail("phase 26 (b): a pod unbound or on a plain node")
    if launches["fit_and_score"] < args.ndf_pods:
        fail(f"phase 26 (b): K4 launched {launches['fit_and_score']} times for "
             f"{args.ndf_pods} pods")
    run = sum(v - run0[k] for k, v in algo.backend.run_phase_s.items())
    return {"bindings": bound, "rng": algo.rng.getstate(), "pods_s": args.ndf_pods / wall,
            "launches": launches, "s": s, "probe": tp,
            "cycle_s": s.loop.phase_profile["cycle"] - cycle0, "run_s": run}


def ndf_telemetry(args, smi):
    """26 (b): NDF at full width with SchedulerMetrics on and every part
    off: identical bindings and rng; the host tail split by extension point
    and plugin from the sampled plugin histograms (each sum scaled by its
    sample share: the samples over the calls, counted in a third run with
    a probe on Framework._timed, which also times every call: the
    unsampled split beside the sampled one)."""
    on, _off, rates = on_off_runs(ndf_telemetry_run, args, "phase 26 (b)")
    counted = collected(ndf_telemetry_run, args, True, True)
    if counted["bindings"] != on["bindings"] or counted["rng"] != on["rng"]:
        fail("phase 26 (b): telemetry on and the counting run differ")
    print(f"(26 (b)) NodeDeclaredFeatures/1000Nodes through the port's Scheduler on {smi}: "
          f"{on_off_line(rates)}; bindings and rng equal; launches on {on['launches']}")
    hist = on["s"].metrics.plugin_execution_duration
    probe = counted["probe"]
    n = args.ndf_pods
    rows = []
    for key, calls in probe.calls.items():
        st = hist.values.get(key)
        count, total = (st.count, st.total) if st is not None else (0, 0.0)
        est = total * calls / count if count else 0.0
        rows.append((key[1], key[0], est, count, calls, probe.secs[key]))
    rows.sort(key=lambda r: -r[5])
    cycle_us = on["cycle_s"] * 1e6 / n
    run_us = on["run_s"] * 1e6 / n
    print(f"(26 (b)) per pod: cycle {cycle_us:.1f} us, of it K4's run {run_us:.1f} us, the "
          f"rest (host) {cycle_us - run_us:.1f} us; plugin time: sampled sums scaled by the "
          f"sample share {sum(r[2] for r in rows) * 1e6 / n:.1f} us, every call timed "
          f"(the counting run) {sum(r[5] for r in rows) * 1e6 / n:.1f} us")
    print("(26 (b)) host time by extension point and plugin, us per pod: sampled and "
          "scaled (samples / calls), every call timed:")
    for point, plugin, est, count, calls, secs in rows:
        print(f"(26 (b))   {point:>10} {plugin:<34} {est * 1e6 / n:9.2f} ({count} / {calls})"
              f" {secs * 1e6 / n:9.2f}")
    unsampled = sorted(f"{r[1]}/{r[0]}" for r in rows if not r[3])
    if unsampled:
        print(f"(26 (b)) called but never sampled: {unsampled}")


def gang_telemetry_run(args, device, groups):
    """26 (c), the gang: GangSchedulingTopologyRequired/500Nodes (gang.yaml:
    500 nodes, PodGroups of 4 default pods, Required zone topology) through
    the port's Scheduler with the gang gates on."""
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import (
        GangPolicy, PodGroup, PodGroupSpec, SchedulingConstraints, TopologyConstraint)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import make_node, make_pod, with_gang

    store = Store()
    for i in range(args.gang_nodes):
        store.create(make_node(f"node-{i}", zone=f"zone-{i % args.zones}"),
                     copy_return=False)
    s = telemetry_scheduler(store, device, args.wave, args.seed, True,
                            gates={"GenericWorkload": True,
                                   "TopologyAwareWorkloadScheduling": True})
    topo = SchedulingConstraints(topology=(TopologyConstraint(
        key="topology.kubernetes.io/zone", mode="Required"),))
    for g in range(groups):
        store.create(PodGroup(meta=ObjectMeta(name=f"group-{g}"),
                              spec=PodGroupSpec(policy=GangPolicy(min_count=4),
                                                constraints=topo)), copy_return=False)
        for m in range(4):
            store.create(with_gang(make_pod(f"group-{g}-{m}", cpu="100m", mem="50Mi"),
                                   f"group-{g}"), copy_return=False)
    kernels.reset_launches()
    s.schedule_pending()
    launches = dict(kernels.LAUNCHES)
    check_loop(f"phase 26 (c) gangs on {device}", s)
    bound = {p.meta.name: p.spec.node_name for p in store.pods()}
    if not all(bound.values()):
        fail(f"phase 26 (c) gangs on {device}: unbound pods")
    return {"bindings": bound, "rng": s.algorithms["default-scheduler"].rng.getstate(),
            "launches": launches, "s": s}


def breaker_telemetry_run(args, device, point, start_after, times):
    """26 (c), the breaker: the golden bursts through the port's Scheduler
    with the `point` fault armed (`times` transient faults after
    `start_after` clean passes)."""
    import kubernetes_tpu_torch.testing.wrappers as w
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.mixed import burst_pods
    from kubernetes_tpu_torch.utils import faultinject

    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
    try:
        store = Store()
        for i in range(args.loop_nodes):
            store.create(w.make_node(f"n{i}", cpu="32", mem="64Gi", zone=f"z{i % 4}"))
        reg = faultinject.registry()
        reg.reset(seed=0)
        reg.register(faultinject.FaultSpec(point, mode=faultinject.ERROR, transient=True,
                                           start_after=start_after, times=times))
        reg.arm()
        try:
            s = telemetry_scheduler(store, device, 16, 3, True)
            for p in burst_pods(w, 0, 160):
                store.create(p)
            s.schedule_pending()
        finally:
            reg.disarm()
            reg.reset(seed=0)
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
    bound = {p.meta.name: p.spec.node_name for p in store.pods()}
    if not all(bound.values()):
        fail(f"phase 26 (c) {point} on {device}: unbound pods")
    fr = s.flight_recorder
    if not any(new == "open" for _old, new, _why in fr.breaker_events):
        fail(f"phase 26 (c) {point} on {device}: the breaker never opened "
             f"({fr.breaker_events})")
    fallback = {k: v for k, v in fr.phase_snapshot().items() if k.startswith("fallback/")}
    if not fallback:
        fail(f"phase 26 (c) {point} on {device}: no fallback/<plugin> time")
    return {"bindings": bound, "rng": s.algorithms["default-scheduler"].rng.getstate(),
            "s": s, "fallback": fallback}


def gang_breaker_telemetry(args):
    """26 (c): the gang records on the recorder, and breaker-OPEN waves'
    fallback attribution."""
    t0 = time.perf_counter()
    g = collected(gang_telemetry_run, args, "cuda", args.gang_groups)
    fr = g["s"].flight_recorder
    gangs = [r for r in fr.records() if r.gang_groups]
    device = fr.gang_pod_totals.get("device", 0)
    if device != 4 * args.gang_groups or len(gangs) != args.gang_groups \
            or any(not r.gang_outcome.startswith("device:") for r in gangs) \
            or g["launches"]["gang_assign"] < args.gang_groups:
        fail(f"phase 26 (c): {len(gangs)} gang records, gang pods by path "
             f"{fr.gang_pod_totals}, launches {g['launches']}")
    comp = fr.device_telemetry.snapshot()["compiles"]
    print(f"(26 (c)) GangSchedulingTopologyRequired/{args.gang_nodes}Nodes, "
          f"{args.gang_groups} PodGroups of 4 through the port's Scheduler: {len(gangs)} gang "
          f"records, outcomes {sorted({r.gang_outcome.split(':')[0] for r in gangs})}, gang "
          f"pods by path {fr.gang_pod_totals}; launches {g['launches']}; compiles "
          f"{comp['by_kernel']}, seconds {comp['seconds_by_kernel']}; "
          f"{time.perf_counter() - t0:.1f} s")
    for point, start_after, times in (("tpu.launch", 0, 3), ("tpu.collect", 1, 3)):
        r = breaker_telemetry_run(args, "cuda", point, start_after, times)
        fr = r["s"].flight_recorder
        reasons = sorted({rec.fallback_reason for rec in fr.records() if rec.fallback_reason})
        if point == "tpu.collect" and not any(x.startswith("injected:") for x in reasons):
            fail(f"phase 26 (c) {point}: no wave record carries its fallback reason "
                 f"({reasons})")
        top = sorted(r["fallback"].items(), key=lambda kv: -kv[1])[:6]
        print(f"(26 (c)) {point} armed ({times} faults after {start_after} clean): breaker "
              f"{[(o, n) for o, n, _ in fr.breaker_events]}; {len(fr.records())} wave "
              f"records, fallback reasons {reasons}; fallback time by plugin, ms "
              + ", ".join(f"{k[9:]} {v * 1e3:.2f}" for k, v in top))
    print(f"phase 26 (c): {time.perf_counter() - t0:.1f} s")


def telemetry_card_vs_cpu(args):
    """26 (d): a short SchedulingBasic, NDF and gang workload on the card
    and with device="cpu": every non-timing field of every wave record,
    each pod's ledger edge sequence, the observations per (plugin,
    extension point) and the compiles per kernel equal."""
    import kubernetes_tpu_torch.testing.wrappers as w
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    t0 = time.perf_counter()

    def sb(device):
        os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
        try:
            store = Store()
            for i in range(TEL_CPU_NODES):
                store.create(scheduling_basic_node(i, args.zones), copy_return=False)
            s = telemetry_scheduler(store, device, 64, args.seed, True)
        finally:
            os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
        for i in range(TEL_CPU_PODS):
            store.create(scheduling_basic_pod(i), copy_return=False)
        s.schedule_pending()
        return s, store

    def ndf(device):
        store = Store()
        for i in range(TEL_CPU_NODES):
            featured = i % 2 == 1
            store.create(w.make_node(f"node-{i}", zone=f"zone-{i % args.zones}",
                                     declared_features=(FEATURE,) if featured else ()))
        s = telemetry_scheduler(store, device, 64, args.seed, True,
                                gates={"NodeDeclaredFeatures": True})
        for i in range(TEL_CPU_PODS // 4):
            p = w.make_pod(f"pod-{i}", cpu="500m")
            if i % 3:
                p.meta.annotations[NDF_ANNOTATION] = FEATURE
            store.create(p)
        s.schedule_pending()
        return s, store

    def gang(device):
        r = gang_telemetry_run(SimpleArgs(args, gang_nodes=TEL_CPU_NODES), device, 12)
        return r["s"], None

    for label, fn in (("SchedulingBasic", sb), ("NodeDeclaredFeatures", ndf),
                      ("GangSchedulingTopologyRequired", gang)):
        out = {}
        for device in ("cuda", "cpu"):
            s, _ = fn(device)
            check_loop(f"phase 26 (d) {label} on {device}", s)
            out[device] = (telemetry_view(s),
                           s.algorithms["default-scheduler"].rng.getstate())
        if out["cuda"] != out["cpu"]:
            which = [k for k in out["cuda"][0] if out["cuda"][0][k] != out["cpu"][0][k]]
            fail(f"phase 26 (d) {label}: card and CPU differ on {which or 'rng'}")
        view = out["cuda"][0]
        print(f"(26 (d)) {label}: card == CPU ({len(view['records'])} wave records, "
              f"{len(view['ledger'])} ledger entries, {sum(view['observations'].values())} "
              f"plugin samples over {len(view['observations'])} (plugin, point) keys, "
              f"compiles {view['compiles']})")
    print(f"phase 26 (d): {time.perf_counter() - t0:.1f} s")


# 26 (d)'s short cluster and pods
TEL_CPU_NODES = 48
TEL_CPU_PODS = 256


class SimpleArgs:
    """args with some values replaced."""

    def __init__(self, args, **kw):
        self.__dict__.update(vars(args))
        self.__dict__.update(kw)


def telemetry_phase(args, smi):
    """26. The telemetry on the card: (a) SchedulingBasic, (b) NDF, (c) a
    gang and breaker-OPEN waves, (d) card == CPU."""
    t0 = time.perf_counter()
    with watchdog("phase 26 (a) (SchedulingBasic with the telemetry on and off)",
                  args.phase_timeout):
        sb_telemetry(args, smi)
    with watchdog("phase 26 (b) (NodeDeclaredFeatures with the telemetry on and off)",
                  args.phase_timeout):
        ndf_telemetry(args, smi)
    with watchdog("phase 26 (c) (a gang and breaker-OPEN waves)", args.phase_timeout):
        gang_breaker_telemetry(args)
    with watchdog("phase 26 (d) (the telemetry, card against the CPU)", args.phase_timeout):
        telemetry_card_vs_cpu(args)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# 27: the restart path: warm start, crash recovery, the fleet
# --------------------------------------------------------------------------


def bind_ledger(store):
    """Wrap the store's bind path with the double-bind oracle: each pod
    key's bind count, and the perf_counter time of the first bind."""
    ledger = {"binds": {}, "first": None}
    lock = threading.Lock()
    orig_pods, orig_pod = store.bind_pods, store.bind_pod

    def note(keys):
        with lock:
            if keys and ledger["first"] is None:
                ledger["first"] = time.perf_counter()
            for k in keys:
                ledger["binds"][k] = ledger["binds"].get(k, 0) + 1

    def bind_pods(bindings):
        out = orig_pods(bindings)
        note([k for (k, _n), st in zip(bindings, out) if st == "bound"])
        return out

    def bind_pod(key, node_name):
        obj = orig_pod(key, node_name)
        note([key])
        return obj

    store.bind_pods, store.bind_pod = bind_pods, bind_pod
    return ledger


def check_restart(label, store, ledger, scheds=()):
    """Every pod bound exactly once, no node past its cpu, memory or pod
    count, every listed scheduler left with no assume and an empty queue."""
    from kubernetes_tpu_torch.api.resource import ResourceNames
    from kubernetes_tpu_torch.ops.planes import PlaneBuilder
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot

    pods = store.pods()
    unbound = [p.meta.key for p in pods if not p.spec.node_name]
    if unbound:
        fail(f"{label}: {len(unbound)} pods unbound (first {unbound[:3]})")
    twice = {k: n for k, n in ledger["binds"].items() if n != 1}
    if twice:
        fail(f"{label}: pods bound more than once: {list(twice.items())[:3]}")
    names = ResourceNames()
    cache = Cache(names)
    for n in store.nodes():
        cache.add_node(n)
    for p in pods:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    planes = PlaneBuilder(names).sync(snap)
    over = (planes.used[: planes.n] > planes.alloc[: planes.n]).any(axis=1)
    if over.any():
        fail(f"{label}: {int(over.sum())} nodes past their cpu, memory or pod count")
    for s in scheds:
        if s.cache.assumed_pod_count() or sum(s.queue.pending_pods()):
            fail(f"{label}: {s.cache.assumed_pod_count()} assumes and "
                 f"{s.queue.pending_pods()} queued pods left")
    return int(planes.used[: planes.n, 3].max())


def digest(obj) -> str:
    import hashlib

    return hashlib.sha256(repr(obj).encode()).hexdigest()[:16]


# phase 27's sizes: the backlog of (a)'s starts in waves of --wave, the
# measured wave (b)'s crash fires on, (c)'s lease in seconds and the waves
# its member 1 runs before it crashes
RESTART_WAVES = 10
CRASH_WAVE = 10
FLEET_LEASE = 5.0
FLEET_CRASH_WAVES = 3

# 27 (a)'s children in the order they run: cold, warm, warm, cold, then a
# warm start over an empty backlog (the pods arrive after start(): its warm
# pods cannot take a pending pod's shape, ROADMAP C16)
RESTART_CHILDREN = ({"warm": False}, {"warm": True}, {"warm": True}, {"warm": False},
                    {"warm": True, "late_backlog": True})


def restart_child_main(spec):
    """27 (a)'s child process: import, say "ready", and run its start only
    when the parent writes "go" (the parent starts every child at once, so
    their interpreter starts overlap, and runs them one at a time); a
    parent that ended without a word leaves it nothing to do."""
    import kubernetes_tpu_torch.scheduler.scheduler  # noqa: F401
    import kubernetes_tpu_torch.testing.wrappers  # noqa: F401

    spec["ready_s"] = time.time() - spec["t_spawn"]
    print("ready", flush=True)
    if sys.stdin.readline().strip() == "go":
        print(json.dumps(restart_child_run(spec)), flush=True)


def restart_child_run(spec):
    """27 (a), in a fresh process: SchedulingBasic's cluster with its
    initial pods already bound (a restart over a running cluster) and a
    backlog of `waves` waves of pods, created before start() or, with
    `late_backlog`, just after it; Scheduler(warm_start=spec["warm"])
    started and driven until the backlog is bound. Returns the times,
    compile counts, launches and hashes."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    device, nodes, init = spec["device"], spec["nodes"], spec["init"]
    late = spec.get("late_backlog", False)
    backlog = spec["waves"] * spec["wave"]
    t0 = time.perf_counter()
    store = Store()
    for i in range(nodes):
        store.create(scheduling_basic_node(i, spec["zones"]), copy_return=False)
    for i in range(init):
        pod = scheduling_basic_pod(i)
        pod.spec.node_name = f"node-{i % nodes}"
        store.create(pod, copy_return=False)

    def create_backlog():
        for i in range(backlog):
            store.create(scheduling_basic_pod(init + i), copy_return=False)

    if not late:
        create_backlog()
    ledger = bind_ledger(store)
    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
    try:
        s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=spec["wave"])],
                      seed=spec["seed"], clock=StrictClock(), device=device,
                      warm_start=spec["warm"])
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
    setup_s = time.perf_counter() - t0
    tele = s.flight_recorder.device_telemetry
    kernels.reset_launches()
    t1 = time.perf_counter()
    s.start()
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    start_launches = dict(kernels.LAUNCHES)
    start_compiles = tele.compile_count()
    start_seconds = dict(tele.snapshot()["compiles"]["seconds_by_kernel"])
    kernels.reset_launches()
    arrived = t1
    if late:
        create_backlog()
        arrived = time.perf_counter()
    n = s.schedule_pending()
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    label = f"phase 27 (a), warm {spec['warm']}{', late backlog' if late else ''}"
    check_loop(label, s)
    check_restart(label, store, ledger, [s])
    if n != backlog:
        fail(f"{label}: {n} pods scheduled of a backlog of {backlog}")
    bound = sorted((p.meta.key, p.spec.node_name) for p in store.pods())
    snap = tele.snapshot()["compiles"]
    summary = None
    if spec["warm"]:
        (summary,) = s.warmup_summaries
        summary = {k: v for k, v in summary.items() if k != "cache_dir"}
    return {"warm": spec["warm"], "late": late, "ready_s": spec["ready_s"],
            "setup_s": setup_s, "start_s": t2 - t1,
            "backlog_after_start_s": arrived - t2 if late else None,
            "first_bind_s": ledger["first"] - arrived,
            "drain_s": t3 - arrived, "waves": s.flight_recorder.phase_totals["waves"],
            "summary": summary, "start_launches": start_launches,
            "wave_launches": dict(kernels.LAUNCHES),
            "compiles_after_start": start_compiles, "compiles": tele.compile_count(),
            "since_warm": tele.compile_count_since_warm(),
            "start_compile_s": start_seconds,
            "compile_s": snap["seconds_by_kernel"],
            "bindings": digest(bound), "rng": digest(
                s.algorithms["default-scheduler"].rng.getstate())}


def restart_children(args, smi):
    """27 (a): two cold and two warm Schedulers and a warm one whose backlog
    comes after start(), each in a fresh process, so every first use
    (library load, module load, first launch, pinned staging) is paid in
    the run that counts it; the libraries phase 1 built are on disk. Every
    child starts at once and imports; they then run one at a time."""
    script = os.path.abspath(__file__)
    procs = []
    try:
        for kind in RESTART_CHILDREN:
            spec = dict(kind, device="cuda", nodes=args.nodes, zones=args.zones,
                        init=args.init_pods, waves=RESTART_WAVES, wave=args.wave,
                        seed=args.seed, t_spawn=time.time())
            procs.append((kind, subprocess.Popen(
                [sys.executable, script, "--restart-child", json.dumps(spec)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for kind, proc in procs:
            said = []
            for line in proc.stdout:
                if line.strip() == "ready":
                    break
                said.append(line)
            else:
                proc.wait()
                fail(f"phase 27 (a) child {kind} exited {proc.returncode} before it was "
                     f"ready:\n{''.join(said)[-4000:]}")
        runs = []
        for kind, proc in procs:
            out, _ = proc.communicate("go\n", timeout=args.phase_timeout)
            if proc.returncode != 0:
                fail(f"phase 27 (a) child {kind} exited {proc.returncode}:\n{out[-6000:]}")
            r = json.loads(out.strip().splitlines()[-1])
            runs.append(r)
            name = ("warm, backlog after start()" if r["late"]
                    else "warm" if r["warm"] else "cold")
            arrival = ("start()" if not r["late"] else
                       f"the backlog's last create ({r['backlog_after_start_s']:.4f} s of "
                       f"creates after start())")
            print(f"phase 27 (a) {name} ({smi}): process start and imports (all children "
                  f"at once) {r['ready_s']:.3f} s, store {r['setup_s']:.3f} s, start() "
                  f"{r['start_s']:.4f} s, {arrival} to first bind {r['first_bind_s']:.4f} s, "
                  f"the backlog {RESTART_WAVES * args.wave} pods in {r['drain_s']:.4f} s "
                  f"({r['waves']} waves); first uses at start {r['compiles_after_start']}, "
                  f"in all {r['compiles']}, since warm {r['since_warm']}; launches in start() "
                  f"{r['start_launches']}, in the waves {r['wave_launches']}; first-use s by "
                  f"kernel at start {r['start_compile_s']}, in all {r['compile_s']}; "
                  f"bindings {r['bindings']}, rng {r['rng']}")
            if r["warm"]:
                print(f"phase 27 (a) warmup summary: {r['summary']}")
    finally:
        for _kind, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r in runs:
        if r["bindings"] != runs[0]["bindings"] or r["rng"] != runs[0]["rng"]:
            fail("phase 27 (a): the warm and cold runs bind differently or leave another rng")
        if r["warm"]:
            if r["summary"]["skipped"]:
                fail(f"phase 27 (a): the warmup skipped {r['summary']['skipped']}")
            if r["since_warm"] != 0 and not r["late"]:
                fail(f"phase 27 (a): {r['since_warm']} first uses after the warm start")
            for k in ("static_parts", "assign_scan", "scatter_rows", "fit_and_score",
                      "gang_assign"):
                if r["start_launches"][k] <= 0:
                    fail(f"phase 27 (a): the warmup never launched {k}")
    cold = [r for r in runs if not r["warm"]]
    warm = [r for r in runs if r["warm"] and not r["late"]]
    mean = lambda rs, k: sum(r[k] for r in rs) / len(rs)  # noqa: E731
    print(f"phase 27 (a) ({smi}): start() cold {mean(cold, 'start_s'):.4f} s, warm "
          f"{mean(warm, 'start_s'):.4f} s; start() to first bind cold "
          f"{mean(cold, 'first_bind_s'):.4f} s, warm {mean(warm, 'first_bind_s'):.4f} s; "
          f"backlog drain cold {mean(cold, 'drain_s'):.4f} s, warm {mean(warm, 'drain_s'):.4f} s")
    return runs


def crash_restart_run(device, nodes, zones, init, pods, wave, seed, crash_wave):
    """27 (b), one run: SchedulingBasic through the port's Scheduler A at
    depth 2, CRASH armed at `loop.wave` on the measured pods' crash_wave-th
    wave; A's informers stopped (no drain, no flush), then a fresh
    Scheduler(warm_start=True) B over the same store binds the rest.
    Returns B's reconcile stats, the bindings and the numbers."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod
    from kubernetes_tpu_torch.utils import faultinject

    def scheduler(warm):
        os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
        try:
            return Scheduler(store, profiles=[Profile(backend="tpu", wave_size=wave)],
                             seed=seed, clock=StrictClock(), device=device, warm_start=warm)
        finally:
            os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)

    store = Store()
    for i in range(nodes):
        store.create(scheduling_basic_node(i, zones), copy_return=False)
    ledger = bind_ledger(store)
    a = scheduler(False)
    a.start()
    for i in range(init):
        store.create(scheduling_basic_pod(i), copy_return=False)
    a.schedule_pending()
    for i in range(pods):
        store.create(scheduling_basic_pod(init + i), copy_return=False)
    reg = faultinject.registry()
    reg.reset(seed=11)
    reg.register(faultinject.FaultSpec("loop.wave", mode=faultinject.CRASH, times=1,
                                       start_after=crash_wave - 1))
    reg.arm()
    try:
        a.schedule_pending()
        fail("phase 27 (b): the armed loop.wave crash never fired")
    except faultinject.SchedulerCrashed:
        pass
    finally:
        reg.disarm()
        reg.reset(seed=0)
    a.informers.stop_all()
    a_bound = sum(1 for p in store.pods() if p.spec.node_name)
    if device == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launches()
    ledger["first"] = None
    t0 = time.perf_counter()
    b = scheduler(True)
    stats = []
    reconcile = b.reconcile
    b.reconcile = lambda **kw: stats.append(reconcile(**kw)) or stats[-1]
    b.start()
    t1 = time.perf_counter()
    start_launches = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    n = b.schedule_pending()
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    label = f"phase 27 (b) on {device}"
    check_loop(label, b)
    max_pods = check_restart(label, store, ledger, [b])
    (summary,) = b.warmup_summaries
    return {"bindings": {p.meta.key: p.spec.node_name for p in store.pods()},
            "stats": stats, "restart_events": list(b.flight_recorder.restart_events),
            "rng": b.algorithms["default-scheduler"].rng.getstate(),
            "a_bound": a_bound, "b_bound": n, "start_s": t1 - t0,
            "first_bind_s": ledger["first"] - t0 if ledger["first"] else None,
            "drain_s": t2 - t1, "since_warm": b.flight_recorder.device_telemetry
            .compile_count_since_warm(), "skipped": summary["skipped"],
            "start_launches": start_launches, "launches": dict(kernels.LAUNCHES),
            "max_pods": max_pods}


def self_reconcile_run(device, point, nodes, seed):
    """27 (b), a crash that leaves state on the crashed Scheduler, which then
    reconciles itself (the reference's TestBindCommitGap): at
    loop.bind_commit on a SchedulingBasic stream (704 pods, waves of 64,
    the crash at the 4th wave's commit, after its store binds), or at
    gang.permit on 24 PodGroups of 4 with Required zone topology through
    the gang waves (K1 + K5; the crash at the 6th gang, its members assumed
    and none dispatched). Returns the reconcile stats, the bindings, the
    restart records and the rng."""
    from kubernetes_tpu_torch.api.meta import ObjectMeta
    from kubernetes_tpu_torch.api.types import (
        GangPolicy, PodGroup, PodGroupSpec, SchedulingConstraints, TopologyConstraint)
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import (
        make_node, make_pod, scheduling_basic_node, scheduling_basic_pod, with_gang)
    from kubernetes_tpu_torch.utils import faultinject

    store = Store()
    if point == "loop.bind_commit":
        gates, start_after = None, 3
        for i in range(nodes):
            store.create(scheduling_basic_node(i, 4), copy_return=False)
        for i in range(704):
            store.create(scheduling_basic_pod(i), copy_return=False)
    else:
        gates, start_after = {"GenericWorkload": True,
                              "TopologyAwareWorkloadScheduling": True}, 5
        for i in range(nodes):
            store.create(make_node(f"node-{i}", zone=f"zone-{i % 4}"), copy_return=False)
        topo = SchedulingConstraints(topology=(TopologyConstraint(
            key="topology.kubernetes.io/zone", mode="Required"),))
        for g in range(24):
            store.create(PodGroup(meta=ObjectMeta(name=f"group-{g}"),
                                  spec=PodGroupSpec(policy=GangPolicy(min_count=4),
                                                    constraints=topo)), copy_return=False)
            for m in range(4):
                store.create(with_gang(make_pod(f"group-{g}-{m}", cpu="100m", mem="50Mi"),
                                       f"group-{g}"), copy_return=False)
    ledger = bind_ledger(store)
    s = loop_scheduler(store, device, 64, seed, gates)
    label = f"phase 27 (b) {point} on {device}"
    reg = faultinject.registry()
    reg.reset(seed=11)
    reg.register(faultinject.FaultSpec(point, mode=faultinject.CRASH, times=1,
                                       start_after=start_after))
    reg.arm()
    kernels.reset_launches()
    try:
        s.schedule_pending()
        fail(f"{label}: the armed crash never fired")
    except faultinject.SchedulerCrashed:
        pass
    finally:
        reg.disarm()
        reg.reset(seed=0)
    landed = sum(1 for p in store.pods() if p.spec.node_name)
    assumed = s.cache.assumed_pod_count()
    stats = s.reconcile()
    s.schedule_pending()
    if device == "cuda":
        torch.cuda.synchronize()
    check_loop(label, s)
    check_restart(label, store, ledger, [s])
    return {"bindings": {p.meta.key: p.spec.node_name for p in store.pods()},
            "stats": stats, "restart_events": list(s.flight_recorder.restart_events),
            "rng": s.algorithms["default-scheduler"].rng.getstate(), "landed": landed,
            "assumed": assumed, "launches": dict(kernels.LAUNCHES)}


def crash_restart(args, smi):
    """27 (b): the crash and restart at full width, then at the small size,
    and the two crashes a Scheduler reconciles on itself, each on the card
    and on the CPU: equal bindings, stats, records and rng."""
    r = crash_restart_run("cuda", args.nodes, args.zones, args.init_pods, args.pods,
                          args.wave, args.seed, CRASH_WAVE)
    print(f"phase 27 (b) ({smi}): A bound {r['a_bound']} pods before the crash at its "
          f"measured wave {CRASH_WAVE}; B's reconcile {r['stats']}, restart records "
          f"{r['restart_events']}; B: start() {r['start_s']:.4f} s (warm, skipped "
          f"{r['skipped']}), construction to first bind {r['first_bind_s']:.4f} s, "
          f"{r['b_bound']} pods in {r['drain_s']:.4f} s = {r['b_bound'] / r['drain_s']:.1f} "
          f"pods/s, first uses after warm {r['since_warm']}; launches in B's start() "
          f"{r['start_launches']}, in its waves {r['launches']}; every pod bound once, "
          f"at most {r['max_pods']} pods a node")
    if r["since_warm"] != 0 or r["skipped"]:
        fail(f"phase 27 (b): after B's warm start {r['since_warm']} first uses, skipped "
             f"{r['skipped']}")
    if r["launches"]["static_parts"] <= 0 or r["launches"]["assign_scan"] <= 0:
        fail(f"phase 27 (b): K1 and K2 must launch in B's waves: {r['launches']}")
    small = {}
    for device in ("cuda", "cpu"):
        small[device] = crash_restart_run(device, args.loop_nodes, 4, 64, 640, 64, args.seed, 4)
    c, h = small["cuda"], small["cpu"]
    for k in ("bindings", "stats", "restart_events", "rng", "a_bound", "b_bound"):
        if c[k] != h[k]:
            fail(f"phase 27 (b): the small run's {k} differ between the card and the CPU")
    print(f"phase 27 (b) small ({args.loop_nodes} nodes, 704 pods, waves of 64): card == "
          f"CPU (bindings, reconcile stats {c['stats']}, restart records, rng); A bound "
          f"{c['a_bound']}, B {c['b_bound']}")
    # the sweeps at work: crashes that leave assumes and quorum entries on
    # the instance that reconciles
    for point, acted, needs in (
            ("loop.bind_commit", ("adopted",), ("static_parts", "assign_scan")),
            ("gang.permit", ("forgotten", "requeued", "permit_cleared"),
             ("static_parts", "gang_assign"))):
        runs = {d: self_reconcile_run(d, point, args.loop_nodes, args.seed)
                for d in ("cuda", "cpu")}
        c, h = runs["cuda"], runs["cpu"]
        for k in ("bindings", "stats", "restart_events", "rng", "landed", "assumed"):
            if c[k] != h[k]:
                fail(f"phase 27 (b) {point}: the {k} differ between the card and the CPU")
        idle = [k for k in acted if not c["stats"].get(k)]
        if idle:
            fail(f"phase 27 (b) {point}: reconcile left {idle} at zero: {c['stats']}")
        if not all(c["launches"][k] > 0 for k in needs):
            fail(f"phase 27 (b) {point}: {needs} must launch on the card: {c['launches']}")
        print(f"phase 27 (b) {point} on the crashed instance ({args.loop_nodes} nodes): "
              f"card == CPU (bindings, reconcile stats {c['stats']}, restart records "
              f"{c['restart_events']}, rng); {c['landed']} pods bound and {c['assumed']} "
              f"assumed at the crash; launches on the card {c['launches']}")
    return r


def fleet_failover(args, smi):
    """27 (c): two FleetMembers over one store and one card, each Scheduler
    with its own TorchBackend, driven from two threads (each its own loop:
    elect_once, pump, one wave); member 1 crashes after --fleet-crash-waves
    waves, member 0 adopts its shard when the lease expires. Every pod
    bound exactly once, no node past its capacity; member 0's device
    mirror equal to its host planes afterwards."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler.fleet import FleetMember
    from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler
    from kubernetes_tpu_torch.store import Store
    from kubernetes_tpu_torch.testing.wrappers import scheduling_basic_node, scheduling_basic_pod

    store = Store()
    for i in range(args.nodes):
        store.create(scheduling_basic_node(i, args.zones), copy_return=False)
    ledger = bind_ledger(store)
    members = []
    os.environ["KUBE_TPU_PIPELINE_DEPTH"] = "2"
    try:
        for i in range(2):
            s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=args.wave)],
                          seed=args.seed + i, clock=StrictClock(), device="cuda")
            m = FleetMember(s, 2, f"scheduler-{i}", preferred_shard=i,
                            lease_duration=FLEET_LEASE,
                            renew_deadline=FLEET_LEASE * 2 / 3, retry_period=0.05)
            m.start()
            members.append(m)
    finally:
        os.environ.pop("KUBE_TPU_PIPELINE_DEPTH", None)
    for m in members:
        m.elect_once()
    if [m.owned_shards() for m in members] != [{0}, {1}]:
        fail(f"phase 27 (c): ownership {[m.owned_shards() for m in members]}")
    total = args.init_pods + args.pods
    for i in range(total):
        pod = scheduling_basic_pod(i)
        pod.meta.uid = pod.meta.name
        store.create(pod, copy_return=False)
    # admit the pods and renew both leases just before the threads start:
    # a lease that lapsed while the pods were created would be taken over
    # by the peer, a failover this run does not test
    for m in members:
        m.scheduler.pump()
        m.elect_once()
    barrier = threading.Barrier(2)
    out = [{}, {}]
    errors = []

    def drive(i, m):
        s = m.scheduler
        try:
            base = kernels.thread_launches()
            barrier.wait(timeout=60)
            t0 = time.perf_counter()
            waves = 0
            while time.perf_counter() - t0 < args.phase_timeout:
                m.elect_once()
                s.pump()
                n = s.loop.schedule_wave(args.wave, timeout=0.0)
                waves += n > 0
                if i == 1 and waves >= FLEET_CRASH_WAVES:
                    m.crash()
                    break
                if n == 0:
                    if len(ledger["binds"]) >= total:
                        break
                    time.sleep(0.002)
            if i == 0:
                s.loop.wait_for_bindings()
                s.pump()
            out[i].update(waves=waves, wall=time.perf_counter() - t0, launches={
                k: v - base.get(k, 0) for k, v in kernels.thread_launches().items()})
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=drive, args=(i, m)) for i, m in enumerate(members)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        fail(f"phase 27 (c): {errors}")
    m0 = members[0]
    check_loop("phase 27 (c), member 0", m0.scheduler)
    max_pods = check_restart("phase 27 (c)", store, ledger, [m0.scheduler])
    if m0.owned_shards() != {0, 1}:
        fail(f"phase 27 (c): member 0 owns {m0.owned_shards()} after the failover")
    fr = m0.scheduler.flight_recorder
    failovers = [e for e in fr.fleet_events if e[0] == "failover"]
    adopt = [(k, n) for k, n in fr.restart_events if k.startswith("shard_adopt_")]
    if len(failovers) != 1 or failovers[0][1] != 1:
        # a member whose rounds outlast the lease loses its own shard to the
        # peer: a longer --fleet-lease keeps this run to the one failover
        fail(f"phase 27 (c): failover records {failovers} (member 0 must adopt shard 1 "
             f"once and keep shard 0; lease {FLEET_LEASE} s)")
    for i, o in enumerate(out):
        if o["launches"].get("static_parts", 0) <= 0 or o["launches"].get("assign_scan", 0) <= 0:
            fail(f"phase 27 (c): member {i} launched {o['launches']}")
    # member 0's device mirror against its host planes
    backend = m0.scheduler.algorithms["default-scheduler"].backend
    backend.invalidate_carry()
    m0.scheduler.cache.update_snapshot(m0.scheduler.snapshot)
    planes = backend.sync(m0.scheduler.snapshot)
    dev_planes, _ = backend.device_inputs(planes)
    host = planes.as_dict()
    for k, t in dev_planes.items():
        h = host[k].view("int32") if host[k].dtype.name == "uint32" else host[k]
        if not torch.equal(t.cpu(), torch.from_numpy(np.ascontiguousarray(h))):
            fail(f"phase 27 (c): member 0's device plane {k} differs from its host plane")
    wall = out[0]["wall"]
    print(f"phase 27 (c) ({smi}): {total} pods through two members in {wall:.3f} s = "
          f"{total / wall:.1f} pods/s; member 1 crashed after {out[1]['waves']} waves "
          f"({out[1]['wall']:.3f} s); lease {FLEET_LEASE} s, failover latency (lease "
          f"deadline to adoption) {failovers[0][2]:.4f} s; member 0 {out[0]['waves']} waves; "
          f"shard_adopt_ records {adopt}; launches by member (thread): member 0 "
          f"{out[0]['launches']}, member 1 {out[1]['launches']}; every pod bound once, at "
          f"most {max_pods} pods a node; member 0's mirror equal to its host planes")
    return out, failovers[0][2]


def restart_phase(args, smi):
    """27. The restart path on the card: (a) cold and warm start in fresh
    processes, (b) crash and restart, (c) fleet failover."""
    t0 = time.perf_counter()
    with watchdog("phase 27 (a) (cold and warm start)", args.phase_timeout * 2):
        restart_children(args, smi)
    with watchdog("phase 27 (b) (crash and restart)", args.phase_timeout):
        crash_restart(args, smi)
    with watchdog("phase 27 (c) (fleet failover)", args.phase_timeout):
        fleet_failover(args, smi)
    print(f"phase 27: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
