"""The streaming-wave loop: pipelined launch/collect over a Cache and a
Snapshot, the stand-in for the scheduling loop's wave pipeline until that
loop is ported (the reference's ScheduleOneLoop._pipeline_wave,
_complete_wave, _flush_wave_pipeline and _poison_successor,
kubernetes_tpu/scheduler/schedule_one.py:593-872), with no queue and no
framework.

Per wave: update the snapshot, launch wave k+1 on the device carry, then
collect wave k and assume its winners into the cache while k+1 runs. A
pod the wave could not place is re-run through the algorithm's
schedule_pod inside the wave's re-run window (it reads that wave's output
planes). NeedResync drains the pipeline, drops the carry, updates the
snapshot and retries once; FallbackNeeded (a poisoned wave, a tie-draw
overflow, a pod the extractor refuses) poisons the successor and hands
the wave's pods back to the caller. A change of pad drains first.
depth=1 is the serial loop through the same code: each wave is collected
right after its launch.

The loop touches the backend, the cache and the algorithm by method
name only (launch_batched, collect, invalidate_carry, mark_external;
update_snapshot, assume_pod; schedule_pod and rng), so the reference
package's TPUBackend runs through it as well: pass its exception types.

    pipe = WavePipeline(backend, cache, snapshot, algo, depth=2)
    pipe.schedule(pods, wave=512)
    pipe.bindings[pod.meta.key]   # node name, or None: fits nowhere
"""

from __future__ import annotations

import time

from ..ops.planes import FallbackNeeded
from ..ops.vocab import next_pow2
from ..scheduler.framework import CycleState, FitError
from ..scheduler.tpu.backend import NeedResync


class WavePipeline:
    """Pipelined waves over one backend, cache, snapshot and algorithm."""

    def __init__(self, backend, cache, snapshot, algo, depth: int = 2,
                 need_resync=NeedResync, fallback=FallbackNeeded,
                 fit_error=FitError, new_state=CycleState):
        self.backend = backend
        self.cache = cache
        self.snapshot = snapshot
        self.algo = algo
        self.depth = max(1, depth)
        self.need_resync = need_resync
        self.fallback = fallback
        self.fit_error = fit_error
        self.new_state = new_state
        # a host-side veto of a wave's winner (a Reserve or Permit failure in
        # the scheduling loop): reject(pod, host) -> True reverts the pod,
        # poisons the successor, and re-runs the wave's later pods per pod
        self.reject = None
        self._inflight = None
        # pod key -> node name, or None (fits nowhere, or rejected)
        self.bindings: dict[str, str | None] = {}
        self.handed_back: list = []   # pods of waves that fell back
        self.rejected: list = []
        self.stats = {"waves": 0, "resyncs": 0, "fallback_waves": 0,
                      "reruns": 0, "poisoned": 0}
        # host seconds by loop phase: snapshot updates, launch_batched,
        # collect, assumes, per-pod re-runs
        self.phase_s = {"snapshot": 0.0, "launch": 0.0, "collect": 0.0,
                        "assume": 0.0, "rerun": 0.0}

    # -- the loop --------------------------------------------------------------

    def schedule(self, pods: list, wave: int) -> None:
        """Every pod in waves of at most `wave`, each padded to the next
        power of two (floor 8, at most `wave`), then drain the pipeline."""
        for i in range(0, len(pods), wave):
            chunk = pods[i: i + wave]
            self.submit(chunk, min(next_pow2(len(chunk), floor=8), wave))
        self.flush()

    def submit(self, pods: list, pad_to: int) -> None:
        """Launch one wave and complete the wave before it."""
        infl = self._inflight
        if infl is not None and (infl.pad != pad_to or infl.poisoned):
            self.flush()  # the tie-word frame assumes equal pads
        self._update_snapshot()
        fl = None
        for _attempt in (0, 1):
            t = time.perf_counter()
            try:
                fl = self.backend.launch_batched(pods, self.snapshot, rng=self.algo.rng,
                                                 pad_to=pad_to)
                break
            except self.need_resync:
                # drain, re-upload from host truth, retry once
                self.stats["resyncs"] += 1
                self.flush()
                self.backend.invalidate_carry()
                self._update_snapshot()
            except self.fallback:
                break
            finally:
                self.phase_s["launch"] += time.perf_counter() - t
        if fl is None:
            # strict queue order: whatever is in flight precedes these pods
            self.flush()
            self.stats["fallback_waves"] += 1
            self.handed_back.extend(pods)
            return
        self.stats["waves"] += 1
        prev, self._inflight = self._inflight, fl
        if prev is not None:
            self._complete(prev)
        if self.depth <= 1:
            self.flush()

    def flush(self) -> None:
        """Complete the wave in flight, if any."""
        infl, self._inflight = self._inflight, None
        if infl is not None:
            self._complete(infl)

    def _complete(self, fl) -> None:
        """Collect a launched wave and run its host half: assume each
        winner; re-run a pod the wave could not place (and, after a
        reject, every later pod) through schedule_pod."""
        t = time.perf_counter()
        try:
            hosts, _planes = self.backend.collect(fl, rng=self.algo.rng)
        except self.fallback:
            # poisoned or overflowed: results discarded; a successor
            # launched on that carry is poisoned too
            self._poison_successor()
            self.stats["fallback_waves"] += 1
            self.handed_back.extend(fl.pods)
            return
        finally:
            self.phase_s["collect"] += time.perf_counter() - t
        invalidated = False
        for pod, host in zip(fl.pods, hosts):
            if invalidated or host is None:
                # a host=None re-run reproduces the FitError in this wave's
                # re-run window (no draws, no state change)
                self.schedule_one(pod)
                continue
            if self.reject is not None and self.reject(pod, host):
                # the kernel placed this pod but the host reverted it: the
                # carry, and any successor computed from it, is wrong
                self.bindings[pod.meta.key] = None
                self.rejected.append(pod)
                self._poison_successor()
                invalidated = True
                continue
            t = time.perf_counter()
            self.cache.assume_pod(pod, host)
            self.bindings[pod.meta.key] = host
            self.phase_s["assume"] += time.perf_counter() - t

    def schedule_one(self, pod) -> None:
        """One pod's cycle through the algorithm's schedule_pod (the
        single-pod kernel path); a placement outside the wave writeback
        marks the carry stale and poisons the wave in flight."""
        t = time.perf_counter()
        self.stats["reruns"] += 1
        self._update_snapshot()
        try:
            result = self.algo.schedule_pod(self.new_state(), pod, self.snapshot)
        except self.fit_error:
            self.bindings[pod.meta.key] = None
        else:
            self.cache.assume_pod(pod, result.suggested_host)
            self.bindings[pod.meta.key] = result.suggested_host
            self.external(poison=True)
        self.phase_s["rerun"] += time.perf_counter() - t

    def external(self, poison: bool = True) -> None:
        """Cluster state changed outside the pipeline's writeback: the next
        launch drains and re-uploads. poison=True (a host-side placement or
        removal made now, before the wave in flight in queue order) also
        discards the wave in flight; poison=False (an informer event after
        the wave's pods were taken) keeps it."""
        self.backend.mark_external()
        if poison and self._inflight is not None:
            self._inflight.mark_poisoned()
            self.stats["poisoned"] += 1

    def _poison_successor(self) -> None:
        self.backend.invalidate_carry()
        if self._inflight is not None:
            self._inflight.mark_poisoned()
            self.stats["poisoned"] += 1

    def _update_snapshot(self) -> None:
        t = time.perf_counter()
        self.cache.update_snapshot(self.snapshot)
        self.phase_s["snapshot"] += time.perf_counter() - t
