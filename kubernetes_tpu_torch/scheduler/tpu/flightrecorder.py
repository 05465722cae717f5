"""The loop's phase stopwatches and the breaker's transition record.

A trimmed copy of the reference package's flight recorder
(kubernetes_tpu/scheduler/tpu/flightrecorder.py): what the scheduling loop
and the circuit breaker read before the rest of the telemetry is ported.

- `phase(name)` times a loop-level phase into `phase_totals`, which the
  loop aliases as `phase_profile` (the same dict object): pop, snapshot,
  kernel (launch_batched and collect), finish (the per-pod host half of a
  wave), bind, pump, events and drain;
- `count_wave()` counts the launched waves (`phase_totals["waves"]`);
- `breaker_transition` keeps the circuit breaker's (old, new, reason)
  transitions in `breaker_events`;
- `partition_detected` keeps the informers' watch-partition repairs.

Left out until the telemetry slice (A6c): the per-wave records and their
ring buffer, the pod latency ledger, the stall profiler, the device
telemetry, the fallback attribution and the slow-wave watchdog. None of
them changes a decision (the reference's profiler on/off golden shows it);
the loop's call sites for them are marked A6c. Everything here runs on the
host between device calls.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager

# loop-level phases (the loop's phase_profile)
LOOP_PHASES = ("snapshot", "kernel", "finish", "bind", "pump", "events",
               "pop", "drain")


class FlightRecorder:
    """Phase stopwatches shared by the scheduler, its loop and its
    backends' breakers."""

    def __init__(self):
        self.phase_totals: dict = {k: 0.0 for k in LOOP_PHASES}
        self.phase_totals["waves"] = 0
        self._lock = threading.Lock()
        # circuit-breaker transition history (old, new, reason), bounded
        self.breaker_events: "collections.deque[tuple]" = collections.deque(
            maxlen=64)
        # watch-partition repairs (kind, repaired, latency_s), bounded
        self.partition_events: "collections.deque[tuple]" = collections.deque(
            maxlen=64)

    @contextmanager
    def phase(self, name: str):
        """Time a loop-level phase into phase_totals."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.phase_totals[name] = self.phase_totals.get(name, 0.0) + dt

    def count_wave(self) -> None:
        """One wave launched (the phase_profile["waves"] counter)."""
        with self._lock:
            self.phase_totals["waves"] += 1

    def breaker_transition(self, old: str, new: str, reason: str) -> None:
        with self._lock:
            self.breaker_events.append((old, new, reason))

    def partition_detected(self, kind: str, repaired: int,
                           latency_s: float) -> None:
        """The informers' partition observer: a watch-stream gap was
        detected and repaired."""
        with self._lock:
            self.partition_events.append((kind, repaired, latency_s))
