"""Circuit breaker for the device path: trip to host fallback, probe back.

The degradation ladder already has two rungs — the batched device wave, and
the per-pod host path (`TorchSchedulingAlgorithm.schedule_pod`'s
`super().schedule_pod` tier, where every `FallbackNeeded` lands). What it
lacked was memory: a flaking device made EVERY wave pay the launch/collect
round trip before falling back. The breaker adds the standard three states:

- CLOSED: waves go to the device; consecutive *device* failures count up
  (benign fallbacks — non-kernelizable pods, overflow — do not count).
- OPEN: after `threshold` consecutive failures, waves bypass the device
  entirely and route per-pod through the host tier until `cooldown_s`
  elapses (clock-injectable for tests).
- HALF_OPEN: after cooldown, up to `probes` waves are let through as
  probes; `probes` consecutive successes close the breaker, any failure
  re-opens it and restarts the cooldown.

Env knobs: KUBE_TPU_BREAKER_THRESHOLD (default 3),
KUBE_TPU_BREAKER_COOLDOWN_S (default 1.0), KUBE_TPU_BREAKER_PROBES
(default 2). Transitions fan out through `on_transition` (the flight
recorder); the breaker itself never imports it — it is a pure state
machine, safe to construct anywhere.

A device failure here is an injected one only (the `tpu.launch` and
`tpu.collect` fault points, raised as DeviceFlakeError): on the card a
CUDA error, a failed build or a failed launch raises out of the loop and
is never recorded. A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/circuitbreaker.py).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ...utils.envknob import float_env, int_env

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"



class CircuitBreaker:
    """Three-state breaker over an opaque 'device wave' operation."""

    def __init__(
        self,
        threshold: int | None = None,
        cooldown_s: float | None = None,
        probes: int | None = None,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str, str, str], None] | None = None,
    ):
        self.threshold = (threshold if threshold is not None
                          else int_env("KUBE_TPU_BREAKER_THRESHOLD", 3))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else float_env("KUBE_TPU_BREAKER_COOLDOWN_S", 1.0))
        self.probes = (probes if probes is not None
                       else int_env("KUBE_TPU_BREAKER_PROBES", 2))
        self._clock = clock
        self._on_transition = on_transition
        self._mu = threading.Lock()
        self.state = CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_successes = 0
        self._probes_inflight = 0
        self.trip_count = 0
        self.recovery_count = 0
        self.transitions: list[tuple[str, str, str]] = []  # bounded below

    # -- decisions ---------------------------------------------------------

    def allow_device_wave(self) -> bool:
        """May the next wave go to the device? OPEN flips to HALF_OPEN once
        the cooldown elapses; HALF_OPEN admits at most `probes` concurrent
        probe waves."""
        fire: tuple[str, str, str] | None = None
        with self._mu:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                fire = self._transition_locked(HALF_OPEN, "cooldown elapsed")
                self._probe_successes = 0
                self._probes_inflight = 0
            # HALF_OPEN: meter the probes
            if self._probes_inflight >= self.probes:
                allowed = False
            else:
                self._probes_inflight += 1
                allowed = True
        if fire is not None:
            self._fan_out(fire)
        return allowed

    def device_blocked(self) -> bool:
        """Pure read for the per-pod path: True only while OPEN and still
        cooling — never mutates state, so it is safe in schedule_pod."""
        with self._mu:
            return (
                self.state == OPEN
                and self._clock() - self._opened_at < self.cooldown_s
            )

    def probing(self) -> bool:
        """Pure read: True while HALF_OPEN — the wave popper uses this to
        cap probe waves at a small size (a recovering device gets a taster,
        not a full wave). Never mutates state."""
        with self._mu:
            return self.state == HALF_OPEN

    # -- outcomes ----------------------------------------------------------

    def record_success(self) -> None:
        fire: tuple[str, str, str] | None = None
        with self._mu:
            self.consecutive_failures = 0
            if self.state == HALF_OPEN:
                self._probe_successes += 1
                self._probes_inflight = max(0, self._probes_inflight - 1)
                if self._probe_successes >= self.probes:
                    fire = self._transition_locked(
                        CLOSED, f"{self.probes} probe waves succeeded")
                    self.recovery_count += 1
        if fire is not None:
            self._fan_out(fire)

    def record_failure(self, reason: str = "device wave failed") -> None:
        fire: tuple[str, str, str] | None = None
        with self._mu:
            self.consecutive_failures += 1
            if self.state == HALF_OPEN:
                # one failed probe re-opens immediately and restarts cooldown
                fire = self._transition_locked(OPEN, f"probe failed: {reason}")
                self._opened_at = self._clock()
                self.trip_count += 1
            elif (self.state == CLOSED
                  and self.consecutive_failures >= self.threshold):
                fire = self._transition_locked(
                    OPEN,
                    f"{self.consecutive_failures} consecutive failures "
                    f"({reason})",
                )
                self._opened_at = self._clock()
                self.trip_count += 1
        if fire is not None:
            self._fan_out(fire)

    def record_benign(self) -> None:
        """A device wave ended without a device verdict (non-kernelizable
        fallback, overflow, poisoned carry): releases a HALF_OPEN probe
        slot without counting toward success or failure — a probe that
        never reached the device proves nothing either way."""
        with self._mu:
            if self.state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)

    # -- plumbing ----------------------------------------------------------

    def _transition_locked(
        self, new_state: str, reason: str
    ) -> tuple[str, str, str]:
        old = self.state
        self.state = new_state
        entry = (old, new_state, reason)
        self.transitions.append(entry)
        if len(self.transitions) > 256:
            del self.transitions[:128]
        return entry

    def _fan_out(self, entry: tuple[str, str, str]) -> None:
        # outside _mu: the sink writes flight-recorder state under its own
        # lock
        if self._on_transition is not None:
            self._on_transition(*entry)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "trip_count": self.trip_count,
                "recovery_count": self.recovery_count,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "probes": self.probes,
            }
