"""Deterministic fault injection: one seeded registry, named points.

The chaos contract (README "Fault injection & degradation ladder"): every
place the scheduler talks to something that can fail in production — the
store write path, the async dispatcher's call execution, the TPU wave
launch/collect pair, watch delivery — declares a NAMED injection point
and calls `fire(point)` on it. A disarmed registry (the default, and the
only mode outside chaos tests) answers with one attribute read and a
bool check; an armed registry consults its schedule of `FaultSpec`s and
either raises a transient/permanent error, sleeps (latency), or tells
the caller to drop the delivery.

Everything is reproducible from one seed: each spec draws from its own
`random.Random` seeded by (registry seed, point, spec index), so whether
spec A fires on its point's Nth visit never depends on how often any
OTHER point was visited. Re-running the same workload with the same seed
replays the same fault schedule.

A copy of the reference package's module
(kubernetes_tpu/utils/faultinject.py), with the points the port fires:
the store's writes and watch delivery, the dispatcher's calls, the wave
launch/collect pair, the leader elector's lease round and the
scheduling loop's crash points. The registry
is disarmed by default, and nothing but a test arms it.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable


class FaultInjected(Exception):
    """Base class for injected errors (never raised by real code paths)."""

    transient = False


class TransientFault(FaultInjected):
    """An injected failure that a bounded retry is expected to absorb."""

    transient = True


class PermanentFault(FaultInjected):
    """An injected failure that must surface through the failure handler."""


class SchedulerCrashed(FaultInjected):
    """Injected scheduler death: rips straight through the scheduling loop.

    Deliberately NOT transient — the dispatcher's bounded retry and the
    device path's DeviceFlakeError wrapping must never absorb it. The
    chaos restart soak catches it above `schedule_pending`, tears the
    scheduler down ungracefully (no drain, no flush) and constructs a
    fresh one over the same store."""

    transient = False


# fault modes
ERROR = "error"
LATENCY = "latency"
DROP = "drop"
# the process dies mid-flight: fire() raises SchedulerCrashed, which no
# retry layer may absorb — only the restart soak catches it
CRASH = "crash"
# a long-lived gap: once triggered, the spec drops `window` CONSECUTIVE
# visits unconditionally — on a watch point that is a contiguous
# revision-range loss the informer must detect by itself (bookmark
# staleness), not a per-delivery coin flip like DROP
PARTITION = "partition"

# every injection point threaded through the port; a call site must be
# declared here or `fire` raises KeyError under an armed registry
FAULT_POINTS = (
    "store.create",
    "store.update",
    "store.delete",
    "store.bind_pod",
    "store.patch_pod_status",
    "dispatcher.execute",
    "tpu.launch",
    "tpu.collect",
    "watch.deliver",
    "watch.partition",
    # one leader-election CAS round (acquire or renew): ERROR/LATENCY model
    # a flaky or slow coordination write, PARTITION a window where every
    # renewal is lost — seeded lease loss and renew storms for the fleet
    "lease.renew",
    # crash points on the main scheduling thread: unlike tpu.* (whose
    # FaultInjected raises are caught locally and wrapped as device
    # flakes) these propagate up through schedule_pending
    "loop.wave",
    "loop.bind_commit",
    "gang.permit",
)


@dataclass
class FaultSpec:
    """One scheduled fault at one point.

    `start_after` skips the first N visits to the point; `times` bounds how
    often the spec fires (None = unlimited); `probability` gates each
    remaining visit through the spec's own seeded rng. `exc` overrides the
    raised exception (e.g. a real store ConflictError) for ERROR mode.

    PARTITION mode: `times` bounds how often the partition OPENS; each
    opening then drops `window` consecutive visits unconditionally (the
    opening visit included), producing one contiguous gap per opening."""

    point: str
    mode: str = ERROR
    transient: bool = True
    probability: float = 1.0
    times: int | None = None
    start_after: int = 0
    latency_s: float = 0.0
    window: int = 1
    message: str = "injected fault"
    exc: Callable[[str], Exception] | None = None
    # runtime state (owned by the registry)
    fired: int = 0
    _open_left: int = 0
    _rng: random.Random | None = field(default=None, repr=False)

    def make_error(self) -> Exception:
        msg = f"{self.point}: {self.message}"
        if self.exc is not None:
            return self.exc(msg)
        return TransientFault(msg) if self.transient else PermanentFault(msg)


class FaultRegistry:
    """Seeded, schedule-driven fault registry behind the `fire` points."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.armed = False
        self._mu = threading.Lock()
        self._specs: dict[str, list[FaultSpec]] = {p: [] for p in FAULT_POINTS}
        self._visits: dict[str, int] = {p: 0 for p in FAULT_POINTS}
        self.fired_total = 0
        self.fired_by_point: dict[str, int] = {p: 0 for p in FAULT_POINTS}

    # -- configuration -----------------------------------------------------

    def register(self, spec: FaultSpec) -> FaultSpec:
        with self._mu:
            if spec.point not in self._specs:
                raise KeyError(
                    f"unknown injection point {spec.point!r} "
                    f"(known: {', '.join(FAULT_POINTS)})"
                )
            idx = len(self._specs[spec.point])
            # per-spec stream: independent of visit order at other points;
            # a str seed hashes via sha512 (stable across processes, unlike
            # tuple hashing under PYTHONHASHSEED randomization)
            spec._rng = random.Random(f"{self.seed}:{spec.point}:{idx}")
            spec.fired = 0
            spec._open_left = 0
            self._specs[spec.point].append(spec)
            return spec

    def arm(self) -> None:
        with self._mu:
            self.armed = True

    def disarm(self) -> None:
        with self._mu:
            self.armed = False

    def reset(self, seed: int | None = None) -> None:
        """Drop every spec and counter; optionally reseed."""
        with self._mu:
            if seed is not None:
                self.seed = seed
            self.armed = False
            self._specs = {p: [] for p in FAULT_POINTS}
            self._visits = {p: 0 for p in FAULT_POINTS}
            self.fired_total = 0
            self.fired_by_point = {p: 0 for p in FAULT_POINTS}

    # -- the hot call ------------------------------------------------------

    def fire(self, point: str) -> bool:
        """Visit an injection point. Disarmed: False immediately. Armed:
        the first matching spec acts — ERROR raises, LATENCY sleeps then
        returns False, DROP returns True (caller skips the delivery)."""
        if not self.armed:
            return False
        sleep_s = 0.0
        err: Exception | None = None
        dropped = False
        with self._mu:
            visit = self._visits[point]  # KeyError = undeclared point
            self._visits[point] = visit + 1
            for spec in self._specs[point]:
                # an open partition window swallows every visit
                # unconditionally until it closes — that is what makes
                # the gap contiguous (a revision RANGE, not scattered
                # drops a probability gate would produce)
                if spec.mode == PARTITION and spec._open_left > 0:
                    spec._open_left -= 1
                    self.fired_total += 1
                    self.fired_by_point[point] += 1
                    dropped = True
                    break
                if visit < spec.start_after:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.probability < 1.0 and (
                    spec._rng.random() >= spec.probability
                ):
                    continue
                spec.fired += 1
                self.fired_total += 1
                self.fired_by_point[point] += 1
                if spec.mode == ERROR:
                    err = spec.make_error()
                elif spec.mode == CRASH:
                    err = SchedulerCrashed(
                        f"{point}: {spec.message} (seed {self.seed})"
                    )
                elif spec.mode == LATENCY:
                    sleep_s = spec.latency_s
                elif spec.mode == DROP:
                    dropped = True
                elif spec.mode == PARTITION:
                    # this visit opens the gap and is itself dropped;
                    # the remaining window - 1 visits drop above
                    spec._open_left = max(spec.window - 1, 0)
                    dropped = True
                break
        # act OUTSIDE the registry lock: a latency injection must not
        # serialize every other point behind this one's sleep
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if err is not None:
            raise err
        return dropped

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "seed": self.seed,
                "armed": self.armed,
                "fired_total": self.fired_total,
                "fired_by_point": {
                    p: n for p, n in self.fired_by_point.items() if n
                },
                "visits": {p: n for p, n in self._visits.items() if n},
                "specs": {
                    p: len(specs) for p, specs in self._specs.items() if specs
                },
            }


# one process-wide registry: call sites fire on it via the module functions
# below, tests/chaos own its lifecycle through reset()/arm()/disarm()
_REGISTRY = FaultRegistry()


def registry() -> FaultRegistry:
    return _REGISTRY


def fire(point: str) -> bool:
    """Module-level fast path — the form every call site uses."""
    r = _REGISTRY
    if not r.armed:
        return False
    return r.fire(point)



def fired_total() -> int:
    """Faults fired since the last reset (the wave records' window base)."""
    return _REGISTRY.fired_total
