"""Sampling CPU profiler: the /debug/pprof role.

Reference: every component serves net/http/pprof when profiling is enabled
(routes.Profiling{}.Install, cmd/kube-scheduler/app/server.go:390), and the
perf workflow is "hit /debug/pprof/profile?seconds=N, look at the hot
stacks". Go's CPU profile is a sampling profiler; this is the same idea on
sys._current_frames(): sample every thread's stack at `hz` for `seconds`,
aggregate self/cumulative hits per function, render the familiar
flat-profile table. Pure stdlib, safe to run in production (sampling cost
only while a profile is being taken). A copy of the reference package's
module (kubernetes_tpu/utils/pprof.py); the wave recorder's slow-wave
watchdog is its caller.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter


def take_profile(seconds: float = 1.0, hz: int = 100,
                 top: int = 30) -> str:
    """Sample all threads for `seconds`; returns a flat-profile text table
    (samples ~ CPU+wait time per frame, like a wall-clock pprof)."""
    interval = 1.0 / hz
    self_hits: Counter[str] = Counter()
    cum_hits: Counter[str] = Counter()
    ticks = 0  # percentages normalize per TICK: "this frame was on-CPU in
    # X% of sampling instants" — not per thread-sample, which would dilute
    # a hot thread by however many idle threads exist
    me = threading.get_ident()
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        ticks += 1
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            first = True
            seen: set[str] = set()
            while frame is not None:
                code = frame.f_code
                # co_qualname is 3.11+; co_name loses the class prefix only
                qn = getattr(code, "co_qualname", code.co_name)
                loc = f"{qn} ({code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno})"
                if first:
                    self_hits[loc] += 1
                    first = False
                if loc not in seen:  # recursion: one cum hit per sample
                    seen.add(loc)
                    cum_hits[loc] += 1
                frame = frame.f_back
        time.sleep(interval)
    lines = [
        f"sampling profile: {ticks} ticks over {seconds}s at {hz}Hz",
        f"{'self':>6} {'self%':>7} {'cum':>6} {'cum%':>7}  location",
    ]
    total = max(ticks, 1)
    # every sampled frame gets a cum hit, so cum_hits is the full row set;
    # callers with 0 self time (all samples in callees) still rank by cum —
    # dropping them would hide the hot call path's entry points
    entries = sorted(
        ((self_hits.get(loc, 0), cum_hits[loc], loc) for loc in cum_hits),
        key=lambda e: (-e[0], -e[1], e[2]),
    )[:top]
    for n, c, loc in entries:
        lines.append(
            f"{n:>6} {100 * n / total:>6.1f}% {c:>6} {100 * c / total:>6.1f}%  {loc}"
        )
    return "\n".join(lines) + "\n"
