"""Injectable clocks — deterministic time in tests.

A copy of the reference package's clocks (kubernetes_tpu/utils/clock.py;
k8s.io/utils/clock): the framework's permit wait reads `now` and blocks
through `wait_for`.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait_for(self, waiter, timeout: float):
        """Block up to `timeout` on a blocking waiter (e.g. a condition
        wait); returns the waiter's result. Virtual clocks override this:
        they advance virtually instead of blocking on wall time."""
        return waiter(timeout)


class FakeClock(Clock):
    def __init__(self, start: float = 1000.0):
        self._now = start
        self._mu = threading.Lock()

    def now(self) -> float:
        with self._mu:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._mu:
            self._now += seconds

    def wait_for(self, waiter, timeout: float):
        # non-blocking probe, then advance virtual time so deadline loops
        # (WaitOnPermit) progress deterministically
        result = waiter(0)
        if result is None:
            self.step(min(timeout, 0.001))
        return result
