"""Shared bounded-retry helper: exponential backoff with full jitter.

A copy of the reference package's module (kubernetes_tpu/utils/backoff.py):
one policy object describing what is retryable and how long to wait, one
`retry_call` that runs a callable under it. The jitter follows the "full jitter"
scheme (delay drawn uniformly from [0, min(cap, base * 2^attempt)]) —
the AWS-architecture-blog result that decorrelated sleeps empty a
contended queue in near-minimal time, and the shape client-go's
wait.Backoff{Jitter: 1.0} approximates.

The rng is the CALLER's (seeded): retries are host-side control flow and
never touch the scheduler's tie-break stream, but a seeded jitter source
keeps chaos-soak timing reproducible run to run.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class RetryPolicy:
    """How many attempts, how long between them, and what qualifies."""

    max_attempts: int = 4
    base_s: float = 0.002
    cap_s: float = 0.1
    # exception classes that merit another attempt; anything else (and the
    # last attempt's failure) propagates to the caller unchanged
    retryable: tuple = field(default_factory=tuple)

    def is_retryable(self, err: Exception) -> bool:
        if isinstance(err, self.retryable):
            return True
        # duck-typed escape hatch: injected faults and facade errors mark
        # themselves rather than importing every consumer's exception types
        return bool(getattr(err, "transient", False))

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter delay before retry number `attempt` (1-based)."""
        ceiling = min(self.cap_s, self.base_s * (2 ** (attempt - 1)))
        return rng.uniform(0.0, ceiling)


def retry_call(
    fn: Callable[[], object],
    policy: RetryPolicy,
    rng: random.Random,
    *,
    sleep: Callable[[float], None] = time.sleep,
    should_abort: Callable[[], bool] | None = None,
    on_backoff: Callable[[int, float], None] | None = None,
):
    """Run `fn`, retrying retryable failures up to policy.max_attempts.

    `on_backoff(attempt, delay_s)` fires before each sleep (metrics hook);
    `should_abort` short-circuits remaining attempts (dispatcher shutdown)
    by re-raising the last error immediately.
    """
    attempt = 1
    while True:
        try:
            return fn()
        except Exception as err:  # noqa: BLE001 - classified right below
            if (
                attempt >= policy.max_attempts
                or not policy.is_retryable(err)
                or (should_abort is not None and should_abort())
            ):
                raise
            delay = policy.delay_s(attempt, rng)
            if on_backoff is not None:
                on_backoff(attempt, delay)
            sleep(delay)
            attempt += 1
