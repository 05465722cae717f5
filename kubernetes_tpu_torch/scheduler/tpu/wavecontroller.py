"""Adaptive wave sizing for the streaming wave pipeline.

The controller sizes the NEXT wave from the scheduling queue's observed
depth instead of one constant: small waves under light arrival (latency),
large waves under backlog (throughput), always within the caller's
`max_pods` cap. Queue depth is a pure function of store and informer
state, so the decisions do not depend on timing.

Sizes are pow2-bucketed (floor `min_pods`, 8) so the controller never
asks for wave shapes beyond the buckets the wave padding in
`schedule_wave` already uses. The circuit breaker's HALF_OPEN probe sizing
(`schedule_one.PROBE_WAVE_PODS`) stays authoritative: the pop loop's
probe break caps a recovering device's wave whatever the controller asked
for.

The wall-clock latency guard (AIMD: halve the size ceiling when a wave
blows its budget, recover one pow2 step per good wave) is opt-in through
`latency_budget_s`, off by default, because wall time is not
deterministic; the loop feeds it every completed wave's recorded
duration (`observe`). `last_clipped` tells the stall profiler when the
caller's cap clipped the target (its capacity_gate reason).

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/wavecontroller.py) less its environment
knobs: the floor, ceiling and budget are constructor arguments.
"""

from __future__ import annotations


def _next_pow2(n: int, floor: int = 1) -> int:
    p = max(1, floor)
    while p < n:
        p <<= 1
    return p


class WaveSizeController:
    """Sizes the next batched wave from queue depth (+ optional latency).

    One instance is owned by the ScheduleOneLoop and consulted at the top
    of every `schedule_wave` call; `observe()` feeds it completed waves'
    durations (a no-op unless the latency guard is armed).
    """

    def __init__(self, min_pods: int = 8, max_pods: int = 0,
                 latency_budget_s: float | None = None):
        self.min_pods = _next_pow2(min_pods)
        self.max_pods = max_pods  # 0: the caller's cap alone
        self.latency_budget_s = latency_budget_s or None
        # AIMD ceiling driven by the latency guard; None = wide open
        self._soft_max: int | None = None
        self.sized_waves = 0
        # capacity-gate signal for the stall profiler: True when the last
        # next_size() wanted more slots than the caller's cap allowed
        self.last_clipped = False
        self.capped_waves = 0

    def next_size(self, backlog: int, cap: int) -> int:
        """Target pod count for the next wave.

        `backlog` is the queue's active-pod depth; `cap` is the caller's
        max_pods and stays a hard ceiling: callers that ask for 512-pod
        waves under a dumped backlog still get exactly 512."""
        ceiling = cap
        if self.max_pods > 0:
            ceiling = min(ceiling, self.max_pods)
        if self._soft_max is not None:
            ceiling = min(ceiling, self._soft_max)
        # +1: the pod about to be popped may not be counted as active yet
        target = _next_pow2(backlog + 1, self.min_pods)
        self.sized_waves += 1
        self.last_clipped = target > ceiling
        if self.last_clipped:
            self.capped_waves += 1
        return max(1, min(target, ceiling))

    def observe(self, wave_duration_s: float) -> None:
        """AIMD latency guard (opt-in): a wave over budget halves the size
        ceiling; a wave under budget recovers one pow2 step."""
        budget = self.latency_budget_s
        if budget is None:
            return
        if wave_duration_s > budget:
            base = self._soft_max if self._soft_max is not None else \
                max(self.max_pods, self.min_pods * 4)
            self._soft_max = max(self.min_pods, base // 2)
        elif self._soft_max is not None:
            doubled = self._soft_max * 2
            limit = self.max_pods if self.max_pods > 0 else doubled
            self._soft_max = doubled if doubled < limit else None

    def snapshot(self) -> dict:
        return {
            "min_pods": self.min_pods,
            "max_pods": self.max_pods,
            "latency_budget_s": self.latency_budget_s,
            "soft_max": self._soft_max,
            "sized_waves": self.sized_waves,
            "capped_waves": self.capped_waves,
        }
