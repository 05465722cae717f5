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

A copy of the reference package's module
(kubernetes_tpu/scheduler/tpu/wavecontroller.py) less its environment
knobs and its opt-in wall-clock latency guard (`observe`), which the loop
feeds only with the telemetry slice (A6c).
"""

from __future__ import annotations


def _next_pow2(n: int, floor: int = 1) -> int:
    p = max(1, floor)
    while p < n:
        p <<= 1
    return p


class WaveSizeController:
    """Sizes the next batched wave from queue depth. One instance is owned
    by the ScheduleOneLoop and consulted at the top of every
    `schedule_wave` call."""

    def __init__(self, min_pods: int = 8, max_pods: int = 0):
        self.min_pods = _next_pow2(min_pods)
        self.max_pods = max_pods  # 0: the caller's cap alone

    def next_size(self, backlog: int, cap: int) -> int:
        """Target pod count for the next wave.

        `backlog` is the queue's active-pod depth; `cap` is the caller's
        max_pods and stays a hard ceiling: callers that ask for 512-pod
        waves under a dumped backlog still get exactly 512."""
        ceiling = cap
        if self.max_pods > 0:
            ceiling = min(ceiling, self.max_pods)
        # +1: the pod about to be popped may not be counted as active yet
        target = _next_pow2(backlog + 1, self.min_pods)
        return max(1, min(target, ceiling))
