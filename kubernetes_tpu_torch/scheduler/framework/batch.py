"""Opportunistic batching: reuse one scoring pass across identical pods.

Reference: pkg/scheduler/framework/runtime/batch.go:33-229 (maxBatchAge:56,
GetNodeHint:63, StoreScheduleResults:97, batchStateCompatible:162) +
PodSignature from staging/.../framework/signers.go (the Framework.sign_pod
concatenation of per-plugin fragments). Feature OpportunisticBatching,
KEP-5598 (pkg/features/kube_features.go:671).

A signature's cached sorted score list answers "where would an identical pod
go" without re-running Score. The hinted node is re-Filtered (cheap, one
node); while it keeps passing, the whole run of identical pods binds there —
when it fills up, the hint advances down the list. Entries expire after
500 ms and on node-shape cluster events. Freshness uses time.monotonic():
a wall-clock jump (NTP step, suspend/resume) must not make entries
immortal or instantly stale.

The device kernels subsume this for wave-eligible pods (a wave of
identical pods is one K2 scan over its signatures); this host cache
accelerates the long-tail pods that take the host path, and the loop warms
it from each wave's per-signature score rows. A copy of the reference
package's module (kubernetes_tpu/scheduler/framework/batch.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

MAX_BATCH_AGE = 0.5  # seconds (batch.go maxBatchAge:56)

HIT = "hit"
MISS = "miss"
STALE = "stale"
EXHAUSTED = "exhausted"


@dataclass
class _BatchEntry:
    ordered_nodes: list[str]  # node names, best score first
    created: float  # time.monotonic() — never wall clock (see module doc)
    next_index: int = 0  # current hint position


@dataclass
class BatchCache:
    max_age: float = MAX_BATCH_AGE
    entries: dict[str, _BatchEntry] = field(default_factory=dict)
    metrics: object | None = None

    def _record(self, result: str) -> None:
        if self.metrics is not None:
            self.metrics.batch_attempts.inc(result)

    def has_fresh(self, signature: str) -> bool:
        """Cheap pre-check so callers skip PreFilter setup on a sure miss."""
        entry = self.entries.get(signature)
        if entry is None:
            self._record(MISS)
            return False
        if time.monotonic() - entry.created > self.max_age:
            del self.entries[signature]
            self._record(STALE)
            return False
        return True

    def get_node_hint(self, signature: str, filter_fn) -> str | None:
        """batch.go GetNodeHint:63 — the current hint node if it still passes
        Filter; otherwise advance down the list. filter_fn(node_name) -> bool
        runs the real Filter chain against the live snapshot."""
        t0 = time.perf_counter()
        try:
            entry = self.entries.get(signature)
            if entry is None:
                self._record(MISS)
                return None
            if time.monotonic() - entry.created > self.max_age:
                del self.entries[signature]
                self._record(STALE)
                return None
            while entry.next_index < len(entry.ordered_nodes):
                node = entry.ordered_nodes[entry.next_index]
                if filter_fn(node):
                    self._record(HIT)
                    return node
                entry.next_index += 1
            del self.entries[signature]
            self._record(EXHAUSTED)
            return None
        finally:
            if self.metrics is not None:
                self.metrics.get_node_hint_duration.observe(
                    time.perf_counter() - t0
                )

    def store_schedule_results(self, signature: str, ordered_nodes: list[str]) -> None:
        """batch.go StoreScheduleResults:97 — cache the sorted node list from
        a full scoring pass."""
        t0 = time.perf_counter()
        self.entries[signature] = _BatchEntry(list(ordered_nodes), time.monotonic())
        if self.metrics is not None:
            self.metrics.store_schedule_results_duration.observe(
                time.perf_counter() - t0
            )

    def flush(self) -> None:
        """Cluster events that change node shape invalidate every entry
        (BatchCacheFlushed metric in the reference)."""
        self.entries.clear()
