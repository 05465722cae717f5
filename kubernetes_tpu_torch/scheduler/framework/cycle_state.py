"""Per-cycle typed key/value store.

Reference: staging/src/k8s.io/kube-scheduler/framework/cycle_state.go:45 and
pkg/scheduler/framework/cycle_state.go — plugin-private state flowing through
one scheduling cycle, with skip-sets computed at PreFilter/PreScore and the
gang-cycle flag. A copy of the reference package's module.
"""

from __future__ import annotations

import copy
from typing import Any


class CycleState:
    def __init__(self) -> None:
        self._storage: dict[str, Any] = {}
        self.skip_filter_plugins: set[str] = set()
        self.skip_score_plugins: set[str] = set()
        self.skip_pre_bind_plugins: set[str] = set()
        self.record_plugin_metrics = False
        self.is_pod_group_scheduling_cycle = False

    def read(self, key: str) -> Any:
        return self._storage.get(key)

    def write(self, key: str, value: Any) -> None:
        self._storage[key] = value

    def delete(self, key: str) -> None:
        self._storage.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        # plugin state objects implement clone() if they need COW semantics
        for k, v in self._storage.items():
            c._storage[k] = v.clone() if hasattr(v, "clone") else copy.copy(v)
        c.skip_filter_plugins = set(self.skip_filter_plugins)
        c.skip_score_plugins = set(self.skip_score_plugins)
        c.skip_pre_bind_plugins = set(self.skip_pre_bind_plugins)
        c.record_plugin_metrics = self.record_plugin_metrics
        c.is_pod_group_scheduling_cycle = self.is_pod_group_scheduling_cycle
        return c
