"""Per-cycle typed key/value store.

Reference: staging/src/k8s.io/kube-scheduler/framework/cycle_state.go:45 —
plugin-private state flowing through one scheduling cycle. A trimmed copy:
the skip sets, metrics flags and clone() come with the framework slice that
has plugins to use them.
"""

from __future__ import annotations

from typing import Any


class CycleState:
    def __init__(self) -> None:
        self._storage: dict[str, Any] = {}

    def read(self, key: str) -> Any:
        return self._storage.get(key)

    def write(self, key: str, value: Any) -> None:
        self._storage[key] = value

    def delete(self, key: str) -> None:
        self._storage.pop(key, None)
