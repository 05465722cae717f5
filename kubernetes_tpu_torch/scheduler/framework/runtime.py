"""The scheduler framework's placement half, and the handle its plugins read.

Reference: kubernetes_tpu/scheduler/framework/runtime.py (Framework:
the plugin lists by extension point :78-79, run_placement_generate_plugins
and run_placement_score_plugins :496-513) and scheduler.py Handle. A
trimmed copy: the framework holds the plugins, their weights and the two
placement extension points the gang planner calls. The filter/score/bind
pipeline, the queue and the store come with the host tier of the port.

The handle gives a plugin the cluster state it reads: the cache (live gang
member accounting), the snapshot, and `store`, which stands in for the
reference's Store with its read side only (try_get by kind and key) over
the PodGroups and bound Pods a caller has added.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

from .interface import Status, status_of


class ObjectLookup:
    """The read side of a Store: objects by (kind, namespace/name key)."""

    def __init__(self) -> None:
        self._objects: dict[tuple[str, str], Any] = {}

    def add(self, obj) -> None:
        self._objects[(obj.kind, obj.meta.key)] = obj

    def try_get(self, kind: str, key: str):
        return self._objects.get((kind, key))


@dataclass
class Handle:
    """What stateful plugins get to touch (framework.Handle, interface.go:804)."""

    store: ObjectLookup = field(default_factory=ObjectLookup)
    cache: Any = None
    snapshot: Any = None


class Framework:
    """One profile's plugins, their score weights and the placement
    extension points."""

    def __init__(self, plugins: Sequence[Any], weights: dict[str, int] | None = None,
                 profile_name: str = "default-scheduler", handle: Handle | None = None):
        self.profile_name = profile_name
        self.plugins = list(plugins)
        self.weights = dict(weights or {})
        self.handle = handle
        for p in self.plugins:
            if handle is not None and hasattr(p, "set_handle"):
                p.set_handle(handle)

        def having(method: str) -> list[Any]:
            return [p for p in self.plugins if callable(getattr(p, method, None))]

        self.placement_generate_plugins = having("generate_placements")
        self.placement_score_plugins = having("score_placement")

    def run_placement_generate_plugins(self, state, pods, parent_placement):
        placements = [parent_placement]
        for p in self.placement_generate_plugins:
            out, st = p.generate_placements(state, pods, placements)
            st = status_of(st)
            if not st.is_success:
                return placements, st
            if out:
                placements = out
        return placements, Status()

    def run_placement_score_plugins(self, state, pods, placement) -> int:
        total = 0
        for p in self.placement_score_plugins:
            score, st = p.score_placement(state, pods, placement)
            if status_of(st).is_success:
                total += score * self.weights.get(p.name, 1)
        return total
