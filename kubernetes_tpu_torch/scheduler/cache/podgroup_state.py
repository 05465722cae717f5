"""Per-gang pod accounting, snapshotted into scheduling cycles.

Reference: pkg/scheduler/backend/cache/podgroupstate.go:66,217 — each PodGroup
tracks unscheduled/assumed/scheduled member sets with generations; the gang
plugin reads the snapshot copy inside gang cycles and the live copy otherwise.
"""

from __future__ import annotations

import threading

from ...api.types import PodGroup


class PodGroupState:
    __slots__ = ("group", "unscheduled", "assumed", "scheduled")

    def __init__(self, group: PodGroup | None = None):
        self.group = group
        self.unscheduled: set[str] = set()
        self.assumed: set[str] = set()
        self.scheduled: set[str] = set()

    @property
    def all_pods_count(self) -> int:
        return len(self.unscheduled) + len(self.assumed) + len(self.scheduled)

    @property
    def scheduled_pods_count(self) -> int:
        return len(self.scheduled)

    @property
    def assumed_or_scheduled_count(self) -> int:
        return len(self.assumed) + len(self.scheduled)

    def clone(self) -> "PodGroupState":
        s = PodGroupState(self.group)
        s.unscheduled = set(self.unscheduled)
        s.assumed = set(self.assumed)
        s.scheduled = set(self.scheduled)
        return s


class PodGroupStates:
    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._groups: dict[str, PodGroupState] = {}  # "namespace/name" -> state

    def set_group(self, group: PodGroup) -> None:
        with self._mu:
            st = self._groups.setdefault(group.meta.key, PodGroupState())
            st.group = group

    def remove_group(self, key: str) -> None:
        with self._mu:
            self._groups.pop(key, None)

    def get(self, key: str) -> PodGroupState | None:
        with self._mu:
            return self._groups.get(key)

    def pod_added(self, group_key: str, pod_key: str) -> None:
        with self._mu:
            st = self._groups.setdefault(group_key, PodGroupState())
            if pod_key not in st.scheduled and pod_key not in st.assumed:
                st.unscheduled.add(pod_key)

    def pod_assumed(self, group_key: str, pod_key: str) -> None:
        with self._mu:
            st = self._groups.setdefault(group_key, PodGroupState())
            st.unscheduled.discard(pod_key)
            st.assumed.add(pod_key)

    def pod_scheduled(self, group_key: str, pod_key: str) -> None:
        with self._mu:
            st = self._groups.setdefault(group_key, PodGroupState())
            st.unscheduled.discard(pod_key)
            st.assumed.discard(pod_key)
            st.scheduled.add(pod_key)

    def pod_unassumed(self, group_key: str, pod_key: str) -> None:
        with self._mu:
            st = self._groups.get(group_key)
            if st is not None:
                st.assumed.discard(pod_key)
                st.unscheduled.add(pod_key)

    def pod_removed(self, group_key: str, pod_key: str) -> None:
        with self._mu:
            st = self._groups.get(group_key)
            if st is not None:
                st.unscheduled.discard(pod_key)
                st.assumed.discard(pod_key)
                st.scheduled.discard(pod_key)

    def snapshot(self) -> dict[str, PodGroupState]:
        with self._mu:
            return {k: v.clone() for k, v in self._groups.items()}
