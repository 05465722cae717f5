"""The nominator: which pods a preemption nominated onto which nodes.

Reference: backend/queue/nominator.go. A copy of the nominator half of the
reference package's SchedulingQueue
(kubernetes_tpu/scheduler/queue/scheduling_queue.py:530-578), as a class
of its own that the port's SchedulingQueue holds and answers for. The scheduling algorithm reads
it to simulate nominated pods of equal or higher priority while filtering
(schedule_one.go:1190 addNominatedPods).
"""

from __future__ import annotations

import threading

from ...api.resource import ResourceNames
from ...api.types import Pod
from ..nodeinfo import PodInfo


class Nominator:
    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._nominated: dict[str, tuple[str, PodInfo]] = {}  # key -> (node, info)

    def add_nominated_pod(self, pod: Pod, node_name: str, pod_info: PodInfo | None = None) -> None:
        with self._mu:
            self._nominated[pod.meta.key] = (
                node_name,
                pod_info or PodInfo(pod, ResourceNames()),
            )

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        with self._mu:
            self._nominated.pop(pod.meta.key, None)

    def nominated_pods_for_node(self, node_name: str) -> list[str]:
        with self._mu:
            return [k for k, (n, _) in self._nominated.items() if n == node_name]

    def nominated_pod_info(self, key: str) -> PodInfo | None:
        with self._mu:
            entry = self._nominated.get(key)
            return entry[1] if entry else None

    def nominated_node_for(self, pod: Pod) -> str:
        with self._mu:
            entry = self._nominated.get(pod.meta.key)
            return entry[0] if entry else ""

    def max_nominated_priority(self, exclude_key: str | None = None) -> int | None:
        """Highest priority among nominated pods (optionally excluding one
        pod), None when nothing is nominated. Only pods a nomination of
        equal or higher priority could affect leave the kernel-only path."""
        with self._mu:
            best: int | None = None
            for key, (_n, info) in self._nominated.items():
                if key == exclude_key:
                    continue
                p = info.pod.spec.priority
                if best is None or p > best:
                    best = p
            return best

    def has_nominated_pods(self) -> bool:
        with self._mu:
            return bool(self._nominated)
