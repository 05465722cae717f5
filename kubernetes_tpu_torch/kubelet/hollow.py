"""Hollow kubelet: a node agent with a fake container runtime.

Reference: pkg/kubelet (Run:1833, syncLoop:2602, SyncPod:2002, node lease
heartbeat kubelet.go:1122-1128) in its kubemark form
(pkg/kubemark/hollow_kubelet.go:62 — real kubelet logic, fake CRI). The sync
loop here is the same shape: watch pods assigned to this node, drive them
through a fake runtime (Pending -> Running -> Succeeded), report NodeStatus,
heartbeat a Lease, and finalize deletions.

A copy of the reference package's module (kubernetes_tpu/kubelet/hollow.py).
"""

from __future__ import annotations

import threading

from ..api.types import (
    Node,
    PENDING,
    RUNNING,
    SUCCEEDED,
    PodCondition,
)
from ..store import try_delete
from ..store.store import ConflictError, NotFoundError
from ..utils import faultinject
from ..utils.net import stable_pod_ip
from .agent import NodeAgentBase


class FakeRuntime:
    """The kubemark fake CRI: containers 'run' instantly; a spec'd run
    duration lets Jobs complete."""

    def __init__(self, clock):
        self.clock = clock
        self.containers: dict[str, float] = {}  # pod key -> start time

    def start_pod(self, pod) -> None:
        self.containers[pod.meta.key] = self.clock.now()

    def pod_finished(self, pod) -> bool:
        """Pods annotated with a run duration complete; service pods don't."""
        duration = pod.meta.annotations.get("kubemark.io/run-seconds")
        if duration is None:
            return False
        start = self.containers.get(pod.meta.key)
        return start is not None and self.clock.now() - start >= float(duration)

    def kill_pod(self, key: str) -> None:
        self.containers.pop(key, None)


class HollowKubelet(NodeAgentBase):
    """One hollow node agent (cmd/kubemark hollow-node)."""

    def __init__(self, store, node: Node, clock=None,
                 lease_duration: float = 40.0):
        from ..utils.clock import Clock

        self.store = store
        self.node = node
        self.node_name = node.meta.name
        self.clock = clock or Clock()
        self.lease_duration = lease_duration
        self.runtime = FakeRuntime(self.clock)
        self._watch = None

    # registration + heartbeat come from NodeAgentBase

    def register(self) -> None:
        super().register()
        # from the CURRENT revision: the watch is only drained as a wakeup
        # signal (state is re-listed each sync), and a node started mid-run
        # must not demand compacted history (watch(0) raises CompactedError
        # once >log_cap Pod events have ever happened)
        _, rev = self.store.list("Pod")
        self._watch = self.store.watch("Pod", from_revision=rev)

    # -- pod sync loop -------------------------------------------------------

    def _my_pods(self):
        return [p for p in self.store.pods() if p.spec.node_name == self.node_name]

    def sync_once(self) -> int:
        """One syncLoopIteration: converge every assigned pod; returns the
        number of pods whose status changed."""
        # chaos: a dead/hung kubelet (see Kubelet.sync_loop_iteration) —
        # skipping the iteration skips the heartbeat too, so the node's
        # lease goes stale and the lifecycle controller reacts
        if faultinject.fire("kubelet.sync"):
            return 0
        self.heartbeat()
        if self._watch is not None:
            self._watch.drain()  # consume; state is re-listed below
        changed = 0
        seen = set()
        for pod in self._my_pods():
            seen.add(pod.meta.key)
            if pod.is_terminating:
                # finalize: the runtime stops containers, then the API object
                # goes away (kubelet's graceful deletion handshake)
                self.runtime.kill_pod(pod.meta.key)
                try_delete(self.store, "Pod", pod.meta.key)
                changed += 1
                continue
            if pod.status.phase == PENDING:
                self.runtime.start_pod(pod)
                pod.status.phase = RUNNING
                pod.status.start_time = self.clock.now()
                if not pod.status.pod_ip:
                    # sandbox networking: stable per-pod address (crc32 of
                    # uid — same scheme the endpointslice controller falls
                    # back to for pods that never report one)
                    pod.status.pod_ip = stable_pod_ip(
                        pod.meta.uid or pod.meta.key
                    )
                ready = PodCondition(type="Ready", status="True")
                pod.status.conditions = [
                    c for c in pod.status.conditions if c.type != "Ready"
                ] + [ready]
                self._update_status(pod)
                changed += 1
            elif pod.status.phase == RUNNING and self.runtime.pod_finished(pod):
                pod.status.phase = (
                    SUCCEEDED if pod.spec.restart_policy != "Always" else RUNNING
                )
                if pod.status.phase == SUCCEEDED:
                    self.runtime.kill_pod(pod.meta.key)
                    self._update_status(pod)
                    changed += 1
        # reap runtime state for pods that vanished without deletion_timestamp
        for key in list(self.runtime.containers):
            if key not in seen:
                self.runtime.kill_pod(key)
        return changed

    def _update_status(self, pod) -> None:
        try:
            self.store.update(pod, check_version=False)
        except (ConflictError, NotFoundError):
            pass

    def run(self, stop_event: threading.Event, sync_period: float = 0.05) -> threading.Thread:
        def loop():
            while not stop_event.is_set():
                self.sync_once()
                stop_event.wait(sync_period)

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        return t


def start_hollow_nodes(store, n: int, clock=None, cpu: str = "32",
                       mem: str = "64Gi", zones: int = 8) -> list[HollowKubelet]:
    """kubemark cluster bootstrap: n hollow nodes registered and synced."""
    from ..testing.wrappers import make_node

    kubelets = []
    for i in range(n):
        node = make_node(f"hollow-node-{i}", cpu=cpu, mem=mem,
                         zone=f"zone-{i % zones}")
        k = HollowKubelet(store, node, clock=clock)
        k.register()
        kubelets.append(k)
    return kubelets
