"""Node lifecycle: lease staleness -> Ready=Unknown, the unreachable taint
and the eviction of the node's pods.

Reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go
(Lease-staleness -> NotReady + unreachable taint) with pkg/controller/
tainteviction/ collapsed in. A copy of the part of the reference package's
module (kubernetes_tpu/controllers/lifecycle.py:19, :115-197) that the
chaos soaks run: `UNREACHABLE_TAINT` and `NodeLifecycleController`. Left
out, as no path of the port runs them: the garbage collector, the pod GC,
the resource-claim cleanup and the endpoint-slice controller.
"""

from __future__ import annotations

from ..api.types import NO_EXECUTE, NodeCondition, Taint
from ..store import try_delete
from ..utils import faultinject
from .base import Controller

UNREACHABLE_TAINT = "node.kubernetes.io/unreachable"


class NodeLifecycleController(Controller):
    """node_lifecycle_controller.go — Lease-staleness drives Ready condition
    and the unreachable NoExecute taint; pods on unreachable nodes are
    evicted (tainteviction collapsed in, as the reference does when
    TaintBasedEvictions became the only path)."""

    name = "node-lifecycle"
    watches = ("Node", "Lease")
    grace_period = 40.0  # node-monitor-grace-period default
    clocked_queue = True  # staleness monitoring self-requeues

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "Lease":
            if obj.meta.namespace != "kube-node-lease":
                return None
            return obj.meta.name
        return obj.meta.name

    def _lease_fresh(self, node_name: str) -> bool:
        lease = self.store.try_get("Lease", f"kube-node-lease/{node_name}")
        if lease is None:
            return False
        return self.clock.now() - lease.spec.renew_time < self.grace_period

    def reconcile(self, key: str) -> None:
        # chaos: the node-health monitor itself degrades — ERROR rides the
        # base class's backoff requeue and DROP skips one pass but keeps
        # the monitor's self-requeue alive; either way tainting/eviction
        # is DELAYED, never abandoned
        if faultinject.fire("controller.lifecycle"):
            self.queue.add_after(key, max(self.grace_period / 2, 0.2))
            return
        node = self.store.try_get("Node", key)
        if node is None:
            return
        fresh = self._lease_fresh(key)
        ready = next(
            (c for c in node.status.conditions if c.type == "Ready"), None
        )
        changed = False
        if ready is None:
            ready = NodeCondition(type="Ready", status="Unknown")
            node.status.conditions.append(ready)
            changed = True
        want_status = "True" if fresh else "Unknown"
        if ready.status != want_status:
            ready.status = want_status
            changed = True
        has_taint = any(t.key == UNREACHABLE_TAINT for t in node.spec.taints)
        if not fresh and not has_taint:
            node.spec.taints = tuple(node.spec.taints) + (
                Taint(key=UNREACHABLE_TAINT, effect=NO_EXECUTE),
            )
            changed = True
        elif fresh and has_taint:
            node.spec.taints = tuple(
                t for t in node.spec.taints if t.key != UNREACHABLE_TAINT
            )
            changed = True
        if changed:
            self.store.update(node, check_version=False)
        if not fresh:
            self._evict_pods(key)
        # continuous health monitoring (the reference's monitorNodeHealth
        # 5s poll): a DEAD kubelet emits no further lease events, so the
        # controller must wake itself to observe the staleness
        self.queue.add_after(key, max(self.grace_period / 2, 0.2))

    def _evict_pods(self, node_name: str) -> None:
        """tainteviction — NoExecute evicts pods lacking a matching
        toleration (tolerationSeconds treated as immediate at reconcile)."""
        taint = Taint(key=UNREACHABLE_TAINT, effect=NO_EXECUTE)
        for pod in self.store.pods():
            if pod.spec.node_name != node_name:
                continue
            if any(tol.tolerates(taint) for tol in pod.spec.tolerations):
                continue
            try_delete(self.store, "Pod", pod.meta.key)

    def sweep(self) -> None:
        for node in self.store.nodes():
            self.queue.add(node.meta.name)

