"""Shared node-agent plumbing: registration + lease heartbeat.

Reference: both kubelet forms share one registration/heartbeat contract —
registerWithAPIServer (pkg/kubelet/kubelet_node_status.go) and the
fast-path Lease heartbeat (kubelet.go:1122-1128). Lease recreation on
heartbeat matters: the lease controller re-creates a deleted lease, and an
agent that only renews would be permanently NotReady after a lease GC.

A copy of the reference package's module (kubernetes_tpu/kubelet/agent.py).
"""

from __future__ import annotations

from ..api.coordination import Lease, LeaseSpec
from ..api.meta import ObjectMeta
from ..api.types import NodeCondition
from ..store.store import ConflictError, NotFoundError
from ..utils import faultinject

LEASE_NAMESPACE = "kube-node-lease"


class NodeAgentBase:
    """Mixin: subclasses set store/node/node_name/clock/lease_duration."""

    lease_duration: float = 40.0

    def register(self) -> None:
        """Create/refresh the Node object with Ready=True + first lease."""
        existing = self.store.try_get("Node", self.node_name)
        ready = NodeCondition(type="Ready", status="True")
        self.node.status.conditions = [
            c for c in self.node.status.conditions if c.type != "Ready"
        ] + [ready]
        if existing is None:
            self.store.create(self.node)
        else:
            existing.status = self.node.status
            self.store.update(existing, check_version=False)
            self.node = existing
        self.heartbeat()

    def heartbeat(self) -> None:
        # chaos: a lost heartbeat — the node keeps running pods but its
        # lease goes stale, the exact asymmetry the lifecycle controller's
        # grace period exists for. DROP skips this renewal only; the next
        # heartbeat recreates/renews as usual (degrades ERROR to a skip —
        # a crashed heartbeat and a lost one look identical to the lease)
        try:
            if faultinject.fire("kubelet.lease"):
                return
        except faultinject.FaultInjected:
            return
        key = f"{LEASE_NAMESPACE}/{self.node_name}"
        now = self.clock.now()
        lease = self.store.try_get("Lease", key)
        if lease is None:
            try:
                self.store.create(Lease(
                    meta=ObjectMeta(name=self.node_name,
                                    namespace=LEASE_NAMESPACE),
                    spec=LeaseSpec(
                        holder_identity=self.node_name,
                        lease_duration_seconds=self.lease_duration,
                        acquire_time=now, renew_time=now,
                    ),
                ))
            except ConflictError:
                pass
            return
        lease.spec.renew_time = now
        try:
            self.store.update(lease, check_version=False)
        except (ConflictError, NotFoundError):
            pass
