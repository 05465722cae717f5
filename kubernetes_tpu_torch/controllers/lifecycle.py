"""Lifecycle controllers: garbage collection, node lifecycle, taint eviction,
resource-claim cleanup, endpoint slices.

Reference: pkg/controller/garbagecollector/ (ownerReference cascade),
pkg/controller/nodelifecycle/node_lifecycle_controller.go (Lease-staleness ->
NotReady + unreachable taint), pkg/controller/tainteviction/,
pkg/controller/resourceclaim/, pkg/controller/endpointslice/.

A copy of the reference package's module
(kubernetes_tpu/controllers/lifecycle.py).
"""

from __future__ import annotations

from ..api.labels import labels_subset
from ..api.types import NO_EXECUTE, NodeCondition, Taint
from ..api.workloads import Endpoint, EndpointSlice
from ..api.meta import ObjectMeta
from ..utils import faultinject
from ..store import iter_kind, try_delete
from .base import Controller

UNREACHABLE_TAINT = "node.kubernetes.io/unreachable"

# kinds the GC walks (an informer per watched kind; the reference discovers
# these dynamically via the RESTMapper)
GC_KINDS = ("Pod", "ReplicaSet", "Deployment", "Job", "PersistentVolumeClaim",
            "ResourceClaim", "EndpointSlice")


class GarbageCollector(Controller):
    """garbagecollector — delete objects whose controller owner is gone.

    The reference builds a dependency graph; with the store's cheap listing
    the same effect comes from checking each dependent's owners on events.
    """

    name = "garbage-collector"
    watches = GC_KINDS

    def key_of(self, kind: str, obj) -> str | None:
        if not obj.meta.owner_references:
            return None
        return f"{kind}|{obj.meta.key}"

    def _owner_exists(self, namespace: str, ref) -> bool:
        key = f"{namespace}/{ref.name}" if namespace else ref.name
        owner = self.store.try_get(ref.kind, key)
        return owner is not None and (not ref.uid or owner.meta.uid == ref.uid)

    def reconcile(self, key: str) -> None:
        kind, _, obj_key = key.partition("|")
        obj = self.store.try_get(kind, obj_key)
        if obj is None:
            return
        refs = obj.meta.owner_references
        if refs and not any(self._owner_exists(obj.meta.namespace, r) for r in refs):
            try_delete(self.store, kind, obj_key)

    def sweep(self) -> int:
        """Full-resync mark pass (the reference's graph rebuild on sync)."""
        n = 0
        for kind in GC_KINDS:
            for obj in list(iter_kind(self.store, kind)):
                if obj.meta.owner_references:
                    self.queue.add(f"{kind}|{obj.meta.key}")
                    n += 1
        return n


class PodGCController(Controller):
    """podgc (pkg/controller/podgc/gc_controller.go) — three sweeps:

    - ORPHANED pods: bound to a node that no longer exists → delete (the
      kubelet that would run them is gone, nothing else will clean up);
    - TERMINATED pods beyond `terminated_threshold`: oldest finished pods
      deleted first, keeping the newest threshold-many (the reference's
      --terminated-pod-gc-threshold, default 12500);
    - UNSCHEDULED terminating pods: deleted immediately (no kubelet will
      ever finalize them).
    """

    name = "pod-gc"
    watches = ("Pod", "Node")
    TERMINATED_THRESHOLD = 12500

    def __init__(self, store, informers=None, clock=None,
                 terminated_threshold: int | None = None):
        super().__init__(store, informers, clock=clock)
        self.terminated_threshold = (
            self.TERMINATED_THRESHOLD if terminated_threshold is None
            else terminated_threshold)

    def key_of(self, kind: str, obj) -> str | None:
        # any pod/node event triggers one global sweep (the reference runs
        # gc() on a 20s period; event-driven is strictly fresher)
        return "sweep"

    def reconcile(self, key: str) -> None:
        from ..api.types import FAILED, SUCCEEDED

        nodes = {n.meta.name for n in self.store.nodes()}
        terminated = []
        for p in list(self.store.pods()):
            phase = p.status.phase
            if p.spec.node_name and p.spec.node_name not in nodes:
                try_delete(self.store, "Pod", p.meta.key)  # orphaned
            elif p.is_terminating and not p.spec.node_name:
                try_delete(self.store, "Pod", p.meta.key)  # never ran
            elif phase in (SUCCEEDED, FAILED):
                terminated.append(p)
        excess = len(terminated) - self.terminated_threshold
        if excess > 0:
            terminated.sort(key=lambda p: p.meta.creation_timestamp)
            for p in terminated[:excess]:
                try_delete(self.store, "Pod", p.meta.key)


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


class ResourceClaimController(Controller):
    """resourceclaim controller — drop reservedFor entries of deleted pods;
    deallocate a claim once nothing reserves it (allowing reuse)."""

    name = "resourceclaim"
    watches = ("ResourceClaim", "Pod")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "ResourceClaim":
            return obj.meta.key
        # pod deletions may strand reservations on any claim it referenced
        from ..api.dra import pod_resource_claim_keys

        keys = pod_resource_claim_keys(obj)
        for k in keys[1:]:
            self.queue.add(k)
        return keys[0] if keys else None

    def reconcile(self, key: str) -> None:
        claim = self.store.try_get("ResourceClaim", key)
        if claim is None:
            return
        live = tuple(
            pod_key for pod_key in claim.status.reserved_for
            if self.store.try_get("Pod", pod_key) is not None
        )
        if live != claim.status.reserved_for:
            claim.status.reserved_for = live
            if not live:
                claim.status.allocation = None  # deallocate idle claim
            self.store.update(claim, check_version=False)


class EndpointSliceController(Controller):
    """endpointslice controller — slices per Service tracking ready
    running pods matching the selector, chunked at MAX_ENDPOINTS per slice
    (discovery/v1's maxEndpointsPerSlice default 100: watch fan-out stays
    bounded when a service has thousands of backends)."""

    name = "endpointslice"
    watches = ("Service", "Pod")
    MAX_ENDPOINTS = 100

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "Service":
            return obj.meta.key
        # pods map back to services by label match
        for svc in iter_kind(self.store, "Service"):
            if (svc.meta.namespace == obj.meta.namespace
                    and svc.spec.selector
                    and labels_subset(svc.spec.selector, obj.meta.labels)):
                self.queue.add(svc.meta.key)
        return None

    def _owned_slices(self, namespace: str, svc_name: str) -> list:
        return [
            s for s in iter_kind(self.store, "EndpointSlice")
            if s.meta.namespace == namespace and s.service_name == svc_name
        ]

    def reconcile(self, key: str) -> None:
        ns, _, svc_name = key.partition("/")
        svc = self.store.try_get("Service", key)
        if svc is None:
            for s in self._owned_slices(ns, svc_name):
                try_delete(self.store, "EndpointSlice", s.meta.key)
            return
        from ..api.types import RUNNING

        def pod_ip(p) -> str:
            # prefer the kubelet-reported address; otherwise a stable
            # per-pod address derived from its uid (stable across
            # processes, unlike salted hash()) — churn elsewhere in the
            # cluster must not rewrite this slice's endpoints
            if p.status.pod_ip:
                return p.status.pod_ip
            from ..utils.net import stable_pod_ip

            return stable_pod_ip(p.meta.uid or p.meta.key)

        def pod_ready(p) -> bool:
            # pod readiness = Running AND the kubelet-reported Ready
            # condition isn't False (readiness probes gate it)
            if p.status.phase != RUNNING:
                return False
            cond = next((c for c in p.status.conditions
                         if c.type == "Ready"), None)
            return cond is None or cond.status != "False"

        endpoints = tuple(
            Endpoint(
                addresses=(pod_ip(p),),
                node_name=p.spec.node_name,
                # discovery/v1 conditions: a deleting pod stops being
                # "ready" but keeps "serving" while it still runs, so the
                # proxy's terminating fallback has real producers
                ready=(pod_ready(p)
                       and p.meta.deletion_timestamp is None),
                serving=pod_ready(p),
                terminating=p.meta.deletion_timestamp is not None,
                target_pod=p.meta.key,
            )
            for p in self.store.pods()
            if p.meta.namespace == svc.meta.namespace
            and p.spec.node_name
            and svc.spec.selector
            and labels_subset(svc.spec.selector, p.meta.labels)
        )
        # chunk into slices of MAX_ENDPOINTS (stable order so chunks only
        # churn where membership actually changed)
        ordered = sorted(endpoints, key=lambda e: e.target_pod)
        chunks = [tuple(ordered[i:i + self.MAX_ENDPOINTS])
                  for i in range(0, len(ordered), self.MAX_ENDPOINTS)] or [()]
        want_names = {f"{svc.meta.name}-endpoints-{i}" if i else
                      f"{svc.meta.name}-endpoints"
                      for i in range(len(chunks))}
        for s in self._owned_slices(svc.meta.namespace, svc.meta.name):
            if s.meta.name not in want_names:
                try_delete(self.store, "EndpointSlice", s.meta.key)
        for i, chunk in enumerate(chunks):
            name = (f"{svc.meta.name}-endpoints-{i}" if i
                    else f"{svc.meta.name}-endpoints")
            existing = self.store.try_get(
                "EndpointSlice", f"{svc.meta.namespace}/{name}"
            )
            if existing is None:
                self.store.create(EndpointSlice(
                    meta=ObjectMeta(name=name, namespace=svc.meta.namespace),
                    service_name=svc.meta.name,
                    endpoints=chunk,
                    ports=svc.spec.ports,
                ))
            elif (existing.endpoints != chunk
                  or existing.ports != svc.spec.ports):
                existing.endpoints = chunk
                existing.ports = svc.spec.ports
                self.store.update(existing, check_version=False)


class NamespaceController(Controller):
    """namespace lifecycle controller — pkg/controller/namespace: a
    Namespace marked for deletion drains every namespaced object it holds
    (the "content deleter" walking discovered resources), then the
    namespace object itself goes away. Phase mirrors the reference:
    Active → Terminating (deletion_timestamp set) → gone."""

    name = "namespace"
    watches = ("Namespace",)

    @staticmethod
    def drain_kinds() -> list[str]:
        """Every namespaced kind from the registry (the reference's
        discovery-driven content deleter), workload owners first and pods
        last so controllers don't resurrect pods mid-drain. Derived, not
        hand-listed: a new namespaced kind is drained automatically."""
        from ..apiserver.discovery import CLUSTER_SCOPED, all_kinds

        first = ["Deployment", "StatefulSet", "DaemonSet", "ReplicaSet",
                 "Job"]
        last = ["Pod"]
        rest = sorted(k for k in all_kinds()
                      if k not in CLUSTER_SCOPED
                      and k not in first and k not in last)
        return first + rest + last

    def reconcile(self, key: str) -> None:
        ns = self.store.try_get("Namespace", key)
        if ns is None:
            return
        if ns.meta.deletion_timestamp is None:
            return
        if ns.phase != "Terminating":
            ns.phase = "Terminating"
            self.store.update(ns, check_version=False)
        name = ns.meta.name
        remaining = 0
        for kind in self.drain_kinds():
            for obj in iter_kind(self.store, kind):
                if obj.meta.namespace != name:
                    continue
                remaining += 1
                try_delete(self.store, kind, obj.meta.key)
        if remaining:
            # deletes cascade through other controllers/kubelets; re-check
            self.queue.add(key)
            return
        try_delete(self.store, "Namespace", key)


class TTLAfterFinishedController(Controller):
    """ttl-after-finished controller — pkg/controller/ttlafterfinished:
    deletes finished Jobs ttlSecondsAfterFinished after completion. Jobs
    whose TTL hasn't elapsed yet are requeued (the reference enqueues with
    a delay; our workqueue re-add plays that role via periodic syncs)."""

    name = "ttlafterfinished"
    watches = ("Job",)

    clocked_queue = True  # TTL-expiry self-requeues ride the clock

    def reconcile(self, key: str) -> None:
        job = self.store.try_get("Job", key)
        if job is None:
            return
        ttl = job.spec.ttl_seconds_after_finished
        if ttl is None or not job.status.completed:
            return
        done_at = job.status.completion_time
        if done_at is None:
            return
        remaining = ttl - (self.clock.now() - done_at)
        if remaining <= 0:
            try_delete(self.store, "Job", key)
        else:
            # delayed requeue (the reference enqueueAfter) — a plain add()
            # would busy-spin the worker for the whole TTL window
            self.queue.add_after(key, remaining)
