"""ResourceQuota: usage accounting + admission enforcement.

Reference: pkg/controller/resourcequota (recompute status.used from live
objects) + plugin/pkg/admission/resourcequota (reject creates that would
exceed hard). Tracked resources: requests.cpu (milli), requests.memory
(MiB), pods, and count/<Kind> object counts — the subset our API models.

A copy of the reference package's module
(kubernetes_tpu/controllers/quota.py).
"""

from __future__ import annotations

from ..api.quantity import parse_cpu, parse_mem_mib
from ..store import iter_kind
from .base import Controller

POD_PHASES_COUNTED = ("Pending", "Running")  # terminal pods don't consume


def pod_usage(pod) -> dict[str, int]:
    cpu = sum(parse_cpu(c.requests["cpu"])
              for c in pod.spec.containers if "cpu" in c.requests)
    mem = sum(parse_mem_mib(c.requests["memory"])
              for c in pod.spec.containers if "memory" in c.requests)
    return {"requests.cpu": cpu, "requests.memory": mem, "pods": 1}


def compute_usage(store, namespace: str, tracked: set[str]) -> dict[str, int]:
    used: dict[str, int] = {k: 0 for k in tracked}
    if {"requests.cpu", "requests.memory", "pods"} & tracked:
        # namespace-filtered list: the admission hot path must not deepcopy
        # every pod in the cluster to sum one namespace
        pods, _ = store.list("Pod", namespace=namespace)
        for p in pods:
            if p.status.phase not in POD_PHASES_COUNTED:
                continue
            for k, v in pod_usage(p).items():
                if k in used:
                    used[k] += v
    for key in tracked:
        if key.startswith("count/"):
            kind = key.split("/", 1)[1]
            used[key] = len(store.list(kind, namespace=namespace)[0])
    return used


class QuotaController(Controller):
    """resource_quota_controller.go: keep status.used fresh as objects
    churn, so admission decisions rest on accurate accounting.

    The reference discovers countable kinds dynamically via the
    RESTMapper; here the watch set is the kinds quotas commonly count
    (any event re-enqueues that namespace's quotas)."""

    name = "resourcequota"
    watches = ("ResourceQuota", "Pod", "Service", "PersistentVolumeClaim",
               "ResourceClaim", "Deployment", "Job")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "ResourceQuota":
            return obj.meta.key
        for rq in iter_kind(self.store, "ResourceQuota"):
            if rq.meta.namespace == obj.meta.namespace:
                self.queue.add(rq.meta.key)
        return None

    def reconcile(self, key: str) -> None:
        rq = self.store.try_get("ResourceQuota", key)
        if rq is None:
            return
        used = compute_usage(self.store, rq.meta.namespace, set(rq.hard))
        if used != rq.used:
            rq.used = used
            self.store.update(rq, check_version=False)


def quota_admission(store):
    """Validating admission: a create that would push any tracked resource
    past `hard` is rejected with 403 (the reference's quota admission)."""
    from ..apiserver.server import AdmissionError

    def admit(operation: str, obj) -> None:
        if operation != "CREATE":
            return
        ns = getattr(obj.meta, "namespace", "")
        if not ns:
            return
        kind = getattr(obj, "kind", "")
        for rq in iter_kind(store, "ResourceQuota"):
            if rq.meta.namespace != ns:
                continue
            # candidate's increments against this quota
            inc: dict[str, int] = {}
            if kind == "Pod":
                for k, v in pod_usage(obj).items():
                    if k in rq.hard:
                        inc[k] = v
            count_key = f"count/{kind}"
            if count_key in rq.hard:
                inc[count_key] = inc.get(count_key, 0) + 1
            if not inc:
                continue
            # recompute live usage (never trust possibly-stale status for
            # the enforcement decision)
            used = compute_usage(store, ns, set(inc))
            for k, v in inc.items():
                if used.get(k, 0) + v > rq.hard[k]:
                    raise AdmissionError(
                        f"exceeded quota {rq.meta.name}: requested "
                        f"{k}={v}, used {used.get(k, 0)} of {rq.hard[k]}",
                        code=403,
                    )

    # the live-usage check must be atomic with the store commit: the server
    # runs tagged plugins under its per-namespace create lock
    admit.serialize_with_create = True
    return admit
