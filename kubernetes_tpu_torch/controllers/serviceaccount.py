"""ServiceAccount controller: a "default" account in every namespace.

Reference: pkg/controller/serviceaccount/serviceaccounts_controller.go —
ensures each active namespace carries the default ServiceAccount so pods
(whose spec.serviceAccountName is admission-defaulted to "default") always
resolve an identity. Recreates it if deleted; skips terminating
namespaces.

A copy of the reference package's module
(kubernetes_tpu/controllers/serviceaccount.py).
"""

from __future__ import annotations

from ..api.rbac import ServiceAccount
from .base import Controller


class ServiceAccountController(Controller):
    name = "serviceaccount"
    watches = ("Namespace", "ServiceAccount")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "Namespace":
            return obj.meta.name
        # a deleted/changed default SA reconciles its namespace
        return obj.meta.namespace if obj.meta.name == "default" else None

    def reconcile(self, namespace: str) -> None:
        ns = self.store.try_get("Namespace", namespace)
        if ns is None or ns.meta.deletion_timestamp is not None:
            return
        if self.store.try_get("ServiceAccount",
                              f"{namespace}/default") is None:
            sa = ServiceAccount()
            sa.meta.name = "default"
            sa.meta.namespace = namespace
            from ..store.store import AlreadyExistsError

            try:
                self.store.create(sa)
            except AlreadyExistsError:
                pass
