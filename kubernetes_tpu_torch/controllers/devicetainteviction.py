"""Device taint eviction controller.

Reference: pkg/controller/devicetainteviction/ (KEP-5055) — watches
ResourceSlices, ResourceClaims and Pods; when a device acquires a
NoExecute taint, every pod whose allocated claim holds that device (and
does not tolerate the taint) is evicted, and the claim is deallocated so
the scheduler can re-allocate it onto untainted devices. The allocation
half of the feature (NoSchedule/NoExecute keeping NEW allocations off
tainted devices) lives in the DRA allocator.

A copy of the reference package's module
(kubernetes_tpu/controllers/devicetainteviction.py).
"""

from __future__ import annotations

from ..api.dra import NO_EXECUTE, untolerated_taints
from .base import Controller

_CLUSTER = "cluster"


class DeviceTaintEvictionController(Controller):
    name = "devicetainteviction"
    watches = ("ResourceSlice", "ResourceClaim", "Pod")

    def key_of(self, kind: str, obj) -> str | None:
        # taints/claims interact cluster-wide; one desired-state pass
        return _CLUSTER

    def _noexec_taints(self) -> dict[tuple[str, str, str], tuple]:
        """(driver, scoped pool, device) -> its NoExecute taints. Pool
        names use the allocator's node scoping (<node>/<pool> for
        node-local slices) so keys match AllocationResult entries."""
        out: dict[tuple[str, str, str], tuple] = {}
        for sl in self.store.list_refs("ResourceSlice"):
            pool = sl.pool if sl.all_nodes else f"{sl.node_name}/{sl.pool}"
            for dev in sl.devices:
                ts = tuple(t for t in dev.taints if t.effect == NO_EXECUTE)
                if ts:
                    out[(sl.driver, pool, dev.name)] = ts
        return out

    @staticmethod
    def _tolerations_by_result(claim) -> dict[str, tuple]:
        """AllocationResult request name -> that request's tolerations.
        Matching is PER REQUEST, like the allocator's: one request's
        toleration must not shield a device allocated for another (the
        result name of a prioritized-list winner is <request>/<sub>)."""
        out: dict[str, tuple] = {}
        for req in claim.spec.requests:
            out[req.name] = tuple(req.tolerations)
            for sub in req.first_available:
                out[f"{req.name}/{sub.name}"] = tuple(sub.tolerations)
        return out

    def reconcile(self, key: str) -> None:
        from ..store.store import NotFoundError

        tainted = self._noexec_taints()
        if not tainted:
            return
        for ref in self.store.list_refs("ResourceClaim"):
            alloc = ref.status.allocation
            if alloc is None:
                continue
            by_req = self._tolerations_by_result(ref)
            hit = [
                t
                for d in alloc.devices
                for t in tainted.get((d.driver, d.pool, d.device), ())
                if untolerated_taints([t], by_req.get(d.request, ()),
                                      effects=(NO_EXECUTE,))
            ]
            if not hit:
                continue
            # evict every consumer (the reference deletes the pods), then
            # deallocate so the claim can land on untainted devices
            for pod_key in ref.status.reserved_for:
                try:
                    self.store.delete("Pod", pod_key)
                except NotFoundError:
                    pass
            claim = self.store.get("ResourceClaim", ref.meta.key)
            claim.status.allocation = None
            claim.status.reserved_for = ()
            self.store.update(claim, check_version=False)
