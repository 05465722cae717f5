"""PersistentVolume lifecycle controller: claim↔volume binding outside the
scheduler, dynamic provisioning, reclaim.

Reference: pkg/controller/volume/persistentvolume/pv_controller.go — the
controller that owns Immediate-mode binding (syncUnboundClaim: find the
smallest adequate Available PV, else dynamically provision when the class
has a provisioner), keeps half-finished binds converging (syncBoundClaim),
and reclaims released volumes per persistentVolumeReclaimPolicy
(reclaimVolume: Retain → Released, Delete → delete the PV).

WaitForFirstConsumer claims are explicitly NOT bound here — the scheduler's
volume binder owns them (volume_binding.go PreBind), exactly as the
reference's pv controller skips claims annotated for delayed binding. With
this controller running, a pod using an unbound immediate-mode PVC is no
longer stranded: the controller binds the claim, the PVC update event
requeues the pod (VolumeBinding's EventsToRegister), and scheduling
proceeds.

A copy of the reference package's module
(kubernetes_tpu/controllers/volume.py).
"""

from __future__ import annotations

from ..api.storage import (
    CLAIM_BOUND,
    CLAIM_PENDING,
    NO_PROVISIONER,
    RECLAIM_DELETE,
    VOLUME_AVAILABLE,
    VOLUME_BOUND,
    VOLUME_RELEASED,
    PersistentVolume,
    PersistentVolumeSpec,
)
from ..store import iter_kind, try_delete
from .base import Controller


class PersistentVolumeController(Controller):
    name = "persistentvolume"
    watches = ("PersistentVolumeClaim", "PersistentVolume", "StorageClass")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "PersistentVolumeClaim":
            return f"pvc:{obj.meta.key}"
        if kind == "PersistentVolume":
            return f"pv:{obj.meta.key}"
        # a new StorageClass can unblock provisioning for pending claims
        return "rescan:"

    def reconcile(self, key: str) -> None:
        what, _, name = key.partition(":")
        if what == "pvc":
            self._sync_claim(name)
        elif what == "pv":
            self._sync_volume(name)
            pv = self.store.try_get("PersistentVolume", name)
            if pv is None:
                return
            if pv.spec.claim_ref:
                # bound/pre-bound volume: only its own claim can care —
                # NOT a global rescan (scheduler PreBind emits thousands
                # of bound-PV events in a WFFC storm; each must be O(1))
                self.queue.add(f"pvc:{pv.spec.claim_ref}")
            else:
                # an Available PV can only satisfy claims of its class
                self._rescan_pending(pv.spec.storage_class_name)
        else:
            self._rescan_pending()

    def _rescan_pending(self, storage_class: str | None = None) -> None:
        for pvc in iter_kind(self.store, "PersistentVolumeClaim"):
            if pvc.status.phase != CLAIM_PENDING:
                continue
            if (storage_class is not None
                    and pvc.spec.storage_class_name != storage_class):
                continue
            self.queue.add(f"pvc:{pvc.meta.key}")

    # -- claims (pv_controller.go syncClaim) --------------------------------

    def _sync_claim(self, claim_key: str) -> None:
        pvc = self.store.try_get("PersistentVolumeClaim", claim_key)
        if pvc is None:
            # claim deleted: reclaim any volume still referencing it
            for pv in list(iter_kind(self.store, "PersistentVolume")):
                if pv.spec.claim_ref == claim_key:
                    self._sync_volume(pv.meta.key)
            return
        if pvc.spec.volume_name:
            self._sync_prebound_claim(pvc)
            return
        sc = self.store.try_get("StorageClass", pvc.spec.storage_class_name) \
            if pvc.spec.storage_class_name else None
        wffc = sc is not None and sc.is_wait_for_first_consumer
        stale, pv = self._scan_volumes(pvc, match=not wffc)
        for name in stale:
            # a PV still referencing a PREVIOUS instance of this claim key
            # (delete + recreate before we reconciled) is dead — reclaim
            # it, or it stays Bound-with-stale-claimRef forever. This runs
            # for WFFC claims too: the binder refuses stale-uid PVs, so
            # only reclaim can free them.
            self._sync_volume(name)
        if wffc:
            return  # the scheduler's binder owns WFFC claims
        if pv is None and sc is not None and sc.provisioner != NO_PROVISIONER:
            pv = self._provision(pvc, sc)
        if pv is not None:
            self._bind(pv, pvc)

    def _sync_prebound_claim(self, pvc) -> None:
        """volume_name already set (pre-bound by user, or a bind that
        committed the PV half only): converge both halves."""
        pv = self.store.try_get("PersistentVolume", pvc.spec.volume_name)
        if pv is None:
            return  # claim references a missing PV: stays Pending (lost)
        if pv.spec.claim_ref in ("", pvc.meta.key) and (
            not pv.spec.claim_ref_uid
            or pv.spec.claim_ref_uid == pvc.meta.uid
        ):
            self._bind(pv, pvc)
        # else: PV belongs to another claim (instance) — stays Pending

    def _scan_volumes(self, pvc, match: bool = True):
        """ONE pass over PVs serving two roles (pv_controller.go folds both
        into its indexed lookups): collect stale same-key references (uid
        mismatch → reclaim) and, when `match`, find the best available
        volume — smallest Available PV satisfying class/capacity/access
        modes; a PV pre-bound to THIS claim instance wins outright."""
        stale: list[str] = []
        prebound = None
        best = None
        for pv in iter_kind(self.store, "PersistentVolume"):
            if pv.spec.claim_ref == pvc.meta.key:
                if (pv.spec.claim_ref_uid
                        and pv.spec.claim_ref_uid != pvc.meta.uid):
                    stale.append(pv.meta.key)
                elif pv.status.phase == VOLUME_AVAILABLE:
                    prebound = pv
                continue
            if not match or pv.status.phase != VOLUME_AVAILABLE:
                continue
            if pv.spec.claim_ref:
                continue
            if pv.spec.storage_class_name != pvc.spec.storage_class_name:
                continue
            if not set(pvc.spec.access_modes) <= set(pv.spec.access_modes):
                continue
            if pv.storage_capacity < pvc.requested_storage:
                continue
            if best is None or pv.storage_capacity < best.storage_capacity:
                best = pv
        return stale, (prebound if prebound is not None else best)

    def _provision(self, pvc, sc):
        """Dynamic provisioning (provisionClaimOperation): mint a PV sized
        to the request, pre-bound to the claim, carrying the class's
        reclaim policy."""
        name = f"pvc-{pvc.meta.uid or pvc.meta.key.replace('/', '-')}"
        existing = self.store.try_get("PersistentVolume", name)
        if existing is not None:
            return existing
        pv = PersistentVolume(spec=PersistentVolumeSpec(
            capacity=dict(pvc.spec.request),
            access_modes=tuple(pvc.spec.access_modes),
            storage_class_name=sc.meta.name,
            claim_ref=pvc.meta.key,
            claim_ref_uid=pvc.meta.uid,
            csi_driver="" if sc.provisioner == NO_PROVISIONER
            else sc.provisioner,
            reclaim_policy=sc.reclaim_policy,
        ))
        pv.meta.name = name
        pv.meta.namespace = ""
        return self.store.create(pv)

    def _bind(self, pv, pvc) -> None:
        """bindVolumeToClaim + bindClaimToVolume: PV half first, claim half
        second; each write skipped when already converged so reconciles
        are idempotent."""
        if (pv.spec.claim_ref != pvc.meta.key
                or pv.spec.claim_ref_uid != pvc.meta.uid
                or pv.status.phase != VOLUME_BOUND):
            pv.spec.claim_ref = pvc.meta.key
            pv.spec.claim_ref_uid = pvc.meta.uid
            pv.status.phase = VOLUME_BOUND
            self.store.update(pv, check_version=False)
        if (pvc.spec.volume_name != pv.meta.name
                or pvc.status.phase != CLAIM_BOUND):
            pvc.spec.volume_name = pv.meta.name
            pvc.status.phase = CLAIM_BOUND
            self.store.update(pvc, check_version=False)

    # -- volumes (pv_controller.go syncVolume / reclaimVolume) --------------

    def _sync_volume(self, name: str) -> None:
        pv = self.store.try_get("PersistentVolume", name)
        if pv is None:
            return
        if not pv.spec.claim_ref:
            if pv.status.phase != VOLUME_AVAILABLE:
                pv.status.phase = VOLUME_AVAILABLE
                self.store.update(pv, check_version=False)
            return
        pvc = self.store.try_get("PersistentVolumeClaim", pv.spec.claim_ref)
        if pvc is not None and (not pv.spec.claim_ref_uid
                                or pvc.meta.uid == pv.spec.claim_ref_uid):
            return  # bound (or pre-bound awaiting _sync_claim)
        # claim is gone — or a DIFFERENT same-named claim took its place
        # (uid mismatch): either way the bound instance is dead, reclaim
        if pv.status.phase == VOLUME_BOUND:
            if pv.spec.reclaim_policy == RECLAIM_DELETE:
                try_delete(self.store, "PersistentVolume", name)
                return
            pv.status.phase = VOLUME_RELEASED
            self.store.update(pv, check_version=False)
