"""Attach/detach controller: VolumeAttachment reconciliation.

Reference: pkg/controller/volume/attachdetach/attach_detach_controller.go —
the controller watches pods and PVs, computes the desired set of
(volume, node) attachments from scheduled pods' claim-backed CSI volumes,
creates VolumeAttachment objects for missing ones and deletes them when the
last pod using the volume on that node is gone. The external CSI attacher
then performs the attach and reports status; here the attacher is
in-process (the in-memory dataplane), flipping status["attached"] in the
same reconcile pass so the kubelet's WaitForAttachAndMount can proceed.

In-tree (non-CSI) volumes need no attach — the kubelet mounts them
directly, exactly like the reference's non-attachable plugins.

A copy of the reference package's module
(kubernetes_tpu/controllers/attachdetach.py).
"""

from __future__ import annotations

from ..api.storage import VolumeAttachment, VolumeAttachmentSpec
from .base import Controller

_CLUSTER = "cluster"


class AttachDetachController(Controller):
    """Whole-cluster desired-state reconciler (the reference's
    desired_state_of_world is also global; per-object keys would just
    re-derive it)."""

    name = "attachdetach"
    watches = ("Pod", "PersistentVolumeClaim", "PersistentVolume",
               "VolumeAttachment")

    def key_of(self, kind: str, obj) -> str | None:
        return _CLUSTER

    def _desired(self) -> dict[str, tuple[str, str, str]]:
        """name -> (pv, node, attacher) for every scheduled pod's bound
        CSI claim volume (desired_state_of_world)."""
        out: dict[str, tuple[str, str, str]] = {}
        for pod in self.store.list_refs("Pod"):
            node = pod.spec.node_name
            if not node or pod.meta.deletion_timestamp is not None:
                continue
            for v in pod.spec.volumes:
                claim = v.claim_name(pod.meta.name)
                if not claim:
                    continue
                pvc = self.store.try_get(
                    "PersistentVolumeClaim", f"{pod.meta.namespace}/{claim}"
                )
                if pvc is None or not pvc.spec.volume_name:
                    continue
                pv = self.store.try_get("PersistentVolume",
                                        pvc.spec.volume_name)
                if pv is None or not pv.spec.csi_driver:
                    continue  # in-tree volumes attach implicitly
                name = VolumeAttachment.expected_name(pv.meta.name, node)
                out[name] = (pv.meta.name, node, pv.spec.csi_driver)
        return out

    def reconcile(self, key: str) -> None:
        from ..api.meta import ObjectMeta
        from ..store.store import AlreadyExistsError, NotFoundError

        desired = self._desired()
        existing = {va.meta.name
                    for va in self.store.list_refs("VolumeAttachment")}
        # attach: create intents for missing pairs
        for name, (pv, node, attacher) in desired.items():
            if name in existing:
                continue
            try:
                self.store.create(VolumeAttachment(
                    meta=ObjectMeta(name=name, namespace=""),
                    spec=VolumeAttachmentSpec(
                        attacher=attacher, node_name=node, pv_name=pv),
                ))
            except AlreadyExistsError:
                pass
        # the in-process attacher: report attach completion
        for name in desired:
            va = self.store.try_get("VolumeAttachment", name)
            if va is not None and not va.status.get("attached"):
                va.status["attached"] = True
                self.store.update(va, check_version=False)
        # detach: drop intents no pod needs anymore
        for name in existing - set(desired):
            try:
                self.store.delete("VolumeAttachment", name)
            except NotFoundError:
                pass
