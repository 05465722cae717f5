"""Storage API types: PersistentVolume, PersistentVolumeClaim, StorageClass,
CSINode, and pod Volume sources.

Reference: staging/src/k8s.io/api/core/v1/types.go (PersistentVolume,
PersistentVolumeClaim, Volume), staging/src/k8s.io/api/storage/v1/types.go
(StorageClass, CSINode). Only the scheduling-relevant subset: the volume
plugins need binding state, capacity, access modes, node affinity / zone
labels, binding mode, and CSI attach limits.

A copy of the reference package's module
(kubernetes_tpu/api/storage.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta
from .types import NodeSelector

# Access modes (core/v1 PersistentVolumeAccessMode)
READ_WRITE_ONCE = "ReadWriteOnce"
READ_ONLY_MANY = "ReadOnlyMany"
READ_WRITE_MANY = "ReadWriteMany"
READ_WRITE_ONCE_POD = "ReadWriteOncePod"

# PV phases
VOLUME_AVAILABLE = "Available"
VOLUME_BOUND = "Bound"
VOLUME_RELEASED = "Released"

# PVC phases
CLAIM_PENDING = "Pending"
CLAIM_BOUND = "Bound"

# StorageClass volumeBindingMode
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# Provisioner value meaning "static PVs only" (storage/v1 well-known)
NO_PROVISIONER = "kubernetes.io/no-provisioner"

# persistentVolumeReclaimPolicy (core/v1)
RECLAIM_RETAIN = "Retain"
RECLAIM_DELETE = "Delete"

# Well-known zone/region labels the VolumeZone plugin matches
# (reference: pkg/scheduler/framework/plugins/volumezone/volume_zone.go
# topologyLabels).
ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


@dataclass(frozen=True)
class Volume:
    """A pod volume source (core/v1 Volume). Only the sources the scheduler
    inspects are modeled: PVC references and ephemeral volumes (which own a
    generated claim named <pod>-<volume>)."""

    name: str
    persistent_volume_claim: str = ""  # claim name in the pod's namespace
    ephemeral: bool = False  # generic ephemeral volume -> claim <pod>-<name>
    host_path: str = ""
    empty_dir: bool = False

    def claim_name(self, pod_name: str) -> str:
        """The PVC name this volume resolves to, or '' if not claim-backed.

        Reference: ephemeral claims are named <podName>-<volumeName>
        (component-helpers/storage/ephemeral).
        """
        if self.persistent_volume_claim:
            return self.persistent_volume_claim
        if self.ephemeral:
            return f"{pod_name}-{self.name}"
        return ""


@dataclass
class PersistentVolumeSpec:
    capacity: dict[str, object] = field(default_factory=dict)  # {"storage": "10Gi"}
    access_modes: tuple[str, ...] = (READ_WRITE_ONCE,)
    storage_class_name: str = ""
    node_affinity: NodeSelector | None = None  # required topology
    claim_ref: str = ""  # "namespace/name" of the bound claim
    # UID of the bound claim (claimRef.uid): distinguishes the claim
    # INSTANCE — a deleted-and-recreated same-named PVC must not keep the
    # old PV bound (pv_controller.go checks exactly this)
    claim_ref_uid: str = ""
    csi_driver: str = ""  # CSI driver name, "" for in-tree/local volumes
    reclaim_policy: str = RECLAIM_RETAIN  # persistentVolumeReclaimPolicy


@dataclass
class PersistentVolumeStatus:
    phase: str = VOLUME_AVAILABLE


@dataclass
class PersistentVolume:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)
    status: PersistentVolumeStatus = field(default_factory=PersistentVolumeStatus)

    kind = "PersistentVolume"

    @property
    def storage_capacity(self) -> int:
        from .quantity import parse_quantity

        return int(parse_quantity(self.spec.capacity.get("storage", 0)))


@dataclass
class PersistentVolumeClaimSpec:
    access_modes: tuple[str, ...] = (READ_WRITE_ONCE,)
    storage_class_name: str = ""
    volume_name: str = ""  # set when bound (or pre-bound) to a PV
    request: dict[str, object] = field(default_factory=dict)  # {"storage": "5Gi"}


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = CLAIM_PENDING


@dataclass
class PersistentVolumeClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(
        default_factory=PersistentVolumeClaimStatus
    )

    kind = "PersistentVolumeClaim"

    @property
    def is_bound(self) -> bool:
        return self.status.phase == CLAIM_BOUND and bool(self.spec.volume_name)

    @property
    def requested_storage(self) -> int:
        from .quantity import parse_quantity

        return int(parse_quantity(self.spec.request.get("storage", 0)))


@dataclass
class StorageClass:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = NO_PROVISIONER
    volume_binding_mode: str = BINDING_IMMEDIATE
    # reclaim policy stamped onto dynamically provisioned PVs (the
    # reference defaults provisioned volumes to Delete)
    reclaim_policy: str = RECLAIM_DELETE

    kind = "StorageClass"

    @property
    def is_wait_for_first_consumer(self) -> bool:
        return self.volume_binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER


@dataclass(frozen=True)
class CSINodeDriver:
    name: str
    allocatable_count: int = 0  # 0 = no limit reported


@dataclass
class CSINode:
    """Per-node CSI driver registration + attach limits (storage/v1 CSINode).
    meta.name == node name."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: tuple[CSINodeDriver, ...] = ()

    kind = "CSINode"

    def limit_for(self, driver: str) -> int:
        for d in self.drivers:
            if d.name == driver:
                return d.allocatable_count
        return 0


def pod_claim_names(pod) -> list[str]:
    """All PVC names (in the pod's namespace) referenced by the pod's volumes."""
    out = []
    for v in pod.spec.volumes:
        name = v.claim_name(pod.meta.name)
        if name:
            out.append(name)
    return out


@dataclass
class VolumeAttachmentSpec:
    """storage.k8s.io/v1 VolumeAttachmentSpec (attach_detach_controller +
    the external CSI attacher's contract): which PV is being attached to
    which node by which attacher."""

    attacher: str = ""  # CSI driver name ("" = in-tree, attach is a no-op)
    node_name: str = ""
    pv_name: str = ""  # source.persistentVolumeName


@dataclass
class VolumeAttachment:
    """storage.k8s.io/v1 VolumeAttachment: the attach INTENT between PV
    binding and kubelet mount. The attach-detach controller creates these
    for scheduled pods' CSI volumes; the attacher (in-process here) flips
    status["attached"]; the kubelet's volume manager WAITS on that before
    mounting (WaitForAttachAndMount's attach half). Cluster-scoped.

    Reference: pkg/controller/volume/attachdetach/attach_detach_controller.go
    + staging/src/k8s.io/api/storage/v1/types.go VolumeAttachment."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: VolumeAttachmentSpec = field(default_factory=VolumeAttachmentSpec)
    # {"attached": bool, "attach_error": str}
    status: dict = field(default_factory=dict)

    kind = "VolumeAttachment"

    @staticmethod
    def expected_name(pv_name: str, node_name: str) -> str:
        """Deterministic, COLLISION-FREE name per (volume, node) pair —
        hashed like the reference's csi-<sha> (a readable join would
        collide: pv 'data-1'+node 'a' vs pv 'data'+node '1-a')."""
        import hashlib

        digest = hashlib.sha1(
            f"{pv_name}\x00{node_name}".encode()
        ).hexdigest()[:16]
        return f"attach-{digest}"
