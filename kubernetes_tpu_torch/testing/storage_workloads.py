"""scheduler_perf's volume and DRA workloads on the port's harness.

`StorageWorkloadExecutor` is the port's WorkloadExecutor
(kubernetes_tpu_torch/perf/harness.py) that also makes the objects of the
ops that create storage and DRA objects: a createNodes op's `csiNodeDriver`
(a CSINode per node with the CSI driver's attach limit, scheduler_perf's
csiNodeAllocatable), a createPods op's `persistentVolumeClaimTemplate` and
`persistentVolumeTemplate` (a claim per pod, and a PV per pod, pre-bound to
it with `bound: true`) and `resourceClaimTemplate` (a ResourceClaim per
pod), and createResourceSlices (one ResourceSlice of `devicesPerNode`
devices per node). They are copies of the reference harness's
(kubernetes_tpu/perf/harness.py:268-434, `_attach_volume`,
`_attach_claim`). The harness dispatches ops by name, so the overrides
take effect with no change to it; with them perf/configs/volumes.json and
dra.json run through the port's Scheduler:

    cases = load_config("kubernetes_tpu_torch/perf/configs/volumes.json")
    case = cases[0]                     # SchedulingWFFCVolumes
    StorageWorkloadExecutor(case, case["workloads"][0], wave_size=32,
                            device="cpu").run()
"""

from __future__ import annotations

from ..api.dra import (
    Device,
    DeviceRequest,
    DeviceSelector,
    PodResourceClaim,
    ResourceClaim,
    ResourceClaimSpec,
    ResourceSlice,
)
from ..api.meta import ObjectMeta
from ..api.storage import (
    BINDING_WAIT_FOR_FIRST_CONSUMER,
    CLAIM_BOUND,
    CSINode,
    CSINodeDriver,
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    PersistentVolumeSpec,
    StorageClass,
    Volume,
)
from ..perf.harness import WorkloadExecutor, _resolve
from ..perf.templates import node_from_manifest, pod_from_manifest


class StorageWorkloadExecutor(WorkloadExecutor):
    """WorkloadExecutor with CSINode, PV, PVC, ResourceClaim and
    ResourceSlice construction."""

    def _op_createNodes(self, op: dict) -> None:
        template = self._template(op, "nodeTemplate", self.node_template)
        n = self._count(op)
        zones = int(_resolve(op.get("zones", 8), self.params) or 8)
        # csiNodeAllocatable: every created node also registers a CSINode
        # with the CSI driver's attach limit, which NodeVolumeLimits counts
        csi = op.get("csiNodeDriver")
        for _ in range(n):
            i = self._node_seq
            self._node_seq += 1
            name = f"node-{i}"
            self.store.create(node_from_manifest(template, name, zone=f"zone-{i % zones}"),
                              copy_return=False)
            if csi:
                self.store.create(CSINode(
                    meta=ObjectMeta(name=name, namespace=""),
                    drivers=(CSINodeDriver(name=csi.get("name", "csi.example.com"),
                                           allocatable_count=int(csi.get("count", 39))),),
                ), copy_return=False)
        self.scheduler.pump()

    def _op_createPods(self, op: dict) -> None:
        template = self._template(op, "podTemplate", self.pod_template)
        n = self._count(op)
        collect = bool(op.get("collectMetrics"))
        if collect and not self._collecting:
            self._start_collecting()
        namespace = op.get("namespace", "default")
        pvc_t = op.get("persistentVolumeClaimTemplate")
        pv_t = op.get("persistentVolumeTemplate")
        claims_spec = op.get("resourceClaimTemplate")
        for _ in range(n):
            i = self._pod_seq
            self._pod_seq += 1
            pod = pod_from_manifest(template, f"pod-{i}", namespace)
            if pvc_t is not None:
                self._attach_volume(pod, i, pvc_t, pv_t, namespace)
            if claims_spec is not None:
                self._attach_claim(pod, i, claims_spec, namespace)
            self.store.create(pod, copy_return=False)
        if collect:
            self.measured += n
        # steady-state scheduling after each creation op (the reference's
        # scheduler runs continuously; the barrier waits for completion)
        self._barrier(wait_all=not op.get("skipWaitToCompletion"))

    def _attach_volume(self, pod, i: int, pvc_t: dict, pv_t: dict | None,
                       namespace: str) -> None:
        """A claim for the pod (and a PV when the op has a PV template),
        as scheduler_perf's persistentVolumeClaimTemplatePath builds them."""
        claim_name = f"claim-{i}"
        sc = pvc_t.get("storageClassName", "")
        if sc and self.store.try_get("StorageClass", sc) is None:
            self.store.create(StorageClass(
                meta=ObjectMeta(name=sc, namespace=""),
                provisioner=pvc_t.get("provisioner", "kubernetes.io/no-provisioner"),
                volume_binding_mode=BINDING_WAIT_FOR_FIRST_CONSUMER,
            ))
        pv_name = f"pv-{i}"
        # bound: true is the immediate-binding shape (pvc.yaml's
        # pv.kubernetes.io/bind-completed annotation): the claim and its
        # volume arrive bound to each other
        bound = bool(pvc_t.get("bound"))
        if pv_t is not None:
            self.store.create(PersistentVolume(
                meta=ObjectMeta(name=pv_name, namespace=""),
                spec=PersistentVolumeSpec(
                    capacity=dict(pv_t.get("capacity", {"storage": "10Gi"})),
                    access_modes=tuple(pv_t.get("accessModes", ("ReadWriteOnce",))),
                    storage_class_name=sc,
                    csi_driver=pv_t.get("csiDriver", ""),
                    claim_ref=f"{namespace}/{claim_name}" if bound else "",
                ),
            ))
        pvc = PersistentVolumeClaim(
            meta=ObjectMeta(name=claim_name, namespace=namespace),
            spec=PersistentVolumeClaimSpec(
                access_modes=tuple(pvc_t.get("accessModes", ("ReadWriteOnce",))),
                storage_class_name=sc,
                request=dict(pvc_t.get("request", {"storage": "5Gi"})),
                volume_name=pv_name if bound and pv_t is not None else "",
            ),
        )
        if bound:
            pvc.status.phase = CLAIM_BOUND
        self.store.create(pvc)
        pod.spec.volumes = tuple(pod.spec.volumes) + (
            Volume(name="data", persistent_volume_claim=claim_name),)

    def _attach_claim(self, pod, i: int, claims_spec: dict, namespace: str) -> None:
        """A ResourceClaim for the pod (the resourceclaim controller makes
        these from templates; the harness creates them directly)."""
        name = f"rclaim-{i}"
        cel = claims_spec.get("celSelector", "")
        self.store.create(ResourceClaim(
            meta=ObjectMeta(name=name, namespace=namespace),
            spec=ResourceClaimSpec(requests=(
                DeviceRequest(
                    name="req",
                    device_class_name=claims_spec.get("deviceClassName", ""),
                    count=int(claims_spec.get("count", 1)),
                    selectors=(DeviceSelector(cel=cel),) if cel else (),
                ),
            )),
        ))
        pod.spec.resource_claims = (PodResourceClaim(name=name, resource_claim_name=name),)

    def _op_createResourceSlices(self, op: dict) -> None:
        """The DRA inventory: one slice per existing node (scheduler_perf's
        createResourceDriver)."""
        per_node = int(_resolve(op.get("devicesPerNode", 4), self.params))
        driver = op.get("driver", "perf.example.com")
        for node in self.store.nodes():
            self.store.create(ResourceSlice(
                meta=ObjectMeta(name=f"slice-{node.meta.name}", namespace=""),
                node_name=node.meta.name,
                driver=driver,
                devices=tuple(Device(name=f"dev-{j}", attributes={"index": str(j)})
                              for j in range(per_node)),
            ))
        self.scheduler.pump()
