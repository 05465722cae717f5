"""Fixture builders, modeled on pkg/scheduler/testing/wrappers.go, plus the
scheduler_perf SchedulingBasic and TopologySpreading clusters
(test/integration/scheduler_perf misc/performance-config.yaml
SchedulingBasic, topology_spreading/performance-config.yaml,
templates/pod-default.yaml)."""

from __future__ import annotations

from ..api.dra import (
    Device,
    DeviceRequest,
    PodResourceClaim,
    ResourceClaim,
    ResourceClaimSpec,
    ResourceSlice,
)
from ..api.labels import LabelSelector
from ..api.meta import ObjectMeta
from ..api.storage import (
    BINDING_IMMEDIATE,
    BINDING_WAIT_FOR_FIRST_CONSUMER,
    CLAIM_BOUND,
    CLAIM_PENDING,
    NO_PROVISIONER,
    READ_WRITE_ONCE,
    CSINode,
    CSINodeDriver,
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    PersistentVolumeClaimStatus,
    PersistentVolumeSpec,
    StorageClass,
    Volume,
)
from ..api.types import (
    Affinity,
    Container,
    ContainerPort,
    Node,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    SchedulingGroup,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"


def make_pod(name: str, namespace: str = "default", cpu: str | None = None,
             mem: str | None = None, labels: dict | None = None,
             node_name: str = "", image: str = "",
             host_ports: tuple[int, ...] = (), priority: int = 0,
             requests: dict | None = None) -> Pod:
    req: dict = {}
    if cpu is not None:
        req["cpu"] = cpu
    if mem is not None:
        req["memory"] = mem
    if requests:
        req.update(requests)
    c = Container(
        name="c", image=image, requests=req,
        ports=tuple(ContainerPort(container_port=p, host_port=p) for p in host_ports),
    )
    return Pod(
        meta=ObjectMeta(name=name, namespace=namespace, labels=dict(labels or {})),
        spec=PodSpec(containers=[c], node_name=node_name, priority=priority),
    )


def make_node(name: str, cpu: str = "32", mem: str = "64Gi", pods: int = 110,
              labels: dict | None = None, taints: tuple[Taint, ...] = (),
              unschedulable: bool = False, zone: str | None = None,
              declared_features: tuple[str, ...] = ()) -> Node:
    lab = dict(labels or {})
    lab.setdefault(HOSTNAME_LABEL, name)
    if zone is not None:
        lab[ZONE_LABEL] = zone
    alloc = {"cpu": cpu, "memory": mem, "pods": pods, "ephemeral-storage": "100Gi"}
    return Node(
        meta=ObjectMeta(name=name, namespace="", labels=lab),
        spec=NodeSpec(unschedulable=unschedulable, taints=taints),
        status=NodeStatus(capacity=dict(alloc), allocatable=dict(alloc),
                          declared_features=tuple(declared_features)),
    )


def with_tolerations(pod: Pod, *tols: Toleration) -> Pod:
    pod.spec.tolerations = tuple(pod.spec.tolerations) + tols
    return pod


def with_spread(pod: Pod, max_skew: int = 1, key: str = ZONE_LABEL,
                when: str = "DoNotSchedule",
                selector: LabelSelector | None = None) -> Pod:
    if selector is None:
        selector = LabelSelector.of(dict(pod.meta.labels))
    pod.spec.topology_spread_constraints = tuple(
        pod.spec.topology_spread_constraints) + (
        TopologySpreadConstraint(max_skew, key, when, selector),)
    return pod


def with_pod_affinity(pod: Pod, key: str, value: str, topology_key: str,
                      anti: bool = False) -> Pod:
    """One required (anti-)affinity term to pods labelled key=value."""
    term = PodAffinityTerm(
        label_selector=LabelSelector.of({key: value}), topology_key=topology_key
    )
    aff = pod.spec.affinity or Affinity()
    if anti:
        pa = aff.pod_anti_affinity or PodAntiAffinity()
        pod.spec.affinity = Affinity(
            node_affinity=aff.node_affinity,
            pod_affinity=aff.pod_affinity,
            pod_anti_affinity=PodAntiAffinity(required=tuple(pa.required) + (term,),
                                              preferred=pa.preferred),
        )
    else:
        pa = aff.pod_affinity or PodAffinity()
        pod.spec.affinity = Affinity(
            node_affinity=aff.node_affinity,
            pod_affinity=PodAffinity(required=tuple(pa.required) + (term,),
                                     preferred=pa.preferred),
            pod_anti_affinity=aff.pod_anti_affinity,
        )
    return pod


def with_gang(pod: Pod, group_name: str) -> Pod:
    pod.spec.scheduling_group = SchedulingGroup(pod_group_name=group_name)
    return pod


# --- storage fixtures -------------------------------------------------------


def with_pvc(pod: Pod, claim_name: str, volume_name: str | None = None) -> Pod:
    pod.spec.volumes = tuple(pod.spec.volumes) + (
        Volume(name=volume_name or claim_name, persistent_volume_claim=claim_name),)
    return pod


def make_pv(name: str, storage: str = "10Gi", storage_class: str = "",
            access_modes: tuple[str, ...] = (READ_WRITE_ONCE,),
            node_names: tuple[str, ...] = (), zone: str | None = None,
            csi_driver: str = "") -> PersistentVolume:
    """A PersistentVolume; node_names pins it by node affinity on the
    hostname label (the local-volume pattern), zone adds the zone label."""
    labels = {} if zone is None else {ZONE_LABEL: zone}
    affinity = None
    if node_names:
        affinity = NodeSelector(terms=(NodeSelectorTerm(match_expressions=(
            NodeSelectorRequirement(HOSTNAME_LABEL, "In", tuple(node_names)),)),))
    return PersistentVolume(
        meta=ObjectMeta(name=name, namespace="", labels=labels),
        spec=PersistentVolumeSpec(capacity={"storage": storage}, access_modes=access_modes,
                                  storage_class_name=storage_class, node_affinity=affinity,
                                  csi_driver=csi_driver))


def make_pvc(name: str, namespace: str = "default", storage: str = "5Gi",
             storage_class: str = "", access_modes: tuple[str, ...] = (READ_WRITE_ONCE,),
             volume_name: str = "", bound: bool = False) -> PersistentVolumeClaim:
    assert not bound or volume_name, "bound=True requires volume_name"
    return PersistentVolumeClaim(
        meta=ObjectMeta(name=name, namespace=namespace),
        spec=PersistentVolumeClaimSpec(access_modes=access_modes,
                                       storage_class_name=storage_class,
                                       volume_name=volume_name,
                                       request={"storage": storage}),
        status=PersistentVolumeClaimStatus(phase=CLAIM_BOUND if bound else CLAIM_PENDING))


def make_storage_class(name: str, provisioner: str = NO_PROVISIONER,
                       wait_for_first_consumer: bool = True) -> StorageClass:
    return StorageClass(
        meta=ObjectMeta(name=name, namespace=""), provisioner=provisioner,
        volume_binding_mode=(BINDING_WAIT_FOR_FIRST_CONSUMER if wait_for_first_consumer
                             else BINDING_IMMEDIATE))


def make_csi_node(node_name: str, **driver_limits: int) -> CSINode:
    """A CSINode; each keyword is a driver with its attach limit, "__" in
    the name standing for "." (ebs__csi__example__com=39)."""
    return CSINode(
        meta=ObjectMeta(name=node_name, namespace=""),
        drivers=tuple(CSINodeDriver(name=d.replace("__", "."), allocatable_count=n)
                      for d, n in driver_limits.items()))


# --- DRA fixtures -------------------------------------------------------------


def make_slice(node: str, driver: str = "tpu.example.com", n_devices: int = 4,
               pool: str = "p0", **attrs) -> ResourceSlice:
    """One ResourceSlice of n_devices devices dev-<i> on `node`, each with
    the attribute index=<i> and `attrs`."""
    return ResourceSlice(
        meta=ObjectMeta(name=f"slice-{node}-{pool}", namespace=""),
        node_name=node, driver=driver, pool=pool,
        devices=tuple(Device(name=f"dev-{i}", attributes={"index": str(i), **attrs})
                      for i in range(n_devices)))


def make_claim(name: str, requests=None, namespace: str = "default") -> ResourceClaim:
    """A ResourceClaim of `requests` (default: one device of any class)."""
    return ResourceClaim(
        meta=ObjectMeta(name=name, namespace=namespace),
        spec=ResourceClaimSpec(requests=tuple(requests or (DeviceRequest(name="gpu", count=1),))))


def claim_pod(pod: Pod, *claim_names: str) -> Pod:
    """The pod references each named ResourceClaim."""
    pod.spec.resource_claims = tuple(PodResourceClaim(name=c, resource_claim_name=c)
                                     for c in claim_names)
    return pod


# --- scheduler_perf SchedulingBasic ----------------------------------------

def scheduling_basic_node(i: int, zones: int = 8) -> Node:
    """createNodes with the default node template: 32 CPU, 64Gi, 110 pods,
    `topology.kubernetes.io/zone` round-robin over `zones`."""
    return make_node(f"node-{i}", zone=f"zone-{i % zones}")


def scheduling_basic_pod(i: int, namespace: str = "default") -> Pod:
    """templates/pod-default.yaml: one pause container, 100m CPU and 50Mi,
    labelled app: perf."""
    return Pod(
        meta=ObjectMeta(name=f"pod-{i}", namespace=namespace,
                        labels={"app": "perf"}),
        spec=PodSpec(containers=[Container(
            name="pause", image="registry.k8s.io/pause:3.10",
            requests={"cpu": "100m", "memory": "50Mi"})]),
    )


# --- scheduler_perf TopologySpreading ----------------------------------------

def topology_spreading_pod(i: int, namespace: str = "default") -> Pod:
    """The measured pod of TopologySpreading: the pause container at 100m
    and 50Mi, labelled app: spread, with one DoNotSchedule zone constraint
    (maxSkew 1, selector app: spread)."""
    pod = Pod(
        meta=ObjectMeta(name=f"spread-{i}", namespace=namespace,
                        labels={"app": "spread"}),
        spec=PodSpec(containers=[Container(
            name="pause", requests={"cpu": "100m", "memory": "50Mi"})]),
    )
    return with_spread(pod, max_skew=1, key=ZONE_LABEL, when="DoNotSchedule",
                       selector=LabelSelector.of({"app": "spread"}))
