"""Fixture builders, modeled on pkg/scheduler/testing/wrappers.go, plus the
scheduler_perf SchedulingBasic and TopologySpreading clusters
(test/integration/scheduler_perf misc/performance-config.yaml
SchedulingBasic, topology_spreading/performance-config.yaml,
templates/pod-default.yaml)."""

from __future__ import annotations

from ..api.labels import LabelSelector
from ..api.meta import ObjectMeta
from ..api.types import (
    Affinity,
    Container,
    ContainerPort,
    Node,
    NodeSpec,
    NodeStatus,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    SchedulingGroup,
    Taint,
    TopologySpreadConstraint,
)

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"


def make_pod(name: str, namespace: str = "default", cpu: str | None = None,
             mem: str | None = None, labels: dict | None = None,
             node_name: str = "", image: str = "",
             host_ports: tuple[int, ...] = (), priority: int = 0) -> Pod:
    req: dict = {}
    if cpu is not None:
        req["cpu"] = cpu
    if mem is not None:
        req["memory"] = mem
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
