"""NodeInfo / PodInfo — the per-node aggregates every filter/score consumes.

Reference: pkg/scheduler/framework/types.go (NodeInfo :165-208 with Requested,
NonZeroRequested, Allocatable, UsedPorts, PodsWithAffinity, ImageStates,
Generation; PodInfo with precomputed RequiredAffinityTerms). These are the rows
of the device planes: a NodeInfo's vectors are already in plane units.
"""

from __future__ import annotations

import itertools
from typing import Iterable

from ..api.labels import LabelSelector
from ..api.resource import (
    ResourceNames,
    ResourceVec,
    nonzero_request_vec,
    pod_request_vec,
)
from ..api.storage import pod_claim_names
from ..api.types import Node, Pod, PodAffinityTerm

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


class AffinityTerm:
    """A PodAffinityTerm with its namespace set resolved.

    Reference: framework/types.go AffinityTerm + GetAffinityTerms.
    """

    __slots__ = ("selector", "topology_key", "namespaces")

    def __init__(self, term: PodAffinityTerm, pod_namespace: str):
        self.selector: LabelSelector | None = term.label_selector
        self.topology_key = term.topology_key
        self.namespaces = frozenset(term.namespaces) if term.namespaces else frozenset(
            (pod_namespace,)
        )

    def matches(self, pod: Pod) -> bool:
        if pod.meta.namespace not in self.namespaces:
            return False
        return self.selector is not None and self.selector.matches(pod.meta.labels)


class PodInfo:
    """Pod plus precomputed scheduling-relevant derivations (one-time cost)."""

    __slots__ = (
        "pod",
        "request",
        "nonzero_request",
        "ports",
        "pvc_keys",
        "required_affinity_terms",
        "required_anti_affinity_terms",
        "preferred_affinity_terms",
        "preferred_anti_affinity_terms",
    )

    def __init__(self, pod: Pod, names: ResourceNames):
        self.pod = pod
        self.request = pod_request_vec(pod, names)
        self.nonzero_request = nonzero_request_vec(self.request)
        self.ports: list[tuple[str, str, int]] = []
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port > 0:
                    self.ports.append((p.host_ip or "0.0.0.0", p.protocol, p.host_port))
        self.pvc_keys = [
            f"{pod.meta.namespace}/{name}" for name in pod_claim_names(pod)
        ]
        aff = pod.spec.affinity
        ns = pod.meta.namespace
        self.required_affinity_terms = (
            [AffinityTerm(t, ns) for t in aff.pod_affinity.required]
            if aff and aff.pod_affinity
            else []
        )
        self.required_anti_affinity_terms = (
            [AffinityTerm(t, ns) for t in aff.pod_anti_affinity.required]
            if aff and aff.pod_anti_affinity
            else []
        )
        self.preferred_affinity_terms = (
            [(w.weight, AffinityTerm(w.term, ns)) for w in aff.pod_affinity.preferred]
            if aff and aff.pod_affinity
            else []
        )
        self.preferred_anti_affinity_terms = (
            [(w.weight, AffinityTerm(w.term, ns)) for w in aff.pod_anti_affinity.preferred]
            if aff and aff.pod_anti_affinity
            else []
        )

    @property
    def key(self) -> str:
        return self.pod.meta.key

    @property
    def has_affinity_constraints(self) -> bool:
        return bool(self.required_affinity_terms or self.preferred_affinity_terms or
                    self.required_anti_affinity_terms or self.preferred_anti_affinity_terms)

    @property
    def has_required_anti_affinity(self) -> bool:
        return bool(self.required_anti_affinity_terms)


class NodeInfo:
    """Aggregated node state; all vectors in plane units."""

    __slots__ = (
        "node",
        "pods",
        "pods_with_affinity",
        "pods_with_required_anti_affinity",
        "requested",
        "nonzero_requested",
        "allocatable",
        "used_ports",
        "image_sizes",
        "pvc_ref_counts",
        "generation",
        "names",
    )

    def __init__(self, names: ResourceNames, node: Node | None = None):
        self.names = names
        self.node: Node | None = None
        self.pods: dict[str, PodInfo] = {}
        self.pods_with_affinity: list[PodInfo] = []
        self.pods_with_required_anti_affinity: list[PodInfo] = []
        self.requested = ResourceVec(names.width)
        self.nonzero_requested = ResourceVec(names.width)
        self.allocatable = ResourceVec(names.width)
        self.used_ports: dict[tuple[str, str, int], int] = {}
        self.image_sizes: dict[str, int] = {}
        self.pvc_ref_counts: dict[str, int] = {}
        self.generation = 0
        if node is not None:
            self.set_node(node)

    # -- node --------------------------------------------------------------

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = ResourceVec.from_map(
            node.status.allocatable, self.names, floor=True
        )
        self.image_sizes = {
            name: img.size_bytes for img in node.status.images for name in img.names
        }
        self.generation = next_generation()

    @property
    def name(self) -> str:
        return self.node.meta.name if self.node else ""

    # -- pods --------------------------------------------------------------

    def add_pod(self, pi: PodInfo) -> None:
        self.pods[pi.key] = pi
        self.requested.add(pi.request)
        self.nonzero_requested.add(pi.nonzero_request)
        for port in pi.ports:
            self.used_ports[port] = self.used_ports.get(port, 0) + 1
        for k in pi.pvc_keys:
            self.pvc_ref_counts[k] = self.pvc_ref_counts.get(k, 0) + 1
        if pi.has_affinity_constraints:
            self.pods_with_affinity.append(pi)
        if pi.has_required_anti_affinity:
            self.pods_with_required_anti_affinity.append(pi)
        self.generation = next_generation()

    def remove_pod(self, key: str) -> PodInfo | None:
        pi = self.pods.pop(key, None)
        if pi is None:
            return None
        self.requested.sub(pi.request)
        self.nonzero_requested.sub(pi.nonzero_request)
        for port in pi.ports:
            n = self.used_ports.get(port, 0) - 1
            if n <= 0:
                self.used_ports.pop(port, None)
            else:
                self.used_ports[port] = n
        for k in pi.pvc_keys:
            n = self.pvc_ref_counts.get(k, 0) - 1
            if n <= 0:
                self.pvc_ref_counts.pop(k, None)
            else:
                self.pvc_ref_counts[k] = n
        self.pods_with_affinity = [p for p in self.pods_with_affinity if p.key != key]
        self.pods_with_required_anti_affinity = [
            p for p in self.pods_with_required_anti_affinity if p.key != key
        ]
        self.generation = next_generation()
        return pi

    def clone(self) -> "NodeInfo":
        ni = NodeInfo(self.names)
        ni.node = self.node
        ni.pods = dict(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        ni.requested = self.requested.clone()
        ni.nonzero_requested = self.nonzero_requested.clone()
        ni.allocatable = self.allocatable.clone()
        ni.used_ports = dict(self.used_ports)
        ni.image_sizes = dict(self.image_sizes)
        ni.pvc_ref_counts = dict(self.pvc_ref_counts)
        ni.generation = self.generation
        return ni

    def iter_pods(self) -> Iterable[PodInfo]:
        return self.pods.values()

    def __repr__(self) -> str:
        return f"NodeInfo({self.name}, pods={len(self.pods)}, gen={self.generation})"
