"""HTTP extender: legacy out-of-process filter/prioritize/bind webhook.

Reference: pkg/scheduler/extender.go (NewHTTPExtender:88, Filter:249,
Prioritize:320, Bind:362) with wire types from
staging/src/k8s.io/kube-scheduler/extender/v1/types.go (ExtenderArgs:73,
ExtenderFilterResult:88, HostPriorityList:132, MaxExtenderPriority=10:29).

The extender is the architectural precedent for out-of-process scheduling
backends: the TPU sidecar design (SURVEY.md §5.8) mirrors this hook with
device-resident tensors instead of HTTP round-trips. Kept here for API parity
and for composing third-party scorers with the kernel path.

A copy of the reference package's module
(kubernetes_tpu/scheduler/extender.py).
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.request
from dataclasses import dataclass

from ..api.types import Pod
from .framework.interface import MAX_NODE_SCORE, Status
from .nodeinfo import NodeInfo

MAX_EXTENDER_PRIORITY = 10  # extender/v1/types.go:29

# every way a webhook round-trip can fail: transport, protocol, malformed
# JSON (ValueError covers JSONDecodeError), or missing response keys
EXTENDER_ERRORS = (
    urllib.error.URLError,
    http.client.HTTPException,
    OSError,
    RuntimeError,
    ValueError,
    KeyError,
    TypeError,
)


@dataclass
class ExtenderConfig:
    """apis/config KubeSchedulerConfiguration.extenders entry."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    ignorable: bool = False  # errors don't fail scheduling
    node_cache_capable: bool = False  # send node names, not full nodes
    managed_resources: tuple[str, ...] = ()  # empty -> interested in all pods
    http_timeout: float = 5.0


def _pod_to_wire(pod: Pod) -> dict:
    return {
        "metadata": {
            "name": pod.meta.name,
            "namespace": pod.meta.namespace,
            "uid": pod.meta.uid,
            "labels": dict(pod.meta.labels),
        },
        "spec": {
            "containers": [
                {"name": c.name, "requests": {k: str(v) for k, v in c.requests.items()}}
                for c in pod.spec.containers
            ],
            "priority": pod.spec.priority,
        },
    }


def _node_to_wire(ni: NodeInfo) -> dict:
    node = ni.node
    return {
        "metadata": {"name": node.meta.name, "labels": dict(node.meta.labels)},
        "status": {
            "allocatable": {k: str(v) for k, v in node.status.allocatable.items()}
        },
    }


class HTTPExtender:
    """One configured webhook endpoint (extender.go HTTPExtender)."""

    def __init__(self, config: ExtenderConfig):
        self.config = config

    @property
    def name(self) -> str:
        return self.config.url_prefix

    # -- capability probes (fwk.Extender interface) --------------------------

    def is_ignorable(self) -> bool:
        return self.config.ignorable

    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)

    def is_filter(self) -> bool:
        return bool(self.config.filter_verb)

    def is_prioritizer(self) -> bool:
        return bool(self.config.prioritize_verb)

    def is_interested(self, pod: Pod) -> bool:
        """extender.go IsInterested — managed-resources intersection; empty
        list means every pod."""
        if not self.config.managed_resources:
            return True
        managed = set(self.config.managed_resources)
        for c in pod.spec.containers + pod.spec.init_containers:
            if managed & (set(c.requests) | set(c.limits)):
                return True
        return False

    # -- HTTP plumbing -------------------------------------------------------

    def _post(self, verb: str, payload: dict) -> dict:
        url = f"{self.config.url_prefix.rstrip('/')}/{verb}"
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(req, timeout=self.config.http_timeout) as resp:
            return json.loads(resp.read().decode() or "{}")

    # -- verbs ---------------------------------------------------------------

    def filter(
        self, pod: Pod, nodes: list[NodeInfo]
    ) -> tuple[list[NodeInfo], dict[str, str], dict[str, str]]:
        """extender.go Filter:249 — returns (feasible, failed,
        failed_and_unresolvable); raises on transport errors."""
        by_name = {ni.name: ni for ni in nodes}
        args: dict = {"pod": _pod_to_wire(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = list(by_name)
        else:
            args["nodes"] = {"items": [_node_to_wire(ni) for ni in nodes]}
        result = self._post(self.config.filter_verb, args)
        if result.get("error"):
            raise RuntimeError(f"extender {self.name}: {result['error']}")
        if self.config.node_cache_capable and "nodenames" in result:
            keep = [n for n in result["nodenames"] if n in by_name]
        elif "nodes" in result:
            keep = [
                item["metadata"]["name"]
                for item in result["nodes"].get("items", [])
                if item["metadata"]["name"] in by_name
            ]
        else:
            keep = list(by_name)
        return (
            [by_name[n] for n in keep],
            dict(result.get("failedNodes") or {}),
            dict(result.get("failedAndUnresolvableNodes") or {}),
        )

    def prioritize(
        self, pod: Pod, nodes: list[NodeInfo]
    ) -> tuple[dict[str, int], int]:
        """extender.go Prioritize:320 — (host -> raw score 0..10, weight)."""
        args: dict = {"pod": _pod_to_wire(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = [ni.name for ni in nodes]
        else:
            args["nodes"] = {"items": [_node_to_wire(ni) for ni in nodes]}
        result = self._post(self.config.prioritize_verb, args)
        scores = {
            hp["host"]: int(hp["score"])
            for hp in (result if isinstance(result, list) else result.get("items", []))
        }
        return scores, self.config.weight

    def bind(self, pod: Pod, node_name: str) -> Status:
        """extender.go Bind:362 — delegate the binding API call."""
        try:
            result = self._post(
                self.config.bind_verb,
                {
                    "podName": pod.meta.name,
                    "podNamespace": pod.meta.namespace,
                    "podUID": pod.meta.uid,
                    "node": node_name,
                },
            )
        except EXTENDER_ERRORS as e:
            return Status.as_error(RuntimeError(f"extender bind failed: {e}"))
        if result.get("error"):
            return Status.as_error(RuntimeError(result["error"]))
        return Status()


def find_nodes_that_pass_extenders(
    extenders: list[HTTPExtender],
    pod: Pod,
    feasible: list[NodeInfo],
    diagnosis,
) -> list[NodeInfo]:
    """schedule_one.go findNodesThatPassExtenders:890 — sequential fan-in;
    ignorable extenders' transport errors are skipped, others propagate."""
    for ext in extenders:
        if not feasible:
            break
        if not ext.is_filter() or not ext.is_interested(pod):
            continue
        try:
            feasible, failed, failed_unresolvable = ext.filter(pod, feasible)
        except EXTENDER_ERRORS as e:
            if ext.is_ignorable():
                continue
            raise RuntimeError(f"extender {ext.name} filter failed: {e}") from e
        for node_name, reason in failed_unresolvable.items():
            diagnosis.node_to_status.set(
                node_name, Status.unresolvable(reason, plugin="extender")
            )
        for node_name, reason in failed.items():
            if node_name not in failed_unresolvable:
                diagnosis.node_to_status.set(
                    node_name, Status.unschedulable(reason, plugin="extender")
                )
    return feasible


def extender_scores(
    extenders: list[HTTPExtender], pod: Pod, nodes: list[NodeInfo]
) -> dict[str, int]:
    """prioritizeNodes extender fan-out (schedule_one.go:985-1044): raw 0..10
    scores rescaled to the plugin 0..100 range and weight-combined."""
    combined: dict[str, int] = {}
    for ext in extenders:
        if not ext.is_prioritizer() or not ext.is_interested(pod):
            continue
        try:
            scores, weight = ext.prioritize(pod, nodes)
        except EXTENDER_ERRORS:
            continue  # prioritize errors are never fatal (schedule_one.go:996)
        factor = MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY  # :1019 rescale
        for host, score in scores.items():
            combined[host] = combined.get(host, 0) + score * weight * factor
    return combined
