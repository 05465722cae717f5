"""Dynamic Resource Allocation (DRA) API types: ResourceClaim, ResourceSlice,
DeviceClass.

Reference: staging/src/k8s.io/api/resource/v1/types.go (ResourceClaim,
ResourceSlice, DeviceClass with structured parameters) — the device-claim
model behind pkg/scheduler/framework/plugins/dynamicresources/.

Device selectors come in two equivalent forms: typed attribute requirements
(kernel-friendly, the fast path) and CEL expressions over the `device`
variable (the reference's API shape, resource/v1 DeviceSelector.CEL —
evaluated by utils/cel.py's subset compiler).

A copy of the reference package's module
(kubernetes_tpu/api/dra.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from .meta import ObjectMeta


@dataclass(frozen=True)
class DeviceSelector:
    """One predicate on a device: either a typed attribute requirement
    (key/operator/values — In, NotIn, Exists, DoesNotExist, Gt, Lt) or a
    CEL expression (resource/v1 DeviceSelector.CEL.Expression) evaluated
    against the whole device context."""

    key: str = ""
    operator: str = "Exists"
    values: tuple[str, ...] = ()
    cel: str = ""  # when set, the expression IS the predicate

    def matches(self, attributes: Mapping[str, object], *,
                capacity: Mapping[str, object] | None = None,
                driver: str = "", name: str = "") -> bool:
        if self.cel:
            from ..utils.cel import evaluate_device

            return evaluate_device(self.cel, driver=driver, name=name,
                                   attributes=attributes, capacity=capacity)
        present = self.key in attributes
        val = attributes.get(self.key)
        if self.operator == "Exists":
            return present
        if self.operator == "DoesNotExist":
            return not present
        if self.operator == "In":
            return present and str(val) in self.values
        if self.operator == "NotIn":
            return not present or str(val) not in self.values
        if self.operator in ("Gt", "Lt"):
            if not present or not self.values:
                return False
            try:
                lhs, rhs = int(str(val)), int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if self.operator == "Gt" else lhs < rhs
        return False


# taint effects shared with node taints (api/types.py is the source)
from .types import NO_EXECUTE, NO_SCHEDULE  # noqa: E402,F401


@dataclass(frozen=True)
class DeviceTaint:
    """A taint on one device (KEP-5055 device taints,
    resource/v1 DeviceTaint + pkg/controller/devicetainteviction):
    NoSchedule keeps new allocations off the device; NoExecute
    additionally evicts pods whose claims hold it."""

    key: str
    value: str = ""
    effect: str = NO_SCHEDULE  # NoSchedule | NoExecute


@dataclass(frozen=True)
class DeviceToleration:
    """resource/v1 DeviceToleration: lets a claim's request accept
    matching device taints (Exists ignores the value; Equal compares)."""

    key: str = ""  # "" + Exists tolerates everything
    operator: str = "Exists"  # Exists | Equal
    value: str = ""
    effect: str = ""  # "" matches every effect

    def tolerates(self, taint: DeviceTaint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            return self.operator == "Exists"
        if self.key != taint.key:
            return False
        return self.operator == "Exists" or self.value == taint.value


def untolerated_taints(taints, tolerations,
                       effects=(NO_SCHEDULE, NO_EXECUTE)):
    """The device taints (of the given effects) no toleration covers —
    non-empty blocks allocation (and NoExecute evicts)."""
    return [
        t for t in taints
        if t.effect in effects
        and not any(tol.tolerates(t) for tol in tolerations)
    ]


@dataclass(frozen=True)
class Device:
    """One allocatable device in a ResourceSlice (resource/v1 BasicDevice).

    consumes_counters makes the device a PARTITION of a physical device
    (KEP-4815 partitionable devices): counter-set name → {counter →
    amount} drawn from the slice's shared_counters; partitions of one
    physical device can only be allocated while the shared budget holds."""

    name: str
    attributes: Mapping[str, object] = field(default_factory=dict)
    capacity: Mapping[str, int] = field(default_factory=dict)
    consumes_counters: Mapping[str, Mapping[str, int]] = field(
        default_factory=dict
    )
    taints: tuple[DeviceTaint, ...] = ()


@dataclass
class ResourceSlice:
    """Per-(node, driver, pool) device inventory published by a DRA driver
    (resource/v1 ResourceSlice). node_name == "" means network-attached
    devices available to every node (all_nodes). shared_counters:
    counter-set name → {counter → capacity} budgeting the slice's
    partitionable devices (KEP-4815 CounterSet)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    node_name: str = ""
    driver: str = ""
    pool: str = "default"
    devices: tuple[Device, ...] = ()
    all_nodes: bool = False
    shared_counters: Mapping[str, Mapping[str, int]] = field(
        default_factory=dict
    )

    kind = "ResourceSlice"


@dataclass
class DeviceClass:
    """Admin-defined device category (resource/v1 DeviceClass): a driver
    plus common selectors every claim of this class inherits."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    driver: str = ""
    selectors: tuple[DeviceSelector, ...] = ()

    kind = "DeviceClass"


@dataclass(frozen=True)
class DeviceSubRequest:
    """One alternative inside a prioritized-list request (resource/v1
    DeviceSubRequest, KEP-4816)."""

    name: str
    device_class_name: str = ""
    selectors: tuple[DeviceSelector, ...] = ()
    count: int = 1
    tolerations: tuple[DeviceToleration, ...] = ()


@dataclass(frozen=True)
class DeviceRequest:
    """One device request inside a claim (resource/v1 DeviceRequest).

    Either the flat fields describe exactly one shape, or
    `first_available` lists alternatives tried IN ORDER — the first
    satisfiable subrequest wins (the prioritized-list feature: "give me an
    H100, else any GPU"). When `first_available` is set the flat fields
    are ignored (the reference's oneOf exactly/firstAvailable)."""

    name: str
    device_class_name: str = ""
    selectors: tuple[DeviceSelector, ...] = ()
    count: int = 1
    first_available: tuple["DeviceSubRequest", ...] = ()
    tolerations: tuple[DeviceToleration, ...] = ()


@dataclass
class ResourceClaimSpec:
    requests: tuple[DeviceRequest, ...] = ()


@dataclass(frozen=True)
class DeviceAllocationResult:
    """One allocated device (resource/v1 DeviceRequestAllocationResult)."""

    request: str
    driver: str
    pool: str
    device: str


@dataclass
class AllocationResult:
    devices: tuple[DeviceAllocationResult, ...] = ()
    node_name: str = ""  # node the allocation is bound to ("" = any node)


@dataclass
class ResourceClaimStatus:
    allocation: AllocationResult | None = None
    reserved_for: tuple[str, ...] = ()  # pod keys (resource/v1 max 256)


@dataclass
class ResourceClaim:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceClaimSpec = field(default_factory=ResourceClaimSpec)
    status: ResourceClaimStatus = field(default_factory=ResourceClaimStatus)

    kind = "ResourceClaim"

    @property
    def is_allocated(self) -> bool:
        return self.status.allocation is not None


@dataclass(frozen=True)
class PodResourceClaim:
    """pod.spec.resourceClaims entry: a pod-local name mapping to a
    ResourceClaim object in the pod's namespace."""

    name: str
    resource_claim_name: str


RESERVED_FOR_MAX = 256  # resource/v1 ResourceClaimReservedForMaxSize


def pod_resource_claim_keys(pod) -> list[str]:
    """Store keys of all ResourceClaims the pod references."""
    return [
        f"{pod.meta.namespace}/{rc.resource_claim_name}"
        for rc in pod.spec.resource_claims
    ]
