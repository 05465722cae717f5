"""Dense resource vectors — the row type of the NodeInfo device planes.

Reference: pkg/scheduler/framework/types.go (Resource struct: MilliCPU, Memory,
EphemeralStorage, AllowedPodNumber, ScalarResources map). Here a resource
vector IS a fixed-width int array in plane units so the same object feeds the
host fit/score math and the [nodes, R] device tensors unchanged.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from .quantity import parse_cpu, parse_mem_mib, parse_count

# Fixed base resource indices (plane columns).
CPU = 0  # millicores
MEM = 1  # MiB
EPHEMERAL = 2  # MiB
PODS = 3  # count
NUM_BASE_RESOURCES = 4

# Defaults for pods that request nothing, used by NonZero accounting only
# (reference: pkg/scheduler/util/pod_resources.go:29-31 — 100 mCPU, 200 MB).
# 200 MB = 190.73 MiB -> ceil 191 MiB in plane units.
DEFAULT_MILLI_CPU = 100
DEFAULT_MEM_MIB = 191


class ResourceNames:
    """Registry mapping resource names to plane columns.

    Base resources have fixed columns; extended resources (nvidia.com/gpu,
    google.com/tpu, hugepages-*) get columns appended in registration order.
    One registry instance is shared by a cluster's cache + tensor snapshots so
    every NodeInfo row has the same width.
    """

    BASE = ("cpu", "memory", "ephemeral-storage", "pods")

    def __init__(self) -> None:
        self._index: dict[str, int] = {n: i for i, n in enumerate(self.BASE)}
        self._names: list[str] = list(self.BASE)

    def index_of(self, name: str) -> int:
        i = self._index.get(name)
        if i is None:
            i = len(self._names)
            self._index[name] = i
            self._names.append(name)
        return i

    def get(self, name: str) -> int | None:
        return self._index.get(name)

    @property
    def width(self) -> int:
        return len(self._names)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    def parse(self, name: str, value, *, floor: bool = False) -> int:
        """Parse a quantity for resource `name` into its plane unit."""
        if name == "cpu":
            if floor:
                # capacities: floor at milli granularity
                from .quantity import parse_quantity

                v = parse_quantity(value) * 1000
                return v.numerator // v.denominator
            return parse_cpu(value)
        if name in ("memory", "ephemeral-storage") or name.startswith("hugepages-"):
            return parse_mem_mib(value, floor=floor)
        return parse_count(value, floor=floor)


class ResourceVec:
    """A mutable fixed-width int vector of plane-unit resource amounts."""

    __slots__ = ("v",)

    def __init__(self, width: int = NUM_BASE_RESOURCES, values: Iterable[int] | None = None):
        if values is not None:
            self.v = list(values)
            if len(self.v) < width:
                self.v.extend([0] * (width - len(self.v)))
        else:
            self.v = [0] * width

    @classmethod
    def from_map(
        cls, m: Mapping[str, object], names: ResourceNames, *, floor: bool = False
    ) -> "ResourceVec":
        r = cls(names.width)
        for k, q in m.items():
            i = names.index_of(k)
            if i >= len(r.v):
                r.v.extend([0] * (i + 1 - len(r.v)))
            r.v[i] = names.parse(k, q, floor=floor)
        return r

    def widen(self, width: int) -> None:
        if width > len(self.v):
            self.v.extend([0] * (width - len(self.v)))

    def add(self, other: "ResourceVec") -> None:
        self.widen(len(other.v))
        for i, x in enumerate(other.v):
            self.v[i] += x

    def sub(self, other: "ResourceVec") -> None:
        self.widen(len(other.v))
        for i, x in enumerate(other.v):
            self.v[i] -= x

    def max_with(self, other: "ResourceVec") -> None:
        """Elementwise max — container-limits semantics for pod requests."""
        self.widen(len(other.v))
        for i, x in enumerate(other.v):
            if x > self.v[i]:
                self.v[i] = x

    def clone(self) -> "ResourceVec":
        return ResourceVec(len(self.v), self.v)

    def row(self, width: int) -> list[int]:
        """Fixed-width row for tensor materialization."""
        if len(self.v) >= width:
            return self.v[:width]
        return self.v + [0] * (width - len(self.v))

    def __getitem__(self, i: int) -> int:
        return self.v[i] if i < len(self.v) else 0

    def __setitem__(self, i: int, val: int) -> None:
        self.widen(i + 1)
        self.v[i] = val

    def __eq__(self, other) -> bool:
        if not isinstance(other, ResourceVec):
            return NotImplemented
        n = max(len(self.v), len(other.v))
        return all(self[i] == other[i] for i in range(n))

    def __repr__(self) -> str:
        return f"ResourceVec({self.v})"


def pod_request_vec(pod, names: ResourceNames) -> ResourceVec:
    """Effective pod resource request in plane units.

    Reference: computePodResourceRequest (pkg/scheduler/framework/plugins/
    noderesources/fit.go:317) — sum of container requests, elementwise-max with
    each init container, plus overhead. The +1 pod slot is accounted by the
    caller via the PODS column.
    """
    req = ResourceVec(names.width)
    for c in pod.spec.containers:
        req.add(ResourceVec.from_map(c.requests, names))
    for c in pod.spec.init_containers:
        req.max_with(ResourceVec.from_map(c.requests, names))
    if pod.spec.overhead:
        req.add(ResourceVec.from_map(pod.spec.overhead, names))
    req[PODS] = 1
    return req


def nonzero_request_vec(req: ResourceVec) -> ResourceVec:
    """Request with zero cpu/mem replaced by defaults.

    Reference: pkg/scheduler/util/pod_resources.go GetNonzeroRequests — used by
    scoring so empty pods still register load.
    """
    nz = req.clone()
    if nz[CPU] == 0:
        nz[CPU] = DEFAULT_MILLI_CPU
    if nz[MEM] == 0:
        nz[MEM] = DEFAULT_MEM_MIB
    return nz
