"""Versioned API conversion: the runtime.Scheme conversion role.

Reference: apimachinery's Scheme holds versioned external types plus
conversion functions to/from the unversioned internal ("hub") types
(runtime/scheme.go Convert; generated zz_generated.conversion.go per
group/version). Components always work on internal types; the wire carries
a specific apiVersion, converted at the codec boundary.

This module is that machinery: register an external dataclass for a
(group/version, kind) with its to/from-internal converters, then
decode_versioned/encode_versioned handle wire objects whose "apiVersion"
names a registered version. Objects without apiVersion (or with "v1") pass
through the plain codec — internal and v1-external are identical here, the
same shortcut the reference takes for groups whose storage version matches.

Registered below: scheduling.k8s.io/v1alpha2 PodGroup — the reference's
actual in-flight gang API (staging/src/k8s.io/api/scheduling/v1alpha2/
types.go:191) whose external shape (minCount at spec top level,
topologyConstraints list) differs from our internal hub types.

A copy of the reference package's module (kubernetes_tpu/api/versioning.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .meta import ObjectMeta
from .serialization import decode, encode
from .types import (
    GangPolicy,
    PodGroup,
    PodGroupSpec,
    PodGroupStatus,
    SchedulingConstraints,
    TopologyConstraint,
)


class ConversionScheme:
    def __init__(self):
        # (api_version, kind) → (external cls, to_internal, from_internal)
        self._by_version: dict[tuple[str, str],
                               tuple[type, Callable, Callable]] = {}

    def register(self, api_version: str, kind: str, external_cls: type,
                 to_internal: Callable, from_internal: Callable) -> None:
        self._by_version[(api_version, kind)] = (
            external_cls, to_internal, from_internal
        )

    def versions_for(self, kind: str) -> list[str]:
        return [v for (v, k) in self._by_version if k == kind]

    def decode_versioned(self, wire: dict):
        """Wire dict → INTERNAL object. apiVersion routes to the matching
        external type + converter; absent/"v1" uses the plain codec."""
        api_version = wire.get("apiVersion", "")
        kind = wire.get("kind", "")
        entry = self._by_version.get((api_version, kind))
        if entry is None:
            if api_version in ("", "v1"):
                return decode(wire)
            raise ValueError(f"no conversion registered for "
                             f"{api_version}/{kind}")
        external_cls, to_internal, _ = entry
        body = {k: v for k, v in wire.items() if k != "apiVersion"}
        return to_internal(decode(body, external_cls))

    def encode_versioned(self, obj, api_version: str = "") -> dict:
        """INTERNAL object → wire dict at the requested apiVersion."""
        kind = getattr(obj, "kind", "")
        entry = self._by_version.get((api_version, kind))
        if entry is None:
            if api_version in ("", "v1"):
                return encode(obj)
            raise ValueError(f"no conversion registered for "
                             f"{api_version}/{kind}")
        _, _, from_internal = entry
        out = encode(from_internal(obj))
        out["apiVersion"] = api_version
        out["kind"] = kind
        return out


# -- scheduling.k8s.io/v1alpha2 PodGroup (external shape) --------------------


@dataclass(frozen=True)
class TopologyConstraintV1alpha2:
    topologyKey: str = ""
    mode: str = "Required"


@dataclass
class PodGroupSpecV1alpha2:
    """External spec: minCount flattened to the top (the gang policy is
    implicit in v1alpha2), constraints as a bare list."""

    minCount: int = 0
    topologyConstraints: tuple[TopologyConstraintV1alpha2, ...] = ()


@dataclass
class PodGroupV1alpha2:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpecV1alpha2 = field(default_factory=PodGroupSpecV1alpha2)
    allPodsCount: int = 0
    scheduledPodsCount: int = 0

    kind = "PodGroup"


def _podgroup_to_internal(ext: PodGroupV1alpha2) -> PodGroup:
    return PodGroup(
        meta=ext.meta,
        spec=PodGroupSpec(
            policy=GangPolicy(min_count=ext.spec.minCount),
            constraints=SchedulingConstraints(topology=tuple(
                TopologyConstraint(key=t.topologyKey, mode=t.mode)
                for t in ext.spec.topologyConstraints
            )),
        ),
        status=PodGroupStatus(
            all_pods_count=ext.allPodsCount,
            scheduled_pods_count=ext.scheduledPodsCount,
        ),
    )


def _podgroup_from_internal(pg: PodGroup) -> PodGroupV1alpha2:
    return PodGroupV1alpha2(
        meta=pg.meta,
        spec=PodGroupSpecV1alpha2(
            minCount=pg.spec.policy.min_count,
            topologyConstraints=tuple(
                TopologyConstraintV1alpha2(topologyKey=t.key, mode=t.mode)
                for t in pg.spec.constraints.topology
            ),
        ),
        allPodsCount=pg.status.all_pods_count,
        scheduledPodsCount=pg.status.scheduled_pods_count,
    )


def default_scheme() -> ConversionScheme:
    scheme = ConversionScheme()
    scheme.register(
        "scheduling.k8s.io/v1alpha2", "PodGroup", PodGroupV1alpha2,
        _podgroup_to_internal, _podgroup_from_internal,
    )
    return scheme
