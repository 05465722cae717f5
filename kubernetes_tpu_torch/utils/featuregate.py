"""Feature-gate registry with versioned specs.

Reference: staging/src/k8s.io/component-base/featuregate/feature_gate.go
(versioned specs, emulation-version aware :353) and the scheduler-relevant
catalog in pkg/features/kube_features.go (GenericWorkload:348,
OpportunisticBatching:671, TopologyAwareWorkloadScheduling:1062,
SchedulerAsyncAPICalls:899, SchedulerQueueingHints:920,
DynamicResourceAllocation:302, NodeDeclaredFeatures:635).

A copy of the reference package's module
(kubernetes_tpu/utils/featuregate.py) with its catalog unchanged, so one
configuration document enables the same gates in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

ALPHA = "ALPHA"
BETA = "BETA"
GA = "GA"


@dataclass(frozen=True)
class FeatureSpec:
    default: bool
    pre_release: str = ALPHA
    locked_to_default: bool = False


# The catalog: our framework's gates, defaults mirroring the reference's
# maturity levels for the same features.
KNOWN_FEATURES: dict[str, FeatureSpec] = {
    # gang scheduling (GenericWorkload + PodGroup API, alpha fork feature —
    # on by default here because the TPU framework's north star is gangs)
    "GangScheduling": FeatureSpec(default=True, pre_release=BETA),
    "TopologyAwareWorkloadScheduling": FeatureSpec(default=True, pre_release=ALPHA),
    # KEP-5598 batch reuse (alpha -> default off)
    "OpportunisticBatching": FeatureSpec(default=False, pre_release=ALPHA),
    "SchedulerAsyncAPICalls": FeatureSpec(default=False, pre_release=BETA),
    "SchedulerQueueingHints": FeatureSpec(default=True, pre_release=BETA),
    "DynamicResourceAllocation": FeatureSpec(default=True, pre_release=GA),
    "NodeDeclaredFeatures": FeatureSpec(default=True, pre_release=ALPHA),
    "DefaultPreemption": FeatureSpec(default=True, pre_release=GA,
                                     locked_to_default=False),
    # TPU-native additions
    "TPUBackend": FeatureSpec(default=True, pre_release=BETA),
}


class FeatureGate:
    """Mutable view over the catalog (featuregate.MutableFeatureGate)."""

    def __init__(self, known: dict[str, FeatureSpec] | None = None):
        self.known = dict(known or KNOWN_FEATURES)
        self.overrides: dict[str, bool] = {}

    def enabled(self, name: str) -> bool:
        if name in self.overrides:
            return self.overrides[name]
        spec = self.known.get(name)
        if spec is None:
            raise KeyError(f"unknown feature gate {name!r}")
        return spec.default

    def set_from_map(self, m: dict[str, bool]) -> None:
        for name, value in m.items():
            spec = self.known.get(name)
            if spec is None:
                raise KeyError(f"unknown feature gate {name!r}")
            if spec.locked_to_default and value != spec.default:
                raise ValueError(f"cannot set locked feature gate {name}")
            self.overrides[name] = bool(value)

    def as_map(self) -> dict[str, bool]:
        return {name: self.enabled(name) for name in self.known}
