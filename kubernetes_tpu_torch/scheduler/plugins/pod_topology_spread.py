"""PodTopologySpread constraint selection: the part of the plugin that the
feature extractor needs (which constraints apply to a pod).

Reference: pkg/scheduler/framework/plugins/podtopologyspread/plugin.go:46-60
(SystemDefaulting: zone + hostname ScheduleAnyway) and common.go
(default constraints take the pod's own labels as their selector).
"""

from __future__ import annotations

from ...api.labels import LabelSelector
from ...api.types import SCHEDULE_ANYWAY, Pod, TopologySpreadConstraint

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"

_SYSTEM_DEFAULT_CONSTRAINTS = (
    TopologySpreadConstraint(3, HOSTNAME_LABEL, SCHEDULE_ANYWAY, None),
    TopologySpreadConstraint(5, ZONE_LABEL, SCHEDULE_ANYWAY, None),
)


class PodTopologySpread:
    name = "PodTopologySpread"

    def __init__(self, default_constraints=None, system_defaulting: bool = True):
        self.default_constraints = tuple(default_constraints or ())
        self.system_defaulting = system_defaulting

    def _constraints_for(self, pod: Pod, action: str) -> list[TopologySpreadConstraint]:
        explicit = [
            c for c in pod.spec.topology_spread_constraints if c.when_unsatisfiable == action
        ]
        if pod.spec.topology_spread_constraints:
            return explicit
        defaults = self.default_constraints or (
            _SYSTEM_DEFAULT_CONSTRAINTS if self.system_defaulting else ()
        )
        out = []
        for c in defaults:
            if c.when_unsatisfiable != action:
                continue
            sel = c.label_selector or LabelSelector.of(dict(pod.meta.labels))
            out.append(
                TopologySpreadConstraint(c.max_skew, c.topology_key, c.when_unsatisfiable, sel)
            )
        return out
