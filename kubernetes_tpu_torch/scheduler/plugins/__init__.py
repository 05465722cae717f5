"""In-tree plugins (reference: pkg/scheduler/framework/plugins/)."""

from .basics import (  # noqa: F401
    ImageLocality,
    NodeName,
    NodePorts,
    NodeUnschedulable,
    PrioritySort,
    SchedulingGates,
    TaintToleration,
)
from .default_preemption import DefaultPreemption  # noqa: F401
from .gang_scheduling import GangScheduling  # noqa: F401
from .interpod_affinity import InterPodAffinity  # noqa: F401
from .node_affinity import NodeAffinity  # noqa: F401
from .node_declared_features import NodeDeclaredFeatures  # noqa: F401
from .node_resources import BalancedAllocation, NodeResourcesFit  # noqa: F401
from .pod_topology_spread import PodTopologySpread  # noqa: F401
from .registry import DEFAULT_WEIGHTS, default_plugins  # noqa: F401
