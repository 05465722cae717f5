"""Controllers (reference: pkg/controller/). The port has the one the
scheduler's preemption reads, the disruption controller, which keeps each
PodDisruptionBudget's status true, and the node lifecycle controller the
chaos soaks run (lease staleness -> taint and evict), and the quota
controller behind the API server's ResourceQuota admission."""

from .base import Controller  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
from .lifecycle import UNREACHABLE_TAINT, NodeLifecycleController  # noqa: F401
from .quota import QuotaController  # noqa: F401
