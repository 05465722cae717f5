"""Controllers (reference: pkg/controller/). The port has the one the
scheduler's preemption reads: the disruption controller, which keeps each
PodDisruptionBudget's status true."""

from .base import Controller  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
