"""Service proxy layer: the pkg/proxy equivalent.

Watches Services and EndpointSlices and programs an in-memory dataplane
table — the analogue of the reference's iptables/ipvs/nftables rule
programming (pkg/proxy/). The dataplane here is a lookup
structure (`DataplaneTable`) instead of kernel rules: virtual-IP:port →
backend endpoints, with session affinity and traffic-policy filtering, so
tests and the hollow kubelet can resolve service VIPs the way a node's
dataplane would.

A copy of the reference package's module
(kubernetes_tpu/proxy/__init__.py).
"""

from .dataplane import DataplaneTable, Rule
from .proxier import (
    EndpointsChangeTracker,
    Proxier,
    ServiceChangeTracker,
    ServicePortName,
)

__all__ = [
    "DataplaneTable", "Rule", "Proxier",
    "ServiceChangeTracker", "EndpointsChangeTracker", "ServicePortName",
]
