"""Node agent layer: the kubemark hollow form the chaos soaks run
(HollowKubelet — fake runtime, lease heartbeat, batch sync; pkg/kubemark).
The reference's full-shaped agent (CRI runtime, PLEG, eviction manager,
pod workers) is not ported: no scheduler path runs it."""

from .hollow import FakeRuntime, HollowKubelet, start_hollow_nodes

__all__ = ["FakeRuntime", "HollowKubelet", "start_hollow_nodes"]
