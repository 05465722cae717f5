"""Node agent layer: the kubemark hollow form the chaos soaks and the
bootstrapped cluster run (HollowKubelet — fake runtime, lease heartbeat,
batch sync, a threaded sync loop; pkg/kubemark). The reference's
full-shaped agent (CRI runtime, PLEG, eviction manager, pod workers) is
not ported yet (ROADMAP A16)."""

from .hollow import FakeRuntime, HollowKubelet, start_hollow_nodes

__all__ = ["FakeRuntime", "HollowKubelet", "start_hollow_nodes"]
