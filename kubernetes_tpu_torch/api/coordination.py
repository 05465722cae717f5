"""Coordination API: Lease.

Reference: staging/src/k8s.io/api/coordination/v1/types.go — the object
behind leader election and node heartbeats. A copy of the reference
package's module (kubernetes_tpu/api/coordination.py); the store keeps
Leases like any other kind.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0

    def deadline(self) -> float:
        """The instant the current term expires: the holder must land a
        renew before this or any candidate may take the lease over."""
        return self.renew_time + self.lease_duration_seconds

    def expired(self, now: float) -> bool:
        """Past the holder's renewal deadline — takeover is legal."""
        return now > self.deadline()


def shard_lease_name(base: str, shard: int) -> str:
    """Per-shard coordination Lease name for the active-active scheduler
    fleet (scheduler/fleet.py): shard ownership is one Lease per shard,
    named off the configured resource name."""
    return f"{base}-shard-{shard}"


@dataclass
class Lease:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LeaseSpec = field(default_factory=LeaseSpec)

    kind = "Lease"
