"""In-memory dataplane: the programmed ruleset a node's proxy would install.

The reference programs kernel dataplanes (iptables chains, ipvs virtual
servers, nftables maps — pkg/proxy/iptables/proxier.go etc.);
the capability being modeled is "given a packet to VIP:port, pick a backend".
This table is that capability as a data structure: `program()` swaps in a
full ruleset atomically (the reference's iptables-restore semantics: rules
are rebuilt and applied as one transaction), `resolve()` is the DNAT hook.

Session affinity reproduces the ClientIP mode (recent-destination map with a
timeout, like the kernel's `recent` match); load balancing is round-robin
per rule (ipvs rr semantics; iptables uses random statistic match — a
deterministic rr is test-friendlier and distributionally equivalent).

A copy of the reference package's module
(kubernetes_tpu/proxy/dataplane.py).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Backend:
    """One DNAT target."""

    address: str
    port: int
    node_name: str = ""


@dataclass
class Rule:
    """All backends programmed for one (vip, port, protocol) key."""

    service: str  # namespace/name:portname — provenance for debugging
    backends: tuple[Backend, ...]
    session_affinity: bool = False
    affinity_timeout_s: int = 10800


class DataplaneTable:
    """Atomic-swap rule table with per-rule round-robin + ClientIP affinity."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._rules: dict[tuple[str, int, str], Rule] = {}
        self._rr: dict[tuple[str, int, str], int] = {}
        # (rule key, client ip) → (backend, stamp)
        self._affinity: dict[tuple, tuple[Backend, float]] = {}
        self._clock = clock
        self._last_sweep = 0.0
        self.generation = 0

    def program(self, rules: dict[tuple[str, int, str], Rule]) -> None:
        """Swap in a complete ruleset (one transaction, like
        iptables-restore). Affinity entries for vanished rules or backends
        are dropped; round-robin cursors for unchanged rules persist."""
        with self._lock:
            self._rules = dict(rules)
            self._rr = {k: self._rr.get(k, 0) for k in rules}
            now = self._clock()
            keep = {}
            for (key, client), (backend, stamp) in self._affinity.items():
                rule = rules.get(key)
                if (rule is not None and backend in rule.backends
                        and now - stamp <= rule.affinity_timeout_s):
                    keep[(key, client)] = (backend, stamp)
            self._affinity = keep
            self.generation += 1

    def rules(self) -> dict[tuple[str, int, str], Rule]:
        with self._lock:
            return dict(self._rules)

    def resolve(self, vip: str, port: int, protocol: str = "TCP",
                client_ip: str = "") -> Backend | None:
        """The DNAT decision for one connection; None = no rule / no
        backends (the reference REJECTs such packets)."""
        key = (vip, port, protocol)
        with self._lock:
            rule = self._rules.get(key)
            if rule is None or not rule.backends:
                return None
            now = self._clock()
            if now - self._last_sweep > 60.0:
                # periodic sweep: one-shot clients of a stable ruleset
                # would otherwise grow the map forever (program() reaps,
                # but the no-change sync fast path never calls it)
                self._last_sweep = now
                self._affinity = {
                    k: (b, stamp) for k, (b, stamp) in self._affinity.items()
                    if (r := self._rules.get(k[0])) is not None
                    and now - stamp <= r.affinity_timeout_s
                }
            if rule.session_affinity and client_ip:
                hit = self._affinity.get((key, client_ip))
                if hit is not None:
                    backend, stamp = hit
                    if now - stamp <= rule.affinity_timeout_s:
                        self._affinity[(key, client_ip)] = (backend, now)
                        return backend
                    # expired: reap (the kernel's `recent` match reaps on
                    # timeout; without this, one-shot clients leak entries)
                    del self._affinity[(key, client_ip)]
            i = self._rr.get(key, 0) % len(rule.backends)
            self._rr[key] = i + 1
            backend = rule.backends[i]
            if rule.session_affinity and client_ip:
                self._affinity[(key, client_ip)] = (backend, now)
            return backend
