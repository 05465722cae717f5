"""Proxier: Services + EndpointSlices → dataplane rules.

The pkg/proxy control loop re-expressed: informer events land in change
trackers (pending deltas between syncs — servicechangetracker.go:33,
endpointschangetracker.go:33), a sync pass folds pending changes into the
applied maps (ServicePortMap.Update, EndpointsMap.Update) and rebuilds the
dataplane ruleset as one transaction (the iptables-restore model of
iptables/proxier.go syncProxyRules). Endpoint selection per service port
follows topology.go CategorizeEndpoints: ready endpoints, falling back to
serving-terminating ones; internal/externalTrafficPolicy=Local narrows to
this node's endpoints.

Unlike the reference there is no kernel below — the programmed artifact is
an in-memory DataplaneTable (dataplane.py) shared with whoever wants VIP
resolution (tests, hollow kubelet).

A copy of the reference package's module
(kubernetes_tpu/proxy/proxier.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api.workloads import EndpointSlice, Service
from ..client.informer import InformerFactory
from .dataplane import Backend, DataplaneTable, Rule


@dataclass(frozen=True)
class ServicePortName:
    """Unique id of one load-balanced port (proxy/types.go:44)."""

    namespace: str
    name: str
    port: str
    protocol: str = "TCP"

    def __str__(self) -> str:
        p = f":{self.port}" if self.port else ""
        return f"{self.namespace}/{self.name}{p}"


class ServiceChangeTracker:
    """Pending service changes since the last sync
    (servicechangetracker.go:76 Update semantics: track (previous, current)
    per key, collapse no-op pairs)."""

    def __init__(self):
        self._pending: dict[str, tuple[Service | None, Service | None]] = {}

    def update(self, previous: Service | None, current: Service | None) -> bool:
        obj = current if current is not None else previous
        if obj is None:
            return False
        key = obj.meta.key
        if key in self._pending:
            first, _ = self._pending[key]
            self._pending[key] = (first, current)
            if first is current:  # add then delete of the same object
                del self._pending[key]
        else:
            self._pending[key] = (previous, current)
        return True

    def drain(self) -> dict[str, tuple[Service | None, Service | None]]:
        pending, self._pending = self._pending, {}
        return pending


class EndpointsChangeTracker:
    """Pending slice changes keyed by owning service
    (endpointschangetracker.go:81 EndpointSliceUpdate): remembers which
    services need their endpoint sets rebuilt."""

    def __init__(self):
        # service key → {slice key: slice}
        self._by_service: dict[str, dict[str, EndpointSlice]] = {}
        self._touched: set[str] = set()  # service keys

    def update(self, slice_: EndpointSlice, removed: bool = False) -> bool:
        if not slice_.service_name:
            return False
        svc_key = f"{slice_.meta.namespace}/{slice_.service_name}"
        bucket = self._by_service.setdefault(svc_key, {})
        if removed:
            bucket.pop(slice_.meta.key, None)
            if not bucket:
                del self._by_service[svc_key]
        else:
            bucket[slice_.meta.key] = slice_
        self._touched.add(svc_key)
        return True

    def drain(self) -> set[str]:
        touched, self._touched = self._touched, set()
        return touched

    def slices_for(self, service_key: str) -> list[EndpointSlice]:
        return list(self._by_service.get(service_key, {}).values())


class Proxier:
    """One node's proxy: trackers + applied maps + dataplane programming."""

    def __init__(self, store, node_name: str = "",
                 informers: InformerFactory | None = None,
                 dataplane: DataplaneTable | None = None):
        self.store = store
        self.node_name = node_name  # "" = policy-Local matches nothing
        self.dataplane = dataplane or DataplaneTable()
        self.service_changes = ServiceChangeTracker()
        self.endpoint_changes = EndpointsChangeTracker()
        self._services: dict[str, Service] = {}  # applied ServicePortMap src
        self.informers = informers or InformerFactory(store)
        self.informers.informer("Service").add_handler(self._on_service)
        self.informers.informer("EndpointSlice").add_handler(self._on_slice)
        self._started = False
        self.syncs = 0

    # -- informer handlers (pkg/proxy/config handlers) -----------------------

    def _on_service(self, etype, old, new) -> None:
        from ..store.store import DELETED

        if etype == DELETED:
            self.service_changes.update(new if new is not None else old, None)
        else:
            self.service_changes.update(old, new)

    def _on_slice(self, etype, old, new) -> None:
        from ..store.store import DELETED

        obj = new if new is not None else old
        self.endpoint_changes.update(obj, removed=(etype == DELETED))

    # -- sync (syncProxyRules) ----------------------------------------------

    def start(self) -> None:
        if not self._started:
            self.informers.start_all()
            self._started = True

    def sync(self) -> int:
        """Pump informers, fold pending changes, reprogram the dataplane.
        Returns the number of programmed rules. Cheap when nothing changed
        (the reference's partial-sync fast path)."""
        self.start()
        self.informers.pump_all()
        svc_pending = self.service_changes.drain()
        ep_touched = self.endpoint_changes.drain()
        if not svc_pending and not ep_touched and self.syncs:
            return len(self.dataplane.rules())
        for key, (_prev, cur) in svc_pending.items():
            if cur is None:
                self._services.pop(key, None)
            else:
                self._services[key] = cur
        rules: dict[tuple[str, int, str], Rule] = {}
        for key, svc in self._services.items():
            self._rules_for(key, svc, rules)
        self.dataplane.program(rules)
        self.syncs += 1
        return len(rules)

    def _rules_for(self, key: str, svc: Service,
                   rules: dict[tuple[str, int, str], Rule]) -> None:
        if not svc.spec.cluster_ip and svc.spec.type == "ClusterIP":
            return  # headless
        slices = self.endpoint_changes.slices_for(key)
        affinity = svc.spec.session_affinity == "ClientIP"
        for sp in svc.spec.ports:
            spn = ServicePortName(svc.meta.namespace, svc.meta.name,
                                  sp.name, sp.protocol)
            target = sp.target_port or sp.port
            cluster_eps = self._select(slices, target, local_only=False)
            if svc.spec.internal_traffic_policy == "Local":
                internal_eps = self._select(slices, target, local_only=True)
            else:
                internal_eps = cluster_eps
            if svc.spec.cluster_ip:
                rules[(svc.spec.cluster_ip, sp.port, sp.protocol)] = Rule(
                    service=str(spn), backends=internal_eps,
                    session_affinity=affinity,
                    affinity_timeout_s=svc.spec.session_affinity_timeout_s,
                )
            if svc.spec.type in ("NodePort", "LoadBalancer") and sp.node_port:
                if svc.spec.external_traffic_policy == "Local":
                    external_eps = self._select(slices, target, local_only=True)
                else:
                    external_eps = cluster_eps
                # node-port rule: any node address; modeled as vip="*"
                rules[("*", sp.node_port, sp.protocol)] = Rule(
                    service=str(spn), backends=external_eps,
                    session_affinity=affinity,
                    affinity_timeout_s=svc.spec.session_affinity_timeout_s,
                )

    def _select(self, slices, target_port: int,
                local_only: bool) -> tuple[Backend, ...]:
        """topology.go CategorizeEndpoints: ready endpoints first; when a
        service has none, fall back to serving-terminating endpoints so
        rolling restarts don't blackhole traffic."""
        ready: list[Backend] = []
        serving: list[Backend] = []
        for s in slices:
            for ep in s.endpoints:
                if local_only and ep.node_name != self.node_name:
                    continue
                for addr in ep.addresses:
                    b = Backend(addr, target_port, ep.node_name)
                    if ep.ready:
                        ready.append(b)
                    elif ep.serving and ep.terminating:
                        serving.append(b)
        chosen = ready if ready else serving
        # deterministic order: iptables rules are ordered by insertion; we
        # sort for reproducibility across informer orderings
        return tuple(sorted(chosen, key=lambda b: (b.address, b.port)))
