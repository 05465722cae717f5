"""DynamicResources plugin: device-claim allocation against ResourceSlices.

Reference: pkg/scheduler/framework/plugins/dynamicresources/dynamicresources.go
(PreEnqueue:252 claims-must-exist, PreFilter:408 allocator setup, Filter:637
per-node allocation attempt, Reserve, PreBind, Unreserve) with the structured
allocator from staging/src/k8s.io/dynamic-resource-allocation/ and in-memory
allocation tracking mirroring dra_manager.go / allocateddevices.go.

Device selectors evaluate a CEL subset (utils/cel.py, wired at
api/dra.py) alongside typed selectors; the per-node allocation attempt is
the same shape: gather the node's device inventory, subtract devices
already allocated (claim statuses + in-flight assumes), then greedily
satisfy each request.

A copy of the reference package's module
(kubernetes_tpu/scheduler/plugins/dynamic_resources.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...api.dra import (
    RESERVED_FOR_MAX,
    AllocationResult,
    DeviceAllocationResult,
    DeviceRequest,
    ResourceClaim,
    pod_resource_claim_keys,
)
from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE
from ..framework.interface import Plugin, Status
from ..nodeinfo import NodeInfo

ERR_CLAIM_NOT_FOUND = "waiting for dynamic resource claim to be created"
ERR_CANNOT_ALLOCATE = "cannot allocate all claims"
ERR_RESERVED_ELSEWHERE = "resourceclaim in use and not available on this node"
ERR_TOO_MANY_CONSUMERS = "resourceclaim has reached its maximum consumer count"


@dataclass
class _ClaimState:
    """Per-cycle DRA state (dynamicresources.go stateData). The taken-device
    set and slice list are computed ONCE at PreFilter (the reference builds
    its allocator there too) — Filter only copies the small taken set."""

    claims: list[ResourceClaim] = field(default_factory=list)
    base_taken: set = field(default_factory=set)  # (driver, pool, device)
    slices: list = field(default_factory=list)
    # slice-order-preserving inventory, split once per cycle: entries are
    # (slice_idx, driver, pool, device) so a per-node merge reproduces the
    # exact candidate order a full slice walk would produce
    inv_global: list = field(default_factory=list)
    inv_by_node: dict = field(default_factory=dict)
    # claim key -> per-request variant lists, each entry
    # (subrequest name, driver, selectors, count) tried in order — see
    # Allocator._request_variants. Resolved once per cycle (DeviceClass
    # lookups are node-independent; re-resolving per node deepcopied the
    # class per (pod, node) at 500-node scale)
    requirements: dict = field(default_factory=dict)
    # partitionable devices (KEP-4815): counter budgets + per-device
    # consumption, and the cluster-wide use already committed by existing
    # allocations — all keyed (driver, scoped pool, counter-set name)
    counter_caps: dict = field(default_factory=dict)
    device_consumes: dict = field(default_factory=dict)
    base_counter_use: dict = field(default_factory=dict)
    needs_allocation: bool = False
    # node name -> {claim key -> AllocationResult} computed by Filter
    allocations_per_node: dict[str, dict[str, AllocationResult]] = field(
        default_factory=dict
    )
    # set by reserve; used by unreserve/pre_bind
    reserved_node: str = ""

    def clone(self) -> "_ClaimState":
        c = _ClaimState(
            claims=list(self.claims),
            base_taken=set(self.base_taken),
            slices=list(self.slices),
            needs_allocation=self.needs_allocation,
        )
        # the prebuilt inventory/requirements are per-cycle read-only:
        # sharing the structures (not the containers) is safe
        c.inv_global = list(self.inv_global)
        c.inv_by_node = {n: list(v) for n, v in self.inv_by_node.items()}
        c.requirements = dict(self.requirements)
        c.counter_caps = dict(self.counter_caps)
        c.device_consumes = dict(self.device_consumes)
        c.base_counter_use = dict(self.base_counter_use)  # inner dicts
        # are read-only too: Filter copies them before mutating
        c.allocations_per_node = {
            n: dict(m) for n, m in self.allocations_per_node.items()
        }
        c.reserved_node = self.reserved_node
        return c


class _ChainSet:
    """A read-only base set + a small mutable overlay: the allocator's
    `taken` contract (membership, update, add, iteration) without copying
    the base per candidate node."""

    __slots__ = ("base", "extra")

    def __init__(self, base):
        self.base = base
        self.extra = set()

    def __contains__(self, key) -> bool:
        return key in self.extra or key in self.base

    def __iter__(self):
        yield from self.base
        yield from self.extra

    def add(self, key) -> None:
        self.extra.add(key)

    def update(self, items) -> None:
        self.extra.update(items)


class DRAManager:
    """In-memory view of allocated devices (dra_manager.go +
    allocateddevices.go): claim statuses from the store plus in-flight
    assumed allocations not yet written back."""

    def __init__(self, store):
        self.store = store
        # claim key -> AllocationResult assumed during Reserve
        self.assumed: dict[str, AllocationResult] = {}

    def allocated_device_ids(self) -> set[tuple[str, str, str]]:
        """(driver, pool, device) triples currently taken cluster-wide."""
        taken: set[tuple[str, str, str]] = set()
        for claim in self.store.list_refs("ResourceClaim"):
            alloc = claim.status.allocation
            if alloc is not None:
                for d in alloc.devices:
                    taken.add((d.driver, d.pool, d.device))
        for alloc in self.assumed.values():
            for d in alloc.devices:
                taken.add((d.driver, d.pool, d.device))
        return taken

    def effective_allocation(self, claim: ResourceClaim) -> AllocationResult | None:
        return claim.status.allocation or self.assumed.get(claim.meta.key)

    def assume(self, claim_key: str, alloc: AllocationResult) -> None:
        self.assumed[claim_key] = alloc

    def forget(self, claim_key: str) -> None:
        self.assumed.pop(claim_key, None)


class Allocator:
    """Structured allocator: satisfy a claim's requests from one node's
    inventory (staging/.../structured/allocator.go, typed-selector form)."""

    def __init__(self, store, manager: DRAManager):
        self.store = store
        self.manager = manager

    def _resolve_class(self, device_class_name: str, selectors):
        driver = ""
        out = list(selectors)
        if device_class_name:
            dc = self.store.try_get("DeviceClass", device_class_name)
            if dc is not None:
                driver = dc.driver
                out.extend(dc.selectors)
        return driver, out

    def _request_variants(self, request: DeviceRequest):
        """[(subrequest name, driver, selectors, count, tolerations)]
        tried in order — a plain request is its own single variant; a
        prioritized-list request (KEP-4816 firstAvailable) yields one
        variant per alternative."""
        if request.first_available:
            return [
                (sub.name, *self._resolve_class(sub.device_class_name,
                                                sub.selectors), sub.count,
                 sub.tolerations)
                for sub in request.first_available
            ]
        driver, selectors = self._resolve_class(
            request.device_class_name, request.selectors
        )
        return [("", driver, selectors, request.count, request.tolerations)]

    @staticmethod
    def _merged_inventory(cycle_state, node_name: str):
        """Per-node inventory in exact slice order, cached per node on the
        cycle state — allocate() runs once per (claim, node), and the merge
        must not be rebuilt per claim."""
        inv_cache = getattr(cycle_state, "_inv_cache", None)
        if inv_cache is None:
            inv_cache = {}
            cycle_state._inv_cache = inv_cache
        inv = inv_cache.get(node_name)
        if inv is not None:
            return inv
        node_entries = cycle_state.inv_by_node.get(node_name, [])
        if cycle_state.inv_global:
            import heapq

            inv = [
                (d, p, dev) for _, d, p, dev in heapq.merge(
                    cycle_state.inv_global, node_entries,
                    key=lambda e: e[0],
                )
            ]
        else:
            inv = [(d, p, dev) for _, d, p, dev in node_entries]
        inv_cache[node_name] = inv
        return inv

    @staticmethod
    def node_inventory(slices: list, node_name: str):
        """(driver, pool, device) inventory visible to one node, from a
        pre-listed slice set.

        Device identity is (driver, pool, device); node-local slices get a
        node-scoped pool so equally-named devices on different nodes stay
        distinct (resource/v1 semantics: a pool belongs to one driver and
        names are unique within it — drivers publish per-node pools)."""
        out = []
        for sl in slices:
            if sl.all_nodes or sl.node_name == node_name:
                pool = sl.pool if sl.all_nodes else f"{sl.node_name}/{sl.pool}"
                for dev in sl.devices:
                    out.append((sl.driver, pool, dev))
        return out

    @staticmethod
    def _counters_ok(caps: dict, uses: list[dict], drv: str, pool: str,
                     cons) -> bool:
        """KEP-4815: every counter the partition consumes must fit what is
        left of its set's budget after all use layers (committed + this
        claim + this variant)."""
        for set_name, cnts in cons.items():
            cap = caps.get((drv, pool, set_name))
            if cap is None:
                return False  # partition without a published budget
            for cname, amt in cnts.items():
                used = sum(
                    u.get((drv, pool, set_name), {}).get(cname, 0)
                    for u in uses
                )
                if used + amt > cap.get(cname, 0):
                    return False
        return True

    @staticmethod
    def _bump_counters(use: dict, drv: str, pool: str, cons) -> None:
        for set_name, cnts in cons.items():
            u = use.setdefault((drv, pool, set_name), {})
            for cname, amt in cnts.items():
                u[cname] = u.get(cname, 0) + amt

    @staticmethod
    def _merge_use(dst: dict, src: dict) -> None:
        for k, cnts in src.items():
            u = dst.setdefault(k, {})
            for cname, amt in cnts.items():
                u[cname] = u.get(cname, 0) + amt

    @staticmethod
    def _counter_tables(slices) -> tuple[dict, dict]:
        """(caps, consumes) keyed (driver, scoped pool, ...) from a raw
        slice list — the legacy allocate() path must enforce KEP-4815
        budgets exactly like the PreFilter-built cycle state does."""
        caps: dict = {}
        consumes: dict = {}
        for sl in slices:
            pool = sl.pool if sl.all_nodes else f"{sl.node_name}/{sl.pool}"
            for set_name, c in (sl.shared_counters or {}).items():
                caps[(sl.driver, pool, set_name)] = c
            for dev in sl.devices:
                if dev.consumes_counters:
                    consumes[(sl.driver, pool, dev.name)] = \
                        dev.consumes_counters
        return caps, consumes

    def allocate(
        self, claim: ResourceClaim, node_name: str,
        taken: "set[tuple[str, str, str]] | _ChainSet",
        slices: list | None = None,
        cycle_state=None,
        counter_use: dict | None = None,
    ) -> AllocationResult | None:
        """Greedy per-request allocation; mutates `taken` on success so one
        Filter pass can allocate several claims without double-booking.
        With `cycle_state` (the PreFilter-built _ClaimState) the inventory
        and class requirements come prebuilt — O(node's devices) per call
        instead of a full slice walk + DeviceClass store gets per node."""
        reqs = None
        if cycle_state is not None:
            inventory = self._merged_inventory(cycle_state, node_name)
            reqs = cycle_state.requirements.get(claim.meta.key)
        else:
            if slices is None:
                slices = self.store.list_refs("ResourceSlice")
            inventory = self.node_inventory(slices, node_name)
        picked: list[DeviceAllocationResult] = []
        newly: list[tuple[str, str, str]] = []
        committed_use = counter_use if counter_use is not None else {}
        claim_use: dict = {}
        if cycle_state is not None:
            consumes = cycle_state.device_consumes
            caps = cycle_state.counter_caps
        else:
            caps, consumes = self._counter_tables(slices)
            if counter_use is None and consumes:
                # no precomputed committed use: derive it from the taken
                # set so already-allocated partitions count against caps
                for key in taken:
                    cons = consumes.get(key)
                    if cons:
                        self._bump_counters(committed_use, key[0], key[1],
                                            cons)
        from ...api.dra import untolerated_taints

        for ri, request in enumerate(claim.spec.requests):
            variants = (reqs[ri] if reqs is not None
                        else self._request_variants(request))
            satisfied = False
            for sub_name, driver, selectors, count, tolerations in variants:
                picked_v: list[DeviceAllocationResult] = []
                newly_v: list[tuple[str, str, str]] = []
                use_v: dict = {}
                need = count
                # the allocation result names the winning alternative as
                # <request>/<subrequest> (the reference's format)
                result_name = (f"{request.name}/{sub_name}" if sub_name
                               else request.name)
                for drv, pool, dev in inventory:
                    if need == 0:
                        break
                    if driver and drv != driver:
                        continue
                    key = (drv, pool, dev.name)
                    if key in taken or key in newly or key in newly_v:
                        continue
                    if not all(sel.matches(dev.attributes,
                                           capacity=dev.capacity,
                                           driver=drv, name=dev.name)
                               for sel in selectors):
                        continue
                    if dev.taints and untolerated_taints(dev.taints,
                                                         tolerations):
                        # KEP-5055: NoSchedule AND NoExecute taints keep
                        # new allocations off the device unless tolerated
                        continue
                    cons = consumes.get(key)
                    if cons is not None and not self._counters_ok(
                        caps, [committed_use, claim_use, use_v],
                        drv, pool, cons,
                    ):
                        continue  # partition budget exhausted
                    picked_v.append(DeviceAllocationResult(
                        result_name, drv, pool, dev.name))
                    newly_v.append(key)
                    if cons is not None:
                        self._bump_counters(use_v, drv, pool, cons)
                    need -= 1
                if need == 0:
                    picked.extend(picked_v)
                    newly.extend(newly_v)
                    self._merge_use(claim_use, use_v)
                    satisfied = True
                    break  # firstAvailable: the first full fit wins
            if not satisfied:
                return None
        taken.update(newly)
        if counter_use is not None:
            self._merge_use(counter_use, claim_use)
        return AllocationResult(devices=tuple(picked), node_name=node_name)


class DynamicResources(Plugin):
    """dynamicresources/dynamicresources.go — DRA extension points."""

    name = "DynamicResources"
    STATE_KEY = "PreFilterDynamicResources"

    def __init__(self, store, manager: DRAManager | None = None):
        self.store = store
        self.manager = manager or DRAManager(store)
        self.allocator = Allocator(store, self.manager)
        # (slice rv signature, inv_global, inv_by_node, counter_caps,
        # device_consumes) — see pre_filter
        self._inventory_cache: tuple | None = None

    def events_to_register(self):
        return [
            ClusterEventWithHint(
                ClusterEvent(ev.RESOURCE_CLAIM, ev.ADD | ev.UPDATE | ev.DELETE),
                lambda *_: QUEUE,
            ),
            ClusterEventWithHint(
                ClusterEvent(ev.RESOURCE_SLICE, ev.ADD | ev.UPDATE), lambda *_: QUEUE
            ),
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD), lambda *_: QUEUE),
        ]

    # -- queue gating --------------------------------------------------------

    def pre_enqueue(self, pod: Pod) -> Status:
        """PreEnqueue:252 — claims must exist before the pod may queue."""
        for key in pod_resource_claim_keys(pod):
            if self.store.try_get("ResourceClaim", key) is None:
                return Status.unresolvable(ERR_CLAIM_NOT_FOUND, plugin=self.name)
        return Status()

    # -- scheduling cycle ----------------------------------------------------

    def pre_filter(self, state, pod: Pod, nodes):
        keys = pod_resource_claim_keys(pod)
        if not keys:
            return None, Status.skip()
        s = _ClaimState()
        for key in keys:
            claim = self.store.try_get("ResourceClaim", key)
            if claim is None:
                return None, Status.unresolvable(ERR_CLAIM_NOT_FOUND, plugin=self.name)
            s.claims.append(claim)
        # allocator setup happens once per cycle (dynamicresources.go
        # PreFilter:408) — Filter must not re-list the store per node
        s.needs_allocation = any(
            self.manager.effective_allocation(c) is None for c in s.claims
        )
        if s.needs_allocation:
            s.base_taken = self.manager.allocated_device_ids()
            s.slices = self.store.list_refs("ResourceSlice")
            # the slice-derived inventory is identical between cycles while
            # the slices themselves are unchanged — cache it keyed by the
            # slices' resourceVersions (one claim pod per cycle rebuilt a
            # 5000-device inventory per POD before; reference: the
            # resourceslicetracker keeps a live view for the same reason)
            sig = tuple(sl.meta.resource_version for sl in s.slices)
            cached = self._inventory_cache
            if cached is not None and cached[0] == sig:
                (_, s.inv_global, s.inv_by_node, s.counter_caps,
                 s.device_consumes) = cached
            else:
                for idx, sl in enumerate(s.slices):
                    pool = (sl.pool if sl.all_nodes
                            else f"{sl.node_name}/{sl.pool}")
                    for set_name, caps in (sl.shared_counters or {}).items():
                        s.counter_caps[(sl.driver, pool, set_name)] = caps
                    target = (s.inv_global if sl.all_nodes
                              else s.inv_by_node.setdefault(sl.node_name, []))
                    for dev in sl.devices:
                        target.append((idx, sl.driver, pool, dev))
                        if dev.consumes_counters:
                            s.device_consumes[
                                (sl.driver, pool, dev.name)
                            ] = dev.consumes_counters
                self._inventory_cache = (
                    sig, s.inv_global, s.inv_by_node, s.counter_caps,
                    s.device_consumes,
                )
            # counter use already committed by existing allocations
            for key in s.base_taken:
                cons = s.device_consumes.get(key)
                if not cons:
                    continue
                for set_name, cnts in cons.items():
                    u = s.base_counter_use.setdefault(
                        (key[0], key[1], set_name), {}
                    )
                    for cname, amt in cnts.items():
                        u[cname] = u.get(cname, 0) + amt
            s.requirements = {
                c.meta.key: [self.allocator._request_variants(r)
                             for r in c.spec.requests]
                for c in s.claims
            }
        state.write(self.STATE_KEY, s)
        return None, None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return Status()
        node_name = node_info.name
        taken = None  # per-node OVERLAY on the PreFilter-computed base set
        counter_use: dict = {}
        node_allocs: dict[str, AllocationResult] = {}
        for claim in s.claims:
            alloc = self.manager.effective_allocation(claim)
            if alloc is not None:
                # already allocated: node must match the allocation
                if alloc.node_name and alloc.node_name != node_name:
                    return Status.unresolvable(
                        ERR_RESERVED_ELSEWHERE, plugin=self.name
                    )
                if (
                    len(claim.status.reserved_for) >= RESERVED_FOR_MAX
                    and pod.meta.key not in claim.status.reserved_for
                ):
                    return Status.unresolvable(
                        ERR_TOO_MANY_CONSUMERS, plugin=self.name
                    )
                continue
            if taken is None:
                # copying the base set per candidate node made DRA Filter
                # quadratic in allocated claims (thousands of triples copied
                # per (pod, node)); the overlay shares the immutable base.
                # base_counter_use is only populated by partitionable
                # devices (KEP-4815) — when those reach the same scale the
                # same layered treatment applies here
                taken = _ChainSet(s.base_taken)
                counter_use = {
                    k: dict(v) for k, v in s.base_counter_use.items()
                }
            alloc = self.allocator.allocate(claim, node_name, taken,
                                            cycle_state=s,
                                            counter_use=counter_use)
            if alloc is None:
                return Status.unschedulable(ERR_CANNOT_ALLOCATE, plugin=self.name)
            node_allocs[claim.meta.key] = alloc
        if node_allocs:
            s.allocations_per_node[node_name] = node_allocs
        return Status()

    def post_filter(self, state, pod: Pod, node_to_status):
        """PostFilter (dynamicresources.go:787): when the pod is
        unschedulable and holds an allocated-but-unreserved claim, the
        allocation may be what pins it to an infeasible node — deallocate
        so the retry can allocate elsewhere. Always returns Unschedulable
        (it improves the NEXT attempt; preemption still runs after)."""
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return None, Status.unschedulable(
                "no claims to deallocate", plugin=self.name
            )
        from ...store.store import ConflictError

        freed = 0
        for claim in s.claims:
            cur = self.store.try_get("ResourceClaim", claim.meta.key)
            if cur is None or cur.status.allocation is None:
                continue
            if cur.status.reserved_for:
                continue  # another pod holds it; not ours to free
            cur.status.allocation = None
            try:
                # optimistic-concurrency write: if a concurrent PreBind
                # reserved the claim since our snapshot, the deallocation is
                # stale and MUST lose (a forced write would erase a live
                # reservation and double-allocate the device)
                self.store.update(cur)
                freed += 1
            except ConflictError:
                pass
            except Exception:  # noqa: BLE001
                pass
        return None, Status.unschedulable(
            f"deallocation of {freed} ResourceClaims" if freed
            else "still not schedulable",
            plugin=self.name,
        )

    def reserve(self, state, pod: Pod, node_name: str) -> Status:
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return Status()
        s.reserved_node = node_name
        for key, alloc in s.allocations_per_node.get(node_name, {}).items():
            self.manager.assume(key, alloc)
        return Status()

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return
        for key in s.allocations_per_node.get(node_name, {}):
            self.manager.forget(key)

    def pre_bind(self, state, pod: Pod, node_name: str) -> Status:
        """Write allocation + reservedFor to the store (PreBind)."""
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return Status()
        my_allocs = s.allocations_per_node.get(node_name, {})
        try:
            for claim in s.claims:
                cur = self.store.get("ResourceClaim", claim.meta.key)
                alloc = my_allocs.get(claim.meta.key)
                if alloc is not None and cur.status.allocation is None:
                    cur.status.allocation = alloc
                if pod.meta.key not in cur.status.reserved_for:
                    cur.status.reserved_for = tuple(cur.status.reserved_for) + (
                        pod.meta.key,
                    )
                self.store.update(cur, check_version=False)
                # forget only assumes THIS pod created — a shared claim's
                # assume may belong to another pod's in-flight binding
                if claim.meta.key in my_allocs:
                    self.manager.forget(claim.meta.key)
        except Exception as e:  # noqa: BLE001 - surfaced as bind failure
            return Status.as_error(e, self.name)
        return Status()

    def pre_bind_pre_flight(self, state, pod: Pod, node_name: str) -> Status:
        s: _ClaimState | None = state.read(self.STATE_KEY)
        if s is None:
            return Status.skip()
        return Status()

    def sign(self, pod: Pod) -> str | None:
        """Claim-referencing pods are unsignable: allocation state is
        per-pod, so batching identical-pod score reuse would be wrong
        (signers.go treats DRA pods the same way)."""
        if pod.spec.resource_claims:
            return None
        return ""
