"""DefaultPreemption: dry-run victim search + PDB-aware selection + async
eviction.

Reference: pkg/scheduler/framework/plugins/defaultpreemption/
(SelectVictimsOnNode :207 — remove lower-priority pods, re-run Filter,
reprieve PDB-violating victims first then the rest, highest priority first;
filterPodsWithPDBViolation :380) driving the engine at
pkg/scheduler/framework/preemption/preemption.go (DryRunPreemption :408,
candidate sampling GetOffsetAndNumCandidates :174-191,
pickOneNodeForPreemption :302-360) with the async executor of
preemption/executor.go (prepareCandidateAsync :145 — nomination happens in
the scheduling cycle, evictions never block it).

A copy of the reference package's plugin
(kubernetes_tpu/scheduler/plugins/default_preemption.py). The victim search
stays numpy on the host, as there: the kernels' part is the FitError
diagnosis it reads (K4's per-node failure rows, through the bulk name sets
of the backend's _LazyKernelStatuses). Where the port differs: the
PodDisruptionBudgets are listed with Store.list (the same copies the
reference's iter_kind makes).
"""

from __future__ import annotations

import time

from ...api.resource import ResourceNames
from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint
from ..framework.interface import (
    UNSCHEDULABLE,
    Plugin,
    PostFilterResult,
    Status,
)
from ..nodeinfo import NodeInfo, PodInfo

# preemption.go:45-49 — candidate search is capped, not exhaustive
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100


class _Candidate:
    __slots__ = ("node_name", "victims", "num_pdb_violations")

    def __init__(self, node_name: str, victims: list[PodInfo],
                 num_pdb_violations: int = 0):
        self.node_name = node_name
        self.victims = victims
        self.num_pdb_violations = num_pdb_violations


class PreemptionExecutor:
    """executor.go — runs a chosen candidate's preparation off the
    scheduling loop: clear lower-priority nominations on the node, record
    the disruption against matching PDBs, evict the victims. With the async
    dispatcher the evictions ride worker threads (SchedulerAsyncAPICalls /
    SchedulerAsyncPreemption); without it they run inline (deterministic
    tests)."""

    def __init__(self, handle):
        self.handle = handle

    def prepare_candidate(self, candidate: _Candidate, preemptor: Pod,
                          pdbs: list) -> None:
        # 1. lower-priority pods nominated onto this node lose their
        # nomination (executor.go prepareCandidate ClearNominatedNodeName):
        # queue-side AND status-side — a stale status.nominatedNodeName
        # would keep forcing the demoted pod onto the host path and keep
        # simulating it onto a node it will not get
        queue = self.handle.queue
        store = self.handle.store
        for key in list(queue.nominated_pods_for_node(candidate.node_name)):
            npi = queue.nominated_pod_info(key)
            if npi is not None and npi.pod.spec.priority < preemptor.spec.priority:
                queue.delete_nominated_pod_if_exists(npi.pod)
                patch = getattr(store, "patch_pod_status", None)
                if patch is not None:
                    patch(key, nominated_node="")
        # 2. record the disruption on matching PDBs BEFORE evicting, so
        # concurrent preemptors see the spent budget (the eviction API's
        # DisruptedPods bookkeeping)
        store = self.handle.store
        now = time.time()
        for v in candidate.victims:
            for pdb in pdbs:
                if pdb.meta.namespace != v.pod.meta.namespace:
                    continue
                sel = pdb.spec.selector
                if sel is None or sel.empty or not sel.matches(v.pod.meta.labels):
                    continue
                cur = store.try_get("PodDisruptionBudget", pdb.meta.key)
                if cur is None:
                    continue
                cur.status.disrupted_pods[v.pod.meta.name] = now
                if cur.status.disruptions_allowed > 0:
                    cur.status.disruptions_allowed -= 1
                try:
                    store.update(cur, check_version=False)
                except Exception:  # noqa: BLE001
                    pass
        # 3. evict — async through the dispatcher when available
        dispatcher = getattr(self.handle, "api_dispatcher", None)
        if dispatcher is not None:
            from ..api_dispatcher import APICall, CallSkippedError, POD_DELETE
            from ...store.store import NotFoundError

            def make_evict(key):
                def evict():
                    try:
                        store.delete("Pod", key)
                    except NotFoundError:
                        pass

                return evict

            for v in candidate.victims:
                try:
                    dispatcher.add(APICall(POD_DELETE, v.key, make_evict(v.key)))
                except CallSkippedError:
                    pass  # an even-more-relevant call owns the object
        else:
            for v in candidate.victims:
                try:
                    store.delete("Pod", v.key)
                except Exception:  # noqa: BLE001
                    pass


class DefaultPreemption(Plugin):
    name = "DefaultPreemption"

    def __init__(self, names: ResourceNames, handle=None):
        self.names = names
        self.handle = handle
        self._offset = 0  # rotating candidate offset (fairness)
        # (node name, node generation, preemptor priority) -> sorted
        # lower-priority PodInfos (see _batch_select_victims)
        self._victim_cache: dict = {}

    def set_handle(self, handle) -> None:
        self.handle = handle

    def events_to_register(self):
        return [ClusterEventWithHint(ClusterEvent(ev.POD, ev.DELETE))]

    # -- eligibility (preemption.go PodEligibleToPreemptOthers) --------------

    def _eligible(self, pod: Pod) -> bool:
        if pod.spec.preemption_policy == "Never":
            return False
        nominated = pod.status.nominated_node_name
        if nominated and self.handle is not None:
            # if a previous nomination exists and victims are still terminating,
            # wait (preemption.go:169) — approximate via node existence check
            ni = self.handle.snapshot.get(nominated) if self.handle.snapshot else None
            if ni is not None and any(
                p.pod.is_terminating and p.pod.spec.priority < pod.spec.priority
                for p in ni.iter_pods()
            ):
                return False
        return True

    # -- PDB awareness -------------------------------------------------------

    def _list_pdbs(self) -> list:
        if self.handle is None:
            return []
        return self.handle.store.list("PodDisruptionBudget")[0]

    @staticmethod
    def _split_pdb_violation(pod_infos: list[PodInfo], pdbs: list):
        """filterPodsWithPDBViolation (default_preemption.go:380): walk the
        victims decrementing each matching PDB's remaining budget; a victim
        that drives any budget negative is 'violating'."""
        allowed = [pdb.status.disruptions_allowed for pdb in pdbs]
        violating: list[PodInfo] = []
        non_violating: list[PodInfo] = []
        for pi in pod_infos:
            pod = pi.pod
            violated = False
            if pod.meta.labels:
                for i, pdb in enumerate(pdbs):
                    if pdb.meta.namespace != pod.meta.namespace:
                        continue
                    sel = pdb.spec.selector
                    if sel is None or sel.empty or not sel.matches(pod.meta.labels):
                        continue
                    if pod.meta.name in pdb.status.disrupted_pods:
                        continue  # already processed; don't double-count
                    allowed[i] -= 1
                    if allowed[i] < 0:
                        violated = True
            (violating if violated else non_violating).append(pi)
        return violating, non_violating

    # -- victim search -------------------------------------------------------

    def _fit_plugin(self):
        from .node_resources import NodeResourcesFit

        for p in self.handle.framework.filter_plugins:
            if isinstance(p, NodeResourcesFit):
                return p
        return None

    @staticmethod
    def _fits_resources(fitp, req, node_info: NodeInfo, used: list[int],
                        pod_count: int) -> bool:
        """NodeResourcesFit.filter's exact arithmetic against an overridden
        usage vector (fit.go:673-760) — the reprieve loop's only possible
        failure mode when nothing but resources can be affected."""
        from ...api.resource import PODS

        alloc = node_info.allocatable
        if pod_count + 1 > alloc[PODS]:
            return False
        width = len(used)
        for i in range(width):
            r = req[i]
            if r == 0 or i == PODS:
                continue
            rname = (fitp.names.names[i] if i < fitp.names.width
                     else f"res{i}")
            if rname in fitp.ignored:
                continue
            if r > alloc[i] - used[i]:
                return False
        return True

    @classmethod
    def _resource_only(cls, pod: Pod, node_info: NodeInfo) -> bool:
        """True when re-ADDING a victim can only break NodeResourcesFit:
        the preemptor carries no inter-pod (anti)affinity, host ports,
        hard spread constraints, or claims (_pod_resource_only), and no
        pod on the node carries required anti-affinity (a reprieved
        victim's anti term could otherwise reject the preemptor). Static
        plugins (taints/affinity/name/unschedulable) are victim-independent
        and already vetted by the full-chain maximal-removal check.
        ONE predicate shared with the batched path — a divergence here
        would let the batch skip filters the sequential path runs."""
        return (cls._pod_resource_only(pod)
                and not node_info.pods_with_required_anti_affinity)

    def _select_victims_on_node(self, state, pod: Pod, node_info: NodeInfo,
                                pdbs: list, status_plugin: str = ""):
        """SelectVictimsOnNode (default_preemption.go:207): remove all lower-
        priority pods, check fit, then reprieve as many as possible — PDB-
        violating victims first, then the rest, highest priority first.
        Returns (victims, num_pdb_violations) or None.

        HOT LOOP #3 (preemption.go:408 DryRunPreemption) treatment:
        - a resource necessary-condition check runs BEFORE the node clone +
          full filter chain (maximal removal is the best case — if
          resources still don't fit, nothing can succeed);
        - when re-adding a victim can only move resources
          (_resource_only), the reprieve loop runs NodeResourcesFit's
          arithmetic instead of the full framework chain per victim;
        - and when additionally the node's failure verdict came from
          NodeResourcesFit itself, the maximal-removal full-chain check is
          skipped too — the kernel reports the FIRST failing filter row,
          NodeResourcesFit sits after every row that could apply to this
          pod (_resource_only rules out ports/spread/IPA/features), so
          that verdict proves all static filters pass."""
        fw = self.handle.framework
        lower = [pi for pi in node_info.iter_pods()
                 if pi.pod.spec.priority < pod.spec.priority]
        if not lower:
            return None
        fitp = self._fit_plugin()
        req = used = None
        resource_only = False
        if fitp is not None:
            req = fitp._pod_info(state, pod).request
            width = max(len(req.v), len(node_info.allocatable.v))
            used = [node_info.requested[i] for i in range(width)]
            for pi in lower:
                for i in range(width):
                    used[i] -= pi.request[i]
            if not self._fits_resources(
                fitp, req, node_info, used,
                len(node_info.pods) - len(lower),
            ):
                return None  # necessary condition: skip the clone + chain
            resource_only = self._resource_only(pod, node_info)
        if not (resource_only and status_plugin == fitp.name):
            # static filters not yet proven: run the maximal-removal full
            # chain on a clone (also the reprieve vehicle when plugins
            # beyond NodeResourcesFit can be affected)
            ni = node_info.clone()
            state = state.clone()
            for pi in lower:
                ni.remove_pod(pi.key)
                fw.run_pre_filter_extension_remove_pod(state, pod, pi, ni)
            if not fw.run_filter_plugins(state, pod, ni).is_success:
                return None  # even with all victims gone: no fit
        # MoreImportantPod order: priority desc, then earlier start
        lower.sort(key=lambda pi: (-pi.pod.spec.priority,
                                   pi.pod.meta.creation_timestamp))
        violating, non_violating = self._split_pdb_violation(lower, pdbs)
        victims: list[PodInfo] = []
        num_violations = 0

        if resource_only:
            kept = [len(node_info.pods) - len(lower)]

            def reprieve(pi: PodInfo) -> bool:
                trial = [u + pi.request[i] for i, u in enumerate(used)]
                # +1 for the preemptor itself, on top of kept pods
                if self._fits_resources(fitp, req, node_info, trial,
                                        kept[0] + 1):
                    used[:] = trial
                    kept[0] += 1
                    return True
                victims.append(pi)
                return False
        else:
            def reprieve(pi: PodInfo) -> bool:
                ni.add_pod(pi)
                fw.run_pre_filter_extension_add_pod(state, pod, pi, ni)
                if fw.run_filter_plugins(state, pod, ni).is_success:
                    return True
                ni.remove_pod(pi.key)
                fw.run_pre_filter_extension_remove_pod(state, pod, pi, ni)
                victims.append(pi)
                return False

        for pi in violating:
            if not reprieve(pi):
                num_violations += 1
        for pi in non_violating:
            reprieve(pi)
        if not victims:
            return None
        victims.sort(key=lambda pi: (-pi.pod.spec.priority,
                                     pi.pod.meta.creation_timestamp))
        return victims, num_violations

    # -- batched victim search (HOT LOOP #3 as dense arrays) -----------------

    def _batch_select_victims(self, state, pod: Pod, nodes: list,
                              statuses) -> dict:
        """One numpy pass replacing per-node _select_victims_on_node for
        the nodes where only resources can decide (preemption.go:408
        DryRunPreemption's dominant case, round-3 task: the candidate ×
        victim dry-run as dense victim-removal deltas instead of a python
        loop per candidate).

        Eligible nodes: the pod is _resource_only-safe, the node carries no
        required anti-affinity pods, its failure verdict came from
        NodeResourcesFit, and it HAS lower-priority pods. The greedy
        reprieve (priority desc, earlier start first) runs as a V-step
        vector scan over every eligible node at once — step v asks "does
        re-adding victim v still fit?" for ALL nodes in one [C, R]
        comparison, byte-identical to the sequential loop's arithmetic.

        Returns {node name: (victims, 0) | None}; nodes it does not decide
        are absent (caller falls back per node). PDBs present → batch off
        (the reprieve ORDER depends on per-victim PDB budgets)."""
        import numpy as np

        fitp = self._fit_plugin()
        if fitp is None:
            return {}
        req_vec = fitp._pod_info(state, pod).request
        if not self._pod_resource_only(pod):
            return {}
        eligible: list = []
        victim_lists: list[list[PodInfo]] = []
        vmax = 0
        prio = pod.spec.priority
        cache = self._victim_cache
        bulk_fit = getattr(statuses, "fit_verdict_names", None)
        fit_names = bulk_fit() if bulk_fit is not None else None
        for ni in nodes:
            if ni.pods_with_required_anti_affinity:
                continue
            if fit_names is not None:
                if ni.name not in fit_names:
                    continue
            elif statuses.get(ni.name).plugin != fitp.name:
                continue
            # sorted victim lists are stable per (node generation, preemptor
            # priority): consecutive preemptors of one priority class reuse
            # them instead of re-walking + re-sorting every node's pods
            ck = (ni.name, ni.generation, prio)
            lower = cache.get(ck)
            if lower is None:
                lower = [pi for pi in ni.iter_pods()
                         if pi.pod.spec.priority < prio]
                # MoreImportantPod order: reprieve tries high priority first
                lower.sort(key=lambda pi: (-pi.pod.spec.priority,
                                           pi.pod.meta.creation_timestamp))
                if len(cache) > 20000:
                    cache.clear()
                cache[ck] = lower
            if not lower:
                continue
            eligible.append(ni)
            victim_lists.append(lower)
            vmax = max(vmax, len(lower))
        if not eligible:
            return {}
        C = len(eligible)
        width = max(
            max(len(ni.allocatable.v) for ni in eligible),
            len(req_vec.v),
        )
        from ...api.resource import PODS

        def vec(v):
            return list(v) + [0] * (width - len(v))

        req = np.asarray(vec(req_vec.v), dtype=np.int64)
        # ignored resources and the PODS column are excluded from the
        # per-resource comparison (exactly _fits_resources)
        active = req > 0
        for i in range(width):
            name = (fitp.names.names[i] if i < fitp.names.width
                    else f"res{i}")
            if name in fitp.ignored:
                active[i] = False
        active[PODS] = False
        alloc = np.asarray([vec(ni.allocatable.v) for ni in eligible],
                           dtype=np.int64)
        used = np.asarray([vec(ni.requested.v) for ni in eligible],
                          dtype=np.int64)
        vreq = np.zeros((C, vmax, width), dtype=np.int64)
        vactive = np.zeros((C, vmax), dtype=bool)
        for c, lower in enumerate(victim_lists):
            for v, pi in enumerate(lower):
                vreq[c, v] = vec(pi.request.v)
                vactive[c, v] = True
        # maximal removal: all lower-priority pods gone
        used = used - vreq.sum(axis=1)
        kept = np.asarray([len(ni.pods) - len(lv)
                           for ni, lv in zip(eligible, victim_lists)],
                          dtype=np.int64)
        pods_cap = alloc[:, PODS]

        req_a = req[active][None, :]
        alloc_a = alloc[:, active]

        def fits(u, k):
            res_ok = (req_a <= alloc_a - u[:, active]).all(axis=1)
            return res_ok & (k + 1 <= pods_cap)

        feasible = fits(used, kept)
        # greedy reprieve scan: step v re-adds victim v where it fits
        victim_mask = np.zeros((C, vmax), dtype=bool)
        for v in range(vmax):
            trial = used + vreq[:, v]
            ok = fits(trial, kept + 1) & vactive[:, v] & feasible
            used = np.where(ok[:, None], trial, used)
            kept = kept + ok
            victim_mask[:, v] = vactive[:, v] & ~ok & feasible
        out: dict = {}
        for c, (ni, lower) in enumerate(zip(eligible, victim_lists)):
            if not feasible[c]:
                out[ni.name] = None
                continue
            victims = [pi for v, pi in enumerate(lower)
                       if victim_mask[c, v]]
            if not victims:
                out[ni.name] = None
                continue
            victims.sort(key=lambda pi: (-pi.pod.spec.priority,
                                         pi.pod.meta.creation_timestamp))
            out[ni.name] = (victims, 0)
        return out

    @staticmethod
    def _pod_resource_only(pod: Pod) -> bool:
        """The pod-level half of _resource_only (node-independent).
        NodeDeclaredFeatures sits BEFORE NodeResourcesFit in the host chain
        but has no kernel row — a kernel NodeResourcesFit verdict cannot
        prove it passed, so a features-requiring pod must take the
        full-chain path. So must a pod with volume or resource claims: the
        volume plugins and DynamicResources have no kernel row either."""
        from ...api.storage import pod_claim_names

        aff = pod.spec.affinity
        if aff is not None and (aff.pod_affinity is not None
                                or aff.pod_anti_affinity is not None):
            return False
        if any(p.host_port > 0 for c in pod.spec.containers
               for p in c.ports):
            return False
        if any(c.when_unsatisfiable == "DoNotSchedule"
               for c in pod.spec.topology_spread_constraints):
            return False
        if pod_claim_names(pod) or pod.spec.resource_claims:
            return False
        from .node_declared_features import infer_required_features

        if infer_required_features(pod):
            return False
        return True

    # -- candidate sampling + ranking ----------------------------------------

    def _num_candidates(self, num_nodes: int) -> int:
        """GetOffsetAndNumCandidates (preemption.go:174-191)."""
        n = num_nodes * MIN_CANDIDATE_NODES_PERCENTAGE // 100
        n = max(n, MIN_CANDIDATE_NODES_ABSOLUTE)
        return min(n, num_nodes)

    @staticmethod
    def _candidate_rank(c: _Candidate):
        """pickOneNodeForPreemption criteria (preemption.go:302-360), all
        minimized: PDB violations, highest victim priority, priority sum,
        victim count, then earliest victim start time (prefer nodes whose
        highest-priority victim started LATEST => minimize -start)."""
        priorities = [v.pod.spec.priority for v in c.victims]
        top = max(priorities, default=-(1 << 31))
        latest_start = max(
            (v.pod.meta.creation_timestamp for v in c.victims
             if v.pod.spec.priority == top), default=0.0
        )
        return (
            c.num_pdb_violations,
            top,
            sum(priorities),
            len(c.victims),
            -latest_start,
        )

    # -- post filter -----------------------------------------------------------

    def post_filter(self, state, pod: Pod, node_to_status):
        if not self._eligible(pod):
            return None, Status.unresolvable(
                "preemption not allowed for this pod", plugin=self.name
            )
        snapshot = self.handle.snapshot
        pdbs = self._list_pdbs()
        nodes = snapshot.list_nodes()
        num_all = len(nodes)
        want = self._num_candidates(num_all)
        candidates: list[_Candidate] = []
        # rotating offset (the reference randomizes; a rotating cursor gives
        # the same fairness deterministically)
        start = self._offset % num_all if num_all else 0
        rotation = [nodes[(start + i) % num_all] for i in range(num_all)]
        # batched dry-run for the resource-only nodes (one numpy pass over
        # every candidate); outcomes match the per-node path exactly, so
        # scan order / early exit / offset bookkeeping below are unchanged.
        # PDBs present → reprieve order depends on per-victim budgets, so
        # everything takes the per-node path.
        # bulk UNSCHEDULABLE mask when the statuses are kernel-backed (one
        # vectorized pass instead of a Status per scanned node)
        bulk = getattr(node_to_status, "unschedulable_name_set", None)
        unsched_names = bulk() if bulk is not None else None

        def _retriable(name: str) -> bool:
            if unsched_names is not None:
                return name in unsched_names
            return node_to_status.get(name).code == UNSCHEDULABLE

        batched: dict = {}
        if not pdbs:
            # the sequential scan stops at `want` candidates, so batching
            # more than ~want nodes is wasted work (nearly every node is a
            # candidate in preemption-heavy workloads); the tail past the
            # cap falls back per node in the rare under-supply case
            cap = min(num_all, 2 * want)
            batched = self._batch_select_victims(
                state, pod,
                [ni for ni in rotation[:cap] if _retriable(ni.name)],
                node_to_status,
            )
        scanned = 0
        for ni in rotation:
            scanned += 1
            if not _retriable(ni.name):
                continue  # UnschedulableAndUnresolvable can't be fixed by eviction
            if ni.name in batched:
                found = batched[ni.name]
            else:
                found = self._select_victims_on_node(
                    state, pod, ni, pdbs,
                    status_plugin=node_to_status.get(ni.name).plugin,
                )
            if found is not None:
                victims, violations = found
                candidates.append(_Candidate(ni.name, victims, violations))
                if len(candidates) >= want:
                    break
        self._offset = (start + scanned) % num_all if num_all else 0
        if not candidates:
            return None, Status.unschedulable(
                "preemption: 0/%d nodes are available" % num_all,
                plugin=self.name,
            )
        best = min(candidates, key=self._candidate_rank)
        # nomination is synchronous (the scheduling cycle needs it); victim
        # eviction + nomination cleanup run via the executor — off the loop
        # when the async dispatcher is available (executor.go:145)
        PreemptionExecutor(self.handle).prepare_candidate(best, pod, pdbs)
        return (
            PostFilterResult(nominated_node_name=best.node_name),
            Status(),
        )
