"""Disruption controller: maintains PodDisruptionBudget status.

Reference: pkg/controller/disruption/disruption.go — for every PDB, count
matching healthy pods and publish how many voluntary disruptions the budget
still allows (DisruptionsAllowed). The scheduler's preemption engine reads
ONLY the published status (default_preemption.go:380
filterPodsWithPDBViolation) — this controller is what makes that status
true. DisruptedPods entries record evictions already processed so a slow
cache never double-counts a disruption; stale entries (older than the
2-minute timeout the reference uses) are dropped.

A copy of the reference package's controller
(kubernetes_tpu/controllers/disruption.py); it lists the budgets with
Store.list, the copies the reference's iter_kind makes.
"""

from __future__ import annotations

import time

from ..api.types import PodDisruptionBudget
from .base import Controller

# disruption.go DeletionTimeout: an eviction recorded in DisruptedPods that
# never turned into a delete stops counting against the budget
DISRUPTED_POD_TIMEOUT_S = 120.0


class DisruptionController(Controller):
    name = "disruption"
    watches = ("PodDisruptionBudget", "Pod")

    def _make_handler(self, kind: str):
        if kind != "Pod":
            return super()._make_handler(kind)

        def handler(etype, old, new):
            # BOTH the old and new pod shapes matter: a relabel that stops
            # matching a PDB must still re-reconcile that PDB (its healthy
            # count just dropped) — matching only the new labels would
            # leave disruptions_allowed overstated forever
            for obj in (old, new):
                if obj is not None:
                    self._enqueue_matching_pdbs(obj)

        return handler

    def _enqueue_matching_pdbs(self, pod) -> None:
        """getPdbForPod: every same-namespace PDB whose selector matches."""
        for pdb in self.store.list("PodDisruptionBudget")[0]:
            if pdb.meta.namespace != pod.meta.namespace:
                continue
            sel = pdb.spec.selector
            if sel is not None and sel.matches(pod.meta.labels):
                self.queue.add(pdb.meta.key)

    def key_of(self, kind: str, obj) -> str | None:
        # only PDB events reach the base handler ("Pod" has its own above)
        return obj.meta.key

    def reconcile(self, key: str) -> None:
        pdb = self.store.try_get("PodDisruptionBudget", key)
        if pdb is None:
            return
        sel = pdb.spec.selector
        matching = []
        if sel is not None:
            for pod in self.store.pods():
                if (pod.meta.namespace == pdb.meta.namespace
                        and sel.matches(pod.meta.labels)):
                    matching.append(pod)
        expected = len(matching)
        # healthy = running (bound) and not terminating (disruption.go
        # countHealthyPods; we have no readiness, bound is our "healthy")
        healthy = sum(1 for p in matching
                      if p.spec.node_name and not p.is_terminating)
        if pdb.spec.min_available is not None:
            desired = min(pdb.spec.min_available, expected)
        elif pdb.spec.max_unavailable is not None:
            desired = max(expected - pdb.spec.max_unavailable, 0)
        else:
            desired = expected  # no budget field: nothing may be disrupted
        now = time.time()
        disrupted = {
            name: ts for name, ts in pdb.status.disrupted_pods.items()
            if now - ts < DISRUPTED_POD_TIMEOUT_S
            and any(p.meta.name == name for p in matching)
        }
        allowed = max(healthy - desired - len(disrupted), 0)
        st = pdb.status
        if (st.disruptions_allowed == allowed and st.current_healthy == healthy
                and st.desired_healthy == desired and st.expected_pods == expected
                and st.disrupted_pods == disrupted):
            return
        st.disruptions_allowed = allowed
        st.current_healthy = healthy
        st.desired_healthy = desired
        st.expected_pods = expected
        st.disrupted_pods = disrupted
        self.store.update(pdb, check_version=False)


__all__ = ["DisruptionController", "PodDisruptionBudget"]
