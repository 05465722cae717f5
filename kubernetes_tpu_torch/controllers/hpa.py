"""HorizontalPodAutoscaler controller.

Reference: pkg/controller/podautoscaler (horizontal.go reconcileAutoscaler
+ replica_calculator.go): desired = ceil(current * actualUtilization /
targetUtilization), clamped to [min, max], with scale-down stabilization —
the applied recommendation is the HIGHEST desired over the stabilization
window, so a brief dip never flaps a deployment down. Utilization is
usage/requests over the target's pods, from PodMetrics objects (the
metrics.k8s.io role; published by the kubelet's stats or the test/bench
harness).

A copy of the reference package's module
(kubernetes_tpu/controllers/hpa.py).
"""

from __future__ import annotations

import math

from ..api.quantity import parse_cpu
from ..store import iter_kind
from .base import Controller


class HPAController(Controller):
    name = "horizontalpodautoscaler"
    watches = ("HorizontalPodAutoscaler", "PodMetrics")

    # tolerance around target before acting (horizontal.go: 0.1)
    TOLERANCE = 0.1

    clocked_queue = True  # stabilization-expiry self-requeues

    def __init__(self, store, informers=None, clock=None):
        super().__init__(store, informers, clock=clock)
        # hpa key → [(time, desired)] recommendations inside the window
        self._recommendations: dict[str, list[tuple[float, int]]] = {}

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "HorizontalPodAutoscaler":
            return obj.meta.key
        # metrics updates re-evaluate every HPA in that namespace (cheap:
        # HPAs are few); the reference resyncs on a 15s period instead
        for hpa in iter_kind(self.store, "HorizontalPodAutoscaler"):
            if hpa.meta.namespace == obj.meta.namespace:
                self.queue.add(hpa.meta.key)
        return None

    def sweep(self) -> None:
        for hpa in iter_kind(self.store, "HorizontalPodAutoscaler"):
            self.queue.add(hpa.meta.key)

    def reconcile(self, key: str) -> None:
        hpa = self.store.try_get("HorizontalPodAutoscaler", key)
        if hpa is None:
            self._recommendations.pop(key, None)
            return
        target = self.store.try_get(
            hpa.spec.scale_target_kind,
            f"{hpa.meta.namespace}/{hpa.spec.scale_target_name}",
        )
        if target is None:
            return
        pods = self._target_pods(hpa, target)
        # "current" is the ACTUAL replica count (scale.Status.Replicas in
        # horizontal.go), not spec.replicas: desired = ceil(actual * ratio)
        # stays a fixed point until the new pods (and their metrics) exist,
        # which is what keeps reconcile idempotent between metric samples
        current = len(pods)
        if current == 0:
            return
        utilization, n_sampled = self._utilization(pods)
        now = self.clock.now()
        changed = False
        if hpa.status.current_replicas != current:
            hpa.status.current_replicas = current
            changed = True
        if utilization is None:
            # no metrics yet: never scale on missing data (horizontal.go
            # treats missing metrics conservatively) — and report the
            # blindness instead of a stale confident number
            if hpa.status.current_cpu_utilization_percent is not None:
                hpa.status.current_cpu_utilization_percent = None
                changed = True
            if changed:
                self.store.update(hpa, check_version=False)
            return
        if hpa.status.current_cpu_utilization_percent != utilization:
            hpa.status.current_cpu_utilization_percent = utilization
            changed = True
        target_util = hpa.spec.target_cpu_utilization_percent
        ratio = utilization / target_util if target_util else 1.0
        missing = current - n_sampled
        if missing > 0:
            # replica_calculator.go missing-metric damping: when scaling UP
            # assume missing pods (fresh replicas) use 0%, when scaling
            # DOWN assume they use 100% — never let blind spots amplify
            if ratio > 1.0:
                ratio = (utilization * n_sampled / current) / target_util
            elif ratio < 1.0:
                ratio = ((utilization * n_sampled + 100 * missing)
                         / current) / target_util
        if abs(ratio - 1.0) <= self.TOLERANCE:
            desired = current
        else:
            desired = math.ceil(current * ratio)
        desired = max(hpa.spec.min_replicas,
                      min(hpa.spec.max_replicas, desired))
        # scale-down stabilization: remember this recommendation, apply the
        # window max (scale-UP applies immediately by construction: the max
        # includes the new high recommendation)
        recs = self._recommendations.setdefault(key, [])
        recs.append((now, desired))
        cutoff = now - hpa.spec.scale_down_stabilization_s
        recs[:] = [(t, d) for t, d in recs if t >= cutoff]
        applied = max(d for _, d in recs)
        if applied > desired and recs:
            # pinned above the live recommendation: revisit when the
            # pinning entries leave the window (no metric event will fire
            # for steady usage, so this wake-up is the only path down)
            oldest_pin = min(t for t, d in recs if d == applied)
            self.queue.add_after(
                key, max(0.1, oldest_pin + hpa.spec.scale_down_stabilization_s
                         - now + 0.1)
            )
        if hpa.status.desired_replicas != applied:
            hpa.status.desired_replicas = applied
            changed = True
        # compare against the KNOB we own (scale.Spec.Replicas): comparing
        # against the actual pod count would rewrite the target every
        # reconcile until the workload controller catches up
        if applied != target.spec.replicas:
            target.spec.replicas = applied
            self.store.update(target, check_version=False)
            hpa.status.last_scale_time = now
            changed = True
        if changed:
            self.store.update(hpa, check_version=False)

    # -- helpers -------------------------------------------------------------

    def _target_pods(self, hpa, target) -> list:
        sel = getattr(target.spec, "selector", None)
        if sel is not None and getattr(sel, "match_labels", None):
            labels = dict(sel.match_labels)  # tuple-of-pairs → dict
        else:
            labels = dict(target.spec.template.labels)
        if not labels:
            return []
        from ..api.labels import labels_subset

        return [
            p for p in self.store.pods()
            if p.meta.namespace == hpa.meta.namespace
            and labels_subset(labels, p.meta.labels)
            and not p.is_terminating
        ]

    def _utilization(self, pods) -> tuple[int | None, int]:
        """(mean usage/request percent over pods WITH metrics, sample
        count); (None, 0) if no pod has both a request and a sample."""
        ratios = []
        for p in pods:
            request = sum(
                parse_cpu(c.requests["cpu"])
                for c in p.spec.containers if "cpu" in c.requests
            )
            if request <= 0:
                continue
            m = self.store.try_get("PodMetrics", p.meta.key)
            if m is None:
                continue
            ratios.append(100.0 * m.cpu_usage_milli / request)
        if not ratios:
            return None, 0
        return int(round(sum(ratios) / len(ratios))), len(ratios)
