"""Workload controllers: ReplicaSet, Deployment, Job.

Reference: pkg/controller/replicaset/replica_set.go (syncReplicaSet,
manageReplicas), pkg/controller/deployment/ (syncDeployment, rolling.go),
pkg/controller/job/job_controller.go (syncJob). Each reconciles one object
key against the pods it owns (ownerReferences-based adoption, the
ControllerRefManager pattern).

A copy of the reference package's module
(kubernetes_tpu/controllers/workloads.py).
"""

from __future__ import annotations

import hashlib

from ..api.meta import ObjectMeta, OwnerReference
from ..api.types import Pod, PodSpec, SUCCEEDED, FAILED, RUNNING
from ..api.workloads import (
    Deployment,
    ReplicaSet,
    ReplicaSetSpec,
    ReplicaSetStatus,
)
from ..api.labels import LabelSelector
from ..store.store import NotFoundError
from ..utils import faultinject
from ..store import iter_kind
from .base import Controller


def _owned_by(obj, owner_uid: str) -> bool:
    return any(r.uid == owner_uid and r.controller for r in obj.meta.owner_references)


def _controller_ref(owner) -> OwnerReference:
    return OwnerReference(
        kind=owner.kind, name=owner.meta.name, uid=owner.meta.uid, controller=True
    )


def _clone_pod_spec(template) -> PodSpec:
    import copy

    return copy.deepcopy(template.spec)


class ReplicaSetController(Controller):
    """replica_set.go — converge owned-pod count to spec.replicas."""

    name = "replicaset"
    watches = ("ReplicaSet", "Pod")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "ReplicaSet":
            return obj.meta.key
        for ref in obj.meta.owner_references:
            if ref.kind == "ReplicaSet" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    def _active_owned_pods(self, rs: ReplicaSet) -> list[Pod]:
        return [
            p for p in self.store.pods()
            if p.meta.namespace == rs.meta.namespace
            and _owned_by(p, rs.meta.uid)
            and p.status.phase not in (SUCCEEDED, FAILED)
            and not p.is_terminating
        ]

    def _adopt_orphans(self, rs: ReplicaSet) -> None:
        """ControllerRefManager adoption: a selector-matching pod with no
        controller owner gains this ReplicaSet's controllerRef (so manually
        created or orphaned pods count toward replicas instead of being
        doubled up)."""
        sel = rs.spec.selector
        if sel is None or sel.empty:
            return
        for p in self.store.pods():
            if p.meta.namespace != rs.meta.namespace or p.is_terminating:
                continue
            if p.status.phase in (SUCCEEDED, FAILED):
                continue  # FilterActivePods: finished pods stay orphans
            if any(r.controller for r in p.meta.owner_references):
                continue
            if not sel.matches(p.meta.labels):
                continue
            p.meta.owner_references = list(p.meta.owner_references) + [
                _controller_ref(rs)
            ]
            self.store.update(p, check_version=False)

    def reconcile(self, key: str) -> None:
        # chaos: workload reconciles degrade — ERROR raises directly and
        # DROP is promoted to a raise, so both land on the base class's
        # rate-limited requeue: convergence is delayed, never lost
        # (replica math is re-derived from live state each run)
        if faultinject.fire("controller.workloads"):
            raise faultinject.TransientFault("controller.workloads: dropped")
        try:
            rs = self.store.get("ReplicaSet", key)
        except NotFoundError:
            return  # GC deletes the orphans
        self._adopt_orphans(rs)
        pods = self._active_owned_pods(rs)
        diff = rs.spec.replicas - len(pods)
        if diff > 0:
            from ..api.meta import new_uid

            for _ in range(diff):
                # generateName semantics: unique suffix, never a collision
                # with a pod that existed before (pod-template-hash pattern)
                suffix = new_uid().rsplit("-", 1)[-1]
                pod = Pod(
                    meta=ObjectMeta(
                        name=f"{rs.meta.name}-{suffix}",
                        namespace=rs.meta.namespace,
                        labels=dict(rs.spec.template.labels),
                        owner_references=[_controller_ref(rs)],
                    ),
                    spec=_clone_pod_spec(rs.spec.template),
                )
                self.store.create(pod)
        elif diff < 0:
            # scale down: prefer unscheduled, then newest (getPodsToDelete rank)
            pods.sort(key=lambda p: (bool(p.spec.node_name), -p.meta.resource_version))
            for p in pods[: -diff]:
                self.store.delete("Pod", p.meta.key)
        new_status = ReplicaSetStatus(
            replicas=max(len(pods) + diff, 0) if diff > 0 else rs.spec.replicas,
            ready_replicas=sum(1 for p in pods if p.status.phase == RUNNING),
            observed_generation=rs.meta.generation,
        )
        # status writes only on change — an unconditional update would emit a
        # MODIFIED event that re-enqueues this key forever
        if new_status != rs.status:
            rs.status = new_status
            self.store.update(rs, check_version=False)


REVISION_ANNOTATION = "deployment.kubernetes.io/revision"


def _template_hash(dep: Deployment) -> str:
    import json

    from ..api.serialization import encode

    payload = json.dumps(encode(dep.spec.template), sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:10]


class DeploymentController(Controller):
    """deployment controller — one ReplicaSet per template hash; template
    changes roll GRADUALLY per rolling.go: the new RS surges up to
    replicas+maxSurge total, old RSes scale down only as far as
    availability allows (available - (replicas - maxUnavailable)), so a
    roll never dips below the availability floor. Recreate tears the old
    RSes fully down before the new one scales up. "Available" uses the
    same pragmatic definition as the StatefulSet controller: scheduled and
    not terminating (Running when a kubelet reports it)."""

    name = "deployment"
    watches = ("Deployment", "ReplicaSet")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "Deployment":
            return obj.meta.key
        for ref in obj.meta.owner_references:
            if ref.kind == "Deployment" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    def reconcile(self, key: str) -> None:
        if faultinject.fire("controller.workloads"):  # chaos: see ReplicaSet
            raise faultinject.TransientFault("controller.workloads: dropped")
        try:
            dep = self.store.get("Deployment", key)
        except NotFoundError:
            return
        want_hash = _template_hash(dep)
        want_name = f"{dep.meta.name}-{want_hash}"
        owned = [
            rs for rs in iter_kind(self.store, "ReplicaSet")
            if rs.meta.namespace == dep.meta.namespace and _owned_by(rs, dep.meta.uid)
        ]
        new_rs = next((rs for rs in owned if rs.meta.name == want_name), None)
        if dep.spec.paused:
            # rollout paused (syncDeployment's paused branch): no new RS,
            # no rolling — but pure scaling still applies: distribute the
            # TOTAL-vs-desired delta across live RSes newest-first (clamped
            # at 0), so a mid-roll pause keeps sum(replicas) == desired
            # instead of inflating the largest RS to desired on its own
            by_newest = sorted(
                owned,
                key=lambda r: int(
                    r.meta.annotations.get(REVISION_ANNOTATION, 0)),
                reverse=True,
            )
            delta = dep.spec.replicas - sum(r.spec.replicas for r in by_newest)
            for rs in by_newest:
                if delta == 0:
                    break
                step = max(delta, -rs.spec.replicas)
                if step:
                    rs.spec.replicas += step
                    self.store.update(rs, check_version=False)
                    delta -= step
            self._write_status(dep, new_rs, owned)
            return
        if new_rs is None:
            labels = dict(dep.spec.template.labels)
            labels["pod-template-hash"] = want_hash
            template = type(dep.spec.template)(
                labels=labels, spec=_clone_pod_spec(dep.spec.template)
            )
            # revision bookkeeping (deployment.kubernetes.io/revision):
            # each new template gets the next revision number; old RSes
            # stay (scaled to 0) as rollback targets
            next_rev = 1 + max(
                (int(rs.meta.annotations.get(REVISION_ANNOTATION, 0))
                 for rs in owned),
                default=0,
            )
            new_rs = ReplicaSet(
                meta=ObjectMeta(
                    name=want_name,
                    namespace=dep.meta.namespace,
                    labels=labels,
                    annotations={REVISION_ANNOTATION: str(next_rev)},
                    owner_references=[_controller_ref(dep)],
                ),
                spec=ReplicaSetSpec(
                    replicas=0,  # the rolling step below surges it up
                    selector=LabelSelector.of(labels),
                    template=template,
                ),
            )
            self.store.create(new_rs)
            if dep.meta.annotations.get(REVISION_ANNOTATION) != str(next_rev):
                dep.meta.annotations[REVISION_ANNOTATION] = str(next_rev)
                self.store.update(dep, check_version=False)
        else:
            # rolling BACK to an existing RS (rollout undo): the reference
            # bumps that RS to a fresh max revision, so history shows the
            # rollback as a new step and a second undo returns to where we
            # came from — a stale annotation would make undo a no-op
            max_rev = max(
                (int(rs.meta.annotations.get(REVISION_ANNOTATION, 0))
                 for rs in owned),
                default=0,
            )
            cur_rev = int(new_rs.meta.annotations.get(REVISION_ANNOTATION, 0))
            if cur_rev < max_rev:
                new_rev = str(max_rev + 1)
                new_rs.meta.annotations[REVISION_ANNOTATION] = new_rev
                dep.meta.annotations[REVISION_ANNOTATION] = new_rev
                self.store.update(dep, check_version=False)
                if new_rs.spec.replicas == dep.spec.replicas:
                    self.store.update(new_rs, check_version=False)
        _deployment_roll(self.store, dep, new_rs,
                         [rs for rs in owned if rs.meta.name != want_name])
        self._write_status(dep, new_rs, owned)

    def _write_status(self, dep, new_rs, owned) -> None:
        from ..api.workloads import DeploymentStatus

        new_status = DeploymentStatus(
            replicas=dep.spec.replicas,
            updated_replicas=new_rs.spec.replicas if new_rs else 0,
            # readiness counts every live RS: mid-roll (or paused mid-roll)
            # part of the pods live in old RSes; rollout-status completion
            # still gates on updated_replicas, so this can't fire early
            ready_replicas=sum(r.status.ready_replicas for r in owned),
            observed_generation=dep.meta.generation,
        )
        if new_status != dep.status:
            dep.status = new_status
            self.store.update(dep, check_version=False)


def _available_pods(store, rs) -> int:
    """Pods of this RS counted as available: scheduled and not terminating
    (Running when a kubelet reports phases) — the pragmatic availability
    the StatefulSet controller uses too."""
    return sum(
        1 for p in store.pods()
        if p.meta.namespace == rs.meta.namespace
        and _owned_by(p, rs.meta.uid)
        and bool(p.spec.node_name)
        and not p.is_terminating
        and p.status.phase not in (SUCCEEDED, FAILED)
    )


def _deployment_roll(store, dep, new_rs, olds) -> None:
    """rolling.go's two moves: surge the new RS, scale old ones down only
    as availability allows."""
    strategy = dep.spec.strategy
    desired = dep.spec.replicas
    if strategy.type == "Recreate":
        # tear old down fully, then bring the new RS up
        for rs in olds:
            if rs.spec.replicas != 0:
                rs.spec.replicas = 0
                store.update(rs, check_version=False)
        old_gone = all(
            _available_pods(store, rs) == 0 and rs.spec.replicas == 0
            for rs in olds
        )
        target = desired if old_gone else new_rs.spec.replicas
        if new_rs.spec.replicas != target:
            new_rs.spec.replicas = target
            store.update(new_rs, check_version=False)
        return
    # RollingUpdate: surge the new RS within replicas+maxSurge total
    # (reconcileNewReplicaSet), then scale old RSes down only as far as
    # availability allows (reconcileOldReplicaSets)
    surge = max(strategy.max_surge,
                1 if strategy.max_unavailable == 0 else 0)
    total = new_rs.spec.replicas + sum(rs.spec.replicas for rs in olds)
    max_total = desired + surge
    if new_rs.spec.replicas < desired and total < max_total:
        new_rs.spec.replicas = min(
            desired, new_rs.spec.replicas + (max_total - total)
        )
        store.update(new_rs, check_version=False)
    elif new_rs.spec.replicas > desired:
        new_rs.spec.replicas = desired
        store.update(new_rs, check_version=False)
    # cleanupUnhealthyReplicas (rolling.go): old replicas that never became
    # available cost nothing to remove — without this, one permanently
    # pending old pod wedges the entire roll at the availability floor
    for rs in sorted(olds, key=lambda r: r.meta.name):
        if rs.spec.replicas == 0:
            continue
        unhealthy = rs.spec.replicas - _available_pods(store, rs)
        if unhealthy > 0:
            rs.spec.replicas = max(0, rs.spec.replicas - unhealthy)
            store.update(rs, check_version=False)
    available = _available_pods(store, new_rs) + sum(
        _available_pods(store, rs) for rs in olds
    )
    min_available = desired - strategy.max_unavailable
    budget = available - min_available
    for rs in sorted(olds, key=lambda r: r.meta.name):
        if budget <= 0:
            break
        if rs.spec.replicas == 0:
            continue
        down = min(rs.spec.replicas, budget)
        rs.spec.replicas -= down
        budget -= down
        store.update(rs, check_version=False)


class JobController(Controller):
    """job_controller.go syncJob — run `parallelism` pods at a time until
    `completions` have succeeded."""

    name = "job"
    watches = ("Job", "Pod")
    clocked_queue = True  # activeDeadlineSeconds wakeups ride the clock

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "Job":
            return obj.meta.key
        for ref in obj.meta.owner_references:
            if ref.kind == "Job" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    def reconcile(self, key: str) -> None:
        if faultinject.fire("controller.workloads"):  # chaos: see ReplicaSet
            raise faultinject.TransientFault("controller.workloads: dropped")
        try:
            job = self.store.get("Job", key)
        except NotFoundError:
            return
        owned = [
            p for p in self.store.pods()
            if p.meta.namespace == job.meta.namespace and _owned_by(p, job.meta.uid)
        ]
        succeeded = sum(1 for p in owned if p.status.phase == SUCCEEDED)
        failed = sum(1 for p in owned if p.status.phase == FAILED)
        active = [
            p for p in owned
            if p.status.phase not in (SUCCEEDED, FAILED) and not p.is_terminating
        ]
        import copy

        old_status = copy.copy(job.status)
        job.status.active = len(active)
        job.status.succeeded = succeeded
        job.status.failed = failed
        if job.status.start_time is None:
            job.status.start_time = self.clock.now()
        # batch/v1 activeDeadlineSeconds (job_controller syncJob past-
        # deadline): the whole job fails once it has run too long
        deadline = job.spec.active_deadline_seconds
        if (deadline is not None and not job.status.completed
                and not job.status.failure_reason):
            elapsed = self.clock.now() - job.status.start_time
            if elapsed >= deadline:
                job.status.failure_reason = "DeadlineExceeded"
                for p in active:
                    self.store.delete("Pod", p.meta.key)
                job.status.active = 0
                if job.status != old_status:
                    self.store.update(job, check_version=False)
                return
            # wake exactly at the deadline (clocked delayed queue)
            self.queue.add_after(key, deadline - elapsed + 0.1)
        if job.status.failure_reason:
            return  # terminally failed: never mint replacement pods
        if succeeded >= job.spec.completions:
            job.status.completed = True
            if job.status.completion_time is None:
                job.status.completion_time = self.clock.now()
            for p in active:
                self.store.delete("Pod", p.meta.key)
            if job.status != old_status:
                self.store.update(job, check_version=False)
            return
        if failed > job.spec.backoff_limit:
            # terminal failure (job_controller.go syncJob BackoffLimitExceeded):
            # stop replacing pods and tear down the active ones. The reason
            # is PERMANENT (batch/v1 Failed condition): even if the failed
            # pods are later GC'd, the job must not resurrect
            job.status.failure_reason = "BackoffLimitExceeded"
            for p in active:
                self.store.delete("Pod", p.meta.key)
            job.status.active = 0
            if job.status != old_status:
                self.store.update(job, check_version=False)
            return
        want_active = min(
            job.spec.parallelism, job.spec.completions - succeeded
        )
        from ..api.meta import new_uid

        for _ in range(want_active - len(active)):
            pod = Pod(
                meta=ObjectMeta(
                    name=f"{job.meta.name}-{new_uid().rsplit('-', 1)[-1]}",
                    namespace=job.meta.namespace,
                    labels=dict(job.spec.template.labels),
                    owner_references=[_controller_ref(job)],
                ),
                spec=_clone_pod_spec(job.spec.template),
            )
            pod.spec.restart_policy = "Never"
            self.store.create(pod)
        if job.status != old_status:
            self.store.update(job, check_version=False)


class StatefulSetController(Controller):
    """pkg/controller/statefulset — stable pod identity with ordered
    rollout: pods are named <set>-0 .. <set>-(replicas-1); under the
    default OrderedReady policy ordinal i+1 is only created once ordinal i
    is scheduled-and-running, scale-down removes the highest ordinal first,
    and a deleted ordinal is recreated under the SAME name (the stable
    network identity the reference guarantees via the headless service)."""

    name = "statefulset"
    watches = ("StatefulSet", "Pod")

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "StatefulSet":
            return obj.meta.key
        for ref in obj.meta.owner_references:
            if ref.kind == "StatefulSet" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    @staticmethod
    def _ordinal(set_name: str, pod_name: str) -> int | None:
        prefix = f"{set_name}-"
        if not pod_name.startswith(prefix):
            return None
        tail = pod_name[len(prefix):]
        return int(tail) if tail.isdigit() else None

    def _pod_running(self, pod: Pod) -> bool:
        # no kubelet in-process: scheduled == as-running-as-it-gets (the
        # hollow kubelet flips phase when present)
        return bool(pod.spec.node_name) and not pod.is_terminating

    def reconcile(self, key: str) -> None:
        if faultinject.fire("controller.workloads"):  # chaos: see ReplicaSet
            raise faultinject.TransientFault("controller.workloads: dropped")
        try:
            st = self.store.get("StatefulSet", key)
        except NotFoundError:
            return
        from ..api.workloads import StatefulSetStatus

        owned: dict[int, Pod] = {}
        for p in self.store.pods():
            if p.meta.namespace != st.meta.namespace or not _owned_by(p, st.meta.uid):
                continue
            if p.is_terminating:
                continue
            o = self._ordinal(st.meta.name, p.meta.name)
            if o is not None:
                owned[o] = p

        ordered = st.spec.pod_management_policy != "Parallel"
        # scale down highest-ordinal-first (the reference deletes one at a
        # time under OrderedReady; one per reconcile converges the same way)
        excess = sorted((o for o in owned if o >= st.spec.replicas), reverse=True)
        for o in excess:
            self.store.delete("Pod", owned[o].meta.key)
            del owned[o]
            if ordered:
                break

        # create missing ordinals in order; OrderedReady waits for the
        # predecessor to be running before minting the successor
        for o in range(st.spec.replicas):
            if o in owned:
                if ordered and not self._pod_running(owned[o]):
                    break
                continue
            labels = dict(st.spec.template.labels)
            labels["statefulset.kubernetes.io/pod-name"] = f"{st.meta.name}-{o}"
            pod = Pod(
                meta=ObjectMeta(
                    name=f"{st.meta.name}-{o}",
                    namespace=st.meta.namespace,
                    labels=labels,
                    owner_references=[_controller_ref(st)],
                ),
                spec=_clone_pod_spec(st.spec.template),
            )
            self._attach_claims(st, o, pod)
            self.store.create(pod)
            if ordered:
                break  # next ordinal waits for this one to run

        new_status = StatefulSetStatus(
            replicas=len(owned),
            ready_replicas=sum(1 for p in owned.values()
                               if self._pod_running(p)),
            observed_generation=st.meta.generation,
        )
        if new_status != st.status:
            st.status = new_status
            self.store.update(st, check_version=False)

    def _attach_claims(self, st, ordinal: int, pod: Pod) -> None:
        """volumeClaimTemplates → per-ordinal PVC <tpl>-<set>-<ordinal>,
        created once and REUSED by a recreated ordinal (stable storage:
        the PVC deliberately carries no owner ref to the pod; the
        reference keeps it until the set's PVC retention policy says
        otherwise)."""
        import copy

        from ..api.storage import Volume

        for tpl in st.spec.volume_claim_templates:
            claim_name = f"{tpl.meta.name}-{st.meta.name}-{ordinal}"
            claim_key = f"{st.meta.namespace}/{claim_name}"
            if self.store.try_get("PersistentVolumeClaim", claim_key) is None:
                claim = copy.deepcopy(tpl)
                claim.meta.name = claim_name
                claim.meta.namespace = st.meta.namespace
                claim.meta.uid = ""
                claim.meta.resource_version = 0
                claim.meta.owner_references = [_controller_ref(st)]
                self.store.create(claim)
            pod.spec.volumes = tuple(pod.spec.volumes) + (
                Volume(name=tpl.meta.name,
                       persistent_volume_claim=claim_name),
            )


class DaemonSetController(Controller):
    """pkg/controller/daemon — one pod per eligible node. Pods are pinned
    to their node with required node affinity on metadata.name (the modern
    daemon controller delegates placement to the SCHEDULER instead of
    setting spec.nodeName, daemon/daemon_controller.go) and get the
    controller's node.kubernetes.io/unschedulable toleration so cordoned
    nodes keep their daemons."""

    name = "daemonset"
    watches = ("DaemonSet", "Pod", "Node")
    clocked_queue = True  # roll-grace-expiry self-requeues ride the clock
    # a rolling replacement unavailable this long stops counting against
    # the maxUnavailable budget (see reconcile)
    ROLL_STUCK_GRACE_S = 60.0

    def key_of(self, kind: str, obj) -> str | None:
        if kind == "DaemonSet":
            return obj.meta.key
        if kind == "Node":
            # node churn re-reconciles every daemonset
            for ds in iter_kind(self.store, "DaemonSet"):
                self.queue.add(ds.meta.key)
            return None
        for ref in obj.meta.owner_references:
            if ref.kind == "DaemonSet" and ref.controller:
                return f"{obj.meta.namespace}/{ref.name}"
        return None

    @staticmethod
    def _daemon_pod_spec(ds, node_name: str) -> PodSpec:
        from ..api.types import (
            Affinity,
            NodeAffinity,
            NodeSelector,
            NodeSelectorRequirement,
            NodeSelectorTerm,
            Toleration,
        )

        spec = _clone_pod_spec(ds.spec.template)
        # ReplaceDaemonSetPodNodeNameNodeAffinity: pin via required node
        # affinity on the node FIELD, scheduled by the scheduler
        spec.affinity = Affinity(node_affinity=NodeAffinity(
            required=NodeSelector(terms=(NodeSelectorTerm(
                match_fields=(NodeSelectorRequirement(
                    key="metadata.name", operator="In", values=(node_name,)
                ),),
            ),)),
        ))
        # AddOrUpdateDaemonPodTolerations: daemons ride out node pressure —
        # unschedulable spec, and the lifecycle controller's unreachable/
        # not-ready NoExecute taints (otherwise a daemon evicted from a
        # flapping node mints a replacement that can never schedule there)
        spec.tolerations = tuple(spec.tolerations) + (
            Toleration(key="node.kubernetes.io/unschedulable",
                       operator="Exists", effect="NoSchedule"),
            Toleration(key="node.kubernetes.io/unreachable",
                       operator="Exists", effect="NoExecute"),
            Toleration(key="node.kubernetes.io/not-ready",
                       operator="Exists", effect="NoExecute"),
        )
        return spec

    def _eligible(self, ds, node) -> bool:
        # template-level node selection: honor the template's nodeSelector
        # (spec.selector is pod OWNERSHIP, handled via owner references)
        tpl_sel = ds.spec.template.spec.node_selector
        if tpl_sel and any(node.meta.labels.get(k) != v for k, v in tpl_sel.items()):
            return False
        return True

    def reconcile(self, key: str) -> None:
        if faultinject.fire("controller.workloads"):  # chaos: see ReplicaSet
            raise faultinject.TransientFault("controller.workloads: dropped")
        try:
            ds = self.store.get("DaemonSet", key)
        except NotFoundError:
            return
        from ..api.workloads import DaemonSetStatus

        nodes = {n.meta.name: n for n in self.store.nodes()}
        eligible = {name for name, n in nodes.items() if self._eligible(ds, n)}
        by_node: dict[str, list[Pod]] = {}
        floating: list[Pod] = []
        for p in self.store.pods():
            if p.meta.namespace != ds.meta.namespace or not _owned_by(p, ds.meta.uid):
                continue
            target = p.meta.annotations.get("daemonset.kubernetes.io/node", "")
            if target:
                by_node.setdefault(target, []).append(p)
            else:
                floating.append(p)
        for p in floating:
            self.store.delete("Pod", p.meta.key)
        from ..api.meta import new_uid

        want_hash = _template_hash(ds)
        for name in sorted(eligible):
            pods = by_node.get(name, [])
            if not pods:
                pod = Pod(
                    meta=ObjectMeta(
                        name=f"{ds.meta.name}-{new_uid().rsplit('-', 1)[-1]}",
                        namespace=ds.meta.namespace,
                        labels=dict(ds.spec.template.labels),
                        annotations={
                            "daemonset.kubernetes.io/node": name,
                            "daemonset.kubernetes.io/template-hash": want_hash,
                        },
                        owner_references=[_controller_ref(ds)],
                    ),
                    spec=self._daemon_pod_spec(ds, name),
                )
                self.store.create(pod)
                # visible to the in-flight budget below: a node whose
                # replacement was minted THIS reconcile is already in
                # flight (otherwise the budget double-spends when a second
                # reconcile runs before the scheduler places the pod)
                by_node[name] = [pod]
            else:
                # at most one daemon per node; extra copies die
                for dup in pods[1:]:
                    self.store.delete("Pod", dup.meta.key)

        # RollingUpdate (daemon/update.go): replace stale-template daemons.
        # - stale AND unavailable daemons delete budget-free (removing them
        #   changes nothing for the node), so a sick node can't wedge the
        #   roll for healthy ones;
        # - the budget for killing AVAILABLE stale daemons is maxUnavailable
        #   minus replacements still in flight (new-hash pods not yet
        #   available) — that's what makes the roll one-node-at-a-time;
        # - a replacement stuck unavailable past ROLL_STUCK_GRACE_S ages out
        #   of the in-flight count (the reference excludes such nodes via
        #   shouldRun fit simulation; the grace approximates it), so the
        #   roll keeps moving. max_unavailable=0 genuinely freezes rolls of
        #   available daemons.
        def pod_available(p) -> bool:
            return bool(p.spec.node_name) and not p.is_terminating

        hash_key = "daemonset.kubernetes.io/template-hash"
        now = self.clock.now()
        in_flight = 0
        next_age_out = None  # earliest grace expiry among in-flight pods
        for name in eligible:
            pods = by_node.get(name, [])[:1]
            if not pods:
                continue
            p = pods[0]
            age = now - p.meta.creation_timestamp
            # negative age = clock skew between store and controller
            # clocks: fail OPEN (not in-flight) so the roll makes progress
            if (p.meta.annotations.get(hash_key) == want_hash
                    and not pod_available(p)
                    and 0 <= age < self.ROLL_STUCK_GRACE_S):
                in_flight += 1
                remain = self.ROLL_STUCK_GRACE_S - age
                if next_age_out is None or remain < next_age_out:
                    next_age_out = remain
        budget = ds.spec.max_unavailable - in_flight
        budget_blocked = False
        for name in sorted(eligible):
            pods = by_node.get(name, [])[:1]
            if not pods:
                continue
            pod = pods[0]
            if pod.meta.annotations.get(hash_key) == want_hash:
                continue
            if not pod_available(pod):
                self.store.delete("Pod", pod.meta.key)  # free
            elif budget > 0:
                self.store.delete("Pod", pod.meta.key)
                budget -= 1
            else:
                budget_blocked = True
        if budget_blocked and next_age_out is not None:
            # stale daemons remain only because replacements hold the
            # budget: wake when the first one ages out of the in-flight
            # count — no unrelated event is needed to resume the roll
            self.queue.add_after(key, next_age_out + 0.1)
        # pods for gone/ineligible nodes are removed
        for name, pods in by_node.items():
            if name not in eligible:
                for p in pods:
                    self.store.delete("Pod", p.meta.key)

        scheduled = sum(
            1 for name in eligible for p in by_node.get(name, [])[:1]
            if p.spec.node_name
        )
        new_status = DaemonSetStatus(
            desired_number_scheduled=len(eligible),
            current_number_scheduled=sum(1 for n in eligible if by_node.get(n)),
            number_ready=scheduled,
        )
        if new_status != ds.status:
            ds.status = new_status
            self.store.update(ds, check_version=False)
