"""Volume plugins: VolumeBinding (+ binder), VolumeRestrictions, VolumeZone,
NodeVolumeLimits.

Reference: pkg/scheduler/framework/plugins/volumebinding/ (volume_binding.go
PreFilter:360 Filter:424 Score:471 Reserve:531 PreBind:577 Unreserve:604;
binder.go FindPodVolumes/AssumePodVolumes/BindPodVolumes),
volumerestrictions/volume_restrictions.go:318 (ReadWriteOncePod conflicts),
volumezone/volume_zone.go:198 (PV zone-label vs node-label match), and
nodevolumelimits/csi.go:257 (CSI attach-limit counting).

TPU-first note: these are the "long tail" host-side plugins (SURVEY.md §7 —
sparse store lookups, tiny cardinalities). They compose with the dense device
kernel through the same framework API; only their Skip/Unschedulable verdicts
gate the kernel's candidate mask.

A copy of the reference package's module
(kubernetes_tpu/scheduler/plugins/volumes.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...api.storage import (
    CLAIM_BOUND,
    NO_PROVISIONER,
    READ_WRITE_ONCE_POD,
    VOLUME_BOUND,
    ZONE_LABELS,
    PersistentVolume,
    PersistentVolumeClaim,
    StorageClass,
    pod_claim_names,
)
from ...api.types import Pod
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE
from ..framework.interface import MAX_NODE_SCORE, Plugin, Status
from ..nodeinfo import NodeInfo

ERR_REASON_NOT_FOUND = "persistentvolumeclaim not found"
ERR_REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_REASON_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
ERR_REASON_RWOP_CONFLICT = (
    "node has pod using PersistentVolumeClaim with the same name and "
    "ReadWriteOncePod access mode"
)
ERR_REASON_ZONE_CONFLICT = "node(s) had no available volume zone"
ERR_REASON_MAX_VOLUME_COUNT = "node(s) exceed max volume count"


def _pvc_key(namespace: str, name: str) -> str:
    return f"{namespace}/{name}"


def _owned_by_pod(pvc, pod: Pod) -> bool:
    """component-helpers/storage/ephemeral VolumeIsForPod: the claim must be
    controller-owned by this pod."""
    return any(
        ref.kind == "Pod" and ref.name == pod.meta.name and ref.controller
        for ref in pvc.meta.owner_references
    )


# --- binder ----------------------------------------------------------------


@dataclass
class PodVolumes:
    """Per-(pod,node) binding decision (volumebinding PodVolumes)."""

    static_bindings: list[tuple[str, str]] = field(default_factory=list)  # (pv, pvc key)
    dynamic_provisions: list[str] = field(default_factory=list)  # pvc keys


@dataclass
class _ClaimsToBind:
    bound: list[PersistentVolumeClaim] = field(default_factory=list)
    unbound_delayed: list[PersistentVolumeClaim] = field(default_factory=list)


class VolumeBinder:
    """Topology-aware PV/PVC matcher + two-phase binding against the store.

    Reference: volumebinding/binder.go — FindPodVolumes enumerates candidate
    static PVs per node, AssumePodVolumes reserves them in an assume-cache,
    BindPodVolumes performs the API writes. In this single-process control
    plane the "PV controller wait" collapses to a direct store transaction.
    """

    def __init__(self, store):
        self.store = store
        # pv key -> pvc key reserved in-memory ahead of the PreBind API write
        self.assumed: dict[str, str] = {}

    # -- lookups ------------------------------------------------------------

    def get_claims(self, pod: Pod) -> tuple[_ClaimsToBind | None, Status | None]:
        """Split the pod's claims into bound / unbound-delayed; error statuses
        mirror volume_binding.go PreFilter:360."""
        out = _ClaimsToBind()
        ephemeral_claims = {
            v.claim_name(pod.meta.name)
            for v in pod.spec.volumes
            if v.ephemeral and not v.persistent_volume_claim
        }
        for name in pod_claim_names(pod):
            pvc = self.store.try_get(
                "PersistentVolumeClaim", _pvc_key(pod.meta.namespace, name)
            )
            if pvc is None:
                return None, Status.unresolvable(
                    f'{ERR_REASON_NOT_FOUND} "{name}"', plugin=VolumeBinding.name
                )
            if name in ephemeral_claims and not _owned_by_pod(pvc, pod):
                # ephemeral.VolumeIsForPod — a same-named foreign claim must
                # not be adopted by naming coincidence
                return None, Status.unresolvable(
                    f'PVC "{name}" was not created for pod "{pod.meta.name}"',
                    plugin=VolumeBinding.name,
                )
            if pvc.is_bound:
                out.bound.append(pvc)
                continue
            sc = self.store.try_get("StorageClass", pvc.spec.storage_class_name)
            if sc is not None and sc.is_wait_for_first_consumer:
                out.unbound_delayed.append(pvc)
            else:
                return None, Status.unresolvable(
                    ERR_REASON_UNBOUND_IMMEDIATE, plugin=VolumeBinding.name
                )
        return out, None

    def _pv_available(self, pv: PersistentVolume, pvc) -> bool:
        claimed = pv.spec.claim_ref or self.assumed.get(pv.meta.key, "")
        if claimed == "":
            return True
        if claimed != pvc.meta.key:
            return False
        # same key: the claimRef.uid must match the claim INSTANCE — a PV
        # still referencing a deleted-and-recreated same-named claim is
        # awaiting reclaim, not available (pv_controller.go uid check)
        return (not pv.spec.claim_ref_uid
                or pv.spec.claim_ref_uid == pvc.meta.uid)

    def _pv_matches(self, pv: PersistentVolume, pvc: PersistentVolumeClaim,
                    node_info: NodeInfo) -> bool:
        """pv_util CheckVolumeModeMismatches + FindMatchingVolume conditions."""
        if pv.spec.storage_class_name != pvc.spec.storage_class_name:
            return False
        if not set(pvc.spec.access_modes) <= set(pv.spec.access_modes):
            return False
        if pv.storage_capacity < pvc.requested_storage:
            return False
        return self.pv_fits_node(pv, node_info)

    def pv_fits_node(self, pv: PersistentVolume, node_info: NodeInfo) -> bool:
        if pv.spec.node_affinity is None:
            return True
        node = node_info.node
        return pv.spec.node_affinity.matches(node.meta.labels, {"metadata.name": node.meta.name})

    def list_candidate_pvs(self) -> list[PersistentVolume]:
        """One sorted PV listing per scheduling cycle (computed at PreFilter,
        reused by every per-node Filter — the input is node-independent).
        Shared refs, read-only: a deepcopy of every PV per pod cycle was
        the profile's top cost at 5k nodes."""
        pv_list = self.store.list_refs("PersistentVolume")
        # deterministic smallest-fit-first order (pv_util sorts by size)
        return sorted(pv_list, key=lambda p: (p.storage_capacity, p.meta.name))

    def candidates_for_claims(self, claims: _ClaimsToBind,
                              pv_list: list[PersistentVolume]) -> dict:
        """Per-claim availability prefilter (node-independent half of
        FindMatchingVolume): drops PVs bound to other claims once per cycle
        so the per-node scan touches only genuinely available volumes."""
        return {
            pvc.meta.key: [pv for pv in pv_list
                           if self._pv_available(pv, pvc)]
            for pvc in claims.unbound_delayed
        }

    def node_neutral_volumes(self, pod: Pod) -> PodVolumes | None:
        """The pod's volume decision when it provably CANNOT depend on the
        node — the batched wave's eligibility check (the wave kernel can't
        run per-node host plugins, so only pods whose entire volume stage
        is node-invariant may ride it). Returns None whenever any volume
        plugin would need per-node evaluation or the decision would fail
        (the hybrid path then produces the right status):

        - bound claims: PV must exist, carry no node affinity, no zone
          labels (VolumeZone), no CSI driver (NodeVolumeLimits)
        - no ReadWriteOncePod access modes anywhere (VolumeRestrictions)
        - each unbound WFFC claim's FIRST matching available candidate must
          be unpinned/zone-free/non-CSI — then every node chooses that same
          volume, so Filter passes everywhere and Score is a constant shift
          that cannot move the argmax or its tie set — or there must be a
          provisionable class (provisioning pins the new PV only AFTER node
          selection)."""
        claims, err = self.get_claims(pod)
        if err is not None or claims is None:
            return None
        volumes = PodVolumes()
        for pvc in claims.bound:
            if READ_WRITE_ONCE_POD in pvc.spec.access_modes:
                return None
            pv = self.store.try_get("PersistentVolume", pvc.spec.volume_name)
            if (pv is None or pv.spec.node_affinity is not None
                    or pv.spec.csi_driver
                    or any(k in pv.meta.labels for k in ZONE_LABELS)):
                return None
        pv_list = None
        taken: set[str] = set()
        for pvc in claims.unbound_delayed:
            if READ_WRITE_ONCE_POD in pvc.spec.access_modes:
                return None
            if pv_list is None:
                pv_list = self.list_candidate_pvs()
            chosen = None
            for pv in pv_list:
                if pv.meta.key in taken:
                    continue
                if not self._pv_available(pv, pvc):
                    continue
                if pv.spec.storage_class_name != pvc.spec.storage_class_name:
                    continue
                if not set(pvc.spec.access_modes) <= set(pv.spec.access_modes):
                    continue
                if pv.storage_capacity < pvc.requested_storage:
                    continue
                # the first otherwise-matching candidate decides: if it is
                # node-dependent in any way, per-node choices can diverge
                if (pv.spec.node_affinity is not None or pv.spec.csi_driver
                        or any(k in pv.meta.labels for k in ZONE_LABELS)):
                    return None
                chosen = pv
                break
            if chosen is not None:
                taken.add(chosen.meta.key)
                volumes.static_bindings.append(
                    (chosen.meta.key, pvc.meta.key)
                )
                continue
            sc = self.store.try_get(
                "StorageClass", pvc.spec.storage_class_name
            )
            if sc is None or sc.provisioner == NO_PROVISIONER:
                return None  # BIND_CONFLICT everywhere: hybrid reports it
            volumes.dynamic_provisions.append(pvc.meta.key)
        return volumes

    def find_pod_volumes(
        self,
        pod: Pod,
        claims: _ClaimsToBind,
        node_info: NodeInfo,
        pv_list: list[PersistentVolume] | None = None,
        by_claim: dict[str, list] | None = None,
        bound_pvs: list | None = None,
    ) -> tuple[PodVolumes, list[str]]:
        """binder.go FindPodVolumes — returns (decision, conflict reasons)."""
        reasons: list[str] = []
        volumes = PodVolumes()
        if bound_pvs is None:
            bound_pvs = [
                (pvc, self.store.try_get("PersistentVolume",
                                         pvc.spec.volume_name))
                for pvc in claims.bound
            ]
        for pvc, pv in bound_pvs:
            if pv is None or not self.pv_fits_node(pv, node_info):
                reasons.append(ERR_REASON_NODE_CONFLICT)
                return volumes, reasons
        for pvc in claims.unbound_delayed:
            if by_claim is not None:
                # availability-prefiltered at PreFilter (node-independent):
                # the per-node scan must not re-walk every already-bound PV
                # — at scale that was O(boundPVs × nodes) per pod
                cands = by_claim.get(pvc.meta.key, ())
            else:
                if pv_list is None:
                    pv_list = self.list_candidate_pvs()
                cands = pv_list
            chosen = None
            taken = {pv for pv, _ in volumes.static_bindings}
            for pv in cands:
                if pv.meta.key in taken:
                    continue
                if self._pv_available(pv, pvc) and self._pv_matches(
                    pv, pvc, node_info
                ):
                    chosen = pv
                    break
            if chosen is not None:
                volumes.static_bindings.append((chosen.meta.key, pvc.meta.key))
                continue
            sc = self.store.try_get("StorageClass", pvc.spec.storage_class_name)
            if sc is not None and sc.provisioner != NO_PROVISIONER:
                volumes.dynamic_provisions.append(pvc.meta.key)
            else:
                reasons.append(ERR_REASON_BIND_CONFLICT)
                return volumes, reasons
        return volumes, reasons

    # -- assume / bind / revert ---------------------------------------------

    def assume_pod_volumes(self, volumes: PodVolumes) -> None:
        for pv_key, pvc_key in volumes.static_bindings:
            self.assumed[pv_key] = pvc_key

    def revert_assumed_pod_volumes(self, volumes: PodVolumes) -> None:
        for pv_key, _ in volumes.static_bindings:
            self.assumed.pop(pv_key, None)

    def bind_pod_volumes(self, pod: Pod, volumes: PodVolumes,
                         node_name: str = "") -> Status:
        """binder.go BindPodVolumes — PV.claimRef + PVC.volumeName API writes
        (the reference then waits for the PV controller to ack; here the store
        write *is* the ack). node_name is the selected node: dynamically
        provisioned PVs get pinned to it, mirroring the provisioner honoring
        the volume.kubernetes.io/selected-node annotation."""
        try:
            for pv_key, pvc_key in volumes.static_bindings:
                pv = self.store.get("PersistentVolume", pv_key)
                pvc = self.store.get("PersistentVolumeClaim", pvc_key)
                pv.spec.claim_ref = pvc_key
                pv.spec.claim_ref_uid = pvc.meta.uid
                pv.status.phase = VOLUME_BOUND
                pvc.spec.volume_name = pv.meta.name
                pvc.status.phase = CLAIM_BOUND
                self.store.update(pv, check_version=False)
                self.store.update(pvc, check_version=False)
                self.assumed.pop(pv_key, None)
            for pvc_key in volumes.dynamic_provisions:
                pvc = self.store.get("PersistentVolumeClaim", pvc_key)
                pv = PersistentVolume()
                pv.meta.name = f"pvc-{pvc.meta.uid or pvc.meta.name}"
                pv.meta.namespace = ""
                pv.spec.storage_class_name = pvc.spec.storage_class_name
                pv.spec.access_modes = pvc.spec.access_modes
                pv.spec.capacity = dict(pvc.spec.request)
                pv.spec.claim_ref = pvc_key
                pv.spec.claim_ref_uid = pvc.meta.uid
                pv.status.phase = VOLUME_BOUND
                if node_name:
                    from ...api.types import (
                        NodeSelector,
                        NodeSelectorRequirement,
                        NodeSelectorTerm,
                    )

                    pv.spec.node_affinity = NodeSelector(
                        terms=(
                            NodeSelectorTerm(
                                match_expressions=(
                                    NodeSelectorRequirement(
                                        "kubernetes.io/hostname", "In", (node_name,)
                                    ),
                                )
                            ),
                        )
                    )
                sc = self.store.try_get("StorageClass", pvc.spec.storage_class_name)
                if sc is not None:
                    pv.spec.csi_driver = sc.provisioner
                self.store.create(pv)
                pvc.spec.volume_name = pv.meta.name
                pvc.status.phase = CLAIM_BOUND
                self.store.update(pvc, check_version=False)
        except Exception as e:  # noqa: BLE001 - surfaced as bind failure
            return Status.as_error(e, VolumeBinding.name)
        return Status()


# --- VolumeBinding plugin ---------------------------------------------------


class _BindingState:
    __slots__ = ("claims", "per_node", "pv_candidates", "by_claim",
                 "bound_pvs", "pv_by_key", "pvc_by_key")

    def __init__(self, claims: _ClaimsToBind, pv_candidates=None,
                 by_claim=None, bound_pvs=None):
        self.claims = claims
        self.pv_candidates: list | None = pv_candidates
        self.by_claim: dict | None = by_claim
        # bound claims' PVs prefetched once per cycle — the per-node Filter
        # and Score must not pay a store deepcopy per (pod, node)
        self.bound_pvs: list = bound_pvs or []
        self.pv_by_key: dict = {
            pv.meta.key: pv for pv in (pv_candidates or ())
        }
        for _, pv in self.bound_pvs:
            if pv is not None:
                self.pv_by_key.setdefault(pv.meta.key, pv)
        self.pvc_by_key: dict = {
            pvc.meta.key: pvc
            for pvc in claims.bound + claims.unbound_delayed
        }
        self.per_node: dict[str, PodVolumes] = {}


class VolumeBinding(Plugin):
    """volumebinding/volume_binding.go — topology-aware PV/PVC binding."""

    name = "VolumeBinding"
    STATE_KEY = "PreFilterVolumeBinding"

    def __init__(self, store, binder: VolumeBinder | None = None):
        self.binder = binder or VolumeBinder(store)

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.PVC, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.PV, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.STORAGE_CLASS, ev.ADD), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.CSI_NODE, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_LABEL), lambda *_: QUEUE),
        ]

    def pre_filter(self, state, pod: Pod, nodes):
        claims, err = self.binder.get_claims(pod)
        if err is not None:
            return None, err
        if not claims.bound and not claims.unbound_delayed:
            return None, Status.skip()
        candidates = (
            self.binder.list_candidate_pvs() if claims.unbound_delayed else []
        )
        by_claim = self.binder.candidates_for_claims(claims, candidates)
        bound_pvs = [
            (pvc, self.binder.store.try_get("PersistentVolume",
                                            pvc.spec.volume_name))
            for pvc in claims.bound
        ]
        state.write(self.STATE_KEY,
                    _BindingState(claims, candidates, by_claim, bound_pvs))
        return None, None

    def _state(self, state) -> _BindingState | None:
        return state.read(self.STATE_KEY)

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        s = self._state(state)
        if s is None:
            return Status()
        volumes, reasons = self.binder.find_pod_volumes(
            pod, s.claims, node_info, s.pv_candidates, by_claim=s.by_claim,
            bound_pvs=s.bound_pvs,
        )
        if reasons:
            # UnschedulableAndUnresolvable (volume_binding.go Filter): no
            # eviction changes PV node affinity, so preemption must not try
            return Status.unresolvable(*reasons, plugin=self.name)
        s.per_node[node_info.name] = volumes
        return Status()

    def filter_batch(self, state, pod: Pod, node_infos):
        """All-nodes Filter in one call (the host long-tail analogue of the
        dense kernel): the per-claim candidate scan is node-independent
        except for PV node affinity, so one ordered pass over candidates
        assigns every node its first matching volume — bit-identical to
        calling filter() per node, at O(candidates + nodes) instead of
        O(candidates x nodes). Returns None (-> per-node fallback) for
        multi-claim pods, whose within-pod taken-set interplay the
        vectorization doesn't model."""
        s = self._state(state)
        if s is None:
            return [None] * len(node_infos)
        if len(s.claims.unbound_delayed) > 1:
            return None
        n = len(node_infos)
        statuses: list[Status | None] = [None] * n
        conflict = None
        for pvc, pv in s.bound_pvs:
            if pv is None:
                conflict = Status.unresolvable(ERR_REASON_NODE_CONFLICT,
                                               plugin=self.name)
                return [conflict] * n
            if pv.spec.node_affinity is None:
                continue
            for i, ni in enumerate(node_infos):
                if statuses[i] is None and not self.binder.pv_fits_node(
                    pv, ni
                ):
                    if conflict is None:
                        conflict = Status.unresolvable(
                            ERR_REASON_NODE_CONFLICT, plugin=self.name)
                    statuses[i] = conflict
        if not s.claims.unbound_delayed:
            empty = PodVolumes()
            for i, ni in enumerate(node_infos):
                if statuses[i] is None:
                    s.per_node[ni.name] = empty
            return statuses

        pvc = s.claims.unbound_delayed[0]
        # node-independent half of _pv_matches, once per cycle
        cands = [
            pv for pv in (s.by_claim or {}).get(pvc.meta.key, ())
            if self.binder._pv_available(pv, pvc)
            and pv.spec.storage_class_name == pvc.spec.storage_class_name
            and set(pvc.spec.access_modes) <= set(pv.spec.access_modes)
            and pv.storage_capacity >= pvc.requested_storage
        ]
        remaining = [i for i in range(n) if statuses[i] is None]
        assignment: dict[int, PersistentVolume] = {}
        for pv in cands:
            if not remaining:
                break
            if pv.spec.node_affinity is None:
                for i in remaining:
                    assignment[i] = pv
                remaining = []
            else:
                still = []
                for i in remaining:
                    if self.binder.pv_fits_node(pv, node_infos[i]):
                        assignment[i] = pv
                    else:
                        still.append(i)
                remaining = still
        sc = self.binder.store.try_get(
            "StorageClass", pvc.spec.storage_class_name
        )
        prov = (PodVolumes(dynamic_provisions=[pvc.meta.key])
                if sc is not None and sc.provisioner != NO_PROVISIONER
                else None)
        bind_fail = None
        vol_cache: dict[str, PodVolumes] = {}
        for i, ni in enumerate(node_infos):
            if statuses[i] is not None:
                continue
            pv = assignment.get(i)
            if pv is not None:
                vol = vol_cache.get(pv.meta.key)
                if vol is None:
                    vol = PodVolumes(
                        static_bindings=[(pv.meta.key, pvc.meta.key)]
                    )
                    vol_cache[pv.meta.key] = vol
                s.per_node[ni.name] = vol
            elif prov is not None:
                s.per_node[ni.name] = prov
            else:
                if bind_fail is None:
                    bind_fail = Status.unresolvable(
                        ERR_REASON_BIND_CONFLICT, plugin=self.name)
                statuses[i] = bind_fail
        return statuses

    def score_batch(self, state, pod: Pod, node_infos) -> list[int]:
        """Score over all nodes at once; assignments sharing a PodVolumes
        share one capacity computation."""
        s = self._state(state)
        if s is None:
            return [0] * len(node_infos)
        cache: dict[int, int] = {}
        out = []
        for ni in node_infos:
            volumes = s.per_node.get(ni.name)
            if volumes is None or not volumes.static_bindings:
                out.append(0)
                continue
            key = id(volumes)
            val = cache.get(key)
            if val is None:
                total_req = total_cap = 0
                for pv_key, pvc_key in volumes.static_bindings:
                    pv = s.pv_by_key.get(pv_key)
                    pvc = s.pvc_by_key.get(pvc_key)
                    if pv is None or pvc is None:
                        continue
                    total_req += pvc.requested_storage
                    total_cap += pv.storage_capacity
                val = ((MAX_NODE_SCORE * total_req) // total_cap
                       if total_cap else 0)
                cache[key] = val
            out.append(val)
        return out

    def score(self, state, pod: Pod, node_info: NodeInfo):
        """Static-binding utilization shape: tighter fit scores higher
        (volume_binding.go Score:471 with the default shape — 0% util -> 0,
        100% util -> MaxNodeScore)."""
        s = self._state(state)
        if s is None:
            return 0, None
        volumes = s.per_node.get(node_info.name)
        if volumes is None or not volumes.static_bindings:
            return 0, None
        total_req = 0
        total_cap = 0
        for pv_key, pvc_key in volumes.static_bindings:
            # cycle-state lookups, NOT store gets: a deepcopy per
            # (pod, node) Score call dominated the 5k-node profile
            pv = s.pv_by_key.get(pv_key)
            pvc = s.pvc_by_key.get(pvc_key)
            if pv is None or pvc is None:
                continue
            total_req += pvc.requested_storage
            total_cap += pv.storage_capacity
        if total_cap == 0:
            return 0, None
        return (MAX_NODE_SCORE * total_req) // total_cap, None

    def reserve(self, state, pod: Pod, node_name: str) -> Status:
        s = self._state(state)
        if s is None:
            return Status()
        volumes = s.per_node.get(node_name)
        if volumes is None:
            return Status.as_error(
                RuntimeError(f"no volume decision for node {node_name}"), self.name
            )
        self.binder.assume_pod_volumes(volumes)
        return Status()

    def unreserve(self, state, pod: Pod, node_name: str) -> None:
        s = self._state(state)
        if s is None:
            return
        volumes = s.per_node.get(node_name)
        if volumes is not None:
            self.binder.revert_assumed_pod_volumes(volumes)

    def pre_bind_pre_flight(self, state, pod: Pod, node_name: str) -> Status:
        s = self._state(state)
        if s is None:
            return Status.skip()
        v = s.per_node.get(node_name)
        if v is None or (not v.static_bindings and not v.dynamic_provisions):
            return Status.skip()
        return Status()

    def pre_bind(self, state, pod: Pod, node_name: str) -> Status:
        s = self._state(state)
        if s is None:
            return Status()
        volumes = s.per_node.get(node_name)
        if volumes is None:
            return Status()
        return self.binder.bind_pod_volumes(pod, volumes, node_name)

    def sign(self, pod: Pod) -> str | None:
        """signers.go VolumeSigner — claim names identify volume topology."""
        return ",".join(sorted(pod_claim_names(pod)))


# --- VolumeRestrictions -----------------------------------------------------


class _RestrictionsState:
    """COW per-cycle RWOP conflict count (volume_restrictions.go
    preFilterState); clone() gives preemption dry-runs their own counter."""

    __slots__ = ("rwop_keys", "conflicts")

    def __init__(self, rwop_keys: frozenset, conflicts: int):
        self.rwop_keys = rwop_keys
        self.conflicts = conflicts

    def clone(self) -> "_RestrictionsState":
        return _RestrictionsState(self.rwop_keys, self.conflicts)


class VolumeRestrictions(Plugin):
    """volumerestrictions/volume_restrictions.go — ReadWriteOncePod access-mode
    conflicts (:318). Legacy in-tree disk (GCE PD / AWS EBS) double-attach
    checks are intentionally absent: those drivers are CSI-migrated in the
    reference snapshot."""

    name = "VolumeRestrictions"

    def __init__(self, store):
        self.store = store

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.ASSIGNED_POD, ev.DELETE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.PVC, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
        ]

    STATE_KEY = "PreFilterVolumeRestrictions"

    def pre_filter(self, state, pod: Pod, nodes):
        claim_names = pod_claim_names(pod)
        if not claim_names:
            return None, Status.skip()
        rwop_keys = set()
        for name in claim_names:
            key = _pvc_key(pod.meta.namespace, name)
            pvc = self.store.try_get("PersistentVolumeClaim", key)
            if pvc is None:
                return None, Status.unresolvable(
                    f'{ERR_REASON_NOT_FOUND} "{name}"', plugin=self.name
                )
            if READ_WRITE_ONCE_POD in pvc.spec.access_modes:
                rwop_keys.add(key)
        if not rwop_keys:
            return None, Status.skip()
        # cluster-wide holder count; AddPod/RemovePod keep it consistent in
        # preemption dry-runs so evicting the holder resolves the conflict
        conflicts = sum(
            ni.pvc_ref_counts.get(key, 0) for ni in nodes for key in rwop_keys
        )
        state.write(self.STATE_KEY, _RestrictionsState(frozenset(rwop_keys), conflicts))
        return None, None

    def _conflict_delta(self, rwop_keys: frozenset, pod_info) -> int:
        return sum(1 for k in pod_info.pvc_keys if k in rwop_keys)

    def add_pod(self, state, pod: Pod, pod_info_to_add, node_info) -> Status:
        s = state.read(self.STATE_KEY)
        if s is not None:
            s.conflicts += self._conflict_delta(s.rwop_keys, pod_info_to_add)
        return Status()

    def remove_pod(self, state, pod: Pod, pod_info_to_remove, node_info) -> Status:
        s = state.read(self.STATE_KEY)
        if s is not None:
            s.conflicts -= self._conflict_delta(s.rwop_keys, pod_info_to_remove)
        return Status()

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        s = state.read(self.STATE_KEY)
        if s is not None and s.conflicts > 0:
            return Status.unschedulable(ERR_REASON_RWOP_CONFLICT, plugin=self.name)
        return Status()


# --- VolumeZone -------------------------------------------------------------


class VolumeZone(Plugin):
    """volumezone/volume_zone.go — bound PVs carrying well-known zone/region
    labels constrain the node's matching labels (:198)."""

    name = "VolumeZone"

    def __init__(self, store):
        self.store = store

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.PVC, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.PV, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.NODE, ev.ADD | ev.UPDATE_NODE_LABEL), lambda *_: QUEUE),
        ]

    def _pod_pv_zone_constraints(self, pod: Pod) -> list[tuple[str, str]] | Status:
        out: list[tuple[str, str]] = []
        for name in pod_claim_names(pod):
            pvc = self.store.try_get(
                "PersistentVolumeClaim", _pvc_key(pod.meta.namespace, name)
            )
            if pvc is None:
                return Status.unresolvable(
                    f'{ERR_REASON_NOT_FOUND} "{name}"', plugin=self.name
                )
            if not pvc.spec.volume_name:
                continue  # unbound: VolumeBinding owns topology for these
            pv = self.store.try_get("PersistentVolume", pvc.spec.volume_name)
            if pv is None:
                continue
            for label in ZONE_LABELS:
                if label in pv.meta.labels:
                    out.append((label, pv.meta.labels[label]))
        return out

    def pre_filter(self, state, pod: Pod, nodes):
        constraints = self._pod_pv_zone_constraints(pod)
        if isinstance(constraints, Status):
            return None, constraints
        if not constraints:
            return None, Status.skip()
        state.write("PreFilterVolumeZone", constraints)
        return None, None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        constraints = state.read("PreFilterVolumeZone")
        if not constraints:
            return Status()
        labels = node_info.node.meta.labels
        for key, value in constraints:
            # missing label counts as a mismatch (volume_zone.go:198 — the
            # node must carry the PV's topology label with the same value);
            # unresolvable: eviction can't relabel nodes
            if labels.get(key) != value:
                return Status.unresolvable(ERR_REASON_ZONE_CONFLICT, plugin=self.name)
        return Status()


# --- NodeVolumeLimits (CSI) -------------------------------------------------


class NodeVolumeLimits(Plugin):
    """nodevolumelimits/csi.go — per-driver CSI attach-limit filter (:257).
    Counts unique volumes already attached (existing pods' bound PVs) plus the
    incoming pod's, per CSI driver, against the node's CSINode allocatable."""

    name = "NodeVolumeLimits"

    def __init__(self, store):
        self.store = store

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.CSI_NODE, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.ASSIGNED_POD, ev.DELETE), lambda *_: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.PVC, ev.ADD | ev.UPDATE), lambda *_: QUEUE),
        ]

    def _driver_of(self, pvc_key: str) -> tuple[str, str] | None:
        """Resolve a claim to (driver, volume identity) or None if
        driverless. Copy-free reads (get_ref): this runs per attached claim
        per node in the Filter hot loop, where try_get's deepcopies were
        the dominant cost of the whole CSI scheduling cycle."""
        read = getattr(self.store, "get_ref", self.store.try_get)
        pvc = read("PersistentVolumeClaim", pvc_key)
        if pvc is None:
            return None
        if pvc.spec.volume_name:
            pv = read("PersistentVolume", pvc.spec.volume_name)
            if pv is not None and pv.spec.csi_driver:
                return pv.spec.csi_driver, pv.meta.name
            return None
        sc = read("StorageClass", pvc.spec.storage_class_name)
        if sc is not None and sc.provisioner != NO_PROVISIONER:
            # to-be-provisioned volume counts toward its driver's limit
            return sc.provisioner, pvc_key
        return None

    STATE_KEY = "PreFilterNodeVolumeLimits"
    MEMO_KEY = "PreFilterNodeVolumeLimitsMemo"

    def pre_filter(self, state, pod: Pod, nodes):
        # resolve the pod's claims to per-driver volume identities once — the
        # result is node-independent (csi.go PreFilter)
        new_by_driver: dict[str, set[str]] = {}
        for name in pod_claim_names(pod):
            res = self._driver_of(_pvc_key(pod.meta.namespace, name))
            if res is None:
                continue
            driver, vol = res
            new_by_driver.setdefault(driver, set()).add(vol)
        if not new_by_driver:
            return None, Status.skip()
        state.write(self.STATE_KEY, new_by_driver)
        # claim->driver resolutions are stable within a cycle: memoize them
        # across the per-node Filter calls (csi.go resolves once per cycle)
        state.write(self.MEMO_KEY, {})
        return None, None

    def filter(self, state, pod: Pod, node_info: NodeInfo) -> Status:
        new_by_driver = state.read(self.STATE_KEY)
        if not new_by_driver:
            return Status()
        read = getattr(self.store, "get_ref", self.store.try_get)
        csi_node = read("CSINode", node_info.name)
        if csi_node is None or not csi_node.drivers:
            return Status()
        memo: dict = state.read(self.MEMO_KEY) or {}
        used_by_driver: dict[str, set[str]] = {}
        for key in node_info.pvc_ref_counts:
            if key in memo:
                res = memo[key]
            else:
                res = memo[key] = self._driver_of(key)
            if res is None:
                continue
            driver, vol = res
            used_by_driver.setdefault(driver, set()).add(vol)
        for driver, new_vols in new_by_driver.items():
            limit = csi_node.limit_for(driver)
            if limit <= 0:
                continue
            used = used_by_driver.get(driver, set())
            if len(used | new_vols) > limit:
                return Status.unschedulable(
                    ERR_REASON_MAX_VOLUME_COUNT, plugin=self.name
                )
        return Status()
