"""The device scheduling backend: planes, features and the kernels.

The port's counterpart of the reference package's TPUBackend and
TPUSchedulingAlgorithm (kubernetes_tpu/scheduler/tpu/backend.py), for two
paths:
- the batched wave (run_batched): a pod wave is scored and placed greedily
  on the device in one K1 + K2 launch pair;
- the single-pod cycle (run, TorchSchedulingAlgorithm.schedule_pod): one
  pod against every node in one K4 launch — every filter and score, hard
  spread and inter-pod affinity included — and the per-node first-failure
  diagnosis of a pod that fits nowhere, built from K4's rows.
Both keep the device mirror of the node planes current by a full put on
cold start and by the K3 row scatter afterwards.

Bit-compatibility contract: with percentageOfNodesToScore=100 the host path
evaluates every node and selects by (max total score, seeded-rng tie-break
over winners in snapshot node order) — exactly what the kernels compute, so
the decisions equal the reference backend's and the host path's.

Device: the backend runs on "cuda" unless the caller passes device="cpu",
which runs the kernels' plain PyTorch versions (as the tests do). Without a
card and without device="cpu" the constructor raises.

The wave runs the reference's default tier: signature dedup on, hard
spread and inter-pod affinity in the scan. Not in this slice (a later one,
in the ROADMAP's order): cross-wave reuse of the signature table and the
pipelined launch/collect pair that feeds it, the host framework with its
fallback, hybrid and nominated-node paths and the circuit breaker, gang
waves and the multi-device mesh. What needs them raises OutOfSlice; pods
the reference sends to its host path raise FallbackNeeded.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ...api.resource import ResourceNames
from ...api.types import Pod, Taint
from ...ops.kernels import (
    FILTER_NAMES,
    MAX_TIE_DRAWS,
    ZERO_TIE_WORDS,
    KernelConfig,
    OutOfSlice,
    batched_assign,
    fit_and_score,
    log_weight_table,
    scatter_rows,
    unpack_fit_outputs,
)
from ...ops.planes import (
    SLICE_PLANES,
    FallbackNeeded,
    PlaneBuilder,
    PodFeatureExtractor,
    features_from_reference,
    pack_features,
    pad_features,
    planes_from_reference,
    stack_features,
)
from ...ops.vocab import next_pow2
from ..framework.interface import (
    UNSCHEDULABLE,
    Diagnosis,
    FitError,
    NodeToStatus,
    ScheduleResult,
    Status,
)
from ..plugins.pod_topology_spread import PodTopologySpread

# Reconstructed host-path messages + codes per filter mask row.
_ROW_STATUS = {
    "NodeUnschedulable": ("unresolvable", "node(s) were unschedulable"),
    "NodeName": ("unresolvable", "node didn't match the requested node name"),
    "NodeAffinity": ("unresolvable", "node(s) didn't match Pod's node affinity/selector"),
    "NodePorts": ("unschedulable", "node(s) didn't have free ports for the requested pod ports"),
}

# the annotation naming node features a pod requires (NodeDeclaredFeatures)
REQUIRED_FEATURES_ANNOTATION = "features.k8s.io/required"

# the five arrays run() returns
RUN_OUTPUTS = ("fails", "feasible", "insufficient", "too_many_pods", "total")


def _mt_stream(rng_state) -> np.random.RandomState:
    """numpy RandomState sharing the MT19937 position of a CPython
    random.Random state — uint32 full-range randint maps 1:1 onto genrand
    words, so the two generators walk the same word stream."""
    _version, mt, _gauss = rng_state
    rs = np.random.RandomState()
    rs.set_state(("MT19937", np.array(mt[:624], dtype=np.uint32), mt[624]))
    return rs


def clone_tie_words(rng, n_words: int) -> np.ndarray:
    """The rng's next n_words getrandbits(32) outputs, without advancing it."""
    rs = _mt_stream(rng.getstate())
    # randint needs uint64 to cover the closed [0, 2^32) range
    return rs.randint(0, 2**32, size=n_words, dtype=np.uint64).astype(np.uint32)


def advance_rng(rng, n_words: int) -> None:
    """Advance a live random.Random by exactly n_words getrandbits(32)
    draws via the same state transplant (no Python-loop catch-up)."""
    if not n_words:
        return
    version, _mt, gauss = rng.getstate()
    rs = _mt_stream(rng.getstate())
    rs.randint(0, 2**32, size=n_words, dtype=np.uint64)
    s = rs.get_state()
    rng.setstate((version, tuple(int(x) for x in s[1]) + (int(s[2]),), gauss))


def group_feature_rows(packed: np.ndarray):
    """Group byte-identical packed feature rows (the wave-side analogue of
    the framework's pod signature): returns (sig_ids [P] int32, uniq_idx [G]
    int32 first-occurrence slots), group ids in first-appearance order.
    Byte equality of the packed rows is the grouping ground truth: two rows
    that agree byte for byte are the same kernel input by construction."""
    ids = np.empty(packed.shape[0], np.int32)
    groups: dict[bytes, int] = {}
    uniq: list[int] = []
    for i in range(packed.shape[0]):
        gid = groups.setdefault(packed[i].tobytes(), len(uniq))
        if gid == len(uniq):
            uniq.append(i)
        ids[i] = gid
    return ids, np.asarray(uniq, np.int32)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU; no silent fallback when there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "kernels' plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchBackend:
    """Planes + features + device-state bookkeeping for one cluster."""

    def __init__(self, names: ResourceNames, plugin_args: dict | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        args = (plugin_args or {}).get("NodeResourcesFit", {})
        ipa_args = (plugin_args or {}).get("InterPodAffinity", {})
        self.ipa_ignore_preferred_existing = bool(
            ipa_args.get("ignorePreferredTermsOfExistingPods", False))
        self.names = names
        self.builder = PlaneBuilder(names)
        self.extractor = PodFeatureExtractor(names, self.builder.vocabs)
        self.strategy = args.get("strategy", "LeastAllocated")
        resources = args.get("resources") or {"cpu": 1, "memory": 1}
        self.fit_resources = tuple(
            (names.index_of(r), w) for r, w in sorted(resources.items(),
                                                      key=lambda kv: names.index_of(kv[0]))
        )
        shape = args.get("shape")
        self.rtc_shape = (
            tuple(sorted(tuple(p) for p in shape)) if shape else ((0, 0), (100, 100))
        )
        # device mirror of the node row planes (SLICE_PLANES), of the global
        # ipa_term_key table (with the host copy last uploaded) and of the
        # affinity tables; _pending_dirty holds the rows changed since the
        # last upload (None = row tracking lost, a full put is owed)
        self._device_planes: dict | None = None
        self._device_term_key: torch.Tensor | None = None
        self._uploaded_term_key: np.ndarray | None = None
        self._device_buckets: tuple | None = None
        self._pending_dirty: set[int] | None = set()
        self._device_tables: dict | None = None
        self._tables_src: dict | None = None
        self._logtab: torch.Tensor | None = None
        # signature dedup, on by default as in the reference; cross-wave
        # reuse of the signature table comes with the pipelined launch
        # (a later slice): turning it on raises OutOfSlice
        self.dedup_enabled = True
        self.cross_wave_enabled = False
        self.dedup_stats = {"pods": 0, "signatures": 0, "waves": 0}
        # scan steps by tier over the dedup waves, [full, replay], summed on
        # the device (read it only off the timed path)
        self.tier_steps = torch.zeros(2, dtype=torch.int32, device=self.device)
        # upload counters: full puts, scatter launches, rows scattered
        self.upload_stats = {"full": 0, "scatter": 0, "rows": 0}
        # host-clock seconds per run_batched phase, summed over waves:
        # sync (planes from the snapshot), features (extract, stack, pad),
        # upload (device_inputs + features + tie words), launch (K1 + K2
        # enqueue), wait (the blocking result copy: the device's remaining
        # work plus the copy)
        self.phase_s = {"sync": 0.0, "features": 0.0, "upload": 0.0,
                        "launch": 0.0, "wait": 0.0}
        # the phases of run(), summed over pods: as above, with the pod's
        # kernel_config timed apart (config), upload = device_inputs (K3)
        # + packed features, launch = K4 enqueue, wait = the one packed
        # result copy
        self.run_phase_s = {"sync": 0.0, "features": 0.0, "config": 0.0,
                            "upload": 0.0, "launch": 0.0, "wait": 0.0}

    # -- config / planes -----------------------------------------------------

    def kernel_config(self, planes, feats=None) -> KernelConfig:
        """The KernelConfig of a pod (one feature dict) or a wave (stacked),
        derived as the reference derives it: feats tightens the slot counts
        to what the pods use. Each kernel wrapper holds it against its own
        gate and raises OutOfSlice for what it does not compute."""
        mc = self.extractor.MAX_CONSTRAINTS
        n_hard = n_soft = mc
        n_ipa_aff = n_ipa_anti = self.extractor.MAX_IPA_TERMS
        n_ipa_pref = self.extractor.MAX_IPA_PREF
        if feats is not None:
            n_hard = int(np.asarray(feats["hard_active"]).sum(axis=-1).max())
            n_soft = int(np.asarray(feats["soft_active"]).sum(axis=-1).max())
            n_ipa_aff = int((np.asarray(feats["ipa_aff_t"]) >= 0).sum(axis=-1).max())
            n_ipa_anti = int((np.asarray(feats["ipa_anti_t"]) >= 0).sum(axis=-1).max())
            n_ipa_pref = int((np.asarray(feats["ipa_pref_t"]) >= 0).sum(axis=-1).max())
        wave_anti = bool(feats is not None
                         and np.asarray(feats["ipa_anti_add"]).any())
        wave_pref = bool(feats is not None
                         and np.asarray(feats["ipa_pref_add"]).any())
        return KernelConfig(
            strategy=self.strategy,
            fit_resources=self.fit_resources,
            rtc_shape=self.rtc_shape,
            topo_domains=self.builder.topo_domains(planes),
            max_constraints=mc,
            n_hard=n_hard,
            n_soft=n_soft,
            ipa_existing_anti=bool(planes.ipa_anti[: planes.n].any()) or wave_anti,
            ipa_existing_pref=bool(planes.ipa_pref[: planes.n].any()) or wave_pref,
            n_ipa_aff=n_ipa_aff,
            n_ipa_anti=n_ipa_anti,
            n_ipa_pref=n_ipa_pref,
            max_ipa_terms=self.extractor.MAX_IPA_TERMS,
            max_ipa_pref=self.extractor.MAX_IPA_PREF,
            ipa_ignore_preferred_existing=self.ipa_ignore_preferred_existing,
        )

    def sync(self, snapshot):
        """Refresh host planes from the snapshot (O(changed) by generation),
        accumulating dirty rows for the device delta upload."""
        planes = self.builder.sync(snapshot)
        if self._pending_dirty is not None:
            dirty = self.builder.dirty_rows
            if dirty is None:
                self._pending_dirty = None  # full rebuild happened
            else:
                self._pending_dirty.update(dirty)
        return planes

    def device_inputs(self, planes) -> tuple[dict, dict]:
        """(node planes + ipa_term_key, affinity tables) mirrored on the
        device.

        Call AFTER feature extraction — features intern affinity signatures.
        A full put on cold start, a bucket reshape, lost row tracking, or a
        dirty set past half the cluster; otherwise the rows changed since
        the last upload travel in ONE packed host→device copy and K3
        scatters them into every row plane in one launch. ipa_term_key is
        global, not row-indexed: a term interned mid-run moves its content
        but not its shape, and a stale device copy would map the new term
        to key slot -1 (K4 then rejects every node), so it is re-uploaded
        whenever its host content differs from the copy last uploaded."""
        host = planes.as_dict()
        full = (
            self._device_planes is None
            or self._pending_dirty is None
            or self._device_buckets != planes.bucket_sizes
            or len(self._pending_dirty) > max(64, planes.n // 2)
        )
        if full:
            self._device_planes = planes_from_reference(
                {k: host[k] for k in SLICE_PLANES}, self.device)
            self.upload_stats["full"] += 1
        elif self._pending_dirty:
            idx = np.array(sorted(self._pending_dirty), np.int32)
            rows = self._upload_rows(host, idx)
            scatter_rows(self._device_planes, rows,
                         torch.from_numpy(idx).to(self.device))
            self.upload_stats["scatter"] += 1
            self.upload_stats["rows"] += len(idx)
        self._device_buckets = planes.bucket_sizes
        self._pending_dirty = set()
        if (full or self._uploaded_term_key is None
                or not np.array_equal(self._uploaded_term_key, planes.ipa_term_key)):
            self._uploaded_term_key = planes.ipa_term_key.copy()
            self._device_term_key = torch.from_numpy(self._uploaded_term_key).to(
                self.device, copy=True)
        tables = self.extractor.affinity_tables(planes)
        if self._tables_src is not tables:
            self._device_tables = planes_from_reference(tables, self.device)
            self._tables_src = tables
        if self._logtab is None or self._logtab.shape[0] != planes.nb + 1:
            self._logtab = torch.from_numpy(log_weight_table(planes.nb)).to(
                self.device)
        return ({**self._device_planes, "ipa_term_key": self._device_term_key},
                self._device_tables)

    def _upload_rows(self, host: dict, idx: np.ndarray) -> dict:
        """Gather the dirty rows of every mirrored plane into one byte
        buffer (16-byte aligned per plane), copy it to the device once, and
        return per-plane views of it in the device planes' dtypes."""
        parts, offs, off = [], {}, 0
        for k in SLICE_PLANES:
            b = np.ascontiguousarray(host[k][idx]).view(np.uint8).reshape(-1)
            offs[k] = (off, b.size)
            parts.append((off, b))
            off += (b.size + 15) // 16 * 16
        buf = np.zeros(off, np.uint8)
        for o, b in parts:
            buf[o: o + b.size] = b
        dev = torch.from_numpy(buf).to(self.device, copy=True)
        rows = {}
        for k in SLICE_PLANES:
            o, size = offs[k]
            t = self._device_planes[k]
            rows[k] = dev[o: o + size].view(t.dtype).view((len(idx),) + tuple(t.shape[1:]))
        return rows

    # -- the batched wave ------------------------------------------------------

    def run_batched(self, pods: list[Pod], snapshot, rng=None,
                    pad_to: int = 0):
        """Greedy batched assignment of a pod wave on the device.

        With rng (the scheduling algorithm's seeded random.Random) the wave's
        tie-breaks are bit-identical to the host path scheduling the same
        pods sequentially: the rng's future getrandbits(32) stream is cloned
        into the kernel, and the live rng is advanced by exactly the words
        the kernel consumed.

        Returns (node names per pod or None, planes). The caller applies the
        same assumes host-side so cache and device state stay coherent."""
        if self.cross_wave_enabled:
            raise OutOfSlice("cross-wave reuse of the signature table")
        t0 = time.perf_counter()
        for pod in pods:
            self.extractor.register(pod)
        planes = self.sync(snapshot)
        t1 = time.perf_counter()
        feats = stack_features(
            [self.extractor.features_cached(p, planes) for p in pods]
        )
        if pad_to > len(pods):
            feats = pad_features(feats, pad_to)
        n_slots = max(pad_to, len(pods))
        t2 = time.perf_counter()
        dev_planes, dev_tables = self.device_inputs(planes)
        cfg = self.kernel_config(planes, feats)
        tie_words = (ZERO_TIE_WORDS if rng is None else
                     clone_tie_words(rng, n_slots * MAX_TIE_DRAWS + MAX_TIE_DRAWS))
        rows, layout = pack_features(feats)
        groups = self._group_wave(rows, len(pods))
        packed_f = torch.from_numpy(rows).to(self.device)
        sig_ids, uniq = (None, None) if groups is None else (
            torch.from_numpy(g).to(self.device) for g in groups)
        words = torch.from_numpy(tie_words.view(np.int32)).to(self.device)
        t3 = time.perf_counter()
        out = batched_assign(cfg, dev_planes, dev_tables, packed_f, layout, words,
                             self._logtab, sig_ids=sig_ids, uniq_idx=uniq)
        if "tiers" in out:
            self.tier_steps += out["tiers"]
        t4 = time.perf_counter()
        # ONE device→host copy: winners ++ [tie_consumed, tie_overflow]
        packed = out["packed"].cpu().numpy()
        t5 = time.perf_counter()
        for k, a, b in (("sync", t0, t1), ("features", t1, t2), ("upload", t2, t3),
                        ("launch", t3, t4), ("wait", t4, t5)):
            self.phase_s[k] += b - a
        winners, consumed, overflow = (
            packed[: len(pods)], int(packed[-2]), bool(packed[-1])
        )
        if rng is not None:
            if overflow:
                # a step exhausted its draw words: results past it are
                # desynced from the host stream — discard the wave
                raise FallbackNeeded("tie-break draw overflow")
            advance_rng(rng, consumed)
        return [planes.node_names[w] if w >= 0 else None for w in winners], planes

    def _group_wave(self, rows: np.ndarray, n_real: int):
        """Signature-group a (possibly padded) packed feature batch: (sig_ids
        [P], uniq_idx [G_pad]) for batched_assign, or None with dedup off.
        uniq_idx is padded to a power of two (floor 8) by repeating the
        first group's slot, as the reference pads it (backend.py:675-679);
        only the first G rows are ever installed."""
        if not self.dedup_enabled:
            return None
        sig_ids, uniq = group_feature_rows(rows)
        self.dedup_stats["pods"] += n_real
        self.dedup_stats["signatures"] += int(sig_ids[:n_real].max()) + 1
        self.dedup_stats["waves"] += 1
        gp = next_pow2(len(uniq), floor=8)
        if gp > len(uniq):
            uniq = np.concatenate([uniq, np.full(gp - len(uniq), uniq[0], np.int32)])
        return sig_ids, uniq

    # -- the single-pod cycle --------------------------------------------------

    def run(self, pod: Pod, snapshot):
        """One pod against the whole cluster in one K4 launch; returns
        (planes, {fails, feasible, insufficient, too_many_pods, total} as
        numpy). Raises FallbackNeeded when the pod is not kernelizable.

        The kernel writes every output into one packed buffer, so the
        results come back in ONE device→host copy (views of it)."""
        t0 = time.perf_counter()
        self.extractor.register(pod)
        planes = self.sync(snapshot)
        t1 = time.perf_counter()
        f = self.extractor.features(pod, planes)
        t2 = time.perf_counter()
        cfg = self.kernel_config(planes, f)
        t3 = time.perf_counter()
        dev_planes, dev_tables = self.device_inputs(planes)
        packed_f, layout = features_from_reference(stack_features([f]), self.device)
        t4 = time.perf_counter()
        packed = fit_and_score(cfg, dev_planes, dev_tables, packed_f, layout,
                               self._logtab)
        t5 = time.perf_counter()
        host = packed[0].cpu()
        t6 = time.perf_counter()
        for k, a, b in (("sync", t0, t1), ("features", t1, t2), ("config", t2, t3),
                        ("upload", t3, t4), ("launch", t4, t5), ("wait", t5, t6)):
            self.run_phase_s[k] += b - a
        n_fails = len(FILTER_NAMES) + 2 * cfg.max_constraints + 3
        out = unpack_fit_outputs(host, planes.nb, n_fails, planes.r)
        return planes, {k: out[k].numpy() for k in RUN_OUTPUTS}

    # -- the FitError diagnosis ----------------------------------------------

    def _diagnosis_row_order(self) -> list[tuple[str, int]]:
        """Filter rows in the host chain's first-failure order: the plugin
        rows, then per constraint the spread missing-key and skew rows, then
        InterPodAffinity's existing-anti, incoming-anti and incoming-affinity
        rows (filtering.go:352-412)."""
        c_max = self.extractor.MAX_CONSTRAINTS
        order: list[tuple[str, int]] = [(nm, i) for i, nm in enumerate(FILTER_NAMES)]
        for c in range(c_max):
            order.append((f"pts_missing:{c}", len(FILTER_NAMES) + c))
            order.append((f"pts_skew:{c}", len(FILTER_NAMES) + c_max + c))
        base = len(FILTER_NAMES) + 2 * c_max
        order.append(("ipa_existing_anti", base))
        order.append(("ipa_anti", base + 1))
        order.append(("ipa_aff", base + 2))
        return order

    def build_diagnosis(self, pod: Pod, planes, out) -> Diagnosis:
        """Per-node first-failure statuses as the host filter chain would
        have produced them (the first rejecting plugin wins), built lazily:
        one vectorized argmax finds every node's first failing row; Status
        objects materialize only for the nodes a consumer asks about."""
        diagnosis = Diagnosis()
        v = self.builder.vocabs
        # tolerance per taint-vocab entry, for host-identical taint messages
        tol = [
            any(tl.tolerates(Taint(*v.taints.key(j))) for tl in pod.spec.tolerations)
            for j in range(len(v.taints))
        ]
        lazy = _LazyKernelStatuses(self, planes, out, self._diagnosis_row_order(),
                                   self._hard_constraint_keys(pod), tol)
        diagnosis.node_to_status = lazy
        diagnosis.unschedulable_plugins |= lazy.failing_plugins()
        return diagnosis

    def _hard_constraint_keys(self, pod: Pod) -> list[str]:
        pts = PodTopologySpread(system_defaulting=self.extractor.system_default_spread)
        return [c.topology_key for c in pts._constraints_for(pod, "DoNotSchedule")]

    def _row_to_status(self, name: str, i: int, planes, out, hard_keys, tol) -> Status:
        v = self.builder.vocabs
        if name == "TaintToleration":
            # the first *intolerable* taint, as the host filter's message
            msg = "node(s) had untolerated taint"
            for tid in planes.taints[i]:
                if tid >= 0 and not tol[int(tid)]:
                    key, val, _eff = v.taints.key(int(tid))
                    msg = f"node(s) had untolerated taint {{{key}: {val}}}"
                    break
            return Status.unresolvable(msg, plugin="TaintToleration")
        if name == "NodeResourcesFit":
            reasons = []
            if out["too_many_pods"][i]:
                reasons.append("Too many pods")
            for r in range(out["insufficient"].shape[0]):
                if out["insufficient"][r, i]:
                    rname = self.names.names[r] if r < self.names.width else f"res{r}"
                    reasons.append(f"Insufficient {rname}")
            return Status.unschedulable(*reasons, plugin="NodeResourcesFit")
        if name.startswith("pts_missing:"):
            c = int(name.split(":")[1])
            key = hard_keys[c] if c < len(hard_keys) else "?"
            return Status.unresolvable(
                f"node(s) didn't have required label {key}", plugin="PodTopologySpread")
        if name.startswith("pts_skew:"):
            return Status.unschedulable(
                "node(s) didn't match pod topology spread constraints",
                plugin="PodTopologySpread")
        if name == "ipa_existing_anti":
            return Status.unschedulable(
                "node(s) had pods with anti-affinity rules rejecting the pod",
                plugin="InterPodAffinity")
        if name == "ipa_anti":
            return Status.unschedulable(
                "node(s) didn't satisfy pod anti-affinity rules", plugin="InterPodAffinity")
        if name == "ipa_aff":
            return Status.unschedulable(
                "node(s) didn't satisfy pod affinity rules", plugin="InterPodAffinity")
        kind, msg = _ROW_STATUS[name]
        ctor = Status.unresolvable if kind == "unresolvable" else Status.unschedulable
        return ctor(msg, plugin=name)


class _LazyKernelStatuses(NodeToStatus):
    """NodeToStatus over K4's dense failure rows: one numpy argmax finds
    every node's first failing row up front; Status objects materialize per
    node on get() (memoized). Entries written by set() take precedence; no
    caller of this slice writes any (preemption, which does, is not ported
    yet)."""

    # row name -> Status code kind mirrored from _row_to_status
    _UNSCHEDULABLE_ROWS = ("NodePorts", "NodeResourcesFit", "pts_skew",
                           "ipa_existing_anti", "ipa_anti", "ipa_aff")

    def __init__(self, backend, planes, out, order, hard_keys, tol):
        super().__init__()
        self._backend = backend
        self._planes = planes
        self._out = out
        self._hard_keys = hard_keys
        self._tol = tol
        self._memo: dict[int, Status] = {}
        self._row_names = [name for name, _ in order]
        fails = np.asarray(out["fails"])[:, : planes.n]
        ordered = fails[[row for _, row in order], :]
        self._first = np.argmax(ordered, axis=0)
        # real (non-padding) infeasible nodes with a recorded failure row
        self._failed = ordered.any(axis=0) & ~np.asarray(out["feasible"])[: planes.n]
        self._index = planes.node_index

    def failing_plugins(self) -> set:
        out = set()
        for r in np.unique(self._first[self._failed]):
            name = self._row_names[int(r)]
            if name.startswith("pts_"):
                out.add("PodTopologySpread")
            elif name.startswith("ipa_"):
                out.add("InterPodAffinity")
            else:
                out.add(name)
        return out

    def get(self, node_name: str) -> Status:
        st = self.node_to_status.get(node_name)
        if st is not None:
            return st
        i = self._index.get(node_name)
        if i is None or i >= len(self._first) or not self._failed[i]:
            return self.absent_nodes_status
        st = self._memo.get(i)
        if st is None:
            name = self._row_names[int(self._first[i])]
            st = self._memo[i] = self._backend._row_to_status(
                name, i, self._planes, self._out, self._hard_keys, self._tol)
        return st

    def unschedulable_name_set(self) -> set:
        """Names whose status code is plain UNSCHEDULABLE (preemption's
        candidate precheck), in one vectorized pass. Overlay entries take
        precedence."""
        rows =[r for r, name in enumerate(self._row_names)
                if name.split(":")[0] in self._UNSCHEDULABLE_ROWS]
        mask = self._failed & np.isin(self._first, rows)
        names = {self._planes.node_names[i] for i in np.nonzero(mask)[0]}
        for n, st in self.node_to_status.items():
            if st.code == UNSCHEDULABLE:
                names.add(n)
            else:
                names.discard(n)
        return names

    def fit_verdict_names(self) -> set:
        """Names whose FIRST failing filter is NodeResourcesFit."""
        fit_row = self._row_names.index("NodeResourcesFit")
        mask = self._failed & (self._first == fit_row)
        names = {self._planes.node_names[i] for i in np.nonzero(mask)[0]}
        for n, st in self.node_to_status.items():
            if st.plugin == "NodeResourcesFit":
                names.add(n)
            else:
                names.discard(n)
        return names

    def aggregate_reasons(self) -> dict[str, int]:
        """Vectorized FitError aggregation: the strings and counts that
        materializing every node's Status would give."""
        reasons: dict[str, int] = {}

        def bump(msg: str, n: int) -> None:
            if n:
                reasons[msg] = reasons.get(msg, 0) + int(n)

        first, failed = self._first, self._failed
        for r, name in enumerate(self._row_names):
            mask = failed & (first == r)
            count = int(mask.sum())
            if not count:
                continue
            if name == "NodeResourcesFit":
                ins = np.asarray(self._out["insufficient"])[:, : len(mask)]
                bump("Too many pods", int(
                    (np.asarray(self._out["too_many_pods"])[: len(mask)] & mask).sum()))
                for col in range(ins.shape[0]):
                    rname = (self._backend.names.names[col]
                             if col < self._backend.names.width else f"res{col}")
                    bump(f"Insufficient {rname}", int((ins[col] & mask).sum()))
            elif name == "TaintToleration":
                # per-node FIRST intolerable taint id, then count per id
                taints = np.asarray(self._planes.taints)[: len(mask)]
                intol = np.zeros_like(taints, dtype=bool)
                for j, ok in enumerate(self._tol):
                    if not ok:
                        intol |= taints == j
                has = intol.any(axis=1)
                tids = taints[np.arange(len(mask)), np.argmax(intol, axis=1)]
                for tid in np.unique(tids[mask & has]):
                    key, val, _eff = self._backend.builder.vocabs.taints.key(int(tid))
                    bump(f"node(s) had untolerated taint {{{key}: {val}}}",
                         int((tids == tid)[mask & has].sum()))
                bump("node(s) had untolerated taint", int((mask & ~has).sum()))
            else:
                # constant-message rows: materialize ONE status for the text
                st = self._backend._row_to_status(
                    name, int(np.argmax(mask)), self._planes, self._out,
                    self._hard_keys, self._tol)
                for rr in st.reasons:
                    bump(rr, count)
        for st in self.node_to_status.values():
            for rr in st.reasons:
                bump(rr, 1)
        return reasons


class TorchSchedulingAlgorithm:
    """schedulePod with K4 on the hot path: the kernel branch of the
    reference's TPUSchedulingAlgorithm.schedule_pod (backend.py:1393-1454).

    percentageOfNodesToScore is 100: K4 evaluates every node, and the
    winner is the max total with the seeded rng's randrange over the tied
    winners in node order, so decisions equal the host algorithm's.

    The host framework is a later slice. The cases the reference hands to
    it raise instead of computing an answer: a nominated pod (OutOfSlice),
    a pod needing host compose (OutOfSlice) and a pod the extractor refuses
    (FallbackNeeded, re-raised). The circuit breaker comes with the host
    tier it falls back to. Before a FitError the reference also runs the
    host PreFilter chain so preemption can reuse its state; that waits for
    the framework.
    """

    def __init__(self, backend: TorchBackend, rng=None):
        self.backend = backend
        self.rng = rng or random.Random(0)  # seeded: deterministic tie-breaks
        self.kernel_count = 0

    def schedule_pod(self, state, pod: Pod, snapshot) -> ScheduleResult:
        if snapshot.num_nodes() == 0:
            raise FitError(pod, 0, Diagnosis())
        if pod.status.nominated_node_name:
            raise OutOfSlice("nominated node evaluation (_evaluate_nominated) "
                             "is not ported yet")
        if self._needs_host_compose(pod):
            raise OutOfSlice("host-composed (hybrid) scheduling is not ported yet")
        planes, out = self.backend.run(pod, snapshot)
        self.kernel_count += 1
        feasible_idx = np.flatnonzero(out["feasible"][: planes.n])
        if feasible_idx.size == 0:
            raise FitError(pod, snapshot.num_nodes(),
                           self.backend.build_diagnosis(pod, planes, out))
        if feasible_idx.size == 1:
            return ScheduleResult(suggested_host=planes.node_names[int(feasible_idx[0])],
                                  evaluated_nodes=planes.n, feasible_nodes=1)
        totals = out["total"][feasible_idx]
        winners = feasible_idx[totals == totals.max()]
        win = int(winners[self.rng.randrange(winners.size)] if winners.size > 1
                  else winners[0])
        return ScheduleResult(suggested_host=planes.node_names[win],
                              evaluated_nodes=planes.n,
                              feasible_nodes=int(feasible_idx.size))

    @staticmethod
    def _needs_host_compose(pod: Pod) -> bool:
        """Pods whose long-tail host stages must run on top of the kernel
        (the reference's hybrid path). Of its triggers — volume claims,
        resource claims, required node features, interested extenders —
        the port's types carry only the required-features annotation."""
        ann = pod.meta.annotations.get(REQUIRED_FEATURES_ANNOTATION, "")
        return any(f.strip() for f in ann.split(","))
