"""The device scheduling backend: planes, features and the wave kernels.

The port's counterpart of the reference package's TPUBackend
(kubernetes_tpu/scheduler/tpu/backend.py) for the batched wave path: a pod
wave is scored and placed greedily on the device in one K1 + K2 launch
pair, with the device mirror of the node planes kept current by a full put
on cold start and by the K3 row scatter afterwards.

Bit-compatibility contract: with percentageOfNodesToScore=100 the host path
evaluates every node and selects by (max total score, seeded-rng tie-break
over winners in snapshot node order) — exactly what the kernels compute, so
the decisions equal the reference backend's and the host path's.

Device: the backend runs on "cuda" unless the caller passes device="cpu",
which runs the kernels' plain PyTorch versions (as the tests do). Without a
card and without device="cpu" the constructor raises.

Not in this slice (a later one, in the ROADMAP's order): the single-pod path
(run / fit_and_score), hard spread constraints, inter-pod affinity,
signature dedup and cross-wave reuse, the pipelined launch/collect pair,
gang waves and the multi-device mesh. Configurations that need them raise
OutOfSlice; pods the reference sends to its host path raise FallbackNeeded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...api.resource import ResourceNames
from ...api.types import Pod
from ...ops.kernels import (
    MAX_TIE_DRAWS,
    ZERO_TIE_WORDS,
    KernelConfig,
    OutOfSlice,
    batched_assign,
    check_slice,
    log_weight_table,
    scatter_rows,
)
from ...ops.planes import (
    SLICE_PLANES,
    FallbackNeeded,
    PlaneBuilder,
    PodFeatureExtractor,
    features_from_reference,
    pad_features,
    planes_from_reference,
    stack_features,
)


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
        # device mirror of the node planes (SLICE_PLANES) and the affinity
        # tables; _pending_dirty holds the rows changed since the last
        # upload (None = row tracking lost, a full put is owed)
        self._device_planes: dict | None = None
        self._device_buckets: tuple | None = None
        self._pending_dirty: set[int] | None = set()
        self._device_tables: dict | None = None
        self._tables_src: dict | None = None
        self._logtab: torch.Tensor | None = None
        # signature dedup and cross-wave reuse come with a later slice; the
        # switches exist so a caller that turns them on gets OutOfSlice
        self.dedup_enabled = False
        self.cross_wave_enabled = False
        # upload counters: full puts, scatter launches, rows scattered
        self.upload_stats = {"full": 0, "scatter": 0, "rows": 0}
        # host-clock seconds per run_batched phase, summed over waves:
        # sync (planes from the snapshot), features (extract, stack, pad),
        # upload (device_inputs + features + tie words), launch (K1 + K2
        # enqueue), wait (the blocking result copy: the device's remaining
        # work plus the copy)
        self.phase_s = {"sync": 0.0, "features": 0.0, "upload": 0.0,
                        "launch": 0.0, "wait": 0.0}

    # -- config / planes -----------------------------------------------------

    def kernel_config(self, planes, feats=None) -> KernelConfig:
        """The wave's KernelConfig, derived as the reference derives it (feats
        tightens the constraint-slot counts). Raises OutOfSlice for any
        configuration the ported kernels do not compute."""
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
        cfg = KernelConfig(
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
        )
        check_slice(cfg)
        return cfg

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
        """(node planes, affinity tables) mirrored on the device.

        Call AFTER feature extraction — features intern affinity signatures.
        A full put on cold start, a bucket reshape, lost row tracking, or a
        dirty set past half the cluster; otherwise the rows changed since
        the last upload travel in ONE packed host→device copy and K3
        scatters them into every plane in one launch."""
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
        tables = self.extractor.affinity_tables(planes)
        if self._tables_src is not tables:
            self._device_tables = planes_from_reference(tables, self.device)
            self._tables_src = tables
        if self._logtab is None or self._logtab.shape[0] != planes.nb + 1:
            self._logtab = torch.from_numpy(log_weight_table(planes.nb)).to(
                self.device)
        return self._device_planes, self._device_tables

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
        if self.dedup_enabled or self.cross_wave_enabled:
            raise OutOfSlice("signature dedup / cross-wave reuse")
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
        packed_f, layout = features_from_reference(feats, self.device)
        words = torch.from_numpy(tie_words.view(np.int32)).to(self.device)
        t3 = time.perf_counter()
        packed_dev, _out = batched_assign(cfg, dev_planes, dev_tables, packed_f,
                                          layout, words, self._logtab)
        t4 = time.perf_counter()
        # ONE device→host copy: winners ++ [tie_consumed, tie_overflow]
        packed = packed_dev.cpu().numpy()
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
