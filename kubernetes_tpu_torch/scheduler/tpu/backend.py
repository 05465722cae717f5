"""The device scheduling backend: planes, features and the kernels.

The port's counterpart of the reference package's TPUBackend and
TPUSchedulingAlgorithm (kubernetes_tpu/scheduler/tpu/backend.py), for three
paths:
- the batched wave (run_batched): a pod wave is scored and placed greedily
  on the device in one K1 + K2 launch pair;
- the single-pod cycle (run, TorchSchedulingAlgorithm.schedule_pod): one
  pod against every node in one K4 launch — every filter and score, hard
  spread and inter-pod affinity included — and the per-node first-failure
  diagnosis of a pod that fits nowhere, built from K4's rows;
- the gang wave (run_gang, called by gangplanner.try_gang_wave): a whole
  PodGroup scanned over every placement mask at once in one K1 + K5 launch
  pair, all or nothing.
- the streaming wave (launch_batched / collect): the reference's default
  main path. A wave's K1 + K2 launch chains on the previous launch's
  output planes (the device carry) while the host processes the previous
  wave's results one wave behind; K2 reads the predecessor's final tie
  cursor from the device and seeds its signature table from the previous
  chained wave's resident rows (cross-wave reuse). Its uploads leave from
  pinned host memory without blocking, and its one result copy is
  enqueued right behind K2 with an event that collect waits on.
All keep the device mirror of the node planes current by a full put on
cold start and by the K3 row scatter afterwards. The carry is a second
buffer beside that mirror: while it lives, the mirror owes the rows the
carry owns (mirror debt), repaid by one K3 scatter when the carry dies.

Bit-compatibility contract: with percentageOfNodesToScore=100 the host path
evaluates every node and selects by (max total score, seeded-rng tie-break
over winners in snapshot node order) — exactly what the kernels compute, so
the decisions equal the reference backend's and the host path's.

Device: the backend runs on "cuda" unless the caller passes device="cpu",
which runs the kernels' plain PyTorch versions (as the tests do). Without a
card and without device="cpu" the constructor raises.

The wave runs the reference's default tier: signature dedup on, hard
spread and inter-pod affinity in the scan, cross-wave reuse on, and pods
whose volume decision is node-neutral ride it with their volume plan
applied at the wave's finish. Around K4 the single-pod cycle has the
reference's host tier (TorchSchedulingAlgorithm): the hybrid route (the
volume plugins, DynamicResources, NodeDeclaredFeatures and HTTP extenders
on K4's feasible nodes), the nominee fast path, the host algorithm for
pods the extractor refuses (FallbackNeeded), and the circuit breaker the
scheduling loop (schedule_one.ScheduleOneLoop) feeds with its device
waves' outcomes. The breaker reads injected faults only: the tpu.launch
and tpu.collect points raise DeviceFlakeError, and a real error on the
card raises out of the loop. A FitError's cycle state is left fit for
DefaultPreemption's dry run. What the kernels do not compute raises
OutOfSlice, which no route sends to the host.

Telemetry (the reference's, backend.py:474-643, :707-913): every backend
writes into a wave recorder (waverecorder.WaveRecorder; the Scheduler's,
or one of its own). A streaming wave and a gang wave each leave a
WaveRecord — pods, pad, dedup and cross-wave outcome, fallback reason,
phases, transfer bytes — closed at collect (or by the loop) with the
reference's fallback reasons. The device telemetry counts every upload
and fetch by plane at its seam (`accounted_put`, `accounted_fetch`, or
the accounting-only entries for the pinned staging copies and the wave's
asynchronous result copy), a compile span per kernel entry point keyed
by its static configuration, and the resident buffer groups. None of it
adds a copy, a synchronisation or an rng draw. The phase dicts
(`phase_s`, `pipe_phase_s`, `run_phase_s`, `gang_phase_s`) keep their
own keys: the records take the same clock readings under the reference's
wave-phase names.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from ...api.resource import ResourceNames
from ...api.storage import pod_claim_names
from ...api.types import Pod, Taint
from ...ops.cards import CardTensor, card_scan_plan, fit_outputs
from ...ops.kernels import (
    FILTER_NAMES,
    MAX_TIE_DRAWS,
    SCAN_MAX_BLOCKS,
    ZERO_TIE_WORDS,
    KernelConfig,
    check_gang_rows,
    dedup_fast_capable,
    gang_assign,
    log_weight_table,
    plan_key,
    scan_limits,
    scan_plan_for,
    scatter_rows,
    static_parts,
    unpack_fit_outputs,
)
from ...ops.planes import (
    SLICE_PLANES,
    DeviceFlakeError,
    FallbackNeeded,
    PlaneBuilder,
    PodFeatureExtractor,
    features_from_reference,
    pack_features,
    pad_features,
    placement_masks,
    stack_features,
)
from ...ops.vocab import next_pow2
from ...utils import faultinject
from ..extender import extender_scores, find_nodes_that_pass_extenders
from .devicetelemetry import tree_nbytes
from .waverecorder import WaveRecord, WaveRecorder
from ..framework.interface import (
    UNSCHEDULABLE,
    Diagnosis,
    FitError,
    NodePluginScores,
    NodeToStatus,
    ScheduleResult,
    Status,
)
from ..plugins.node_declared_features import infer_required_features
from ..plugins.pod_topology_spread import PodTopologySpread
from ..plugins.volumes import VolumeBinding
from ..schedule_one import SchedulingAlgorithm, num_feasible_nodes_to_find

# Plugins K4 fully models. On the hybrid path these are skipped host-side
# (their work already happened on the device) while the long-tail plugins
# (NodeDeclaredFeatures here; the volume and DRA plugins in the reference)
# run on the kernel-pruned node set.
KERNEL_FILTER_PLUGINS = frozenset({
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodePorts", "NodeResourcesFit", "PodTopologySpread", "InterPodAffinity",
})
KERNEL_SCORE_PLUGINS = frozenset({
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration",
    "NodeAffinity", "PodTopologySpread", "InterPodAffinity", "ImageLocality",
})

# Reconstructed host-path messages + codes per filter mask row.
_ROW_STATUS = {
    "NodeUnschedulable": ("unresolvable", "node(s) were unschedulable"),
    "NodeName": ("unresolvable", "node didn't match the requested node name"),
    "NodeAffinity": ("unresolvable", "node(s) didn't match Pod's node affinity/selector"),
    "NodePorts": ("unschedulable", "node(s) didn't have free ports for the requested pod ports"),
}

# the five arrays run() returns
RUN_OUTPUTS = ("fails", "feasible", "insufficient", "too_many_pods", "total")


def _bucket_label(bucket_sizes) -> str:
    """Compact shape label for the compile tracker's metrics series."""
    return "nb" + "x".join(str(b) for b in bucket_sizes)


def _wave_label(bucket_sizes, pad: int, uniq, plan) -> str:
    g = len(uniq) if uniq is not None else 0
    return f"pad{pad}/g{g}/{_bucket_label(bucket_sizes)}" + _blocks_label(plan)


def _blocks_label(plan) -> str:
    """A scan's (blocks, passes) (kernels.plan_key), and over several cards
    their count: past the card's largest cluster its blocks walk in passes,
    "/p<passes>"; past one block's slots it runs a cluster of blocks,
    "/c<blocks>"; at the card level, "/x<cards>"."""
    blocks, passes = plan[:2]
    cards = plan[2] if len(plan) > 2 else 1
    return ((f"/p{passes}" if passes else "") + (f"/c{blocks}" if blocks > 1 else "")
            + (f"/x{cards}" if cards > 1 else ""))


def _same_card(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: a CUDA device without an index is the
    current card."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if (a.index is None or b.index is None) else 0
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _first(x):
    """A card-level output's card-0 part (CardTensor), else x."""
    return x.parts[0] if isinstance(x, CardTensor) else x


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


class NeedResync(Exception):
    """A pipelined launch cannot proceed on the device carry (an external
    change touched node rows the carry does not account for, or the plane
    buckets changed shape): the caller must drain the pipeline, after which
    the next launch re-uploads from host truth."""


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


class SignatureScoreCache:
    """Host bookkeeping for the device-resident cross-wave score rows (the
    reference's SignatureScoreCache, backend.py:160-221).

    K2's dedup tier leaves a per-signature table (sig_table) on the device;
    this cache keeps its signature-bytes → slot map and a shape/config key
    so the NEXT chained wave can hand the table back (carry_map /
    sig_table) and replay signatures already scored. The tensors never
    travel to the host. The table's rows are scores against the carry
    planes as of the end of the wave that made them, so they are handed
    back only to a launch that chains on that carry; every carry
    invalidation clears the cache too (TorchBackend.invalidate_carry)."""

    def __init__(self):
        self.slots: dict[bytes, int] = {}   # signature bytes → table slot
        self.table: dict | None = None      # device tensors from sig_table
        self.key: tuple | None = None       # (cfg, bucket_sizes, G_pad)
        self.hits = 0                        # cumulative
        self.misses = 0
        self.evictions = 0

    def clear(self) -> None:
        self.slots = {}
        self.table = None
        self.key = None

    def lookup(self, key, sig_bytes, g_pad: int):
        """carry_map [g_pad] of this wave's signatures against the cached
        table (slot gid replays cached slot carry_map[gid]; -1 a miss), or
        None when the cache is cold or keyed differently."""
        if self.table is None or key != self.key:
            return None
        m = np.full(g_pad, -1, np.int32)
        for gid, b in enumerate(sig_bytes):
            m[gid] = self.slots.get(b, -1)
        return m

    def store(self, key, table, sig_bytes) -> tuple[int, int, int]:
        """Adopt a just-launched wave's table as the resident generation;
        returns (hits, misses, evictions) of its signatures against the
        previous generation. One generation only: signatures absent from
        the new wave are evicted."""
        warm = self.table is not None and key == self.key
        hit = sum(1 for b in sig_bytes if b in self.slots) if warm else 0
        miss = len(sig_bytes) - hit
        evict = max(0, len(self.slots) - hit) if warm else len(self.slots)
        self.slots = {}
        for gid, b in enumerate(sig_bytes):
            self.slots.setdefault(b, gid)  # first appearance wins
        self.table = table
        self.key = key
        self.hits += hit
        self.misses += miss
        self.evictions += evict
        return hit, miss, evict


class InflightWave:
    """A launched, not yet collected wave (the reference's InflightWave,
    backend.py:223-256): device outputs, the pinned host copy of its packed
    result with the event that says it arrived, and the pinned buffers of
    its uploads, held until its copies are done."""

    __slots__ = ("pods", "qpis", "planes", "info", "pad", "cursor_base_host",
                 "frame_shift", "poisoned", "sig_ids", "host_packed", "ready",
                 "staged", "chained", "launch_s", "record")

    def __init__(self, pods, planes, info, pad, frame_shift, sig_ids=None):
        self.pods = pods
        self.qpis = None  # the queued pod infos, set by the scheduling loop
        self.planes = planes
        self.info = info  # K2's outputs, on the device
        self.pad = pad
        self.sig_ids = sig_ids
        # absolute tie-stream position where this wave's draws started, in
        # this wave's word frame: known on the device at launch
        # (cursor_init), on the host once the predecessor is collected
        self.cursor_base_host: int | None = None
        # words the live rng advanced between the predecessor's launch and
        # this launch: converts the predecessor's final cursor into this
        # wave's frame
        self.frame_shift = frame_shift
        self.poisoned = False
        self.host_packed = None
        self.ready = None
        self.staged: list = []
        self.chained = False
        self.launch_s = 0.0
        self.record: WaveRecord | None = None  # the wave's flight record

    def mark_poisoned(self) -> None:
        """The scheduling loop's poison hook: this wave's results must be
        discarded at collect (host state diverged from what its kernel
        assumed)."""
        self.poisoned = True


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


class _CardEvents:
    """A card-level wave's result event on card 0 and each card's control
    words copied behind it (TorchBackend._fetch_async)."""

    def __init__(self, events, ctls):
        self.events, self.ctls = events, ctls

    def synchronize(self) -> None:
        for e in self.events:
            e.synchronize()

    def check(self, ctx) -> None:
        bad = [c for c, h in enumerate(self.ctls) if int(h[0])]
        if bad:
            ctx.check()
            raise RuntimeError(f"card level: a card rank never arrived at an exchange "
                               f"(cards {bad})")


class TorchBackend:
    """Planes + features + device-state bookkeeping for one cluster.

    Over several cards (a MeshContext whose mesh spans them) every node
    plane of the mirror, the carry and the signature table's columns is a
    CardTensor (ops/cards.py), one contiguous node range per card; dirty
    rows go to the card that owns them (_scatter_cards); a wave's results
    are read from card 0, with each card's control words beside them."""

    def __init__(self, names: ResourceNames, plugin_args: dict | None = None,
                 device="cuda", context=None, recorder=None):
        from ...parallel.mesh import context_from_env

        self.device = resolve_device(device)
        # the scheduler's wave recorder (wave records, device telemetry,
        # breaker transitions, gang routing), or one of the backend's own
        self.recorder = recorder if recorder is not None else WaveRecorder()
        # the accounted host<->device seam: transfer ledger, compile
        # tracker, memory watermark (the recorder's)
        self.telemetry = self.recorder.device_telemetry
        if self.device.type == "cuda":
            self.telemetry.device = self.device
        # the execution-context seam (parallel/mesh.py): LocalContext (K1 +
        # K2) or a MeshContext over node shards (K1 + K6), chosen once
        # (KUBE_TPU_MESH_DEVICES when none is passed); every upload and
        # kernel entry goes through it
        self._ctx = context if context is not None else context_from_env(device=self.device)
        if not _same_card(self._ctx.device, self.device):
            raise ValueError(f"the context runs on {self._ctx.device}, the "
                             f"backend on {self.device}")
        # the node axis's cards (a MeshContext over several cards: every
        # plane's node axis cut into the cards' ranges, ops/cards.py)
        self.cards = getattr(self._ctx, "cards", 1)
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
        # the streaming waves' carry (device buffer two, beside the mirror
        # above): the last launched K2's output planes feed the next launch
        # directly. _carry_rows: rows placed since the carry's base;
        # _carry_anti/_carry_pref: the carry holds IPA anti/preferred terms
        # the host planes may not show yet; _carry_external: an event
        # outside the pipeline touched cluster state; _mirror_dirty: rows
        # whose mirror values are stale because the carry holds their truth
        self._carry: dict | None = None
        self._carry_rows: set[int] = set()
        self._carry_anti = False
        self._carry_pref = False
        self._carry_external = False
        self._mirror_dirty: set[int] = set()
        self._inflight: InflightWave | None = None  # the last launched wave
        self._advanced_since_launch = 0  # rng words collected since then
        # (carry, rows allowed dirty) of the wave being processed: single-pod
        # re-runs in that window see state as of THAT wave, not the
        # uncollected successor's
        self._rerun_carry: tuple[dict, set[int]] | None = None
        # pinned host buffers of uploads still in flight; a launch hands
        # them to its InflightWave
        self._staging: list[torch.Tensor] = []
        # signature dedup and cross-wave reuse of the signature table, on
        # by default as in the reference; decisions are the same either way
        self.dedup_enabled = True
        self.cross_wave_enabled = True
        self.sig_cache = SignatureScoreCache()
        self.dedup_stats = {"pods": 0, "signatures": 0, "waves": 0,
                            "xwave_hits": 0, "xwave_misses": 0,
                            "xwave_evictions": 0}
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
        # host-clock seconds per launch_batched / collect phase, summed over
        # waves: sync, features, upload (carry overlay or device_inputs,
        # kernel_config), dedup (grouping + cache lookup), tie (the word
        # frame), launch (the staged copy, K1 + K2 and the result copy
        # enqueued, the cache store), wait (collect's wait on the result
        # event: what of the device's work the host did not hide), collect
        # (the rest of collect)
        self.pipe_phase_s = {"sync": 0.0, "features": 0.0, "upload": 0.0,
                             "dedup": 0.0, "tie": 0.0, "launch": 0.0,
                             "wait": 0.0, "collect": 0.0}
        # launches by kind, and per collected wave (the last 4096): chained
        # or not, host seconds in launch_batched and in collect's wait
        self.pipe_stats = {"launches": 0, "chained": 0, "xwave_launches": 0}
        self.wave_log: collections.deque = collections.deque(maxlen=4096)
        # the phases of run(), summed over pods: as above, with the pod's
        # kernel_config timed apart (config), upload = device_inputs (K3)
        # + packed features, launch = K4 enqueue, wait = the one packed
        # result copy
        self.run_phase_s = {"sync": 0.0, "features": 0.0, "config": 0.0,
                            "upload": 0.0, "launch": 0.0, "wait": 0.0}
        # the phases of run_gang, summed over gangs: masks (the placement
        # mask stack), upload = device_inputs + kernel_config + features,
        # masks and tie words; kernel = K1 + K5 enqueue; wait = the one
        # packed result copy
        self.gang_phase_s = {"sync": 0.0, "features": 0.0, "masks": 0.0,
                             "upload": 0.0, "kernel": 0.0, "wait": 0.0}
        # errors the gang planner's catch-all degraded to the host cycle
        # (a failed K1/K5 build or launch among them), and the last message
        self.gang_errors = 0
        self.gang_last_error = ""

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
        # a pipelined wave may have placed the first anti/preferred-term
        # pod on the device carry before the host planes show it: the
        # statics stay on (_carry_anti/_carry_pref)
        existing_anti = (bool(planes.ipa_anti[: planes.n].any()) or wave_anti
                         or self._carry_anti)
        existing_pref = (bool(planes.ipa_pref[: planes.n].any()) or wave_pref
                         or self._carry_pref)
        return KernelConfig(
            strategy=self.strategy,
            fit_resources=self.fit_resources,
            rtc_shape=self.rtc_shape,
            topo_domains=self.builder.topo_domains(planes),
            max_constraints=mc,
            n_hard=n_hard,
            n_soft=n_soft,
            ipa_existing_anti=existing_anti,
            ipa_existing_pref=existing_pref,
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

    def device_inputs(self, planes, rec=None) -> tuple[dict, dict]:
        """(node planes + ipa_term_key, affinity tables) mirrored on the
        device.

        Call AFTER feature extraction — features intern affinity signatures.
        A full put on cold start, a bucket reshape, lost row tracking, or a
        dirty set past half the cluster; otherwise the rows changed since
        the last upload (the mirror debt a dropped carry left included)
        travel in ONE packed host→device copy from pinned memory and K3
        scatters them into every row plane in one launch. The bytes land
        on the device telemetry (and on `rec`, a wave's record)."""
        full = (
            self._device_planes is None
            or self._pending_dirty is None
            or self._device_buckets != planes.bucket_sizes
            or len(self._pending_dirty) > max(64, planes.n // 2)
        )
        tel = self.telemetry
        if full:
            self._cold_start_upload(planes, rec)
            # the only upload that changes the mirror's size
            tel.note_resident("planes", tree_nbytes(self._device_planes), rec)
        elif self._pending_dirty and self.cards > 1:
            idx = np.array(sorted(self._pending_dirty), np.int32)
            self._scatter_cards(planes, idx, rec)
        elif self._pending_dirty:
            idx = np.array(sorted(self._pending_dirty), np.int32)
            rows = self._upload_rows(planes.as_dict(), idx, rec)
            tel.account_upload("delta_idx", idx.nbytes, rec)
            # K3's first use at these planes' shapes and a pow2 bucket of
            # rows (the reference pads its scatter index to one)
            n = next_pow2(len(idx), floor=8)
            with tel.compile_span("scatter_rows", ("scatter", planes.bucket_sizes, n),
                                  label=f"rows{n}", record=rec):
                scatter_rows(self._device_planes, rows, self._pinned_copy(idx))
            self.upload_stats["scatter"] += 1
            self.upload_stats["rows"] += len(idx)
        self._device_buckets = planes.bucket_sizes
        self._pending_dirty = set()
        self._fresh_term_key(planes, rec)
        self._refresh_tables(planes, rec)
        if self._logtab is None or self._logtab.shape[0] != planes.nb + 1:
            table = log_weight_table(planes.nb)
            tel.account_upload("log_weights", table.nbytes, rec)
            self._logtab = self._ctx.put_replicated(table)
        return self._overlay({})

    def _scatter_cards(self, planes, idx: np.ndarray, rec=None) -> None:
        """The dirty rows over several cards: each row to the card that owns
        it, at its card-local index; per card one packed copy and one K3
        launch on that card's planes (a card none of whose rows is dirty
        gets nothing)."""
        tel = self.telemetry
        host = planes.as_dict()
        for c, (lo, hi) in enumerate(self._ctx.ranges(planes.nb)):
            own = idx[(idx >= lo) & (idx < hi)]
            if not own.size:
                continue
            local = (own - lo).astype(np.int32)
            rows = self._upload_rows(host, own, rec, card=c)
            tel.account_upload("delta_idx", local.nbytes, rec)
            n = next_pow2(len(own), floor=8)
            dst = {k: self._device_planes[k].parts[c] for k in SLICE_PLANES}
            with torch.cuda.device(dst["alloc"].device) if dst["alloc"].is_cuda \
                    else contextlib.nullcontext():
                with tel.compile_span("scatter_rows",
                                      ("scatter", planes.bucket_sizes, n, self.cards),
                                      label=f"rows{n}/x{self.cards}", record=rec):
                    scatter_rows(dst, rows, self._pinned_copy(local, card=c))
            self.upload_stats["scatter"] += 1
        self.upload_stats["rows"] += len(idx)

    def _cold_start_upload(self, planes, rec=None) -> None:
        """The full put of the node planes: cold start, bucket reshape, lost
        row tracking, or a dirty set so large a put beats the scatter. The
        mirror is then exact: no mirror debt remains."""
        host = planes.as_dict()
        self._device_planes = self.telemetry.accounted_put(
            "node_planes", {k: host[k] for k in SLICE_PLANES}, put=self._ctx.put,
            record=rec)
        self._uploaded_term_key = None
        self._mirror_dirty = set()
        self.upload_stats["full"] += 1

    def _fresh_term_key(self, planes, rec=None) -> None:
        """Re-upload the global ipa_term_key table when its host content
        moved (a term interned mid-run): it is not row-indexed, so the
        scatter skips it, and a stale copy would map the new term to key
        slot -1 (every node rejected). Called from every place that
        assembles device inputs, the carry overlay included."""
        if (self._uploaded_term_key is not None
                and np.array_equal(self._uploaded_term_key, planes.ipa_term_key)):
            return
        self._uploaded_term_key = planes.ipa_term_key.copy()
        self._device_term_key = self._ctx.put(self._uploaded_term_key, "ipa_term_key")
        self.telemetry.account_upload("ipa_term_key", self._uploaded_term_key.nbytes, rec)

    def _refresh_tables(self, planes, rec=None) -> None:
        tables = self.extractor.affinity_tables(planes)
        if self._tables_src is not tables:
            self._device_tables = self.telemetry.accounted_put(
                "affinity_tables", tables, put=self._ctx.put, record=rec)
            self._tables_src = tables
            self.telemetry.note_resident(
                "tables", tree_nbytes(self._device_tables), rec)

    def _overlay(self, carry: dict) -> tuple[dict, dict]:
        """The device inputs: the mirror with `carry`'s planes over it."""
        return ({**self._device_planes, **carry, "ipa_term_key": self._device_term_key},
                self._device_tables)

    def _carry_view(self, planes) -> tuple[dict, dict]:
        """Device inputs for a single-pod or gang cycle while the pipeline's
        carry is live (the reference's _carry_view, backend.py:534-572).

        In a wave's result-processing window (collect set _rerun_carry) the
        cycle reads THAT wave's output planes, not the uncollected
        successor's. Host assumes of the wave's own pods dirty exactly the
        rows its outputs already hold, so those rows are consumable (the
        mirror owes them); any other dirt, or no window and any dirt at
        all, drops the carry and falls back to the mirror."""
        if self._carry is not None:
            compatible = (
                not self._carry_external
                and self._device_buckets == planes.bucket_sizes
                and self._pending_dirty is not None
            )
            if compatible and self._rerun_carry is not None:
                carry, allowed = self._rerun_carry
                if not (self._pending_dirty - allowed):
                    self._mirror_dirty |= self._pending_dirty
                    self._pending_dirty = set()
                    self._refresh_tables(planes)
                    self._fresh_term_key(planes)
                    return self._overlay(carry)
            elif compatible and self._pending_dirty == set():
                self._refresh_tables(planes)
                self._fresh_term_key(planes)
                return self._overlay(self._carry)
            self.invalidate_carry()
        return self.device_inputs(planes)

    def _pinned_copy(self, a: np.ndarray, card: int | None = None):
        """One host array on the backend's device (over several cards: a copy
        on every card, or on card `card` alone). To a card: through a
        pinned buffer and a non-blocking copy (a copy from pageable memory
        would block the host until every kernel queued before it is done);
        the buffer stays referenced in _staging until its wave is
        collected. On the CPU: the array itself."""
        a = np.ascontiguousarray(a)
        if self.device.type != "cuda":
            host = torch.from_numpy(a)
        else:
            host = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
            host.numpy()[...] = a
            self._staging.append(host)
        if card is not None:
            return self._ctx.put_card(host, card)
        if self.device.type != "cuda" and self.cards == 1:
            return host
        return self._ctx.put_replicated(host)

    def _stage(self, parts: list[np.ndarray]) -> list[torch.Tensor]:
        """int32 (or uint32, same bits) arrays on the device through ONE
        pinned copy; returns views of it shaped as the arrays."""
        flat = np.concatenate(
            [np.ascontiguousarray(a).view(np.int32).reshape(-1) for a in parts])
        dev = self._pinned_copy(flat)
        out, off = [], 0
        for a in parts:
            out.append(dev[off: off + a.size].view(a.shape))
            off += a.size
        return out

    def _fetch_async(self, t):
        """(host tensor, event): t's copy to pinned host memory enqueued
        right behind the kernel that writes it, and the event collect waits
        on. On the CPU: (t, None). Over several cards t is card 0's copy,
        and the event (_CardEvents) also waits for each card's control
        words, copied behind the launch on that card, which collect
        checks: a card rank that never arrived raises there."""
        if self.device.type != "cuda":
            return _first(t), None
        t0 = _first(t)
        host = torch.empty(t0.shape, dtype=t0.dtype, pin_memory=True)
        host.copy_(t0, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t0.device))
        if self.cards == 1:
            return host, ev
        evs, ctls = [ev], []
        for c, ctl in enumerate(self._ctx.card_set.ctl):
            h = torch.empty(ctl.shape, dtype=ctl.dtype, pin_memory=True)
            h.copy_(ctl, non_blocking=True)
            e = torch.cuda.Event()
            e.record(torch.cuda.current_stream(ctl.device))
            evs.append(e)
            ctls.append(h)
        return host, _CardEvents(evs, ctls)

    def _upload_rows(self, host: dict, idx: np.ndarray, rec=None, card: int | None = None) -> dict:
        """Gather the dirty rows of every mirrored plane into one byte
        buffer (16-byte aligned per plane), copy it to the device once, and
        return per-plane views of it in the device planes' dtypes (over
        several cards: to card `card` alone, which owns every row)."""
        parts, offs, off = [], {}, 0
        for k in SLICE_PLANES:
            b = np.ascontiguousarray(host[k][idx]).view(np.uint8).reshape(-1)
            offs[k] = (off, b.size)
            parts.append((off, b))
            off += (b.size + 15) // 16 * 16
        buf = np.zeros(off, np.uint8)
        for o, b in parts:
            buf[o: o + b.size] = b
        self.telemetry.account_upload("delta_rows", buf.nbytes, rec)
        dev = self._pinned_copy(buf, card=card)
        rows = {}
        for k in SLICE_PLANES:
            o, size = offs[k]
            t = self._device_planes[k]
            if card is not None:
                t = t.parts[card]
            rows[k] = dev[o: o + size].view(t.dtype).view((len(idx),) + tuple(t.shape[1:]))
        return rows

    # -- the batched wave ------------------------------------------------------

    def run_batched(self, pods: list[Pod], snapshot, rng=None,
                    pad_to: int = 0):
        """Greedy batched assignment of a pod wave on the device, serially:
        no chaining and no cross-wave reuse (the reference's run_batched,
        backend.py:594-654). A live carry is dropped first (its mirror debt
        folds into the next upload); a wave in flight must be collected
        before.

        With rng (the scheduling algorithm's seeded random.Random) the wave's
        tie-breaks are bit-identical to the host path scheduling the same
        pods sequentially: the rng's future getrandbits(32) stream is cloned
        into the kernel, and the live rng is advanced by exactly the words
        the kernel consumed.

        Returns (node names per pod or None, planes). The caller applies the
        same assumes host-side so cache and device state stay coherent."""
        if self._inflight is not None:
            raise RuntimeError("a pipelined wave is in flight: collect it first")
        if self._carry is not None:
            self.invalidate_carry()
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
        parts = [rows, tie_words] + ([] if groups is None else list(groups[:2]))
        self.telemetry.account_upload("features", sum(a.nbytes for a in parts))
        staged = self._stage(parts)
        packed_f, words = staged[:2]
        sig_ids, uniq = (None, None) if groups is None else staged[2:]
        blocks = self._scan_blocks(cfg, dev_planes)
        t3 = time.perf_counter()
        with self.telemetry.compile_span(
                "batched_assign",
                (cfg, planes.bucket_sizes, n_slots,
                 0 if groups is None else len(groups[1]), rng is not None,
                 False, False, self._ctx.n_shards, blocks),
                label=_wave_label(planes.bucket_sizes, n_slots,
                                  None if groups is None else groups[1], blocks)):
            out = self._ctx.batched_assign(cfg, dev_planes, dev_tables, packed_f, layout,
                                           words, self._logtab, sig_ids=sig_ids,
                                           uniq_idx=uniq)
        if "tiers" in out:
            self.tier_steps += _first(out["tiers"])
        t4 = time.perf_counter()
        # ONE device→host copy: winners ++ [tie_consumed, tie_overflow]
        packed = self.telemetry.accounted_fetch("results", out["packed"]).numpy()
        self._ctx_check()
        self._staging = []
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

    def _ctx_check(self) -> None:
        """Over several cards: raise where a card rank never arrived."""
        if self.cards > 1:
            self._ctx.check()

    def _scan_blocks(self, cfg: KernelConfig, dev_planes: dict) -> tuple[int, int]:
        """The launch plan's blocks and passes for this wave's scan (K2, or
        K6 over the context's shards; kernels.plan_key), and over several
        cards their count: part of the first-use signature, since a new
        block, pass or card count is a new kernel instance."""
        if self.cards > 1:
            nb, R = dev_planes["alloc"].shape
            dev = dev_planes["alloc"].device
            cap = (scan_limits(dev)["max_blocks"] if dev.type == "cuda"
                   else SCAN_MAX_BLOCKS)
            plan = card_scan_plan(cfg, nb // self.cards, self._ctx.mesh.shards_per_card, R,
                                  dev_planes["sel_counts"].shape[1], cap)
            return plan_key(plan) + (self.cards,)
        n = self._ctx.n_shards if self._ctx.is_sharded else None
        return plan_key(scan_plan_for("sharded_assign" if n else "assign_scan", cfg,
                                      dev_planes, n))

    def _group_wave(self, rows: np.ndarray, n_real: int):
        """Signature-group a (possibly padded) packed feature batch: (sig_ids
        [P], uniq_idx [G_pad], sig_bytes [G]) for batched_assign, or None
        with dedup off. uniq_idx is padded to a power of two (floor 8) by
        repeating the first group's slot, as the reference pads it
        (backend.py:656-682); only the first G rows are ever installed.
        sig_bytes holds the G groups' packed-row bytes: the cross-wave
        cache's key material."""
        if not self.dedup_enabled:
            return None
        sig_ids, uniq = group_feature_rows(rows)
        self.dedup_stats["pods"] += n_real
        self.dedup_stats["signatures"] += int(sig_ids[:n_real].max()) + 1
        self.dedup_stats["waves"] += 1
        sig_bytes = tuple(rows[i].tobytes() for i in uniq)
        gp = next_pow2(len(uniq), floor=8)
        if gp > len(uniq):
            uniq = np.concatenate([uniq, np.full(gp - len(uniq), uniq[0], np.int32)])
        return sig_ids, uniq, sig_bytes

    # -- the streaming wave ----------------------------------------------------

    def invalidate_carry(self) -> None:
        """Drop the carry. The mirror stays valid except for the rows the
        carry owned (_mirror_dirty), folded into _pending_dirty so the next
        device_inputs repairs them with one K3 scatter; a full put is still
        owed where row tracking itself was lost. The resident signature
        rows are scores against the carry planes and die with it. Dropping
        a live carry counts on the recorder (the open records' windows)."""
        if self._carry is not None:
            self.recorder.carry_invalidated()
        self._carry = None
        self._carry_rows = set()
        self._carry_anti = self._carry_pref = False
        self._carry_external = False
        self._rerun_carry = None
        if self._pending_dirty is not None:
            self._pending_dirty |= self._mirror_dirty
        self._mirror_dirty = set()
        self.sig_cache.clear()
        self.telemetry.note_resident("carry", 0)
        self.telemetry.note_resident("sig_table", 0)

    def mark_external(self) -> None:
        """An event outside the pipeline's own writeback touched cluster
        state (a node change, a foreign pod's add/update/delete, a host-path
        assume or forget): the next launch drains and re-uploads. A no-op
        while no carry is live."""
        if self._carry is not None:
            self._carry_external = True

    def launch_batched(self, pods: list[Pod], snapshot, rng=None,
                       pad_to: int = 0) -> InflightWave:
        """Enqueue one wave's K1 + K2 without waiting for its result (the
        reference's launch_batched, backend.py:832-1009).

        K2's input planes are the previous launch's output planes, still on
        the device, so consecutive launches chain with no host round trip
        while the host processes the wave before. The tie words are the
        live rng's next (2*pad+1)*MAX_TIE_DRAWS words; an uncollected
        predecessor's final cursor reaches K2 as a device scalar, shifted
        by the words collected since that predecessor's launch.

        Raises NeedResync when the carry cannot absorb host-side changes
        (the caller drains the pipeline, invalidates the carry and
        retries), FallbackNeeded for a pod the extractor refuses, and
        DeviceFlakeError for an injected launch fault.

        The wave's record opens here (fl.record) and closes at collect on
        a fallback, else in the loop after the wave's binds; a NeedResync
        closes it with "resync: <why>"."""
        try:
            # before any state is touched: an injected launch flake leaves
            # the carry, the in-flight frame and the rng as they were
            faultinject.fire("tpu.launch")
        except faultinject.FaultInjected as e:
            raise DeviceFlakeError(f"injected launch fault: {e}") from e
        self._rerun_carry = None  # a new launch closes any re-run window
        rec = self.recorder.begin_wave(pods=len(pods))
        t0 = time.perf_counter()
        for pod in pods:
            self.extractor.register(pod)
        planes = self.sync(snapshot)
        t1 = time.perf_counter()
        feats = stack_features(
            [self.extractor.features_cached(p, planes) for p in pods])
        if pad_to > len(pods):
            feats = pad_features(feats, pad_to)
        pad = max(pad_to, len(pods))
        rec.pad = pad
        t2 = time.perf_counter()

        prev = self._inflight
        chained = False
        try:
            if prev is not None and self._carry is None:
                # a cycle dropped the carry while a wave is in flight: the
                # host planes lack that wave's placements, so an upload
                # from them would double-book nodes
                raise NeedResync("carry dropped while a wave is in flight")
            if self._carry is not None:
                if self._carry_external:
                    raise NeedResync("external event touched cluster state")
                if self._device_buckets != planes.bucket_sizes:
                    raise NeedResync("plane buckets changed under the carry")
                if self._pending_dirty is None:
                    raise NeedResync("full plane rebuild required")
                external = self._pending_dirty - self._carry_rows
                if external:
                    raise NeedResync(f"{len(external)} externally-dirtied rows")
                # the remaining dirty rows are our own collected binds,
                # whose values the carry already holds: the mirror owes
                # them instead
                self._mirror_dirty |= self._pending_dirty
                self._pending_dirty = set()
                self._refresh_tables(planes, rec)
                self._fresh_term_key(planes, rec)
                dev_planes, dev_tables = self._overlay(self._carry)
                # this wave chains on exactly the planes the resident score
                # rows were scored against: cross-wave replay is sound
                chained = True
            else:
                dev_planes, dev_tables = self.device_inputs(planes, rec)
        except NeedResync as e:
            # the caller drains and retries; this attempt's record closes
            self.recorder.wave_phases(rec, (("sync", t0, t1), ("features", t1, t2)))
            self.recorder.end_wave(rec, fallback_reason=f"resync: {e}")
            raise
        cfg = self.kernel_config(planes, feats)
        t3 = time.perf_counter()

        rows, layout = pack_features(feats)
        groups = self._group_wave(rows, len(pods))
        carry_map = sig_table = xw_key = None
        if groups is not None and dedup_fast_capable(cfg):
            xw_key = (cfg, planes.bucket_sizes, len(groups[1]))
            if chained and self.cross_wave_enabled:
                carry_map = self.sig_cache.lookup(xw_key, groups[2], len(groups[1]))
                if carry_map is not None:
                    sig_table = self.sig_cache.table
        self.recorder.note_launch(
            rec, signatures=0 if groups is None else int(groups[0][: len(pods)].max()) + 1,
            dedup=groups is not None)
        t4 = time.perf_counter()
        frame_shift = self._advanced_since_launch
        cursor_init = 0
        tie_words = ZERO_TIE_WORDS
        if rng is not None:
            # the frame covers a whole predecessor and this wave
            tie_words = clone_tie_words(rng, (2 * pad + 1) * MAX_TIE_DRAWS)
            if prev is not None:
                # the predecessor's final cursor, read by K2 on the device
                cursor_init = prev.info["packed"][prev.info["packed"].shape[0] - 2]
        t5 = time.perf_counter()

        parts = [rows, tie_words]
        if groups is not None:
            parts += [groups[0], groups[1]]
        if carry_map is not None:
            parts.append(carry_map)
        self.telemetry.account_upload("features", sum(a.nbytes for a in parts), rec)
        staged = self._stage(parts)
        packed_f, words = staged[:2]
        sig_ids = uniq = dev_map = None
        if groups is not None:
            sig_ids, uniq = staged[2:4]
        if carry_map is not None:
            dev_map = staged[4]
        blocks = self._scan_blocks(cfg, dev_planes)
        with self.telemetry.compile_span(
                "batched_assign",
                (cfg, planes.bucket_sizes, pad,
                 0 if groups is None else len(groups[1]), rng is not None,
                 carry_map is not None, sig_table is not None, self._ctx.n_shards, blocks),
                label=_wave_label(planes.bucket_sizes, pad,
                                  None if groups is None else groups[1], blocks),
                record=rec):
            info = self._ctx.batched_assign(
                cfg, dev_planes, dev_tables, packed_f, layout, words, self._logtab,
                cursor_init=cursor_init, frame_shift=frame_shift if prev is not None else 0,
                sig_ids=sig_ids, uniq_idx=uniq, carry_map=dev_map, sig_table=sig_table)
        host_packed, ready = self._fetch_async(info["packed"])
        if "tiers" in info:
            self.tier_steps += _first(info["tiers"])
        if xw_key is not None and "sig_table" in info:
            if carry_map is None:
                # nothing replayed (cold cache, fresh upload, reuse off):
                # this wave's table starts a fresh generation
                self.sig_cache.clear()
            hit, miss, evict = self.sig_cache.store(xw_key, info["sig_table"], groups[2])
            self.dedup_stats["xwave_hits"] += hit
            self.dedup_stats["xwave_misses"] += miss
            self.dedup_stats["xwave_evictions"] += evict
            self.recorder.note_cross_wave(rec, hit, miss, evict)
        else:
            self.sig_cache.clear()
        # the next launch chains on these outputs
        self._carry = {k: info[k] for k in ("used", "nonzero_used", "sel_counts")}
        for k in ("ipa_counts", "ipa_anti", "ipa_pref"):
            if k in info:
                self._carry[k] = info[k]
        self._carry_anti = self._carry_anti or bool(feats["ipa_anti_add"].any())
        self._carry_pref = self._carry_pref or bool(feats["ipa_pref_add"].any())
        # the carry overlay and the resident score table now hold device
        # memory: fold the new live total into the wave's high-water mark
        self.telemetry.note_resident("carry", tree_nbytes(self._carry))
        self.telemetry.note_resident("sig_table", tree_nbytes(self.sig_cache.table))
        self.telemetry.stamp_watermark(rec)
        fl = InflightWave(pods, planes, info, pad, frame_shift,
                          sig_ids=None if groups is None else groups[0])
        fl.host_packed, fl.ready = host_packed, ready
        fl.staged, self._staging = self._staging, []
        fl.chained = chained
        fl.record = rec
        if prev is None:
            fl.cursor_base_host = 0
        self._inflight = fl
        self._advanced_since_launch = 0
        t6 = time.perf_counter()
        fl.launch_s = t6 - t0
        for k, a, b in (("sync", t0, t1), ("features", t1, t2), ("upload", t2, t3),
                        ("dedup", t3, t4), ("tie", t4, t5), ("launch", t5, t6)):
            self.pipe_phase_s[k] += b - a
        self.recorder.wave_phases(rec, (
            ("sync", t0, t1), ("features", t1, t2), ("upload", t2, t3),
            ("dedup", t3, t4), ("tie", t4, t5), ("dispatch", t5, t6)))
        self.pipe_stats["launches"] += 1
        self.pipe_stats["chained"] += int(chained)
        self.pipe_stats["xwave_launches"] += int(carry_map is not None)
        # pipeline overlap: with a predecessor in flight every host prep
        # phase above ran while the device executed it (hidden time)
        self.recorder.note_pipeline(rec, overlapped=prev is not None)
        # the stall profiler's double-buffer handoff bit (a chained launch
        # vs a launch into an idle device)
        self.recorder.stall_profiler.note_handoff(rec, chained=prev is not None)
        return fl

    def collect(self, fl: InflightWave, rng=None):
        """Wait for a launched wave's packed result (its event, not the
        stream: a successor's kernels may run on), advance the live rng by
        exactly the words it consumed, and absorb its placements into the
        carry bookkeeping (the reference's collect, backend.py:1011-1074).
        Returns (hosts, planes).

        Raises FallbackNeeded for a poisoned wave or a tie-draw overflow,
        and DeviceFlakeError for an injected collect fault: results
        discarded, rng untouched, carry invalidated (the caller must poison
        a successor launched on it). Each of these closes the wave's record
        with its fallback reason."""
        rec = fl.record
        try:
            faultinject.fire("tpu.collect")
        except faultinject.FaultInjected as e:
            if self._inflight is fl:
                self._inflight = None
            self.invalidate_carry()
            if rec is not None:
                self.recorder.end_wave(rec, fallback_reason=f"injected: {e}")
            raise DeviceFlakeError(f"injected collect fault: {e}") from e
        t0 = time.perf_counter()
        if fl.ready is not None:
            fl.ready.synchronize()
        packed = fl.host_packed.numpy()
        if isinstance(fl.ready, _CardEvents):
            fl.ready.check(self._ctx)
        fl.staged = []  # every copy of this wave is done
        t1 = time.perf_counter()
        # the result copy enqueued at launch has landed: count its bytes
        self.telemetry.account_fetch("results", packed.nbytes, rec)
        self.recorder.wave_phases(rec, (("wait", t0, t1),))
        try:
            return self._absorb(fl, packed, rng)
        finally:
            t2 = time.perf_counter()
            self.pipe_phase_s["wait"] += t1 - t0
            self.pipe_phase_s["collect"] += t2 - t1
            self.wave_log.append({"chained": fl.chained, "launch_s": fl.launch_s,
                                  "wait_s": t1 - t0, "collect_s": t2 - t1})

    def _absorb(self, fl: InflightWave, packed: np.ndarray, rng):
        winners = packed[: len(fl.pods)]
        final_abs, overflow = int(packed[-2]), bool(packed[-1])
        if self._inflight is fl:
            self._inflight = None
        rec = fl.record
        if fl.poisoned:
            self.invalidate_carry()
            if rec is not None:
                self.recorder.end_wave(
                    rec, fallback_reason="poisoned: predecessor diverged")
            raise FallbackNeeded("predecessor wave diverged host-side")
        if rng is not None and overflow:
            self.invalidate_carry()
            if rec is not None:
                self.recorder.end_wave(
                    rec, fallback_reason="overflow: tie-break draw overflow")
            raise FallbackNeeded("tie-break draw overflow")
        if rng is not None:
            if fl.cursor_base_host is None:
                raise RuntimeError("wave collected before its predecessor")
            own = final_abs - fl.cursor_base_host
            # the live rng is past every wave collected before: advance it by
            # exactly this wave's words
            advance_rng(rng, own)
            self._advanced_since_launch += own
            succ = self._inflight
            if succ is not None and succ.cursor_base_host is None:
                # the successor's draws start where ours ended, in its frame
                succ.cursor_base_host = final_abs - succ.frame_shift
        win_rows = {int(w) for w in winners if w >= 0}
        self._carry_rows.update(win_rows)
        # open this wave's re-run window (see _carry_view)
        if self._carry is not None:
            carried = {k: fl.info[k] for k in self._carry if k in fl.info}
            self._rerun_carry = (carried, win_rows)
        hosts = [fl.planes.node_names[w] if w >= 0 else None for w in winners]
        return hosts, fl.planes

    # -- the gang wave ---------------------------------------------------------

    def run_gang(self, pods: list[Pod], snapshot, placements,
                 n_constrained: int, has_fallback: bool, rng):
        """Whole-PodGroup device placement: ONE K1 launch over the members
        and ONE K5 launch scan the gang over every placement mask at once
        (the reference's TPUBackend.run_gang, backend.py:684-812).

        `placements` is the PlacementGenerate output in plugin order: rows
        [0, n_constrained) the topology domains and, with has_fallback, row
        n_constrained the unconstrained parent. Returns (hosts aligned with
        `pods`, the winning placement row, the gang wave's record), or None
        when the gang must ride the host cycle (no feasible domain, tie
        overflow on a real row, a member the extractor refuses). The live
        rng advances by the winning row's tie draws ONLY on success. Every
        return closes the record (gang_outcome "device:<placement>" or
        "fallback:<reason>"); the recorder counts the device members."""
        rec = self.recorder.begin_wave(pods=len(pods))
        rec.gang_groups = 1
        rec.gang_pods = len(pods)
        t0 = time.perf_counter()
        try:
            for pod in pods:
                self.extractor.register(pod)
            planes = self.sync(snapshot)
            t1 = time.perf_counter()
            feats = stack_features(
                [self.extractor.features_cached(p, planes) for p in pods])
        except FallbackNeeded as e:
            rec.gang_fallback_pods = len(pods)
            rec.gang_outcome = f"fallback:{e}"
            self.recorder.end_wave(rec, fallback_reason=str(e))
            return None
        pad_to = next_pow2(len(pods), floor=4)
        if pad_to > len(pods):
            feats = pad_features(feats, pad_to)
        t2 = time.perf_counter()
        # masks in host placement order; pad rows (pow2 shape) stay
        # all-False and can never win (an empty valid set places nobody)
        n_rows = next_pow2(len(placements), floor=2)
        masks = placement_masks(planes, [list(p.node_names) for p in placements], n_rows)
        t3 = time.perf_counter()
        # inside a pipelined wave's re-run window the gang reads that wave's
        # output planes (the carry); else the mirror
        dev_planes, dev_tables = self._carry_view(planes)
        cfg = self.kernel_config(planes, feats)
        # one frame covers the worst single row: every row replays the
        # stream from cursor 0, as the host's dry runs restore the rng
        tie_words = clone_tie_words(rng, pad_to * MAX_TIE_DRAWS + MAX_TIE_DRAWS)
        rows, layout = pack_features(feats)
        tel = self.telemetry
        tel.account_upload("features", rows.nbytes + tie_words.nbytes, rec)
        tel.account_upload("gang_masks", masks.nbytes, rec)
        packed_f = torch.from_numpy(rows).to(self.device)
        words = torch.from_numpy(tie_words.view(np.int32)).to(self.device)
        dev_masks = torch.from_numpy(masks).to(self.device)
        # the masks are host arrays: their largest row sizes K5's blocks per
        # row (and past the card's largest cluster its passes) with no
        # device round trip
        population = int(masks.sum(axis=1).max()) if n_rows else 0
        blocks = plan_key(scan_plan_for("gang_assign", cfg, dev_planes,
                                        population=population))
        t4 = time.perf_counter()
        with tel.compile_span(
                "gang_assign",
                (cfg, planes.bucket_sizes, pad_to, n_rows, int(n_constrained),
                 bool(has_fallback), self._ctx.n_shards, blocks),
                label=(f"gang{pad_to}/d{n_rows}/{_bucket_label(planes.bucket_sizes)}"
                       + _blocks_label(blocks)),
                record=rec):
            static = static_parts(dev_planes, dev_tables, packed_f, layout)
            packed_dev = gang_assign(cfg, dev_planes, static, packed_f, layout, dev_masks,
                                     words, self._logtab, n_constrained, has_fallback,
                                     population=population)
        t5 = time.perf_counter()
        # ONE device→host copy carries the whole gang verdict
        packed = tel.accounted_fetch("results", packed_dev, rec).numpy()
        self._staging = []
        t6 = time.perf_counter()
        marks = (("sync", t0, t1), ("features", t1, t2), ("masks", t2, t3),
                 ("upload", t3, t4), ("kernel", t4, t5), ("wait", t5, t6))
        for k, a, b in marks:
            self.gang_phase_s[k] += b - a
        self.recorder.wave_phases(rec, marks)
        d, p = n_rows, pad_to
        winners = packed[: d * p].reshape(d, p)
        consumed = packed[d * p: d * p + d]
        overflow = packed[d * p + d: d * p + 2 * d]
        placed = packed[d * p + 2 * d: d * p + 3 * d]
        win_d, ok = int(packed[-3]), bool(packed[-2])
        n_real = len(placements)
        check_gang_rows(overflow)
        if overflow[:n_real].any():
            # a truncated draw desynchronizes that row's verdict, not just
            # its stream: the whole gang verdict is untrustworthy (a pad
            # row's overflow does not count)
            rec.gang_fallback_pods = len(pods)
            rec.gang_outcome = "fallback:tie-break draw overflow"
            self.recorder.end_wave(
                rec, fallback_reason="gang tie-break draw overflow")
            return None
        if not ok:
            # the near miss: the row that placed the most members
            near = int(np.argmax(placed[:n_real])) if n_real else -1
            hint = ""
            if near >= 0:
                hint = (f" near={placements[near].name}"
                        f" placed={int(placed[near])}/{len(pods)}")
            rec.gang_fallback_pods = len(pods)
            rec.gang_outcome = "fallback:no-domain" + hint
            self.recorder.end_wave(
                rec, fallback_reason="gang: no feasible domain")
            return None
        hosts = [planes.node_names[int(w)] for w in winners[win_d][: len(pods)]]
        advance_rng(rng, int(consumed[win_d]))
        rec.gang_outcome = f"device:{placements[win_d].name}"
        self.recorder.end_wave(rec)
        self.recorder.count_gang_pods("device", len(pods))
        return hosts, win_d, rec

    # -- the single-pod cycle --------------------------------------------------

    def run(self, pod: Pod, snapshot):
        """One pod against the whole cluster in one K4 launch; returns
        (planes, {fails, feasible, insufficient, too_many_pods, total} as
        numpy). Raises FallbackNeeded when the pod is not kernelizable.

        The device inputs come from _carry_view: in a pipelined wave's
        re-run window the pod reads that wave's output planes, as the
        reference's run does (ROADMAP C10 names what that view holds).
        The kernel writes every output into one packed buffer, so the
        results come back in ONE device→host copy (views of it)."""
        t0 = time.perf_counter()
        self.extractor.register(pod)
        planes = self.sync(snapshot)
        t1 = time.perf_counter()
        f = self.extractor.features(pod, planes)
        t2 = time.perf_counter()
        # before kernel_config: dropping the carry clears its IPA statics
        dev_planes, dev_tables = self._carry_view(planes)
        t3 = time.perf_counter()
        cfg = self.kernel_config(planes, f)
        t4 = time.perf_counter()
        packed_f, layout = features_from_reference(stack_features([f]), self.device)
        if self.cards > 1:
            packed_f = self._ctx.put_replicated(packed_f)
        self.telemetry.account_upload("features", packed_f.nbytes)
        t5 = time.perf_counter()
        with self.telemetry.compile_span(
                "fit_and_score", (cfg, planes.bucket_sizes, self._ctx.n_shards),
                label=_bucket_label(planes.bucket_sizes)):
            packed = self._ctx.fit_and_score(cfg, dev_planes, dev_tables, packed_f,
                                             layout, self._logtab)
        t6 = time.perf_counter()
        n_fails = len(FILTER_NAMES) + 2 * cfg.max_constraints + 3
        if self.cards > 1:
            # each card's outputs over its range, joined on the host
            out = fit_outputs(packed, 0, n_fails, planes.r)
            self.telemetry.account_fetch("scores", sum(int(t[0].numel()) for t in packed.parts))
            self._ctx_check()
        else:
            host = self.telemetry.accounted_fetch("scores", packed[0])
        self._staging = []
        t7 = time.perf_counter()
        for k, a, b in (("sync", t0, t1), ("features", t1, t2), ("upload", t2, t3),
                        ("config", t3, t4), ("upload", t4, t5), ("launch", t5, t6),
                        ("wait", t6, t7)):
            self.run_phase_s[k] += b - a
        if self.cards == 1:
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
    node on get() (memoized). Overlays written via set() — the hybrid
    path's host-stage verdicts, preemption's — take precedence (they are
    more specific)."""

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
        self._unsched_names = None
        self._fit_names = None
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

    def set(self, node_name: str, status: Status) -> None:
        super().set(node_name, status)
        self._unsched_names = None  # overlays invalidate the bulk caches
        self._fit_names = None

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
        candidate precheck), in one vectorized pass, cached until the next
        overlay. Overlay entries take precedence."""
        if self._unsched_names is not None:
            return self._unsched_names
        rows = [r for r, name in enumerate(self._row_names)
                if name.split(":")[0] in self._UNSCHEDULABLE_ROWS]
        mask = self._failed & np.isin(self._first, rows)
        names = {self._planes.node_names[i] for i in np.nonzero(mask)[0]}
        for n, st in self.node_to_status.items():
            if st.code == UNSCHEDULABLE:
                names.add(n)
            else:
                names.discard(n)
        self._unsched_names = names
        return names

    def fit_verdict_names(self) -> set:
        """Names whose FIRST failing filter is NodeResourcesFit (the
        batched victims-search precondition), cached until the next
        overlay."""
        if self._fit_names is not None:
            return self._fit_names
        fit_row = self._row_names.index("NodeResourcesFit")
        mask = self._failed & (self._first == fit_row)
        names = {self._planes.node_names[i] for i in np.nonzero(mask)[0]}
        for n, st in self.node_to_status.items():
            if st.plugin == "NodeResourcesFit":
                names.add(n)
            else:
                names.discard(n)
        self._fit_names = names
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


class TorchSchedulingAlgorithm(SchedulingAlgorithm):
    """schedulePod with K4 on the hot path: a copy of the reference's
    TPUSchedulingAlgorithm (kubernetes_tpu/scheduler/tpu/backend.py:
    1346-1763), less the volume wave plans.

    Inherits select_host (seeded-rng tie-break) and the host algorithm for
    the host tier, so decisions match the host algorithm bit-for-bit at
    percentageOfNodesToScore=100. The routes:
    - kernel: K4 over every node, the winner the max total with the seeded
      rng's randrange over the tied winners in node order;
    - hybrid (`_schedule_hybrid`): K4's feasibility and totals, with the
      host chain's remaining plugins (the volume plugins, DynamicResources,
      NodeDeclaredFeatures, and the two-pass nominated-pod filter on nodes
      holding nominations of equal or higher priority) on the
      kernel-feasible nodes, then the interested extenders' filter and
      weighted scores;
    - nominee fast path (`_evaluate_nominated`): a preemptor's nominated
      node checked host-side first;
    - host tier (`super().schedule_pod`): a pod the extractor refuses
      (FallbackNeeded), and every pod while the circuit breaker is OPEN
      and cooling (`device_blocked()`).
    OutOfSlice (a pod the extractor accepts whose shapes pass the kernels'
    capacities) is never routed to the host: it propagates.

    The breaker counts the device failures the scheduling loop records:
    DeviceFlakeError, which only an injected tpu.launch or tpu.collect
    fault raises. On the card a kernel error raises instead, so it never
    trips the breaker and never sends pods to the host tier.
    """

    def __init__(self, framework, backend: TorchBackend, rng=None,
                 nominator=None, host_tail_percentage: int = 0,
                 extenders: list | None = None):
        super().__init__(framework, percentage_of_nodes_to_score=100,
                         rng=rng, nominator=nominator, extenders=extenders)
        from .circuitbreaker import CircuitBreaker

        self.backend = backend
        self.fallback_count = 0
        self.kernel_count = 0
        # degradation ladder rung 3: after N consecutive device failures
        # (DeviceFlakeError — benign fallbacks don't count) waves bypass
        # the device and ride the host tier until probe waves succeed
        self.breaker = CircuitBreaker(on_transition=self._on_breaker_transition)
        # pod key -> the node-neutral volume plan assumed at wave admission,
        # popped at the wave's finish (take_wave_plan) or reverted when the
        # pod re-runs per pod (revert_wave_plan)
        self._wave_plans: dict = {}
        # the kernel evaluates every node, so the kernel path stays at
        # 100%; the hybrid path's host tail follows the reference's own
        # adaptive sampling (numFeasibleNodesToFind + rotation + early
        # exit, schedule_one.go:775,862) at this percentage (0 = the
        # adaptive 50-nodes/125 formula; under 100 nodes every node)
        self.host_tail_percentage = host_tail_percentage

    @property
    def on_card(self) -> bool:
        return self.backend.device.type != "cpu"

    def _on_breaker_transition(self, old: str, new: str, reason: str) -> None:
        from .circuitbreaker import OPEN

        if new == OPEN:
            # trip: per-pod host scheduling is about to change cluster
            # state outside the wave writeback, so the resident cross-wave
            # score rows cannot be trusted past this point (the carry's own
            # NeedResync checks handle the planes)
            self.backend.sig_cache.clear()
        if self.backend.recorder is not None:
            self.backend.recorder.breaker_transition(old, new, reason)

    def schedule_pod(self, state, pod: Pod, snapshot) -> ScheduleResult:
        if snapshot.num_nodes() == 0:
            raise FitError(pod, 0, Diagnosis())
        if self.breaker.device_blocked():
            # breaker OPEN and cooling: no device round trip, straight to
            # the host tier (a pure read, no state change)
            self.fallback_count += 1
            return super().schedule_pod(state, pod, snapshot)
        pre_filter_done = None
        if pod.status.nominated_node_name:
            # evaluateNominatedNode fast path (schedule_one.go:718): try the
            # nominee host-side (ONE node); when it no longer fits, fall
            # through to the kernel/hybrid cycle
            res, pre_filter_done = self._evaluate_nominated(state, pod, snapshot)
            if res is not None:
                self.fallback_count += 1  # host-path decision
                return res
        hybrid = (self._needs_host_compose(pod)
                  or self._has_relevant_nominations(pod))
        try:
            planes, out = self.backend.run(pod, snapshot)
        except FallbackNeeded:
            self.fallback_count += 1
            return super().schedule_pod(state, pod, snapshot)
        self.kernel_count += 1
        if hybrid:
            return self._schedule_hybrid(state, pod, snapshot, planes, out,
                                         pre_filter_done=pre_filter_done)

        feasible_idx = np.flatnonzero(out["feasible"][: planes.n])
        if feasible_idx.size == 0:
            # populate the cycle state through the host PreFilter chain
            # before raising: preemption's victim dry run re-runs Filter
            # plugins against this state (preemption.go SelectVictimsOnNode)
            self.fw.run_pre_filter_plugins(state, pod, snapshot.list_nodes())
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

    def _needs_host_compose(self, pod: Pod) -> bool:
        """Pods whose long-tail stages (volume plugins, DRA, declared
        features, HTTP extenders) must run host-side on top of the kernel's
        dense feasibility and scores: the hybrid path, not a fallback."""
        if pod_claim_names(pod) or pod.spec.resource_claims:
            return True
        if infer_required_features(pod):
            return True
        # extenders ride on the feasible set exactly as in the host path
        # (filter after the in-tree plugins, prioritize added to totals)
        return any(e.is_interested(pod) for e in self.extenders)

    def wave_eligible(self, pod: Pod) -> bool:
        """Fully-kernel pods ride the batched wave, and so do claim pods
        whose volume decision is provably node-neutral
        (VolumeBinder.node_neutral_volumes): their host volume stage
        collapses to a per-pod constant the wave's finish applies after
        node selection. Admitting such a pod assumes its plan in the binder
        at once (stashed in _wave_plans), so the next pod's neutrality
        check sees this pod's chosen volume: the sequential-greedy rule the
        wave keeps for resources, kept for volumes."""
        if self._must_fall_back(pod) or self._has_relevant_nominations(pod):
            return False
        if pod.spec.resource_claims or infer_required_features(pod):
            return False
        if any(e.is_interested(pod) for e in self.extenders):
            return False
        if pod_claim_names(pod):
            binder = self._volume_binder()
            if binder is None:
                return False
            plan = binder.node_neutral_volumes(pod)
            if plan is None:
                return False
            binder.assume_pod_volumes(plan)
            self._wave_plans[pod.meta.key] = plan
        return True

    def _volume_binder(self):
        for p in self.fw.reserve_plugins:
            if isinstance(p, VolumeBinding):
                return p.binder
        return None

    def take_wave_plan(self, pod_key: str):
        """Pop the stashed node-neutral volume plan (the wave's finish)."""
        return self._wave_plans.pop(pod_key, None)

    def revert_wave_plan(self, pod: Pod) -> None:
        """Release a stashed plan's binder assumes: every wave path that
        re-runs the pod per pod (a launch fallback, a poisoned carry, a
        kernel FitError) calls this first, or the assumed PV stays
        reserved."""
        plan = self._wave_plans.pop(pod.meta.key, None)
        if plan is not None:
            self.safe_revert_volumes(plan)

    def safe_revert_volumes(self, plan) -> None:
        """Revert only the assumes that still belong to this plan's claims:
        a later pod may have re-assumed the same PV."""
        binder = self._volume_binder()
        if binder is None:
            return
        for pv_key, pvc_key in plan.static_bindings:
            if binder.assumed.get(pv_key) == pvc_key:
                binder.assumed.pop(pv_key, None)

    def _has_relevant_nominations(self, pod: Pod) -> bool:
        """Any nominated pod (≥ priority) that must be simulated during
        this pod's filtering (schedule_one.go:1190)?"""
        if self.nominator is None:
            return False
        top = self.nominator.max_nominated_priority(exclude_key=pod.meta.key)
        return top is not None and top >= pod.spec.priority

    def _schedule_hybrid(self, state, pod: Pod, snapshot, planes,
                         out, pre_filter_done=None) -> ScheduleResult:
        """Kernel feasibility/scores ∩ host long-tail plugins.

        K4 already filtered and scored the dense plugins over every node;
        the host chain runs only the remaining plugins (skip sets) on the
        kernel-feasible nodes, and their weighted scores add onto the
        kernel totals. Node order is snapshot order in both, and selection
        goes through the same select_host rng draw."""
        fw = self.fw
        nodes = snapshot.list_nodes()
        if pre_filter_done is not None:
            # PreFilter already ran this cycle (nominee fast path)
            pre_result, st = pre_filter_done
        else:
            pre_result, st = fw.run_pre_filter_plugins(state, pod, nodes)
        if not st.is_success:
            if st.is_rejected:
                d = Diagnosis()
                d.pre_filter_msg = st.message()
                if st.plugin:
                    d.unschedulable_plugins.add(st.plugin)
                raise FitError(pod, snapshot.num_nodes(), d)
            raise RuntimeError(f"prefilter failed: {st.reasons}")
        allowed = None
        if pre_result is not None and pre_result.node_names is not None:
            allowed = set(pre_result.node_names)
        # dense plugins already ran on the device: skip their host Filter.
        # Keep the UNPOLLUTED PreFilter skip set aside — preemption's victim
        # dry run re-runs the FULL host filter chain against this state and
        # must not inherit kernel skips
        prefilter_skips = set(state.skip_filter_plugins)
        state.skip_filter_plugins = prefilter_skips | set(KERNEL_FILTER_PLUGINS)
        # host-failure statuses only; the kernel's per-node failure rows are
        # materialized lazily at the FitError site
        diagnosis = Diagnosis()
        feasible_mask = out["feasible"]
        node_index = planes.node_index
        # the host long-tail stage follows findNodesThatPassFilters:775:
        # rotate the start index, evaluate kernel-feasible nodes in rotated
        # order, early-exit at numFeasibleNodesToFind
        host_nodes = (nodes if allowed is None
                      else [ni for ni in nodes if ni.name in allowed])
        num_all = len(host_nodes)
        num_to_find = num_feasible_nodes_to_find(self.host_tail_percentage, num_all)
        start = self.next_start_node_index % num_all if num_all else 0
        survivors: list[tuple[int, object]] = []
        evaluated = num_all
        pos = 0
        done = False
        while pos < num_all and not done:
            # chunk of kernel-feasible candidates, in rotated order
            chunk: list[tuple[int, object, int]] = []
            want = max(num_to_find - len(survivors), 1)
            while pos < num_all and len(chunk) < want:
                ni = host_nodes[(start + pos) % num_all]
                ki = node_index.get(ni.name)
                pos += 1
                if ki is not None and feasible_mask[ki]:
                    chunk.append((ki, ni, pos))  # pos = evaluated-if-last
            if not chunk:
                break
            noms = [self._nominated_pod_infos(pod, ni) for _, ni, _ in chunk]
            if any(noms):
                sts = []
                for (ki, ni, _), npis in zip(chunk, noms):
                    if npis:
                        # two-pass nominated treatment (schedule_one.go:1190).
                        # Pass 1 — WITH nominated pods assumed — needs the
                        # FULL chain on an unpolluted state clone: the
                        # kernel verdict didn't model them. Pass 2 — the
                        # bare node — keeps the kernel skips: out["feasible"]
                        # already IS the bare-node dense verdict.
                        state.skip_filter_plugins = prefilter_skips
                        state_clone = state.clone()
                        state.skip_filter_plugins = prefilter_skips | set(
                            KERNEL_FILTER_PLUGINS)
                        ni_with = ni.clone()
                        for npi in npis:
                            ni_with.add_pod(npi)
                            fw.run_pre_filter_extension_add_pod(
                                state_clone, pod, npi, ni_with)
                        host_st = fw.run_filter_plugins(state_clone, pod, ni_with)
                        if host_st.is_success:
                            host_st = fw.run_filter_plugins(state, pod, ni)
                    else:
                        host_st = fw.run_filter_plugins(state, pod, ni)
                    sts.append(host_st)
            else:
                sts = fw.run_filter_plugins_batch(state, pod, [ni for _, ni, _ in chunk])
            for (ki, ni, at), host_st in zip(chunk, sts):
                if host_st.is_success:
                    survivors.append((ki, ni))
                    if len(survivors) >= num_to_find:
                        evaluated = at
                        done = True
                        break
                else:
                    diagnosis.node_to_status.set(ni.name, host_st)
                    if host_st.plugin:
                        diagnosis.unschedulable_plugins.add(host_st.plugin)
        self.next_start_node_index = (start + evaluated) % num_all if num_all else 0
        if survivors and self.extenders:
            # extenders prune after the in-tree filters
            # (findNodesThatPassExtenders, schedule_one.go:890), here on the
            # kernel ∩ host feasible set
            interested = [e for e in self.extenders if e.is_interested(pod)]
            if interested:
                kept = find_nodes_that_pass_extenders(
                    interested, pod, [ni for _, ni in survivors], diagnosis)
                kept_names = {ni.name for ni in kept}
                survivors = [(i, ni) for i, ni in survivors if ni.name in kept_names]
        if not survivors:
            state.skip_filter_plugins = prefilter_skips  # see above
            # materialize the kernel's per-node failure rows now, then
            # overlay the host-stage verdicts, which are more specific
            full = self.backend.build_diagnosis(pod, planes, out)
            full.node_to_status.node_to_status.update(
                diagnosis.node_to_status.node_to_status)
            full.unschedulable_plugins |= diagnosis.unschedulable_plugins
            if allowed is not None:
                full.node_to_status.absent_nodes_status = Status.unresolvable(
                    "node(s) didn't satisfy plugin prefilter result")
            raise FitError(pod, snapshot.num_nodes(), full)
        node_infos = [ni for _, ni in survivors]
        # kernel-covered score plugins are pre-seeded into the skip set so
        # their host PreScore never runs: their weighted scores are already
        # in the kernel total (counting them host-side too would double them)
        st = fw.run_pre_score_plugins(state, pod, node_infos,
                                      skip=set(KERNEL_SCORE_PLUGINS))
        if not st.is_success:
            raise RuntimeError(f"prescore failed: {st.reasons}")
        host_scores, st = fw.run_score_plugins(state, pod, node_infos)
        if not st.is_success:
            raise RuntimeError(f"score failed: {st.reasons}")
        ext_bonus: dict[str, int] = {}
        if self.extenders:
            ext_bonus = extender_scores(self.extenders, pod, node_infos) or {}
        combined = []
        for (i, ni), host in zip(survivors, host_scores):
            combined.append(NodePluginScores(
                name=ni.name, scores=host.scores,
                total_score=(int(out["total"][i]) + host.total_score
                             + ext_bonus.get(ni.name, 0))))
        host_name, _ = self.select_host(combined)
        return ScheduleResult(suggested_host=host_name, evaluated_nodes=planes.n,
                              feasible_nodes=len(survivors))

    def _must_fall_back(self, pod: Pod) -> bool:
        # a preemptor revisiting its own nomination is handled per pod
        # (nominee first in schedule_pod), never batched in a wave
        return bool(pod.status.nominated_node_name)

    def _evaluate_nominated(self, state, pod: Pod, snapshot):
        """Host-side nominee check. Returns (result, pre_filter_done):
        result is a ScheduleResult when the nominee still fits, else None;
        pre_filter_done is the (pre_result, status) pair from the PreFilter
        pass, so the hybrid continuation does not run it again."""
        ni = snapshot.get(pod.status.nominated_node_name)
        if ni is None:
            return None, None
        pre_done = self.fw.run_pre_filter_plugins(state, pod, snapshot.list_nodes())
        pre_result, st = pre_done
        if not st.is_success:
            return None, pre_done  # the main cycle diagnoses this
        if (pre_result is not None and pre_result.node_names is not None
                and ni.name not in pre_result.node_names):
            return None, pre_done
        if self._filter_one(state, pod, ni, Diagnosis()):
            return ScheduleResult(suggested_host=ni.name, evaluated_nodes=1,
                                  feasible_nodes=1), pre_done
        return None, pre_done
