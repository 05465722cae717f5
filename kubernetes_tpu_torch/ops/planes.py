"""Tensor planes: the Snapshot materialized as dense [nodes, ...] arrays.

Every per-node quantity a filter or score plugin reads is laid out as a
column of a dense plane, padded to power-of-two buckets, and updated
incrementally by NodeInfo generation (mirroring the O(changed) snapshot
update of pkg/scheduler/backend/cache/cache.go:190-360). The host builders
are numpy and produce the same bytes as the reference package's builders
(kubernetes_tpu/ops/planes.py); the device side is torch tensors.

Planes (all numpy host-side; the backend uploads them to the device):
- alloc/used        [Nb, R]  int32   allocatable / requested, plane units
- nonzero_used      [Nb, 2]  int32   NonZeroRequested cpu/mem (scoring)
- valid             [Nb]     bool    padding mask
- unsched           [Nb]     bool    node.spec.unschedulable
- group_id          [Nb]     int32   node-label-group vocab id
- taints            [Nb, T]  int32   NoSchedule/NoExecute taint vocab ids, -1 pad
- prefer_taints     [Nb, Tp] int32   PreferNoSchedule taint vocab ids, -1 pad
- domain            [Nb, K]  int32   per-topology-key domain id, -1 = key absent
- sel_counts        [Nb, S]  int32   pods on node matching selector signature s
- port_words        [Nb, W]  uint32  used host-port bitset over the port vocab
- image_kib         [Nb, I]  int32   per-image KiB present on node
- ipa_counts        [Nb, Ta] int32   pods on node matching IPA term selector t
- ipa_anti          [Nb, Ta] int32   (pod, required-anti-affinity term) pairs
- ipa_pref          [Nb, Ta] int32   signed preferred-term weight sums
- ipa_term_key      [Ta]     int32   topology-key slot per term (global table)

Device dtype mapping (planes_from_reference / features_from_reference):
int32 stays int32; uint32 bitsets (port_words, the pod's ports) are carried
as int32 with the same bits (torch has no full uint32 arithmetic; the
kernels only AND them); bool stays torch.bool (one byte, 0/1) for planes
and tables, and rides the packed feature buffer as 0/1 int32.

Pod features (PodFeatureExtractor) are the per-pod side of the same split:
everything string-shaped is resolved host-side against the vocabularies, so
the kernels only gather and compare integers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.resource import CPU, MEM, ResourceNames
from ..api.types import NO_SCHEDULE, PREFER_NO_SCHEDULE, Pod, Taint
from .vocab import ClusterVocabs, next_pow2

ZONE_LABEL = "topology.kubernetes.io/zone"
HOSTNAME_LABEL = "kubernetes.io/hostname"
UNSCHEDULABLE_TAINT_KEY = "node.kubernetes.io/unschedulable"
_FIELD_HOSTNAME = "metadata.name"


class Planes:
    """Container of the dense node planes + index metadata."""

    __slots__ = (
        "node_names", "node_index", "n", "nb", "r",
        "alloc", "used", "nonzero_used", "valid", "unsched", "group_id",
        "taints", "prefer_taints", "domain", "sel_counts", "port_words",
        "image_kib", "ipa_counts", "ipa_anti", "ipa_pref", "ipa_term_key",
        "version", "bucket_sizes",
    )

    def as_dict(self) -> dict[str, np.ndarray]:
        """The kernel-input arrays (every plane the device code may read)."""
        return {
            "alloc": self.alloc,
            "used": self.used,
            "nonzero_used": self.nonzero_used,
            "valid": self.valid,
            "unsched": self.unsched,
            "group_id": self.group_id,
            "taints": self.taints,
            "prefer_taints": self.prefer_taints,
            "domain": self.domain,
            "sel_counts": self.sel_counts,
            "port_words": self.port_words,
            "image_kib": self.image_kib,
            "ipa_counts": self.ipa_counts,
            "ipa_anti": self.ipa_anti,
            "ipa_pref": self.ipa_pref,
            "ipa_term_key": self.ipa_term_key,
        }


def _canonical_fingerprint(vocabs: ClusterVocabs, names: ResourceNames) -> tuple:
    return (
        len(vocabs.taints), len(vocabs.prefer_taints), len(vocabs.groups),
        len(vocabs.topo_keys),
        tuple(len(vocabs.domain_vocab(i)) for i in range(len(vocabs.topo_keys))),
        len(vocabs.selectors), len(vocabs.ports), len(vocabs.images),
        len(vocabs.ipa_terms),
        names.width,
    )


class PlaneBuilder:
    """Builds and incrementally refreshes Planes from a Snapshot."""

    def __init__(self, names: ResourceNames, vocabs: ClusterVocabs | None = None):
        self.names = names
        self.vocabs = vocabs or ClusterVocabs()
        # default topology keys so the common spread constraints don't force
        # an early rebuild (podtopologyspread system defaults, plugin.go:46-60)
        self.vocabs.topo_keys.id(ZONE_LABEL)
        self.vocabs.topo_keys.id(HOSTNAME_LABEL)
        self._planes: Planes | None = None
        self._row_cache: dict[str, tuple[int, tuple]] = {}  # name -> (gen, fp)
        self._version = 0
        self.dirty_rows: list[int] | None = None  # rows changed by last sync
        # (snapshot uid, version, membership_version, fingerprint) of the
        # last sync — the O(changed) fast-path key (see _fast_sync)
        self._last_sync: tuple | None = None

    # -- public ------------------------------------------------------------

    def sync(self, snapshot) -> Planes:
        """Refresh planes from the snapshot; O(changed nodes) when the node
        set, bucket sizes, and vocabularies are stable."""
        p = self._fast_sync(snapshot)
        if p is not None:
            return p
        nodes = snapshot.list_nodes()
        names = [ni.name for ni in nodes]
        # intern node-derived vocab entries BEFORE sizing buckets, so the
        # fingerprint and bucket sizes already reflect this sync's content
        for ni in nodes:
            cached = self._row_cache.get(ni.name)
            if cached is None or cached[0] != ni.generation:
                self._register_node(ni)
        fp = _canonical_fingerprint(self.vocabs, self.names)
        buckets = self._bucket_sizes(len(nodes), fp)
        p = self._planes
        # strict append within the same pow2 node bucket: joined nodes get
        # new tail rows (existing rows keep their index), so membership
        # growth stays an O(changed) row update with dirty-row tracking
        # intact — the device mirror repairs it with a delta scatter, not a
        # full re-put. Removals/reorders still rebuild (rare, sanctioned).
        append = (
            p is not None and p.bucket_sizes == buckets
            and len(names) > len(p.node_names)
            and names[: len(p.node_names)] == p.node_names
        )
        if p is None or (not append and p.node_names != names) \
                or p.bucket_sizes != buckets:
            p = self._full_build(nodes, names, buckets, fp)
            self.dirty_rows: list[int] | None = None  # None = everything changed
        else:
            if append and p.node_names != names:
                old_n = p.n
                p.node_names = names
                for i in range(old_n, len(names)):
                    p.node_index[names[i]] = i
                p.n = len(names)
                p.valid[old_n: p.n] = True
                # new tail rows have no row-cache entry yet, so the loop
                # below writes (and dirties) exactly them + changed rows
            dirty: list[int] = []
            for i, ni in enumerate(nodes):
                cached = self._row_cache.get(ni.name)
                if cached is not None and cached == (ni.generation, fp):
                    continue
                self._write_row(p, i, ni, fp)
                dirty.append(i)
            self._finish_row_sync(p, dirty)
        self._stamp_sync(snapshot, p, fp)
        return p

    def _finish_row_sync(self, p: Planes, dirty: list[int]) -> None:
        """Shared tail of both sync paths: refresh GLOBAL (non-row) tables
        — a term interned mid-run (first pod with that affinity) dirties
        every row's counts, but its key-slot mapping lives here; a stale -1
        makes the kernel reject every node for that term — then record the
        dirty rows and bump the version when anything moved."""
        tables_changed = False
        for ti, (_ns, _sel, ki) in enumerate(self.vocabs.ipa_term_matchers):
            if p.ipa_term_key[ti] != ki:
                p.ipa_term_key[ti] = ki
                tables_changed = True
        self.dirty_rows = dirty
        if dirty or tables_changed:
            self._version += 1
            p.version = self._version

    def _stamp_sync(self, snapshot, p: Planes, fp: tuple) -> None:
        """Shared tail of both sync paths: _write_row may have interned new
        *values* (e.g. topology domains) mid-pass; restamp the row cache
        with the post-write fingerprint so the next sync doesn't see a
        spurious mismatch and rewrite every row. Row content is invariant
        to value-vocab growth (ids are append-only; shape-affecting growth
        changes bucket sizes and forces a rebuild). Records the fast-path
        key for the next sync."""
        fp2 = _canonical_fingerprint(self.vocabs, self.names)
        if fp2 != fp:
            self._row_cache = {
                nm: (gen, fp2) for nm, (gen, _) in self._row_cache.items()
            }
        self._planes = p
        self._last_sync = (
            getattr(snapshot, "uid", None),
            getattr(snapshot, "version", None),
            getattr(snapshot, "membership_version", None),
            fp2,
        )

    def _fast_sync(self, snapshot):
        """O(changed) sync via the snapshot's change feed: when this builder
        last synced this very snapshot and only row content changed since
        (no membership/order change, no vocab or bucket growth), re-extract
        ONLY the nodes named in the changelog suffix instead of scanning all
        N rows — the per-pod hybrid path syncs once per pod, and a full
        O(N) scan per pod dominated its profile at 5k nodes. Returns None
        to defer to the full path."""
        p = self._planes
        last = self._last_sync
        sv = getattr(snapshot, "version", None)
        if (p is None or last is None or sv is None
                or last[0] != snapshot.uid
                or last[2] != snapshot.membership_version
                or not (snapshot.changelog_base <= last[1] <= sv)):
            return None
        changed = set(snapshot.changelog[last[1] - snapshot.changelog_base:])
        for nm in changed:
            ni = snapshot.node_info_map.get(nm)
            if ni is None:
                return None  # feed references a node the map lost: full scan
            cached = self._row_cache.get(nm)
            if cached is None or cached[0] != ni.generation:
                self._register_node(ni)
        fp = _canonical_fingerprint(self.vocabs, self.names)
        if fp != last[3]:
            return None  # vocab growth: bucket sizes may move, full path
        if self._bucket_sizes(len(p.node_names), fp) != p.bucket_sizes:
            return None
        dirty: list[int] = []
        for nm in sorted(changed):
            ni = snapshot.node_info_map[nm]
            i = p.node_index.get(nm)
            if i is None:
                return None
            cached = self._row_cache.get(nm)
            if cached is not None and cached == (ni.generation, fp):
                continue
            self._write_row(p, i, ni, fp)
            dirty.append(i)
        self._finish_row_sync(p, dirty)
        self._stamp_sync(snapshot, p, fp)
        return p

    def topo_domains(self, planes: Planes) -> tuple[int, ...]:
        """Per-topology-key kernel treatment (KernelConfig.topo_domains):
        0 when every domain holds at most one node (hostname-style keys —
        the kernel then skips segment reductions entirely), else the padded
        domain-vocab size for the one-hot-matmul reduction."""
        v = self.vocabs
        out = []
        k_bucket = planes.domain.shape[1]
        for k in range(k_bucket):
            if k >= len(v.topo_keys):
                out.append(0)  # unused key slot
                continue
            col = planes.domain[: planes.n, k]
            vals = col[col >= 0]
            if vals.size == 0 or np.unique(vals).size == vals.size:
                out.append(0)
            else:
                out.append(next_pow2(len(v.domain_vocab(k)), 1))
        return tuple(out)

    # -- internals ----------------------------------------------------------

    def _register_node(self, ni) -> None:
        v = self.vocabs
        node = ni.node
        if node is not None:
            v.group_of_labels(dict(node.meta.labels))
            for tt in node.spec.taints:
                if tt.effect in (NO_SCHEDULE, "NoExecute"):
                    v.taints.id((tt.key, tt.value, tt.effect))
                elif tt.effect == PREFER_NO_SCHEDULE:
                    v.prefer_taints.id((tt.key, tt.value))
            for ki in range(len(v.topo_keys)):
                val = node.meta.labels.get(v.topo_keys.key(ki))
                if val is not None:
                    v.domain_vocab(ki).id(val)
        for (_ip, proto, port) in ni.used_ports:
            v.ports.id((proto, port))
        for img_name in ni.image_sizes:
            v.images.id(img_name)
        # existing pods' (anti)affinity terms — required AND preferred, so the
        # planes cover both filter (filtering.go:91) and score (scoring.go:81)
        for epi in ni.pods_with_affinity:
            for term in epi.required_affinity_terms:
                v.ipa_term_id(term)
            for term in epi.required_anti_affinity_terms:
                v.ipa_term_id(term)
            for _w, term in epi.preferred_affinity_terms:
                v.ipa_term_id(term)
            for _w, term in epi.preferred_anti_affinity_terms:
                v.ipa_term_id(term)

    def _bucket_sizes(self, n: int, fp: tuple) -> tuple:
        # same pow2 buckets as the reference package, so both build
        # byte-identical planes from one cluster
        v = self.vocabs
        max_taints = max((len(v.taints), 1))
        return (
            next_pow2(n, 8),                       # Nb
            next_pow2(self.names.width, 4),        # R
            next_pow2(max_taints, 1),              # T (vocab-sized: node rows index it)
            next_pow2(max(len(v.prefer_taints), 1), 1),   # Tp
            next_pow2(max(len(v.topo_keys), 2), 2),       # K
            next_pow2(max(len(v.selectors), 1), 1),       # S
            next_pow2((len(v.ports) + 31) // 32, 1),      # W port words
            next_pow2(max(len(v.images), 1), 1),          # I
            next_pow2(max(len(v.ipa_terms), 1), 1),       # Ta IPA terms
        )

    def _full_build(self, nodes, names, buckets, fp) -> Planes:
        nb, r, t, tp, k, s, w, im, ta = buckets
        p = Planes()
        p.node_names = names
        p.node_index = {nm: i for i, nm in enumerate(names)}
        p.n = len(nodes)
        p.nb, p.r = nb, r
        p.bucket_sizes = buckets
        p.alloc = np.zeros((nb, r), np.int32)
        p.used = np.zeros((nb, r), np.int32)
        p.nonzero_used = np.zeros((nb, 2), np.int32)
        p.valid = np.zeros(nb, bool)
        p.valid[: p.n] = True
        p.unsched = np.zeros(nb, bool)
        p.group_id = np.zeros(nb, np.int32)
        p.taints = np.full((nb, t), -1, np.int32)
        p.prefer_taints = np.full((nb, tp), -1, np.int32)
        p.domain = np.full((nb, k), -1, np.int32)
        p.sel_counts = np.zeros((nb, s), np.int32)
        p.port_words = np.zeros((nb, w), np.uint32)
        p.image_kib = np.zeros((nb, im), np.int32)
        p.ipa_counts = np.zeros((nb, ta), np.int32)
        p.ipa_anti = np.zeros((nb, ta), np.int32)
        p.ipa_pref = np.zeros((nb, ta), np.int32)
        # global term → topology-key-slot table (padded slots map to -1 so
        # the kernel's per-key unroll never picks them up)
        p.ipa_term_key = np.full(ta, -1, np.int32)
        for ti, (_ns, _sel, ki) in enumerate(self.vocabs.ipa_term_matchers):
            p.ipa_term_key[ti] = ki
        self._row_cache.clear()
        for i, ni in enumerate(nodes):
            self._write_row(p, i, ni, fp)
        self._version += 1
        p.version = self._version
        return p

    def _write_row(self, p: Planes, i: int, ni, fp: tuple) -> None:
        v = self.vocabs
        node = ni.node
        p.alloc[i, : p.r] = 0
        p.alloc[i, : min(len(ni.allocatable.v), p.r)] = [
            min(x, 2**31 - 1) for x in ni.allocatable.v[: p.r]
        ]
        p.used[i, : p.r] = 0
        p.used[i, : min(len(ni.requested.v), p.r)] = ni.requested.v[: p.r]
        p.nonzero_used[i, 0] = ni.nonzero_requested[CPU]
        p.nonzero_used[i, 1] = ni.nonzero_requested[MEM]
        labels = node.meta.labels if node is not None else {}
        p.unsched[i] = bool(node is not None and node.spec.unschedulable)
        p.group_id[i] = v.group_of_labels(dict(labels))
        # taints
        p.taints[i, :] = -1
        p.prefer_taints[i, :] = -1
        if node is not None:
            hard = [tt for tt in node.spec.taints if tt.effect in (NO_SCHEDULE, "NoExecute")]
            soft = [tt for tt in node.spec.taints if tt.effect == PREFER_NO_SCHEDULE]
            for j, tt in enumerate(hard[: p.taints.shape[1]]):
                p.taints[i, j] = v.taints.id((tt.key, tt.value, tt.effect))
            for j, tt in enumerate(soft[: p.prefer_taints.shape[1]]):
                p.prefer_taints[i, j] = v.prefer_taints.id((tt.key, tt.value))
        # topology domains
        p.domain[i, :] = -1
        for ki in range(len(v.topo_keys)):
            key = v.topo_keys.key(ki)
            val = labels.get(key)
            if val is not None and ki < p.domain.shape[1]:
                p.domain[i, ki] = v.domain_vocab(ki).id(val)
        # selector-signature pod counts (podtopologyspread/filtering.go:97)
        p.sel_counts[i, :] = 0
        for si, (ns, sel) in enumerate(v.selector_matchers):
            if si >= p.sel_counts.shape[1]:
                break
            c = 0
            for pi in ni.iter_pods():
                pod = pi.pod
                if pod.meta.namespace != ns or pod.is_terminating:
                    continue
                if sel.matches(pod.meta.labels):
                    c += 1
            p.sel_counts[i, si] = c
        # used host ports
        p.port_words[i, :] = 0
        for (_ip, proto, port) in ni.used_ports:
            b = v.ports.id((proto, port))
            if b // 32 < p.port_words.shape[1]:
                p.port_words[i, b // 32] |= np.uint32(1 << (b % 32))
        # images
        p.image_kib[i, :] = 0
        for img_name, size in ni.image_sizes.items():
            ii = v.images.id(img_name)
            if ii < p.image_kib.shape[1]:
                p.image_kib[i, ii] = size >> 10  # KiB keeps int32 on-device
        # inter-pod affinity planes (the dense topologyToMatchedTermCount:
        # per-term matching-pod counts + per-term carried anti/preferred
        # terms; domain aggregation happens on device)
        p.ipa_counts[i, :] = 0
        p.ipa_anti[i, :] = 0
        p.ipa_pref[i, :] = 0
        if v.ipa_terms:
            ta = p.ipa_counts.shape[1]
            for ti, (ns_set, sel, _ki) in enumerate(v.ipa_term_matchers):
                if ti >= ta or sel is None:
                    continue  # None-selector terms match nothing
                c = 0
                for epi in ni.iter_pods():
                    pod = epi.pod
                    if pod.meta.namespace in ns_set and sel.matches(pod.meta.labels):
                        c += 1
                p.ipa_counts[i, ti] = c
            for epi in ni.pods_with_required_anti_affinity:
                for term in epi.required_anti_affinity_terms:
                    ti = v.ipa_term_id(term)
                    if ti < ta:
                        p.ipa_anti[i, ti] += 1
            for epi in ni.pods_with_affinity:
                for w_, term in epi.preferred_affinity_terms:
                    ti = v.ipa_term_id(term)
                    if ti < ta:
                        p.ipa_pref[i, ti] += w_
                for w_, term in epi.preferred_anti_affinity_terms:
                    ti = v.ipa_term_id(term)
                    if ti < ta:
                        p.ipa_pref[i, ti] -= w_
        self._row_cache[ni.name] = (ni.generation, fp)


class FallbackNeeded(Exception):
    """Raised when a pod uses features the dense kernel does not model yet;
    the caller must run the host scheduling path for this pod (the same
    pods the reference package sends to its host path)."""

    # set by DeviceFlakeError: the circuit breaker counts only those
    device_flake = False


class DeviceFlakeError(FallbackNeeded):
    """An injected failure of the device path (the tpu.launch and
    tpu.collect fault points; reference ops/planes.py:449-459). Handled
    like FallbackNeeded — the wave's pods re-run per pod — and also counted
    as a circuit-breaker failure. A real error on the card (a failed build
    or launch, a CUDA error) is never wrapped in it: it raises."""

    device_flake = True


class PodFeatureExtractor:
    """Resolves one Pod against the vocabularies into fixed-shape arrays.

    Raises FallbackNeeded for the long-tail features kept host-side
    (match_fields beyond the In(metadata.name) fast path, host ports with
    specific hostIPs, constraint/term counts beyond the kernel slots).
    Inter-pod (anti)affinity is fully kernelized.
    """

    MAX_CONSTRAINTS = 4  # padded constraint slots per pod
    MAX_IPA_TERMS = 4    # required (anti)affinity term slots per pod
    MAX_IPA_PREF = 8     # preferred (anti)affinity term slots per pod

    def __init__(self, names: ResourceNames, vocabs: ClusterVocabs,
                 system_default_spread: bool = True):
        self.names = names
        self.vocabs = vocabs
        self.system_default_spread = system_default_spread
        self._aff_sigs: dict = {}  # full-spec key -> (sig, pin name | None)
        self._aff_specs: list = []
        self._aff_spec_ids: dict = {}  # residual-spec key -> sig (dedup)
        self._aff_tables: dict | None = None
        self._aff_tables_key: tuple | None = None
        self._feat_cache: dict = {}
        self._feat_cache_key: tuple | None = None

    # -- vocab registration (must run before PlaneBuilder.sync) -------------

    def register(self, pod: Pod) -> None:
        """Intern every vocab entry this pod needs so the subsequent
        planes sync covers them."""
        from ..scheduler.plugins.pod_topology_spread import PodTopologySpread

        pts = PodTopologySpread(system_defaulting=self.system_default_spread)
        for action in ("DoNotSchedule", "ScheduleAnyway"):
            for c in pts._constraints_for(pod, action):
                ki = self.vocabs.topo_keys.id(c.topology_key)
                self.vocabs.domain_vocab(ki)
                sel = c.label_selector
                if sel is not None:
                    self.vocabs.selector_id(pod.meta.namespace, sel)
        aff = pod.spec.affinity
        if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
            from ..scheduler.nodeinfo import PodInfo

            pi = PodInfo(pod, self.names)
            for term in pi.required_affinity_terms + pi.required_anti_affinity_terms:
                ti = self.vocabs.ipa_term_id(term)
                self.vocabs.domain_vocab(self.vocabs.ipa_term_matchers[ti][2])
            for _w, term in (pi.preferred_affinity_terms
                             + pi.preferred_anti_affinity_terms):
                ti = self.vocabs.ipa_term_id(term)
                self.vocabs.domain_vocab(self.vocabs.ipa_term_matchers[ti][2])
        for c in pod.spec.containers:
            for prt in c.ports:
                if prt.host_port > 0:
                    self.vocabs.ports.id((prt.protocol, prt.host_port))
            if c.image:
                self.vocabs.images.id(c.image)

    # -- extraction ----------------------------------------------------------

    def features_cached(self, pod: Pod, planes: Planes) -> dict[str, np.ndarray]:
        """features() memoized by pod shape: pods identical up to their name
        share one extraction (the dense analogue of SignPod sharing one
        score list, staging/.../framework/signers.go). Safe because every
        feature is a pure function of (spec, namespace, labels) and the
        vocab/bucket epoch — the cache clears when either changes. Callers
        must not mutate the returned arrays (stack_features copies)."""
        # epoch: features are pure in (spec, ns, labels) given vocab contents
        # (fingerprint = exact vocab lengths), bucket shapes, and the node
        # list (name_idx; node_index is fixed per Planes object). Plane ROW
        # content (used/counts) never enters features, so the cache survives
        # across waves.
        epoch = (planes.bucket_sizes, id(planes),
                 _canonical_fingerprint(self.vocabs, self.names))
        if self._feat_cache_key != epoch:
            self._feat_cache.clear()
            self._feat_cache_key = epoch
        key = (pod.meta.namespace, tuple(sorted(pod.meta.labels.items())),
               repr(pod.spec))
        f = self._feat_cache.get(key)
        if f is None:
            f = self.features(pod, planes)
            self._feat_cache[key] = f
        return f

    def features(self, pod: Pod, planes: Planes) -> dict[str, np.ndarray]:
        """Fixed-shape per-pod kernel inputs, aligned to `planes` buckets."""
        from ..api.resource import nonzero_request_vec, pod_request_vec
        from ..scheduler.plugins.pod_topology_spread import PodTopologySpread

        v = self.vocabs
        nb = planes.nb
        _, r, t, tp, k, s, w, im, ta = planes.bucket_sizes
        f: dict[str, np.ndarray] = {}

        # inter-pod (anti)affinity features: the pod's own term slots plus its
        # match vector against every interned term — the per-pod side of the
        # dense topologyToMatchedTermCount (interpodaffinity/filtering.go:91)
        self._ipa_features(pod, f, ta)

        # resources (noderesources/fit.go:317 computePodResourceRequest)
        req = pod_request_vec(pod, self.names)
        nz = nonzero_request_vec(req)
        f["req"] = np.array(req.row(r), np.int32)
        f["nz_req"] = np.array([nz[CPU], nz[MEM]], np.int32)

        # NodeName (node_name.go:79)
        if pod.spec.node_name:
            f["name_idx"] = np.int32(planes.node_index.get(pod.spec.node_name, -2))
        else:
            f["name_idx"] = np.int32(-1)

        # NodeUnschedulable toleration escape (node_unschedulable.go:142)
        f["tol_unsched"] = np.bool_(any(
            tl.key in (UNSCHEDULABLE_TAINT_KEY, "") and tl.operator == "Exists"
            for tl in pod.spec.tolerations
        ))

        # taint tolerance tables (tainttoleration.go Filter + Score)
        tol = np.zeros(t, bool)
        for j in range(len(v.taints)):
            key, val, eff = v.taints.key(j)
            taint = Taint(key, val, eff)
            tol[j] = any(tl.tolerates(taint) for tl in pod.spec.tolerations)
        f["tol"] = tol
        score_tols = [tl for tl in pod.spec.tolerations
                      if tl.effect in ("", PREFER_NO_SCHEDULE)]
        tolp = np.zeros(tp, bool)
        for j in range(len(v.prefer_taints)):
            key, val = v.prefer_taints.key(j)
            taint = Taint(key, val, PREFER_NO_SCHEDULE)
            tolp[j] = any(tl.tolerates(taint) for tl in score_tols)
        f["tol_prefer"] = tolp

        # node affinity / nodeSelector resolved to a shared signature row
        # (node_affinity.go:218; signature reuse mirrors SignPod,
        # staging/.../framework/signers.go — identical pods share one row).
        # A single-name required affinity (the daemonset shape) rides as a
        # per-pod pin index instead (node_affinity.go:159 fast path); -2 =
        # pinned to a node not in this snapshot -> infeasible everywhere
        sig, pin_name = self._affinity_sig(pod)
        f["aff_sig"] = np.int32(sig)
        f["aff_pin"] = np.int32(
            -1 if pin_name is None else planes.node_index.get(pin_name, -2)
        )

        # host ports (node_ports.go:75) — wildcard-ip pods only; the
        # (proto, port) bitset is exact for those
        ports = np.zeros(w, np.uint32)
        has_ports = False
        for c in pod.spec.containers:
            for prt in c.ports:
                if prt.host_port <= 0:
                    continue
                if prt.host_ip not in ("", "0.0.0.0"):
                    raise FallbackNeeded("host port with specific hostIP")
                b = v.ports.get((prt.protocol, prt.host_port))
                if b is None or b // 32 >= w:
                    raise FallbackNeeded("port vocab stale; re-register pod")
                ports[b // 32] |= np.uint32(1 << (b % 32))
                has_ports = True
        f["ports"] = ports
        f["has_ports"] = np.bool_(has_ports)

        # topology spread constraints → (key idx, selector idx, skew) slots
        pts = PodTopologySpread(system_defaulting=self.system_default_spread)
        for kind, action in (("hard", "DoNotSchedule"), ("soft", "ScheduleAnyway")):
            cs = pts._constraints_for(pod, action)
            if len(cs) > self.MAX_CONSTRAINTS:
                raise FallbackNeeded("more spread constraints than kernel slots")
            active = np.zeros(self.MAX_CONSTRAINTS, bool)
            ckey = np.zeros(self.MAX_CONSTRAINTS, np.int32)
            csel = np.zeros(self.MAX_CONSTRAINTS, np.int32)
            cskew = np.zeros(self.MAX_CONSTRAINTS, np.int32)
            cself = np.zeros(self.MAX_CONSTRAINTS, np.int32)
            for j, c in enumerate(cs):
                ki = v.topo_keys.get(c.topology_key)
                sel = c.label_selector
                si = (v.selectors.get((pod.meta.namespace, sel.canonical()))
                      if sel is not None else None)
                if ki is None or ki >= k or si is None or si >= s:
                    raise FallbackNeeded("spread vocab stale; re-register pod")
                active[j] = True
                ckey[j], csel[j], cskew[j] = ki, si, c.max_skew
                cself[j] = 1 if sel.matches(pod.meta.labels) else 0
            f[f"{kind}_active"] = active
            f[f"{kind}_key"] = ckey
            f[f"{kind}_sel"] = csel
            f[f"{kind}_skew"] = cskew
            f[f"{kind}_self"] = cself

        # image locality (image_locality.go:93-105)
        img_idx = np.full(8, -1, np.int32)
        n_containers = len(pod.spec.containers)
        if n_containers > 8:
            raise FallbackNeeded("more containers than image slots")
        for j, c in enumerate(pod.spec.containers):
            if c.image:
                ii = v.images.get(c.image)
                if ii is not None and ii < im:
                    img_idx[j] = ii
        f["img_idx"] = img_idx
        f["num_containers"] = np.int32(max(n_containers, 1))

        # which selector signatures this pod itself matches (batched-assign
        # carry update: the placed pod joins its own spread domains)
        sig = np.zeros(s, np.int32)
        for si, (ns, sel) in enumerate(v.selector_matchers):
            if si < s and ns == pod.meta.namespace and sel.matches(pod.meta.labels):
                sig[si] = 1
        f["sig_match"] = sig
        # real pod slot (pad_features flips this for wave padding)
        f["active"] = np.bool_(True)
        return f

    def _ipa_features(self, pod: Pod, f: dict, ta: int) -> None:
        """Inter-pod affinity per-pod inputs (all bucket-aligned to Ta):

        - ipa_match  [Ta] bool  term t's (ns, selector) matches THIS pod —
          drives the existing→incoming direction (check 1 of filtering.go:352
          and the existing-preferred side of scoring.go:81), and the scan
          carry update (a placed pod joins each matching term's counts).
        - ipa_aff_t/ipa_anti_t [MAX_IPA_TERMS] int32 term ids of the pod's
          required (anti)affinity terms, -1 pad; ipa_aff_self marks terms
          that match the pod itself (self-match bootstrap, filtering.go:404).
        - ipa_pref_t [MAX_IPA_PREF] int32 + ipa_pref_w signed weights for the
          pod's preferred terms (anti terms carry negative weight).
        - ipa_anti_add/ipa_pref_add [Ta] int32: the pod's own contribution to
          the ipa_anti/ipa_pref planes if placed (batched-scan carry).
        """
        from ..scheduler.nodeinfo import PodInfo

        v = self.vocabs
        match = np.zeros(ta, bool)
        for ti, (ns_set, sel, _ki) in enumerate(v.ipa_term_matchers):
            if ti >= ta or sel is None:
                continue
            match[ti] = (pod.meta.namespace in ns_set
                         and sel.matches(pod.meta.labels))
        f["ipa_match"] = match

        aff = pod.spec.affinity
        aff_t = np.full(self.MAX_IPA_TERMS, -1, np.int32)
        aff_self = np.zeros(self.MAX_IPA_TERMS, bool)
        anti_t = np.full(self.MAX_IPA_TERMS, -1, np.int32)
        pref_t = np.full(self.MAX_IPA_PREF, -1, np.int32)
        pref_w = np.zeros(self.MAX_IPA_PREF, np.int32)
        anti_add = np.zeros(ta, np.int32)
        pref_add = np.zeros(ta, np.int32)
        if aff is not None and (aff.pod_affinity or aff.pod_anti_affinity):
            pi = PodInfo(pod, self.names)
            if (len(pi.required_affinity_terms) > self.MAX_IPA_TERMS
                    or len(pi.required_anti_affinity_terms) > self.MAX_IPA_TERMS):
                raise FallbackNeeded("more required IPA terms than kernel slots")
            prefs = pi.preferred_affinity_terms + pi.preferred_anti_affinity_terms
            if len(prefs) > self.MAX_IPA_PREF:
                raise FallbackNeeded("more preferred IPA terms than kernel slots")
            def term_id(term):
                ti = v.ipa_term_lookup(term)
                if ti is None or ti >= ta:
                    raise FallbackNeeded("IPA vocab stale; re-register pod")
                return ti

            for j, term in enumerate(pi.required_affinity_terms):
                ti = term_id(term)
                aff_t[j] = ti
                aff_self[j] = term.matches(pod)
            for j, term in enumerate(pi.required_anti_affinity_terms):
                ti = term_id(term)
                anti_t[j] = ti
                anti_add[ti] += 1
            n_aff_pref = len(pi.preferred_affinity_terms)
            for j, (w_, term) in enumerate(prefs):
                ti = term_id(term)
                sign = 1 if j < n_aff_pref else -1
                pref_t[j] = ti
                pref_w[j] = sign * w_
                pref_add[ti] += sign * w_
        f["ipa_aff_t"] = aff_t
        f["ipa_aff_self"] = aff_self
        f["ipa_anti_t"] = anti_t
        f["ipa_pref_t"] = pref_t
        f["ipa_pref_w"] = pref_w
        f["ipa_anti_add"] = anti_add
        f["ipa_pref_add"] = pref_add

    def _affinity_sig(self, pod: Pod) -> tuple[int, str | None]:
        """Intern the pod's (nodeSelector, node affinity) spec into a
        (signature id, pinned node name | None); identical pods share one
        table row.

        match_fields support is limited to the reference's own fast path —
        a single term whose fields are `In(metadata.name, [...])`
        (node_affinity.go:159) — expressed as a node allowlist. When that
        allowlist is a SINGLE name and the term carries no expressions, the
        pin comes back as a per-pod feature and NO signature is minted:
        a daemonset-style run of uniquely-pinned pods must share one table
        row, not grow the [sigs, nodes] allow matrix by one row per pod
        (which made 5k daemon pods rebuild+upload a 5k-row table per wave).
        """
        aff = pod.spec.affinity
        node_aff = aff.node_affinity if aff else None
        required = node_aff.required if node_aff else None
        preferred = tuple(node_aff.preferred) if node_aff else ()
        selector = tuple(sorted(pod.spec.node_selector.items()))
        key = (selector, repr(required), repr(preferred))
        cached = self._aff_sigs.get(key)
        if cached is not None:
            return cached

        pin: str | None = None
        allowed_names: frozenset | None = None
        terms_for_groups = None
        if required is not None:
            terms = required.terms
            if any(t.match_fields for t in terms):
                if len(terms) != 1 or not all(
                    fr.key == _FIELD_HOSTNAME and fr.operator == "In"
                    for fr in terms[0].match_fields
                ):
                    raise FallbackNeeded("match_fields beyond In(metadata.name)")
                allowed: set[str] | None = None
                for fr in terms[0].match_fields:
                    vals = set(fr.values)
                    allowed = vals if allowed is None else (allowed & vals)
                allowed_names = frozenset(allowed or ())
                if (len(allowed_names) == 1
                        and not terms[0].match_expressions):
                    pin = next(iter(allowed_names))
                    allowed_names = None
                else:
                    # strip fields; expressions still gate per group
                    from ..api.types import NodeSelector, NodeSelectorTerm
                    terms_for_groups = NodeSelector(
                        (NodeSelectorTerm(terms[0].match_expressions, ()),)
                    )
            else:
                terms_for_groups = required
        for term in preferred:
            if term.preference.match_fields:
                raise FallbackNeeded("preferred term with match_fields")

        # intern the residual spec — shared across every pod whose affinity
        # differs only by its pinned name
        spec_key = (selector, repr(terms_for_groups), repr(preferred),
                    allowed_names)
        sig = self._aff_spec_ids.get(spec_key)
        if sig is None:
            sig = len(self._aff_specs)
            self._aff_specs.append(
                (dict(pod.spec.node_selector), terms_for_groups, preferred,
                 allowed_names)
            )
            self._aff_spec_ids[spec_key] = sig
        result = (sig, pin)
        self._aff_sigs[key] = result
        return result

    def affinity_tables(self, planes: Planes) -> dict[str, np.ndarray]:
        """Materialize the signature rows against the current group vocab and
        node set; cached until either grows or the node list changes."""
        v = self.vocabs
        n_sigs = len(self._aff_specs)
        a = next_pow2(n_sigs, 1)
        g = next_pow2(len(v.groups), 1)
        # actual group count must key the cache (not just its pow2 bucket):
        # new groups within the same bucket need their columns evaluated for
        # EVERY signature, which the incremental new-rows-only path can't do
        base_key = (a, g, len(v.groups), planes.nb, hash(tuple(planes.node_names)))
        prev = self._aff_tables
        if prev is not None and self._aff_tables_key == (base_key, n_sigs):
            return prev
        # signatures are append-only; when only new ones arrived (same group
        # vocab, node set, and buckets), fill just the new rows instead of
        # re-evaluating every prior spec — O(new) on the scheduling hot path
        if prev is not None and self._aff_tables_key[0] == base_key:
            start = self._aff_tables_key[1]
            # fresh dict object: TorchBackend.device_inputs re-uploads on
            # identity change, and the rows below mutate in place
            tables = dict(prev)
        else:
            start = 0
            tables = {
                "aff_match": np.ones((a, g), bool),
                "aff_pref": np.zeros((a, g), np.int32),
                "aff_allow": np.ones((a, planes.nb), bool),
                "aff_has_pref": np.zeros(a, bool),
            }
        group_labels = [dict(v.groups.key(gi)) for gi in range(len(v.groups))]
        for si in range(start, n_sigs):
            node_selector, terms, preferred, allowed_names = self._aff_specs[si]
            tables["aff_has_pref"][si] = bool(preferred)
            if allowed_names is not None:
                tables["aff_allow"][si, :] = False
                for nm in allowed_names:
                    i = planes.node_index.get(nm)
                    if i is not None:
                        tables["aff_allow"][si, i] = True
            for gi, labels in enumerate(group_labels):
                ok = all(labels.get(kk) == vv for kk, vv in node_selector.items())
                if ok and terms is not None:
                    ok = terms.matches(labels, {})
                tables["aff_match"][si, gi] = ok
                tables["aff_pref"][si, gi] = sum(
                    t.weight for t in preferred if t.preference.matches(labels, {})
                )
        self._aff_tables, self._aff_tables_key = tables, (base_key, n_sigs)
        return tables


def placement_masks(planes: Planes, node_name_lists: list[list[str]],
                    n_rows: int | None = None) -> np.ndarray:
    """[D, Nb] bool row-mask stack for the gang kernel, one row per
    placement's node-name list in HOST PLACEMENT ORDER (the gang winner
    tie-break is first-max over this order). Names missing from the plane
    index are skipped — the host dry run skips snapshot misses the same
    way. Rows beyond the given lists (shape padding up to `n_rows`) stay
    all-False: an empty valid set places nobody and can never win."""
    d = len(node_name_lists) if n_rows is None else max(n_rows, len(node_name_lists))
    masks = np.zeros((d, planes.nb), np.bool_)
    for row, names in enumerate(node_name_lists):
        for nm in names:
            i = planes.node_index.get(nm)
            if i is not None:
                masks[row, i] = True
    return masks


def stack_features(feats: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack per-pod feature dicts into [P, ...] batched arrays."""
    if not feats:
        raise ValueError("no features to stack")
    return {k: np.stack([f[k] for f in feats]) for k in feats[0]}


def pad_features(stacked: dict[str, np.ndarray], pad_to: int) -> dict[str, np.ndarray]:
    """Pad a stacked feature batch to `pad_to` pod slots with inactive rows
    (active=False: the scan step discards their placements and draws no
    tie-break words). The kernels skip inactive slots."""
    p = stacked["active"].shape[0]
    if p >= pad_to:
        return stacked
    out = {}
    for k, a in stacked.items():
        pad = np.zeros((pad_to - p,) + a.shape[1:], a.dtype)
        if k in ("ipa_aff_t", "ipa_anti_t", "ipa_pref_t"):
            pad -= 1  # -1 = inactive term slot
        out[k] = np.concatenate([a, pad])
    return out


# --------------------------------------------------------------------------
# feature packing: ONE host→device transfer per wave
# --------------------------------------------------------------------------

def pack_features(stacked: dict[str, np.ndarray]):
    """Pack a stacked feature batch into a single [P, F] int32 buffer plus
    a layout tuple (name, offset, width, ndim, tag). A wave's features are
    ~30 tiny arrays; each would be its own host→device copy, so the batch
    ships as one buffer: the CUDA kernels read fields at their layout
    offsets, the plain versions through unpack_features' views.

    bool columns ride as 0/1 int32, uint32 bitmask columns are bitcast
    (same bytes); values are reconstructed exactly — bit-identity holds.
    """
    cols = []
    layout = []
    off = 0
    for name in sorted(stacked):
        a = stacked[name]
        a2 = a[:, None] if a.ndim == 1 else a
        width = a2.shape[1]
        if a.dtype == np.uint32:
            tag = "uint32"
            cols.append(a2.view(np.int32))
        elif a.dtype == np.bool_:
            tag = "bool"
            cols.append(a2.astype(np.int32))
        else:
            tag = "int32"
            cols.append(a2.astype(np.int32, copy=False))
        layout.append((name, off, width, a.ndim, tag))
        off += width
    return np.ascontiguousarray(np.concatenate(cols, axis=1)), tuple(layout)


SLICE_PLANES = (
    "alloc", "used", "nonzero_used", "valid", "unsched", "group_id",
    "taints", "prefer_taints", "domain", "sel_counts", "port_words",
    "image_kib", "ipa_counts", "ipa_anti", "ipa_pref",
)
"""The row planes ([Nb, ...]) the kernels read; the device mirror holds
these and repairs them by row scatter (K3). The global ipa_term_key table
([Ta], not row-indexed) is mirrored beside them and re-uploaded whenever its
host content moves."""

_DEVICE_DTYPE = {
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.int32,  # same bits; see the module docstring
    np.dtype(np.bool_): torch.bool,
}


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a gathered jax array: torch wants a writable one
        a = a.copy()
    dt = _DEVICE_DTYPE.get(a.dtype)
    if dt is None:
        raise TypeError(f"no device dtype for plane dtype {a.dtype}")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # copy=True: on the CPU too the mirror must not alias the host planes,
    # which the builder rewrites in place
    return torch.from_numpy(a).to(device, copy=True)


def planes_from_reference(planes: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """numpy planes or affinity tables (this package's Planes.as_dict() or
    affinity_tables(), or the reference package's, which are byte-equal)
    → device tensors, dtypes mapped as the module docstring states. An
    array of the reference's node-sharded outputs (carry planes,
    sig_scores) gathers to numpy here and becomes one contiguous tensor:
    the port keeps every plane whole, whatever its shard count."""
    return {k: _to_device(v, device) for k, v in planes.items()}


def sig_table_from_reference(sig_table: dict, carry_map, device):
    """A chained wave's cross-wave inputs from numpy (or the reference
    package's device arrays, node-sharded columns included, gathered
    through np.array): the previous wave's signature table {ew, ffit, feas,
    segs, pcs} → contiguous device tensors (uint32 → int32 with the same
    bits, bool → bool), and carry_map → int32."""
    table = planes_from_reference(
        {k: np.array(v) for k, v in sig_table.items()}, device)
    cmap = torch.from_numpy(np.ascontiguousarray(carry_map, dtype=np.int32)).to(
        device, copy=True)
    return table, cmap


def features_from_reference(stacked: dict[str, np.ndarray], device):
    """A stacked [P, ...] feature batch → (packed [P, F] int32 device
    buffer, static layout): ONE host→device copy per wave."""
    packed, layout = pack_features(stacked)
    return torch.from_numpy(packed).to(device), layout


def unpack_features(buf: torch.Tensor, layout) -> dict[str, torch.Tensor]:
    """Inverse of pack_features as zero-copy views of the packed [P, F]
    int32 buffer. Every column stays int32: bool columns hold 0/1 and
    uint32 columns hold the same bits, so consumers compare with != 0 and
    AND bitsets directly. 1-D features come back as [P] views."""
    out = {}
    for name, off, width, ndim, _tag in layout:
        sl = buf[:, off:off + width]
        out[name] = sl[:, 0] if ndim == 1 else sl
    return out
