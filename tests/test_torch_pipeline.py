"""Streaming waves in the port: the chained launch's K2 inputs (the
cross-wave seed of the signature table and the device tie cursor) and the
pipelined launch/collect protocol, against the reference package on the
same inputs.

- K2's plain version with carry_map / sig_table / cursor_init /
  frame_shift equals JAX batched_assign on every output array;
- SignatureScoreCache equals the reference's over one scripted sequence;
- TorchBackend(device="cpu") driven by launch_batched/collect at depth 2
  (kubernetes_tpu_torch.testing.pipeline) equals TPUBackend driven by the
  same loop, wave by wave: hosts, carry planes, dedup_stats with the
  xwave_* counters, and the final rng state — also through the mid-stream
  events (an external node change, churn deletes, a host revert that
  poisons the successor, a tie stream that overflows at collect, a
  schedule_pod in the re-run window, a gang between chained waves);
- the golden triple on the port: pipelined, serial (depth 1) and dedup
  off give equal bindings and rng state.

Every comparison is exact (integers and bools: tolerance 0). The spread
domain counts stay off the points where the JAX kernel's log weight
differs from the host plugin's, which the port follows
(tests/test_torch_fit.py shows the difference); the SchedulingBasic shape
runs at a few hundred nodes.
"""

import dataclasses
import os
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import FallbackNeeded as JFallbackNeeded
from kubernetes_tpu.ops.planes import pad_features, stack_features
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework.interface import FitError as JFitError
from kubernetes_tpu.scheduler.framework.runtime import Framework as JFramework
from kubernetes_tpu.scheduler.plugins.registry import DEFAULT_WEIGHTS, default_plugins
from kubernetes_tpu.scheduler.tpu import backend as jbackend
from kubernetes_tpu.scheduler.tpu.backend import (
    NeedResync as JNeedResync,
    SignatureScoreCache as JSignatureScoreCache,
    TPUBackend,
    TPUSchedulingAlgorithm,
    clone_tie_words,
)
from kubernetes_tpu.store import Store
from kubernetes_tpu.utils import faultinject
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    sig_table_from_reference,
)
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import FitError as TFitError
from kubernetes_tpu_torch.scheduler.framework import Framework as TFramework
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_WEIGHTS as TDEFAULT_WEIGHTS
from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault_plugins
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu.backend import (
    SignatureScoreCache,
    TorchBackend,
    TorchSchedulingAlgorithm,
)
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.mixed import (
    build_nodes,
    build_pods,
    dedup_nodes,
    dedup_pods,
    ipa_pods,
    mixed_spec,
)
from kubernetes_tpu_torch.testing.pipeline import WavePipeline
from tests.test_torch_dedup import _case as _dedup_case


_DEVICE_PUT = jax.device_put


def _device_put_copy(x, *args, **kwargs):
    """jax.device_put of private copies of the numpy leaves: on the CPU
    backend device_put may alias a 64-byte-aligned numpy array instead of
    copying it (ROADMAP C12), and the reference's backend puts its plane
    builder's arrays, which the builder rewrites in place, into its device
    mirror."""
    x = jax.tree.map(lambda a: np.array(a, copy=True) if isinstance(a, np.ndarray) else a, x)
    return _DEVICE_PUT(x, *args, **kwargs)


@pytest.fixture(autouse=True)
def _own_process_state(monkeypatch):
    """Every test here starts from the process state it sets itself, not
    from what an earlier test in the same worker left: the reference's
    process-wide fault registry (fired by TPUBackend.launch_batched and
    collect) disarmed and reset, no KUBE_TPU_* knob in the environment (the
    reference reads some of them, e.g. KUBE_TPU_MESH_DEVICES, when its
    backend is built; the port's context_from_env reads the same one), and
    the reference's device mirror holding copies of its host planes rather
    than, depending on where the allocator put them, aliases (C12)."""
    reg = faultinject.registry()
    reg.disarm()
    reg.reset(seed=0)
    for name in [k for k in os.environ if k.startswith("KUBE_TPU_")]:
        monkeypatch.delenv(name)
    monkeypatch.setattr(jax, "device_put", _device_put_copy)
    yield
    reg.disarm()
    reg.reset(seed=0)


# --------------------------------------------------------------------------
# K2 with the cross-wave seed and the device cursor
# --------------------------------------------------------------------------


def _basic_case():
    from kubernetes_tpu.testing.wrappers import make_node, make_pod

    nodes = [make_node(f"node-{i}", zone=f"zone-{i % 8}") for i in range(24)]
    pods = [make_pod(f"pod-{i}", cpu="100m", mem="50Mi", labels={"app": "perf"},
                     image="registry.k8s.io/pause:3.10") for i in range(40)]
    return nodes, [], pods, 48, "rng", 3


def _kernel_inputs(name):
    """(cfg, planes, arrays, feats, sig_ids, uniq) of one wave in the
    reference package's types; the dedup file's cases plus SchedulingBasic."""
    nodes, existing, wave, pad_to, _kind, _seed = (
        _basic_case() if name == "basic" else _dedup_case(name))
    names = JNames()
    cache = JCache(names)
    for n in nodes:
        cache.add_node(n)
    backend = TPUBackend(names)
    for i, pod in enumerate(existing):
        backend.extractor.register(pod)
        cache.assume_pod(pod, nodes[(5 * i) % len(nodes)].meta.name)
    snap = JSnapshot()
    cache.update_snapshot(snap)
    for pod in wave:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = stack_features([backend.extractor.features(p, planes) for p in wave])
    if pad_to:
        feats = pad_features(feats, pad_to)
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    sig_ids, uniq, _ = backend._group_wave(feats, len(wave))
    return cfg, planes, arrays, feats, sig_ids, uniq


def _port_wave(cfg, planes, arrays, feats, words, sig_ids, uniq, **kw):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    as_t = (lambda a: torch.from_numpy(np.asarray(a, np.int32)))
    return tk.batched_assign(
        pcfg, dplanes, dtables, packed_f, layout,
        torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(tk.log_weight_table(planes.nb)),
        sig_ids=as_t(sig_ids), uniq_idx=as_t(uniq), **kw)


def _assert_equal_outputs(got, want):
    assert np.array_equal(got["packed"].numpy(), np.asarray(want["packed"]))
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti",
              "ipa_pref", "sig_scores"):
        assert (k in got) == (k in want), k
        if k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert set(got["sig_table"]) == set(want["sig_table"])
    for k, v in want["sig_table"].items():
        assert np.array_equal(got["sig_table"][k].numpy(), np.asarray(v)), k


def _crafted_map(g_pad):
    """Slot 0 a hit on itself, slot 1 a miss, the rest a rotation (every
    other slot replays another slot's row)."""
    m = np.arange(g_pad, dtype=np.int32)
    m[2:] = np.roll(m[2:], -1)
    m[1] = -1
    return m


SEED_CASES = ["basic", "mixed", "hard-zone", "hard-hostname", "ipa-existing",
              "ipa-wave-adds-first-anti"]


@pytest.mark.parametrize("cmap_kind", ["same-slots", "crafted"])
@pytest.mark.parametrize("case", SEED_CASES)
def test_seeded_batched_assign_matches_reference(case, cmap_kind):
    """A chained second wave on the first wave's output planes, with the
    first wave's signature table, a carry_map, the first wave's final
    cursor as cursor_init (a 0-d tensor on the port's side) and a nonzero
    frame_shift: the port's batched_assign == JAX batched_assign on packed,
    the carried planes, sig_scores and every array of sig_table."""
    cfg, planes, arrays, feats, sig_ids, uniq = _kernel_inputs(case)
    pad = feats["active"].shape[0]
    words1 = clone_tie_words(random.Random(11), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, first = jk.batched_assign(cfg, arrays, feats, words1, sig_ids=sig_ids,
                                 uniq_idx=uniq)
    port_first = _port_wave(cfg, planes, arrays, feats, words1, sig_ids, uniq)
    _assert_equal_outputs(port_first, first)
    chained = dict(arrays)
    for k in ("used", "nonzero_used", "sel_counts", "ipa_counts", "ipa_anti", "ipa_pref"):
        if k in first:
            chained[k] = np.asarray(first[k])
    g_pad = len(uniq)
    cmap = (np.arange(g_pad, dtype=np.int32) if cmap_kind == "same-slots"
            else _crafted_map(g_pad))
    cursor = int(first["tie_consumed"])
    shift = min(3, cursor)
    words2 = clone_tie_words(random.Random(12), (2 * pad + 1) * jk.MAX_TIE_DRAWS)
    _, want = jk.batched_assign(cfg, chained, feats, words2,
                                cursor_init=first["tie_consumed"], frame_shift=shift,
                                sig_ids=sig_ids, uniq_idx=uniq, carry_map=cmap,
                                sig_table=first["sig_table"])
    table, tcmap = sig_table_from_reference(first["sig_table"], cmap, "cpu")
    got = _port_wave(cfg, planes, chained, feats, words2, sig_ids, uniq,
                     cursor_init=torch.tensor(cursor, dtype=torch.int32),
                     frame_shift=shift, carry_map=tcmap, sig_table=table)
    _assert_equal_outputs(got, want)
    if case == "basic" and cmap_kind == "same-slots":
        # no gate (no hard spread, no IPA): every step replays a seeded row
        assert got["tiers"].tolist() == [0, pad]
    # the output table is new memory: the input table is left as it was
    for k, v in first["sig_table"].items():
        assert np.array_equal(table[k].numpy(), np.asarray(v))
        assert table[k].data_ptr() != got["sig_table"][k].data_ptr()
    # the port's own first table seeds the same way
    own = _port_wave(cfg, planes, chained, feats, words2, sig_ids, uniq,
                     cursor_init=port_first["packed"][-2], frame_shift=shift,
                     carry_map=tcmap, sig_table=port_first["sig_table"])
    _assert_equal_outputs(own, want)


# --------------------------------------------------------------------------
# SignatureScoreCache
# --------------------------------------------------------------------------


def test_signature_score_cache_matches_reference():
    """One scripted sequence through both caches: a cold start, hits,
    misses, a key change, evictions, a clear and repeated signature bytes.
    Every return value and the whole state after each step are equal."""
    script = [
        ("lookup", "k1", (b"a", b"b"), 8),      # cold: None
        ("store", "k1", (b"a", b"b")),          # a fresh generation
        ("lookup", "k1", (b"b", b"c", b"a"), 8),
        ("store", "k1", (b"b", b"c", b"a")),    # hits b, a; miss c
        ("lookup", "k2", (b"a",), 8),           # key change: None
        ("store", "k2", (b"d",)),               # cold under k2: three evicted
        ("store", "k2", (b"d", b"e")),
        ("store", "k2", (b"f",)),               # two evicted
        ("clear",),
        ("lookup", "k2", (b"f",), 8),
        ("store", "k2", (b"f", b"f", b"g")),    # first appearance wins
        ("lookup", "k2", (b"g", b"x", b"f"), 4),
    ]
    caches = (JSignatureScoreCache(), SignatureScoreCache())
    for step, op in enumerate(script):
        outs = []
        for c in caches:
            if op[0] == "lookup":
                got = c.lookup(op[1], op[2], op[3])
                outs.append(None if got is None else got.tolist())
            elif op[0] == "store":
                outs.append(c.store(op[1], {"step": step}, op[2]))
            else:
                outs.append(c.clear())
        assert outs[0] == outs[1], (step, op)
        states = [(c.slots, c.table, c.key, c.hits, c.misses, c.evictions) for c in caches]
        assert states[0] == states[1], (step, op)
    assert caches[1].hits > 0 and caches[1].misses > 0 and caches[1].evictions > 0


# --------------------------------------------------------------------------
# the backends through the pipelined loop
# --------------------------------------------------------------------------


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class _Recording:
    """A backend with a log: after each collect the hosts, the carry planes
    and dedup_stats (or the fallback's message); after each run the five
    arrays. Everything else goes to the backend."""

    def __init__(self, backend):
        self.__dict__["b"] = backend
        self.__dict__["log"] = []

    def __getattr__(self, name):
        return getattr(self.b, name)

    def __setattr__(self, name, value):
        setattr(self.b, name, value)

    def collect(self, fl, rng=None):
        try:
            hosts, planes = self.b.collect(fl, rng)
        except Exception as e:
            self.log.append(("collect-fallback", type(e).__name__, str(e)))
            raise
        carry = {k: _np(v).tolist() for k, v in sorted((self.b._carry or {}).items())}
        self.log.append(("collect", hosts, carry, dict(self.b.dedup_stats)))
        return hosts, planes

    def launch_batched(self, pods, snapshot, rng=None, pad_to=0):
        try:
            return self.b.launch_batched(pods, snapshot, rng=rng, pad_to=pad_to)
        except Exception as e:
            self.log.append(("launch-raised", type(e).__name__, str(e)))
            raise

    def run(self, pod, snapshot):
        planes, out = self.b.run(pod, snapshot)
        self.log.append(("run", pod.meta.name, {k: _np(out[k]).tolist() for k in sorted(out)}))
        return planes, out


class _Side:
    """One package's cluster: cache, snapshot, backend (recorded),
    algorithm and the pipelined loop over them."""

    def __init__(self, pkg, nodes, plugin_args=None, seed=5, depth=2, dedup=True,
                 cross_wave=True, base=None):
        self.pkg = pkg
        self.types, self.meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
        if base is None:
            names = JNames() if pkg == "jax" else TNames()
            self.cache = (JCache if pkg == "jax" else TCache)(names)
            for n in nodes:
                self.cache.add_node(n)
            self.snapshot = (JSnapshot if pkg == "jax" else TSnapshot)()
            self.cache.update_snapshot(self.snapshot)
            backend = (TPUBackend(names, plugin_args=plugin_args) if pkg == "jax" else
                       TorchBackend(names, plugin_args=plugin_args, device="cpu"))
        else:  # a gang side of tests/test_torch_gang.py
            self.cache, self.snapshot, backend = base.cache, base.snapshot, base.backend
            names = base.names
        backend.dedup_enabled = dedup
        backend.cross_wave_enabled = cross_wave
        self.backend = _Recording(backend)
        rng = random.Random(seed)
        if pkg == "jax":
            from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCS

            fw = JFramework(default_plugins(Store(), names, {}, plugin_args or {}),
                            dict(DEFAULT_WEIGHTS))
            self.algo = TPUSchedulingAlgorithm(fw, backend, rng=rng)
            self.algo.backend = self.backend
            errors = dict(need_resync=JNeedResync, fallback=JFallbackNeeded,
                          fit_error=JFitError, new_state=JCS)
        else:
            fw = TFramework(tdefault_plugins(names, args=plugin_args),
                            dict(TDEFAULT_WEIGHTS))
            self.algo = TorchSchedulingAlgorithm(fw, self.backend, rng=rng)
            errors = {}
        self.pipe = WavePipeline(self.backend, self.cache, self.snapshot, self.algo,
                                 depth=depth, **errors)

    def result(self):
        return (self.backend.log, self.pipe.bindings, self.algo.rng.getstate(),
                dict(self.backend.b.dedup_stats), dict(self.pipe.stats),
                [p.meta.name for p in self.pipe.handed_back],
                [p.meta.name for p in self.pipe.rejected])


def _jax_basic(n_nodes, n_pods, cpu="32"):
    from kubernetes_tpu.testing.wrappers import make_node, make_pod

    return ([make_node(f"node-{i}", cpu=cpu, zone=f"zone-{i % 8}") for i in range(n_nodes)],
            [make_pod(f"pod-{i}", cpu="100m", mem="50Mi", labels={"app": "perf"},
                      image="registry.k8s.io/pause:3.10") for i in range(n_pods)])


def _port_basic(n_nodes, n_pods, cpu="32"):
    nodes = [tw.scheduling_basic_node(i) for i in range(n_nodes)]
    if cpu != "32":
        nodes = [tw.make_node(f"node-{i}", cpu=cpu, zone=f"zone-{i % 8}")
                 for i in range(n_nodes)]
    return nodes, [tw.scheduling_basic_pod(i) for i in range(n_pods)]


def _cluster(name, pkg):
    """(nodes, pods, wave) of a named cluster in one package's types."""
    types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
    if name == "basic":  # SchedulingBasic's shape, cut in size
        nodes, pods = (_jax_basic if pkg == "jax" else _port_basic)(200, 360)
        return nodes, pods, 64
    if name == "hard-spread":
        return (dedup_nodes(10, types, meta, cpu="8"),
                dedup_pods(64, types, meta, spread=(1, "zone")), 16)
    if name == "ipa":
        return dedup_nodes(12, types, meta, cpu="8"), ipa_pods(48, types, meta), 16
    if name == "mixed":  # many signatures, capacity failures re-run per pod
        spec = mixed_spec(7, 24, 90, constraints=True)
        return build_nodes(spec, types, meta), build_pods(spec, types, meta), 16
    raise KeyError(name)


def _both(build, **kw):
    """Build and drive a scenario on both packages; returns their results
    (reference first) and the port's side."""
    out = []
    for pkg in ("jax", "port"):
        side = build(pkg, **kw)
        out.append(side)
    return out


def _run_cluster(name, pkg, **kw):
    nodes, pods, wave = _cluster(name, pkg)
    side = _Side(pkg, nodes, **kw)
    side.pipe.schedule(pods, wave)
    return side


@pytest.mark.parametrize("name", ["basic", "hard-spread", "ipa", "mixed"])
def test_pipelined_backend_matches_reference(name):
    """The same clusters and pods through WavePipeline at depth 2 over
    TPUBackend and over TorchBackend(device="cpu"): after every collect
    equal hosts, carry planes and dedup_stats (xwave_* included); equal
    launch and re-run logs, bindings and final rng state; and the port
    chained its launches and replayed signatures across waves."""
    jside, tside = _both(lambda pkg: _run_cluster(name, pkg))
    assert tside.result() == jside.result()
    b = tside.backend.b
    assert b.pipe_stats["chained"] > 0
    if name != "mixed":  # the mixed pods hardly repeat a signature
        assert b.dedup_stats["xwave_hits"] > 0
        assert b.pipe_stats["xwave_launches"] > 0
    assert any(h for e in tside.backend.log if e[0] == "collect" for h in e[1])
    if name == "mixed":
        assert tside.pipe.stats["reruns"] > 0  # host=None pods re-ran in the window
        assert any(e[0] == "run" for e in tside.backend.log)
    assert b._inflight is None


@pytest.mark.parametrize("name", ["basic", "hard-spread", "ipa", "mixed"])
def test_golden_triple(name):
    """On the port: pipelined (depth 2), serial (depth 1, the same code)
    and dedup off give equal bindings and equal rng state; the pipelined
    run replays across waves, the others do not. On the mixed cluster the
    reference's own serial run binds differently from its pipelined run
    (ROADMAP C10: a re-run reads the wave's output planes at depth 1 where
    a resync sends it to host truth at depth 2); there the port's serial
    run equals the reference's serial run instead."""
    runs = [_run_cluster(name, "port", depth=2),
            _run_cluster(name, "port", depth=1),
            _run_cluster(name, "port", depth=2, dedup=False)]
    want = (runs[0].pipe.bindings, runs[0].algo.rng.getstate())
    serial = (runs[1].pipe.bindings, runs[1].algo.rng.getstate())
    assert (runs[2].pipe.bindings, runs[2].algo.rng.getstate()) == want
    if name == "mixed":
        jd1, jd2 = (_run_cluster(name, "jax", depth=d) for d in (1, 2))
        assert jd1.pipe.bindings != jd2.pipe.bindings
        assert (jd2.pipe.bindings, jd2.algo.rng.getstate()) == want
        assert (jd1.pipe.bindings, jd1.algo.rng.getstate()) == serial
    else:
        assert serial == want
        assert runs[0].backend.b.dedup_stats["xwave_hits"] > 0
    assert runs[2].backend.b.dedup_stats["xwave_hits"] == 0
    assert runs[0].backend.b.pipe_stats["chained"] > 0


def test_pipelined_equals_serial_run_batched():
    """The pipelined loop places exactly what the serial run_batched
    loop places, with the same rng state (phase (a) of chip_smoke.py
    holds the card to this at full size)."""
    side = _run_cluster("basic", "port")
    nodes, pods, wave = _cluster("basic", "port")
    cache = TCache(TNames())
    for n in nodes:
        cache.add_node(n)
    snap = TSnapshot()
    cache.update_snapshot(snap)
    b = TorchBackend(cache.names, device="cpu")
    rng = random.Random(5)
    got = {}
    for i in range(0, len(pods), wave):
        chunk = pods[i: i + wave]
        hosts, _ = b.run_batched(chunk, snap, rng=rng, pad_to=wave)
        for pod, host in zip(chunk, hosts):
            got[pod.meta.key] = host
            cache.assume_pod(pod, host)
        cache.update_snapshot(snap)
    assert got == side.pipe.bindings
    assert rng.getstate() == side.algo.rng.getstate()


def _window_side(pkg, depth):
    """Eight nodes; wave 0 is a pod with required affinity to app=front on
    zone that it does not match itself, then seven app=front pods; waves 1
    and 2 front pods with the same term (no new label, so the planes keep
    their buckets and the carry stays compatible; the term keeps the IPA
    planes in the successor's carry, whose keys the window takes). At the first pod's turn no front pod exists, so the
    wave cannot place it; its re-run in wave 0's re-run window reads the
    wave's output planes, which hold the seven front pods."""
    types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
    side = _Side(pkg, dedup_nodes(8, types, meta, cpu="8"), depth=depth)
    term = types.PodAffinityTerm(label_selector=types.LabelSelector.of({"app": "front"}),
                                 topology_key="topology.kubernetes.io/zone")
    aff = types.Affinity(pod_affinity=types.PodAffinity(required=(term,)))

    def pod(name, app, affinity=None):
        c = types.Container(name="c", requests={"cpu": "500m", "memory": "256Mi"})
        return types.Pod(meta=meta.ObjectMeta(name=name, namespace="default",
                                              labels={"app": app}),
                         spec=types.PodSpec(containers=[c], affinity=affinity))

    wave0 = [pod("f00", "client", aff)] + [pod(f"w{i:02d}", "front") for i in range(1, 8)]
    rest = [pod(f"p{i:02d}", "front", aff) for i in range(16)]
    side.pipe.schedule(wave0 + rest, 8)
    return side


@pytest.mark.parametrize("depth", [2, 1])
def test_rerun_window_reads_the_wave_output(depth):
    """The reference's run binds a re-run pod from its wave's output
    planes whenever the carry is still compatible, at depth 2 as at depth
    1; the port does the same, wave by wave and run by run (the run
    arrays, bindings, poisoned successor, handed-back pods, rng state)."""
    jside, tside = _window_side("jax", depth), _window_side("port", depth)
    assert tside.result() == jside.result()
    assert tside.pipe.bindings["default/f00"] is not None
    assert any(e[0] == "run" and e[1] == "f00" for e in tside.backend.log)
    if depth == 2:  # the bind outside the writeback poisoned wave 1
        assert tside.pipe.stats["poisoned"] >= 1 and tside.pipe.handed_back


# --------------------------------------------------------------------------
# events mid-stream, through both packages
# --------------------------------------------------------------------------


def _wrappers(side):
    if side.pkg == "jax":
        from kubernetes_tpu.testing import wrappers

        return wrappers
    return tw


def _plain_nodes(side, n, cpu="8", zones=2):
    w = _wrappers(side)
    return [w.make_node(f"n{i}", cpu=cpu, mem="16Gi", zone=f"z{i % zones}") for i in range(n)]


def _plain_pods(side, prefix, n, cpu="1"):
    w = _wrappers(side)
    return [w.make_pod(f"{prefix}{i:02d}", cpu=cpu, mem="1Gi") for i in range(n)]


def _waves_of(side, pods, size):
    for i in range(0, len(pods), size):
        side.pipe.submit(pods[i: i + size], size)


def _ev_node_change(pkg, monkeypatch):
    """A node grows while a wave is in flight: mark_external → NeedResync
    at the next launch → drain, drop the carry, re-upload, retry."""
    side = _Side(pkg, None, base=_Base(pkg, lambda s: _plain_nodes(s, 10)))
    _waves_of(side, _plain_pods(side, "a", 24), 8)
    w = _wrappers(side)
    side.cache.add_node(w.make_node("n3", cpu="64", mem="16Gi", zone="z1"))
    side.pipe.external(poison=False)
    _waves_of(side, _plain_pods(side, "b", 24), 8)
    side.pipe.flush()
    assert side.pipe.stats["resyncs"] >= 1
    return side


def _ev_churn(pkg, monkeypatch):
    """Bound pods deleted between waves, with a wave in flight: the freed
    capacity is reused after the resync."""
    side = _Side(pkg, None, base=_Base(pkg, lambda s: _plain_nodes(s, 6, cpu="4")))
    first = _plain_pods(side, "a", 16)
    _waves_of(side, first, 4)
    for pod in first[:6]:
        if side.pipe.bindings.get(pod.meta.key):
            side.cache.remove_pod(pod)
    side.pipe.external(poison=False)
    _waves_of(side, _plain_pods(side, "b", 16), 4)
    side.pipe.flush()
    assert side.pipe.stats["resyncs"] >= 1
    return side


def _ev_host_revert(pkg, monkeypatch):
    """The host reverts one winner (a Reserve failure): the successor in
    flight is poisoned, its collect falls back, and its pods come back to
    be re-run one at a time."""
    side = _Side(pkg, None, base=_Base(pkg, lambda s: _plain_nodes(s, 8)))
    side.pipe.reject = lambda pod, host: pod.meta.name == "a05"
    _waves_of(side, _plain_pods(side, "a", 32), 8)
    side.pipe.flush()
    assert side.pipe.stats["poisoned"] >= 1 and side.pipe.handed_back
    for pod in list(side.pipe.handed_back):
        side.pipe.schedule_one(pod)
    return side


def _ev_overflow(pkg, monkeypatch):
    """The third launch's tie frame is three all-ones words: every draw
    with a tie rejects 16 times, collect raises, the rng stays where it
    was, the carry dies and the successor is poisoned."""
    side = _Side(pkg, None, base=_Base(pkg, lambda s: _plain_nodes(s, 8)))
    mod = jbackend if pkg == "jax" else tbackend
    real, calls = mod.clone_tie_words, []

    def frame(rng, n):
        calls.append(n)
        return np.full(3, 0xFFFFFFFF, np.uint32) if len(calls) == 3 else real(rng, n)

    with monkeypatch.context() as m:
        m.setattr(mod, "clone_tie_words", frame)
        _waves_of(side, _plain_pods(side, "a", 40), 8)
        side.pipe.flush()
    assert any(e[0] == "collect-fallback" and "overflow" in e[2] for e in side.backend.log)
    for pod in list(side.pipe.handed_back):
        side.pipe.schedule_one(pod)
    return side


def _ev_rerun_window(pkg, monkeypatch):
    """Capacity runs out mid-wave: the pods the wave could not place re-run
    through schedule_pod in the wave's re-run window (K4 on the wave's
    output planes) and reproduce the FitError; the run arrays are logged."""
    side = _Side(pkg, None, base=_Base(pkg, lambda s: _plain_nodes(s, 4, cpu="2")))
    _waves_of(side, _plain_pods(side, "a", 24), 8)
    side.pipe.flush()
    assert side.pipe.stats["reruns"] > 0
    assert sum(v is not None for v in side.pipe.bindings.values()) == 8
    return side


class _Base:
    """Cache, snapshot and backend of one package over nodes(side)."""

    def __init__(self, pkg, nodes):
        self.pkg = pkg
        self.names = JNames() if pkg == "jax" else TNames()
        self.cache = (JCache if pkg == "jax" else TCache)(self.names)
        for n in nodes(self):
            self.cache.add_node(n)
        self.snapshot = (JSnapshot if pkg == "jax" else TSnapshot)()
        self.cache.update_snapshot(self.snapshot)
        self.backend = (TPUBackend(self.names) if pkg == "jax" else
                        TorchBackend(self.names, device="cpu"))


EVENTS = {"node-change": _ev_node_change, "churn-deletes": _ev_churn,
          "host-revert": _ev_host_revert, "tie-overflow": _ev_overflow,
          "rerun-window": _ev_rerun_window}


@pytest.mark.parametrize("event", list(EVENTS))
def test_events_mid_stream_match_reference(event, monkeypatch):
    """Each event through both packages: the same launches raise, the same
    collects fall back, and after every collect and re-run the same hosts,
    carry planes, dedup_stats and run arrays; equal bindings, handed-back
    pods and final rng state."""
    jside = EVENTS[event]("jax", monkeypatch)
    tside = EVENTS[event]("port", monkeypatch)
    assert tside.result() == jside.result()
    assert tside.backend.b._inflight is None


@pytest.mark.parametrize("depth", [2, 1])
def test_gang_between_chained_waves_matches_reference(depth):
    """Plain waves, then (after draining, as the loop drains before a gang)
    a gang through try_gang_wave, its members bound and the carry marked
    external, then more waves: both packages give the same gang hosts and
    outcome, the same logs, bindings and rng state."""
    from kubernetes_tpu.scheduler.tpu import gangplanner as jplanner
    from kubernetes_tpu_torch.scheduler.tpu import gangplanner as tplanner
    from kubernetes_tpu_torch.testing.mixed import build_gang_nodes, build_gangs, gang_wave_spec
    from tests.test_torch_gang import _Jax, _Port, _qpis

    spec = gang_wave_spec()
    results = []
    for pkg in ("jax", "port"):
        types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
        base = (_Jax if pkg == "jax" else _Port)(build_gang_nodes(spec, types, meta))
        side = _Side(pkg, None, base=base, depth=depth)
        planner = jplanner if pkg == "jax" else tplanner
        gangs = []
        for g, (group, pods) in enumerate(build_gangs(spec, types, meta)):
            _waves_of(side, _plain_pods(side, f"w{g}-", 16), 8)
            side.pipe.flush()
            base.add_group(group, pods)
            side.cache.update_snapshot(side.snapshot)
            hosts = planner.try_gang_wave(base, base.fw, side.algo, group.meta.key,
                                          _qpis(pods))
            gangs.append((hosts, base.outcome()))
            if hosts:
                for pod, host in zip(pods, hosts):
                    base.bind(group, pod, host)
                side.pipe.external(poison=True)
        _waves_of(side, _plain_pods(side, "tail-", 16), 8)
        side.pipe.flush()
        results.append((gangs, side.result()))
    assert results[1] == results[0]
    gangs = results[1][0]
    assert all(h and o.startswith("device:") for h, o in gangs)


# --------------------------------------------------------------------------
# the carry's config terms, the device rule, the kernel's parameter block
# --------------------------------------------------------------------------


def test_kernel_config_keeps_carry_ipa_statics():
    """A launched wave of pods with anti-affinity and preferred terms puts
    them on the device carry before the host planes show them: the next
    kernel_config (on planes without them, for a pod without terms) keeps
    ipa_existing_anti/pref on, as the reference's does; dropping the carry
    turns them off again."""
    cfgs = []
    for pkg in ("jax", "port"):
        types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
        side = _Side(pkg, dedup_nodes(12, types, meta, cpu="8"))
        pods = ipa_pods(16, types, meta)
        side.backend.launch_batched(pods, side.snapshot, rng=side.algo.rng, pad_to=16)
        planes = side.backend.sync(side.snapshot)
        assert not planes.ipa_anti.any() and not planes.ipa_pref.any()
        on = side.backend.kernel_config(planes)
        side.backend.invalidate_carry()
        off = side.backend.kernel_config(planes)
        cfgs.append((dataclasses.asdict(on), dataclasses.asdict(off)))
    assert cfgs[0] == cfgs[1]
    (on, off) = cfgs[1]
    assert on["ipa_existing_anti"] and on["ipa_existing_pref"]
    assert not off["ipa_existing_anti"] and not off["ipa_existing_pref"]


def test_launch_on_a_cuda_backend_without_a_card_raises(monkeypatch):
    """No silent fallback: a backend asked for the card refuses to be
    built without one, and where a card only seems present the first
    device allocation or copy fails; launch_batched never runs the plain
    versions for it."""
    names = TNames()
    cache = TCache(names)
    for i in range(4):
        cache.add_node(tw.scheduling_basic_node(i))
    snap = TSnapshot()
    cache.update_snapshot(snap)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(names)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises((RuntimeError, AssertionError)):
        b = TorchBackend(names)
        b.launch_batched([tw.scheduling_basic_pod(0)], snap, rng=random.Random(1))


def _struct_fields(src: str, name: str) -> list[str]:
    import re

    body = src.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = decl.split(None, 1)[1]
        fields += [re.sub(r"\[.*\]", "", n).strip() for n in names.split(",")]
    return fields


def test_scan_params_twin_matches_the_header():
    """K2's parameter block, grown by the chained launch's fields
    (frame_shift, xwave, G_prev), has the same fields in the same order in
    csrc/common.cuh and in its ctypes twin."""
    from pathlib import Path

    from kubernetes_tpu_torch.ops import cuda

    src = (Path(cuda.__file__).parent / "csrc" / "common.cuh").read_text()
    assert _struct_fields(src, "ScanParams") == [f for f, _ in cuda.ScanParams._fields_]
    for f in ("frame_shift", "xwave", "G_prev"):
        assert f in dict(cuda.ScanParams._fields_)


def test_assign_scan_source_header_names_the_seed():
    """K2's source header says what it replaces, the seed included, and no
    longer calls the seed unported; its launcher reads (through scan_args
    in scan_step.cuh, which K6's launcher shares) the eight pointers the
    wrapper appends for the device cursor and the seed."""
    from pathlib import Path

    from kubernetes_tpu_torch.ops import cuda

    csrc = Path(cuda.__file__).parent / "csrc"
    src = (csrc / "assign_scan.cu").read_text()
    header = src.split("#include", 1)[0]
    assert "not ported" not in header
    assert ":1308-1328" in header
    assert "scan_args(ptrs)" in src
    step = (csrc / "scan_step.cuh").read_text()
    assert "ptrs[37]" in step and "ptrs[38]" not in step


def test_port_pipeline_modules_import_no_jax():
    """The new wave loop and the backend import nothing of jax or of the
    reference package (test_torch_slice.py scans the whole port too)."""
    from pathlib import Path

    from tests.test_torch_slice import _imported_roots

    root = Path(tbackend.__file__).resolve().parents[2]
    for rel in ("testing/pipeline.py", "scheduler/tpu/backend.py", "ops/kernels.py"):
        roots = {m.split(".")[0] for m in _imported_roots(root / rel)}
        assert not roots & {"jax", "jaxlib", "kubernetes_tpu"}, rel
