"""The mesh over several cards end to end on the CPU ("cards" are CPU
devices, the kernels' plain versions run at the card level):

- WavePipeline at depth 2 over the reference's TPUBackend on a 4-device
  MeshContext and over the port's TorchBackend on a MeshContext of 4 CPU
  cards x 1 shard and of 2 cards x 2 shards: chained waves, a node change
  mid-stream (resync, full re-upload), K3 row scatters routed to the cards
  that own the rows and re-runs through K4; equal logs after every collect
  and re-run, equal bindings and final rng state;
- the Scheduler over a store (SchedulingBasic-like nodes and pods, churn
  deletes and a node change between waves) on 4 CPU cards: the same
  bindings, diagnoses and final rng state as the reference's loop on a
  4-device MeshContext (KUBE_TPU_MESH_DEVICES=4) and as the port's on one
  card;
- the reference's bench_multichip churn bursts (launch/collect, new running
  pods between bursts, mark_external, NeedResync, a retried launch) on both
  packages at two node counts: equal hosts and rng, and each card's
  per-burst upload flat over the warm bursts (max/min <= 1.1);
- a warm start over 4 CPU cards: every card's warm launches under labels
  naming the card count, no first use left for the waves, the bindings a
  cold start's.

Every comparison is exact (integers, bools and names: tolerance 0). The
reference's side of each pipeline scenario runs once per process.
"""

import functools
import random

import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tpu.backend import NeedResync as JNeedResync
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import cards as tc
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.cards import CardTensor
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu.backend import NeedResync as TNeedResync
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing.mixed import (
    build_nodes,
    build_pods,
    dedup_nodes,
    dedup_pods,
    mixed_spec,
)
from tests.test_torch_loop import SIDES, outcome, scheduler
from tests.test_torch_pipeline import _Side, _waves_of, _wrappers
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)


def _card_ctx(cards, shards):
    return tmesh.MeshContext(tmesh.scheduler_mesh(cards * shards, devices=["cpu"] * cards))


class _Base:
    """Cache, snapshot and a backend on a mesh, for one package: the
    reference's on 4 devices, the port's on `cards` CPU cards."""

    def __init__(self, pkg, nodes, cards=4, shards=1):
        self.pkg = pkg
        self.names = JNames() if pkg == "jax" else TNames()
        self.cache = (JCache if pkg == "jax" else TCache)(self.names)
        for n in nodes:
            self.cache.add_node(n)
        self.snapshot = (JSnapshot if pkg == "jax" else TSnapshot)()
        self.cache.update_snapshot(self.snapshot)
        if pkg == "jax":
            self.backend = TPUBackend(self.names, context=jmesh.MeshContext(
                jmesh.scheduler_mesh(n_devices=4)))
        else:
            self.backend = TorchBackend(self.names, device="cpu",
                                        context=_card_ctx(cards, shards))


def _node_change(pkg, cluster, cards=4, shards=1):
    """A cluster's first half of pods in waves of 8, a node added while a
    wave is in flight (mark_external -> NeedResync -> drain, drop the
    carry, re-upload), then the second half."""
    types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
    if cluster == "mixed":
        spec = mixed_spec(7, 24, 48, constraints=True)
        nodes, pods = build_nodes(spec, types, meta), build_pods(spec, types, meta)
    else:
        nodes = dedup_nodes(16, types, meta, cpu="8")
        pods = dedup_pods(48, types, meta, spread=(2, "zone"))
    side = _Side(pkg, None, base=_Base(pkg, nodes, cards, shards))
    _waves_of(side, pods[:24], 8)
    w = _wrappers(side)
    side.cache.add_node(w.make_node("extra", cpu="64", mem="64Gi", zone="zone-1"))
    side.pipe.external(poison=False)
    _waves_of(side, pods[24:], 8)
    side.pipe.flush()
    return side


@functools.lru_cache(maxsize=None)
def _reference(cluster):
    return _node_change("jax", cluster).result()


def _spy(monkeypatch):
    """Count the card-level plain versions' calls (the CPU runs them and
    counts no launch) and the one-card scan's."""
    calls = {"cards_assign": 0, "cards_fit": 0, "assign_scan": 0}

    def wrap(name, fn):
        def spy(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return spy

    monkeypatch.setattr(tc, "cards_assign_ref", wrap("cards_assign", tc.cards_assign_ref))
    monkeypatch.setattr(tc, "cards_fit_and_score_ref",
                        wrap("cards_fit", tc.cards_fit_and_score_ref))
    monkeypatch.setattr(tk, "assign_scan", wrap("assign_scan", tk.assign_scan))
    return calls


@pytest.mark.parametrize("cards,shards", [(4, 1), (2, 2)])
@pytest.mark.parametrize("cluster", ["mixed", "hard-spread"])
def test_card_pipeline_matches_reference(cluster, cards, shards, monkeypatch):
    """WavePipeline at depth 2 over the reference's 4-device mesh backend
    and the port's card-level backend: the same launches raise, the same
    collects fall back, and after every collect and re-run the same hosts,
    carry planes (joined over the cards), dedup_stats and run arrays;
    equal bindings and rng. The port's planes, carry and signature table
    are split by card; its scans ran at the card level, K2 never."""
    want = _reference(cluster)
    calls = _spy(monkeypatch)
    tside = _node_change("port", cluster, cards, shards)
    assert tside.result() == want
    b = tside.backend.b
    assert b.cards == cards and b._ctx.n_shards == 4
    assert calls["cards_assign"] > 0 and calls["assign_scan"] == 0
    assert all(isinstance(v, CardTensor) and len(v.parts) == cards
               for v in b._device_planes.values())
    assert tside.pipe.stats["resyncs"] >= 1 and b.upload_stats["full"] >= 2
    if cluster == "mixed":
        assert b.upload_stats["scatter"] > 0 and tside.pipe.stats["reruns"] > 0
        assert calls["cards_fit"] > 0
    else:
        assert b.pipe_stats["chained"] > 0 and b.dedup_stats["xwave_hits"] > 0
        assert isinstance(b.sig_cache.table["ew"], CardTensor)
    assert b._inflight is None


def _stream(side, store, sched):
    """SchedulingBasic-like nodes in 4 zones and pods, churn deletes and a
    grown node between the waves."""
    w = side.w
    for i in range(24):
        store.create(w.make_node(f"n{i:02d}", cpu="4", mem="16Gi", zone=f"z{i % 4}"))
    for i in range(40):
        store.create(w.make_pod(f"a{i:02d}", cpu="500m", mem="1Gi", labels={"app": "perf"}))
    sched.schedule_pending()
    bound = sorted((p for p in store.pods() if p.spec.node_name),
                   key=lambda p: p.meta.name)[:8]
    for p in bound:
        store.delete("Pod", p.meta.key)
    node = store.get("Node", "n03")
    node.status.allocatable = dict(node.status.allocatable, cpu="16")
    store.update(node, check_version=False)
    for i in range(40):
        store.create(w.make_pod(f"b{i:02d}", cpu="500m", mem="1Gi", labels={"app": "perf"}))
    sched.schedule_pending()


def test_scheduler_over_cards_matches_reference_and_one_card(monkeypatch):
    """The port's Scheduler over 4 CPU cards (context=) binds the stream as
    the reference's loop on a 4-device MeshContext and as the port's on one
    card: equal bindings, diagnoses and final rng state; its waves ran the
    card-level scan."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    calls = _spy(monkeypatch)
    out = {}
    for name, side, kw, env in (("jax", SIDES["jax"], {}, "4"),
                                ("one card", SIDES["port"], {}, None),
                                ("cards", SIDES["port"], {"context": _card_ctx(4, 1)}, None)):
        if env:
            monkeypatch.setenv("KUBE_TPU_MESH_DEVICES", env)
        else:
            monkeypatch.delenv("KUBE_TPU_MESH_DEVICES", raising=False)
        store = side.Store()
        before = dict(calls)
        sched = scheduler(side, store, **kw)
        _stream(side, store, sched)
        out[name] = outcome(store, sched)
        if name == "jax":
            assert sched.algorithms["default-scheduler"].backend._ctx.n_shards == 4
        if name == "cards":
            assert sched.algorithms["default-scheduler"].backend.cards == 4
            assert calls["cards_assign"] > 0 and calls["assign_scan"] == 0
    assert out["cards"] == out["jax"]
    assert out["cards"] == out["one card"]
    assert all(out["cards"][0].values())


def _bursts(pkg, n_nodes, bursts=4, wave=16, churn=4):
    """bench_multichip's run_sweep on one package at a small size: per
    burst the hosts, and (the port) each card's upload bytes."""
    if pkg == "jax":
        from kubernetes_tpu.testing import make_pod, synthetic_cluster

        names = JNames()
        cache, snap = synthetic_cluster(n_nodes, n_zones=8, names=names)
        backend = TPUBackend(names, context=jmesh.MeshContext(jmesh.scheduler_mesh(n_devices=4)))
        resync = JNeedResync
    else:
        from kubernetes_tpu_torch.testing import synthetic_cluster
        from kubernetes_tpu_torch.testing.wrappers import make_pod

        names = TNames()
        cache, snap = synthetic_cluster(n_nodes, n_zones=8, names=names)
        backend = TorchBackend(names, device="cpu", context=_card_ctx(4, 1))
        resync = TNeedResync
    rng = random.Random(0)
    hosts, per_card, seq = [], [], 0
    for b in range(bursts):
        pods = [make_pod(f"b{b}-p{i}", cpu="500m", mem="512Mi", labels={"app": f"g{i % 4}"})
                for i in range(wave)]
        before = list(getattr(backend._ctx, "upload_bytes", []))
        try:
            fl = backend.launch_batched(pods, snap, rng=rng, pad_to=wave)
        except resync:
            backend.invalidate_carry()
            fl = backend.launch_batched(pods, snap, rng=rng, pad_to=wave)
        got, _ = backend.collect(fl, rng=rng)
        hosts.append(got)
        if pkg == "port":
            per_card.append([x - y for x, y in zip(backend._ctx.upload_bytes, before)])
        for k in range(churn):
            cache.add_pod(make_pod(f"churn-{seq}", cpu="100m", mem="64Mi",
                                   node_name=f"node-{(b * churn + k) % n_nodes}"))
            seq += 1
        snap = cache.update_snapshot(snap)
        backend.mark_external()
    return hosts, rng.getstate(), per_card, backend


@pytest.mark.parametrize("n_nodes", [40, 200])
def test_nodes_sweep_bursts_flat_per_card(n_nodes):
    """The reference's --nodes-sweep bursts on both packages (4 cards, 4
    devices): equal hosts and rng; on the port each card's per-burst upload
    is flat over the warm bursts (the delta scatter, never a full re-put)
    and the cold burst's is larger."""
    jhosts, jrng, _, _ = _bursts("jax", n_nodes)
    hosts, rng, per_card, backend = _bursts("port", n_nodes)
    assert hosts == jhosts and rng == jrng
    assert all(h for burst in hosts for h in burst)
    warm = per_card[1:]
    for c in range(4):
        col = [r[c] for r in warm]
        assert min(col) > 0 and max(col) / min(col) <= 1.1, (c, per_card)
        assert per_card[0][c] > max(col)
    assert backend.upload_stats["full"] == 1 and backend.upload_stats["scatter"] >= 1


def test_warm_start_over_cards(monkeypatch):
    """A warm start over 4 CPU cards: start() warms the waves, the
    single-pod cycle and K3 on every card's rows under labels that name the
    card count (`/x4`), skips the gang shape (a mesh backend sends gangs to
    the host cycle), and the warm Scheduler's waves meet no first use; its
    bindings and rng equal a cold start's over the same cards."""
    from kubernetes_tpu_torch.store import Store as TStore
    from kubernetes_tpu_torch.testing import wrappers as tw

    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    out = {}
    for warm in (False, True):
        store = TStore()
        for i in range(24):
            store.create(tw.make_node(f"node-{i}", zone=f"zone-{i % 8}"))
        for i in range(32):
            store.create(tw.make_pod(f"pod-{i}", cpu="100m", mem="50Mi",
                                     labels={"app": "perf"}))
        s = SIDES["port"].Scheduler(store, profiles=[SIDES["port"].Profile(wave_size=16)],
                                    seed=7, device="cpu", warm_start=warm,
                                    context=_card_ctx(4, 1))
        s.start()
        (summary,) = s.warmup_summaries if warm else (None,)
        for i in range(32, 192):
            store.create(tw.make_pod(f"pod-{i}", cpu="100m", mem="50Mi",
                                     labels={"app": "perf"}))
        s.schedule_pending()
        tele = s.flight_recorder.device_telemetry
        out[warm] = ({p.meta.name: p.spec.node_name for p in store.pods()},
                     s.algorithms["default-scheduler"].rng.getstate(),
                     tele.compile_count_since_warm(), summary, tele)
    bound, rng, since, summary, tele = out[True]
    assert all(bound.values()) and (bound, rng) == out[False][:2]
    assert since == 0, since
    assert summary["buckets"] == [8, 16] and summary["scatter"] == [8, 16, 32]
    assert summary["gangs"] == [] and any("host cycle" in x for x in summary["skipped"])
    labels = {sig for kern, sig in tele._compiled if kern == "scatter_rows"}
    assert all(sig[-1] == 4 for sig in labels)
    assert out[False][2] > 0  # the cold start met its first uses in the waves
