"""The port's volume plugins and node-neutral volume wave plans against the
reference's.

Everything runs through both packages — the reference's (kubernetes_tpu,
Profile(backend="tpu"): its TPU backend on the CPU) and the port's
(kubernetes_tpu_torch, device="cpu": the kernels' plain versions) — on the
same inputs, and the results are held equal (tolerance 0: names, statuses
and integers):

- per plugin (VolumeBinding, VolumeRestrictions, VolumeZone,
  NodeVolumeLimits) on numpy-seeded storage clusters (static, node-pinned,
  zone-labelled and CSI volumes; WaitForFirstConsumer, Immediate and
  provisioning classes; bound, unbound, missing and ephemeral claims;
  ReadWriteOncePod holders; CSI attach limits): PreFilter's status, every
  node's Filter status (per node and batched), the PreFilter extensions,
  every node's Score (per node and batched), `sign` and the registered
  events;
- VolumeBinder.node_neutral_volumes over a sequence of pods, each plan
  assumed before the next pod is checked (the wave's admission rule);
- the six classes of tests/test_volumes.py through both Schedulers: every
  pod's node and nomination, every claim's and volume's binding, the
  kernel/fallback counts and the final rng state, and each reference
  test's own assertions on the port's run.

Both packages' clocks are one virtual clock (each reading 1 µs past the
last); `clock.advance` stands in for the reference tests' sleeps.

tests/test_torch_storage_loop.py holds the hybrid route, the short
volumes.json and dra.json workloads and the default profile.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.api.dra as jdra
import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.storage as jstorage
import kubernetes_tpu.scheduler.plugins.dynamic_resources as jdr
import kubernetes_tpu.scheduler.plugins.volumes as jvol
from kubernetes_tpu.scheduler.framework.interface import Status as JStatus
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu_torch.api.dra as tdra
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.storage as tstorage
import kubernetes_tpu_torch.scheduler.plugins.dynamic_resources as tdr
import kubernetes_tpu_torch.scheduler.plugins.volumes as tvol
import kubernetes_tpu_torch.testing.wrappers as tw
import kubernetes_tpu_torch.utils.clock as tclock
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCycleState
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import CycleState as TCycleState
from kubernetes_tpu_torch.scheduler.framework.interface import Status as TStatus
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, meta=jmeta, storage=jstorage, dra=jdra,
                           vol=jvol, dr=jdr, Store=JStore, Scheduler=JScheduler,
                           Profile=JProfile, Cache=JCache, Snapshot=JSnapshot,
                           Names=JNames, CycleState=JCycleState, Status=JStatus, kw={}),
    "port": SimpleNamespace(name="port", w=tw, meta=tmeta, storage=tstorage, dra=tdra,
                            vol=tvol, dr=tdr, Store=TStore, Scheduler=TScheduler,
                            Profile=TProfile, Cache=TCache, Snapshot=TSnapshot,
                            Names=TNames, CycleState=TCycleState, Status=TStatus,
                            kw={"device": "cpu"}),
}
CSI = "ebs.csi.example.com"


class VirtualClock:
    """Both packages' Clock.now: each reading 1 µs past the last; advance()
    stands in for the reference tests' sleeps."""

    def __init__(self):
        self.t = 1000.0

    def now(self, _clock=None):
        self.t += 1e-6
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    vc = VirtualClock()
    monkeypatch.setattr(jclock.Clock, "now", lambda self: vc.now())
    monkeypatch.setattr(tclock.Clock, "now", lambda self: vc.now())
    tfi.registry().reset(seed=0)
    yield vc
    tfi.registry().reset(seed=0)


def both(fn, *a, **kw):
    """fn(side, ...) for the reference and the port; returns (want, got)."""
    return fn(SIDES["jax"], *a, **kw), fn(SIDES["port"], *a, **kw)


def scheduler(side, store, wave_size=0, seed=0, **kw):
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=wave_size)],
                       seed=seed, **side.kw, **kw)
    s.start()
    return s


def _pv_name(name: str) -> str:
    # a provisioned volume is named after its claim's uid, which each
    # package's store numbers on its own
    return "<provisioned>" if name.startswith("pvc-") else name


def outcome(store, sched):
    """Every pod's node and nomination, every claim's and volume's binding
    (a provisioned volume by its claim), every ResourceClaim's allocation,
    the kernel/fallback counts and the rng state."""
    pods = {p.meta.key: (p.spec.node_name, p.status.nominated_node_name,
                         p.meta.deletion_timestamp is not None)
            for p in store.pods()}
    pvcs = {c.meta.key: (c.status.phase, _pv_name(c.spec.volume_name))
            for c in store.list("PersistentVolumeClaim")[0]}
    pvs = sorted((_pv_name(v.meta.name), v.spec.claim_ref, v.status.phase, v.spec.csi_driver,
                  None if v.spec.node_affinity is None else
                  [[(r.key, r.operator, tuple(r.values)) for r in t.match_expressions]
                   for t in v.spec.node_affinity.terms])
                 for v in store.list("PersistentVolume")[0])
    claims = {c.meta.key: (None if c.status.allocation is None else (
        c.status.allocation.node_name,
        [(d.request, d.driver, d.pool, d.device) for d in c.status.allocation.devices]),
        tuple(c.status.reserved_for))
        for c in store.list("ResourceClaim")[0]}
    algo = sched.algorithms["default-scheduler"]
    return {"pods": pods, "pvcs": pvcs, "pvs": pvs, "claims": claims,
            "counts": (algo.kernel_count, algo.fallback_count),
            "rng": algo.rng.getstate()}


def run_both(scenario):
    """scenario(side, clock) -> (store, scheduler) on both packages; the
    outcomes must be equal. Returns the port's (outcome, store, scheduler)."""
    vc = VirtualClock()
    out = {}
    for name in ("jax", "port"):
        vc.t = 1000.0
        jclock.Clock.now = tclock.Clock.now = lambda self: vc.now()
        store, sched = scenario(SIDES[name], vc)
        out[name] = (outcome(store, sched), store, sched)
    assert out["port"][0] == out["jax"][0]
    return out["port"]


def node_of(store, pod_name):
    return store.get("Pod", f"default/{pod_name}").spec.node_name


# --------------------------------------------------------------------------
# seeded storage clusters: the plugins and the node-neutral plans
# --------------------------------------------------------------------------


def storage_spec(seed: int, n_nodes: int, n_pvs: int, n_pods: int) -> dict:
    """A storage cluster as plain data, drawn from numpy's seeded
    generator: nodes in three zones with CSI attach limits, volumes of
    every kind, claims bound and unbound, holders on nodes, pending pods."""
    rng = np.random.default_rng(seed)
    classes = ["wffc", "local", "", "imm", "prov"]
    nodes = [{"name": f"n{i}", "zone": f"z{i % 3}", "csi": int(rng.integers(0, 4))}
             for i in range(n_nodes)]
    modes = [("ReadWriteOnce",), ("ReadWriteOnce", "ReadOnlyMany"), ("ReadWriteOncePod",)]
    pvs = []
    for j in range(n_pvs):
        kind = rng.integers(0, 4)
        pvs.append({
            "name": f"pv{j}", "class": classes[int(rng.integers(0, 4))],
            "storage": ["1Gi", "5Gi", "10Gi"][int(rng.integers(0, 3))],
            "modes": modes[int(rng.integers(0, 3))] if rng.random() < 0.8 else modes[0],
            "nodes": tuple(nodes[int(k)]["name"] for k in
                           rng.choice(n_nodes, size=2, replace=False)) if kind == 1 else (),
            "zone": f"z{int(rng.integers(0, 3))}" if kind == 2 else None,
            "csi": CSI if kind == 3 else ""})
    pvcs = []
    bound_pvs = rng.choice(n_pvs, size=n_pvs // 3, replace=False)
    # among the bound volumes at least one zoned, one CSI and one
    # ReadWriteOncePod volume, each with a pod of its own below
    pvs[int(bound_pvs[0])].update(nodes=(), zone="z1", csi="")
    pvs[int(bound_pvs[1])].update(nodes=(), zone=None, csi=CSI)
    pvs[int(bound_pvs[2])]["modes"] = modes[2]
    for j in bound_pvs:
        pv = pvs[int(j)]
        pvcs.append({"name": f"b-{pv['name']}", "class": pv["class"], "storage": "1Gi",
                     "modes": pv["modes"], "volume": pv["name"]})
        pv["claim"] = f"default/b-{pv['name']}"
    for j in range(n_pvs // 2):
        pvcs.append({"name": f"u{j}", "class": classes[int(rng.integers(0, 5))],
                     "storage": ["1Gi", "5Gi", "8Gi"][int(rng.integers(0, 3))],
                     "modes": modes[int(rng.integers(0, 3))] if rng.random() < 0.7 else modes[0],
                     "volume": ""})
    names = [c["name"] for c in pvcs]
    holders = []
    for j, c in enumerate(pvcs):
        if c["volume"] and rng.random() < 0.5:
            holders.append({"name": f"h{j}", "node": nodes[int(rng.integers(0, n_nodes))]["name"],
                            "claims": (c["name"],)})
    pods = []
    for i in range(n_pods):
        k = int(rng.integers(1, 3))
        claims = tuple(names[int(x)] for x in rng.choice(len(names), size=k, replace=False))
        if rng.random() < 0.08:
            claims += ("missing",)
        pods.append({"name": f"p{i}", "claims": claims, "ephemeral": rng.random() < 0.05})
    for j in bound_pvs[:3]:
        pods.append({"name": f"q{int(j)}", "claims": (f"b-pv{int(j)}",), "ephemeral": False})
    return {"nodes": nodes, "pvs": pvs, "pvcs": pvcs, "holders": holders, "pods": pods}


def build_storage(side, spec, store):
    """The spec's objects in `side`'s types, written into `store`; returns
    (nodes, holders, pending pods)."""
    w = side.w
    store.create(w.make_storage_class("wffc"))
    store.create(w.make_storage_class("local"))
    store.create(w.make_storage_class("imm", wait_for_first_consumer=False))
    store.create(w.make_storage_class("prov", provisioner=CSI))
    nodes = []
    for n in spec["nodes"]:
        node = w.make_node(n["name"], zone=n["zone"])
        nodes.append(node)
        store.create(node)
        store.create(w.make_csi_node(n["name"], **{CSI.replace(".", "__"): n["csi"]}))
    for v in spec["pvs"]:
        pv = w.make_pv(v["name"], storage=v["storage"], storage_class=v["class"],
                       access_modes=v["modes"], node_names=v["nodes"], zone=v["zone"],
                       csi_driver=v["csi"])
        pv.spec.claim_ref = v.get("claim", "")
        store.create(pv)
    for c in spec["pvcs"]:
        store.create(w.make_pvc(c["name"], storage=c["storage"], storage_class=c["class"],
                                access_modes=c["modes"], volume_name=c["volume"],
                                bound=bool(c["volume"])))
    holders = []
    for h in spec["holders"]:
        pod = w.make_pod(h["name"], cpu="100m", node_name=h["node"])
        for c in h["claims"]:
            w.with_pvc(pod, c)
        holders.append(pod)
    pods = []
    for p in spec["pods"]:
        pod = w.make_pod(p["name"], cpu="100m")
        for c in p["claims"]:
            w.with_pvc(pod, c)
        if p["ephemeral"]:
            pod.spec.volumes = tuple(pod.spec.volumes) + (
                side.storage.Volume(name="scratch", ephemeral=True),)
        pods.append(pod)
    return nodes, holders, pods


def _st(st):
    return None if st is None else (st.code, tuple(st.reasons), st.plugin)


def _ok(st):
    """A Filter answer with success spelled one way."""
    return None if st is None or st.is_success else _st(st)


def plugin_trace(side, plugin_name, spec):
    """Everything one volume plugin answers for each pending pod of the
    spec, over a snapshot holding the spec's nodes and holders."""
    store = side.Store()
    nodes, holders, pods = build_storage(side, spec, store)
    names = side.Names()
    cache = side.Cache(names)
    for n in nodes:
        cache.add_node(n)
    for h in holders:
        cache.add_pod(h)
    snap = side.Snapshot()
    cache.update_snapshot(snap)
    plugin = getattr(side.vol, plugin_name)(store)
    nis = snap.list_nodes()
    out = [sorted((e.event.resource, e.event.action_type, e.event.label)
                  for e in plugin.events_to_register())]
    for pod in pods:
        state = side.CycleState()
        rec = {"sign": plugin.sign(pod) if hasattr(plugin, "sign") else None}
        _, st = plugin.pre_filter(state, pod, nis)
        rec["pre_filter"] = _st(st)
        if st is None or st.is_success:
            per_node = [plugin.filter(state, pod, ni) for ni in nis]
            rec["filter"] = [_st(st) for st in per_node]
            if hasattr(plugin, "filter_batch"):
                state2 = side.CycleState()
                plugin.pre_filter(state2, pod, nis)
                batch = plugin.filter_batch(state2, pod, nis)
                rec["filter_batch"] = None if batch is None else [_st(st) for st in batch]
                if batch is not None:
                    # the batch answers as the per-node calls do
                    assert [_ok(st) for st in batch] == [_ok(st) for st in per_node]
            if hasattr(plugin, "add_pod") and holders:
                host = next(ni for ni in nis if ni.pods)
                pi = next(iter(host.iter_pods()))
                rec["remove_pod"] = _st(plugin.remove_pod(state, pod, pi, host))
                rec["filter_removed"] = [_st(plugin.filter(state, pod, ni)) for ni in nis]
                rec["add_pod"] = _st(plugin.add_pod(state, pod, pi, host))
            if hasattr(plugin, "score"):
                feasible = [ni for ni, s in zip(nis, rec["filter"]) if s is None or s[0] == 0]
                rec["score"] = [tuple(plugin.score(state, pod, ni)[0:1]) for ni in feasible]
                if hasattr(plugin, "score_batch"):
                    rec["score_batch"] = list(plugin.score_batch(state, pod, feasible))
        out.append(rec)
    return out


SPECS = {"a": (61, 9, 24, 40), "b": (62, 14, 40, 60), "c": (63, 5, 12, 30)}


@pytest.mark.parametrize("spec_id", sorted(SPECS))
@pytest.mark.parametrize("plugin", ["VolumeBinding", "VolumeRestrictions", "VolumeZone",
                                    "NodeVolumeLimits"])
def test_volume_plugin_matches_reference(plugin, spec_id):
    spec = storage_spec(*SPECS[spec_id])
    want, got = both(plugin_trace, plugin, spec)
    assert got == want
    # the trace met a rejection and a pass somewhere
    codes = {s[0] for r in got[1:] for s in (r.get("filter") or []) if s is not None}
    assert codes, "no pod reached Filter"


def neutral_plans(side, spec):
    """node_neutral_volumes for every pending pod in order, each plan
    assumed before the next pod is checked; the binder's assumes after."""
    store = side.Store()
    _, _, pods = build_storage(side, spec, store)
    binder = side.vol.VolumeBinder(store)
    log = []
    for pod in pods:
        plan = binder.node_neutral_volumes(pod)
        if plan is None:
            log.append(None)
            continue
        binder.assume_pod_volumes(plan)
        log.append((list(plan.static_bindings), list(plan.dynamic_provisions)))
    return log, dict(binder.assumed)


@pytest.mark.parametrize("spec_id", sorted(SPECS))
def test_node_neutral_plans_match_reference(spec_id):
    spec = storage_spec(*SPECS[spec_id])
    # unpinned, unlabelled volumes only for half the volumes, so plans exist
    for v in spec["pvs"][::2]:
        v.update(nodes=(), zone=None, csi="")
    want, got = both(neutral_plans, spec)
    assert got == want
    log = got[0]
    assert any(p is None for p in log) and any(p is not None for p in log)
    # no volume assumed for two claims
    assert len(set(got[1])) == len(got[1])


# --------------------------------------------------------------------------
# tests/test_volumes.py through both Schedulers
# --------------------------------------------------------------------------


class TestVolumeBinding:
    def test_wait_for_first_consumer_local_pv(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_storage_class("local", wait_for_first_consumer=True))
            store.create(w.make_pv("pv-n2", storage="10Gi", storage_class="local",
                                   node_names=("n2",)))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="local"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n2"
        pvc = store.get("PersistentVolumeClaim", "default/data")
        assert pvc.status.phase == tstorage.CLAIM_BOUND
        assert pvc.spec.volume_name == "pv-n2"
        assert store.get("PersistentVolume", "pv-n2").spec.claim_ref == "default/data"

    def test_unbound_immediate_claim_unschedulable(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_storage_class("fast", wait_for_first_consumer=False))
            store.create(w.make_pvc("data", storage_class="fast"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == ""

    def test_missing_claim_unschedulable(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "nope"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == ""

    def test_bound_claim_node_affinity_conflict(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_pv("pv1", storage_class="local", node_names=("n1",)))
            store.create(w.make_pvc("data", storage_class="local", volume_name="pv1",
                                    bound=True))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n1"

    def test_dynamic_provisioning(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_storage_class("csi-fast", provisioner=CSI,
                                              wait_for_first_consumer=True))
            store.create(w.make_pvc("data", storage="8Gi", storage_class="csi-fast"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n1"
        pvc = store.get("PersistentVolumeClaim", "default/data")
        assert pvc.status.phase == tstorage.CLAIM_BOUND
        pv = store.get("PersistentVolume", pvc.spec.volume_name)
        assert pv.spec.claim_ref == "default/data"
        assert pv.spec.csi_driver == CSI

    @pytest.mark.parametrize("wave_size", [0, 8])
    def test_two_pods_compete_for_one_pv(self, wave_size):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_storage_class("local", wait_for_first_consumer=True))
            store.create(w.make_pv("only-pv", storage_class="local"))
            store.create(w.make_pvc("c1", storage_class="local"))
            store.create(w.make_pvc("c2", storage_class="local"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "c1"))
            store.create(w.with_pvc(w.make_pod("p2", cpu="1"), "c2"))
            s = scheduler(side, store, wave_size=wave_size)
            s.schedule_pending()
            return store, s

        _, store, s = run_both(scenario)
        placed = [n for n in (node_of(store, "p1"), node_of(store, "p2")) if n]
        assert len(placed) == 1
        bound = [c for c in (store.get("PersistentVolumeClaim", "default/c1"),
                             store.get("PersistentVolumeClaim", "default/c2"))
                 if c.is_bound]
        assert len(bound) == 1 and bound[0].spec.volume_name == "only-pv"
        assert s.algorithms["default-scheduler"]._wave_plans == {}


class TestVolumeNeutralWave:
    def test_unpinned_wffc_pods_ride_the_wave(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            for i in range(8):
                store.create(w.make_node(f"n{i}"))
            store.create(w.make_storage_class("wffc", wait_for_first_consumer=True))
            for i in range(6):
                store.create(w.make_pv(f"pv{i}", storage="10Gi", storage_class="wffc"))
                store.create(w.make_pvc(f"c{i}", storage="5Gi", storage_class="wffc"))
                store.create(w.with_pvc(w.make_pod(f"p{i}", cpu="100m"), f"c{i}"))
            s = scheduler(side, store, wave_size=8)
            assert s.schedule_pending() == 6
            return store, s

        out, store, s = run_both(scenario)
        algo = s.algorithms["default-scheduler"]
        assert out["counts"] == (6, 0)
        assert s.loop.phase_profile["waves"] > 0
        for i in range(6):
            assert store.get("PersistentVolumeClaim", f"default/c{i}").status.phase == \
                tstorage.CLAIM_BOUND
            assert node_of(store, f"p{i}")
        assert len({store.get("PersistentVolumeClaim", f"default/c{i}").spec.volume_name
                    for i in range(6)}) == 6
        assert algo._wave_plans == {}

    def test_pinned_pv_pods_stay_on_hybrid_path(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_storage_class("local", wait_for_first_consumer=True))
            store.create(w.make_pv("pv-n2", storage="10Gi", storage_class="local",
                                   node_names=("n2",)))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="local"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="100m"), "data"))
            s = scheduler(side, store, wave_size=8)
            assert not s.algorithms["default-scheduler"].wave_eligible(
                store.get("Pod", "default/p1"))
            assert s.schedule_pending() == 1
            return store, s

        _, store, s = run_both(scenario)
        assert node_of(store, "p1") == "n2"
        assert s.loop.phase_profile["waves"] == 0

    def test_failed_wave_finish_reverts_the_plan(self):
        """A wave pod whose Reserve fails after the kernel placed it gives
        its assumed volume back (safe_revert_volumes), so the pods re-run
        after it can take it: the same outcome as the reference."""
        def scenario(side, clock):
            w, store = side.w, side.Store()
            for i in range(4):
                store.create(w.make_node(f"n{i}"))
            store.create(w.make_storage_class("wffc", wait_for_first_consumer=True))
            for i in range(3):
                store.create(w.make_pv(f"pv{i}", storage="10Gi", storage_class="wffc"))
                store.create(w.make_pvc(f"c{i}", storage="5Gi", storage_class="wffc"))
                store.create(w.with_pvc(w.make_pod(f"p{i}", cpu="100m"), f"c{i}"))
            s = scheduler(side, store, wave_size=8)
            fw = s.frameworks["default-scheduler"]
            vb = next(p for p in fw.reserve_plugins if p.name == "VolumeBinding")
            orig = vb.reserve
            calls = []

            def reserve(state, pod, node_name):
                calls.append(pod.meta.name)
                if len(calls) == 1:
                    return side.Status.unschedulable("injected", plugin="VolumeBinding")
                return orig(state, pod, node_name)

            vb.reserve = reserve
            s.schedule_pending()
            clock.advance(30)
            s.schedule_pending()
            return store, s

        out, store, s = run_both(scenario)
        assert all(v[0] for v in out["pods"].values())
        assert s.algorithms["default-scheduler"]._wave_plans == {}
        assert s.algorithms["default-scheduler"]._volume_binder().assumed == {}


class TestVolumeZone:
    def test_zone_conflict_filters_node(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n-a", zone="zone-a"))
            store.create(w.make_node("n-b", zone="zone-b"))
            store.create(w.make_pv("pv-a", storage_class="", zone="zone-a"))
            store.create(w.make_pvc("data", storage_class="", volume_name="pv-a", bound=True))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n-a"


class TestVolumeRestrictions:
    def test_rwop_conflict(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_pv("pv1", access_modes=("ReadWriteOncePod",)))
            store.create(w.make_pvc("data", access_modes=("ReadWriteOncePod",),
                                    volume_name="pv1", bound=True))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1", node_name="n1"), "data"))
            store.create(w.with_pvc(w.make_pod("p2", cpu="1"), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p2") == ""

    def test_rwop_free_after_owner_deleted(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_pv("pv1", access_modes=("ReadWriteOncePod",)))
            store.create(w.make_pvc("data", access_modes=("ReadWriteOncePod",),
                                    volume_name="pv1", bound=True))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1", node_name="n1"), "data"))
            store.create(w.with_pvc(w.make_pod("p2", cpu="1"), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            assert node_of(store, "p2") == ""
            store.delete("Pod", "default/p1")
            clock.advance(1.1)  # the retried pod's backoff
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p2") == "n1"


class TestNodeVolumeLimits:
    def test_csi_attach_limit(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_csi_node("n1", **{"ebs__csi__example__com": 1}))
            store.create(w.make_csi_node("n2", **{"ebs__csi__example__com": 8}))
            for claim in ("v1", "v2"):
                store.create(w.make_pv(f"pv-{claim}", csi_driver=CSI))
                store.create(w.make_pvc(claim, volume_name=f"pv-{claim}", bound=True))
            store.create(w.with_pvc(w.make_pod("existing", cpu="1", node_name="n1"), "v1"))
            store.create(w.with_pvc(w.make_pod("newpod", cpu="1"), "v2"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "newpod") == "n2"


class TestReviewFixes:
    def test_provisioned_pv_pinned_to_selected_node(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_node("n2"))
            store.create(w.make_storage_class("csi", provisioner=CSI,
                                              wait_for_first_consumer=True))
            store.create(w.make_pvc("data", storage_class="csi"))
            store.create(w.with_pvc(w.make_pod("p1", cpu="1"), "data"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            store.create(w.with_pvc(w.make_pod("p2", cpu="1"), "data"))
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        landed = node_of(store, "p1")
        pvc = store.get("PersistentVolumeClaim", "default/data")
        assert store.get("PersistentVolume", pvc.spec.volume_name).spec.node_affinity is not None
        assert node_of(store, "p2") == landed

    def test_rwop_conflict_resolvable_by_preemption(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            store.create(w.make_pv("pv1", access_modes=("ReadWriteOncePod",)))
            store.create(w.make_pvc("data", access_modes=("ReadWriteOncePod",),
                                    volume_name="pv1", bound=True))
            store.create(w.with_pvc(w.make_pod("holder", cpu="1", node_name="n1",
                                               priority=0), "data"))
            store.create(w.with_pvc(w.make_pod("urgent", cpu="1", priority=100), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            holder = store.try_get("Pod", "default/holder")
            assert holder is None or holder.meta.deletion_timestamp is not None
            clock.advance(1.1)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "urgent") == "n1"

    def test_ephemeral_claim_requires_pod_ownership(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n1"))
            # a foreign claim that collides with the generated ephemeral name
            store.create(w.make_pvc("p1-scratch"))
            pod = w.make_pod("p1", cpu="1")
            pod.spec.volumes = (side.storage.Volume(name="scratch", ephemeral=True),)
            store.create(pod)
            s = scheduler(side, store)
            s.schedule_pending()
            assert node_of(store, "p1") == ""  # rejected, not adopted
            owned = w.make_pvc("p2-scratch", volume_name="pv-x", bound=True)
            owned.meta.owner_references.append(
                side.meta.OwnerReference(kind="Pod", name="p2", uid="u", controller=True))
            store.create(w.make_pv("pv-x"))
            store.create(owned)
            pod2 = w.make_pod("p2", cpu="1")
            pod2.spec.volumes = (side.storage.Volume(name="scratch", ephemeral=True),)
            store.create(pod2)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == ""
        assert node_of(store, "p2") == "n1"
