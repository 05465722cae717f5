"""The port's store-driven scheduling loop against the reference's.

Each scenario runs through both packages' Scheduler — the reference's
(kubernetes_tpu.scheduler.Scheduler) and the port's
(kubernetes_tpu_torch.scheduler.scheduler.Scheduler, device="cpu", so the
kernels' plain versions run) — over the same store workload, and holds
every binding, every PodScheduled=False diagnosis and the final tie-break
rng state equal (tolerance 0: names, strings and integers):

- the scenarios of tests/test_wave_pipeline.py (an external node change
  mid-stream, capacity-exhaustion FitErrors, a gang trailer that flushes
  the pipeline, churn deletes between waves, the async dispatcher), each
  at pipeline depth 1 and 2, and through the reference's host loop
  (backend="host", no device) against the port's per-pod cycle
  (wave_size 0: K4 through TorchSchedulingAlgorithm);
- ROADMAP C11: a re-run placed after the carry was dropped leaves the
  successor wave unpoisoned, and both loops bind the same (wrong) node;
- on a card a kernel error from launch_batched, collect or run (a single
  pod's cycle, or a gang's host cycle) raises out of schedule_pending, and
  the circuit breaker does not record it;
- an OPEN breaker on an injected clock routes pods and gangs to the host
  tier, then probes the device again; the device rule, the profile
  validation, DefaultBinder in the default profile, and the Scheduler
  with jax and the reference package unimportable.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchSchedulingAlgorithm
from kubernetes_tpu_torch.scheduler.tpu.circuitbreaker import CLOSED
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, types=jtypes, meta=jmeta, Store=JStore,
                           Scheduler=JScheduler, Profile=JProfile, fi=jfi, kw={}),
    "port": SimpleNamespace(name="port", w=tw, types=ttypes, meta=tmeta, Store=TStore,
                            Scheduler=TScheduler, Profile=TProfile, fi=tfi,
                            kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _port_registry():
    """The port's fault registry disarmed and empty around every test (the
    imported _own_process_state does the same for the reference's)."""
    tfi.registry().reset(seed=0)
    yield
    tfi.registry().reset(seed=0)


def scheduler(side, store, backend="tpu", wave_size=8, **kw):
    """backend="host" is the reference's host loop (per-pod, no device);
    the port has no such profile and answers with its per-pod cycle on the
    device backend (wave_size 0)."""
    if backend == "host":
        wave_size = 0
        backend = "tpu" if side.name == "port" else "host"
    prof = side.Profile(backend=backend, wave_size=wave_size)
    s = side.Scheduler(store, profiles=[prof], **side.kw, **kw)
    s.start()
    return s


def outcome(store, sched):
    """(bindings, PodScheduled=False diagnoses, final rng state)."""
    sched.event_recorder.flush()
    placed = {p.meta.name: p.spec.node_name for p in store.pods()}
    diags = {}
    for p in store.pods():
        for c in p.status.conditions:
            if c.type == "PodScheduled" and c.status == "False":
                diags[p.meta.name] = f"{c.reason}: {c.message}"
    return placed, diags, sched.algorithms["default-scheduler"].rng.getstate()


def run_both(build, monkeypatch, depth=2, backend="tpu", **kw):
    """One scenario through both packages' loops; returns their outcomes
    and schedulers."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", str(depth))
    out = {}
    for name, side in SIDES.items():
        store = side.Store()
        sched = scheduler(side, store, backend=backend, **kw)
        build(side, store, sched)
        out[name] = (outcome(store, sched), sched)
    return out


# --------------------------------------------------------------------------
# tests/test_wave_pipeline.py's scenarios
# --------------------------------------------------------------------------


def _external_node_change(side, store, sched):
    w = side.w
    for i in range(10):
        store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 2}"))
    for i in range(20):
        store.create(w.make_pod(f"a{i:02d}", cpu="1", mem="1Gi"))
    sched.schedule_pending()
    # external change: grow node n3 (UpdateNodeAllocatable)
    node = store.get("Node", "n3")
    node.status.allocatable = dict(node.status.allocatable, cpu="64")
    store.update(node, check_version=False)
    for i in range(20):
        store.create(w.make_pod(f"b{i:02d}", cpu="1", mem="1Gi"))
    sched.schedule_pending()


def _capacity_exhaustion(side, store, sched):
    w = side.w
    for i in range(4):
        store.create(w.make_node(f"n{i}", cpu="2", mem="4Gi"))
    for i in range(20):  # 20 x 1 cpu into 8 cpu: 8 fit, 12 do not
        store.create(w.make_pod(f"p{i:02d}", cpu="1", mem="1Gi"))
    sched.schedule_pending()


def _gang_trailer(side, store, sched):
    w, t, m = side.w, side.types, side.meta
    for i in range(8):
        store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi"))
    for i in range(12):
        store.create(w.make_pod(f"plain{i:02d}", cpu="1", mem="1Gi"))
    store.create(t.PodGroup(meta=m.ObjectMeta(name="g1"),
                            spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=3))))
    for i in range(3):
        p = w.make_pod(f"gang{i}", cpu="1", mem="1Gi")
        p.spec.scheduling_group = t.SchedulingGroup(pod_group_name="g1")
        store.create(p)
    sched.schedule_pending()


def _churn_deletes(side, store, sched):
    w = side.w
    for i in range(6):
        store.create(w.make_node(f"n{i}", cpu="4", mem="8Gi"))
    for i in range(12):
        store.create(w.make_pod(f"a{i:02d}", cpu="1", mem="1Gi"))
    sched.schedule_pending()
    bound = sorted((p for p in store.pods() if p.spec.node_name),
                   key=lambda p: p.meta.name)[:6]
    for p in bound:
        store.delete("Pod", p.meta.key)
    for i in range(12):
        store.create(w.make_pod(f"b{i:02d}", cpu="1", mem="1Gi"))
    sched.schedule_pending()


SCENARIOS = {
    "external_node_change": _external_node_change,
    "capacity_exhaustion": _capacity_exhaustion,
    "gang_trailer": _gang_trailer,
    "churn_deletes": _churn_deletes,
}


@pytest.mark.parametrize("loop", ["depth2", "depth1", "host"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_wave_pipeline_scenarios_match_reference(name, loop, monkeypatch):
    backend = "host" if loop == "host" else "tpu"
    depth = 1 if loop == "depth1" else 2
    out = run_both(SCENARIOS[name], monkeypatch, depth=depth, backend=backend)
    (want, jsched), (got, tsched) = out["jax"], out["port"]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    placed = got[0]
    if name == "capacity_exhaustion":
        assert sum(1 for v in placed.values() if v) == 8
        assert len(got[1]) == 12 and all("Insufficient cpu" in d for d in got[1].values())
    else:
        assert all(placed.values()), {k: v for k, v in placed.items() if not v}
    talgo = tsched.algorithms["default-scheduler"]
    assert talgo.kernel_count > 0
    assert talgo.breaker.state == CLOSED
    if backend == "host":
        assert tsched.loop.phase_profile["waves"] == 0
    else:
        jalgo = jsched.algorithms["default-scheduler"]
        assert (talgo.kernel_count, talgo.fallback_count) == (
            jalgo.kernel_count, jalgo.fallback_count)
        assert tsched.loop.phase_profile["waves"] == jsched.loop.phase_profile["waves"] > 0
        assert tsched.loop._inflight_wave is None


def test_async_dispatcher_with_pipeline_matches_reference(monkeypatch):
    """SchedulerAsyncAPICalls + pipelined waves: binds land through the
    dispatcher, every pod binds, and the placements equal the
    reference's."""
    def build(side, store, sched):
        for i in range(12):
            store.create(side.w.make_node(f"n{i}", cpu="8", mem="16Gi"))
        for i in range(50):
            store.create(side.w.make_pod(f"p{i:02d}", cpu="500m", mem="512Mi"))
        sched.schedule_pending()
        sched.api_dispatcher.close()

    out = run_both(build, monkeypatch, wave_size=16, async_api_calls=True)
    (want, _), (got, tsched) = out["jax"], out["port"]
    assert sum(1 for v in got[0].values() if v) == 50
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert tsched.api_dispatcher is not None


# --------------------------------------------------------------------------
# C11: the re-run after the carry was dropped leaves the successor unpoisoned
# --------------------------------------------------------------------------


def _c11(side, monkeypatch):
    """Zones zA and zB; wave k holds pod A, which fits nowhere; wave k+1
    holds pod B with required zone anti-affinity to A's label; node "big" in zA is
    added (store -> informer -> cache) right after k+1's launch, while k+1
    is in flight. A's re-run in k's re-run window places it on "big" on
    host truth, the carry is gone, so mark_wave_external's gate leaves k+1
    unpoisoned and B binds to a0 in zA (the reference's fault, kept)."""
    w = side.w
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    store = side.Store()
    store.create(w.make_node("a0", cpu="8", mem="16Gi", zone="zA"))
    store.create(w.make_node("b0", cpu="4", mem="8Gi", zone="zB"))
    sched = scheduler(side, store)
    backend = sched.algorithms["default-scheduler"].backend
    launches = []
    orig = type(backend).launch_batched

    def launch(self, *a, **k):
        fl = orig(self, *a, **k)
        launches.append(fl)
        if len(launches) == 2:
            store.create(w.make_node("big", cpu="32", mem="64Gi", zone="zA"))
            sched.pump()
        return fl

    monkeypatch.setattr(type(backend), "launch_batched", launch)

    def pod(name, cpu):
        # both pods labelled app=A with the same term, so wave k+1 brings
        # no new selector or term: it chains on k's carry (no bucket
        # change, no resync); A's own term matches no other pod before B
        return w.with_pod_affinity(w.make_pod(name, cpu=cpu, mem="1Gi", labels={"app": "A"}),
                                   "app", "A", "topology.kubernetes.io/zone", anti=True)

    store.create(pod("A", "16"))
    sched.pump()
    sched.loop.schedule_wave(8)  # wave k: [A], in flight
    store.create(pod("B", "1"))
    sched.pump()
    sched.loop.schedule_wave(8)  # wave k+1: [B]; completes k (A's re-run)
    assert not launches[1].poisoned
    sched.schedule_pending()
    placed, diags, rng = outcome(store, sched)
    return placed, diags, rng, len(launches)


def test_c11_rerun_after_dropped_carry_leaves_successor_unpoisoned(monkeypatch):
    want = _c11(SIDES["jax"], monkeypatch)
    got = _c11(SIDES["port"], monkeypatch)
    assert got == want
    placed = got[0]
    # the same wrong binding on both loops: B shares zone zA with A
    assert placed == {"A": "big", "B": "a0"}


# --------------------------------------------------------------------------
# a kernel error on the card raises; the breaker does not record it
# --------------------------------------------------------------------------


@pytest.mark.parametrize("where", ["launch_batched", "collect", "run", "gang_host_cycle"])
def test_kernel_error_on_the_card_leaves_schedule_pending(where, monkeypatch):
    """A RuntimeError from launch_batched (K1/K2 build or launch), collect
    (the result wait) or run (K4: the per-pod cycle, or the members of a
    gang that try_gang_wave declines, here with KUBE_TPU_GANG_WAVES=0),
    with on_card true, leaves schedule_pending; the breaker stays CLOSED
    with no failure counted and no pod is sent to the host tier."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    monkeypatch.setattr(TorchSchedulingAlgorithm, "on_card", True)
    gang = where == "gang_host_cycle"
    if gang:
        monkeypatch.setenv("KUBE_TPU_GANG_WAVES", "0")
        where = "run"

    def boom(*a, **k):
        raise RuntimeError(f"{where}: CUDA error: an illegal memory access")

    monkeypatch.setattr(tbackend.TorchBackend, where, boom)
    side = SIDES["port"]
    store = side.Store()
    for i in range(4):
        store.create(side.w.make_node(f"n{i}", cpu="8", mem="16Gi"))
    # the per-pod cycle takes a nominated pod (never batched in a wave)
    pods = [side.w.make_pod(f"p{i:02d}", cpu="1", mem="1Gi") for i in range(12)]
    if gang:
        t, m = side.types, side.meta
        store.create(t.PodGroup(meta=m.ObjectMeta(name="g"),
                                spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=3))))
        pods = [side.w.with_gang(side.w.make_pod(f"g{i}", cpu="1", mem="1Gi"), "g")
                for i in range(3)]
    elif where == "run":
        pods[0].status.nominated_node_name = "n-gone"
    for p in pods:
        store.create(p)
    sched = scheduler(side, store)
    algo = sched.algorithms["default-scheduler"]
    with pytest.raises(RuntimeError, match="illegal memory access"):
        sched.schedule_pending()
    assert algo.breaker.state == CLOSED
    assert algo.breaker.consecutive_failures == 0
    assert algo.fallback_count == 0
    assert not any(p.spec.node_name for p in store.pods())
    assert not any(c.type == "PodScheduled" for p in store.pods()
                   for c in p.status.conditions)


# --------------------------------------------------------------------------
# the breaker's routes, the device rule, profiles, the default binder
# --------------------------------------------------------------------------


def _breaker_side(side, monkeypatch):
    """A scheduler over 6 nodes and 12 pods, its breaker on an injected
    clock and tripped OPEN by three recorded failures."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    store = side.Store()
    for i in range(6):
        store.create(side.w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 2}"))
    for i in range(12):
        store.create(side.w.make_pod(f"p{i:02d}", cpu="1", mem="1Gi", labels={"app": "x"}))
    s = scheduler(side, store)
    algo = s.algorithms["default-scheduler"]
    now = [100.0]
    algo.breaker._clock = lambda: now[0]
    for _ in range(3):
        algo.breaker.record_failure("injected: test")
    return s, store, algo, now


def test_open_breaker_routes_to_the_host_tier(monkeypatch):
    """While the breaker is OPEN and cooling, the loop launches no wave and
    schedule_pod routes every pod to the host tier (no K4 run); after the
    cooldown a HALF_OPEN probe wave goes to the device again. Bindings, rng
    and counts equal the reference's."""
    out = {}
    for name, side in SIDES.items():
        s, store, algo, now = _breaker_side(side, monkeypatch)
        runs = []
        orig = type(algo.backend).run

        def run(self, *a, **k):
            runs.append(1)
            return orig(self, *a, **k)

        monkeypatch.setattr(type(algo.backend), "run", run)
        assert algo.breaker.state == "open" and algo.breaker.device_blocked()
        s.schedule_pending()
        cooling = (algo.fallback_count, algo.kernel_count, len(runs),
                   s.loop.phase_profile["waves"])
        now[0] += 5.0  # past the cooldown: the next wave is a probe
        for i in range(12, 20):
            store.create(side.w.make_pod(f"p{i:02d}", cpu="1", mem="1Gi", labels={"app": "x"}))
        s.schedule_pending()
        out[name] = (outcome(store, s), cooling, algo.breaker.state,
                     [(o, n) for o, n, _ in s.flight_recorder.breaker_events],
                     s.loop.phase_profile["waves"], algo.kernel_count)
    assert out["port"] == out["jax"]
    (placed, _, _), cooling, state, events, waves, kernel = out["port"]
    assert all(placed.values())
    assert cooling == (12, 0, 0, 0)
    assert events[0] == ("closed", "open") and ("open", "half_open") in events
    assert waves > 0 and kernel > 0


def test_open_breaker_sends_a_gang_to_the_host_cycle(monkeypatch):
    """try_gang_wave declines a gang while the breaker cools, as the
    reference's planner does (gangplanner.py:146)."""
    out = {}
    for name, side in SIDES.items():
        s, store, algo, _ = _breaker_side(side, monkeypatch)
        t, m = side.types, side.meta
        store.create(t.PodGroup(meta=m.ObjectMeta(name="g"),
                                spec=t.PodGroupSpec(policy=t.GangPolicy(min_count=3))))
        for i in range(3):
            store.create(side.w.with_gang(side.w.make_pod(f"g{i}", cpu="1", mem="1Gi"), "g"))
        s.schedule_pending()
        totals = (algo.backend.gang_pod_totals if name == "port"
                  else s.flight_recorder.gang_pod_totals)
        out[name] = (outcome(store, s), dict(totals))
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"host": 3}


def test_scheduler_needs_a_card_unless_cpu_is_asked():
    """The device rule: every profile's backend runs on "cuda" unless the
    caller passes device="cpu"; without a card the constructor raises."""
    import torch

    store = TStore()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TScheduler(store, profiles=[TProfile(backend="tpu", wave_size=8)])
        # the default profile too: every profile runs on the device backend
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TScheduler(store)
    s = TScheduler(store, profiles=[TProfile(backend="tpu", wave_size=8)], device="cpu")
    assert s.algorithms["default-scheduler"].backend.device.type == "cpu"
    s = TScheduler(TStore(), device="cpu")
    assert isinstance(s.algorithms["default-scheduler"], TorchSchedulingAlgorithm)
    assert s.algorithms["default-scheduler"].backend.device.type == "cpu"


@pytest.mark.parametrize("bad, message", [
    (dict(backend="gpu"), "unknown backend"),
    (dict(wave_size=-1, backend="tpu"), "waveSize must be >= 0"),
    (dict(backend="host"), "unknown backend host"),
    (dict(percentage_of_nodes_to_score=101), "out of range"),
])
def test_profile_validation(bad, message):
    """The per-profile checks of the reference's configuration validation
    (kubernetes_tpu/config/types.py:75-81) and duplicate names."""
    with pytest.raises(ValueError, match=message):
        TScheduler(TStore(), profiles=[TProfile(**bad)], device="cpu")
    with pytest.raises(ValueError, match="unique"):
        TScheduler(TStore(), profiles=[TProfile(), TProfile()], device="cpu")


def test_extenders_and_disabled_kernel_plugins_raise():
    from kubernetes_tpu_torch.ops.kernels import OutOfSlice

    with pytest.raises(OutOfSlice, match="A4b"):
        TScheduler(TStore(), extenders=[object()], device="cpu")
    with pytest.raises(ValueError, match="kernel-modeled plugins"):
        TScheduler(TStore(), profiles=[TProfile(backend="tpu",
                                                disabled_plugins=("NodePorts",))],
                   device="cpu")


def test_default_profile_binds_through_the_store():
    """With a store the default profile ends in DefaultBinder at the
    reference's position (the reference's order less its volume and DRA
    plugins, DefaultPreemption last), and the loop's wave bind is the
    store's batched binding."""
    from kubernetes_tpu.scheduler.plugins.registry import default_plugins as jdefault
    from kubernetes_tpu_torch.scheduler.plugins.basics import DefaultBinder
    from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault

    absent = {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
              "DynamicResources"}
    store = TStore()
    ref = [p.name for p in jdefault(JStore(), JNames())]
    got = tdefault(TNames(), store=store)
    assert [p.name for p in got] == [n for n in ref if n not in absent]
    s = TScheduler(store, profiles=[TProfile(backend="tpu", wave_size=8)], device="cpu")
    fw = s.frameworks["default-scheduler"]
    assert [type(p) for p in fw.bind_plugins] == [DefaultBinder]
    assert s.loop._default_bind_only(fw)
    store.create(tw.make_node("n0", cpu="4", mem="8Gi"))
    store.create(tw.make_pod("p0", cpu="1"))
    s.start()
    s.schedule_pending()
    assert store.get("Pod", "default/p0").spec.node_name == "n0"
    assert s.cache.is_assumed_pod(store.get("Pod", "default/p0")) is False


def test_port_scheduler_runs_without_jax():
    """With jax and the reference package made unimportable, the port's
    Scheduler schedules a store workload through its wave loop (depth 2),
    a gang through the pod-group cycle and an async-dispatcher run."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "from kubernetes_tpu_torch.scheduler.scheduler import Profile, Scheduler\n"
        "from kubernetes_tpu_torch.store import Store\n"
        "import kubernetes_tpu_torch.testing.wrappers as w\n"
        "import kubernetes_tpu_torch.api.types as T, kubernetes_tpu_torch.api.meta as M\n"
        "from kubernetes_tpu_torch.testing.mixed import burst_pods\n"
        "for kw in ({}, {'async_api_calls': True}):\n"
        "    st = Store()\n"
        "    [st.create(w.make_node(f'n{i}', cpu='4', mem='8Gi', zone=f'z{i % 2}')) for i in range(6)]\n"
        "    s = Scheduler(st, profiles=[Profile(backend='tpu', wave_size=8)], device='cpu', **kw)\n"
        "    s.start()\n"
        "    [st.create(p) for p in burst_pods(w, 0, 20)]\n"
        "    st.create(T.PodGroup(meta=M.ObjectMeta(name='g'),\n"
        "                         spec=T.PodGroupSpec(policy=T.GangPolicy(min_count=2))))\n"
        "    [st.create(w.with_gang(w.make_pod(f'g{i}', cpu='100m'), 'g')) for i in range(2)]\n"
        "    s.schedule_pending()\n"
        "    bound = [p for p in st.pods() if p.spec.node_name]\n"
        "    assert len(bound) == 22, len(bound)\n"
        "    assert s.algorithms['default-scheduler'].backend.gang_pod_totals == {'device': 2}\n"
        "    if s.api_dispatcher is not None:\n"
        "        s.api_dispatcher.close()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kubernetes_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('bound', len(bound))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "bound 22" in r.stdout
