"""The storage, DRA and extender half of the host tier in the port's
scheduling loop, against the reference's.

Both packages run on the same inputs — the reference with
Profile(backend="tpu") (its TPU backend on the CPU), the port with
device="cpu" — and the results are held equal, tolerance 0:

- tests/test_hybrid.py's storage cases through both Schedulers
  (TestHybridVolumes, TestWaveSkipsHybridPods, the claim pods of
  TestHybridScoreIsolation and TestHybridPreemptionState): every pod's
  node, nomination and eviction, every claim's and volume's binding, the
  kernel/fallback counts and the rng state, with each reference test's own
  assertions on the port's run;
- the short workloads of volumes.json and dra.json (all but
  SchedulingSecrets, which tests/test_torch_perf_workloads.py holds)
  through the reference's WorkloadExecutor(backend="tpu") and the port's
  StorageWorkloadExecutor(device="cpu"), in waves of 32 and one pod at a
  time: the same, plus `scheduled`;
- the port's default profile, given a store, against the reference's:
  plugin for plugin (names and order), weights and feature gates.

Both packages' clocks are one virtual clock (tests/test_torch_volumes.py).
"""

from __future__ import annotations

from pathlib import Path

import pytest

from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.perf.harness import WorkloadExecutor as JExecutor
from kubernetes_tpu.perf.harness import load_config as jload
from kubernetes_tpu.scheduler.plugins.registry import DEFAULT_WEIGHTS as JWEIGHTS
from kubernetes_tpu.scheduler.plugins.registry import default_plugins as jdefault_plugins
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.perf.harness import load_config as tload
from kubernetes_tpu_torch.scheduler.framework.runtime import Framework as TFramework
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_WEIGHTS as TWEIGHTS
from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault_plugins
from kubernetes_tpu_torch.scheduler.tpu.backend import KERNEL_SCORE_PLUGINS
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.testing.storage_workloads import StorageWorkloadExecutor
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)
from tests.test_torch_volumes import clock, outcome, run_both, scheduler  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def node_of(store, pod_name):
    return store.get("Pod", f"default/{pod_name}").spec.node_name


# --------------------------------------------------------------------------
# tests/test_hybrid.py's storage cases
# --------------------------------------------------------------------------


class TestHybridVolumes:
    def test_claim_pod_uses_kernel_not_fallback(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            for i in range(6):
                store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 3}"))
            store.create(w.make_storage_class("local", wait_for_first_consumer=True))
            store.create(w.make_pv("pv-n4", storage="10Gi", storage_class="local",
                                   node_names=("n4",)))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="local"))
            store.create(w.with_pvc(w.make_pod("claimed", cpu="1"), "data"))
            for i in range(4):
                store.create(w.make_pod(f"plain-{i}", cpu="1", mem="1Gi"))
            s = scheduler(side, store, seed=7)
            s.schedule_pending()
            return store, s

        out, store, _ = run_both(scenario)
        assert node_of(store, "claimed") == "n4"
        assert out["counts"] == (5, 0)

    def test_zone_conflict_composes_with_kernel_filters(self):
        """VolumeZone (host) prunes what the kernel allowed, NodeResourcesFit
        (kernel) what VolumeZone allowed."""
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n0", cpu="1", mem="1Gi", zone="z1"))
            store.create(w.make_node("n1", cpu="8", mem="16Gi", zone="z2"))
            store.create(w.make_node("n2", cpu="8", mem="16Gi", zone="z1"))
            store.create(w.make_storage_class("std"))
            store.create(w.make_pv("pv-z1", storage="10Gi", storage_class="std", zone="z1"))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="std",
                                    volume_name="pv-z1"))
            store.create(w.with_pvc(w.make_pod("p", cpu="4", mem="8Gi"), "data"))
            s = scheduler(side, store, seed=7)
            s.schedule_pending()
            return store, s

        out, store, _ = run_both(scenario)
        assert node_of(store, "p") == "n2"
        assert out["counts"] == (1, 0)


class TestWaveSkipsHybridPods:
    def test_mixed_wave_keeps_order_and_schedules_all(self):
        def scenario(side, clock):
            w, store = side.w, side.Store()
            for i in range(8):
                store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 2}"))
            store.create(w.make_storage_class("std"))
            store.create(w.make_pv("pv0", storage="10Gi", storage_class="std"))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="std",
                                    volume_name="pv0"))
            for i in range(5):
                store.create(w.make_pod(f"a{i}", cpu="1"))
            store.create(w.with_pvc(w.make_pod("mid-claim", cpu="1"), "data"))
            for i in range(5):
                store.create(w.make_pod(f"b{i}", cpu="1"))
            s = scheduler(side, store, wave_size=4, seed=7)
            s.schedule_pending()
            return store, s

        out, store, s = run_both(scenario)
        assert all(v[0] for v in out["pods"].values()), out["pods"]
        assert out["counts"][1] == 0
        assert s.loop.phase_profile["waves"] > 0


class TestHybridScoreIsolation:
    def test_host_score_pass_excludes_kernel_plugins(self, monkeypatch):
        """The dense plugins' scores are in the kernel's total; the hybrid
        route's host score pass must not run them again."""
        captured = []
        orig = TFramework.run_score_plugins

        def spy(self, state, pod, nodes):
            scores, st = orig(self, state, pod, nodes)
            captured.append(scores)
            return scores, st

        monkeypatch.setattr(TFramework, "run_score_plugins", spy)

        def scenario(side, clock):
            w, store = side.w, side.Store()
            for i in range(4):
                store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi"))
            store.create(w.make_pod("filler", cpu="6", mem="12Gi", node_name="n0"))
            store.create(w.make_storage_class("std"))
            store.create(w.make_pv("pv0", storage="10Gi", storage_class="std"))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="std",
                                    volume_name="pv0"))
            store.create(w.with_pvc(w.make_pod("claimed", cpu="1"), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "claimed")
        assert captured, "the hybrid route ran no host score pass"
        for scores in captured:
            for nps in scores:
                for plugin, _ in nps.scores:
                    assert plugin not in KERNEL_SCORE_PLUGINS


class TestHybridPreemptionState:
    def test_unsatisfiable_hybrid_pod_does_not_evict(self):
        """A claim pod too big for every node gains nothing from eviction:
        no victim is deleted and nothing is nominated."""
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n0", cpu="4", mem="8Gi"))
            store.create(w.make_pod("victim", cpu="1", mem="1Gi", node_name="n0", priority=0))
            store.create(w.make_storage_class("std"))
            store.create(w.make_pv("pv0", storage="10Gi", storage_class="std"))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="std",
                                    volume_name="pv0"))
            store.create(w.with_pvc(w.make_pod("giant", cpu="32", mem="64Gi",
                                               priority=1000), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert store.try_get("Pod", "default/victim") is not None
        giant = store.get("Pod", "default/giant")
        assert not giant.spec.node_name and not giant.status.nominated_node_name

    def test_satisfiable_claim_pod_preempts(self):
        """A claim pod that fits once a victim goes: the full host chain's
        dry run (the claim refusal in _pod_resource_only) evicts and
        nominates as the reference does."""
        def scenario(side, clock):
            w, store = side.w, side.Store()
            store.create(w.make_node("n0", cpu="4", mem="8Gi"))
            store.create(w.make_pod("victim", cpu="3", mem="1Gi", node_name="n0", priority=0))
            store.create(w.make_storage_class("std"))
            store.create(w.make_pv("pv0", storage="10Gi", storage_class="std"))
            store.create(w.make_pvc("data", storage="5Gi", storage_class="std",
                                    volume_name="pv0"))
            store.create(w.with_pvc(w.make_pod("urgent", cpu="2", priority=1000), "data"))
            s = scheduler(side, store)
            s.schedule_pending()
            clock.advance(1.1)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "urgent") == "n0"
        victim = store.try_get("Pod", "default/victim")
        assert victim is None or victim.meta.deletion_timestamp is not None


# --------------------------------------------------------------------------
# volumes.json and dra.json's short workloads
# --------------------------------------------------------------------------


def _short(config: str) -> list[tuple[str, str, str]]:
    return [(config, case["name"], wl["name"])
            for case in tload(REPO / "kubernetes_tpu_torch/perf/configs" / f"{config}.json")
            for wl in case["workloads"]
            if "short" in wl.get("labels", []) and case["name"] != "SchedulingSecrets"]


SHORT = _short("volumes") + _short("dra")


def _pick(cases, case_name, wl_name):
    case = next(c for c in cases if c["name"] == case_name)
    return case, next(w for w in case["workloads"] if w["name"] == wl_name)


@pytest.mark.parametrize("wave_size", [32, 0])
@pytest.mark.parametrize("config,case_name,wl_name", SHORT,
                         ids=[f"{c}:{n}/{w}" for c, n, w in SHORT])
def test_short_storage_workload_matches_reference(config, case_name, wl_name, wave_size):
    jex = JExecutor(*_pick(jload(REPO / "kubernetes_tpu/perf/configs" / f"{config}.yaml"),
                           case_name, wl_name), backend="tpu", wave_size=wave_size)
    jres = jex.run()
    tex = StorageWorkloadExecutor(
        *_pick(tload(REPO / "kubernetes_tpu_torch/perf/configs" / f"{config}.json"),
               case_name, wl_name), wave_size=wave_size, device="cpu")
    tres = tex.run()
    want, got = outcome(jex.store, jex.scheduler), outcome(tex.store, tex.scheduler)
    assert got == want
    assert tres.scheduled == jres.scheduled == len(got["pods"])
    # every claim bound to one volume of its class and size, no volume twice
    pvs = {v.meta.name: v for v in tex.store.list("PersistentVolume")[0]}
    for c in tex.store.list("PersistentVolumeClaim")[0]:
        pv = pvs[c.spec.volume_name]
        assert pv.spec.claim_ref == c.meta.key
        assert pv.spec.storage_class_name == c.spec.storage_class_name
        assert set(c.spec.access_modes) <= set(pv.spec.access_modes)
        assert pv.storage_capacity >= c.requested_storage
    devices = [(a[0], d) for a, _ in got["claims"].values() for d in a[1]]
    assert len({d[1][1:] for d in devices}) == len(devices)  # no device twice
    if case_name == "SchedulingWFFCVolumes" and wave_size:
        # node-neutral claims ride the waves: every pod a kernel decision
        assert tex.scheduler.loop.phase_profile["waves"] > 0
    assert got["counts"][1] == 0


# --------------------------------------------------------------------------
# the default profile
# --------------------------------------------------------------------------


@pytest.mark.parametrize("gates", [
    {}, {"NodeDeclaredFeatures": False}, {"DynamicResourceAllocation": False},
    {"GangScheduling": False}, {"TopologyAwareWorkloadScheduling": False},
    {"DefaultPreemption": False},
], ids=lambda g: ",".join(g) or "defaults")
def test_default_profile_equals_reference_with_a_store(gates):
    """Given a store, the port's default profile is the reference's plugin
    for plugin: names, order, weights, the gates' effects and the events
    each plugin registers."""
    ref = jdefault_plugins(JStore(), JNames(), gates)
    got = tdefault_plugins(TNames(), gates, store=TStore())
    assert [p.name for p in got] == [p.name for p in ref]
    assert TWEIGHTS == JWEIGHTS and TWEIGHTS["VolumeBinding"] == 1

    def events(plugins):
        return {p.name: sorted((e.event.resource, e.event.action_type, e.event.label)
                               for e in p.events_to_register())
                for p in plugins if callable(getattr(p, "events_to_register", None))}

    assert events(got) == events(ref)
    names = [p.name for p in got]
    assert names.index("NodeResourcesFit") < names.index("VolumeRestrictions") < \
        names.index("NodeVolumeLimits") < names.index("VolumeBinding") < \
        names.index("VolumeZone") < names.index("PodTopologySpread")
    assert ("DynamicResources" in names) == gates.get("DynamicResourceAllocation", True)
