"""The port's DefaultPreemption against the reference's.

Everything here runs through both packages — the reference's
(kubernetes_tpu, Profile(backend="tpu"): its TPU backend on the CPU) and
the port's (kubernetes_tpu_torch, device="cpu": the kernels' plain
versions) — on the same inputs, and holds the results equal (tolerance 0:
pod names, node names and integers):

- the plugin's units on seeded clusters (random.Random) of mixed
  priorities, PodDisruptionBudgets with and without budget, pods with
  required anti-affinity and nodes full by pod count: _split_pdb_violation,
  _select_victims_on_node (resource-only and full-chain preemptors),
  _batch_select_victims against _select_victims_on_node, _candidate_rank,
  _num_candidates, and K4's bulk name sets (unschedulable_name_set,
  fit_verdict_names) on the kernel and the hybrid route;
- runs of preemptors through both Schedulers: surviving pods, nominations,
  bindings, budgets, the final rng state and the candidate offset;
- the reference's preemption tests: tests/test_preemption_pdb.py's PDB and
  async cases (the async one by its survivors, nodes taken and evictions:
  which preemptor takes which node follows the dispatcher threads' timing
  in the reference too), tests/test_scheduler_e2e.py::TestPreemption,
  tests/test_review_regressions.py::test_nominated_pod_resources_protected,
  tests/test_tpu_batched.py::TestKernelFailurePathState, and
  tests/test_hybrid.py::TestHybridPreemptionState with a NodeDeclaredFeatures
  pod in place of the PVC pod (the port has no storage API until A4b).

tests/test_torch_preemption_loop.py (test_nominated_fallback.py, the golden
fuzz seeds) and tests/test_torch_preemption_perf.py (scheduler_perf's
Preemption cases at an evicting density) hold the longer runs.

Both packages' clocks are one virtual clock, every reading 1 µs past the
last (as in tests/test_torch_perf_workloads.py): no backoff expires within
a run unless a test advances the clock, where the reference tests sleep
on the wall clock.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.labels as jlabels
import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.scheduler.plugins.default_preemption as jdp
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu_torch.api.labels as tlabels
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.scheduler.plugins.default_preemption as tdp
import kubernetes_tpu_torch.testing.wrappers as tw
import kubernetes_tpu_torch.utils.clock as tclock
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCycleState
from kubernetes_tpu.scheduler.framework.interface import FitError as JFitError
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.scheduler.framework import CycleState as TCycleState
from kubernetes_tpu_torch.scheduler.framework import FitError as TFitError
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, types=jtypes, meta=jmeta, labels=jlabels,
                           Store=JStore, Scheduler=JScheduler, Profile=JProfile,
                           CycleState=JCycleState, FitError=JFitError, dp=jdp, kw={}),
    "port": SimpleNamespace(name="port", w=tw, types=ttypes, meta=tmeta, labels=tlabels,
                            Store=TStore, Scheduler=TScheduler, Profile=TProfile,
                            CycleState=TCycleState, FitError=TFitError, dp=tdp,
                            kw={"device": "cpu"}),
}
NDF = "features.k8s.io/required"


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


def plugin(sched):
    """The profile's DefaultPreemption (the reference's DynamicResources
    also has a PostFilter; it passes claim-less pods on)."""
    fw = sched.frameworks["default-scheduler"]
    assert fw.post_filter_plugins[-1].name == "DefaultPreemption"
    return fw.post_filter_plugins[-1]


def settle(store, sched, clock, names, rounds=30, step=0.2):
    """schedule_pending until every named pod is bound, advancing the
    virtual clock between rounds (the reference tests' wall-clock wait)."""
    for _ in range(rounds):
        sched.schedule_pending()
        pods = [store.try_get("Pod", f"default/{n}") for n in names]
        if all(p is not None and p.spec.node_name for p in pods):
            return True
        clock.advance(step)
    return False


def outcome(store, sched):
    """Every pod's (node, nominated node, priority), the queue's
    nominations, the budgets, the counters, the rng and the offset."""
    algo = sched.algorithms["default-scheduler"]
    pods = {p.meta.name: (p.spec.node_name, p.status.nominated_node_name, p.spec.priority)
            for p in store.pods()}
    nodes = [n.meta.name for n in store.nodes()]
    noms = {n: sorted(sched.queue.nominated_pods_for_node(n)) for n in nodes}
    pdbs = {b.meta.key: (b.status.disruptions_allowed, sorted(b.status.disrupted_pods))
            for b in store.list("PodDisruptionBudget")[0]}
    return {"pods": pods, "nominations": {k: v for k, v in noms.items() if v},
            "pdbs": pdbs, "counts": (algo.kernel_count, algo.fallback_count),
            "rng": algo.rng.getstate(), "offset": plugin(sched)._offset}


def pdb(side, name, match, min_available=None, allowed=0, disrupted=()):
    t = side.types
    obj = t.PodDisruptionBudget(
        meta=side.meta.ObjectMeta(name=name),
        spec=t.PodDisruptionBudgetSpec(
            selector=side.labels.LabelSelector(match_labels=tuple(sorted(match.items()))),
            min_available=min_available))
    obj.status.disruptions_allowed = allowed
    obj.status.disrupted_pods = {n: 1.0 for n in disrupted}
    return obj


# --------------------------------------------------------------------------
# the plugin's units on seeded clusters
# --------------------------------------------------------------------------

APPS = ("web", "db", "batch", "cache")


def cluster_spec(seed: int, n_nodes: int = 14) -> dict:
    rng = random.Random(seed)
    nodes = [{"name": f"n{i:02d}", "cpu": rng.choice(("8", "8", "12")),
              "pods": rng.choice((110, 110, 4)), "zone": f"z{i % 3}",
              "featured": i % 4 == 0} for i in range(n_nodes)]
    pods, ts = [], 100.0
    for nd in nodes:
        # fill each node until less than one CPU is left or its pod count is
        # reached, so no preemptor fits anywhere without evictions
        free, j = int(nd["cpu"]) * 1000, 0
        while free >= 1000 and j < nd["pods"]:
            cpu = rng.choice([c for c in (1000, 1500, 2000, 3000) if c <= free])
            free -= cpu
            ts += rng.choice((1.0, 1.0, 0.0))  # some equal start times
            pods.append({"name": f"{nd['name']}-p{j}", "node": nd["name"],
                         "cpu": f"{cpu}m", "prio": rng.choice((0, 0, 5, 10, 50, 200)),
                         "app": rng.choice(APPS), "ts": ts,
                         # required anti-affinity against the preemptors
                         "anti": rng.random() < 0.15})
            j += 1
    return {"nodes": nodes, "pods": pods}


def build_cluster(side, spec, pdbs=True, features=False, wave=0):
    """A Scheduler over a store holding spec's nodes, its pods bound, and
    (pdbs) three budgets: web with none left, db with one and a pod already
    disrupted, batch with three."""
    w = side.w
    store = side.Store()
    for nd in spec["nodes"]:
        node = w.make_node(nd["name"], cpu=nd["cpu"], mem="32Gi", pods=nd["pods"],
                           zone=nd["zone"])
        if features and nd["featured"]:
            node.status.declared_features = ("NUMAAlignment",)
        store.create(node)
    for p in spec["pods"]:
        pod = w.make_pod(p["name"], cpu=p["cpu"], mem="1Gi", labels={"app": p["app"]})
        if p["anti"]:
            pod = w.with_pod_affinity(pod, "tier", "vip", "kubernetes.io/hostname", anti=True)
        pod.spec.priority = p["prio"]
        pod.spec.node_name = p["node"]
        pod.meta.creation_timestamp = p["ts"]
        store.create(pod)
    if pdbs:
        db_pod = next((p["name"] for p in spec["pods"] if p["app"] == "db"), "none")
        store.create(pdb(side, "web", {"app": "web"}, allowed=0))
        store.create(pdb(side, "db", {"app": "db"}, allowed=1, disrupted=(db_pod,)))
        store.create(pdb(side, "batch", {"app": "batch"}, allowed=3))
    sched = scheduler(side, store, wave_size=wave)
    sched.cache.update_snapshot(sched.snapshot)
    return store, sched


PREEMPTORS = {
    # kind: (cpu, host port, required anti-affinity, required feature)
    "plain": ("6", (), False, False),
    "small": ("2", (), False, False),
    "anti": ("5", (), True, False),
    "port": ("4", (8080,), False, False),
    "features": ("5", (), False, True),
}


def preemptor(side, kind, name="pre", prio=100):
    cpu, ports, anti, feature = PREEMPTORS[kind]
    pod = side.w.make_pod(name, cpu=cpu, mem="1Gi", labels={"tier": "vip"},
                          host_ports=ports)
    if anti:
        pod = side.w.with_pod_affinity(pod, "app", "cache", "kubernetes.io/hostname",
                                       anti=True)
    if feature:
        pod.meta.annotations[NDF] = "NUMAAlignment"
    pod.spec.priority = prio
    return pod


def names(pis):
    return [pi.pod.meta.name for pi in pis]


def _units(side, spec, kind):
    """Every unit of the plugin on one seeded cluster and one preemptor,
    through the scheduler's own framework, algorithm and FitError."""
    store, sched = build_cluster(side, spec, features=kind == "features")
    algo = sched.algorithms["default-scheduler"]
    pl = plugin(sched)
    pod = preemptor(side, kind)
    state = side.CycleState()
    with pytest.raises(side.FitError) as err:
        algo.schedule_pod(state, pod, sched.snapshot)
    nts = err.value.diagnosis.node_to_status
    pdbs = pl._list_pdbs()
    nodes = sched.snapshot.list_nodes()
    out = {"unsched": sorted(nts.unschedulable_name_set()),
           "fit": sorted(nts.fit_verdict_names()),
           "status": {ni.name: (nts.get(ni.name).code, nts.get(ni.name).plugin)
                      for ni in nodes},
           "resource_only": [pl._resource_only(pod, ni) for ni in nodes],
           "split": {}, "victims": {}, "no_pdb": {}, "ranks": {}}
    for ni in nodes:
        lower = sorted((pi for pi in ni.iter_pods() if pi.pod.spec.priority < 100),
                       key=lambda pi: (-pi.pod.spec.priority, pi.pod.meta.creation_timestamp))
        viol, ok = pl._split_pdb_violation(lower, pdbs)
        out["split"][ni.name] = (names(viol), names(ok))
        plug = nts.get(ni.name).plugin
        for key, budgets in (("victims", pdbs), ("no_pdb", [])):
            found = pl._select_victims_on_node(state, pod, ni, budgets, status_plugin=plug)
            out[key][ni.name] = None if found is None else (names(found[0]), found[1])
            if found is not None and key == "victims":
                out["ranks"][ni.name] = pl._candidate_rank(
                    side.dp._Candidate(ni.name, found[0], found[1]))
    batched = pl._batch_select_victims(state, pod, nodes, nts)
    out["batched"] = {n: None if r is None else (names(r[0]), r[1])
                      for n, r in batched.items()}
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(PREEMPTORS))
def test_plugin_units_match_reference(seed, kind):
    spec = cluster_spec(seed)
    want, got = both(_units, spec, kind)
    assert got == want
    # the batched scan decides exactly what the per-node path decides
    # without budgets, on every node it takes
    for name, res in got["batched"].items():
        assert res == got["no_pdb"][name]
    if kind in ("plain", "small"):
        assert got["batched"], "no node took the batched scan"
    else:
        assert not got["batched"]  # not resource-only: every node per node


def test_plugin_units_reach_every_branch():
    """Across the seeded cases: budgets violated and not, candidates and
    non-candidates, full-chain and resource-only nodes."""
    seen = set()
    for seed in (1, 2, 3):
        spec = cluster_spec(seed)
        for kind in ("plain", "anti"):
            got = _units(SIDES["port"], spec, kind)
            for name, res in got["victims"].items():
                seen.add("candidate" if res else "none")
                if res and res[1]:
                    seen.add("violation")
                if got["split"][name][0]:
                    seen.add("violating split")
            seen.update("resource-only" if r else "full chain" for r in got["resource_only"])
    assert seen >= {"candidate", "none", "violation", "violating split", "resource-only",
                    "full chain"}


def test_num_candidates_matches_reference():
    jp, tp = jdp.DefaultPreemption(None), tdp.DefaultPreemption(None)
    for n in (0, 1, 5, 99, 100, 101, 500, 999, 1000, 1001, 4999, 5000, 20000):
        assert tp._num_candidates(n) == jp._num_candidates(n)
    assert (jdp.MIN_CANDIDATE_NODES_PERCENTAGE, jdp.MIN_CANDIDATE_NODES_ABSOLUTE) == (
        tdp.MIN_CANDIDATE_NODES_PERCENTAGE, tdp.MIN_CANDIDATE_NODES_ABSOLUTE)


def _preemptor_run(side, clock, spec, pdbs, wave, kinds):
    """A burst of preemptors through the Scheduler on a seeded cluster."""
    store, sched = build_cluster(side, spec, pdbs=pdbs, wave=wave)
    run = []
    for i, kind in enumerate(kinds):
        store.create(preemptor(side, kind, name=f"pre-{i}", prio=100 + 10 * (i % 3)))
    sched.schedule_pending()
    run.append(outcome(store, sched))
    settle(store, sched, clock, [f"pre-{i}" for i in range(len(kinds))], rounds=8)
    run.append(outcome(store, sched))
    return run


@pytest.mark.parametrize("seed,n_nodes,pdbs,wave", [
    (4, 12, True, 0), (5, 12, False, 8), (6, 130, False, 8), (7, 130, True, 0)])
def test_preemptor_runs_match_reference(clock, seed, n_nodes, pdbs, wave):
    """Surviving pods, nominations, bindings, budgets, counters, rng and the
    rotating candidate offset, after the first pass and after the retries.
    Past 100 nodes the candidate scan stops at its quota and the offset
    moves (with budgets every node takes the per-node path, without them
    the batched scan decides)."""
    spec = cluster_spec(seed, n_nodes=n_nodes)
    kinds = ["plain", "small", "anti", "plain", "port", "small"]
    want = _preemptor_run(SIDES["jax"], clock, spec, pdbs, wave, kinds)
    got = _preemptor_run(SIDES["port"], clock, spec, pdbs, wave, kinds)
    assert got == want
    first, last = got
    pres = {k: v for k, v in last["pods"].items() if k.startswith("pre-")}
    assert all(node and nominated for node, nominated, _ in pres.values())
    assert (first["offset"] != 0) == (n_nodes > 100)
    evicted = {p["name"] for p in spec["pods"]} - set(last["pods"])
    assert evicted


# --------------------------------------------------------------------------
# tests/test_preemption_pdb.py
# --------------------------------------------------------------------------


def _two_nodes(side, n_nodes=2, cpu="4", **kw):
    store = side.Store()
    for i in range(n_nodes):
        store.create(side.w.make_node(f"n{i}", cpu=cpu, mem="8Gi"))
    return store, scheduler(side, store, **kw)


def _victim(side, name, cpu="3", prio=0, labels=None):
    p = side.w.make_pod(name, cpu=cpu, mem="1Gi", labels=labels or {})
    p.spec.priority = prio
    return p


def _pre(side, name, prio, cpu="3"):
    p = side.w.make_pod(name, cpu=cpu, mem="1Gi")
    p.spec.priority = prio
    return p


def _protected_victims_reprieved(side, clock):
    store, sched = _two_nodes(side)
    store.create(_victim(side, "prot", labels={"app": "critical"}))
    store.create(_victim(side, "free", labels={"app": "bulk"}))
    sched.schedule_pending()
    assert all(p.spec.node_name for p in store.pods())
    store.create(pdb(side, "crit-budget", {"app": "critical"}, min_available=1, allowed=0))
    store.create(_pre(side, "pre", 100))
    sched.schedule_pending()
    names_ = {p.meta.name for p in store.pods()}
    assert "prot" in names_ and "free" not in names_
    first = outcome(store, sched)
    assert settle(store, sched, clock, ["pre"])
    return first, outcome(store, sched)


def _budget_violating_still_possible(side, clock):
    store, sched = _two_nodes(side, n_nodes=1)
    store.create(_victim(side, "only", labels={"app": "critical"}))
    sched.schedule_pending()
    store.create(pdb(side, "crit-budget", {"app": "critical"}, min_available=1, allowed=0))
    store.create(_pre(side, "pre", 100))
    sched.schedule_pending()
    assert store.try_get("Pod", "default/only") is None
    first = outcome(store, sched)
    assert settle(store, sched, clock, ["pre"])
    return first, outcome(store, sched)


def _pdb_disrupted_pods_recorded(side, clock):
    store, sched = _two_nodes(side, n_nodes=1)
    store.create(_victim(side, "v0", labels={"app": "web"}))
    sched.schedule_pending()
    store.create(pdb(side, "web-budget", {"app": "web"}, min_available=0, allowed=1))
    store.create(_pre(side, "pre", 10))
    sched.schedule_pending()
    cur = store.get("PodDisruptionBudget", "default/web-budget")
    assert "v0" in cur.status.disrupted_pods
    assert cur.status.disruptions_allowed == 0
    return (outcome(store, sched),)


def _evictions_ride_the_dispatcher(side, clock):
    store, sched = _two_nodes(side, async_api_calls=True)
    evictions = []
    orig = sched.api_dispatcher.add

    def add(call):
        if call.call_type == "pod_delete":
            evictions.append(call.object_key)
        return orig(call)

    sched.api_dispatcher.add = add
    for i in range(2):
        store.create(_victim(side, f"v{i}"))
    sched.schedule_pending()
    for i in range(2):
        store.create(_pre(side, f"pre-{i}", 100))
    sched.schedule_pending()
    ok = settle(store, sched, clock, ["pre-0", "pre-1"])
    sched.api_dispatcher.close()
    assert ok
    assert store.try_get("Pod", "default/v0") is None
    assert store.try_get("Pod", "default/v1") is None
    assert sorted(set(evictions)) == ["default/v0", "default/v1"]
    # which preemptor ends on which node, and the counters on the way,
    # follow the dispatcher threads' timing (in the reference too): the
    # survivors, the nodes taken and the evictions are compared
    return (sorted(p.meta.name for p in store.pods()),
            sorted(p.spec.node_name for p in store.pods()), sorted(set(evictions)))


def _lower_priority_nomination_cleared(side, clock):
    store, sched = _two_nodes(side, n_nodes=1)
    store.create(_victim(side, "v0", prio=0))
    sched.schedule_pending()
    store.create(_pre(side, "low", 10))
    sched.pump()
    sched.loop.schedule_one(timeout=0)
    assert "default/low" in sched.queue.nominated_pods_for_node("n0")
    first = outcome(store, sched)
    store.create(_pre(side, "high", 100))
    sched.schedule_pending()
    assert store.get("Pod", "default/high").spec.node_name == "n0"
    low = store.try_get("Pod", "default/low")
    assert low is None or not low.spec.node_name
    return first, outcome(store, sched)


def _fewer_pdb_violations_preferred(side, clock):
    store = side.Store()
    store.create(side.w.make_node("n0", cpu="4", mem="8Gi"))
    store.create(side.w.make_node("n1", cpu="4", mem="8Gi"))
    sched = scheduler(side, store)
    a = _victim(side, "prot", labels={"app": "critical"})
    a.spec.node_name = "n0"
    store.create(a)
    b = _victim(side, "free", labels={"app": "bulk"})
    b.spec.node_name = "n1"
    store.create(b)
    store.create(pdb(side, "crit", {"app": "critical"}, min_available=1, allowed=0))
    store.create(_pre(side, "pre", 50))
    sched.schedule_pending()
    assert store.try_get("Pod", "default/prot") is not None
    assert store.try_get("Pod", "default/free") is None
    return (outcome(store, sched),)


# --------------------------------------------------------------------------
# test_scheduler_e2e.py::TestPreemption, test_review_regressions.py
# --------------------------------------------------------------------------


def _high_priority_preempts(side, clock):
    store = side.Store()
    store.create(side.w.make_node("n1", cpu="2", pods=10))
    store.create(side.w.make_pod("low1", cpu="1", priority=1))
    store.create(side.w.make_pod("low2", cpu="1", priority=1))
    s = scheduler(side, store)
    s.schedule_pending()
    assert all(p.spec.node_name == "n1" for p in store.pods())
    store.create(side.w.make_pod("high", cpu="2", priority=100))
    s.schedule_pending()
    assert {p.meta.name for p in store.pods()} == {"high"}
    assert store.get("Pod", "default/high").status.nominated_node_name == "n1"
    first = outcome(store, s)
    clock.advance(1.1)
    s.schedule_pending()
    assert store.get("Pod", "default/high").spec.node_name == "n1"
    return first, outcome(store, s)


def _nominated_pod_resources_protected(side, clock):
    store = side.Store()
    store.create(side.w.make_node("n1", cpu="2", pods=10))
    store.create(side.w.make_pod("victim", cpu="2", priority=0))
    s = scheduler(side, store)
    s.schedule_pending()
    store.create(side.w.make_pod("preemptor", cpu="2", priority=100))
    s.schedule_pending()
    assert store.get("Pod", "default/preemptor").status.nominated_node_name == "n1"
    store.create(side.w.make_pod("opportunist", cpu="2", priority=1))
    s.schedule_pending()
    assert store.get("Pod", "default/opportunist").spec.node_name == ""
    first = outcome(store, s)
    clock.advance(1.1)
    s.schedule_pending()
    assert store.get("Pod", "default/preemptor").spec.node_name == "n1"
    return first, outcome(store, s)


SCENARIOS = {
    "pdb:protected_victims_reprieved": _protected_victims_reprieved,
    "pdb:budget_violating_preemption_still_possible": _budget_violating_still_possible,
    "pdb:pdb_disrupted_pods_recorded": _pdb_disrupted_pods_recorded,
    "pdb:evictions_ride_the_dispatcher": _evictions_ride_the_dispatcher,
    "pdb:lower_priority_nomination_cleared": _lower_priority_nomination_cleared,
    "pdb:candidate_ranking_prefers_fewer_pdb_violations": _fewer_pdb_violations_preferred,
    "e2e:high_priority_preempts": _high_priority_preempts,
    "regressions:nominated_pod_resources_protected": _nominated_pod_resources_protected,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reference_scenario_matches(clock, name):
    """The reference test's own assertions on both packages, and every
    outcome (pods, nominations, budgets, counters, rng, offset) equal."""
    want, got = both(SCENARIOS[name], clock)
    assert got == want


# --------------------------------------------------------------------------
# test_tpu_batched.py::TestKernelFailurePathState, test_hybrid.py
# --------------------------------------------------------------------------


def _fit_error_state(side, kind):
    """A pod no node holds, through the algorithm: the state its FitError
    leaves for preemption's dry run."""
    store = side.Store()
    for i in range(2):
        node = side.w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=f"z{i}")
        node.status.declared_features = ("NUMAAlignment",)
        store.create(node)
    sched = scheduler(side, store)
    sched.cache.update_snapshot(sched.snapshot)
    pod = side.w.with_spread(
        side.w.make_pod("big", cpu="64", labels={"app": "w"}), max_skew=1,
        key="topology.kubernetes.io/zone", when="DoNotSchedule",
        selector=side.labels.LabelSelector.of({"app": "w"}))
    if kind == "hybrid":
        pod.meta.annotations[NDF] = "NUMAAlignment"
    state = side.CycleState()
    with pytest.raises(side.FitError):
        sched.algorithms["default-scheduler"].schedule_pod(state, pod, sched.snapshot)
    host_only = {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
                 "DynamicResources"}
    return (sorted(state._storage), sorted(state.skip_filter_plugins - host_only),
            sorted(state.skip_score_plugins - host_only))


@pytest.mark.parametrize("kind", ["kernel", "hybrid"])
def test_fit_error_leaves_prefilter_state(kind):
    """The kernel and the hybrid route's FitError leave the host PreFilter
    chain's state (PodTopologySpread's key among it) and no kernel skips,
    as the reference's do."""
    want, got = both(_fit_error_state, kind)
    assert got == want
    assert "PreFilterPodTopologySpread" in got[0]
    assert "NodeResourcesFit" not in got[1]


def _unsatisfiable_hybrid_pod(side, clock):
    store = side.Store()
    node = side.w.make_node("n0", cpu="4", mem="8Gi")
    node.status.declared_features = ("NUMAAlignment",)
    store.create(node)
    victim = side.w.make_pod("victim", cpu="1", mem="1Gi")
    victim.spec.node_name = "n0"
    store.create(victim)
    giant = side.w.make_pod("giant", cpu="32", mem="64Gi")
    giant.meta.annotations[NDF] = "NUMAAlignment"
    giant.spec.priority = 1000
    store.create(giant)
    s = scheduler(side, store, seed=7)
    s.schedule_pending()
    assert store.try_get("Pod", "default/victim") is not None
    giant = store.get("Pod", "default/giant")
    assert not giant.spec.node_name and not giant.status.nominated_node_name
    return outcome(store, s)


def test_unsatisfiable_hybrid_pod_does_not_evict(clock):
    want, got = both(_unsatisfiable_hybrid_pod, clock)
    assert got == want
    assert got["counts"][0] > 0  # the hybrid route ran K4
