"""The port's DisruptionController against the reference's.

Both packages' controllers (kubernetes_tpu.controllers.DisruptionController
and kubernetes_tpu_torch.controllers.DisruptionController) run over stores
built from the same objects, and every PodDisruptionBudget's status is held
equal after each sync_once (tolerance 0: integers and pod names):

- tests/test_preemption_pdb.py's TestDisruptionController (minAvailable,
  maxUnavailable, unbound pods not healthy), each through both packages;
- seeded clusters (random.Random) of labelled pods, bound and unbound,
  under budgets with minAvailable, maxUnavailable or neither, then a round
  of relabels (a pod that stops matching must re-reconcile the budget it
  left), deletes, binds and disruption records, one inside the 2-minute
  window and one past it, synced again.
"""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.labels as jlabels
import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.labels as tlabels
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.controllers import DisruptionController as JController
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.controllers import DisruptionController as TController
from kubernetes_tpu_torch.store import Store as TStore

SIDES = {
    "jax": SimpleNamespace(w=jw, types=jtypes, meta=jmeta, labels=jlabels, Store=JStore,
                           Controller=JController),
    "port": SimpleNamespace(w=tw, types=ttypes, meta=tmeta, labels=tlabels, Store=TStore,
                            Controller=TController),
}


def pdb(side, name, match, min_available=None, max_unavailable=None):
    t = side.types
    return t.PodDisruptionBudget(
        meta=side.meta.ObjectMeta(name=name),
        spec=t.PodDisruptionBudgetSpec(
            selector=side.labels.LabelSelector(match_labels=tuple(sorted(match.items()))),
            min_available=min_available, max_unavailable=max_unavailable))


def statuses(store):
    """Every budget's status, by key."""
    return {p.meta.key: (p.status.disruptions_allowed, p.status.current_healthy,
                         p.status.desired_healthy, p.status.expected_pods,
                         sorted(p.status.disrupted_pods))
            for p in store.list("PodDisruptionBudget")[0]}


def _min_available(side, store):
    store.create(side.w.make_node("n0", cpu="8", mem="16Gi"))
    store.create(pdb(side, "budget", {"app": "web"}, min_available=2))
    for i in range(3):
        p = side.w.make_pod(f"web-{i}", cpu="1", mem="1Gi", labels={"app": "web"})
        p.spec.node_name = "n0"
        store.create(p)


def _max_unavailable(side, store):
    store.create(side.w.make_node("n0", cpu="8", mem="16Gi"))
    store.create(pdb(side, "budget", {"app": "db"}, max_unavailable=1))
    for i in range(4):
        p = side.w.make_pod(f"db-{i}", cpu="1", mem="1Gi", labels={"app": "db"})
        p.spec.node_name = "n0"
        store.create(p)


def _unbound_not_healthy(side, store):
    store.create(pdb(side, "budget", {"app": "web"}, min_available=1))
    store.create(side.w.make_pod("web-0", labels={"app": "web"}))


REFERENCE_CASES = {
    # name: (build, the reference test's expected (allowed, healthy, desired))
    "min_available_budget": (_min_available, (1, 3, 2)),
    "max_unavailable_budget": (_max_unavailable, (1, 4, 3)),
    "unbound_pods_not_healthy": (_unbound_not_healthy, (0, 0, 1)),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_controller_cases(case):
    """test_preemption_pdb.py::TestDisruptionController through both
    packages: the same status, and the reference test's numbers."""
    build, want = REFERENCE_CASES[case]
    out = {}
    for name, side in SIDES.items():
        store = side.Store()
        ctrl = side.Controller(store)
        build(side, store)
        assert ctrl.sync_once() > 0
        out[name] = statuses(store)
    assert out["port"] == out["jax"]
    allowed, healthy, desired, _expected, _disrupted = out["port"]["default/budget"]
    assert (allowed, healthy, desired) == want


APPS = ("web", "db", "batch", "cache")


def _seeded_spec(seed: int) -> dict:
    rng = random.Random(seed)
    nodes = [f"n{i}" for i in range(rng.randint(2, 5))]
    pods = []
    for i in range(rng.randint(10, 30)):
        pods.append({"name": f"p{i:02d}", "app": rng.choice(APPS),
                     "ns": rng.choice(("default", "default", "other")),
                     "node": rng.choice(nodes + [""])})
    budgets = []
    for j, app in enumerate(rng.sample(APPS, 3)):
        kind = rng.choice(("min", "max", "none"))
        budgets.append({"name": f"b{j}", "app": app, "ns": rng.choice(("default", "other")),
                        "min": rng.randint(0, 4) if kind == "min" else None,
                        "max": rng.randint(0, 3) if kind == "max" else None})
    # the second round: relabels, deletes, binds and disruption records
    relabel = rng.sample(range(len(pods)), 3)
    delete = rng.sample([i for i in range(len(pods)) if i not in relabel], 2)
    bind = [i for i in range(len(pods)) if not pods[i]["node"]
            and i not in relabel and i not in delete][:2]
    return {"nodes": nodes, "pods": pods, "budgets": budgets, "relabel": relabel,
            "delete": delete, "bind": bind, "new_apps": [rng.choice(APPS) for _ in relabel]}


def _seeded_run(side, spec):
    store = side.Store()
    ctrl = side.Controller(store)
    for n in spec["nodes"]:
        store.create(side.w.make_node(n, cpu="16", mem="32Gi"))
    for b in spec["budgets"]:
        obj = pdb(side, b["name"], {"app": b["app"]}, b["min"], b["max"])
        obj.meta.namespace = b["ns"]
        store.create(obj)
    for p in spec["pods"]:
        pod = side.w.make_pod(p["name"], namespace=p["ns"], cpu="1", mem="1Gi",
                              labels={"app": p["app"]})
        pod.spec.node_name = p["node"]
        store.create(pod)
    ctrl.sync_once()
    first = statuses(store)
    pods = spec["pods"]
    for i, app in zip(spec["relabel"], spec["new_apps"]):
        cur = store.get("Pod", f"{pods[i]['ns']}/{pods[i]['name']}")
        cur.meta.labels = {"app": app}
        store.update(cur)
    for i in spec["delete"]:
        store.delete("Pod", f"{pods[i]['ns']}/{pods[i]['name']}")
    for i in spec["bind"]:
        cur = store.get("Pod", f"{pods[i]['ns']}/{pods[i]['name']}")
        cur.spec.node_name = spec["nodes"][0]
        store.update(cur)
    # a disruption recorded 10 s ago still counts; one from 200 s ago does
    # not (DISRUPTED_POD_TIMEOUT_S); names of pods the budget does not
    # select are dropped
    now = time.time()
    for b in store.list("PodDisruptionBudget")[0]:
        matching = sorted(p.meta.name for p in store.pods()
                          if p.meta.namespace == b.meta.namespace
                          and p.meta.labels.get("app") == b.spec.selector.match_labels[0][1])
        if matching:
            b.status.disrupted_pods = {matching[0]: now - 10.0, matching[-1]: now - 200.0,
                                       "gone": now}
            store.update(b, check_version=False)
    ctrl.sync_once()
    return first, statuses(store)


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_seeded_budgets_match_reference(seed):
    spec = _seeded_spec(seed)
    want = _seeded_run(SIDES["jax"], spec)
    got = _seeded_run(SIDES["port"], spec)
    assert got == want
    # the run reached budgets with room and budgets without
    allowed = [s[0] for st in got for s in st.values()]
    assert len(allowed) == 2 * len(spec["budgets"])


def test_relabel_out_of_a_budget_rereconciles_it():
    """A bound pod relabelled away from a budget's selector lowers that
    budget's healthy count in both packages (the handler enqueues the
    budgets of the old and the new shape)."""
    out = {}
    for name, side in SIDES.items():
        store = side.Store()
        ctrl = side.Controller(store)
        store.create(side.w.make_node("n0", cpu="8", mem="16Gi"))
        store.create(pdb(side, "budget", {"app": "web"}, min_available=1))
        for i in range(3):
            p = side.w.make_pod(f"web-{i}", cpu="1", labels={"app": "web"})
            p.spec.node_name = "n0"
            store.create(p)
        ctrl.sync_once()
        before = statuses(store)
        cur = store.get("Pod", "default/web-0")
        cur.meta.labels = {"app": "db"}
        store.update(cur)
        ctrl.sync_once()
        out[name] = (before, statuses(store))
    assert out["port"] == out["jax"]
    assert out["port"][0]["default/budget"][:2] == (2, 3)
    assert out["port"][1]["default/budget"][:2] == (1, 2)
