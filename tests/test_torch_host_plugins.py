"""The host tier's plugins and host algorithm: the port's copies
(kubernetes_tpu_torch/scheduler/plugins, framework/runtime.py,
schedule_one.py) against the reference package's, on numpy-seeded mixed
clusters built in each package's types (kubernetes_tpu_torch/testing/
mixed.py).

Compared exactly, per plugin and pod: PreFilter's result and status,
every node's Filter status (also after the AddPod/RemovePod extensions),
PreScore's status, every node's Score and the normalized scores, the
signature fragment and the registered events; per host algorithm run:
hosts, evaluated and feasible counts, the rotation index, the seeded rng
state and the FitError diagnosis, at percentageOfNodesToScore 100 and at
the adaptive percentage; and the port's default profile against the
reference's full profile (volume, DRA, binder and preemption plugins
included) on pods without volumes or claims, with the port's store-backed
plugins and without them.
"""

import random
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.scheduler.plugins as jplugins
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.scheduler.plugins as tplugins
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework import events as jevents
from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCycleState
from kubernetes_tpu.scheduler.framework.interface import FitError as JFitError
from kubernetes_tpu.scheduler.framework.runtime import Framework as JFramework
from kubernetes_tpu.scheduler.plugins.node_declared_features import (
    NodeDeclaredFeatures as JNDF,
)
from kubernetes_tpu.scheduler.plugins.registry import DEFAULT_WEIGHTS as JWEIGHTS
from kubernetes_tpu.scheduler.plugins.registry import default_plugins as jdefault_plugins
from kubernetes_tpu.scheduler.queue.scheduling_queue import SchedulingQueue
from kubernetes_tpu.scheduler.schedule_one import SchedulingAlgorithm as JAlgorithm
from kubernetes_tpu.scheduler.schedule_one import (
    num_feasible_nodes_to_find as jnum_feasible,
)
from kubernetes_tpu.store import Store
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import CycleState as TCycleState
from kubernetes_tpu_torch.scheduler.framework import FitError as TFitError
from kubernetes_tpu_torch.scheduler.framework import Framework as TFramework
from kubernetes_tpu_torch.scheduler.framework import events as tevents
from kubernetes_tpu_torch.scheduler.plugins.node_declared_features import (
    NodeDeclaredFeatures as TNDF,
)
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_WEIGHTS as TWEIGHTS
from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault_plugins
from kubernetes_tpu_torch.scheduler.queue import Nominator
from kubernetes_tpu_torch.scheduler.schedule_one import SchedulingAlgorithm as TAlgorithm
from kubernetes_tpu_torch.scheduler.schedule_one import num_feasible_nodes_to_find
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec

FEATURE = "NUMAAlignment"
NDF_ANNOTATION = "features.k8s.io/required"


def _features(spec, i: int):
    """Seeded declared and required features: every third node declares
    FEATURE, every fifth pod requires it (every fifteenth requires one no
    node declares)."""
    node_features = [(FEATURE,) if j % 3 == 1 else () for j in range(len(spec["nodes"]))]
    return node_features, (FEATURE if i % 5 == 2 else "Quantum" if i % 15 == 4 else "")


class _Cluster:
    """One mixed spec in one package: a cache holding the first half of the
    pods (assumed round-robin, so their labels and terms are the existing
    pods the others meet) and a snapshot; `pods` is the other half."""

    def __init__(self, spec, pkg, features=True):
        types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
        self.names = JNames() if pkg == "jax" else TNames()
        self.cache = (JCache if pkg == "jax" else TCache)(self.names)
        nodes = build_nodes(spec, types, meta)
        pods = build_pods(spec, types, meta)
        node_features, _ = _features(spec, 0)
        for node, decl in zip(nodes, node_features):
            if features:
                node.status.declared_features = decl
            self.cache.add_node(node)
        for i, pod in enumerate(pods):
            req = _features(spec, i)[1]
            if features and req:
                pod.meta.annotations[NDF_ANNOTATION] = req
        half = len(pods) // 2
        for i, pod in enumerate(pods[:half]):
            self.cache.assume_pod(pod, nodes[(3 * i) % len(nodes)].meta.name)
        self.pods = pods[half:]
        self.snapshot = (JSnapshot if pkg == "jax" else TSnapshot)()
        self.cache.update_snapshot(self.snapshot)
        self.state_cls = JCycleState if pkg == "jax" else TCycleState


def _st(st):
    return None if st is None else (st.code, tuple(st.reasons), st.plugin)


def _prefilter_result(r):
    if r is None:
        return None
    return "all" if r.node_names is None else sorted(r.node_names)


def _trace(plugin, cluster):
    """Everything the plugin answers for each of the cluster's pods."""
    nodes = cluster.snapshot.list_nodes()
    out = []
    for pod in cluster.pods:
        state = cluster.state_cls()
        rec = {}
        if callable(getattr(plugin, "sign", None)):
            rec["sign"] = plugin.sign(pod)
        if callable(getattr(plugin, "pre_enqueue", None)):
            rec["pre_enqueue"] = _st(plugin.pre_enqueue(pod))
        skip = False
        if callable(getattr(plugin, "pre_filter", None)):
            r, st = plugin.pre_filter(state, pod, nodes)
            rec["pre_filter"] = (_prefilter_result(r), _st(st))
            skip = st is not None and st.is_skip
        if callable(getattr(plugin, "filter", None)) and not skip:
            rec["filter"] = [_st(plugin.filter(state, pod, ni)) for ni in nodes]
            if callable(getattr(plugin, "remove_pod", None)):
                # the PreFilter extensions: drop an existing pod from its
                # node's counts, filter every node, add it back, again
                host = next((ni for ni in nodes if ni.pods_with_required_anti_affinity),
                            next((ni for ni in nodes if ni.pods), None))
                if host is not None:
                    pi = next(iter(host.iter_pods()))
                    rec["remove_pod"] = _st(plugin.remove_pod(state, pod, pi, host))
                    rec["filter_removed"] = [_st(plugin.filter(state, pod, ni))
                                             for ni in nodes]
                    rec["add_pod"] = _st(plugin.add_pod(state, pod, pi, host))
                    rec["filter_added"] = [_st(plugin.filter(state, pod, ni))
                                           for ni in nodes]
        if callable(getattr(plugin, "score", None)):
            pre = None
            if callable(getattr(plugin, "pre_score", None)):
                pre = plugin.pre_score(state, pod, nodes)
                rec["pre_score"] = _st(pre)
            if pre is None or not pre.is_skip:
                raw = []
                for ni in nodes:
                    score, st = plugin.score(state, pod, ni)
                    raw.append([ni.name, score])
                    assert st is None or st.is_success
                rec["score"] = [tuple(r) for r in raw]
                if callable(getattr(plugin, "normalize_score", None)):
                    rec["normalize"] = _st(plugin.normalize_score(state, pod, raw))
                    rec["normalized"] = [tuple(r) for r in raw]
        out.append(rec)
    return out


PLUGINS = {
    # name: (class name, constructor args)
    "SchedulingGates": ("SchedulingGates", {}),
    "NodeUnschedulable": ("NodeUnschedulable", {}),
    "NodeName": ("NodeName", {}),
    "TaintToleration": ("TaintToleration", {}),
    "NodePorts": ("NodePorts", {}),
    "ImageLocality": ("ImageLocality", {}),
    "NodeAffinity": ("NodeAffinity", {}),
    "NodeDeclaredFeatures": ("NodeDeclaredFeatures", {}),
    "Fit-LeastAllocated": ("NodeResourcesFit", lambda n: {"names": n}),
    "Fit-MostAllocated": ("NodeResourcesFit",
                          lambda n: {"names": n, "scoring_strategy": "MostAllocated",
                                     "resource_weights": {"cpu": 2, "memory": 1,
                                                          "example.com/dev": 3}}),
    "Fit-RequestedToCapacityRatio": (
        "NodeResourcesFit",
        lambda n: {"names": n, "scoring_strategy": "RequestedToCapacityRatio",
                   "shape": [(0, 100), (40, 60), (40, 30), (100, 0)]}),
    "BalancedAllocation": ("BalancedAllocation", lambda n: {"names": n}),
    "BalancedAllocation-3": ("BalancedAllocation",
                             lambda n: {"names": n,
                                        "resources": ["cpu", "memory", "example.com/dev"]}),
    "PodTopologySpread": ("PodTopologySpread", {}),
    "PodTopologySpread-nodefault": ("PodTopologySpread", {"system_defaulting": False}),
    "InterPodAffinity": ("InterPodAffinity", {}),
    "InterPodAffinity-ignore": ("InterPodAffinity",
                                {"ignore_preferred_terms_of_existing_pods": True}),
}

SPECS = {"a": (41, 24, 60), "b": (45, 40, 80)}


def _module(pkg, cls_name):
    if cls_name == "NodeDeclaredFeatures":
        return JNDF if pkg == "jax" else TNDF
    return getattr(jplugins if pkg == "jax" else tplugins, cls_name)


@pytest.mark.parametrize("spec_id", sorted(SPECS))
@pytest.mark.parametrize("plugin", sorted(PLUGINS))
def test_plugin_matches_reference(plugin, spec_id):
    seed, n_nodes, n_pods = SPECS[spec_id]
    spec = mixed_spec(seed, n_nodes, n_pods, constraints=True)
    cls_name, args = PLUGINS[plugin]
    traces = []
    for pkg in ("jax", "port"):
        cluster = _Cluster(spec, pkg)
        a = args(cluster.names) if callable(args) else dict(args)
        traces.append(_trace(_module(pkg, cls_name)(**a), cluster))
    assert traces[1] == traces[0]
    # the trace reached the plugin's filter and score on some pod
    assert any("filter" in r or "score" in r or "pre_enqueue" in r for r in traces[1])


def test_queue_sort_gates_and_events_match_reference():
    """PrioritySort's order, SchedulingGates' PreEnqueue on a gated pod and
    every plugin's registered events."""
    def qpi(pod, ts):
        return SimpleNamespace(pod=pod, timestamp=ts)

    pods = {}
    for pkg, types, meta in (("jax", jtypes, jmeta), ("port", ttypes, tmeta)):
        ps = build_pods(mixed_spec(43, 8, 12), types, meta)
        for i, p in enumerate(ps):
            p.spec.priority = (i * 7) % 3
        ps[0].spec.scheduling_gates = ("example.com/wait",)
        pods[pkg] = ps
    jsort, tsort = jplugins.PrioritySort(), tplugins.PrioritySort()
    for i in range(12):
        for j in range(12):
            assert tsort.less(qpi(pods["port"][i], i), qpi(pods["port"][j], 12 - j)) == \
                jsort.less(qpi(pods["jax"][i], i), qpi(pods["jax"][j], 12 - j))
    jg, tg = jplugins.SchedulingGates(), tplugins.SchedulingGates()
    assert _st(tg.pre_enqueue(pods["port"][0])) == _st(jg.pre_enqueue(pods["jax"][0]))
    assert not tg.pre_enqueue(pods["port"][0]).is_success

    def events(plugins):
        out = {}
        for p in plugins:
            fn = getattr(p, "events_to_register", None)
            if callable(fn):
                out[p.name] = [(e.event.resource, e.event.action_type, e.event.label)
                               for e in fn()]
        return out

    assert events(tdefault_plugins(TNames())) == {
        k: v for k, v in events(jdefault_plugins(Store(), JNames())).items()
        if k in {p.name for p in tdefault_plugins(TNames())}}
    assert tevents.ALL == jevents.ALL


def test_gang_scheduling_plugin_matches_reference():
    """GangScheduling's PreEnqueue (no PodGroup, below quorum, at quorum)
    and Permit (Wait below quorum, then Allow, releasing the waiting
    sibling) against the reference with each package's handle."""
    from kubernetes_tpu.scheduler.scheduler import Handle as JHandle
    from kubernetes_tpu_torch.scheduler.framework import Handle as THandle
    from kubernetes_tpu_torch.testing.mixed import build_gangs, perf_gang_spec

    out = []
    for pkg, types, meta in (("jax", jtypes, jmeta), ("port", ttypes, tmeta)):
        names = JNames() if pkg == "jax" else TNames()
        cache = (JCache if pkg == "jax" else TCache)(names)
        group, members = build_gangs(perf_gang_spec(8, 2, 1, 3, "Required"), types, meta)[0]
        snap = (JSnapshot if pkg == "jax" else TSnapshot)()
        plugin = (jplugins if pkg == "jax" else tplugins).GangScheduling()
        if pkg == "jax":
            store = Store()
            handle = JHandle(store, cache, None, snap)
            add = store.create
        else:
            handle = THandle(cache=cache, snapshot=snap)
            add = handle.store.add
        fw = (JFramework if pkg == "jax" else TFramework)([plugin])
        handle.framework = fw
        plugin.set_handle(handle)
        rec = [_st(plugin.pre_enqueue(members[0]))]
        add(group)
        cache.pod_group_states.set_group(group)
        rec.append(_st(plugin.pre_enqueue(members[0])))
        for p in members:
            cache.pod_group_states.pod_added(group.meta.key, p.meta.key)
        rec.append(_st(plugin.pre_enqueue(members[0])))
        cache.update_snapshot(snap)
        state = (JCycleState if pkg == "jax" else TCycleState)()
        state.is_pod_group_scheduling_cycle = True
        gsnap = snap.pod_group_states[group.meta.key]
        for i, p in enumerate(members):
            gsnap.unscheduled.discard(p.meta.key)
            gsnap.assumed.add(p.meta.key)
            st = fw.run_permit_plugins(state, p, f"node-{i}")
            waiting = sorted(w.pod.meta.name for w in fw.iterate_waiting_pods())
            decisions = [_st(w.decision) for w in fw.iterate_waiting_pods()]
            rec.append((_st(st), waiting, decisions))
        out.append(rec)
    assert out[1] == out[0]
    assert out[1][-1][2] == [(0, (), ""), (0, (), "")]  # both waiters allowed


# --- the host algorithm -------------------------------------------------------


def _nominate(nominator, pods, nodes, pkg):
    """Nominations in either package's nominator: two pods of priority 50
    onto two nodes."""
    from kubernetes_tpu.scheduler.nodeinfo import PodInfo as JPodInfo
    from kubernetes_tpu_torch.scheduler.nodeinfo import PodInfo as TPodInfo

    info = JPodInfo if pkg == "jax" else TPodInfo
    names = JNames() if pkg == "jax" else TNames()
    for pod, node in zip(pods, nodes):
        pod.spec.priority = 50
        nominator.add_nominated_pod(pod, node, info(pod, names))


def _host_side(spec, pkg, percentage, features=True, store=False):
    """The cluster and a host algorithm over the default profile; the
    port's with the store-backed plugins when `store` is set."""
    c = _Cluster(spec, pkg, features=features)
    if pkg == "jax":
        fw = JFramework(jdefault_plugins(Store(), c.names), dict(JWEIGHTS))
        nominator = SchedulingQueue(lambda a, b: a.timestamp < b.timestamp)
        algo = JAlgorithm(fw, percentage, rng=random.Random(5), nominator=nominator)
    else:
        fw = TFramework(tdefault_plugins(c.names, store=TStore() if store else None),
                        dict(TWEIGHTS))
        nominator = Nominator()
        algo = TAlgorithm(fw, percentage, rng=random.Random(5), nominator=nominator)
    types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
    extra = build_pods(mixed_spec(spec["seed"] + 1, 4, 2), types, meta)
    for p in extra:
        p.meta.name = "nominee-" + p.meta.name
    _nominate(nominator, extra, [spec["nodes"][1]["name"], spec["nodes"][2]["name"]], pkg)
    return c, algo


def _drive_host(side, n_pods=None):
    """schedule_pod for every pod, assuming each placement; the log holds
    every result or FitError diagnosis and the rotation index after it."""
    c, algo = side
    log = []
    names = [ni.name for ni in c.snapshot.list_nodes()]
    for i, pod in enumerate(c.pods[:n_pods]):
        if i % 4 == 3:
            # a preemptor revisiting its nomination: the nominee fast path
            pod.status.nominated_node_name = names[(7 * i) % len(names)]
        try:
            r = algo.schedule_pod(c.state_cls(), pod, c.snapshot)
        except (JFitError, TFitError) as e:
            d = e.diagnosis
            log.append(("fit", e.error_message(), e.num_all_nodes,
                        sorted(d.unschedulable_plugins), d.pre_filter_msg,
                        [_st(d.node_to_status.get(n)) for n in names],
                        algo.next_start_node_index))
            continue
        log.append((r.suggested_host, r.evaluated_nodes, r.feasible_nodes,
                    algo.next_start_node_index))
        c.cache.assume_pod(pod, r.suggested_host)
        c.cache.update_snapshot(c.snapshot)
    return log, algo.rng.getstate()


HOST_CASES = {
    # name: (seed, nodes, pods, percentageOfNodesToScore)
    "small-100": (51, 30, 60, 100),
    "small-adaptive": (52, 30, 60, 0),
    "adaptive-250": (53, 250, 40, 0),
    "percent-30-250": (54, 250, 40, 30),
    "full-160": (55, 160, 40, 100),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_algorithm_matches_reference(case):
    """The port's host SchedulingAlgorithm against the reference's, with
    nominations of priority 50 and a nominee fast path on every fourth
    pod: hosts, counts, rotation, rng and FitError diagnoses."""
    seed, n_nodes, n_pods, pct = HOST_CASES[case]
    spec = dict(mixed_spec(seed, n_nodes, n_pods, constraints=True), seed=seed)
    want = _drive_host(_host_side(spec, "jax", pct))
    got = _drive_host(_host_side(spec, "port", pct))
    assert got == want
    log = got[0]
    assert any(r[0] == "fit" for r in log) and any(r[0] != "fit" for r in log)
    if pct < 100 and n_nodes >= 100:
        # the adaptive sample stopped early on some pod
        assert any(r[0] != "fit" and r[2] < n_nodes // 2 for r in log)


def test_num_feasible_nodes_to_find_matches_reference():
    for pct in (0, 1, 5, 30, 50, 99, 100):
        for n in (0, 1, 99, 100, 101, 125, 250, 1000, 5000, 6249, 6250, 20000):
            assert num_feasible_nodes_to_find(pct, n) == jnum_feasible(pct, n)


@pytest.mark.parametrize("pct", [100, 0])
def test_default_profile_matches_reference_full_profile(pct):
    """The port's default profile decides pods without volumes or claims as
    the reference's full default profile does, with a store (the volume
    plugins, DynamicResources and DefaultBinder in it; its plugin list
    against the reference's: test_torch_storage_loop.py) and without one
    (those six left out, the order otherwise the reference's,
    DefaultPreemption last)."""
    spec = dict(mixed_spec(57, 120, 60, constraints=True), seed=57)
    want = _drive_host(_host_side(spec, "jax", pct, features=False))
    got = _drive_host(_host_side(spec, "port", pct, features=False))
    assert got == want
    full = _drive_host(_host_side(spec, "port", pct, features=False, store=True))
    assert full == want
    absent = {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
              "DynamicResources", "DefaultBinder"}
    ref = [p.name for p in jdefault_plugins(Store(), JNames())]
    assert set(ref) >= absent
    assert [p.name for p in tdefault_plugins(TNames())] == [n for n in ref if n not in absent]
    assert ref[-1] == "DefaultPreemption"
    assert TWEIGHTS == JWEIGHTS
    for gates in ({"NodeDeclaredFeatures": False}, {"GangScheduling": False},
                  {"TopologyAwareWorkloadScheduling": False}, {"DefaultPreemption": False}):
        ref = [p.name for p in jdefault_plugins(Store(), JNames(), gates)]
        assert [p.name for p in tdefault_plugins(TNames(), gates)] == [
            n for n in ref if n not in absent]
