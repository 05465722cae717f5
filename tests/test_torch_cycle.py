"""The single-pod scheduling cycle: the port's TorchBackend.run and
TorchSchedulingAlgorithm.schedule_pod (plain versions, on the CPU) against
the reference package's TPUBackend.run and TPUSchedulingAlgorithm.
schedule_pod over the same clusters, built from one numpy-seeded spec in
each package's types.

Compared exactly: the five arrays run returns; ScheduleResults and the
final seeded rng state; for pods that fit nowhere the FitError message,
failing plugins, the preemption name sets and every node's status (code,
reasons, plugin). The spread domain counts stay off the points where the
JAX kernel's log weight differs from the host plugin's, which the port
follows (tests/test_torch_fit.py shows the difference). Also the cycle's
scope errors and device rules.
"""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCycleState
from kubernetes_tpu.scheduler.framework.interface import FitError as JFitError
from kubernetes_tpu.scheduler.framework.runtime import Framework
from kubernetes_tpu.scheduler.plugins.registry import DEFAULT_WEIGHTS, default_plugins
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, TPUSchedulingAlgorithm
from kubernetes_tpu.store import Store
from kubernetes_tpu_torch.api.labels import LabelSelector
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops.planes import FallbackNeeded
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import CycleState, FitError
from kubernetes_tpu_torch.scheduler.framework import Framework as TFramework
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_WEIGHTS as TDEFAULT_WEIGHTS
from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault_plugins
from kubernetes_tpu_torch.scheduler.tpu.backend import (
    RUN_OUTPUTS,
    TorchBackend,
    TorchSchedulingAlgorithm,
)
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec


def _mixed(spec):
    """One numpy-seeded mixed spec as (reference side, port side) builders
    of (nodes, assumed (pod, node) pairs, pods to schedule)."""
    return (lambda: (build_nodes(spec, jtypes, jmeta), [], build_pods(spec, jtypes, jmeta)),
            lambda: (build_nodes(spec, ttypes, tmeta), [], build_pods(spec, ttypes, tmeta)))


def _topology_spreading(n_nodes, n_init, n_measured):
    """TopologySpreading at a small size: nodes over 4 zones, default pods,
    then app: spread pods with one DoNotSchedule zone constraint — the
    port's scheduler_perf builders and the same objects in the reference's
    types."""
    from kubernetes_tpu.api.labels import LabelSelector as JSel
    from kubernetes_tpu.testing import wrappers as jw

    def reference():
        nodes = [jw.make_node(f"node-{i}", zone=f"zone-{i % 4}") for i in range(n_nodes)]
        pods = [jw.make_pod(f"pod-{i}", cpu="100m", mem="50Mi", labels={"app": "perf"},
                            image="registry.k8s.io/pause:3.10") for i in range(n_init)]
        pods += [jw.with_spread(
            jw.make_pod(f"spread-{i}", cpu="100m", mem="50Mi", labels={"app": "spread"}),
            max_skew=1, key="topology.kubernetes.io/zone", when="DoNotSchedule",
            selector=JSel.of({"app": "spread"})) for i in range(n_measured)]
        return nodes, [], pods

    def port():
        nodes = [tw.make_node(f"node-{i}", zone=f"zone-{i % 4}") for i in range(n_nodes)]
        pods = [tw.scheduling_basic_pod(i) for i in range(n_init)]
        pods += [tw.topology_spreading_pod(i) for i in range(n_measured)]
        return nodes, [], pods

    return reference, port


class _Pair:
    """One cluster in both packages, from (reference, port) builders: the
    reference TPUSchedulingAlgorithm (built as tests/test_tpu_golden.py's
    build_pair builds it) and the port's TorchSchedulingAlgorithm on the
    CPU, both seeded rng 0."""

    def __init__(self, sides, plugin_args=None):
        self.jcache = JCache(JNames())
        self.tcache = TCache(TNames())
        (jnodes, jassumed, self.jpods), (tnodes, tassumed, self.tpods) = (
            build() for build in sides)
        for cache, nodes, assumed in ((self.jcache, jnodes, jassumed),
                                      (self.tcache, tnodes, tassumed)):
            for n in nodes:
                cache.add_node(n)
            for pod, node in assumed:
                cache.assume_pod(pod, node)
        self.jsnap, self.tsnap = JSnapshot(), TSnapshot()
        self.jcache.update_snapshot(self.jsnap)
        self.tcache.update_snapshot(self.tsnap)
        fw = Framework(default_plugins(Store(), self.jcache.names, {}, plugin_args or {}),
                       dict(DEFAULT_WEIGHTS))
        self.jalgo = TPUSchedulingAlgorithm(
            fw, TPUBackend(self.jcache.names, plugin_args=plugin_args),
            rng=random.Random(0))
        tfw = TFramework(tdefault_plugins(self.tcache.names, args=plugin_args or {}),
                         dict(TDEFAULT_WEIGHTS))
        self.talgo = TorchSchedulingAlgorithm(
            tfw, TorchBackend(self.tcache.names, plugin_args=plugin_args, device="cpu"),
            rng=random.Random(0))

    def assume(self, i, node):
        self.jcache.assume_pod(self.jpods[i], node)
        self.tcache.assume_pod(self.tpods[i], node)
        self.jcache.update_snapshot(self.jsnap)
        self.tcache.update_snapshot(self.tsnap)


def _assert_same_diagnosis(jerr, terr, node_names):
    assert terr.error_message() == jerr.error_message()
    assert terr.num_all_nodes == jerr.num_all_nodes
    jd, td = jerr.diagnosis, terr.diagnosis
    assert td.unschedulable_plugins == jd.unschedulable_plugins
    jn, tn = jd.node_to_status, td.node_to_status
    assert tn.failing_plugins() == jn.failing_plugins()
    assert tn.unschedulable_name_set() == jn.unschedulable_name_set()
    assert tn.fit_verdict_names() == jn.fit_verdict_names()
    for name in node_names:
        js, ts = jn.get(name), tn.get(name)
        assert (ts.code, ts.reasons, ts.plugin) == (js.code, js.reasons, js.plugin), name


def _drive(pair, limit=None):
    """schedule_pod for every pod on both sides, assuming each placement
    into both caches; returns (placed, fit errors)."""
    placed = errors = 0
    node_names = [ni.name for ni in pair.tsnap.list_nodes()]
    for i in range(len(pair.jpods) if limit is None else limit):
        try:
            want = pair.jalgo.schedule_pod(JCycleState(), pair.jpods[i], pair.jsnap)
        except JFitError as jerr:
            with pytest.raises(FitError) as terr:
                pair.talgo.schedule_pod(CycleState(), pair.tpods[i], pair.tsnap)
            _assert_same_diagnosis(jerr, terr.value, node_names)
            errors += 1
            continue
        got = pair.talgo.schedule_pod(CycleState(), pair.tpods[i], pair.tsnap)
        assert (got.suggested_host, got.evaluated_nodes, got.feasible_nodes) == (
            want.suggested_host, want.evaluated_nodes, want.feasible_nodes), i
        pair.assume(i, got.suggested_host)
        placed += 1
    assert pair.talgo.rng.getstate() == pair.jalgo.rng.getstate()
    assert pair.jalgo.fallback_count == 0  # the reference stayed on its kernel
    assert pair.talgo.kernel_count == pair.jalgo.kernel_count
    return placed, errors


ALGO_CASES = {
    # name: ((reference, port) cluster builders, plugin args)
    "topology-spreading": (_topology_spreading(24, 16, 30), None),
    "mixed-ipa-1": (_mixed(mixed_spec(21, 24, 32, constraints=True)), None),
    "mixed-ipa-2": (_mixed(mixed_spec(22, 32, 32, constraints=True)), None),
    "mixed-ipa-most": (_mixed(mixed_spec(23, 20, 32, constraints=True)),
                       {"NodeResourcesFit": {"strategy": "MostAllocated"}}),
}


@pytest.mark.parametrize("case", list(ALGO_CASES))
def test_schedule_pod_matches_reference(case):
    sides, pa = ALGO_CASES[case]
    placed, errors = _drive(_Pair(sides, pa))
    assert placed > 0
    if case.startswith("mixed"):
        assert errors > 0  # the mix has pods that fit nowhere


def test_topology_spreading_spreads_zones():
    """The measured pods of the small TopologySpreading run end with zone
    skew <= 1 (their hard constraint), all placed."""
    pair = _Pair(_topology_spreading(24, 16, 30))
    placed, errors = _drive(pair)
    assert (placed, errors) == (46, 0)
    per_zone = {}
    for pod in pair.tpods:
        if pod.meta.labels["app"] == "spread":
            node = pair.tcache._pod_nodes[pod.meta.key]
            z = int(node.split("-")[1]) % 4
            per_zone[z] = per_zone.get(z, 0) + 1
    assert len(per_zone) == 4 and max(per_zone.values()) - min(per_zone.values()) <= 1


def test_run_matches_reference_backend():
    """TorchBackend.run == TPUBackend.run on the five arrays, pod after pod
    with assumes between them (the first feasible max-total node)."""
    pair = _Pair(_mixed(mixed_spec(31, 24, 36, constraints=True)))
    jb, tb = pair.jalgo.backend, pair.talgo.backend
    for i in range(len(pair.jpods)):
        jplanes, want = jb.run(pair.jpods[i], pair.jsnap)
        tplanes, got = tb.run(pair.tpods[i], pair.tsnap)
        assert tplanes.node_names == jplanes.node_names
        for k in RUN_OUTPUTS:
            assert np.array_equal(got[k], np.asarray(want[k])), (i, k)
        feas = np.flatnonzero(got["feasible"][: tplanes.n])
        if feas.size:
            best = feas[np.argmax(got["total"][feas])]
            pair.assume(i, tplanes.node_names[int(best)])
    # later pods repaired the device mirror by row scatter
    assert tb.upload_stats["scatter"] > 0


def test_term_key_moves_without_a_reshape():
    """A term interned mid-run changes ipa_term_key's content but not its
    bucket: the mirror re-uploads the table (a stale copy maps the new term
    to key slot -1 and rejects every node) while the rows travel by
    scatter, and the outputs stay equal to the reference's."""
    from kubernetes_tpu.api.labels import LabelSelector as JSel

    def pods(types, sel):
        out = []
        for i, (app, key) in enumerate((("a", "kubernetes.io/hostname"),
                                        ("b", "topology.kubernetes.io/zone"),
                                        ("c", "kubernetes.io/hostname"),
                                        ("d", "topology.kubernetes.io/zone"))):
            term = types.PodAffinityTerm(label_selector=sel.of({"app": app}),
                                         topology_key=key)
            p = types.Pod(spec=types.PodSpec(containers=[types.Container(
                requests={"cpu": "100m"})]))
            p.meta.name, p.meta.namespace, p.meta.labels = f"t{i}", "default", {"app": app}
            p.spec.affinity = types.Affinity(
                pod_anti_affinity=types.PodAntiAffinity(required=(term,)))
            out.append(p)
        return out

    pair = _Pair(_mixed(mixed_spec(5, 12, 0)))
    pair.jpods, pair.tpods = pods(jtypes, JSel), pods(ttypes, LabelSelector)
    tb = pair.talgo.backend
    keys = []
    for i in range(4):
        jplanes, want = pair.jalgo.backend.run(pair.jpods[i], pair.jsnap)
        tplanes, got = tb.run(pair.tpods[i], pair.tsnap)
        for k in RUN_OUTPUTS:
            assert np.array_equal(got[k], np.asarray(want[k])), (i, k)
        assert torch.equal(tb._device_term_key, torch.from_numpy(tplanes.ipa_term_key))
        keys.append((tplanes.bucket_sizes[-1], tplanes.ipa_term_key.tolist()))
        node = tplanes.node_names[int(np.flatnonzero(got["feasible"])[0])]
        pair.assume(i, node)
    # the fourth term landed in the bucket the third one opened
    assert keys[2][0] == keys[3][0] and keys[2][1] != keys[3][1]
    assert tb.upload_stats["scatter"] > 0


def _diagnosis_cluster(w, types, sel):
    """Nodes and pods (in one package's wrappers/types) whose pods each fit
    nowhere, with first failures of every kind spread over the nodes:
    zone z0 holds a pod with zone anti-affinity against app: web and two
    app: s pods; zone z1 is tainted; one small node has no zone; one node
    is unschedulable."""
    taint = (types.Taint("dedicated", "infra", "NoSchedule"),)
    nodes = [w.make_node(f"n{i}", cpu="8", mem="16Gi", zone="z0") for i in range(3)]
    nodes += [w.make_node(f"n{i}", cpu="8", mem="16Gi", zone="z1", taints=taint)
              for i in range(3, 6)]
    nodes += [w.make_node("n6", cpu="1", mem="2Gi"),
              w.make_node("n7", cpu="8", mem="16Gi", zone="z1", unschedulable=True)]

    def term(labels, key):
        return types.PodAffinityTerm(label_selector=sel.of(labels), topology_key=key)

    def pod(name, cpu="100m", labels=None, **aff):
        p = w.make_pod(name, cpu=cpu, labels=dict(labels or {"app": "x"}))
        if aff:
            p.spec.affinity = types.Affinity(**aff)
        return p

    zone, host = "topology.kubernetes.io/zone", "kubernetes.io/hostname"
    blocker = pod("blocker", labels={"app": "web"}, pod_anti_affinity=types.PodAntiAffinity(
        required=(term({"app": "web"}, zone),)))
    assumed = [(blocker, "n0"), (pod("s0", labels={"app": "s"}), "n1"),
               (pod("s1", labels={"app": "s"}), "n2")]

    def spread(p, key):
        p.spec.topology_spread_constraints = (types.TopologySpreadConstraint(
            1, key, "DoNotSchedule", sel.of({"app": "s"})),)
        return p

    pods = [
        pod("huge", cpu="64"),                                  # resources
        pod("web", cpu="2", labels={"app": "web"}),             # existing anti
        spread(pod("rack", labels={"app": "s"}), "rack"),       # missing key
        spread(pod("skew", labels={"app": "s"}), zone),         # skew
        pod("lonely", labels={"app": "y"}, pod_affinity=types.PodAffinity(
            required=(term({"app": "ghost"}, host),))),          # affinity
        pod("anti", cpu="2", labels={"app": "z"}, pod_anti_affinity=types.PodAntiAffinity(
            required=(term({"app": "web"}, zone),))),           # incoming anti
    ]
    return nodes, assumed, pods


def test_diagnosis_matches_reference():
    """Pods that fit nowhere, for each kind of first failure (resources,
    taints, unschedulable, a missing spread key, spread skew, each IPA
    check): the FitError message, failing plugins, the preemption name
    sets and every node's status agree with the reference's."""
    from kubernetes_tpu.api.labels import LabelSelector as JSel
    from kubernetes_tpu.testing import wrappers as jw

    pair = _Pair((lambda: _diagnosis_cluster(jw, jtypes, JSel),
                  lambda: _diagnosis_cluster(tw, ttypes, LabelSelector)))
    placed, errors = _drive(pair)
    assert (placed, errors) == (0, 6)
    names = [ni.name for ni in pair.tsnap.list_nodes()]
    plugins = set()
    for pod in pair.tpods:
        with pytest.raises(FitError) as err:
            pair.talgo.schedule_pod(CycleState(), pod, pair.tsnap)
        plugins |= {err.value.diagnosis.node_to_status.get(n).plugin for n in names}
    assert plugins == {"NodeResourcesFit", "TaintToleration", "NodeUnschedulable",
                       "PodTopologySpread", "InterPodAffinity"}


def test_scope_errors():
    """The reference's host-path cases take its routes: a nominated pod
    lands on its nominee through the host fast path, a pod needing host
    compose runs K4 and the host NodeDeclaredFeatures tail (here: no node
    declares the feature, so a FitError), a pod the extractor refuses goes
    to the host algorithm (FallbackNeeded is not re-raised); no nodes raise
    FitError."""
    names = TNames()
    cache = TCache(names)
    for i in range(8):
        cache.add_node(tw.scheduling_basic_node(i))
    snap = TSnapshot()
    cache.update_snapshot(snap)
    algo = TorchSchedulingAlgorithm(
        TFramework(tdefault_plugins(names), dict(TDEFAULT_WEIGHTS)),
        TorchBackend(names, device="cpu"))
    nominated = tw.scheduling_basic_pod(0)
    nominated.status.nominated_node_name = "node-1"
    got = algo.schedule_pod(CycleState(), nominated, snap)
    assert (got.suggested_host, got.evaluated_nodes) == ("node-1", 1)
    assert (algo.kernel_count, algo.fallback_count) == (0, 1)
    compose = tw.scheduling_basic_pod(1)
    compose.meta.annotations["features.k8s.io/required"] = "FeatureX"
    with pytest.raises(FitError) as err:
        algo.schedule_pod(CycleState(), compose, snap)
    assert err.value.diagnosis.unschedulable_plugins == {"NodeDeclaredFeatures"}
    assert (algo.kernel_count, algo.fallback_count) == (1, 1)
    port = tw.make_pod("p", cpu="100m")
    port.spec.containers[0] = ttypes.Container(
        name="c", requests={"cpu": "100m"},
        ports=(ttypes.ContainerPort(80, host_port=80, host_ip="10.0.0.1"),))
    with pytest.raises(FallbackNeeded, match="hostIP"):
        algo.backend.run(port, snap)
    got = algo.schedule_pod(CycleState(), port, snap)
    assert got.suggested_host and got.feasible_nodes == 8
    assert (algo.kernel_count, algo.fallback_count) == (1, 2)
    with pytest.raises(FitError):
        algo.schedule_pod(CycleState(), tw.scheduling_basic_pod(3), TSnapshot())
    # the wave scan now computes hard spread too: the same spread pods
    # through both packages' run_batched land on the same nodes
    reference, port = _topology_spreading(8, 0, 6)
    waves = []
    for build, names, cache_cls, snap_cls, make in (
            (reference, JNames, JCache, JSnapshot, TPUBackend),
            (port, TNames, TCache, TSnapshot, lambda n: TorchBackend(n, device="cpu"))):
        nodes, _, pods = build()
        c = cache_cls(names())
        for n in nodes:
            c.add_node(n)
        s = snap_cls()
        c.update_snapshot(s)
        rng = random.Random(4)
        waves.append((make(c.names).run_batched(pods, s, rng=rng, pad_to=8)[0],
                      rng.getstate()))
    assert waves[1] == waves[0] and all(waves[1][0])
    got = algo.schedule_pod(CycleState(), tw.topology_spreading_pod(1), snap)
    assert got.feasible_nodes == 8 and algo.kernel_count == 2


def test_algorithm_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSchedulingAlgorithm(TFramework([]), TorchBackend(TNames()))
