"""K4 fit_and_score's plain version (run on the CPU) against the reference
package's JAX fit_and_score on the same inputs, for the whole output dict:
fails, feasible, insufficient, too_many_pods, total and every per_plugin
row (infeasible and pad rows included).

Each case builds a cluster and one pod in the reference package's types
(the cases of tests/test_tpu_golden.py's TestFeasibilityAndScoreParity and
TestInterPodAffinityParity, plus hard-spread and seeded mixed cases); the
reference backend turns them into planes, tables and features, and both
sides get the same numpy arrays. Every output is an integer or a bool, so
the tolerance is zero. The cases' spread domain counts stay off the
points where the reference kernel's log weight (jnp.log) differs from the
host plugin's (np.log of a float32) by one ulp; the port follows the host
plugin, and test_spread_log_weight_follows_the_host_plugin holds it to
the host plugin on a 47-node cluster where the JAX kernel's score differs.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import tests.test_tpu_golden as golden
from kubernetes_tpu.api.labels import LabelSelector
from kubernetes_tpu.api.resource import ResourceNames
from kubernetes_tpu.api.types import ContainerImage, Taint, Toleration
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.scheduler.cache.cache import Cache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend
from kubernetes_tpu_torch.ops import cuda as tcuda
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    planes_from_reference,
    stack_features,
)
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec
from tests.wrappers import make_node, make_pod, with_spread, with_tolerations

RTC_DECREASING = {"NodeResourcesFit": {
    "strategy": "RequestedToCapacityRatio",
    "shape": [[0, 100], [50, 20], [100, 0]]}}
MOST = {"NodeResourcesFit": {"strategy": "MostAllocated"}}
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"

IPA = golden.TestInterPodAffinityParity


def _reference_inputs(nodes, existing, pod, plugin_args=None, assumed=()):
    """The reference backend's (cfg, planes, tables, features) for one pod;
    `assumed` are (pod, node name) pairs assumed into the cache."""
    names = ResourceNames()
    cache = Cache(names)
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(p)
    backend = TPUBackend(names, plugin_args=plugin_args)
    for p, node in assumed:
        backend.extractor.register(p)
        cache.assume_pod(p, node)
    snap = Snapshot()
    cache.update_snapshot(snap)
    backend.extractor.register(pod)
    planes = backend.sync(snap)
    f = backend.extractor.features(pod, planes)
    tables = backend.extractor.affinity_tables(planes)
    return backend.kernel_config(planes, f), planes, tables, f


def _port_outputs(cfg, planes, tables, f):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    packed_f, layout = features_from_reference(stack_features([f]), "cpu")
    packed = tk.fit_and_score(
        pcfg, planes_from_reference(planes.as_dict(), "cpu"),
        planes_from_reference(tables, "cpu"), packed_f, layout,
        torch.from_numpy(tk.log_weight_table(planes.nb)))
    nf = len(tk.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    return tk.unpack_fit_outputs(packed[0], planes.nb, nf, planes.r)


def _hetero(n=12, existing=20):
    nodes = golden.hetero_nodes(n)
    return nodes, golden.hetero_existing(nodes, existing)


def _taint_nodes():
    nodes = golden.hetero_nodes(12)
    nodes[0].spec.taints = (Taint("dedicated", "gpu", "NoSchedule"),)
    nodes[1].spec.taints = (Taint("maint", "", "NoExecute"),)
    nodes[2].spec.taints = (Taint("pref", "x", "PreferNoSchedule"),)
    nodes[3].spec.taints = (Taint("pref", "x", "PreferNoSchedule"),
                            Taint("pref2", "y", "PreferNoSchedule"))
    return nodes


def _unsched_nodes():
    nodes = golden.hetero_nodes(6)
    nodes[0].spec.unschedulable = True
    nodes[4].spec.unschedulable = True
    return nodes


def _selector_nodes():
    nodes = golden.hetero_nodes(12)
    for i, n in enumerate(nodes):
        n.meta.labels["disk"] = "ssd" if i % 2 == 0 else "hdd"
    return nodes


def _image_nodes():
    nodes = golden.hetero_nodes(6)
    nodes[0].status.images = [ContainerImage(("img:v1",), 700 * 1024 * 1024)]
    nodes[1].status.images = [ContainerImage(("img:v1",), 50 * 1024 * 1024)]
    return nodes


def _hard_spread(key=ZONE, skew=1, n=9, existing=6):
    nodes = [make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 3}")
             for i in range(n)]
    ex = [make_pod(f"ex{i}", cpu="100m", node_name=f"n{i % 4}",
                   labels={"group": "g"}) for i in range(existing)]
    pod = with_spread(make_pod("p", cpu="100m", labels={"group": "g"}),
                      max_skew=skew, key=key, when="DoNotSchedule",
                      selector=LabelSelector.of({"group": "g"}))
    return nodes, ex, pod


def _ipa_cluster():
    nodes, existing = _hetero()
    existing[0].spec.affinity = IPA._affinity(anti=[IPA._term({"app": "web"})])
    existing[2].spec.affinity = IPA._affinity(
        anti=[IPA._term({"app": "db"}, key=HOST)])
    existing[3].spec.affinity = IPA._affinity(
        preferred=[IPA._weighted(10, IPA._term({"app": "web"}, key=HOST))],
        anti_preferred=[IPA._weighted(3, IPA._term({"app": "db"}))])
    return nodes, existing


def _with_affinity(pod, **kw):
    pod.spec.affinity = IPA._affinity(**kw)
    return pod


def _all_rejected():
    nodes = [make_node(f"n{i}", cpu="8", mem="16Gi", zone="z0") for i in range(3)]
    blocker = make_pod("blocker", cpu="100m", node_name="n0", labels={"app": "web"})
    blocker.spec.affinity = IPA._affinity(anti=[IPA._term({"app": "web"})])
    return nodes, [blocker], make_pod("p", cpu="100m", labels={"app": "web"})


def _mixed(seed, index, n_nodes=32, n_pods=48, n_existing=24):
    """A seeded mixed cluster with hard spread and IPA, the first pods
    assumed round-robin (existing pods carrying their terms), and pod
    `index` of the rest."""
    spec = mixed_spec(seed, n_nodes, n_pods, constraints=True)
    nodes = build_nodes(spec, jtypes, jmeta)
    pods = build_pods(spec, jtypes, jmeta)
    assumed = [(p, nodes[(3 * i) % n_nodes].meta.name)
               for i, p in enumerate(pods[:n_existing])]
    return nodes, [], pods[n_existing + index], None, assumed


CASES = {
    # name: () -> (nodes, existing pods, pod, plugin args[, assumed])
    "basic-resources": lambda: (*_hetero(24, 30), make_pod(
        "p", cpu="500m", mem="4Gi", labels={"app": "web"}), None),
    "basic-resources-large": lambda: (*_hetero(24, 30), make_pod(
        "p", cpu="16", mem="32Gi", labels={"app": "web"}), None),
    "zero-request": lambda: (*_hetero(8, 10), make_pod("empty"), None),
    "most-allocated": lambda: (*_hetero(12, 20), make_pod("p", cpu="1", mem="2Gi"), MOST),
    "rtc-decreasing": lambda: (*_hetero(12, 20), make_pod("p", cpu="2", mem="1Gi"),
                               RTC_DECREASING),
    "taints-plain": lambda: (_taint_nodes(), [], make_pod("plain", cpu="1"), None),
    "taints-tolerant": lambda: (_taint_nodes(), [], with_tolerations(
        make_pod("tolerant", cpu="1"),
        Toleration(key="dedicated", operator="Equal", value="gpu", effect="NoSchedule"),
        Toleration(key="maint", operator="Exists"),
        Toleration(key="pref", operator="Exists", effect="PreferNoSchedule")), None),
    "unschedulable": lambda: (_unsched_nodes(), [], make_pod("p", cpu="1"), None),
    "unschedulable-tolerated": lambda: (_unsched_nodes(), [], with_tolerations(
        make_pod("tol", cpu="1"),
        Toleration(key="node.kubernetes.io/unschedulable", operator="Exists")), None),
    "node-name": lambda: (golden.hetero_nodes(6), [],
                          make_pod("pinned", cpu="1", node_name="n3"), None),
    "node-selector": lambda: (_selector_nodes(), [], dataclasses.replace(
        make_pod("p", cpu="1"), spec=dataclasses.replace(
            make_pod("p", cpu="1").spec, node_selector={"disk": "ssd"})), None),
    "host-ports": lambda: (golden.hetero_nodes(6), [
        make_pod("ex0", node_name="n0", host_ports=(8080,)),
        make_pod("ex1", node_name="n1", host_ports=(8080, 9090))],
        make_pod("q", host_ports=(9090,)), None),
    "default-spread": lambda: (*_hetero(12, 20),
                               make_pod("p", cpu="1", labels={"app": "web"}), None),
    "hard-spread-zone": lambda: (*_hard_spread(), None),
    "hard-spread-hostname": lambda: (*_hard_spread(key=HOST, skew=1), None),
    # no node has the key: min_count is 0 and every node misses it
    "hard-spread-absent-key": lambda: (*_hard_spread(key="rack"), None),
    "images": lambda: (_image_nodes(), [], make_pod("p", cpu="1", image="img:v1"), None),
    "infeasible": lambda: ([make_node("small", cpu="1", mem="1Gi")], [],
                           make_pod("big", cpu="8", mem="64Gi"), None),
    "existing-anti-affinity": lambda: (*_ipa_cluster(), make_pod(
        "p", cpu="100m", labels={"app": "web"}), None),
    "existing-anti-affinity-hostname": lambda: (*_ipa_cluster(), make_pod(
        "q", cpu="100m", labels={"app": "db"}), None),
    "required-affinity": lambda: (*_ipa_cluster(), _with_affinity(
        make_pod("p", cpu="100m", labels={"app": "x"}),
        required=[IPA._term({"app": "web"})]), None),
    "self-match-bootstrap": lambda: (*_ipa_cluster(), _with_affinity(
        make_pod("p", cpu="100m", labels={"tier": "new"}),
        required=[IPA._term({"tier": "new"})]), None),
    # the same term on a pod that does not match it: rejected everywhere
    "affinity-matching-nowhere": lambda: (*_ipa_cluster(), _with_affinity(
        make_pod("p", cpu="100m", labels={"tier": "old"}),
        required=[IPA._term({"tier": "new"})]), None),
    "incoming-anti-affinity": lambda: (*_ipa_cluster(), _with_affinity(
        make_pod("p", cpu="100m", labels={"app": "solo"}),
        anti=[IPA._term({"app": "web"}, key=HOST)]), None),
    "preferred-both-directions": lambda: (*_ipa_cluster(), _with_affinity(
        make_pod("p", cpu="100m", labels={"app": "web"}),
        preferred=[IPA._weighted(7, IPA._term({"app": "db"}))],
        anti_preferred=[IPA._weighted(2, IPA._term({"app": "web"}, key=HOST))]), None),
    "ignore-preferred-existing": lambda: (*_ipa_cluster(), make_pod(
        "p", cpu="100m", labels={"app": "web"}),
        {"InterPodAffinity": {"ignorePreferredTermsOfExistingPods": True}}),
    "all-nodes-rejected": lambda: (*_all_rejected(), None),
    "mixed-1": lambda: _mixed(1, 0),
    "mixed-2": lambda: _mixed(2, 3),
    "mixed-3": lambda: _mixed(3, 5),
    "mixed-4": lambda: _mixed(4, 9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_and_score_matches_reference(case):
    nodes, existing, pod, pa, *assumed = CASES[case]()
    cfg, planes, tables, f = _reference_inputs(nodes, existing, pod, pa,
                                               *(assumed or [()]))
    want = jk.fit_and_score(cfg, {**planes.as_dict(), **tables}, f)
    got = _port_outputs(cfg, planes, tables, f)
    for k in ("fails", "feasible", "insufficient", "too_many_pods", "total"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert sorted(got["per_plugin"]) == sorted(want["per_plugin"])
    for name, v in want["per_plugin"].items():
        assert np.array_equal(got["per_plugin"][name].numpy(), np.asarray(v)), name


def test_cases_reach_every_branch():
    """Together the cases exercise what K4 adds over the wave scan: hard
    spread on a zone, a hostname and an absent key, the three IPA checks
    (rows that fire), the self-match bootstrap, the IPA score in both
    directions, pods feasible nowhere, and pad rows."""
    seen = {}
    for case in CASES:
        nodes, existing, pod, pa, *assumed = CASES[case]()
        cfg, planes, tables, f = _reference_inputs(nodes, existing, pod, pa,
                                                   *(assumed or [()]))
        out = _port_outputs(cfg, planes, tables, f)
        fails = out["fails"].numpy()[:, : planes.n]
        base = len(tk.FILTER_NAMES)
        mc = cfg.max_constraints
        dk = [cfg.topo_domains[int(k)] for k, a in zip(f["hard_key"], f["hard_active"]) if a]
        flags = {
            "hard_zone": any(d > 0 for d in dk),
            "hard_singleton": any(d == 0 for d in dk),
            "pts_missing": fails[base: base + mc].any(),
            "pts_skew": fails[base + mc: base + 2 * mc].any(),
            "ipa_existing_anti": fails[-3].any(),
            "ipa_anti": fails[-2].any(),
            "ipa_aff": fails[-1].any(),
            "bootstrap": bool(f["ipa_aff_self"].any()) and not fails[-1].any()
            and cfg.n_ipa_aff > 0,
            "ipa_score": bool((out["per_plugin"]["InterPodAffinity"].numpy() != 0).any()),
            "existing_pref": cfg.ipa_existing_pref and cfg.n_ipa_pref > 0,
            "fits_nowhere": not out["feasible"].numpy().any(),
            "pad_rows": planes.nb > planes.n,
        }
        for k, v in flags.items():
            seen[k] = seen.get(k, False) or bool(v)
    assert all(seen.values()), [k for k, v in seen.items() if not v]


def test_wrapper_dispatch_and_gate():
    """CPU tensors run the plain version and count no launch; a device
    other than cpu/cuda raises; the K4 gate and the wave gate both admit
    hard spread and IPA over any number of keys and both refuse past the
    kernels' slot capacities."""
    cfg, planes, tables, f = _reference_inputs(*_hard_spread(), None)
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    assert pcfg.n_hard == 1
    ipa = dataclasses.replace(pcfg, n_hard=0, n_ipa_anti=1, ipa_existing_pref=True)
    for gate in (tk.check_fit_slice, tk.check_slice):
        gate(pcfg)
        gate(ipa)
        # a key of 2048 domains and 17 keys (past the parameter block's 16:
        # the launch tables) are computed; an empty shape is refused
        gate(dataclasses.replace(pcfg, topo_domains=(2048, 0)))
        gate(dataclasses.replace(pcfg, topo_domains=(8,) * 17))
        with pytest.raises(tk.OutOfSlice, match="rtc shape"):
            gate(dataclasses.replace(pcfg, rtc_shape=()))
        with pytest.raises(tk.OutOfSlice, match="term slots"):
            gate(dataclasses.replace(ipa, max_ipa_pref=9))
    tk.reset_launches()
    _port_outputs(cfg, planes, tables, f)
    assert tk.LAUNCHES["fit_and_score"] == 0
    packed_f, layout = features_from_reference(stack_features([f]), "meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tk.fit_and_score(pcfg, planes_from_reference(planes.as_dict(), "cpu"),
                         planes_from_reference(tables, "cpu"), packed_f, layout,
                         torch.from_numpy(tk.log_weight_table(planes.nb)))


def test_packed_outputs_round_trip():
    """The CPU side of the wrapper packs the plain version's dict into the
    kernel's byte layout; unpack_fit_outputs gives it back exactly."""
    cfg, planes, tables, f = _reference_inputs(*_ipa_cluster(), make_pod(
        "p", cpu="100m", labels={"app": "web"}))
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(planes.as_dict(), "cpu")
    dtables = planes_from_reference(tables, "cpu")
    packed_f, layout = features_from_reference(stack_features([f, f]), "cpu")
    from kubernetes_tpu_torch.ops.planes import unpack_features

    logtab = torch.from_numpy(tk.log_weight_table(planes.nb))
    ref = tk.fit_and_score_ref(pcfg, dplanes, dtables,
                               unpack_features(packed_f, layout), logtab, 1)
    packed = tk.fit_and_score(pcfg, dplanes, dtables, packed_f, layout, logtab)
    nf = len(tk.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    assert packed.shape == (2, tk.fit_output_bytes(planes.nb, nf, planes.r)[1])
    got = tk.unpack_fit_outputs(packed[1], planes.nb, nf, planes.r)
    for k in ("fails", "feasible", "insufficient", "too_many_pods", "total"):
        assert torch.equal(got[k], ref[k]), k
    for name in tk.PLUGIN_NAMES:
        assert torch.equal(got["per_plugin"][name], ref["per_plugin"][name]), name


def test_build_cache_key_covers_every_header(tmp_path):
    """A library's build key hashes its source and every shared header in
    csrc/: editing a header's bytes moves the key of every kernel (so each
    rebuilds), and the same bytes give the same key."""
    csrc = tmp_path / "csrc"
    shutil.copytree(tcuda.CSRC, csrc)
    before = {name: tcuda._lib_path(name, csrc) for name in tcuda.SOURCES}
    assert before == {name: tcuda._lib_path(name) for name in tcuda.SOURCES}
    headers = sorted(csrc.glob("*.cuh"))
    assert {h.name for h in headers} >= {"common.cuh", "scoring.cuh"}
    for h in headers:
        original = h.read_bytes()
        h.write_bytes(original + b"\n// edited\n")
        after = {name: tcuda._lib_path(name, csrc) for name in tcuda.SOURCES}
        assert all(after[n] != before[n] for n in tcuda.SOURCES), h.name
        h.write_bytes(original)
    assert {name: tcuda._lib_path(name, csrc) for name in tcuda.SOURCES} == before


def _header_structs(text):
    """{struct name: [(field, array length or 0), ...]} from C declarations
    of int / long long scalars and fixed arrays, and the #define values."""
    import re

    defines = {m[0]: int(m[1]) for m in re.findall(r"#define\s+(\w+)\s+(\d+)\b", text)}
    out = {}
    for name, body in re.findall(r"struct\s+(\w+)\s*\{(.*?)\};", text, re.S):
        fields = []
        body = re.sub(r"//[^\n]*", "", body)
        for decl in body.split(";"):
            decl = " ".join(decl.split())
            if not decl:
                continue
            decl = re.sub(r"^(long long|int)\s+", "", decl)
            for item in decl.split(","):
                m = re.fullmatch(r"\s*(\w+)\s*(?:\[(\w+)\])?\s*", item)
                size = m[2] and (defines.get(m[2]) or int(m[2]))
                fields.append((m[1], size or 0))
        out[name] = fields
    return out


def test_param_structs_match_the_headers():
    """Each ctypes params struct in ops/cuda.py has the C struct's fields in
    the same order with the same array lengths (all 4-byte ints, or 8-byte
    pointers where the header says long long), so the two layouts agree."""
    import ctypes

    structs = _header_structs((tcuda.CSRC / "common.cuh").read_text())
    for name in ("StaticParams", "ScanParams", "FitParams", "ScatterParams"):
        cls = getattr(tcuda, name)
        got = [(f, getattr(t, "_length_", 0)) for f, t in cls._fields_]
        assert got == structs[name], name
        scalars = {ctypes.c_int, ctypes.c_longlong}
        assert all((t if not hasattr(t, "_length_") else t._type_) in scalars
                   for _, t in cls._fields_), name


def _log_weight_cluster():
    """47 nodes with room for 500 pods each; 379, 389 and 374 pods of
    app=w on n0, on n1 and on each other node; the pod spreads over
    hostname with ScheduleAnyway. Every node is feasible, so the spread
    score weighs each count by log(47 + 2), one of the points where
    np.log of a float32 and the JAX kernel's jnp.log differ by one ulp."""
    nodes = [make_node(f"n{i}", cpu="1000", mem="1000Gi", pods=500)
             for i in range(47)]
    counts = [379, 389] + [374] * 45
    existing = [make_pod(f"e{i}-{j}", cpu="1m", node_name=f"n{i}", labels={"app": "w"})
                for i, c in enumerate(counts) for j in range(c)]
    pod = with_spread(make_pod("p", cpu="1m", labels={"app": "w"}), max_skew=1,
                      key=HOST, when="ScheduleAnyway")
    return nodes, existing, pod


def test_spread_log_weight_follows_the_host_plugin():
    """ROADMAP C1, shown rather than avoided: on the 47-node cluster the
    port's PodTopologySpread score on n0 is the reference host plugin's
    (np.log of a float32), 67, where the reference's JAX fit_and_score
    (jnp.log) gives 65; every node's spread score equals the host
    plugin's, run through the reference framework."""
    from kubernetes_tpu.scheduler.framework.cycle_state import CycleState
    from kubernetes_tpu.scheduler.framework.runtime import Framework
    from kubernetes_tpu.scheduler.plugins.pod_topology_spread import PodTopologySpread

    nodes, existing, pod = _log_weight_cluster()
    cfg, planes, tables, f = _reference_inputs(nodes, existing, pod)
    got = _port_outputs(cfg, planes, tables, f)
    want = jk.fit_and_score(cfg, {**planes.as_dict(), **tables}, f)
    pts = got["per_plugin"]["PodTopologySpread"].numpy()
    jax_pts = np.asarray(want["per_plugin"]["PodTopologySpread"])
    assert int(pts[0]) == 67 and int(jax_pts[0]) == 65
    assert not np.array_equal(got["total"].numpy(), np.asarray(want["total"]))

    names = ResourceNames()
    cache = Cache(names)
    for n in nodes:
        cache.add_node(n)
    for p in existing:
        cache.add_pod(p)
    snap = Snapshot()
    cache.update_snapshot(snap)
    fw = Framework([PodTopologySpread()], {"PodTopologySpread": 1})
    state = CycleState()
    infos = snap.list_nodes()
    assert fw.run_pre_score_plugins(state, pod, infos).is_success
    scores, st = fw.run_score_plugins(state, pod, infos)
    assert st.is_success
    host = {s.name: s.total_score for s in scores}
    rows = {name: i for i, name in enumerate(planes.node_names) if name}
    assert host["n0"] == 67
    assert all(host[name] == int(pts[i]) for name, i in rows.items())
