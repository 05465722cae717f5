"""Gang waves in the port: K5's plain version, the placement score, the gang
planner and TorchBackend.run_gang (on the CPU) against the reference
package's JAX gang_assign, _gang_placement_score, plan_gang and
TPUBackend.run_gang over the same clusters, built from one spec in each
package's types.

Every comparison is exact: all outputs are int32 or bool. The spread
domain counts stay off the points where the JAX kernel's log weight
differs from the host plugin's, which the port follows
(tests/test_torch_fit.py shows the difference). The JAX gang program compiles once per kernel
configuration, member count, row count, constrained-row count and fallback
flag, so the kernel cases share a few shapes.
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.ops import kernels as jk
from kubernetes_tpu.ops.planes import pad_features as jpad
from kubernetes_tpu.ops.planes import placement_masks as jmasks
from kubernetes_tpu.ops.planes import stack_features as jstack
from kubernetes_tpu.scheduler import Profile, Scheduler
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework.runtime import Framework as JFramework
from kubernetes_tpu.scheduler.plugins.topology_placement import (
    TopologyPlacementGenerator as JGenerator,
)
from kubernetes_tpu.scheduler.scheduler import Handle as JHandle
from kubernetes_tpu.scheduler.tpu import gangplanner as jplanner
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, clone_tie_words
from kubernetes_tpu.store import Store
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.ops.planes import (
    features_from_reference,
    placement_masks,
    planes_from_reference,
)
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Placement
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import CycleState, Framework, Handle
from kubernetes_tpu_torch.scheduler.plugins.topology_placement import (
    TopologyPlacementGenerator,
)
from kubernetes_tpu_torch.scheduler.tpu import gangplanner as tplanner
from kubernetes_tpu_torch.scheduler.tpu.backend import (
    TorchBackend,
    TorchSchedulingAlgorithm,
)
from kubernetes_tpu_torch.testing.mixed import (
    ZONE_KEY,
    build_gang_nodes,
    build_gangs,
    gang,
    gang_fuzz_spec,
    gang_member,
    gang_node,
    gang_wave_spec,
    mixed_gang_spec,
)

GATES = {"GenericWorkload": True, "TopologyAwareWorkloadScheduling": True}


# --------------------------------------------------------------------------
# the kernel: JAX gang_assign vs the port's K1 + gang_assign plain versions
# --------------------------------------------------------------------------


def _zone_lists(nodes):
    """Placement node lists per zone in sorted zone order, as the topology
    plugin makes them, and the parent list (every node)."""
    zones: dict[str, list[str]] = {}
    for n in nodes:
        z = n.meta.labels.get(ZONE_KEY)
        if z is not None:
            zones.setdefault(z, []).append(n.meta.name)
    return [zones[z] for z in sorted(zones)], [n.meta.name for n in nodes]


def _members(prefix, n, **kw):
    return [gang_member(f"{prefix}{i}", **kw) for i in range(n)]


def _kernel_case(name):
    """(spec, existing gangs placed first, the measured gang, placement mode,
    pad_to, tie words kind, seed)."""
    small = [gang_node(f"n{i}", f"z{i % 3}", cpu="8", mem="16Gi") for i in range(12)]
    uneven = [gang_node(f"n{i}", f"z{(i >= 3) + (i >= 7)}", cpu="4", mem="16Gi")
              for i in range(14)]  # zones of 3, 4 and 7 nodes
    four = _members("m", 4, cpu="3", mem=None)
    if name in ("required", "preferred", "unconstrained", "empty-pin"):
        return small, [], four, name, 4, "rng", 5
    if name == "no-domain-fits":
        return small, [], _members("m", 4, cpu="9", mem=None), "required", 4, "rng", 6
    if name == "pads-3-words":  # 3 members padded to 4; rows 3 -> 4
        return uneven, [], _members("m", 3, cpu="1", mem=None), "required", 4, "short", 34
    if name == "mixed-existing":  # IPA and spread terms of earlier gangs
        spec = mixed_gang_spec(11, 24, 3, 6, max_size=5)
        for g in spec["gangs"]:
            for m in g["members"]:
                m.pop("port", None)
        members = [gang_member("x0", spread=(1, "zone")), gang_member("x1", anti="hostname"),
                   gang_member("x2", aff="zone"), gang_member("x3", spread=(1, "hostname"))]
        return spec["nodes"], spec["gangs"], members, "preferred", 4, "rng", 8
    if name == "own-first-anti-ports":  # no existing terms: the gang's own
        members = [gang_member("y0", anti="hostname", port=8080),
                   gang_member("y1", anti="hostname"), gang_member("y2", port=8080),
                   gang_member("y3", spread=(1, "zone"))]
        return small[:9], [], members, "required", 4, "rng", 9
    raise KeyError(name)


KERNEL_CASES = ["required", "preferred", "unconstrained", "no-domain-fits",
                "pads-3-words", "mixed-existing", "own-first-anti-ports", "empty-pin"]


def _kernel_inputs(name):
    nodes_s, existing, members, mode, pad_to, words_kind, seed = _kernel_case(name)
    spec = {"nodes": nodes_s, "gangs": existing + [gang("measured", None, members, labelled=True)]}
    nodes = build_gang_nodes(spec, jtypes, jmeta)
    gangs = build_gangs(spec, jtypes, jmeta)
    names = JNames()
    cache = JCache(names)
    for n in nodes:
        cache.add_node(n)
    backend = TPUBackend(names)
    for g, (_group, pods) in enumerate(gangs[:-1]):
        for i, pod in enumerate(pods):
            backend.extractor.register(pod)
            cache.assume_pod(pod, nodes[(3 * g + 5 * i) % len(nodes)].meta.name)
    snap = JSnapshot()
    cache.update_snapshot(snap)
    wave = gangs[-1][1]
    for pod in wave:
        backend.extractor.register(pod)
    planes = backend.sync(snap)
    feats = jpad(jstack([backend.extractor.features(p, planes) for p in wave]), pad_to)
    cfg = backend.kernel_config(planes, feats)
    arrays = {**planes.as_dict(), **backend.extractor.affinity_tables(planes)}
    zones, parent = _zone_lists(nodes)
    lists, nc, hf = {"required": (zones, len(zones), False),
                     "preferred": (zones + [parent], len(zones), True),
                     "unconstrained": ([parent], 0, True),
                     "empty-pin": ([[]], 1, False)}[mode if name != "empty-pin" else name]
    n_rows = 1 << max(1, (len(lists) - 1).bit_length())
    masks = jmasks(planes, lists, n_rows)
    n_words = pad_to * jk.MAX_TIE_DRAWS + jk.MAX_TIE_DRAWS
    words = clone_tie_words(random.Random(seed), 3 if words_kind == "short" else n_words)
    return cfg, planes, arrays, feats, masks, words, nc, hf


def _port_gang(cfg, planes, arrays, feats, masks, words, nc, hf):
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    return tk.gang_assign(pcfg, dplanes, static, packed_f, layout, torch.from_numpy(masks),
                          torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(tk.log_weight_table(planes.nb)), nc, hf)


def _unpack(packed, d, p):
    return {"winners": packed[: d * p].reshape(d, p), "consumed": packed[d * p: d * p + d],
            "overflow": packed[d * p + d: d * p + 2 * d],
            "placed": packed[d * p + 2 * d: d * p + 3 * d],
            "score": packed[d * p + 3 * d: d * p + 4 * d], "tail": packed[-3:]}


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_gang_assign_matches_reference(case):
    """The port's gang_assign (K1 once + K5 plain versions) == JAX
    gang_assign, element for element of the packed vector."""
    cfg, planes, arrays, feats, masks, words, nc, hf = _kernel_inputs(case)
    want = np.asarray(jk.gang_assign(cfg, arrays, feats, masks, words, nc, hf))
    got = _port_gang(cfg, planes, arrays, feats, masks, words, nc, hf).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    d, p = masks.shape[0], feats["active"].shape[0]
    out = _unpack(got, d, p)
    win_d, ok, n_active = out["tail"].tolist()
    n_real = nc + int(hf)
    assert n_active == int(feats["active"].sum())
    # pad rows place nobody and draw nothing
    assert (out["winners"][n_real:] == -1).all() and (out["consumed"][n_real:] == 0).all()
    # each case exercises what its name says
    if case in ("required", "preferred", "mixed-existing", "own-first-anti-ports"):
        assert ok
    if case == "required":
        assert not hf and win_d < nc and (out["placed"][:nc] == n_active).all()
    if case == "preferred":
        assert hf and nc == 3 and win_d < nc
    if case == "unconstrained":
        assert nc == 0 and hf and win_d == 0 and ok
    if case == "no-domain-fits":
        assert not ok and win_d == 0 and (out["placed"][:nc] < n_active).all()
    if case == "pads-3-words":
        assert (~feats["active"]).any() and len(words) == 3 and n_real == 3 and d == 4
        assert int(out["overflow"][:n_real].sum()) == 1  # one row's draw runs out
    if case == "mixed-existing":
        assert cfg.ipa_active and cfg.ipa_existing_anti and cfg.n_hard and cfg.n_ipa_anti
    if case == "own-first-anti-ports":
        assert cfg.ipa_active and not arrays["ipa_anti"].any() and feats["has_ports"].any()
    if case == "empty-pin":
        assert nc == 1 and not hf and not masks[0].any() and not ok
        assert out["placed"][0] == 0


def test_gang_assign_dispatch_and_row_checks():
    """CPU tensors run the plain version and count no launch; another
    device raises, and so do more constrained and fallback rows than mask
    rows."""
    cfg, planes, arrays, feats, masks, words, nc, hf = _kernel_inputs("preferred")
    pcfg = tk.KernelConfig(**dataclasses.asdict(cfg))
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    static = tk.static_parts(dplanes, dtables, packed_f, layout)
    args = (torch.from_numpy(masks), torch.from_numpy(words.view(np.int32)),
            torch.from_numpy(tk.log_weight_table(planes.nb)))
    tk.reset_launches()
    tk.gang_assign(pcfg, dplanes, static, packed_f, layout, *args, nc, hf)
    assert tk.LAUNCHES["gang_assign"] == 0
    with pytest.raises(ValueError):
        tk.gang_assign(pcfg, dplanes, static, packed_f.to("meta"), layout, *args, nc, hf)
    with pytest.raises(ValueError):
        tk.gang_assign(pcfg, dplanes, static, packed_f, layout, *args, masks.shape[0], True)


@pytest.mark.parametrize("case", ["mixed-existing", "own-first-anti-ports"])
def test_static_parts_once_equals_per_row(case):
    """K1 once over the members with the mask applied afterwards equals the
    reference's _static_pod_parts under valid & mask, for every row."""
    cfg, planes, arrays, feats, masks, _words, _nc, _hf = _kernel_inputs(case)
    dplanes = planes_from_reference(
        {k: v for k, v in arrays.items() if not k.startswith("aff_")}, "cpu")
    dtables = planes_from_reference(
        {k: v for k, v in arrays.items() if k.startswith("aff_")}, "cpu")
    packed_f, layout = features_from_reference(feats, "cpu")
    once = tk.static_parts(dplanes, dtables, packed_f, layout)
    import jax

    for mask in masks:
        narrowed = dict(arrays, valid=arrays["valid"] & mask)
        want = jax.vmap(lambda f, p=narrowed: jk._static_pod_parts(cfg, p, f))(feats)
        assert np.array_equal((once["static_ok"] & torch.from_numpy(mask)[None]).numpy(),
                              np.asarray(want["static_ok"]))
        for k in ("taint_cnt", "aff_raw", "aff_has_pref", "img"):
            assert np.array_equal(once[k].numpy(), np.asarray(want[k])), k


# --------------------------------------------------------------------------
# two sides over one gang spec: cache, snapshot, backend, planner framework
# --------------------------------------------------------------------------


class _Jax:
    def __init__(self, nodes):
        self.names = JNames()
        self.cache = JCache(self.names)
        for n in nodes:
            self.cache.add_node(n)
        self.snapshot = JSnapshot()
        self.cache.update_snapshot(self.snapshot)
        self.store = Store()
        self.fw = JFramework([JGenerator()])
        handle = JHandle(self.store, self.cache, None, self.snapshot)
        self.fw.placement_generate_plugins[0].set_handle(handle)
        self.backend = TPUBackend(self.names)
        self.plan_gang = jplanner.plan_gang

    def add_group(self, group, pods):
        self.store.create(group)
        self.cache.pod_group_states.set_group(group)
        for pod in pods:
            self.cache.pod_group_states.pod_added(group.meta.key, pod.meta.key)

    def bind(self, group, pod, node):
        self.cache.assume_pod(pod, node)
        self.cache.pod_group_states.pod_scheduled(group.meta.key, pod.meta.key)
        pod.spec.node_name = node
        self.store.create(pod)

    def outcome(self):
        return self.backend.recorder._records[-1].gang_outcome


class _Port:
    def __init__(self, nodes, device="cpu"):
        self.names = TNames()
        self.cache = TCache(self.names)
        for n in nodes:
            self.cache.add_node(n)
        self.snapshot = TSnapshot()
        self.cache.update_snapshot(self.snapshot)
        self.handle = Handle(cache=self.cache, snapshot=self.snapshot)
        self.fw = Framework([TopologyPlacementGenerator()], handle=self.handle)
        self.backend = TorchBackend(self.names, device=device)
        self.plan_gang = tplanner.plan_gang

    def add_group(self, group, pods):
        self.handle.store.add(group)
        self.cache.pod_group_states.set_group(group)
        for pod in pods:
            self.cache.pod_group_states.pod_added(group.meta.key, pod.meta.key)

    def bind(self, group, pod, node):
        self.cache.assume_pod(pod, node)
        self.cache.pod_group_states.pod_scheduled(group.meta.key, pod.meta.key)
        pod.spec.node_name = node
        self.handle.store.add(pod)

    def outcome(self):
        return self.backend.recorder.records()[-1].gang_outcome


def _qpis(pods):
    return [SimpleNamespace(pod=p) for p in pods]


def _plan_view(plan):
    if plan is None:
        return None
    return ([(p.name, list(p.node_names)) for p in plan.gang_placements],
            plan.gang_n_constrained, plan.gang_has_fallback, plan.gang_required)


def _sides(spec):
    return ((_Jax(build_gang_nodes(spec, jtypes, jmeta)), build_gangs(spec, jtypes, jmeta)),
            (_Port(build_gang_nodes(spec, ttypes, tmeta)), build_gangs(spec, ttypes, tmeta)))


def _run_sequence(spec, seed):
    """Every gang of the spec, one after another, through both packages'
    planner and run_gang; each gang's hosts are bound into both caches
    before the next. Returns the per-gang results of both sides."""
    results = []
    for side, gangs in _sides(spec):
        rng = random.Random(seed)
        got = []
        for group, pods in gangs:
            side.add_group(group, pods)
            side.cache.update_snapshot(side.snapshot)
            plan = side.plan_gang(side, side.fw, _qpis(pods))
            res = side.backend.run_gang(pods, side.snapshot, plan.gang_placements,
                                        plan.gang_n_constrained, plan.gang_has_fallback,
                                        rng)
            got.append((_plan_view(plan), None if res is None else res[:2],
                        side.outcome(), rng.getstate()))
            if res is not None:
                for pod, node in zip(pods, res[0]):
                    side.bind(group, pod, node)
        results.append(got)
    return results


SEQUENCES = {
    "gang-wave": gang_wave_spec(),
    "gang-wave-required": gang_wave_spec(modes=("Required",) * 3),
    "gang-wave-preferred": gang_wave_spec(modes=("Preferred",) * 3),
    "required-no-fit": gang_wave_spec(modes=("Required",), sizes=(3,), nodes=4, zones=2,
                                      cpu="2", pod_cpu="1500m"),
    **{f"fuzz-{s}": gang_fuzz_spec(s) for s in (5, 9, 13, 17)},
    "mixed": mixed_gang_spec(5, 30, 4, 6),  # two gangs too large for any node
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_run_gang_sequence_matches_reference(name):
    """TorchBackend.run_gang == TPUBackend.run_gang after every gang: the
    plan, hosts, winning row, outcome string, the None cases and the rng."""
    want, got = _run_sequence(SEQUENCES[name], seed=21)
    assert got == want
    if name == "required-no-fit":
        assert got[0][1] is None and got[0][2].startswith("fallback:no-domain")
    elif name != "mixed":
        # the reference's scenarios place every gang on the device
        assert all(r[1] is not None and r[2].startswith("device:") for r in got)
    else:
        assert any(r[1] is not None for r in got) and any(r[1] is None for r in got)


def test_try_gang_wave_counts_and_leaves_state_on_fallback():
    """The port's try_gang_wave places a gang whole, counts it on the
    device side, and on a fallback returns None with the rng untouched."""
    spec = gang_wave_spec(modes=("Required", "Required"), sizes=(3, 9))
    for m in spec["gangs"][1]["members"]:
        m["cpu"] = "5"  # one per 8-CPU node: no zone of four nodes holds nine
    side = _Port(build_gang_nodes(spec, ttypes, tmeta))
    algo = TorchSchedulingAlgorithm(side.fw, side.backend, rng=random.Random(4))
    (g0, fits), (g1, too_big) = build_gangs(spec, ttypes, tmeta)
    side.add_group(g0, fits)
    hosts = tplanner.try_gang_wave(side, side.fw, algo, g0.meta.key, _qpis(fits))
    assert hosts and len({int(h[1:]) % 3 for h in hosts}) == 1
    assert side.backend.recorder.gang_pod_totals == {"device": 3} and algo.kernel_count == 3
    state = algo.rng.getstate()
    side.add_group(g1, too_big)
    assert tplanner.try_gang_wave(side, side.fw, algo, g1.meta.key, _qpis(too_big)) is None
    assert algo.rng.getstate() == state and algo.fallback_count == 9
    assert side.backend.recorder.gang_pod_totals == {"device": 3, "host": 9}
    record = side.backend.recorder.records()[-1]
    assert record.gang_outcome.startswith("fallback:no-domain near=")
    # past the member cap: the host path, no kernel launch
    many = _qpis(too_big * 15)
    assert len(many) > tplanner.MAX_GANG_MEMBERS
    assert tplanner.try_gang_wave(side, side.fw, algo, g1.meta.key, many) is None
    assert side.backend.recorder.records()[-1] is record
    assert side.backend.recorder.gang_pod_totals["host"] == 9 + len(many)


# --------------------------------------------------------------------------
# the placement score and the planner
# --------------------------------------------------------------------------


def test_placement_score_matches_reference():
    """JAX _gang_placement_score, the port's plain version and the port's
    TopologyPlacementGenerator.score_placement agree on every placement of
    a mixed cluster with used capacity."""
    spec = mixed_gang_spec(5, 30, 4, 6)
    (jside, jgangs), (tside, tgangs) = _sides(spec)
    for (jg, jpods), (tg, tpods) in zip(jgangs[:4], tgangs[:4]):
        for i, (jp, tp) in enumerate(zip(jpods, tpods)):
            node = f"node-{(7 * i + len(jpods)) % 30}"
            jside.cache.assume_pod(jp, node)
            tside.cache.assume_pod(tp, node)
    jside.cache.update_snapshot(jside.snapshot)
    tside.cache.update_snapshot(tside.snapshot)
    jplanes = jside.backend.sync(jside.snapshot)
    tplanes = tside.backend.sync(tside.snapshot)
    dev = planes_from_reference({k: jplanes.as_dict()[k] for k in ("alloc", "used")}, "cpu")
    zones, parent = _zone_lists(build_gang_nodes(spec, ttypes, tmeta))
    lists = zones + [parent, parent[:5], []]
    masks = jmasks(jplanes, lists)
    assert np.array_equal(masks, placement_masks(tplanes, lists))
    gen = tside.fw.placement_generate_plugins[0]
    for lst, mask in zip(lists, masks):
        want = int(jk._gang_placement_score(jplanes.as_dict(), mask))
        assert int(tk.gang_placement_score_ref(dev, torch.from_numpy(mask))) == want
        score, st = gen.score_placement(CycleState(), [], Placement("p", lst))
        assert score == want and st.is_success
    assert len({int(tk.gang_placement_score_ref(dev, torch.from_numpy(m))) for m in masks}) > 2


def _reference_scheduler(spec):
    """A JAX Scheduler built as tests/test_gang_wave.py _run builds it, with
    the spec's nodes, PodGroups and members in its store."""
    store = Store()
    for n in build_gang_nodes(spec, jtypes, jmeta):
        store.create(n)
    s = Scheduler(store, profiles=[Profile(backend="tpu")], seed=7, feature_gates=GATES)
    s.start()
    gangs = build_gangs(spec, jtypes, jmeta)
    for group, pods in gangs:
        store.create(group)
        for pod in pods:
            store.create(pod)
    s.pump()
    s.cache.update_snapshot(s.snapshot)
    return s, gangs


PLAN_CASES = ["required", "preferred", "unconstrained", "pinned", "two-domains"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_gang_matches_reference(case):
    """JAX plan_gang (from a JAX Scheduler) == the port's plan_gang: the
    same placements in the same order with the same node lists,
    n_constrained, has_fallback and required; None on a plugin error."""
    mode = {"required": "Required", "preferred": "Preferred", "unconstrained": None,
            "pinned": "Required", "two-domains": "Required"}[case]
    members = [gang_member(f"m{i}", cpu="1", mem=None) for i in range(4)]
    spec = {"nodes": [gang_node(f"n{i}", f"z{i % 3}" if i != 7 else None, cpu="8",
                                mem="16Gi") for i in range(12)],
            "gangs": [gang("g", mode, members)]}
    bound = {"pinned": {"m0": "n4", "m1": "n1"},  # both in z1
             "two-domains": {"m0": "n4", "m1": "n2"}}.get(case, {})
    # the reference side: members already bound arrive through its informer
    s, jgangs = _reference_scheduler(spec)
    jgroup, jpods = jgangs[0]
    for pod in jpods:
        if pod.meta.name in bound:
            bound_pod = s.store.get("Pod", pod.meta.key)
            bound_pod.spec.node_name = bound[pod.meta.name]
            s.store.update(bound_pod)
    s.pump()
    s.cache.update_snapshot(s.snapshot)
    fw = s.frameworks["default-scheduler"]
    jqpis = _qpis([p for p in jpods if p.meta.name not in bound])
    want = jplanner.plan_gang(s, fw, jqpis)
    # the port side
    side = _Port(build_gang_nodes(spec, ttypes, tmeta))
    tgroup, tpods = build_gangs(spec, ttypes, tmeta)[0]
    side.add_group(tgroup, tpods)
    for pod in tpods:
        if pod.meta.name in bound:
            side.bind(tgroup, pod, bound[pod.meta.name])
    side.cache.update_snapshot(side.snapshot)
    got = tplanner.plan_gang(side, side.fw, _qpis([p for p in tpods
                                                    if p.meta.name not in bound]))
    assert _plan_view(got) == _plan_view(want)
    if case == "two-domains":
        assert got is None
    elif case == "pinned":
        assert [p.name for p in got.gang_placements] == ["all/topology.kubernetes.io/zone=z1"]
    elif case == "unconstrained":
        assert got.gang_n_constrained == 0 and got.gang_has_fallback
    else:
        assert got.gang_n_constrained == 3 and got.gang_has_fallback == (mode == "Preferred")
