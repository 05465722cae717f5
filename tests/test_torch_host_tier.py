"""The host tier around K4: the port's TorchSchedulingAlgorithm (plain
versions, on the CPU) against the reference package's
TPUSchedulingAlgorithm, both built as tests/test_torch_cycle.py builds them
(default profile, seeded rng 0) and given a nominator each (the
reference's SchedulingQueue, the port's Nominator).

Compared exactly on every route: hosts, evaluated and feasible counts,
next_start_node_index, kernel_count and fallback_count, the seeded rng
state and FitError diagnoses. The routes: the hybrid path
(NodeDeclaredFeatures over K4, with the reference's test_hybrid cases that
need no storage or DRA: declared features, score isolation, the cycle
state a FitError leaves for preemption), the nominee fast path and the
two-pass nominated-pod protection (test_nominated_fallback's three
scenarios), FallbackNeeded pods on the host algorithm, OutOfSlice still
raising (single pods and gangs, on the device and the host route), the
kernel diagnosis's set() overlays, K4's run arrays across placement
narrowing and in-snapshot assume/forget, the gang planner's gates and
catch-all, and PodGroupCycle against the reference's host pod-group
algorithm. A kernel error on a card raises from the gang wave and the dry
run instead of degrading as on the CPU.

Clusters stay where the JAX kernel's PodTopologySpread log weight equals
the host plugin's (hostname domain counts off 35, 47, 177, ...; see
tests/test_torch_fit.py).
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Placement as JPlacement
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.framework.cycle_state import CycleState as JCycleState
from kubernetes_tpu.scheduler.framework.interface import FitError as JFitError
from kubernetes_tpu.scheduler.framework.interface import Status as JStatus
from kubernetes_tpu.scheduler.framework.runtime import Framework as JFramework
from kubernetes_tpu.scheduler.nodeinfo import PodInfo as JPodInfo
from kubernetes_tpu.scheduler.plugins.registry import DEFAULT_WEIGHTS as JWEIGHTS
from kubernetes_tpu.scheduler.plugins.registry import default_plugins as jdefault_plugins
from kubernetes_tpu.scheduler.queue.scheduling_queue import SchedulingQueue
from kubernetes_tpu.scheduler.schedule_one import ScheduleOneLoop
from kubernetes_tpu.scheduler.scheduler import Handle as JHandle
from kubernetes_tpu.scheduler.tpu import backend as jbackend
from kubernetes_tpu.scheduler.tpu import gangplanner as jplanner
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend, TPUSchedulingAlgorithm
from kubernetes_tpu.store import Store
from kubernetes_tpu.testing import wrappers as jw
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops.kernels import OutOfSlice
from kubernetes_tpu_torch.ops.planes import FallbackNeeded
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Placement as TPlacement
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.framework import CycleState as TCycleState
from kubernetes_tpu_torch.scheduler.framework import FitError as TFitError
from kubernetes_tpu_torch.scheduler.framework import Framework as TFramework
from kubernetes_tpu_torch.scheduler.framework import Handle as THandle
from kubernetes_tpu_torch.scheduler.framework import Status as TStatus
from kubernetes_tpu_torch.scheduler.nodeinfo import PodInfo as TPodInfo
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_WEIGHTS as TWEIGHTS
from kubernetes_tpu_torch.scheduler.plugins.registry import default_plugins as tdefault_plugins
from kubernetes_tpu_torch.scheduler.queue import Nominator
from kubernetes_tpu_torch.scheduler.schedule_one import PodGroupCycle
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu import gangplanner as tplanner
from kubernetes_tpu_torch.scheduler.tpu.backend import (
    KERNEL_FILTER_PLUGINS,
    KERNEL_SCORE_PLUGINS,
    RUN_OUTPUTS,
    TorchBackend,
    TorchSchedulingAlgorithm,
)
from kubernetes_tpu_torch.testing import wrappers as tw
from kubernetes_tpu_torch.testing.mixed import (
    build_gang_nodes,
    build_gangs,
    build_nodes,
    build_pods,
    gang,
    gang_member,
    gang_node,
    mixed_spec,
)

NDF = "features.k8s.io/required"
FEATURE = "NUMAAlignment"
# the reference's default plugins that read the store, which the port's
# profile holds only when given one (the frameworks here have none); for
# pods without volumes or claims they Skip or score 0
NOT_PORTED = {"VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
              "DynamicResources", "DefaultBinder"}


class _Side:
    """One package's cluster, framework (default profile, with a handle
    whose store holds the PodGroups), nominator and device algorithm."""

    def __init__(self, pkg, nodes, host_tail_percentage=0, plugin_args=None):
        self.pkg = pkg
        jax = pkg == "jax"
        self.types, self.meta = (jtypes, jmeta) if jax else (ttypes, tmeta)
        self.names = JNames() if jax else TNames()
        self.cache = (JCache if jax else TCache)(self.names)
        for n in nodes:
            self.cache.add_node(n)
        self.snapshot = (JSnapshot if jax else TSnapshot)()
        self.cache.update_snapshot(self.snapshot)
        self.state_cls = JCycleState if jax else TCycleState
        args = plugin_args or {}
        if jax:
            self.store = Store()
            self.fw = JFramework(jdefault_plugins(self.store, self.names, {}, args),
                                 dict(JWEIGHTS))
            self.handle = JHandle(self.store, self.cache, None, self.snapshot)
            self.handle.framework = self.fw
            for p in self.fw.plugins:
                if hasattr(p, "set_handle"):
                    p.set_handle(self.handle)
            self.nominator = SchedulingQueue(lambda a, b: a.timestamp < b.timestamp)
            self.backend = TPUBackend(self.names, plugin_args=plugin_args)
            self.algo = TPUSchedulingAlgorithm(
                self.fw, self.backend, rng=random.Random(0), nominator=self.nominator,
                host_tail_percentage=host_tail_percentage)
        else:
            self.handle = THandle(cache=self.cache, snapshot=self.snapshot)
            self.fw = TFramework(tdefault_plugins(self.names, args=args), dict(TWEIGHTS),
                                 handle=self.handle)
            self.nominator = Nominator()
            self.backend = TorchBackend(self.names, plugin_args=plugin_args, device="cpu")
            self.algo = TorchSchedulingAlgorithm(
                self.fw, self.backend, rng=random.Random(0), nominator=self.nominator,
                host_tail_percentage=host_tail_percentage)

    def pod_info(self, pod):
        return (JPodInfo if self.pkg == "jax" else TPodInfo)(pod, self.names)

    def nominate(self, pod, node):
        self.nominator.add_nominated_pod(pod, node, self.pod_info(pod))

    def assume(self, pod, node):
        self.cache.assume_pod(pod, node)
        self.cache.update_snapshot(self.snapshot)

    def remove(self, pod):
        self.cache.remove_pod(pod)
        self.cache.update_snapshot(self.snapshot)

    def add_group(self, group, pods):
        (self.store.create if self.pkg == "jax" else self.handle.store.add)(group)
        self.cache.pod_group_states.set_group(group)
        for pod in pods:
            self.cache.pod_group_states.pod_added(group.meta.key, pod.meta.key)
        self.cache.update_snapshot(self.snapshot)

    def gang_totals(self):
        return dict(self.backend.recorder.gang_pod_totals)


def _sides(build, **kw):
    """(reference, port) sides from build(types, meta) -> nodes."""
    return tuple(_Side(pkg, build(*((jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta))),
                       **kw) for pkg in ("jax", "port"))


def _st(st):
    return None if st is None else (st.code, tuple(st.reasons), st.plugin)


def _schedule(side, pod):
    """schedule_pod on one side: a comparable record of the result or the
    FitError, the rotation index and the counters after it."""
    algo = side.algo
    node_names = [ni.name for ni in side.snapshot.list_nodes()]
    try:
        r = algo.schedule_pod(side.state_cls(), pod, side.snapshot)
    except (JFitError, TFitError) as e:
        d = e.diagnosis
        nts = d.node_to_status
        rec = ("fit", e.error_message(), e.num_all_nodes, sorted(d.unschedulable_plugins),
               d.pre_filter_msg, [_st(nts.get(n)) for n in node_names])
    else:
        rec = (r.suggested_host, r.evaluated_nodes, r.feasible_nodes)
        side.assume(pod, r.suggested_host)
    return rec + (algo.next_start_node_index, algo.kernel_count, algo.fallback_count)


def _drive(sides, pods_of):
    """Every pod through both sides; returns the port's records (equal to
    the reference's, asserted pod by pod) and checks the rng at the end."""
    jside, tside = sides
    recs = []
    for jp, tp in zip(pods_of(jside), pods_of(tside)):
        want = _schedule(jside, jp)
        got = _schedule(tside, tp)
        assert got == want, tp.meta.name
        recs.append(got)
    assert tside.algo.rng.getstate() == jside.algo.rng.getstate()
    return recs


# --- hybrid: NodeDeclaredFeatures over K4 (test_hybrid.py) ----------------------


def _ndf_nodes(types, meta):
    wr = jw if types is jtypes else tw
    plain = wr.make_node("plain", cpu="8", mem="16Gi")
    featured = wr.make_node("featured", cpu="8", mem="16Gi")
    featured.status.declared_features = (FEATURE,)
    return [plain, featured]


def _needy(side, name="needy", feature=FEATURE, cpu="1", mem=None):
    wr = jw if side.pkg == "jax" else tw
    pod = wr.make_pod(name, cpu=cpu, mem=mem)
    pod.meta.annotations[NDF] = feature
    return pod


class TestHybridDeclaredFeatures:
    def test_ndf_pod_composes(self):
        sides = _sides(_ndf_nodes)
        recs = _drive(sides, lambda s: [_needy(s)])
        assert recs[0][0] == "featured"
        assert recs[0][-2:] == (1, 0)  # kernel_count 1, fallback_count 0

    def test_unsatisfiable_ndf_pod_gets_fit_error_diagnosis(self):
        sides = _sides(_ndf_nodes)
        recs = _drive(sides, lambda s: [_needy(s, feature="Quantum")])
        assert recs[0][0] == "fit" and recs[0][3] == ["NodeDeclaredFeatures"]

    @pytest.mark.parametrize("tail", [100, 0])
    def test_mixed_cluster_with_ndf_pods(self, tail):
        """A 250-node mixed cluster, five nodes in six declaring the
        feature and a third of the pods requiring it (one in nine a
        feature no node declares): the kernel route and the hybrid route
        interleave. At tail 0 the host tail samples adaptively (250 nodes:
        the first 120 feasible nodes, from a rotating start); at 100 it
        walks every node and the start stays put."""
        spec = mixed_spec(61, 250, 36, constraints=True)

        def nodes(types, meta):
            out = build_nodes(spec, types, meta)
            for i, n in enumerate(out):
                n.status.declared_features = (FEATURE,) if i % 6 else ()
            return out

        def pods(side):
            out = build_pods(spec, side.types, side.meta)
            for i, p in enumerate(out):
                if i % 3 == 1:
                    p.meta.annotations[NDF] = "Quantum" if i % 9 == 4 else FEATURE
            return out

        recs = _drive(_sides(nodes, host_tail_percentage=tail), pods)
        assert recs[-1][-2:] == (36, 0)  # every pod ran K4; none fell back
        hybrid = [r for i, r in enumerate(recs) if i % 3 == 1 and r[0] != "fit"]
        assert hybrid
        if tail == 0:
            assert any(r[2] == 120 for r in hybrid) and any(r[-3] for r in recs)
        else:
            assert all(r[-3] == 0 for r in recs)


class TestHybridScoreIsolation:
    def test_host_score_pass_excludes_kernel_plugins(self, monkeypatch):
        """The dense plugins' scores live in K4's total; the host score pass
        must not run them again (double count)."""
        captured = {"jax": [], "port": []}
        for pkg, cls in (("jax", JFramework), ("port", TFramework)):
            orig = cls.run_score_plugins

            def spy(self, state, pod, nodes, orig=orig, pkg=pkg):
                scores, st = orig(self, state, pod, nodes)
                # the reference's VolumeBinding scores 0 for a claim-less pod
                assert all(v == 0 for n in scores for p, v in n.scores if p in NOT_PORTED)
                captured[pkg].append([(n.name, [(p, v) for p, v in n.scores
                                                if p not in NOT_PORTED], n.total_score)
                                      for n in scores])
                return scores, st

            monkeypatch.setattr(cls, "run_score_plugins", spy)

        def nodes(types, meta):
            wr = jw if types is jtypes else tw
            out = [wr.make_node(f"n{i}", cpu="8", mem="16Gi") for i in range(4)]
            for n in out:
                n.status.declared_features = (FEATURE,)
            return out

        jside, tside = sides = _sides(nodes)
        for side in sides:
            wr = jw if side.pkg == "jax" else tw
            side.assume(wr.make_pod("filler", cpu="6", mem="12Gi"), "n0")
        recs = _drive(sides, lambda s: [_needy(s, "claimed"), _needy(s, "second")])
        assert recs[0][0] != "n0"
        assert captured["port"] == captured["jax"] and captured["port"]
        for scores in captured["port"]:
            for _name, plugin_scores, _total in scores:
                assert not {p for p, _ in plugin_scores} & KERNEL_SCORE_PLUGINS
        assert KERNEL_SCORE_PLUGINS == jbackend.KERNEL_SCORE_PLUGINS
        assert KERNEL_FILTER_PLUGINS == jbackend.KERNEL_FILTER_PLUGINS


def _state_view(state):
    """The skip sets (less the reference's plugins the port's profile
    leaves out; they Skip for these pods) and the PreFilter keys."""
    return (sorted(state.skip_filter_plugins - NOT_PORTED),
            sorted(state.skip_score_plugins - NOT_PORTED),
            sorted(state._storage), state.is_pod_group_scheduling_cycle)


class TestHybridPreemptionState:
    @pytest.mark.parametrize("ndf", [True, False])
    def test_fit_error_leaves_the_unpolluted_state(self, ndf):
        """A pod too big for every node, on the hybrid route (ndf) and the
        kernel route: the FitError leaves the host PreFilter chain's state
        — its PreFilter keys and the skip set WITHOUT the kernel's filter
        plugins — as the reference does, for preemption's dry run."""
        def nodes(types, meta):
            wr = jw if types is jtypes else tw
            n0 = wr.make_node("n0", cpu="4", mem="8Gi")
            n0.status.declared_features = (FEATURE,)
            return [n0]

        views = []
        for side in _sides(nodes):
            wr = jw if side.pkg == "jax" else tw
            victim = wr.make_pod("victim", cpu="1", mem="1Gi")
            side.assume(victim, "n0")
            giant = (_needy(side, "giant", cpu="32", mem="64Gi") if ndf
                     else wr.make_pod("giant", cpu="32", mem="64Gi"))
            giant.spec.priority = 1000
            state = side.state_cls()
            with pytest.raises((JFitError, TFitError)) as err:
                side.algo.schedule_pod(state, giant, side.snapshot)
            views.append((_state_view(state), err.value.error_message(),
                          side.algo.kernel_count, side.algo.fallback_count))
        assert views[1] == views[0]
        skips = set(views[1][0][0])
        assert not skips & (KERNEL_FILTER_PLUGINS - {"NodePorts", "PodTopologySpread",
                                                     "InterPodAffinity", "NodeAffinity"})
        assert "PreFilterNodeResourcesFit" in views[1][0][2]


# --- nominated pods (test_nominated_fallback.py) ----------------------------------


def _nominated_cluster(types, meta):
    wr = jw if types is jtypes else tw
    return [wr.make_node(f"n{i}", cpu="4", mem="16Gi", zone=f"z{i % 4}") for i in range(20)]


NOMINEE = "n7"


def _fill_and_nominate(sides):
    """Fill every node with a priority-0 victim of 3 CPU, then nominate a
    priority-100 preemptor onto n7 in both nominators after removing n7's
    victim (as DefaultPreemption leaves it)."""
    pres = []
    for side in sides:
        wr = jw if side.pkg == "jax" else tw
        victims = []
        for i in range(20):
            v = wr.make_pod(f"victim-{i}", cpu="3", mem="1Gi")
            side.cache.assume_pod(v, f"n{i}")
            victims.append(v)
        side.remove(victims[7])
        pre = wr.make_pod("preemptor", cpu="3", mem="1Gi")
        pre.spec.priority = 100
        side.nominate(pre, NOMINEE)
        pres.append(pre)
    return pres


class TestNarrowedFallback:
    def test_higher_priority_pods_stay_on_kernel(self):
        sides = _sides(_nominated_cluster)
        _fill_and_nominate(sides)

        def vips(side):
            wr = jw if side.pkg == "jax" else tw
            out = [wr.make_pod(f"vip-{i}", cpu="100m", mem="64Mi") for i in range(16)]
            for p in out:
                p.spec.priority = 200  # outranks the nomination (100)
            return out

        recs = _drive(sides, vips)
        assert recs[-1][-2:] == (16, 0)  # all on the kernel route
        assert sides[1].algo.next_start_node_index == 0  # the kernel route never rotates

    def test_lower_priority_pods_use_hybrid_with_protection(self):
        sides = _sides(_nominated_cluster)
        _fill_and_nominate(sides)

        def lows(side):
            wr = jw if side.pkg == "jax" else tw
            # sized to fit only the preemptor's freed slot (priority 0)
            out = [wr.make_pod(f"low-{i}", cpu="3", mem="1Gi") for i in range(3)]
            out += [wr.make_pod(f"small-{i}", cpu="500m", mem="64Mi") for i in range(3)]
            return out

        recs = _drive(sides, lows)
        assert recs[-1][-2:] == (6, 0)  # all through K4 (hybrid)
        assert all(r[0] == "fit" for r in recs[:3])  # protection kept the nominee
        # the FitError names the nominee's pass-1 verdict
        assert recs[0][5][7] == (2, ("Insufficient cpu",), "NodeResourcesFit")
        assert all(r[0] not in ("fit",) for r in recs[3:])

    def test_preemptor_and_mixed_workload(self):
        """The preemptor retries through the nominee fast path (host
        decision), a preemptor whose nominee no longer fits falls through
        to the hybrid cycle, and a mixed workload around them keeps the
        kernel ratio at or above 0.9."""
        sides = _sides(_nominated_cluster)
        pres = _fill_and_nominate(sides)
        for pre, side in zip(pres, sides):
            pre.status.nominated_node_name = NOMINEE
        got = [_schedule(side, pre) for pre, side in zip(pres, sides)]
        assert got[1] == got[0] and got[1][:3] == (NOMINEE, 1, 1)
        assert got[1][-2:] == (0, 1)
        for pre, side in zip(pres, sides):
            side.nominator.delete_nominated_pod_if_exists(pre)

        def stale(side):
            wr = jw if side.pkg == "jax" else tw
            p = wr.make_pod("stale", cpu="3", mem="1Gi")
            p.spec.priority = 100
            p.status.nominated_node_name = NOMINEE  # full now
            side.nominate(p, NOMINEE)
            return [p]

        recs = _drive(sides, stale)
        assert recs[0][0] == "fit" and recs[0][-2:] == (1, 1)

        def web(side):
            wr = jw if side.pkg == "jax" else tw
            return [wr.make_pod(f"web-{i}", cpu="100m", mem="64Mi", labels={"app": "web"})
                    for i in range(18)]

        recs = _drive(sides, web)
        algo = sides[1].algo
        assert algo.kernel_count / (algo.kernel_count + algo.fallback_count) >= 0.9


# --- the host route and OutOfSlice ------------------------------------------------


def _basic_nodes(n):
    def build(types, meta):
        wr = jw if types is jtypes else tw
        return [wr.make_node(f"node-{i}", zone=f"zone-{i % 4}") for i in range(n)]
    return build


def _refused_pods(side):
    """Pods the extractor refuses: a hostPort on a specific hostIP, and 5
    spread constraints (4 slots)."""
    t = side.types
    wr = jw if side.pkg == "jax" else tw
    out = []
    for i in range(3):
        p = wr.make_pod(f"port-{i}", cpu="100m")
        p.spec.containers[0] = t.Container(
            name="c", requests={"cpu": "100m"},
            ports=(t.ContainerPort(80, host_port=80, host_ip=f"10.0.0.{i % 2}"),))
        out.append(p)
    for i in range(3):
        p = wr.make_pod(f"spread-{i}", cpu="100m", labels={"app": "s"})
        for k in range(5):
            key = ("topology.kubernetes.io/zone" if k % 2 else "kubernetes.io/hostname")
            wr.with_spread(p, max_skew=k + 1, key=key, when="DoNotSchedule")
        out.append(p)
    return out


def test_fallback_needed_goes_to_the_host_algorithm():
    sides = _sides(_basic_nodes(12))
    for pod in _refused_pods(sides[1]):
        with pytest.raises(FallbackNeeded):
            sides[1].backend.run(pod, sides[1].snapshot)
    recs = _drive(sides, _refused_pods)
    assert recs[-1][-2:] == (0, 6)  # fallback_count counts exactly them
    assert all(r[0] != "fit" for r in recs)


def test_out_of_slice_is_not_routed_to_the_host():
    """A pod the extractor accepts whose shapes K4's gate refuses raises
    OutOfSlice from schedule_pod with fallback_count unchanged: spread
    over a "rack" key of 1025 domains, two nodes in one (K4 holds at most
    1024 domains per key; the reference computes any count), on the kernel
    route and on the hybrid route. A pod the extractor refuses on the same
    cluster takes the host algorithm. A non-empty extender list is
    accepted (extenders are ported)."""
    names = TNames()
    cache = TCache(names)
    for i in range(1026):
        cache.add_node(tw.make_node(f"node-{i}", zone=f"zone-{i % 4}",
                                    labels={"rack": f"r{i % 1025}"}))
    snap = TSnapshot()
    cache.update_snapshot(snap)
    algo = TorchSchedulingAlgorithm(
        TFramework(tdefault_plugins(names), dict(TWEIGHTS)),
        TorchBackend(names, device="cpu"), nominator=Nominator())

    def racked(i):
        return tw.with_spread(tw.scheduling_basic_pod(i), max_skew=1, key="rack",
                              when="ScheduleAnyway")

    with pytest.raises(OutOfSlice, match="1024"):
        algo.schedule_pod(TCycleState(), racked(0), snap)
    needy = racked(1)
    needy.meta.annotations[NDF] = FEATURE
    with pytest.raises(OutOfSlice, match="1024"):
        algo.schedule_pod(TCycleState(), needy, snap)
    assert (algo.kernel_count, algo.fallback_count) == (0, 0)
    side = SimpleNamespace(types=ttypes, pkg="port")
    got = algo.schedule_pod(TCycleState(), _refused_pods(side)[0], snap)
    assert got.suggested_host and (algo.kernel_count, algo.fallback_count) == (0, 1)
    # HTTP extenders are ported: the algorithm holds them
    ext = object()
    assert TorchSchedulingAlgorithm(algo.fw, algo.backend, extenders=[ext]).extenders == [ext]


def test_lazy_kernel_statuses_set_overlays():
    """The kernel diagnosis's set(): an overlay takes precedence in get(),
    the preemption name sets follow it (their caches invalidated), and
    the FitError message counts it — as the reference's."""
    spec = mixed_spec(62, 16, 4, constraints=True)
    out = []
    for side in _sides(lambda t, m: build_nodes(spec, t, m)):
        wr = jw if side.pkg == "jax" else tw
        pod = wr.make_pod("giant", cpu="64", mem="1Gi")
        with pytest.raises((JFitError, TFitError)) as err:
            side.algo.schedule_pod(side.state_cls(), pod, side.snapshot)
        nts = err.value.diagnosis.node_to_status
        status = JStatus if side.pkg == "jax" else TStatus
        rec = [sorted(nts.unschedulable_name_set()), sorted(nts.fit_verdict_names())]
        nts.set("n0", status.unresolvable("volume node affinity conflict",
                                          plugin="VolumeBinding"))
        nts.set("n5", status.unschedulable("Insufficient cpu", plugin="NodeResourcesFit"))
        rec += [sorted(nts.unschedulable_name_set()), sorted(nts.fit_verdict_names()),
                _st(nts.get("n0")), _st(nts.get("n5")), err.value.error_message()]
        out.append(rec)
    assert out[1] == out[0]
    assert "n0" not in out[1][2] + out[1][3] and "n5" in out[1][2] and "n5" in out[1][3]
    assert out[1][4][2] == "VolumeBinding"


def test_run_arrays_across_narrow_assume_forget_restore():
    """K4's five arrays after each step of a host pod-group dry run on the
    snapshot — narrow to a zone, assume a member, assume another, forget
    both, restore — against the reference's: no stale row after
    forget_placement, no bucket sized for the narrowed list."""
    spec = mixed_spec(63, 24, 10, constraints=True)
    jside, tside = _sides(lambda t, m: build_nodes(spec, t, m))
    zone = [n["name"] for n in spec["nodes"] if n["zone"] == "z1"]
    jpods = build_pods(spec, jtypes, jmeta)
    tpods = build_pods(spec, ttypes, tmeta)
    # a pod with a hard spread constraint and (anti)affinity terms
    probe = next(i for i, p in enumerate(spec["pods"])
                 if p["hard"] and (p["aff"] or p["anti"]))
    steps = []

    def step(label):
        (jpl, jo), (tpl, to) = (jside.backend.run(jpods[probe], jside.snapshot),
                                tside.backend.run(tpods[probe], tside.snapshot))
        assert tpl.node_names == jpl.node_names and tpl.nb == jpl.nb, label
        for k in RUN_OUTPUTS:
            np.testing.assert_array_equal(np.asarray(to[k]), np.asarray(jo[k]),
                                          err_msg=f"{label}: {k}")
        steps.append((label, tpl.nb, {k: np.asarray(to[k]).copy() for k in RUN_OUTPUTS}))

    step("whole")
    for side, P in ((jside, JPlacement), (tside, TPlacement)):
        side.snapshot.assume_placement(P("z1", list(zone)))
    step("narrowed")
    placed = []
    for i, node in ((0, zone[0]), (1, zone[1])):
        for side, pods in ((jside, jpods), (tside, tpods)):
            side.snapshot.assume_pod(side.pod_info(pods[i]), node)
        placed.append((i, node))
        step(f"assume {i}")
    for i, node in reversed(placed):
        for side, pods in ((jside, jpods), (tside, tpods)):
            side.snapshot.forget_pod(pods[i].meta.key, node)
        step(f"forget {i}")
    for side in (jside, tside):
        side.snapshot.forget_placement()
    step("restored")
    assert steps[1][1] < steps[0][1]  # the narrowed bucket is smaller
    assert steps[-1][1] == steps[0][1]
    for k in RUN_OUTPUTS:
        np.testing.assert_array_equal(steps[-1][2][k], steps[0][2][k])
        np.testing.assert_array_equal(steps[-2][2][k], steps[1][2][k])


# --- gangs: the planner's gates and the host pod-group cycle --------------------------


class _RefLoop:
    """The reference ScheduleOneLoop's pod-group algorithm methods over one
    side's snapshot, framework and algorithm."""

    _pod_group_wave_algorithm = ScheduleOneLoop._pod_group_wave_algorithm
    _pod_group_apply_wave = ScheduleOneLoop._pod_group_apply_wave
    _pod_group_algorithm = ScheduleOneLoop._pod_group_algorithm
    _pod_group_dry_run = ScheduleOneLoop._pod_group_dry_run
    _pod_group_default_algorithm = ScheduleOneLoop._pod_group_default_algorithm
    _revert_pod_group = ScheduleOneLoop._revert_pod_group

    def __init__(self, side):
        self.snapshot = side.snapshot
        self.algorithms = {side.fw.profile_name: side.algo}
        self.names = side.names
        self.gang_waves = True  # the reference loop's KUBE_TPU_GANG_WAVES default

    def schedule_pod_group(self, fw, gk, qpis):
        out = self._pod_group_wave_algorithm(fw, gk, qpis)
        return out if out is not None else self._pod_group_algorithm(fw, gk, qpis)


def _outcome(out):
    kind, body, err = out
    if kind == "success":
        return kind, [(q.pod.meta.name, r.suggested_host, r.evaluated_nodes, r.feasible_nodes)
                      for q, _st, r, _pi in body]
    msg = err.error_message() if hasattr(err, "error_message") else _st(err)
    return kind, body.pod.meta.name, msg


def _gang_spec(mode, zones=3, per_zone=6):
    """A zoned cluster (18 nodes of 4 CPU over 3 zones) and one gang of 4
    members of 1 CPU."""
    nodes = [gang_node(f"node-{i}", f"zone-{i % zones}", cpu="4")
             for i in range(zones * per_zone)]
    members = [gang_member(f"m{i}", cpu="1") for i in range(4)]
    return {"nodes": nodes, "gangs": [gang("g0", mode, members)]}


def _gang_sides(spec, compose, featured_zone="zone-2"):
    """Both sides with the gang added; the nodes of `featured_zone` declare
    the feature, and with `compose` the gang's second member requires it."""
    def nodes(types, meta):
        out = build_gang_nodes(spec, types, meta)
        for n in out:
            if n.meta.labels.get("topology.kubernetes.io/zone") == featured_zone:
                n.status.declared_features = (FEATURE,)
        return out

    sides = _sides(nodes)
    gangs = []
    for side in sides:
        group, members = build_gangs(spec, side.types, side.meta)[0]
        if compose:
            members[1].meta.annotations[NDF] = FEATURE
        side.add_group(group, members)
        gangs.append((group, members))
    return sides, gangs


def _run_groups(sides, gangs):
    outs = []
    for side, (group, members) in zip(sides, gangs):
        qpis = [SimpleNamespace(pod=p) for p in members]
        if side.pkg == "jax":
            out = _RefLoop(side).schedule_pod_group(side.fw, group.meta.key, qpis)
        else:
            out = PodGroupCycle(side.snapshot, side.fw, side.algo,
                                side.names).schedule_pod_group(group.meta.key, qpis)
        outs.append((_outcome(out), side.algo.rng.getstate(), side.algo.kernel_count,
                     side.algo.fallback_count, side.algo.next_start_node_index,
                     side.gang_totals(), sorted(n.name for n in side.snapshot.list_nodes()
                                                if n.pods)))
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("mode", ["Required", "Preferred"])
def test_pod_group_cycle_with_a_host_compose_member(mode):
    """try_gang_wave declines a gang with a declared-features member; the
    host cycle places it whole through per-member K4 runs (the member on
    the hybrid route) on placement-narrowed snapshots, in zone-2 (Required;
    the only zone that holds the member) — as the reference's."""
    sides, gangs = _gang_sides(_gang_spec(mode), True)
    out = _run_groups(sides, gangs)
    assert out[0][0] == "success"
    hosts = [h for _n, h, _e, _f in out[0][1]]
    if mode == "Required":
        assert {int(h.split("-")[1]) % 3 for h in hosts} == {2}
    assert out[5] == {"host": 4}
    assert out[3] == 0 and out[2] > 4  # dry runs and the final run, all K4


@pytest.mark.parametrize("mode", ["Required", "Preferred"])
def test_pod_group_cycle_failing_member(mode):
    """The member requires a feature no node declares: Required reports no
    zone holding the group, Preferred falls back to the whole snapshot and
    fails on that member with its FitError — reverted, as the reference."""
    sides, gangs = _gang_sides(_gang_spec(mode), True, featured_zone="none")
    out = _run_groups(sides, gangs)
    # Required: no zone holds the group, reported on the first member;
    # Preferred: the whole snapshot, where the second member fits nowhere
    assert out[0][0] == "unschedulable"
    assert out[0][1] == ("m0" if mode == "Required" else "m1")
    assert out[6] == []  # every assume reverted


def test_pod_group_cycle_device_path_and_plain_gang():
    """A plain gang: the device path takes it (K1 + K5), counted on the
    device side, applied through reserve and permit — as the reference."""
    sides, gangs = _gang_sides(_gang_spec("Required"), False)
    out = _run_groups(sides, gangs)
    assert out[0][0] == "success" and out[5] == {"device": 4}
    assert out[2] == 4 and out[3] == 0


def test_gang_gates_and_catch_all(monkeypatch):
    """A raising run_gang in both packages on the CPU: the catch-all sends
    the group to the host cycle (fallback_count + members), the port counts
    the error beside gang_pod_totals; a member a nomination outranks sends the
    group to the host cycle without a device attempt."""
    def boom(*a, **k):
        raise RuntimeError("K5 launch failed")

    monkeypatch.setattr(jbackend.TPUBackend, "run_gang", boom)
    monkeypatch.setattr(tbackend.TorchBackend, "run_gang", boom)
    sides, gangs = _gang_sides(_gang_spec("Required"), False)
    out = _run_groups(sides, gangs)
    assert out[0][0] == "success" and out[5] == {"host": 4} and out[3] == 4
    assert sides[1].backend.gang_errors == 1
    assert "K5 launch failed" in sides[1].backend.gang_last_error
    monkeypatch.undo()

    sides, gangs = _gang_sides(_gang_spec("Preferred"), False)
    for side in sides:
        wr = jw if side.pkg == "jax" else tw
        nom = wr.make_pod("nominee", cpu="1")
        nom.spec.priority = 10
        side.nominate(nom, "node-0")
    attempts = []
    monkeypatch.setattr(tbackend.TorchBackend, "run_gang",
                        lambda *a, **k: attempts.append(1))
    out = _run_groups(sides, gangs)
    assert out[0][0] == "success" and out[5] == {"host": 4} and not attempts
    assert sides[1].backend.gang_errors == 0
    assert jplanner.MAX_GANG_MEMBERS == tplanner.MAX_GANG_MEMBERS


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("mode", ["Required", "Preferred"])
def test_out_of_slice_gang_is_not_routed_to_the_host(mode, route):
    """Gang members spread over a "rack" key of 1025 domains, two nodes in
    one, all in zone-0 (K1/K5 and K4 hold at most 1024 domains per key; the
    reference computes any count): OutOfSlice raises from
    schedule_pod_group on the device route (K5's gate inside run_gang) and
    on the host route (K4's gate in zone-0's dry run of a gang with a
    declared-features member, after zone-1's dry run found no node for
    it), with every assume, placement and the rng restored and no member
    counted on the device route."""
    spec = {"nodes": [gang_node(f"node-{i}", f"zone-{int(i >= 1026)}", cpu="4")
                      for i in range(1027)],
            "gangs": [gang("g0", mode, [gang_member(f"m{i}", cpu="1", spread=(1, "rack"))
                                        for i in range(3)], labelled=True)]}
    nodes = build_gang_nodes(spec, ttypes, tmeta)
    for i, n in enumerate(nodes):
        n.meta.labels["rack"] = f"r{i % 1025}"
    side = _Side("port", nodes)
    group, members = build_gangs(spec, ttypes, tmeta)[0]
    if route == "host":
        members[1].meta.annotations[NDF] = FEATURE
    side.add_group(group, members)
    rng = side.algo.rng.getstate()
    with pytest.raises(OutOfSlice, match="1024"):
        PodGroupCycle(side.snapshot, side.fw, side.algo, side.names).schedule_pod_group(
            group.meta.key, [SimpleNamespace(pod=p) for p in members])
    assert side.snapshot.num_nodes() == 1027
    assert not any(ni.pods for ni in side.snapshot.list_nodes())
    assert side.algo.rng.getstate() == rng
    assert side.algo.fallback_count == 0 and side.backend.gang_errors == 0
    if route == "device":
        assert side.algo.kernel_count == 0 and side.gang_totals() == {}
    else:
        assert side.gang_totals() == {"host": 3}


@pytest.mark.parametrize("on_card", [False, True])
def test_dry_run_kernel_error(monkeypatch, on_card):
    """K4 raising in a host pod-group dry run: on the CPU the dry run reads
    it as a gang that does not fit, as the reference's does (a Required
    gang no zone holds); on a card it raises, the snapshot and rng
    restored."""
    def boom(*a, **k):
        raise RuntimeError("K4 launch failed")

    monkeypatch.setattr(jbackend.TPUBackend, "run", boom)
    monkeypatch.setattr(tbackend.TorchBackend, "run", boom)
    sides, gangs = _gang_sides(_gang_spec("Required"), True)
    if not on_card:
        out = _run_groups(sides, gangs)
        assert out[0][:2] == ("unschedulable", "m0")
        assert out[0][2][2] == "TopologyPlacementGenerator"
        return
    monkeypatch.setattr(TorchSchedulingAlgorithm, "on_card", True)
    side, (group, members) = sides[1], gangs[1]
    rng = side.algo.rng.getstate()
    with pytest.raises(RuntimeError, match="K4 launch failed"):
        PodGroupCycle(side.snapshot, side.fw, side.algo, side.names).schedule_pod_group(
            group.meta.key, [SimpleNamespace(pod=p) for p in members])
    assert side.snapshot.num_nodes() == 18
    assert not any(ni.pods for ni in side.snapshot.list_nodes())
    assert side.algo.rng.getstate() == rng


def test_gang_wave_error_raises_on_the_card(monkeypatch):
    """On a card the catch-all counts run_gang's error and raises it: a
    failed K1/K5 build or launch never sends the group to the host cycle."""
    def boom(*a, **k):
        raise RuntimeError("K5 launch failed")

    monkeypatch.setattr(tbackend.TorchBackend, "run_gang", boom)
    monkeypatch.setattr(TorchSchedulingAlgorithm, "on_card", True)
    sides, gangs = _gang_sides(_gang_spec("Required"), False)
    side, (group, members) = sides[1], gangs[1]
    with pytest.raises(RuntimeError, match="K5 launch failed"):
        PodGroupCycle(side.snapshot, side.fw, side.algo, side.names).schedule_pod_group(
            group.meta.key, [SimpleNamespace(pod=p) for p in members])
    assert side.backend.gang_errors == 1
    assert "K5 launch failed" in side.backend.gang_last_error
    assert (side.algo.kernel_count, side.algo.fallback_count) == (0, 0)
    assert side.gang_totals() == {}
    assert not any(ni.pods for ni in side.snapshot.list_nodes())
