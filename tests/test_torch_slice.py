"""The slice as a whole: waves through the reference TPUBackend.run_batched
(signature dedup on, its default) and through the port's
TorchBackend.run_batched on the CPU give the same bindings and leave the
seeded rng in the same state. Plus the port's import and device rules: it
runs with jax absent, imports nothing of jax or kubernetes_tpu, and never
falls back to the CPU unasked."""

import ast
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops.planes import FallbackNeeded
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu import backend as tbackend
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing.mixed import build_nodes, build_pods, mixed_spec
from kubernetes_tpu_torch.testing import wrappers as tw

REPO = Path(__file__).resolve().parent.parent

RTC_DECREASING = {"NodeResourcesFit": {
    "strategy": "RequestedToCapacityRatio",
    "shape": [[0, 100], [50, 20], [100, 0]]}}


def _drive(backend, cache, snap, waves, pad_to, seed):
    """run_batched wave by wave, assuming winners between waves (as the
    scheduling loop does); returns (bindings, final rng state)."""
    rng = random.Random(seed)
    out = []
    for wave in waves:
        got, _ = backend.run_batched(wave, snap, rng=rng, pad_to=pad_to)
        for pod, node in zip(wave, got):
            if node is not None:
                cache.assume_pod(pod, node)
        cache.update_snapshot(snap)
        out.append(got)
    return out, rng.getstate()


def _waves(pods, size):
    return [pods[i: i + size] for i in range(0, len(pods), size)]


def _basic_reference(n_nodes, n_pods):
    from kubernetes_tpu.testing.wrappers import make_node, make_pod

    names = JNames()
    cache = JCache(names)
    for i in range(n_nodes):
        cache.add_node(make_node(f"node-{i}", zone=f"zone-{i % 8}"))
    pods = [make_pod(f"pod-{i}", cpu="100m", mem="50Mi", labels={"app": "perf"},
                     image="registry.k8s.io/pause:3.10") for i in range(n_pods)]
    return names, cache, pods


def _basic_port(n_nodes, n_pods):
    names = TNames()
    cache = TCache(names)
    for i in range(n_nodes):
        cache.add_node(tw.scheduling_basic_node(i))
    return names, cache, [tw.scheduling_basic_pod(i) for i in range(n_pods)]


def _mixed(spec, names_cls, cache_cls, types, meta):
    names = names_cls()
    cache = cache_cls(names)
    for n in build_nodes(spec, types, meta):
        cache.add_node(n)
    return names, cache, build_pods(spec, types, meta)


SLICES = {
    # name: (cluster kind, plugin args, wave size, pad_to, seed)
    "scheduling-basic": ("basic", None, 16, 16, 11),
    "mixed-least": ("mixed", None, 12, 16, 12),
    "mixed-most": ("mixed", {"NodeResourcesFit": {"strategy": "MostAllocated"}}, 12, 16, 13),
    "mixed-rtc-decreasing": ("mixed", RTC_DECREASING, 12, 16, 14),
}


@pytest.mark.parametrize("case", list(SLICES))
def test_run_batched_matches_reference_backend(case):
    kind, pa, size, pad_to, seed = SLICES[case]
    # <= 32 nodes keeps every hostname-key domain count below 35, away from
    # the points where the reference kernel's log weight differs (C1)
    if kind == "basic":
        jn, jc, jpods = _basic_reference(24, 64)
        tn, tc, tpods = _basic_port(24, 64)
    else:
        spec = mixed_spec(seed, 32, 60)
        jn, jc, jpods = _mixed(spec, JNames, JCache, jtypes, jmeta)
        tn, tc, tpods = _mixed(spec, TNames, TCache, ttypes, tmeta)
    js, ts = JSnapshot(), TSnapshot()
    jc.update_snapshot(js)
    tc.update_snapshot(ts)
    jb = TPUBackend(jn, plugin_args=pa)
    tb = TorchBackend(tn, plugin_args=pa, device="cpu")
    # both run their default tier: signature dedup on
    assert jb.dedup_enabled and tb.dedup_enabled
    want = _drive(jb, jc, js, _waves(jpods, size), pad_to, seed)
    got = _drive(tb, tc, ts, _waves(tpods, size), pad_to, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # later waves repair the device mirror by row scatter (a full put again
    # only where a new vocab entry reshaped the buckets)
    assert tb.upload_stats["full"] >= 1 and tb.upload_stats["scatter"] >= 2
    assert tb.dedup_stats["waves"] == len(want[0])


def test_imports_and_schedules_without_jax():
    """(d) with jax and the reference package made unimportable, the port
    imports (the host tier's modules too), schedules a wave, runs one
    single-pod cycle on the kernel route and one on the hybrid route,
    places one gang through PodGroupCycle's device wave (try_gang_wave)
    and schedules a wave on a 4-shard mesh context on the CPU."""
    code = (
        "import sys, random\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kubernetes_tpu'] = None\n"
        "from kubernetes_tpu_torch.api.resource import ResourceNames\n"
        "from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot\n"
        "from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend\n"
        "from kubernetes_tpu_torch.testing.wrappers import (\n"
        "    make_node, scheduling_basic_node, scheduling_basic_pod)\n"
        "import kubernetes_tpu_torch.ops.cuda\n"
        "import kubernetes_tpu_torch.scheduler.framework.events\n"
        "import kubernetes_tpu_torch.scheduler.plugins.registry\n"
        "import kubernetes_tpu_torch.utils.clock, kubernetes_tpu_torch.utils.envknob\n"
        "c = Cache(ResourceNames())\n"
        "[c.add_node(scheduling_basic_node(i)) for i in range(16)]\n"
        "s = Snapshot(); c.update_snapshot(s)\n"
        "b = TorchBackend(c.names, device='cpu')\n"
        "got, _ = b.run_batched([scheduling_basic_pod(i) for i in range(8)], s,\n"
        "                       rng=random.Random(0), pad_to=16)\n"
        "assert all(got), got\n"
        "from kubernetes_tpu_torch.scheduler.framework import CycleState, Framework\n"
        "from kubernetes_tpu_torch.scheduler.plugins import DEFAULT_WEIGHTS, default_plugins\n"
        "from kubernetes_tpu_torch.scheduler.queue import Nominator\n"
        "from kubernetes_tpu_torch.scheduler.tpu.backend import TorchSchedulingAlgorithm\n"
        "from kubernetes_tpu_torch.testing.wrappers import topology_spreading_pod\n"
        "dfw = Framework(default_plugins(c.names), DEFAULT_WEIGHTS)\n"
        "algo = TorchSchedulingAlgorithm(dfw, b, nominator=Nominator())\n"
        "r = algo.schedule_pod(CycleState(), topology_spreading_pod(0), s)\n"
        "assert r.suggested_host and r.feasible_nodes == 16, r\n"
        "ndf = scheduling_basic_pod(99)\n"
        "ndf.meta.annotations['features.k8s.io/required'] = 'NUMAAlignment'\n"
        "c.add_node(make_node('featured', declared_features=('NUMAAlignment',)))\n"
        "c.update_snapshot(s)\n"
        "r = algo.schedule_pod(CycleState(), ndf, s)\n"
        "assert r.suggested_host == 'featured' and algo.kernel_count == 2, r\n"
        "from kubernetes_tpu_torch.scheduler.schedule_one import PodGroupCycle\n"
        "from types import SimpleNamespace\n"
        "import kubernetes_tpu_torch.api.meta as M, kubernetes_tpu_torch.api.types as T\n"
        "from kubernetes_tpu_torch.scheduler.framework import Framework, Handle\n"
        "from kubernetes_tpu_torch.scheduler.plugins.topology_placement import (\n"
        "    TopologyPlacementGenerator)\n"
        "from kubernetes_tpu_torch.scheduler.tpu.gangplanner import try_gang_wave\n"
        "from kubernetes_tpu_torch.testing.mixed import build_gangs, perf_gang_spec\n"
        "h = Handle(cache=c, snapshot=s)\n"
        "fw = Framework([TopologyPlacementGenerator()], handle=h)\n"
        "group, members = build_gangs(perf_gang_spec(0, 8, 1, 4, 'Required'), T, M)[0]\n"
        "h.store.add(group)\n"
        "out = PodGroupCycle(s, fw, TorchSchedulingAlgorithm(fw, b), c.names).schedule_pod_group(\n"
        "    group.meta.key, [SimpleNamespace(pod=p) for p in members])\n"
        "assert out[0] == 'success', out\n"
        "hosts = [r.suggested_host for _q, _st, r, _pi in out[1]]\n"
        "assert len({int(n.split('-')[1]) % 8 for n in hosts}) == 1, hosts\n"
        "assert b.recorder.gang_pod_totals == {'device': 4}, b.recorder.gang_pod_totals\n"
        "from kubernetes_tpu_torch.parallel import MeshContext, scheduler_mesh\n"
        "m = TorchBackend(c.names, device='cpu', context=MeshContext(scheduler_mesh(4, device='cpu')))\n"
        "got4, _ = m.run_batched([scheduling_basic_pod(100 + i) for i in range(8)], s,\n"
        "                        rng=random.Random(0), pad_to=16)\n"
        "assert all(got4), got4\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'kubernetes_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('placed', len(got))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "placed 8" in r.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference_package():
    """(e) an AST scan of every module of the port and of chip_smoke.py."""
    files = sorted((REPO / "kubernetes_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert REPO / "kubernetes_tpu_torch" / "parallel" / "mesh.py" in files
    bad = []
    for f in files:
        for mod in _imported_roots(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "kubernetes_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_backend_needs_a_card_unless_cpu_is_asked(monkeypatch):
    """(f) no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(TNames())
    with pytest.raises(RuntimeError):
        TorchBackend(TNames(), device="cuda")
    assert TorchBackend(TNames(), device="cpu").device.type == "cpu"


def _small_port_cluster():
    names, cache, _ = _basic_port(8, 0)
    snap = TSnapshot()
    cache.update_snapshot(snap)
    return names, snap


def test_out_of_slice_waves_raise():
    """Hard spread and inter-pod affinity pods, which earlier slices
    refused, now schedule through the port's wave (dedup on) exactly as
    through the reference's; cross-wave reuse (on by default) leaves the
    serial run_batched unchained and a pod the reference sends to its host
    path raises FallbackNeeded."""
    from kubernetes_tpu.api.labels import LabelSelector as JSel
    from kubernetes_tpu_torch.api.labels import LabelSelector as TSel

    def pods(types, sel, w):
        hard = types.Pod(
            meta=(jmeta if types is jtypes else tmeta).ObjectMeta(
                name=f"h{w}", namespace="default", labels={"app": "x"}),
            spec=types.PodSpec(containers=[types.Container(
                name="c", requests={"cpu": "100m"})],
                topology_spread_constraints=(types.TopologySpreadConstraint(
                    1, "topology.kubernetes.io/zone", "DoNotSchedule",
                    sel.of({"app": "x"})),)))
        ipa = types.Pod(
            meta=(jmeta if types is jtypes else tmeta).ObjectMeta(
                name=f"i{w}", namespace="default", labels={"app": "y"}),
            spec=types.PodSpec(
                containers=[types.Container(name="c", requests={"cpu": "100m"})],
                affinity=types.Affinity(pod_anti_affinity=types.PodAntiAffinity(
                    required=(types.PodAffinityTerm(
                        label_selector=sel.of({"app": "y"}),
                        topology_key="kubernetes.io/hostname"),)))))
        return [hard, ipa]

    jn, jc, _ = _basic_reference(8, 0)
    tn, tc, _ = _basic_port(8, 0)
    js, ts = JSnapshot(), TSnapshot()
    jc.update_snapshot(js)
    tc.update_snapshot(ts)
    want = _drive(TPUBackend(jn), jc, js, [pods(jtypes, JSel, w) for w in (0, 1)], 4, 9)
    got = _drive(TorchBackend(tn, device="cpu"), tc, ts,
                 [pods(ttypes, TSel, w) for w in (0, 1)], 4, 9)
    assert got == want and all(all(w) for w in got[0])
    names, snap = _small_port_cluster()
    b2 = TorchBackend(names, device="cpu")
    assert b2.cross_wave_enabled
    for i in range(2):
        b2.run_batched([tw.make_pod(f"d{i}", cpu="100m")], snap)
    assert b2._carry is None and b2.sig_cache.table is None
    assert b2.dedup_stats["xwave_hits"] == b2.dedup_stats["xwave_misses"] == 0
    port = tw.make_pod("p", cpu="100m")
    port.spec.containers[0] = ttypes.Container(
        name="c", requests={"cpu": "100m"},
        ports=(ttypes.ContainerPort(80, host_port=80, host_ip="10.0.0.1"),))
    with pytest.raises(FallbackNeeded, match="hostIP"):
        TorchBackend(names, device="cpu").run_batched([port], snap)


def test_tie_overflow_discards_the_wave(monkeypatch):
    """An exhausted tie draw raises FallbackNeeded and leaves the rng as it
    was, as the reference backend does."""
    names, cache, pods = _basic_port(8, 4)
    snap = TSnapshot()
    cache.update_snapshot(snap)
    b = TorchBackend(names, device="cpu")
    import numpy as np

    monkeypatch.setattr(tbackend, "clone_tie_words",
                        lambda rng, n: np.full(n, 0xFFFFFFFF, np.uint32))
    rng = random.Random(5)
    state = rng.getstate()
    with pytest.raises(FallbackNeeded, match="overflow"):
        b.run_batched(pods, snap, rng=rng)
    assert rng.getstate() == state
