"""The port's warm start (scheduler/tpu/warmup.py) against the reference's.

SchedulingBasic-shaped traffic (scheduler_perf's default pod on nodes of 32
CPU over 8 zones, cut to 24 nodes and waves of 16 at pipeline depth 2) runs
through four Schedulers on one store workload and seed: each package's
cold (warm_start=False) and warm one (the reference's persistent
compilation cache pointed at a temporary directory). Held, tolerance 0:

- the four bind every pod alike and leave the same rng state (warmup
  draws from its own throwaway stream and drops its carry);
- the warm port Scheduler's waves open no compile span afterwards
  (`compile_count_since_warm() == 0`, and no wave record has a
  `compile/` phase); the reference's leaves two (its label-less warm pods
  intern a spread selector these labelled pods never use, so the first
  wave grows the selector bucket: the port's warm pods take a pending
  pod's namespace and labels; and its warmup chains the first round of
  every bucket past the first on the previous bucket's carry, which
  leaves the cold-carry launch at the wave size unwarmed: the port's drops
  the carry before each bucket);
- the summaries' buckets, scatter row buckets and gang shapes equal the
  reference's; the K3 warmup leaves the device planes byte-identical;
- a bucket the configuration refuses (OutOfSlice) is recorded in
  `skipped`, any other error raises out of `start()`; an empty cluster is
  marked warm with nothing launched; DeviceTelemetry's warm hooks.
"""

from __future__ import annotations

import jax
import pytest
import torch

import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.ops.kernels import OutOfSlice
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.tpu import warmup
from kubernetes_tpu_torch.scheduler.tpu.devicetelemetry import DeviceTelemetry
from kubernetes_tpu_torch.store import Store as TStore
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

NODES, INIT, WAVES, WAVE = 24, 32, 10, 16


def sb_pod(w, i):
    """scheduler_perf's pod-default.yaml in either package's types."""
    return w.make_pod(f"pod-{i}", cpu="100m", mem="50Mi", labels={"app": "perf"},
                      image="registry.k8s.io/pause:3.10")


def fill(w, store, nodes=NODES, init=INIT):
    for i in range(nodes):
        store.create(w.make_node(f"node-{i}", zone=f"zone-{i % 8}"))
    for i in range(init):
        store.create(sb_pod(w, i))


def measured(w, store, sched):
    """WAVES waves of SchedulingBasic pods after the initial ones; returns
    the bindings."""
    for i in range(WAVES * WAVE):
        store.create(sb_pod(w, INIT + i))
    sched.schedule_pending()
    return {p.meta.name: p.spec.node_name for p in store.pods()}


@pytest.fixture
def ref_cache(tmp_path, monkeypatch):
    """The reference's warm start enables a persistent compilation cache:
    point it at tmp_path, and give the process its own setting back after."""
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("KUBERNETES_TPU_JAX_CACHE", str(tmp_path))
    yield tmp_path
    jax.config.update("jax_compilation_cache_dir", before[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])


def port_run(warm, wave=WAVE, nodes=NODES, init=INIT):
    store = TStore()
    fill(tw, store, nodes, init)
    s = TScheduler(store, profiles=[TProfile(wave_size=wave)], seed=7, device="cpu",
                   warm_start=warm)
    s.start()
    return store, s


def test_warm_equals_cold_and_the_reference_warm(ref_cache, monkeypatch):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    out = {}
    for label, warm in (("cold", False), ("warm", True)):
        store, s = port_run(warm)
        rng_after_start = s.algorithms["default-scheduler"].rng.getstate()
        s.schedule_pending()
        tele = s.flight_recorder.device_telemetry
        base = tele.compile_count_since_warm()
        first = len(s.flight_recorder.records())
        bound = measured(tw, store, s)
        out[label] = {"bound": bound,
                      "rng": s.algorithms["default-scheduler"].rng.getstate(),
                      "start_rng": rng_after_start, "s": s,
                      "since": (base, tele.compile_count_since_warm()),
                      "records": s.flight_recorder.records()[first:]}
    jout = {}
    for warm in (False, True):
        jstore = JStore()
        fill(jw, jstore)
        js = JScheduler(jstore, profiles=[JProfile(backend="tpu", wave_size=WAVE)], seed=7,
                        warm_start=warm)
        js.start()
        js.schedule_pending()
        jtele = js.flight_recorder.device_telemetry
        jbase = jtele.compile_count_since_warm()
        jout[warm] = (measured(jw, jstore, js), js.algorithms["default-scheduler"].rng.getstate())
    jbound = jout[True][0]

    cold, warm = out["cold"], out["warm"]
    assert len(cold["bound"]) == INIT + WAVES * WAVE and all(cold["bound"].values())
    # each equals the reference's Scheduler with the same warm_start
    assert cold["bound"] == jout[False][0] and cold["rng"] == jout[False][1]
    assert warm["bound"] == jbound and warm["rng"] == jout[True][1]
    assert warm["bound"] == cold["bound"] and warm["rng"] == cold["rng"]
    # start() draws nothing from the live rng, warm or cold
    assert warm["start_rng"] == cold["start_rng"]
    # no first use left after the warm start: no compile span opens
    assert warm["since"] == (0, 0)
    assert len(warm["records"]) >= WAVES
    for rec in warm["records"]:
        assert not [k for k in rec.phases if k.startswith("compile/")], rec.phases
    # the cold Scheduler pays its first uses in the waves
    assert cold["since"][1] > 0
    # the reference's warm start leaves first uses to these waves (see the
    # module docstring): its label-less warm pods intern a selector the
    # `app: perf` pods do not, so their first wave grows the selector
    # bucket and launches cold and chained at plane shapes never warmed
    assert (jbase, jtele.compile_count_since_warm()) == (2, 2)
    # the walk: the same buckets, scatter row buckets and gang shapes
    (summary,) = warm["s"].warmup_summaries
    from kubernetes_tpu.scheduler.tpu.warmup import warm_backend as jwarm

    jstore2 = JStore()
    fill(jw, jstore2)
    js2 = JScheduler(jstore2, profiles=[JProfile(backend="tpu", wave_size=WAVE)], seed=7)
    js2.start()
    js2.cache.update_snapshot(js2.snapshot)
    jsum = jwarm(js2.algorithms["default-scheduler"].backend, js2.snapshot, WAVE)
    for k in ("buckets", "scatter", "gangs", "skipped"):
        assert summary[k] == jsum[k], k
    assert summary["buckets"] == [8, 16] and summary["scatter"] == [8, 16, 32]
    assert summary["cache_dir"] is None  # nothing is built on the CPU
    assert summary["compiles"] > 0
    fr = warm["s"].flight_recorder
    assert fr.phase_totals["warmup"] > 0


def test_warm_scatter_leaves_the_mirror_byte_identical():
    store, s = port_run(False)
    s.schedule_pending()
    backend = s.algorithms["default-scheduler"].backend
    s.cache.update_snapshot(s.snapshot)
    backend.device_inputs(backend.sync(s.snapshot))
    before = {k: v.clone() for k, v in backend._device_planes.items()}
    summary = {"scatter": [], "skipped": []}
    warmup._warm_scatter(backend, s.snapshot, 64, summary)
    assert summary == {"scatter": [8, 16, 32, 64, 128], "skipped": []}
    for k, v in backend._device_planes.items():
        assert torch.equal(v, before[k]), k
    keys = {sig[2] for kern, sig in backend.telemetry._compiled if kern == "scatter_rows"}
    assert keys >= {8, 16, 32, 64, 128}


def test_warm_wave_size_zero_and_gang_shapes(monkeypatch):
    """wave_size 0 (the per-pod cycle) warms the floor bucket; a gang shape
    with constrained domains runs K1 + K5 at its row count."""
    store, s = port_run(False, wave=0)
    s.cache.update_snapshot(s.snapshot)
    backend = s.algorithms["default-scheduler"].backend
    summary = warmup.warm_backend(backend, s.snapshot, 0,
                                  gang_shapes=((4, 0, True), (3, 2, False)))
    assert summary["buckets"] == [8]
    assert summary["scatter"] == [8]
    assert summary["gangs"] == [(4, 0, True), (3, 2, False)]
    assert summary["skipped"] == []
    assert backend._carry is None
    assert backend.telemetry.compile_count_since_warm() == 0


def test_out_of_slice_is_skipped_other_errors_raise(monkeypatch):
    from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend

    real = TorchBackend.launch_batched

    def refuse_16(self, pods, snapshot, rng=None, pad_to=0):
        if pad_to == 16:
            raise OutOfSlice("bucket 16 refused")
        return real(self, pods, snapshot, rng=rng, pad_to=pad_to)

    monkeypatch.setattr(TorchBackend, "launch_batched", refuse_16)
    store, s = port_run(True)
    (summary,) = s.warmup_summaries
    assert summary["buckets"] == [8]
    assert summary["skipped"] == ["wave16: bucket 16 refused"]

    def broken(self, pod, snapshot):
        raise RuntimeError("fit_and_score launch failed: CUDA error 700")

    monkeypatch.setattr(TorchBackend, "run", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        port_run(True)


def test_empty_cluster_is_marked_warm():
    store = TStore()
    s = TScheduler(store, profiles=[TProfile(wave_size=8)], device="cpu", warm_start=True)
    s.start()
    (summary,) = s.warmup_summaries
    assert summary["skipped"] == ["no nodes in snapshot"]
    assert summary["buckets"] == summary["scatter"] == summary["gangs"] == []
    assert s.flight_recorder.device_telemetry.compile_count() == 0


def test_device_telemetry_warm_hooks():
    tele = DeviceTelemetry()
    with tele.compile_span("k", ("a",)):
        pass
    assert tele.compile_count() == 1
    assert tele.compile_count_since_warm() == 1
    tele.mark_warm()
    assert tele.compile_count_since_warm() == 0
    with tele.compile_span("k", ("a",)):  # seen: no first use
        pass
    assert tele.compile_count_since_warm() == 0
    with tele.compile_span("k", ("b",)):
        pass
    assert tele.compile_count_since_warm() == 1


def test_warm_start_over_an_empty_backlog(ref_cache, monkeypatch):
    """A warm start with no pending pod has no shape to give its warm pods:
    they are the reference's label-less pods in `default`. It binds as a
    cold start does and as the reference's warm start over the same empty
    backlog does. The `app: perf` traffic that arrives after start() grows
    the spread selector bucket, where the reference's warm start leaves
    first uses (ROADMAP C16); the port's warmup also launched at that
    bucket, so the traffic meets none."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    out = {}
    for warm in (False, True):
        store, s = port_run(warm, init=0)
        (summary,) = s.warmup_summaries if warm else (None,)
        tele = s.flight_recorder.device_telemetry
        out[warm] = (measured(tw, store, s), s.algorithms["default-scheduler"].rng.getstate(),
                     tele.compile_count_since_warm(), summary)
    jstore = JStore()
    fill(jw, jstore, init=0)
    js = JScheduler(jstore, profiles=[JProfile(backend="tpu", wave_size=WAVE)], seed=7,
                    warm_start=True)
    js.start()
    jbound = measured(jw, jstore, js)
    jsince = js.flight_recorder.device_telemetry.compile_count_since_warm()
    bound, rng, since, summary = out[True]
    assert len(bound) == WAVES * WAVE and all(bound.values())
    assert (bound, rng) == out[False][:2]
    assert bound == jbound and rng == js.algorithms["default-scheduler"].rng.getstate()
    assert summary["skipped"] == [] and summary["buckets"] == [8, 16]
    assert since == 0, since
    assert jsince > 0
    assert summary["grown_selectors"]["S"] == 2
    assert summary["grown_selectors"]["buckets"] == [8, 16]
