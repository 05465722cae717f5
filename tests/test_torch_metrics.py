"""The port's metrics registry, SchedulerMetrics and their wiring, held
against the reference package.

- utils/metrics.py and scheduler/metrics.py are copies: one observation
  script through both packages' SchedulerMetrics exposes the same text.
- Framework._timed samples about one plugin call in ten with the
  reference's LCG, and times every call for an installed observer: the
  same call sequence samples the same calls in both packages.
- On a hybrid-route workload (NodeDeclaredFeatures pods: K4 and the host
  tail) both packages' Schedulers observe the same count per (extension
  point, plugin): the port's Framework calls its plugins in the
  reference's order. This count is what chip_smoke phase 26 (b) scales
  into the host tail's split by plugin.
- The dispatcher's metrics, api spans and retry counts, the event
  recorder's counters, the queue gauges and the wave controller's opt-in
  latency guard.
"""

from __future__ import annotations

import random
import threading

import pytest

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.scheduler.metrics as jmetrics
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.scheduler.metrics as tmetrics
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler.framework.runtime import Framework as JFramework
from kubernetes_tpu.scheduler.tpu.wavecontroller import WaveSizeController as JWSC
from kubernetes_tpu.store import Store as JStore
from kubernetes_tpu_torch.scheduler.api_dispatcher import APICall, APIDispatcher
from kubernetes_tpu_torch.scheduler.framework.runtime import Framework as TFramework
from kubernetes_tpu_torch.scheduler.metrics import MetricsAsyncRecorder, SchedulerMetrics
from kubernetes_tpu_torch.scheduler.plugins.node_declared_features import (
    REQUIRED_FEATURES_ANNOTATION,
)
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.scheduler.tpu.wavecontroller import WaveSizeController
from kubernetes_tpu_torch.scheduler.tpu.waverecorder import WaveRecorder
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils.backoff import RetryPolicy
from kubernetes_tpu_torch.utils.metrics import DEF_BUCKETS, Registry
from kubernetes_tpu_torch.utils.tracing import InMemoryExporter, Tracer
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

FEATURE = "NUMAAlignment"


# ------------------------------------------------------------ the registry


def test_registry_counter_gauge_histogram():
    r = Registry()
    c = r.counter("c_total", "a counter", labels=("k",))
    assert r.counter("c_total") is c  # register returns the existing one
    c.inc("a")
    c.inc("a", by=2.0)
    assert c.get("a") == 3.0 and c.get("b") == 0.0
    with pytest.raises(ValueError):
        c.inc()
    g = r.gauge("g", labels=())
    g.set(5.0)
    g.dec()
    assert g.get() == 4.0
    h = r.histogram("h_seconds", labels=("p",))
    for v in (0.0005, 0.003, 0.003, 0.1):
        h.observe(v, "x")
    assert h.count("x") == 4 and h.average("x") == pytest.approx(0.1065 / 4)
    assert 0.002 <= h.percentile(0.5, "x") <= 0.004
    assert h.percentile(0.5, "missing") == 0.0
    text = r.expose()
    assert '# TYPE h_seconds histogram' in text
    assert 'h_seconds_bucket{p="x",le="+Inf"} 4' in text
    assert 'c_total{k="a"} 3.0' in text
    assert len(DEF_BUCKETS) == 15


def _observation_script(mod, monkeypatch):
    """One fixed sequence of facade calls on a frozen clock."""
    monkeypatch.setattr(mod.time, "time", lambda: 100.0)
    m = mod.SchedulerMetrics()
    qpi = lambda key, plugins=(): type("Q", (), {  # noqa: E731
        "pod": type("P", (), {"meta": type("M", (), {"key": key})()})(),
        "unschedulable_plugins": set(plugins)})()
    for i in range(5):
        m.observe_plugin("Filter", "NodeResourcesFit", 0.001 * i)
        m.observe_plugin("Score", "TaintToleration", 0.0005 * i)
        m.observe_extension_point("Filter", i % 2 == 0, 0.002 * i)
    m.pod_unschedulable(qpi("default/a", ("NodeResourcesFit",)))
    m.pod_unschedulable(qpi("default/a", ("NodeResourcesFit",)))
    m.pod_scheduled(qpi("default/a"))
    m.pod_scheduled(qpi("default/b"))
    m.pod_error(qpi("default/c"))
    m.forget_pod("default/c")
    m.update_queue_gauges(3, 1, 2)
    m.update_cache_gauges(10, 20, 1)
    m.gang_pods("device", 4)
    m.breaker_transition("closed", "open")
    m.slow_wave_captured()
    m.partition_detected("Pod", 0.01)
    m.event_recorded(False)
    m.event_recorded(True)
    m.events_pruned(2)
    m.update_sli_quantiles()
    return m.expose()


def test_facade_exposes_what_the_reference_exposes(monkeypatch):
    got = _observation_script(tmetrics, monkeypatch)
    want = _observation_script(jmetrics, monkeypatch)
    # the device series' help text names the port's kernels: every other
    # line (types, samples) is the reference's
    samples = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                            if not ln.startswith("# HELP")]
    assert samples(got) == samples(want)
    assert 'scheduler_schedule_attempts_total{result="scheduled",' in got


def test_wave_series_equal_the_reference():
    from kubernetes_tpu.scheduler.tpu.flightrecorder import WaveRecord as JRecord
    from kubernetes_tpu_torch.scheduler.tpu.waverecorder import WaveRecord as TRecord

    def land(mod, rec_cls):
        rec = rec_cls(wave_id=1, started_at=0.0, pods=30, pad=32)
        rec.duration_s = 0.125
        rec.signatures, rec.clones = 3, 27
        rec.distinct_signature_ratio = 0.1
        rec.phases = {"kernel": 0.1, "bind": 0.02}
        rec.xwave_hits, rec.xwave_misses, rec.xwave_evictions = 2, 1, 1
        rec.fallback_reason = "injected: tpu.collect"
        rec.upload_bytes, rec.fetch_bytes = 4096, 64
        m = mod.SchedulerMetrics()
        m.wave_completed(rec)
        return m.expose()

    assert [f for f in TRecord.__dataclass_fields__] == \
        [f for f in JRecord.__dataclass_fields__]
    samples = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                            if not ln.startswith("# HELP")]
    assert samples(land(tmetrics, TRecord)) == samples(land(jmetrics, JRecord))


def test_async_recorder_flushes_into_the_facade():
    m = SchedulerMetrics()
    r = MetricsAsyncRecorder(m, interval=0.01)
    r.run()
    for _ in range(3):
        r.observe_plugin_duration_async("Filter", "NodeName", 0.001)
    r.stop()
    assert m.plugin_execution_duration.count("NodeName", "Filter") == 3


# ------------------------------------------------------- Framework._timed


class _Plugin:
    def __init__(self, name):
        self.name = name


@pytest.mark.parametrize("calls", [10, 97, 1000])
def test_timed_samples_the_reference_calls(calls):
    """The same call sequence: the same sampled calls (the LCG state is
    per framework and starts at 1 in both)."""
    counts = []
    for fw_cls, mod in ((TFramework, tmetrics), (JFramework, jmetrics)):
        fw = fw_cls([], metrics=mod.SchedulerMetrics())
        sampled = []
        for i in range(calls):
            name = f"p{i % 7}"
            before = fw.metrics.plugin_execution_duration.count(name, "Filter")
            assert fw._timed("Filter", name, lambda i=i: i * 2) == i * 2
            sampled.append(fw.metrics.plugin_execution_duration.count(name, "Filter")
                           > before)
        counts.append(sampled)
    assert counts[0] == counts[1]
    assert 0 < sum(counts[0]) < calls or calls < 20


def test_timed_observer_times_every_call_and_plain_without_metrics():
    fw = TFramework([])
    assert fw._timed("Filter", "x", lambda: 7) == 7  # no metrics: plain call
    seen = []
    fw.plugin_observer = lambda point, plugin, dt: seen.append((point, plugin))
    for _ in range(4):
        fw._timed("Score", "y", lambda: None)
    assert seen == [("Score", "y")] * 4
    with pytest.raises(RuntimeError):
        fw._timed("Filter", "z", lambda: (_ for _ in ()).throw(RuntimeError("x")))
    assert seen[-1] == ("Filter", "z")  # timed even when the plugin raises


# ---------------------------------- per-plugin observations, port == reference


def _ndf_run(pkg, seed=3, nodes=24, pods=30):
    """A hybrid-route stream: half the nodes declare FEATURE, two thirds
    of the pods require it (K4 + the host tail), the rest ride waves."""
    w, types, Store, Scheduler, Profile, mod = (
        (tw, ttypes, TStore, TScheduler, TProfile, tmetrics) if pkg == "port"
        else (jw, jtypes, JStore, JScheduler, JProfile, jmetrics))
    store = Store()
    for i in range(nodes):
        n = w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 3}")
        if i % 2:
            n.status.declared_features = (FEATURE,)
        store.create(n)
    kw = {"device": "cpu"} if pkg == "port" else {}
    s = Scheduler(store, profiles=[Profile(backend="tpu", wave_size=8)], seed=seed,
                  metrics=mod.SchedulerMetrics(), **kw)
    s.start()
    for i in range(pods):
        p = w.make_pod(f"p{i:02d}", cpu="500m", mem="512Mi")
        if i % 3:
            p.meta.annotations[REQUIRED_FEATURES_ANNOTATION] = FEATURE
        store.create(p)
    s.schedule_pending()
    placed = {p.meta.name: p.spec.node_name for p in store.pods()}
    counts = {k: st.count for k, st in s.metrics.plugin_execution_duration.values.items()}
    return placed, s.algorithms["default-scheduler"].rng.getstate(), counts, s


def test_plugin_observation_counts_equal_the_reference():
    got = _ndf_run("port")
    want = _ndf_run("jax")
    assert got[0] == want[0] and got[1] == want[1]
    assert all(got[0].values())
    assert got[2] == want[2]
    assert ("NodeDeclaredFeatures", "Filter") in got[2]
    # the hybrid route ran on K4's feasible nodes: its filter calls dwarf
    # the per-pod plugins'
    assert got[3].algorithms["default-scheduler"].kernel_count > 0


# ----------------------------------------------------- dispatcher, events


def test_dispatcher_metrics_spans_and_retries():
    m = SchedulerMetrics()
    exporter = InMemoryExporter()
    rec = WaveRecorder()
    d = APIDispatcher(2, metrics=m, tracer=Tracer("api", exporter), recorder=rec,
                      retry_policy=RetryPolicy(max_attempts=4, base_s=0.0, cap_s=0.0,
                                               retryable=(RuntimeError,)))
    d.run()
    fails = {"n": 2}

    def flaky():
        if fails["n"]:
            fails["n"] -= 1
            raise RuntimeError("transient")

    done = threading.Event()
    call = APICall("binding", "default/p0", flaky,
                   on_finish=lambda err: done.set())
    d.add(call)
    assert done.wait(5.0) and call.error is None
    d.close()
    assert rec.retries_total == 2
    assert m.async_api_calls.get("binding", "success") == 1.0
    assert m.async_api_retries.count("binding") == 1
    assert m.async_api_pending.get() == 0.0
    spans = exporter.find("api/binding")
    assert spans and spans[0].attributes["object_key"] == "default/p0"


def test_event_recorder_metrics_wired_by_the_scheduler():
    store = TStore()
    store.create(tw.make_node("n0", cpu="4", mem="8Gi"))
    s = TScheduler(store, profiles=[TProfile(wave_size=8)], device="cpu",
                   metrics=SchedulerMetrics())
    assert s.event_recorder.metrics is s.metrics
    s.start()
    for i in range(3):
        store.create(tw.make_pod(f"p{i}", cpu="1", mem="1Gi"))
    s.schedule_pending()
    s.event_recorder.flush()
    assert s.metrics.events_total.get("recorded") >= 3.0
    assert s.metrics.schedule_attempts.get("scheduled", "default-scheduler") == 3.0
    assert s.metrics.pending_pods.get("active") == 0.0


# --------------------------------------------------- the wave controller


def test_latency_guard_is_off_by_default_and_equals_the_reference():
    assert WaveSizeController().latency_budget_s is None
    durations = [0.5, 0.5, 0.01, 0.01, 0.01, 0.9, 0.01]
    for budget in (None, 0.1):
        port, ref = WaveSizeController(latency_budget_s=budget), JWSC(
            min_pods=8, max_pods=0, latency_budget_s=budget)
        sizes = []
        for d in durations:
            port.observe(d)
            ref.observe(d)
            sizes.append((port.next_size(500, cap=512), ref.next_size(500, cap=512),
                          port.last_clipped, ref.last_clipped))
        assert all(a == b and c == e for a, b, c, e in sizes)
        assert port.snapshot() == ref.snapshot()
        if budget is None:
            assert {s[0] for s in sizes} == {512}
        else:
            assert min(s[0] for s in sizes) < 512
    clip = WaveSizeController()
    assert clip.next_size(1000, cap=64) == 64 and clip.last_clipped
    assert clip.next_size(3, cap=64) == 8 and not clip.last_clipped


def test_rng_untouched_by_sampling():
    """The LCG is the framework's own: the tie-break rng is not read."""
    fw = TFramework([], metrics=SchedulerMetrics())
    state = random.getstate()
    for i in range(50):
        fw._timed("Filter", "p", lambda: None)
    assert random.getstate() == state
