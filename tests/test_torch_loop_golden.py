"""The golden triple of the store-driven loop, port against reference.

tests/test_pipeline_golden.py holds the reference's loop to one binding
stream whatever its mode: pipelined (KUBE_TPU_PIPELINE_DEPTH=2), serial
(depth 1) and dedup off give the same placements, the same
PodScheduled=False diagnoses and the same final tie-break rng state. Here
each mode of the port's Scheduler (device="cpu": the kernels' plain
versions) is held equal, exactly, to the same mode of the reference's
Scheduler on the same streamed bursts (the reference's mixed_pods, built
by kubernetes_tpu_torch.testing.mixed.burst_pods) for the reference's
configurations: basic bursts, the gang plugins registered with no
PodGroup, hard zone spread, the sharded-mesh shape (40 nodes, 4 zones),
and IPA-active waves with node churn between bursts on an 8-shard mesh
(the port's MeshContext: K6's plain version; the reference's over 8
virtual CPU devices).

Also from the reference's goldens, each equal to the reference:
- test_trip_drains_poisoned_successor: three injected tpu.collect flakes
  trip the breaker while a successor is in flight, and the trip drains it;
- tests/test_dedup_golden.py's BatchCache export (a wave exports each
  signature's score-ordered node list when OpportunisticBatching is on,
  nothing without the gate) and the breaker's cache lifecycle (a trip
  clears the resident signature rows, a close lets them re-warm).
"""

from __future__ import annotations

import pytest

from kubernetes_tpu.utils.faultinject import ERROR as JERROR
from kubernetes_tpu.utils.faultinject import FaultSpec as JFaultSpec
from kubernetes_tpu_torch.scheduler.tpu.circuitbreaker import CLOSED, OPEN
from kubernetes_tpu_torch.testing.mixed import burst_pods
from kubernetes_tpu_torch.utils.faultinject import ERROR as TERROR
from kubernetes_tpu_torch.utils.faultinject import FaultSpec as TFaultSpec
from tests.test_torch_loop import SIDES, _port_registry, outcome  # noqa: F401 (autouse)
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

MODES = {"piped": dict(depth=2, dedup=True), "serial": dict(depth=1, dedup=True),
         "nodedup": dict(depth=2, dedup=False)}

CONFIGS = {
    "basic": dict(),
    "gang_registered_absent": dict(gates={"GenericWorkload": True,
                                          "TopologyAwareWorkloadScheduling": True}),
    "hard_pts": dict(spread=True),
    "sharded_mesh_shape": dict(spread=True, nodes=40, zones=4,
                               bursts=((0, 30), (30, 60))),
    "ipa_churn_mesh8": dict(ipa=True, nodes=40, zones=4, mesh=8, churn_nodes=4,
                            bursts=((0, 30), (30, 60))),
}


def _run_stream(side, monkeypatch, depth, dedup=True, spread=False, ipa=False,
                nodes=6, zones=2, cpu="4", bursts=((0, 15), (15, 30), (30, 42)),
                mesh=0, churn_nodes=0, gates=None, wave_size=8, seed=11):
    """One streamed scenario (the reference's _run_stream): pods arrive in
    bursts, each drained by schedule_pending so the waves of a burst
    pipeline; churn_nodes fresh nodes join before every burst after the
    first. Returns (bindings, diagnoses, rng state, scheduler)."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", str(depth))
    if mesh:
        monkeypatch.setenv("KUBE_TPU_MESH_DEVICES", str(mesh))
    else:
        monkeypatch.delenv("KUBE_TPU_MESH_DEVICES", raising=False)
    w = side.w
    store = side.Store()
    for i in range(nodes):
        store.create(w.make_node(f"n{i}", cpu=cpu, mem="8Gi", zone=f"z{i % zones}"))
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=wave_size)],
                       seed=seed, feature_gates=gates or {}, **side.kw)
    backend = s.algorithms["default-scheduler"].backend
    backend.dedup_enabled = dedup
    assert backend._ctx.is_sharded == bool(mesh)
    s.start()
    assert s.loop.pipeline_depth == depth
    for k, (lo, hi) in enumerate(bursts):
        if k and churn_nodes:
            for j in range(churn_nodes):
                store.create(w.make_node(f"cn{k}-{j}", cpu=cpu, mem="8Gi",
                                         zone=f"z{j % zones}"))
        for p in burst_pods(w, lo, hi, spread=spread, ipa=ipa):
            store.create(p)
        s.schedule_pending()
    placed, diags, rng = outcome(store, s)
    return placed, diags, rng, s


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_golden_triple_matches_reference(config, mode, monkeypatch):
    kw = {**CONFIGS[config], **MODES[mode]}
    want = _run_stream(SIDES["jax"], monkeypatch, **kw)
    got = _run_stream(SIDES["port"], monkeypatch, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    placed, diags, _, s = got
    assert sum(1 for v in placed.values() if v) > 0
    if config == "basic":
        assert diags, "some pods must fail with a diagnosis"
    if config == "sharded_mesh_shape":
        assert sum(1 for v in placed.values() if v) == 60
    backend = s.algorithms["default-scheduler"].backend
    jbackend = want[3].algorithms["default-scheduler"].backend
    assert backend.dedup_stats == jbackend.dedup_stats
    if MODES[mode]["dedup"]:
        assert 0 < backend.dedup_stats["signatures"] < backend.dedup_stats["pods"]
    else:
        assert backend.dedup_stats["waves"] == 0
    if config == "ipa_churn_mesh8":
        assert backend._ctx.n_shards == 8
    if config == "gang_registered_absent":
        # no gang popped: the gang path never counted a member
        assert backend.recorder.gang_pod_totals == {}
    assert s.loop.phase_profile["waves"] == want[3].loop.phase_profile["waves"]
    assert s.loop._inflight_wave is None


# --------------------------------------------------------------------------
# the breaker trips mid-flight and drains the poisoned successor
# --------------------------------------------------------------------------


def _trip_run(side, monkeypatch, spec_cls, error):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    w = side.w
    store = side.Store()
    for i in range(4):
        store.create(w.make_node(f"n{i}", cpu="32", mem="64Gi"))
    for i in range(40):
        store.create(w.make_pod(f"p{i:02d}", cpu="100m", mem="64Mi", labels={"app": "x"}))
    reg = side.fi.registry()
    reg.reset(seed=0)
    # first collect passes (pipeline warm), then 3 consecutive flakes:
    # exactly the breaker's default threshold
    reg.register(spec_cls("tpu.collect", mode=error, transient=True,
                          start_after=1, times=3))
    reg.arm()
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=8)],
                       seed=3, **side.kw)
    algo = s.algorithms["default-scheduler"]
    s.start()
    s.schedule_pending()
    s.loop.wait_for_bindings()
    s.pump()
    reg.disarm()
    placed, diags, rng = outcome(store, s)
    return (placed, diags, rng, reg.fired_by_point["tpu.collect"],
            [(o, n) for o, n, _ in s.flight_recorder.breaker_events],
            algo.fallback_count, algo.kernel_count, s)


def test_trip_drains_poisoned_successor(monkeypatch):
    """Three injected collect flakes (the port's tpu.collect point) trip the
    breaker while a successor wave is in flight: the trip drains that
    poisoned successor at once and its pods reroute to the host tier in
    queue order; every pod still binds, as in the reference."""
    want = _trip_run(SIDES["jax"], monkeypatch, JFaultSpec, JERROR)
    got = _trip_run(SIDES["port"], monkeypatch, TFaultSpec, TERROR)
    assert got[:7] == want[:7]
    placed, _, _, fired, events, fallback, _, s = got
    assert fired >= 3
    assert (CLOSED, OPEN) in events
    assert s.loop._inflight_wave is None
    assert all(placed.values())
    assert fallback > 0


# --------------------------------------------------------------------------
# tests/test_dedup_golden.py: the BatchCache export and the breaker's cache
# --------------------------------------------------------------------------


def _export_run(side, gates, wave_size=6):
    w = side.w
    store = side.Store()
    for i in range(4):
        store.create(w.make_node(f"n{i}", cpu="8", mem="16Gi", zone=f"z{i % 2}"))
    pods = burst_pods(w, 0, 12)
    for p in pods:
        store.create(p)
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=wave_size)],
                       feature_gates=gates, seed=3, **side.kw)
    s.start()
    s.schedule_pending()
    return s, pods, store


def test_wave_exports_per_signature_node_hints(monkeypatch):
    """With OpportunisticBatching on, a completed wave exports each
    signature's score-ordered node list into the BatchCache: the same
    signatures and lists as the reference's."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    gates = {"OpportunisticBatching": True}
    js, jpods, jstore = _export_run(SIDES["jax"], gates)
    ts, tpods, tstore = _export_run(SIDES["port"], gates)
    assert ts.batch_cache is not None and ts.batch_cache.entries
    tfw, jfw = ts.frameworks["default-scheduler"], js.frameworks["default-scheduler"]
    sig = tfw.sign_pod(tpods[0])
    assert sig is not None and sig in ts.batch_cache.entries
    # the same profile, so the same signature strings and entries
    assert [tfw.sign_pod(p) for p in tpods] == [jfw.sign_pod(p) for p in jpods]
    got = [ts.batch_cache.entries[tfw.sign_pod(p)].ordered_nodes for p in tpods]
    want = [js.batch_cache.entries[jfw.sign_pod(p)].ordered_nodes for p in jpods]
    assert got == want
    assert len(ts.batch_cache.entries) == len(js.batch_cache.entries) == 3
    assert all(set(v) <= {f"n{i}" for i in range(4)} for v in got)
    assert ({p.meta.name: p.spec.node_name for p in tstore.pods()}
            == {p.meta.name: p.spec.node_name for p in jstore.pods()})


def test_no_export_without_gate(monkeypatch):
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    ts, _, _ = _export_run(SIDES["port"], {})
    assert ts.batch_cache is None
    assert ts.algorithms["default-scheduler"].batch is None


def _lifecycle(side):
    w = side.w
    store = side.Store()
    for i in range(6):
        store.create(w.make_node(f"n{i}", cpu="16", mem="32Gi", zone=f"z{i % 2}"))
    for p in burst_pods(w, 0, 16):
        store.create(p)
    s = side.Scheduler(store, profiles=[side.Profile(backend="tpu", wave_size=8)],
                       seed=5, **side.kw)
    algo = s.algorithms["default-scheduler"]
    backend = algo.backend
    s.start()
    s.schedule_pending()
    s.event_recorder.flush()
    trace = [backend.sig_cache.table is not None, bool(backend.sig_cache.slots)]
    # trip: the transition hook clears the resident rows
    algo.breaker.threshold = 1
    algo.breaker.record_failure("injected: test trip")
    trace += [algo.breaker.state, backend.sig_cache.table is None,
              not backend.sig_cache.slots]
    # recover: zero cooldown, both probes succeed -> CLOSED again
    algo.breaker.cooldown_s = 0.0
    trace.append(algo.breaker.allow_device_wave())
    algo.breaker.record_success()
    trace.append(algo.breaker.allow_device_wave())
    algo.breaker.record_success()
    trace.append(algo.breaker.state)
    # a fresh burst after recovery re-warms the cache
    for p in burst_pods(w, 0, 12):
        p.meta.name = f"post-{p.meta.name}"
        store.create(p)
    s.pump()
    s.schedule_pending()
    trace.append(backend.sig_cache.table is not None)
    return trace, outcome(store, s)


def test_trip_clears_close_rewarms(monkeypatch):
    """CLOSED -> OPEN clears the signature cache; OPEN -> HALF_OPEN ->
    CLOSED lets the next burst re-warm it; bindings and rng as the
    reference's."""
    monkeypatch.setenv("KUBE_TPU_PIPELINE_DEPTH", "2")
    want = _lifecycle(SIDES["jax"])
    got = _lifecycle(SIDES["port"])
    assert got == want
    assert got[0] == [True, True, OPEN, True, True, True, True, CLOSED, True]
