"""The port's entry point against the reference's: the configuration
document, the feature gates, SchedulerServer and its mux, the profile
plugin sets and the CacheDebugger.

The cases of tests/test_config_leaderelection.py (TestConfig,
TestSchedulerServer, TestProfilePluginSets), tests/test_cache_debugger.py
and tests/test_podlatency.py::TestPodLatencyZpage, each run on both
packages — the reference's (kubernetes_tpu) and the port's
(kubernetes_tpu_torch, every Scheduler with device="cpu", so the kernels'
plain versions run) — with the reference test's assertions on each, and
across the two (tolerance 0: names, integers, strings):

- one configuration document loads into equal fields (every field of
  every dataclass) and a bad one fails with equal errors. The named
  departure: the port's profiles all run its device backend, so
  `ProfileConfig.backend` defaults to "tpu" and a document naming "host"
  fails with "unknown backend host"; the parity documents name "tpu";
- a server's bindings, its /configz and /podlatency payloads (timings
  aside) are equal; the reference's server runs with KUBE_TPU_WARMUP=0
  (its warm start compiles a dozen JAX programs on this CPU), the port's
  at its default, warm;
- the debugger's dump, `compare` and `compare_carry` findings are equal on
  the same cluster and the same corruption. The reference's host-backend
  cluster has no port counterpart; the port runs those cases through its
  per-pod cycle (wave size 0), whose bindings equal the host path's;
- every route of the port's mux answers, /readyz stays 503 and /healthz
  500 over a Scheduler whose start() raised, and `main()` without a card
  exits non-zero (no CPU fallback).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.cmd.scheduler as jcmd
import kubernetes_tpu.config.types as jcfg
import kubernetes_tpu.scheduler.cache.debugger as jdbg
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.featuregate as jfg
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.cmd.scheduler as tcmd
import kubernetes_tpu_torch.config.types as tcfg
import kubernetes_tpu_torch.scheduler.cache.debugger as tdbg
import kubernetes_tpu_torch.testing.wrappers as tw
import kubernetes_tpu_torch.utils.featuregate as tfg
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, types=jtypes, cfg=jcfg, fg=jfg, cmd=jcmd,
                           dbg=jdbg, Store=JStore, Scheduler=JScheduler, Profile=JProfile,
                           kw={}, host_backend="host", warmup="0"),
    "port": SimpleNamespace(name="port", w=tw, types=ttypes, cfg=tcfg, fg=tfg, cmd=tcmd,
                            dbg=tdbg, Store=TStore, Scheduler=TScheduler, Profile=TProfile,
                            kw={"device": "cpu"}, host_backend="tpu", warmup="1"),
}
BOTH = pytest.mark.parametrize("side", ["jax", "port"], ids=["jax", "port"])

FULL_DOCUMENT = {
    "apiVersion": "kubescheduler.config.tpu.io/v1",
    "kind": "KubeSchedulerConfiguration",
    "parallelism": 8,
    "percentageOfNodesToScore": 50,
    "featureGates": {"OpportunisticBatching": True},
    "profiles": [
        {"schedulerName": "default-scheduler", "backend": "tpu", "waveSize": 64},
        {"schedulerName": "cpu-sched", "backend": "tpu",
         "pluginConfig": [{"name": "NodeResourcesFit",
                           "args": {"strategy": "MostAllocated"}}]},
    ],
    "extenders": [
        {"urlPrefix": "http://localhost:9999", "filterVerb": "filter",
         "ignorable": True, "managedResources": [{"name": "example.com/dev"}]},
    ],
    "leaderElection": {"leaderElect": True, "leaseDurationSeconds": 6,
                       "renewDeadlineSeconds": 4},
    "podInitialBackoffSeconds": 2,
    "podMaxBackoffSeconds": 20,
}

BAD_DOCUMENTS = [
    {"percentageOfNodesToScore": 150},
    {"profiles": [{"schedulerName": "a", "backend": "tpu"},
                  {"schedulerName": "a", "backend": "tpu"}]},
    {"parallelism": 0, "podInitialBackoffSeconds": 0},
    {"profiles": [{"backend": "tpu", "waveSize": -1, "percentageOfNodesToScore": 101}]},
    {"leaderElection": {"leaderElect": True, "leaseDurationSeconds": 4,
                        "renewDeadlineSeconds": 4}},
    {"apiVersion": "v0"},
    {"kind": "Other"},
]


def fields(obj):
    """Every field of a loaded configuration, comparable across packages
    (an ExtenderConfig by the fields both packages' dataclasses have)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in ("preempt_verb", "http_timeout")}
    if isinstance(obj, (list, tuple)):
        return [fields(v) for v in obj]
    if isinstance(obj, dict):
        return {k: fields(v) for k, v in obj.items()}
    return obj


def load_error(cfg, doc):
    with pytest.raises(ValueError) as e:
        cfg.load_config(doc)
    return str(e.value)


# ------------------------------------------------------------------ config


class TestConfig:
    @BOTH
    def test_defaults(self, side):
        s = SIDES[side]
        cfg = s.cfg.SchedulerConfiguration()
        assert cfg.parallelism == 16
        assert cfg.validate() == []
        assert cfg.profiles[0].backend == s.host_backend  # the named departure

    @BOTH
    def test_load_full_document(self, side):
        s = SIDES[side]
        cfg = s.cfg.load_config(FULL_DOCUMENT)
        assert cfg.parallelism == 8
        assert cfg.profiles[0].backend == "tpu"
        assert cfg.profiles[1].plugin_args["NodeResourcesFit"]["strategy"] == "MostAllocated"
        assert cfg.extenders[0].ignorable
        assert cfg.leader_election.leader_elect
        if side == "port":
            assert fields(cfg) == fields(jcfg.load_config(FULL_DOCUMENT))

    @BOTH
    def test_validation_rejects_bad_config(self, side):
        s = SIDES[side]
        with pytest.raises(ValueError, match="percentageOfNodesToScore"):
            s.cfg.load_config({"percentageOfNodesToScore": 150})
        with pytest.raises(ValueError, match="unique"):
            s.cfg.load_config({"profiles": [{"schedulerName": "a", "backend": "tpu"},
                                            {"schedulerName": "a", "backend": "tpu"}]})
        if side == "port":
            for doc in BAD_DOCUMENTS:
                assert load_error(tcfg, doc) == load_error(jcfg, doc), doc

    @BOTH
    def test_feature_gate_catalog(self, side):
        g = SIDES[side].fg.FeatureGate()
        assert g.enabled("DynamicResourceAllocation")
        assert not g.enabled("OpportunisticBatching")
        g.set_from_map({"OpportunisticBatching": True})
        assert g.enabled("OpportunisticBatching")
        with pytest.raises(KeyError):
            g.set_from_map({"NoSuchGate": True})
        if side == "port":
            assert g.as_map() == {**jfg.FeatureGate().as_map(), "OpportunisticBatching": True}
            assert fields(tfg.KNOWN_FEATURES) == fields(jfg.KNOWN_FEATURES)


def test_port_refuses_the_host_backend():
    """The named departure: the reference loads a host profile, the port
    refuses it with the Scheduler's own 'unknown backend' error."""
    doc = {"profiles": [{"schedulerName": "h", "backend": "host"}]}
    assert jcfg.load_config(doc).profiles[0].backend == "host"
    assert load_error(tcfg, doc) == "invalid configuration: profile h: unknown backend host"
    with pytest.raises(ValueError, match="unknown backend host"):
        TScheduler(TStore(), profiles=[TProfile(backend="host")], device="cpu")


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_load_config_file(tmp_path, fmt):
    """A JSON document (what the card's machine reads, no PyYAML there) and
    a YAML one load into the reference's fields."""
    path = tmp_path / f"config.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps(FULL_DOCUMENT))
    else:
        import yaml

        path.write_text(yaml.safe_dump(FULL_DOCUMENT))
    assert fields(tcfg.load_config_file(str(path))) == fields(jcfg.load_config_file(str(path)))


# ------------------------------------------------------------------ server


@contextmanager
def warmup_env(value):
    old = os.environ.get("KUBE_TPU_WARMUP")
    os.environ["KUBE_TPU_WARMUP"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KUBE_TPU_WARMUP", None)
        else:
            os.environ["KUBE_TPU_WARMUP"] = old


def server(side, store, cfg, warmup=None, **kw):
    with warmup_env(warmup or side.warmup):
        return side.cmd.SchedulerServer(store, cfg, **kw, **side.kw)


def tpu_config(side, wave_size=0):
    cfg = side.cfg.SchedulerConfiguration()
    cfg.profiles[0].backend = "tpu"
    cfg.profiles[0].wave_size = wave_size
    return cfg


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers.get("Content-Type")


def wait_bound(store, keys, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(store.get("Pod", k).spec.node_name for k in keys):
            return
        time.sleep(0.02)


def placed(store):
    return {p.meta.key: p.spec.node_name for p in store.pods()}


class TestSchedulerServer:
    def _endpoints(self, side):
        s = SIDES[side]
        store = s.Store()
        store.create(s.w.make_node("n1", cpu="8"))
        srv = server(s, store, tpu_config(s))
        port = srv.serve(0)
        srv.run(block=False)
        try:
            store.create(s.w.make_pod("p1", cpu="1"))
            wait_bound(store, ["default/p1"])
            assert store.get("Pod", "default/p1").spec.node_name == "n1"
            assert get(port, "/healthz")[:2] == (200, "ok")
            assert get(port, "/readyz")[0] == 200
            code, metrics, _ = get(port, "/metrics")
            assert code == 200 and "scheduler_schedule_attempts_total" in metrics
            code, configz, _ = get(port, "/configz")
            assert code == 200 and json.loads(configz)["parallelism"] == 16
            return placed(store), json.loads(configz)
        finally:
            srv.shutdown()

    def test_endpoints_and_scheduling(self):
        assert self._endpoints("port") == self._endpoints("jax")

    def _only_leader(self, side):
        s = SIDES[side]
        store = s.Store()
        store.create(s.w.make_node("n1", cpu="8"))
        cfg = tpu_config(s)
        cfg.leader_election.leader_elect = True
        cfg.leader_election.retry_period = 0.05
        cfg.leader_election.lease_duration = 1.0
        cfg.leader_election.renew_deadline = 0.5
        s1 = server(s, store, cfg, identity="s1")
        s2 = server(s, store, cfg, identity="s2")
        p1, p2 = s1.serve(0), s2.serve(0)
        s1.run(block=False)
        time.sleep(0.2)  # s1 acquires first
        s2.run(block=False)
        try:
            time.sleep(0.3)
            assert s1.elector.is_leader()
            assert not s2.elector.is_leader()
            store.create(s.w.make_pod("p1", cpu="1"))
            wait_bound(store, ["default/p1"])
            assert store.get("Pod", "default/p1").spec.node_name == "n1"
            if side == "port":
                s1.wait_ready(30.0)
                assert get(p1, "/readyz")[0] == 200
                assert get(p2, "/readyz")[0] == 503  # not the leader
            return placed(store)
        finally:
            s1.shutdown()
            s2.shutdown()

    def test_only_leader_schedules(self):
        assert self._only_leader("port") == self._only_leader("jax")


class TestProfilePluginSets:
    """The reference's cases run its host profile, which the port does not
    have; on the device backend both packages refuse to disable a
    kernel-modeled plugin with equal errors, and a plugin set that keeps
    them binds equally."""

    def _refused(self, side, **kw):
        s = SIDES[side]
        with pytest.raises(ValueError, match="kernel-modeled") as e:
            s.Scheduler(s.Store(), profiles=[s.Profile(backend="tpu", **kw)], **s.kw)
        # the plugins named; the advice after them differs (the reference
        # points at its host backend, which the port does not have)
        return str(e.value).split(" cannot be disabled")[0]

    def test_disabled_plugin_is_not_run(self):
        kw = dict(disabled_plugins=("TaintToleration",))
        assert self._refused("port", **kw) == self._refused("jax", **kw)
        # a plugin the kernels do not model is left out alike: the image
        # score gone, both packages place the pods on the same nodes
        runs = []
        for side in ("jax", "port"):
            s = SIDES[side]
            store = s.Store()
            for i in range(4):
                store.create(s.w.make_node(f"n{i}", cpu="8", mem="16Gi"))
            for i in range(6):
                store.create(s.w.make_pod(f"p{i}", cpu="1"))
            sched = s.Scheduler(store, profiles=[s.Profile(
                backend="tpu", disabled_plugins=("NodeVolumeLimits",))], seed=3, **s.kw)
            sched.start()
            assert sched.schedule_pending() == 6
            runs.append(placed(store))
        assert runs[0] == runs[1]

    def test_wildcard_whitelist(self):
        kw = dict(disabled_plugins=("*",), enabled_plugins=("NodeName",))
        assert self._refused("port", **kw) == self._refused("jax", **kw)

    def test_tpu_profile_rejects_disabling_kernel_plugins(self):
        kw = dict(disabled_plugins=("NodeResourcesFit",))
        assert self._refused("port", **kw) == self._refused("jax", **kw)


# ---------------------------------------------------------- cache debugger


def debug_cluster(side, wave=False, nodes=4):
    """The reference test's cluster: 4 nodes, 6 pods scheduled. The
    reference's host profile (wave=False) is the port's per-pod cycle."""
    s = SIDES[side]
    store = s.Store()
    for i in range(nodes):
        store.create(s.w.make_node(f"n{i}", cpu="8"))
    backend = "tpu" if wave else s.host_backend
    sched = s.Scheduler(store, profiles=[s.Profile(backend=backend,
                                                   wave_size=8 if wave else 0)], **s.kw)
    sched.start()
    for i in range(6):
        store.create(s.w.make_pod(f"p{i}", cpu="1"))
    sched.schedule_pending()
    return store, sched


def debugger(side, store, sched, backend=None, log=lambda *_: None):
    return SIDES[side].dbg.CacheDebugger(sched.cache, sched.queue, store,
                                         backend=backend, log=log)


def on_both(case):
    out = {side: case(side) for side in ("jax", "port")}
    assert out["port"] == out["jax"]
    return out["port"]


class TestDumper:
    def test_dump_lists_nodes_queue_and_assumed(self):
        def case(side):
            store, sched = debug_cluster(side)
            lines: list[str] = []
            out = debugger(side, store, sched, log=lines.append).dump()
            assert "Dump of cached NodeInfo" in out
            for i in range(4):
                assert f"node n{i}:" in out
            assert "Dump of scheduling queue" in out
            assert lines  # dump also logs
            # node order aside (each cache's zone walk), the lines are equal
            return sorted(out.splitlines()), placed(store)

        on_both(case)


class TestComparer:
    def test_clean_cluster_has_no_issues(self):
        def case(side):
            store, sched = debug_cluster(side)
            assert debugger(side, store, sched).compare() == []
            return placed(store)

        on_both(case)

    def test_detects_cache_store_drift(self):
        def case(side):
            s = SIDES[side]
            store, sched = debug_cluster(side)
            dbg = debugger(side, store, sched)
            store.create(s.w.make_node("ghost", cpu="8"))
            first = dbg.compare()
            assert any("ghost" in i and "not in cache" in i for i in first)
            sched.pump()  # absorb the node event first
            assert dbg.compare() == []
            rogue = s.w.make_pod("rogue", cpu="1")
            rogue.spec.node_name = "n0"
            store.create(rogue)  # store knows; cache not pumped
            second = dbg.compare()
            assert any("rogue" in i and "missing from cache" in i for i in second)
            # a pod cached on one node and bound to another in the store
            cur = store.get("Pod", "default/p0")
            other = next(n for n in ("n0", "n1", "n2", "n3") if n != cur.spec.node_name)
            cur.spec.node_name = other
            store.update(cur, check_version=False)
            third = dbg.compare()
            return first, second, [i.replace(other, "OTHER") for i in third], placed(store)

        on_both(case)

    def test_assumed_pods_are_not_flagged(self):
        def case(side):
            s = SIDES[side]
            store, sched = debug_cluster(side)
            dbg = debugger(side, store, sched)
            sched.cache.assume_pod(s.w.make_pod("assumed-only", cpu="1"), "n0")
            assert dbg.compare() == []  # assumed-not-yet-bound is legitimate
            return placed(store)

        on_both(case)


class TestCarryComparer:
    def test_wave_carry_coherent_after_drain(self):
        def case(side):
            # 16 nodes: rows no assume has queued for upload stay to corrupt
            store, sched = debug_cluster(side, wave=True, nodes=16)
            sched.loop.wait_for_bindings()
            algo = sched.algorithms["default-scheduler"]
            assert algo.backend._carry is not None, "the check must read a live carry"
            dbg = debugger(side, store, sched, backend=algo.backend)
            snapshot = sched.loop.snapshot
            sched.cache.update_snapshot(snapshot)
            assert dbg.compare_carry(snapshot) == []
            # the same corruption of one carry row (the first no assume
            # has queued for upload): both report it alike
            row = min(set(range(16)) - set(algo.backend._pending_dirty or ()))
            used = algo.backend._carry["used"]
            if side == "jax":
                import numpy as np

                bad = np.asarray(used).copy()
                bad[row, 0] += 7
                algo.backend._carry["used"] = bad
            else:
                used[row, 0] += 7
            return row, dbg.compare_carry(snapshot), placed(store)

        row, issues, _ = on_both(case)
        assert len(issues) == 1 and issues[0].startswith(f"carry row {row} ")


# ------------------------------------------------------------------ zpages


def timeless(obj):
    """A payload with every float (a timing) blanked."""
    if isinstance(obj, dict):
        return {k: timeless(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [timeless(v) for v in obj]
    return None if isinstance(obj, float) else obj


class TestPodLatencyZpage:
    def _served(self, side):
        s = SIDES[side]
        store = s.Store()
        store.create(s.w.make_node("n0", cpu="8", mem="16Gi"))
        for i in range(6):
            store.create(s.w.make_pod(f"z{i}", cpu="500m", mem="256Mi"))
        # both cold: a warm start's waves take wave ids ahead of the pods'
        srv = server(s, store, tpu_config(s, wave_size=4), warmup="0")
        port = srv.serve(0)
        try:
            srv.scheduler.start()
            srv.scheduler.pump()
            srv.scheduler.schedule_pending()
            code, body, ctype = get(port, "/debug/podlatency?last=2&slowest=1")
            assert code == 200 and ctype == "application/json"
            payload = json.loads(body)
            assert payload["summary"]["pods_completed"] == 6
            assert len(payload["last"]) == 2
            assert len(payload["slowest"]) == 1
            assert "segments" in payload["last"][0]
            assert get(port, "/debug/podlatency?last=abc")[0] == 400
            # the slowest pod is a timing; the rest is not
            payload.pop("slowest")
            return timeless(payload), placed(store)
        finally:
            srv.shutdown()

    def test_served_with_params(self):
        assert self._served("port") == self._served("jax")


ROUTES = ["/healthz", "/readyz", "/metrics", "/configz", "/statusz", "/flagz",
          "/debug/pprof/profile?seconds=0.05", "/debug/flightrecorder",
          "/debug/flightrecorder?last=2", "/debug/podlatency", "/debug/devicetelemetry",
          "/debug/stalls", "/debug/stalls?last=1", "/debug/traces", "/debug/traces?last=3"]


def test_every_route_answers_on_the_port():
    s = SIDES["port"]
    store = s.Store()
    for i in range(4):
        store.create(s.w.make_node(f"n{i}", cpu="8"))
    srv = server(s, store, tpu_config(s, wave_size=8))
    port = srv.serve(0)
    srv.run(block=False)
    try:
        assert srv.wait_ready(30.0)
        for i in range(12):
            store.create(s.w.make_pod(f"r{i}", cpu="1"))
        wait_bound(store, [f"default/r{i}" for i in range(12)])
        assert all(placed(store).values())
        for path in ROUTES:
            code, body, ctype = get(port, path)
            assert code == 200, (path, code, body)
            if ctype == "application/json":
                json.loads(body)
        assert json.loads(get(port, "/debug/devicetelemetry")[1])["compiles"] is not None
        assert json.loads(get(port, "/debug/traces")[1])["resourceSpans"]
        for bad in ("/debug/flightrecorder?last=x", "/debug/stalls?last=x",
                    "/debug/traces?last=x", "/debug/pprof/profile?seconds=x"):
            assert get(port, bad)[0] == 400, bad
        assert get(port, "/nowhere")[0] == 404
        assert srv.scheduler.flight_recorder.device_telemetry.compile_count_since_warm() == 0
    finally:
        srv.shutdown()


def test_a_failed_start_is_never_ready(monkeypatch):
    """start() raising (a kernel build or launch in the warmup, say) keeps
    /readyz at 503, turns /healthz to 500 and is raised, not swallowed."""
    s = SIDES["port"]
    store = s.Store()
    store.create(s.w.make_node("n0", cpu="8"))
    srv = server(s, store, tpu_config(s, wave_size=8))

    def broken_start():
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(srv.scheduler, "start", broken_start)
    port = srv.serve(0)
    try:
        with pytest.raises(RuntimeError, match="kernel build failed"):
            srv.run(block=False)
        assert get(port, "/readyz")[0] == 503
        code, body, _ = get(port, "/healthz")
        assert code == 500 and "kernel build failed" in body
        with pytest.raises(RuntimeError, match="kernel build failed"):
            srv.wait_ready(1.0)
    finally:
        srv.shutdown()


def test_main_without_a_card_exits_non_zero(tmp_path):
    """`python -m kubernetes_tpu_torch.cmd.scheduler` has no CPU switch: on a
    machine without CUDA it fails instead of scheduling on the CPU."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"profiles": [{"backend": "tpu", "waveSize": 8}]}))
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.cmd.scheduler",
                        "--config", str(path), "--port", "0"],
                       capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert "cuda" in (r.stderr + r.stdout).lower()
