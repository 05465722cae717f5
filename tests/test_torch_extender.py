"""The port's HTTP extenders against the reference's, over a real webhook
server on 127.0.0.1.

Both packages' Schedulers (the reference with Profile(backend="tpu"), the
port with device="cpu") run the same cluster against the same in-process
HTTP server, whose handlers are pure functions of the request: every
pod's node, the kernel/fallback counts, the rng state and the sequence of
requests the server received (verb and JSON body, the pod's uid left out:
each package's store numbers its own) are held equal, tolerance 0. Each of
tests/test_extender.py's assertions is then made on the port's run.
find_nodes_that_pass_extenders and extender_scores are held against the
reference's on numpy-seeded node sets and answers (feasible sets, the
diagnosis statuses, the combined scores, ignorable and failing
extenders).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.scheduler.extender as jext
import kubernetes_tpu_torch.scheduler.extender as text
from kubernetes_tpu.scheduler.framework.interface import Diagnosis as JDiagnosis
from kubernetes_tpu_torch.scheduler.framework.interface import Diagnosis as TDiagnosis
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)
from tests.test_torch_volumes import SIDES, _st, clock, run_both, scheduler  # noqa: F401

EXT = {"jax": jext, "port": text}


class _Handler(BaseHTTPRequestHandler):
    behavior: dict = {}  # verb -> fn(args) -> result
    calls: list = []

    def do_POST(self):
        verb = self.path.strip("/")
        args = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).calls.append((verb, args))
        fn = self.behavior.get(verb)
        if fn is None:
            self.send_response(404)
            self.end_headers()
            return
        body = json.dumps(fn(args)).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def server():
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _Handler.behavior = {}
    _Handler.calls = []
    yield f"http://127.0.0.1:{srv.server_port}", _Handler
    srv.shutdown()
    srv.server_close()


def _wire(calls):
    """The requests, the pod uid left out."""
    out = []
    for verb, args in calls:
        args = json.loads(json.dumps(args))
        args.get("pod", {}).get("metadata", {}).pop("uid", None)
        args.pop("podUID", None)
        out.append((verb, args))
    return out


def run_with_server(handler, build, **config):
    """build(side, store) on both packages' Schedulers with one extender of
    `config` on the server; the requests each run made must be equal.
    Returns the port's (outcome, store, scheduler)."""
    calls = {}

    def scenario(side, clock):
        handler.calls.clear()
        store = side.Store()
        build(side, store)
        ext = EXT[side.name].ExtenderConfig(node_cache_capable=True, **config)
        s = scheduler(side, store, extenders=[ext])
        s.schedule_pending()
        calls[side.name] = _wire(handler.calls)
        return store, s

    port = run_both(scenario)
    assert calls["port"] == calls["jax"]
    return port + (calls["port"],)


def _nodes(n, pods=("p1",), special=()):
    def build(side, store):
        for i in range(1, n + 1):
            store.create(side.w.make_node(f"n{i}"))
        for name in pods:
            store.create(side.w.make_pod(name, cpu="1"))
        for name in special:
            store.create(_special(side, name))
    return build


def _special(side, name):
    """A pod with a limit on the extender's managed resource (a limit, so
    the nodes need not hold the resource for the in-tree filters)."""
    pod = side.w.make_pod(name, cpu="1")
    pod.spec.containers[0].limits = {"example.com/foo": "1"}
    return pod


def node_of(store, pod_name):
    return store.get("Pod", f"default/{pod_name}").spec.node_name


def test_extender_filter_restricts_nodes(server):
    url, handler = server
    handler.behavior["filter"] = lambda args: {"nodenames": ["n2"]}
    out, store, s, calls = run_with_server(handler, _nodes(3), url_prefix=url,
                                           filter_verb="filter")
    assert node_of(store, "p1") == "n2"
    assert any(v == "filter" for v, _ in calls)
    # the extender-interested pod took the hybrid route: K4, no fallback
    assert out["counts"] == (1, 0)


def test_extender_prioritize_wins(server):
    url, handler = server
    handler.behavior["prioritize"] = lambda args: [
        {"host": n, "score": 10 if n == "n3" else 0} for n in args.get("nodenames", [])]
    _, store, _, _ = run_with_server(handler, _nodes(3), url_prefix=url,
                                     prioritize_verb="prioritize", weight=5)
    assert node_of(store, "p1") == "n3"


def test_extender_bind_delegation(server):
    url, handler = server
    bound = []

    def do_bind(args):
        bound.append((args["podName"], args["node"]))
        return {}

    handler.behavior["bind"] = do_bind
    _, store, _, _ = run_with_server(handler, _nodes(1), url_prefix=url, bind_verb="bind")
    assert bound == [("p1", "n1"), ("p1", "n1")]  # the reference's run, then the port's
    # the webhook owns the binding write, not DefaultBinder
    assert node_of(store, "p1") == ""


def test_ignorable_extender_failure_tolerated(server):
    url, handler = server  # no behavior: 404 on every verb
    _, store, _, _ = run_with_server(handler, _nodes(1), url_prefix=url,
                                     filter_verb="filter", ignorable=True)
    assert node_of(store, "p1") == "n1"


def test_non_ignorable_extender_failure_errors(server):
    url, handler = server
    _, store, _, _ = run_with_server(handler, _nodes(1), url_prefix=url, filter_verb="filter")
    assert node_of(store, "p1") == ""  # the cycle errored; the pod is retried later


def test_managed_resources_interest(server):
    url, handler = server
    handler.behavior["filter"] = lambda args: {"nodenames": []}  # rejects all
    build = _nodes(1, pods=("plain",), special=("special",))
    _, store, _, calls = run_with_server(handler, build, url_prefix=url, filter_verb="filter",
                                         managed_resources=("example.com/foo",))
    assert node_of(store, "plain") == "n1"  # the extender is not interested
    assert node_of(store, "special") == ""  # it rejected every node
    assert {a["pod"]["metadata"]["name"] for _, a in calls} == {"special"}


def test_extender_composes_with_the_kernel(server):
    """Extender-interested pods take the hybrid route: K4's feasibility,
    then the extender's filter and prioritize; with a wave profile the
    plain pods around them still ride the waves."""
    url, handler = server
    handler.behavior["filter"] = lambda args: {
        "nodenames": [n for n in args.get("nodenames", []) if n != "n1"],
        "failedNodes": {"n1": "n1 is reserved"}}
    handler.behavior["prioritize"] = lambda args: [
        {"host": n, "score": 10 if n == "n3" else 0} for n in args.get("nodenames", [])]

    def build(side, store):
        for i in range(1, 5):
            store.create(side.w.make_node(f"n{i}", cpu="4"))
        for i in range(6):
            store.create(side.w.make_pod(f"plain-{i}", cpu="1"))
        for i in range(3):
            store.create(_special(side, f"special-{i}"))

    calls = {}

    def scenario(side, clock):
        handler.calls.clear()
        store = side.Store()
        build(side, store)
        ext = EXT[side.name].ExtenderConfig(
            url_prefix=url, filter_verb="filter", prioritize_verb="prioritize", weight=5,
            node_cache_capable=True, managed_resources=("example.com/foo",))
        s = scheduler(side, store, wave_size=4, extenders=[ext])
        s.schedule_pending()
        calls[side.name] = _wire(handler.calls)
        return store, s

    out, store, s = run_both(scenario)
    assert calls["port"] == calls["jax"]
    assert node_of(store, "special-0") == "n3"
    assert all(node_of(store, f"special-{i}") != "n1" for i in range(3))
    assert all(node_of(store, f"plain-{i}") for i in range(6))
    assert out["counts"][1] == 0
    assert s.loop.phase_profile["waves"] > 0
    assert {v for v, _ in calls["port"]} == {"filter", "prioritize"}


# --------------------------------------------------------------------------
# the fan-in functions on seeded answers
# --------------------------------------------------------------------------


class FakeExtender:
    """HTTPExtender's interface with answers drawn from numpy's seeded
    generator; `fail` raises the transport error an unreachable webhook
    gives."""

    def __init__(self, seed, ignorable=False, fail=False, managed=()):
        self.rng = np.random.default_rng(seed)
        self.ignorable, self.fail, self.managed = ignorable, fail, managed
        self.name = f"fake-{seed}"

    def is_ignorable(self):
        return self.ignorable

    def is_filter(self):
        return True

    def is_prioritizer(self):
        return True

    def is_binder(self):
        return False

    def is_interested(self, pod):
        return not self.managed or any(
            set(self.managed) & set(c.requests) for c in pod.spec.containers)

    def filter(self, pod, nodes):
        if self.fail:
            raise OSError("connection refused")
        keep = [ni for ni in nodes if self.rng.random() < 0.7]
        dropped = [ni.name for ni in nodes if ni not in keep]
        failed = {n: f"no room on {n}" for n in dropped[::2]}
        unresolvable = {n: f"{n} is gone" for n in dropped[1::2]}
        return keep, failed, unresolvable

    def prioritize(self, pod, nodes):
        if self.fail:
            raise OSError("connection refused")
        return {ni.name: int(self.rng.integers(0, 11)) for ni in nodes}, int(
            self.rng.integers(1, 4))


def _fan_in(side, seed, kinds):
    from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
    from kubernetes_tpu.scheduler.cache.cache import Cache as JCache

    cache = (JCache if side.name == "jax" else TCache)(side.Names())
    for i in range(12):
        cache.add_node(side.w.make_node(f"n{i}"))
    snap = side.Snapshot()
    cache.update_snapshot(snap)
    pod = side.w.make_pod("p", cpu="1", requests={"example.com/foo": "1"})
    exts = [FakeExtender(seed + i, **kw) for i, kw in enumerate(kinds)]
    diagnosis = (JDiagnosis if side.name == "jax" else TDiagnosis)()
    ext = EXT[side.name]
    try:
        kept = ext.find_nodes_that_pass_extenders(exts, pod, snap.list_nodes(), diagnosis)
    except RuntimeError as e:
        return ("error", str(e))
    statuses = {n: _st(s) for n, s in diagnosis.node_to_status.node_to_status.items()}
    scores = ext.extender_scores(exts, pod, kept)
    return [ni.name for ni in kept], statuses, scores


@pytest.mark.parametrize("seed", [91, 92, 93])
@pytest.mark.parametrize("kinds", [
    ({}, {}),
    ({}, {"ignorable": True, "fail": True}, {}),
    ({"managed": ("example.com/bar",)}, {}),
    ({}, {"fail": True}),
], ids=["two", "ignorable-failure", "uninterested", "failure"])
def test_fan_in_matches_reference(seed, kinds):
    sides = {name: SimpleNamespace(**vars(side)) for name, side in SIDES.items()}
    want = _fan_in(sides["jax"], seed, kinds)
    got = _fan_in(sides["port"], seed, kinds)
    assert got == want
    if kinds[-1].get("fail"):
        assert got[0] == "error"
    else:
        assert got[0] and got[2]
