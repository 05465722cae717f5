"""The port's API server, wire codecs, REST client and kubectl held to the
reference.

1. The reference's own suites, run on the port. Each of
   tests/test_apiserver.py, test_apiserver_auth.py, test_apply.py,
   test_cbor.py, test_versioning.py, test_extensions.py,
   test_aggregation.py, test_quota.py and test_tls.py is read, its imports
   of the reference package turned into the port's (`tests.wrappers` into
   `kubernetes_tpu_torch.testing.wrappers`), and executed into this
   module, so every case of those suites is collected here as a case of
   the port (tests/torch_suites.py); the Scheduler and ClusterBootstrap
   the suites run take `device="cpu"` (the port has no host-only
   profile).
2. A differential test: one seeded sequence of REST requests sent to both
   packages' servers, each over its own Store, gives equal status codes
   and equal bodies (uid, timestamps and the serving address masked). The
   sequence covers CRUD, label and field selectors, watch, merge patch,
   server-side apply and its conflicts, admission rejections, RBAC denials
   and the binding subresource.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubernetes_tpu_torch.api import cbor
from tests.torch_suites import load_suites

# suite -> case names (Class.method or function) that need a module the port
# does not have yet; every case of these suites runs on the port
NOT_PORTED: dict[str, set[str]] = {}

SUITES = ("test_apiserver", "test_apiserver_auth", "test_apply", "test_cbor",
          "test_versioning", "test_extensions", "test_aggregation",
          "test_quota", "test_tls")


def _edit(suite: str, src: str) -> str:
    if suite == "test_aggregation":
        # both test_extensions and test_aggregation name a fixture `cluster`
        src, n = re.subn(r"(?<![-\w\"'./])cluster(?![-\w\"'])",
                         "agg_cluster", src)
        assert n > 10, n
    return src


load_suites(globals(), SUITES, NOT_PORTED, _edit)


# ------------------------------------------------------- the differential


MASK = "<masked>"
_MASKED_KEYS = {"uid", "creation_timestamp", "deletion_timestamp",
                "first_timestamp", "last_timestamp", "start_time",
                "timestamp", "last_transition_time", "time"}


def _mask(v, url: str):
    if isinstance(v, dict):
        return {k: (MASK if k in _MASKED_KEYS else _mask(x, url))
                for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x, url) for x in v]
    if isinstance(v, str):
        return v.replace(url, "<url>")
    return v


def _http(url: str, method: str, path: str, body=None, token: str = ""):
    # a bytes body is a CBOR document
    binary = isinstance(body, bytes)
    data = body if binary or body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/cbor" if binary
                       else "application/json")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        out = json.loads(raw) if raw else None
    except ValueError:
        out = raw.decode(errors="replace")
    return code, out


def _watch_lines(url: str, path: str, n: int, token: str = "") -> list:
    """The first n frames of a watch stream (JSON lines)."""
    req = urllib.request.Request(url + path)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    frames = []
    with urllib.request.urlopen(req, timeout=10) as r:
        while len(frames) < n:
            line = r.readline()
            if not line:
                break
            if line.strip():
                frames.append(json.loads(line))
    return frames


def _requests(seed: int) -> list[tuple]:
    """One seeded request sequence: (method, path, body, token)."""
    rng = np.random.default_rng(seed)
    admin, viewer = "admin-token", "viewer-token"
    reqs: list[tuple] = []
    n_nodes = int(rng.integers(3, 6))
    for i in range(n_nodes):
        cpu = str(int(rng.integers(4, 17)))
        alloc = {"cpu": cpu, "memory": "32Gi", "pods": 110}
        reqs.append(("POST", "/api/v1/Node", {
            "kind": "Node",
            "meta": {"name": f"n{i}", "namespace": "", "labels": {
                "topology.kubernetes.io/zone": f"z{i % 3}",
                "kubernetes.io/hostname": f"n{i}"}},
            "status": {"allocatable": alloc, "capacity": dict(alloc)},
        }, admin))
    n_pods = int(rng.integers(6, 10))
    for i in range(n_pods):
        app = ["web", "db", "cache"][int(rng.integers(0, 3))]
        cpu = f"{int(rng.integers(1, 9)) * 100}m"
        reqs.append(("POST", "/api/v1/Pod", {
            "kind": "Pod",
            "meta": {"name": f"p{i}", "namespace": "default",
                     "labels": {"app": app, "tier": str(i % 2)}},
            "spec": {"containers": [{"name": "c", "image": "img",
                                     "requests": {"cpu": cpu}}],
                     "priority_class_name": "high" if i % 3 == 0 else ""},
        }, admin))
    pick = [int(x) for x in rng.permutation(n_pods)[:4]]
    reqs.append(("POST", "/api/v1/Pod", cbor.dumps({
        "kind": "Pod", "meta": {"name": "binary", "namespace": "default",
                                "labels": {"app": "web"}},
        "spec": {"containers": [{"name": "c", "requests": {"cpu": "1"}}]},
    }), admin))
    reqs += [
        # duplicate create, a missing object, an unknown kind
        ("POST", "/api/v1/Pod", {"kind": "Pod", "meta": {
            "name": "p0", "namespace": "default"}}, admin),
        ("GET", "/api/v1/Pod/default/nope", None, admin),
        ("GET", "/api/v1/Widget", None, admin),
        # label and field selectors
        ("GET", "/api/v1/Pod?labelSelector=app%3Dweb", None, admin),
        ("GET", "/api/v1/Pod?labelSelector=app+in+%28db%2Ccache%29%2Ctier%21%3D1",
         None, admin),
        ("GET", "/api/v1/Node?labelSelector=topology.kubernetes.io%2Fzone%3Dz1",
         None, admin),
        ("GET", f"/api/v1/Pod?fieldSelector=metadata.name%3Dp{pick[0]}",
         None, admin),
        # the binding subresource, then a field selector on the node
        ("POST", f"/api/v1/Pod/default/p{pick[1]}/binding",
         {"target_node": "n0"}, admin),
        ("POST", f"/api/v1/Pod/default/p{pick[2]}/binding",
         {"target_node": "n1"}, admin),
        ("POST", "/api/v1/Pod/default/nope/binding", {"target_node": "n1"},
         admin),
        ("GET", "/api/v1/Pod?fieldSelector=spec.nodeName%3Dn0", None, admin),
        # JSON merge patch
        ("PATCH", f"/api/v1/Pod/default/p{pick[3]}",
         {"meta": {"labels": {"app": "patched", "tier": None}}}, admin),
        ("GET", f"/api/v1/Pod/default/p{pick[3]}", None, admin),
        ("PATCH", "/api/v1/Pod/default/nope", {"meta": {"labels": {}}}, admin),
        # server-side apply: create, a conflict, a forced transfer
        ("PATCH", "/api/v1/Pod/default/applied?fieldManager=alice",
         {"kind": "Pod", "meta": {"name": "applied", "namespace": "default",
                                  "labels": {"owner": "alice"}},
          "spec": {"containers": [{"name": "c", "image": "a"}]}}, admin),
        ("PATCH", "/api/v1/Pod/default/applied?fieldManager=bob",
         {"kind": "Pod", "meta": {"name": "applied", "namespace": "default",
                                  "labels": {"owner": "bob"}}}, admin),
        ("PATCH", "/api/v1/Pod/default/applied?fieldManager=bob&force=true",
         {"kind": "Pod", "meta": {"name": "applied", "namespace": "default",
                                  "labels": {"owner": "bob"}}}, admin),
        ("GET", "/api/v1/Pod/default/applied", None, admin),
        # admission: a pod naming a PriorityClass that does not exist
        ("POST", "/api/v1/Pod", {"kind": "Pod", "meta": {
            "name": "orphan", "namespace": "default"},
            "spec": {"priority_class_name": "missing",
                     "containers": [{"name": "c"}]}}, admin),
        # authentication and RBAC: an unknown token, no token, a viewer
        ("GET", "/api/v1/Pod", None, "nobody"),
        ("GET", "/api/v1/Pod", None, ""),
        ("GET", "/api/v1/Pod", None, viewer),
        ("POST", "/api/v1/Pod", {"kind": "Pod", "meta": {
            "name": "v", "namespace": "default"}}, viewer),
        ("DELETE", "/api/v1/Pod/default/p0", None, viewer),
        # an update at a stale version, a delete, a second delete
        ("PUT", "/api/v1/Pod/default/p1", {"kind": "Pod", "meta": {
            "name": "p1", "namespace": "default", "resource_version": 1}},
         admin),
        ("DELETE", "/api/v1/Pod/default/p5", None, admin),
        ("DELETE", "/api/v1/Pod/default/p5", None, admin),
        ("GET", "/api/v1/Pod", None, admin),
        ("GET", "/api/v1/Node", None, admin),
        ("GET", "/api", None, admin),
        ("GET", "/apis", None, admin),
    ]
    return reqs


def _server(pkg: str):
    """One package's APIServer over its own Store, with the default
    admission chain, token authentication, RBAC and a PriorityClass."""
    if pkg == "jax":
        from kubernetes_tpu.api.meta import ObjectMeta
        from kubernetes_tpu.api.types import PriorityClass
        from kubernetes_tpu.apiserver.admission import default_admission_chain
        from kubernetes_tpu.apiserver.auth import (
            RBACAuthorizer, TokenAuthenticator, User, bootstrap_policy)
        from kubernetes_tpu.apiserver.server import APIServer
        from kubernetes_tpu.store import Store
    else:
        from kubernetes_tpu_torch.api.meta import ObjectMeta
        from kubernetes_tpu_torch.api.types import PriorityClass
        from kubernetes_tpu_torch.apiserver.admission import (
            default_admission_chain)
        from kubernetes_tpu_torch.apiserver.auth import (
            RBACAuthorizer, TokenAuthenticator, User, bootstrap_policy)
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.store import Store
    store = Store()
    for obj in bootstrap_policy():
        store.create(obj)
    store.create(PriorityClass(meta=ObjectMeta(name="high", namespace=""),
                               value=1000))
    authn = TokenAuthenticator({
        "admin-token": User("admin", ("system:masters",)),
        "viewer-token": User("alice", ()),
    })
    server = APIServer(store, admission=default_admission_chain(store),
                       authenticator=authn, authorizer=RBACAuthorizer(store))
    server.serve(0)
    return store, server


def _run_sequence(url: str, reqs: list[tuple]) -> list:
    out = []
    for method, path, body, token in reqs:
        code, got = _http(url, method, path, body, token)
        out.append((method, path, code, _mask(got, url)))
    # a watch from revision 0 replays the pod events of the sequence
    frames = _watch_lines(url, "/api/v1/Pod?watch=1&resourceVersion=0", 6,
                          "admin-token")
    out.append(("WATCH", "/api/v1/Pod", len(frames), _mask(frames, url)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_differential_rest_sequence(seed):
    reqs = _requests(seed)
    outs = {}
    for pkg in ("jax", "torch"):
        store, server = _server(pkg)
        try:
            outs[pkg] = _run_sequence(server.url, reqs)
        finally:
            server.shutdown()
    codes = {c for _, _, c, _ in outs["torch"]}
    # the sequence reaches every outcome it is meant to cover
    assert {200, 201, 400, 401, 403, 404, 409, 422} <= codes, codes
    assert len(outs["jax"]) == len(outs["torch"])
    for want, got in zip(outs["jax"], outs["torch"]):
        assert got == want
