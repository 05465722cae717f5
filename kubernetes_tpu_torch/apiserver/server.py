"""API server: REST + watch streaming over the versioned store.

Reference: cmd/kube-apiserver + staging/src/k8s.io/apiserver — the server
chain (CreateServerChain, cmd/kube-apiserver/app/server.go:176) collapses to
one handler here because aggregation/apiextensions don't apply; what is
preserved is the resource REST contract every component programs against:

  GET    /api/v1/{kind}                          list (+ ?watch=1&resourceVersion=N)
  GET    /api/v1/{kind}/{key...}                 get
  POST   /api/v1/{kind}                          create
  PUT    /api/v1/{kind}/{key...}                 update (resourceVersion CAS -> 409)
  DELETE /api/v1/{kind}/{key...}                 delete
  POST   /api/v1/{kind}/{key...}/binding         pod binding subresource

Watch responses stream JSON lines ({"type": ADDED|MODIFIED|DELETED,
"object": ...}) exactly like the reference's watch event frames. The etcd3
storage.Interface role is played by store.Store; the watch cache is the
store's per-kind event fan-out.

An admission-plugin chain runs on create/update (mutating + validating),
mirroring the generic server's handler chain (authn/authz are pluggable
no-ops by default — in-tree clients are trusted the way localhost:8080
insecure serving was).

A copy of the reference package's module
(kubernetes_tpu/apiserver/server.py). The store's iter_kind and try_delete
are the port's store.iter_kind and store.try_delete helpers over Store.list
and Store.delete.
"""

from __future__ import annotations

import json
import re
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable
from urllib.parse import parse_qs, urlparse

from ..api.serialization import decode, encode, kind_class
from ..store import iter_kind, try_delete
from ..store.store import (
    AlreadyExistsError,
    CompactedError,
    ConflictError,
    NotFoundError,
    Store,
)

# admission: fn(operation, obj) -> None | raises AdmissionError
AdmissionFn = Callable[[str, object], None]

# field-selector paths the reference supports per resource, generalized:
# dotted attribute walk over the object (metadata.* maps to meta.*)
_FIELD_ALIASES = {
    "metadata.name": ("meta", "name"),
    "metadata.namespace": ("meta", "namespace"),
    "spec.nodeName": ("spec", "node_name"),
    "spec.schedulerName": ("spec", "scheduler_name"),
    "status.phase": ("status", "phase"),
}


_LABEL_TOKEN = r"[A-Za-z0-9]([-A-Za-z0-9_./]*[A-Za-z0-9])?"


_LABEL_TOKEN_RE = re.compile(f"^{_LABEL_TOKEN}$")

# sentinel user for insecure serving (no authenticator configured): the
# whole authn/authz chain is off, every request is trusted
_TRUSTED = object()


class AuditLog:
    """The audit stage of the handler chain (staging/.../apiserver/pkg/
    audit): one entry per request — who did what to which resource with
    what outcome — kept in a bounded ring and streamed to an optional sink
    (the audit-webhook/log-backend role)."""

    def __init__(self, capacity: int = 1024, sink=None):
        import collections

        self.entries = collections.deque(maxlen=capacity)
        self.sink = sink
        self._lock = threading.Lock()

    def record(self, user: str, verb: str, resource: str, key: str,
               code: int) -> None:
        entry = {"user": user, "verb": verb, "resource": resource,
                 "key": key, "code": code, "ts": _time.time()}
        with self._lock:
            self.entries.append(entry)
        if self.sink is not None:
            self.sink(entry)

    def find(self, **match) -> list[dict]:
        with self._lock:
            return [e for e in self.entries
                    if all(e.get(k) == v for k, v in match.items())]


def parse_label_selector(expr: str) -> list[tuple[str, str, str]]:
    """'k=v,k2!=v2,k3' → [(key, op, value)]; op ∈ {'=', '!=', 'exists'}.

    Strict on syntax: the set-based forms ('k in (a,b)', gt/lt) the
    reference ALSO accepts are not implemented here — they raise
    ValueError (→ 400) rather than silently matching nothing."""
    token = _LABEL_TOKEN_RE
    out = []
    for part in expr.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, _, v = part.partition("!=")
            op = "!="
        elif "=" in part:
            k, _, v = part.partition("==" if "==" in part else "=")
            v = v.lstrip("=")
            op = "="
        else:
            k, v, op = part, "", "exists"
        k, v = k.strip(), v.strip()
        if not token.match(k) or (v and not token.match(v)):
            raise ValueError(f"unsupported label selector part {part!r}")
        out.append((k, op, v))
    return out


def matches_label_selector(obj, sel: list[tuple[str, str, str]]) -> bool:
    labels = getattr(obj.meta, "labels", {}) or {}
    for k, op, v in sel:
        if op == "exists":
            if k not in labels:
                return False
        elif op == "=":
            if labels.get(k) != v:
                return False
        elif labels.get(k) == v:  # !=
            return False
    return True


def parse_field_selector(expr: str) -> list[tuple[tuple[str, ...], bool, str]]:
    """'spec.nodeName=n1,metadata.name!=x' → [(attr path, negated, value)].
    Unknown fields raise ValueError (the reference 400s them). Parsed ONCE
    per request; matching is pure attribute walks."""
    out = []
    for part in expr.split(","):
        part = part.strip()
        if not part:
            continue
        neg = "!=" in part
        k, _, v = part.partition("!=" if neg else "=")
        path = _FIELD_ALIASES.get(k.strip())
        if path is None:
            raise ValueError(f"unsupported field selector {k.strip()!r}")
        out.append((path, neg, v.strip()))
    return out


def matches_field_selector(obj, sel: list[tuple[tuple[str, ...], bool, str]]) -> bool:
    for path, neg, v in sel:
        cur = obj
        for attr in path:
            cur = getattr(cur, attr, None)
            if cur is None:
                break
        got = "" if cur is None else str(cur)
        if neg:
            if got == v:
                return False
        elif got != v:
            return False
    return True


class AdmissionError(Exception):
    def __init__(self, message: str, code: int = 422):
        super().__init__(message)
        self.code = code


class APIServer:
    def __init__(self, store: Store, admission: list[AdmissionFn] | None = None,
                 authenticator=None, authorizer=None, tracer=None,
                 audit: AuditLog | None = None, metrics=None):
        """authenticator/authorizer None = the chain stage is skipped
        (insecure localhost serving, the in-tree trust model); passing a
        TokenAuthenticator + RBACAuthorizer (apiserver/auth.py) turns on
        the generic server's authn→authz handler-chain stages. tracer (a
        utils.tracing.Tracer) emits one span per request — the request-
        filter spans of component-base/tracing. Every API request is
        audit-logged (who/verb/resource/outcome) to `audit`. metrics (a
        utils.metrics.Registry or any object with expose()) serves its text
        exposition at /metrics next to /debug/pprof/profile — the
        routes.DefaultMetrics + routes.Profiling debug surface."""
        self.store = store
        self.tracer = tracer
        self.metrics = metrics
        self.audit = audit or AuditLog()
        self.admission = list(admission or [])
        self.authenticator = authenticator
        self.authorizer = authorizer
        # versioned-conversion scheme: wire objects carrying an apiVersion
        # other than v1 are converted at the codec boundary (runtime.Scheme)
        from ..api.versioning import default_scheme

        self.scheme = default_scheme()
        # serializes admission+create per namespace: quota admission checks
        # live usage, and with ThreadingHTTPServer two concurrent creates in
        # one namespace could otherwise both pass the check and both commit
        # (the reference serializes via CAS on ResourceQuota status)
        self._create_locks: dict[str, threading.Lock] = {}
        self._create_locks_mu = threading.Lock()
        # re-establish dynamic kinds from a pre-populated store (restart
        # from snapshot: the scheme must serve existing CRDs immediately,
        # as apiextensions does on startup)
        from ..api.extensions import register_custom_kind

        for crd in iter_kind(store, "CustomResourceDefinition"):
            register_custom_kind(crd)
        self._http: ThreadingHTTPServer | None = None
        self.port = 0

    # -- request handling ----------------------------------------------------

    def _build_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _wants_cbor(self) -> bool:
                return "application/cbor" in (self.headers.get("Accept") or "")

            def _send_json(self, code: int, payload) -> None:
                """Content-negotiated object response: CBOR when the client
                Accepts it (the binary serializer role of apimachinery's
                protobuf/CBOR formats), JSON otherwise."""
                if self._wants_cbor():
                    from ..api import cbor

                    data = cbor.dumps(payload)
                    ctype = "application/cbor"
                else:
                    data = json.dumps(payload).encode()
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _error(self, code: int, reason: str, message: str) -> None:
                # metav1.Status error shape
                self._send_json(code, {
                    "kind": "Status", "status": "Failure",
                    "reason": reason, "message": message, "code": code,
                })

            def _route(self):
                parsed = urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
                # /api/v1/{kind}[/{ns or name}[/{name}[/{subresource}]]]
                if len(parts) < 3 or parts[0] != "api" or parts[1] != "v1":
                    return None
                kind = parts[2]
                rest = parts[3:]
                sub = ""
                if rest and rest[-1] in ("binding", "status", "log",
                                         "token"):
                    # subresource only when a full object key PRECEDES the
                    # suffix (ns/name, or bare name for cluster-scoped) —
                    # otherwise a pod literally named "log" is unreachable
                    from .discovery import CLUSTER_SCOPED

                    expect = 1 if kind in CLUSTER_SCOPED else 2
                    if len(rest) == expect + 1:
                        sub = rest[-1]
                        rest = rest[:-1]
                key = "/".join(rest)
                return kind, key, sub, query

            def _read_body(self):
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                if not raw:
                    return {}
                ctype = self.headers.get("Content-Type") or ""
                if "application/cbor" in ctype:
                    from ..api import cbor

                    return cbor.loads(raw)
                return json.loads(raw)

            def _authenticate(self):
                """Run the authn stage; returns the user, or None after
                having sent the 401. A None authenticator means the chain
                is off (insecure serving) — returns the trusted marker."""
                from .auth import AuthenticationError

                if server.authenticator is None:
                    return _TRUSTED
                try:
                    user = server.authenticator.authenticate(
                        self.headers.get("Authorization")
                    )
                    self._audit_user = user.name
                    return user
                except AuthenticationError as e:
                    self._error(401, "Unauthorized", str(e))
                    return None

            def _authorized(self, verb: str, kind: str, key: str,
                            namespace: str | None = None) -> bool:
                """authn → authz chain stages (generic server handler
                chain); sends the 401/403 itself when the request fails.
                namespace overrides the key-derived one (creates carry the
                namespace in the body, not the flat URL)."""
                user = self._authenticate()
                if user is None:
                    return False
                if user is _TRUSTED or server.authorizer is None:
                    return True
                from .auth import Attributes

                if namespace is None:
                    namespace = key.split("/", 1)[0] if "/" in key else ""
                ok = server.authorizer.authorize(
                    Attributes(user=user, verb=verb, resource=kind,
                               namespace=namespace)
                )
                if not ok:
                    self._error(
                        403, "Forbidden",
                        f'user "{user.name}" cannot {verb} resource "{kind}"',
                    )
                return ok

            def _proxy_pod_logs(self, key: str, query: dict) -> None:
                from urllib.request import urlopen

                try:
                    pod = server.store.get("Pod", key)
                except NotFoundError:
                    self._error(404, "NotFound", f"pod {key} not found")
                    return
                if not pod.spec.node_name:
                    self._error(400, "BadRequest", "pod is not scheduled")
                    return
                try:
                    node = server.store.get("Node", pod.spec.node_name)
                except NotFoundError:
                    self._error(404, "NotFound", "pod's node is gone")
                    return
                port = node.status.daemon_endpoint_port
                if not port:
                    self._error(503, "ServiceUnavailable",
                                "node's kubelet endpoint is unknown")
                    return
                container = query.get("container", "")
                ns, name = key.split("/", 1)
                url = (f"http://127.0.0.1:{port}/containerLogs/"
                       f"{ns}/{name}/{container}")
                if query.get("tailLines"):
                    url += f"?tailLines={query['tailLines']}"
                try:
                    with urlopen(url, timeout=10) as resp:
                        body = resp.read()
                        code = resp.status
                except Exception as e:  # noqa: BLE001 - proxied verbatim
                    import urllib.error

                    if isinstance(e, urllib.error.HTTPError):
                        body, code = e.read(), e.code
                    else:
                        self._error(502, "BadGateway", f"kubelet: {e}")
                        return
                self.send_response(code)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _handle_aggregated(self) -> None:
                """The aggregation layer (kube-aggregator's role, the FIRST
                server in the reference's delegation chain): everything
                under /apis/ resolves through APIService objects — group
                discovery is merged here, resource requests proxy verbatim
                to the registered delegate, and delegate reachability is
                surfaced as the Available condition (503 when down)."""
                from urllib.error import URLError

                from . import aggregator
                from .auth import ANONYMOUS

                # drain the request body FIRST: every early-exit response
                # below would otherwise desync a keep-alive connection
                # (unread body bytes parse as the next request line)
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                user = self._authenticate()
                if user is None:
                    return
                uname = "" if user is _TRUSTED else user.name
                if user is not _TRUSTED and user.name == ANONYMOUS:
                    self._error(403, "Forbidden",
                                "discovery requires authentication")
                    return
                parsed = urlparse(self.path)
                parts = [p for p in parsed.path.split("/") if p]
                if len(parts) == 1:  # GET /apis
                    self._send_json(
                        200, aggregator.api_group_list(server.store))
                    return
                group = parts[1]
                if len(parts) == 2:  # GET /apis/<group>
                    doc = aggregator.api_group_list(server.store)
                    g = next((x for x in doc["groups"]
                              if x["name"] == group), None)
                    if g is None:
                        self._error(404, "NotFound",
                                    f"no APIService serves group {group!r}")
                        return
                    self._send_json(200, {"kind": "APIGroup", **g})
                    return
                version = parts[2]
                # RBAC runs HERE, before the proxy: the delegate trusts the
                # forwarded identity, so an unauthorized verb must never
                # reach it (verb mapping mirrors the native routes; the
                # resource attribute is the aggregated group)
                verb = {"GET": "get", "POST": "create", "PUT": "update",
                        "PATCH": "patch", "DELETE": "delete"}.get(
                            self.command, self.command.lower())
                if verb == "get" and len(parts) == 4:
                    verb = "list"
                if not self._authorized(verb, group, "/".join(parts[3:])):
                    return
                svc = aggregator.find_apiservice(server.store, group, version)
                if svc is None:
                    self._error(404, "NotFound",
                                f"no APIService for {group}/{version}")
                    return
                if not svc.spec.service_url:
                    self._error(503, "ServiceUnavailable",
                                f"APIService {svc.meta.name} has no service"
                                " reference")
                    return
                try:
                    code, ctype, data = aggregator.proxy_request(
                        svc, self.command, parsed.path, parsed.query, body,
                        self.headers.get("Content-Type", ""), uname,
                    )
                except (URLError, OSError, ValueError) as e:
                    aggregator.set_available_condition(
                        server.store, svc, False, str(e))
                    self._error(503, "ServiceUnavailable",
                                f"APIService {svc.meta.name} is unavailable:"
                                f" {e}")
                    return
                aggregator.set_available_condition(
                    server.store, svc, True, "delegate reachable")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _send_text(self, code: int, text: str,
                           ctype: str = "text/plain") -> None:
                data = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz" or self.path == "/readyz":
                    self._send_json(200, {"status": "ok"})
                    return
                # debug routes (routes.DefaultMetrics / routes.Profiling{}
                # .Install): text exposition + on-demand sampling profile
                if self.path == "/metrics":
                    if server.metrics is None:
                        self._error(404, "NotFound", "no metrics registry")
                        return
                    self._send_text(200, server.metrics.expose(),
                                    "text/plain; version=0.0.4")
                    return
                if self.path.split("?")[0] == "/debug/pprof/profile":
                    from ..utils.pprof import take_profile

                    q = parse_qs(urlparse(self.path).query)
                    try:
                        secs = min(float(q.get("seconds", ["1"])[0]), 30.0)
                    except ValueError:
                        self._error(400, "BadRequest",
                                    "seconds must be a number")
                        return
                    self._send_text(200, take_profile(seconds=secs))
                    return
                if self.path == "/apis" or self.path.startswith("/apis/"):
                    self._handle_aggregated()
                    return
                if self.path == "/version":
                    self._send_json(200, {"gitVersion": "v1.36.0-tpu",
                                          "platform": "tpu"})
                    return
                if self.path in ("/api", "/api/v1", "/openapi/v2"):
                    # discovery requires authentication (the reference
                    # grants system:discovery to authenticated users, not
                    # anonymous); any authenticated user is allowed
                    from .auth import ANONYMOUS

                    user = self._authenticate()
                    if user is None:
                        return
                    if user is not _TRUSTED and user.name == ANONYMOUS:
                        self._error(403, "Forbidden",
                                    "discovery requires authentication")
                        return
                    from . import discovery

                    doc = (discovery.api_versions() if self.path == "/api"
                           else discovery.api_resource_list()
                           if self.path == "/api/v1"
                           else discovery.openapi_v2())
                    self._send_json(200, doc)
                    return
                route = self._route()
                if route is None:
                    self._error(404, "NotFound", "unknown path")
                    return
                kind, key, sub, query = route
                if sub == "log":
                    # pods/log subresource: proxy to the pod's kubelet
                    # (registry/core/pod LogREST → node daemonEndpoints),
                    # gated behind the separate pods/log RBAC resource
                    if kind != "Pod":
                        self._error(404, "NotFound", "log is a pod subresource")
                        return
                    if not self._authorized("get", "Pod/log", key):
                        return
                    self._proxy_pod_logs(key, query)
                    return
                verb = "get" if key else ("watch" if query.get("watch") else "list")
                if not self._authorized(verb, kind, key):
                    return
                try:
                    # both selectors parse (and thus validate) BEFORE any
                    # stream headers go out: bad syntax must 400, not kill
                    # a live watch mid-stream
                    lsel = (parse_label_selector(query["labelSelector"])
                            if "labelSelector" in query else None)
                    fsel = (parse_field_selector(query["fieldSelector"])
                            if "fieldSelector" in query else None)

                    def selected(obj) -> bool:
                        if lsel is not None and not matches_label_selector(obj, lsel):
                            return False
                        return fsel is None or matches_field_selector(obj, fsel)

                    if key:
                        obj = server.store.get(kind, key)
                        want_version = query.get("apiVersion", "")
                        if want_version not in ("", "v1"):
                            self._send_json(
                                200,
                                server.scheme.encode_versioned(
                                    obj, want_version
                                ),
                            )
                            return
                        self._send_json(200, encode(obj))
                    elif query.get("watch"):
                        self._serve_watch(
                            kind, int(query.get("resourceVersion", 0)),
                            selected if (lsel is not None
                                         or fsel is not None) else None,
                        )
                    else:
                        items, rev = server.store.list(kind)
                        self._send_json(200, {
                            "kind": f"{kind}List",
                            "metadata": {"resourceVersion": rev},
                            "items": [encode(o) for o in items if selected(o)],
                        })
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))
                except CompactedError as e:
                    # etcd compaction → 410 Gone ("Expired"): client relists
                    self._error(410, "Expired", str(e))
                except ValueError as e:
                    self._error(400, "BadRequest", str(e))

            def _serve_watch(self, kind: str, from_revision: int,
                             selected=None) -> None:
                """selected: optional predicate — events whose object
                doesn't match are dropped server-side (the watch-cache
                selector filtering of staging/.../storage/cacher). Selector
                transitions follow cacher semantics exactly: an object
                MODIFIED out of the selector synthesizes DELETED (carrying
                the current object), one MODIFIED into it synthesizes
                ADDED — detected via Event.prev_obj, the PrevObject of
                cacher's watchCacheEvent."""
                watch = server.store.watch(kind, from_revision=from_revision)
                use_cbor = self._wants_cbor()
                if use_cbor:
                    from ..api import cbor
                try:
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "application/cbor-seq" if use_cbor else "application/json",
                    )
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def write_chunk(data: bytes) -> None:
                        self.wfile.write(f"{len(data):X}\r\n".encode())
                        self.wfile.write(data + b"\r\n")
                        self.wfile.flush()

                    while not watch.stopped:
                        ev = watch.next(timeout=0.5)
                        if ev is None:
                            # heartbeat chunk: a dead client surfaces as a
                            # broken pipe here instead of leaking the handler
                            # thread + store watch forever on quiet kinds
                            write_chunk(b"\x00\x00\x00\x00" if use_cbor else b"\n")
                            continue
                        ev_type = ev.type
                        if selected is not None:
                            curr = selected(ev.obj)
                            # a MODIFIED without prev_obj degrades to a plain
                            # MODIFIED (prev := curr), never a spurious ADDED
                            prev = (selected(ev.prev_obj)
                                    if ev.prev_obj is not None else curr)
                            if ev_type == "MODIFIED" and curr and not prev:
                                ev_type = "ADDED"  # transitioned in
                            elif ev_type == "MODIFIED" and prev and not curr:
                                ev_type = "DELETED"  # transitioned out
                            elif not curr:
                                continue
                        payload = {"type": ev_type, "object": encode(ev.obj),
                                   "revision": ev.revision}
                        if use_cbor:
                            # length-prefixed CBOR frames: binary bodies
                            # aren't newline-delimitable
                            frame = cbor.dumps(payload)
                            write_chunk(len(frame).to_bytes(4, "big") + frame)
                        else:
                            write_chunk(json.dumps(payload).encode() + b"\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    watch.stop()

            def do_POST(self):
                if self.path.startswith("/apis/"):
                    self._handle_aggregated()
                    return
                route = self._route()
                if route is None:
                    self._error(404, "NotFound", "unknown path")
                    return
                kind, key, sub, _ = route
                body = self._read_body()
                if sub == "log":
                    self._error(405, "MethodNotAllowed", "pods/log is GET-only")
                    return
                if sub in ("binding", "token"):
                    # the reference gates binding writes behind the separate
                    # pods/binding resource, NOT plain pod create — a
                    # create-only grant must not mutate existing pods; the
                    # serviceaccounts/token subresource is gated the same way
                    resource = f"{kind}/{sub}"
                else:
                    # authorize against where the object will actually land:
                    # decode applies the namespace default, the raw body may
                    # omit it
                    resource = kind
                from .discovery import CLUSTER_SCOPED

                if kind in CLUSTER_SCOPED:
                    # cluster-scoped creates authorize against namespace ""
                    # so only ClusterRoleBindings can grant them — a
                    # namespaced Role/RoleBinding must never be able to mint
                    # e.g. a ClusterRoleBinding (rbac.go: RoleBindings grant
                    # within their namespace only)
                    ns = ""
                elif key and "/" in key:
                    ns = key.split("/", 1)[0]
                else:
                    # mirror decode's ObjectMeta default ("default") so an
                    # omitted namespace is authorized where the object lands
                    ns = (body.get("meta") or {}).get("namespace", "default")
                if not self._authorized("create", resource, key, namespace=ns):
                    return
                try:
                    if sub == "token":
                        # TokenRequest subresource (authentication.k8s.io
                        # TokenRequest via serviceaccounts/token) — only
                        # the ServiceAccount kind carries it; authz ran
                        # against <kind>/token, so any other kind must 404
                        # rather than mint under the wrong RBAC resource
                        if kind != "ServiceAccount":
                            self._error(404, "NotFound",
                                        f"{kind} has no token subresource")
                            return
                        issuer = getattr(server.authenticator, "sa_issuer",
                                         None) if server.authenticator else None
                        if issuer is None:
                            self._error(400, "BadRequest",
                                        "token issuance not configured")
                            return
                        exp = int(body.get("expirationSeconds", 3600))
                        if exp <= 0:
                            self._error(400, "BadRequest",
                                        "expirationSeconds must be "
                                        "positive")
                            return
                        exp = max(exp, 600)  # the reference floors at 10m
                        ns, _, name = key.partition("/")
                        try:
                            token = issuer.issue(ns, name, exp)
                        except NotFoundError:
                            # issue() itself is the existence check — the
                            # SA is absent (or a delete raced the request)
                            self._error(404, "NotFound",
                                        f"ServiceAccount {key}")
                            return
                        self._send_json(201, {
                            "token": token,
                            "expirationSeconds": exp,
                        })
                        return
                    if sub == "binding":
                        # pods/binding subresource (registry/core/pod BindingREST)
                        pod = server.store.get(kind, key)
                        pod.spec.node_name = body.get("target_node") or body.get(
                            "target", {}
                        ).get("name", "")
                        server.store.update(pod, check_version=False)
                        self._send_json(201, {"status": "Success"})
                        return
                    from ..api.extensions import CustomObject

                    klass = kind_class(kind)
                    if (body.get("apiVersion", "") not in ("", "v1")
                            and not issubclass(klass, CustomObject)):
                        obj = server.scheme.decode_versioned(body)
                        if obj.kind != kind:
                            # authz ran against the URL kind; a body of a
                            # different kind would bypass it
                            self._error(400, "BadRequest",
                                        f"body kind {obj.kind!r} != URL "
                                        f"kind {kind!r}")
                            return
                    else:
                        # custom kinds carry their CRD group's apiVersion;
                        # they decode unversioned (apiextensions serves
                        # them without scheme conversion)
                        obj = decode(body, klass)
                    if key and obj.meta.key != key:
                        self._error(
                            400, "BadRequest",
                            f"body key {obj.meta.key!r} != URL key {key!r}",
                        )
                        return
                    created = self._commit_create(kind, obj)
                    self._send_json(201, encode(created))
                except AdmissionError as e:
                    self._error(e.code, "Invalid", str(e))
                except AlreadyExistsError as e:
                    self._error(409, "AlreadyExists", str(e))
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))
                except (KeyError, TypeError, ValueError) as e:
                    self._error(400, "BadRequest", f"undecodable body: {e}")

            def do_PATCH(self):
                if self.path.startswith("/apis/"):
                    self._handle_aggregated()
                    return
                """RFC 7386 JSON merge patch against the stored object
                (the reference's application/merge-patch+json strategy:
                objects merge recursively, null deletes a key, anything
                else replaces)."""
                route = self._route()
                if route is None:
                    self._error(404, "NotFound", "unknown path")
                    return
                kind, key, sub, query = route
                patch = self._read_body()
                if sub:
                    self._error(405, "MethodNotAllowed",
                                "subresources are not patchable")
                    return
                if not isinstance(patch, dict):
                    # a non-object root would REPLACE the whole object per
                    # RFC 7386 — never a valid API object
                    self._error(400, "BadRequest", "patch must be an object")
                    return
                if not self._authorized("patch", kind, key):
                    return
                if query.get("fieldManager"):
                    # server-side apply (fieldmanager): managedFields
                    # ownership + conflict detection + dropped-field removal
                    self._server_side_apply(kind, key, patch, query)
                    return

                def merge(base, delta):
                    if not isinstance(delta, dict) or not isinstance(base, dict):
                        return delta
                    out = dict(base)
                    for k, v in delta.items():
                        if v is None:
                            out.pop(k, None)
                        else:
                            out[k] = merge(out.get(k), v)
                    return out

                try:
                    cur = server.store.get(kind, key)
                    merged = merge(encode(cur), patch)
                    obj = decode(merged, kind_class(kind))
                    if obj.meta.key != key:
                        self._error(400, "BadRequest",
                                    "patch may not move the object")
                        return
                    # merge was computed against the live object: write it
                    # back at that revision (a racing writer wins the CAS
                    # and the client retries, apiserver patch semantics)
                    obj.meta.resource_version = cur.meta.resource_version
                    server._admit("UPDATE", obj)
                    updated = server.store.update(obj)
                    self._send_json(200, encode(updated))
                except AdmissionError as e:
                    self._error(e.code, "Invalid", str(e))
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))
                except ConflictError as e:
                    self._error(409, "Conflict", str(e))
                except (KeyError, TypeError, ValueError, AttributeError) as e:
                    self._error(400, "BadRequest", f"unmergeable patch: {e}")

            def do_PUT(self):
                if self.path.startswith("/apis/"):
                    self._handle_aggregated()
                    return
                route = self._route()
                if route is None:
                    self._error(404, "NotFound", "unknown path")
                    return
                kind, key, sub, query = route
                # body FIRST: an unauthorized PUT must still drain its
                # Content-Length bytes or the next request on this
                # keep-alive connection parses them as a request line
                body = self._read_body()
                if sub == "log":
                    self._error(405, "MethodNotAllowed", "pods/log is GET-only")
                    return
                if not self._authorized("update", kind, key):
                    return
                try:
                    from ..api.extensions import CustomObject

                    klass = kind_class(kind)
                    if (body.get("apiVersion", "") not in ("", "v1")
                            and not issubclass(klass, CustomObject)):
                        obj = server.scheme.decode_versioned(body)
                        if obj.kind != kind:
                            self._error(400, "BadRequest",
                                        f"body kind {obj.kind!r} != URL "
                                        f"kind {kind!r}")
                            return
                    else:
                        # custom kinds decode unversioned whatever group
                        # apiVersion they carry (as in do_POST)
                        obj = decode(body, klass)
                    if obj.meta.key != key:
                        # the authz decision above was made against the URL
                        # key; a body naming a different object would bypass
                        # it (the reference rejects URL/body mismatches)
                        self._error(
                            400, "BadRequest",
                            f"body key {obj.meta.key!r} != URL key {key!r}",
                        )
                        return
                    server._admit("UPDATE", obj)
                    check = query.get("force") != "true"
                    updated = server.store.update(obj, check_version=check)
                    self._send_json(200, encode(updated))
                except AdmissionError as e:
                    self._error(e.code, "Invalid", str(e))
                except ConflictError as e:
                    self._error(409, "Conflict", str(e))
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))
                except (KeyError, TypeError, ValueError) as e:
                    self._error(400, "BadRequest", f"undecodable body: {e}")

            def _commit_create(self, kind: str, obj):
                """The ONE create sequence (shared by POST and apply-create
                so they can't drift): unserialized admission chain (incl.
                webhook HTTP calls) → per-namespace lock around the quota
                check-and-commit pair (upstream also runs ResourceQuota as
                the last admission plugin) → post-commit CRD establishment
                (an admission denial must not leak scheme state)."""
                server._admit("CREATE", obj)
                with server._create_lock(getattr(obj.meta, "namespace", "")):
                    server._admit_serialized("CREATE", obj)
                    created = server.store.create(obj)
                if kind == "CustomResourceDefinition":
                    from ..api.extensions import register_custom_kind

                    register_custom_kind(created)
                return created

            def _server_side_apply(self, kind: str, key: str, applied: dict,
                                   query: dict) -> None:
                """fieldmanager apply: create-or-merge with ownership
                tracking; 409 names the conflicting manager unless
                force=true transfers the fields."""
                from .apply import ApplyConflict, apply_doc

                manager = query["fieldManager"]
                force = query.get("force") == "true"
                try:
                    cur = server.store.try_get(kind, key)
                    if cur is None and not self._authorized(
                        "create", kind, key
                    ):
                        # apply-create needs the create verb too (upstream
                        # authorizes both); patch alone must not mint
                        # objects. key-derived namespace matches do_POST's
                        # scoping: cluster-scoped keys carry no "/" -> ""
                        return
                    merged = apply_doc(None if cur is None else encode(cur),
                                       applied, manager, force)
                    obj = decode(merged, kind_class(kind))
                    if obj.meta.key != key:
                        self._error(400, "BadRequest",
                                    f"body key {obj.meta.key!r} != URL "
                                    f"key {key!r}")
                        return
                    if cur is None:
                        created = self._commit_create(kind, obj)
                        self._send_json(201, encode(created))
                        return
                    obj.meta.resource_version = cur.meta.resource_version
                    server._admit("UPDATE", obj)
                    updated = server.store.update(obj)
                    self._send_json(200, encode(updated))
                except ApplyConflict as e:
                    # distinct reason: a field-OWNERSHIP conflict needs the
                    # --force-conflicts remedy; a CAS race ("Conflict")
                    # just needs a retry — clients must tell them apart
                    self._error(409, "FieldManagerConflict", str(e))
                except AdmissionError as e:
                    self._error(e.code, "Invalid", str(e))
                except AlreadyExistsError as e:
                    self._error(409, "AlreadyExists", str(e))
                except ConflictError as e:
                    self._error(409, "Conflict", str(e))
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))
                except (KeyError, TypeError, ValueError, AttributeError) as e:
                    self._error(400, "BadRequest", f"undecodable body: {e}")

            def do_DELETE(self):
                if self.path.startswith("/apis/"):
                    self._handle_aggregated()
                    return
                # drain the body first: DELETE rarely carries one, but
                # unconsumed bytes desync the next keep-alive request
                self._read_body()
                route = self._route()
                if route is None:
                    self._error(404, "NotFound", "unknown path")
                    return
                kind, key, sub, _ = route
                if sub == "log":
                    self._error(405, "MethodNotAllowed", "pods/log is GET-only")
                    return
                if not self._authorized("delete", kind, key):
                    return
                try:
                    deleted = server.store.delete(kind, key)
                    if kind == "CustomResourceDefinition":
                        server._drop_custom_kind(deleted)
                    self._send_json(200, encode(deleted))
                except NotFoundError as e:
                    self._error(404, "NotFound", str(e))

            def log_message(self, *a):
                pass

        _VERB_BY_METHOD = {"POST": "create", "PUT": "update",
                           "PATCH": "patch", "DELETE": "delete"}

        def instrumented(method_fn):
            # request-filter wrapper: one root span per request
            # (component-base/tracing) + one audit entry per API request
            # (the audit stage of the handler chain)
            import functools

            @functools.wraps(method_fn)
            def wrapper(handler_self):
                handler_self._audit_user = "system:unsecured"
                handler_self._audit_code = 0

                def run():
                    return method_fn(handler_self)

                tracer = server.tracer
                try:
                    if tracer is not None and tracer.exporter is not None:
                        path = handler_self.path.split("?")[0]
                        with tracer.span(
                            f"HTTP {handler_self.command} {path}"
                        ):
                            return run()
                    return run()
                finally:
                    route = handler_self._route()
                    if route is not None:
                        kind, key, _sub, query = route
                        method = handler_self.command
                        if method == "GET":
                            # mirror the serving path's precedence exactly
                            # (key wins over ?watch): the audit verb must
                            # match what authz evaluated
                            verb = ("get" if key
                                    else "watch" if query.get("watch")
                                    else "list")
                        else:
                            verb = _VERB_BY_METHOD.get(method, method.lower())
                        server.audit.record(
                            handler_self._audit_user, verb, kind, key,
                            handler_self._audit_code,
                        )

            return wrapper

        _orig_send_response = Handler.send_response

        def send_response(handler_self, code, message=None):
            handler_self._audit_code = code
            return _orig_send_response(handler_self, code, message)

        Handler.send_response = send_response
        for verb in ("do_GET", "do_POST", "do_PUT", "do_PATCH",
                     "do_DELETE"):
            setattr(Handler, verb, instrumented(getattr(Handler, verb)))
        return Handler

    def _admit(self, operation: str, obj) -> None:
        for fn in self.admission:
            if not getattr(fn, "serialize_with_create", False):
                fn(operation, obj)

    def _admit_serialized(self, operation: str, obj) -> None:
        """Plugins that must be atomic with the following store commit
        (quota's check-and-reserve); runs under the per-namespace create
        lock, after the unserialized chain."""
        for fn in self.admission:
            if getattr(fn, "serialize_with_create", False):
                fn(operation, obj)

    def _create_lock(self, namespace: str) -> threading.Lock:
        with self._create_locks_mu:
            return self._create_locks.setdefault(namespace, threading.Lock())

    def _drop_custom_kind(self, crd) -> None:
        """CRD deletion cleanup: delete served instances, then retire the
        kind from the scheme (the apiextensions finalizer's job)."""
        from ..api.extensions import unregister_custom_kind

        kind = crd.spec.names.kind
        for obj in list(iter_kind(self.store, kind)):
            try_delete(self.store, kind, obj.meta.key)
        unregister_custom_kind(kind)

    # -- lifecycle -----------------------------------------------------------

    def serve(self, port: int = 0, tls_cert: str | None = None,
              tls_key: str | None = None) -> int:
        """Plain HTTP by default (insecure localhost, the in-tree trust
        model); with tls_cert/tls_key the listener serves HTTPS (the
        reference's secure serving — generate a pair with
        apiserver/certs.generate_self_signed; the cert doubles as the
        clients' CA)."""
        if bool(tls_cert) != bool(tls_key):
            raise ValueError(
                "tls_cert and tls_key must be provided together — a "
                "half-specified pair must not silently serve plaintext"
            )
        self._http = ThreadingHTTPServer(("127.0.0.1", port), self._build_handler())
        self._http.daemon_threads = True
        self._tls = False
        if tls_cert and tls_key:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._http.socket = ctx.wrap_socket(
                self._http.socket, server_side=True
            )
            self._tls = True
        t = threading.Thread(target=self._http.serve_forever, daemon=True)
        t.start()
        self.port = self._http.server_port
        return self.port

    @property
    def url(self) -> str:
        scheme = "https" if getattr(self, "_tls", False) else "http"
        return f"{scheme}://127.0.0.1:{self.port}"

    def shutdown(self) -> None:
        if self._http is not None:
            self._http.shutdown()
