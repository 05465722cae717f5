"""The aggregation layer: /apis/<group>/<version> proxying + the metrics
delegate (the repo's own first aggregated API).

Reference: staging/src/k8s.io/kube-aggregator — proxy_handler.go forwards
the verbatim request to the APIService's backing service and streams the
response back; apiserver availability is surfaced as the Available
condition; /apis discovery merges every registered group
(apiservice_controller + handler_apis.go).

The metrics delegate mirrors metrics-server's surface
(/apis/metrics.k8s.io/v1beta1 nodes + pods, the canonical aggregated API):
usage here is the request-based accounting our in-memory CRI tracks — the
point is the aggregation CONTRACT (an out-of-process group mounted through
the main server), not cadvisor parity.

A copy of the reference package's module
(kubernetes_tpu/apiserver/aggregator.py).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import request as _urlreq
from urllib.error import HTTPError, URLError


def find_apiservice(store, group: str, version: str):
    """The APIService covering group/version, by the reference's
    '<version>.<group>' naming convention (falls back to a field scan so a
    misnamed object still resolves)."""
    svc = store.try_get("APIService", f"{version}.{group}")
    if svc is not None:
        return svc
    for svc in store.list_refs("APIService"):
        if svc.spec.group == group and svc.spec.version == version:
            return svc
    return None


def proxy_request(svc, method: str, path: str, query: str, body: bytes,
                  content_type: str, user: str = "",
                  timeout_s: float = 10.0):
    """Forward one request to the delegate; returns (code, ctype, body).
    Raises URLError/OSError for unreachable delegates (callers map that to
    503 + the Available=False condition, aggregator semantics)."""
    url = svc.spec.service_url.rstrip("/") + path
    if query:
        url += f"?{query}"
    headers = {"Content-Type": content_type or "application/json"}
    if user:
        # the reference forwards authenticated identity via X-Remote-User
        # (request header authn on the delegate side)
        headers["X-Remote-User"] = user
    req = _urlreq.Request(url, data=body if body else None, method=method,
                          headers=headers)
    try:
        with _urlreq.urlopen(req, timeout=timeout_s) as r:
            return (r.status, r.headers.get("Content-Type",
                                            "application/json"), r.read())
    except HTTPError as e:
        # delegate answered with an error status: proxy it verbatim
        return (e.code, e.headers.get("Content-Type", "application/json"),
                e.read())


def api_group_list(store) -> dict:
    """GET /apis — metav1.APIGroupList merged from registered APIServices
    (handler_apis.go)."""
    groups: dict[str, list[str]] = {}
    for svc in store.list_refs("APIService"):
        groups.setdefault(svc.spec.group, []).append(svc.spec.version)
    return {
        "kind": "APIGroupList",
        "groups": [
            {
                "name": g,
                "versions": [
                    {"groupVersion": f"{g}/{v}", "version": v}
                    for v in sorted(vs)
                ],
                "preferredVersion": {
                    "groupVersion": f"{g}/{sorted(vs)[0]}",
                    "version": sorted(vs)[0],
                },
            }
            for g, vs in sorted(groups.items())
        ],
    }


def set_available_condition(store, svc, available: bool, message: str) -> None:
    """Surface delegate reachability as the Available condition
    (apiservice status controller). Best-effort: a CAS race just means a
    fresher writer won."""
    want = "True" if available else "False"
    try:
        # cheap unchanged check first — this runs per proxied request
        ref = next((s for s in store.list_refs("APIService")
                    if s.meta.key == svc.meta.key), None)
        if ref is None:
            return
        conds = ref.status.get("conditions") or []
        if any(c.get("type") == "Available" and c.get("status") == want
               for c in conds):
            return
        cur = store.try_get("APIService", svc.meta.key)
        if cur is None:
            return
        cur.status["conditions"] = [{
            "type": "Available",
            "status": want,
            "message": message,
        }]
        store.update(cur, check_version=False)
    except Exception:  # noqa: BLE001 - status is advisory
        pass


# -- the metrics delegate ----------------------------------------------------

METRICS_GROUP = "metrics.k8s.io"
METRICS_VERSION = "v1beta1"


class MetricsAPIServer:
    """An out-of-process-style aggregated API server (metrics-server's
    role): its own HTTP listener serving the metrics.k8s.io/v1beta1 group,
    reading cluster state from the store. Mounted into the main server by
    creating an APIService pointing at `url`."""

    def __init__(self, store):
        self.store = store
        self._httpd: ThreadingHTTPServer | None = None

    # usage source: the kubelet-published PodMetrics objects (the SAME
    # pipeline the HPA consumes — one truth for both surfaces); pods whose
    # kubelet hasn't published yet fall back to request-based accounting
    # so fresh clusters still report something deterministic
    def _usage_of(self, pod, names) -> tuple[int, int]:
        """(milli-CPU, MiB) for one scheduled pod."""
        from ..scheduler.nodeinfo import PodInfo

        pm = self.store.try_get("PodMetrics", pod.meta.key)
        if pm is not None:
            return pm.cpu_usage_milli, pm.memory_usage_bytes >> 20
        pi = PodInfo(pod, names)
        return pi.request.v[0], pi.request.v[1]

    def node_metrics(self) -> dict:
        from ..api.resource import ResourceNames

        names = ResourceNames()
        usage: dict[str, list] = {}
        for pod in self.store.list_refs("Pod"):
            node = pod.spec.node_name
            if not node:
                continue
            cpu, mem = self._usage_of(pod, names)
            u = usage.setdefault(node, [0, 0])
            u[0] += cpu
            u[1] += mem
        items = []
        for node in self.store.list_refs("Node"):
            u = usage.get(node.meta.name, [0, 0])
            items.append({
                "metadata": {"name": node.meta.name},
                "usage": {"cpu": f"{u[0]}m", "memory": f"{u[1]}Mi"},
            })
        return {"kind": "NodeMetricsList",
                "apiVersion": f"{METRICS_GROUP}/{METRICS_VERSION}",
                "items": items}

    def pod_metrics(self, namespace: str = "") -> dict:
        from ..api.resource import ResourceNames

        names = ResourceNames()
        items = []
        for pod in self.store.list_refs("Pod"):
            if not pod.spec.node_name:
                continue
            if namespace and pod.meta.namespace != namespace:
                continue
            cpu, mem = self._usage_of(pod, names)
            items.append({
                "metadata": {"name": pod.meta.name,
                             "namespace": pod.meta.namespace},
                "containers": [{
                    "name": c.name,
                    "usage": {"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                } for c in pod.spec.containers],
            })
        return {"kind": "PodMetricsList",
                "apiVersion": f"{METRICS_GROUP}/{METRICS_VERSION}",
                "items": items}

    def resource_list(self) -> dict:
        return {
            "kind": "APIResourceList",
            "groupVersion": f"{METRICS_GROUP}/{METRICS_VERSION}",
            "resources": [
                {"name": "nodes", "kind": "NodeMetrics", "namespaced": False,
                 "verbs": ["get", "list"]},
                {"name": "pods", "kind": "PodMetrics", "namespaced": True,
                 "verbs": ["get", "list"]},
            ],
        }

    def serve(self, port: int = 0) -> None:
        delegate = self

        class Handler(BaseHTTPRequestHandler):
            def _json(self, code: int, doc: dict) -> None:
                data = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _not_found(self):
                self._json(404, {"kind": "Status", "status": "Failure",
                                 "reason": "NotFound", "code": 404})

            def _one_of(self, doc: dict, name: str, ns: str = "") -> None:
                for item in doc["items"]:
                    m = item["metadata"]
                    if m["name"] == name and (not ns
                                              or m.get("namespace") == ns):
                        self._json(200, item)
                        return
                self._not_found()

            def do_GET(self):
                base = f"/apis/{METRICS_GROUP}/{METRICS_VERSION}"
                path = self.path.split("?", 1)[0].rstrip("/")
                if not path.startswith(base):
                    self._not_found()
                    return
                rest = [p for p in path[len(base):].split("/") if p]
                # metrics-server surface: nodes[/name], pods[/name],
                # namespaces/<ns>/pods[/<name>]
                if not rest:
                    self._json(200, delegate.resource_list())
                elif rest[0] == "nodes":
                    if len(rest) == 1:
                        self._json(200, delegate.node_metrics())
                    else:
                        self._one_of(delegate.node_metrics(), rest[1])
                elif rest[0] == "pods":
                    if len(rest) == 1:
                        self._json(200, delegate.pod_metrics())
                    else:
                        self._one_of(delegate.pod_metrics(), rest[1])
                elif rest[0] == "namespaces" and len(rest) >= 3 \
                        and rest[2] == "pods":
                    ns = rest[1]
                    if len(rest) == 3:
                        self._json(200, delegate.pod_metrics(namespace=ns))
                    else:
                        self._one_of(delegate.pod_metrics(namespace=ns),
                                     rest[3], ns)
                else:
                    self._not_found()

            def log_message(self, *a):  # noqa: N802
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    @property
    def url(self) -> str:
        assert self._httpd is not None
        return f"http://127.0.0.1:{self._httpd.server_port}"

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()


def register_metrics_apiservice(store, delegate: MetricsAPIServer):
    """Create the APIService mounting the metrics delegate (what
    metrics-server's manifest does)."""
    from ..api.meta import ObjectMeta
    from ..api.registration import APIService, APIServiceSpec

    svc = APIService(
        meta=ObjectMeta(
            name=APIService.expected_name(METRICS_GROUP, METRICS_VERSION),
            namespace="",
        ),
        spec=APIServiceSpec(group=METRICS_GROUP, version=METRICS_VERSION,
                            service_url=delegate.url),
    )
    if store.try_get("APIService", svc.meta.key) is None:
        store.create(svc)
    return svc
