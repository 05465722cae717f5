"""apiregistration.k8s.io — APIService objects for the aggregation layer.

Reference: staging/src/k8s.io/kube-aggregator/pkg/apis/apiregistration —
the aggregator (first server in the reference's delegation chain,
cmd/kube-apiserver/app/server.go:176) proxies every request under
/apis/<group>/<version>/ to the Service named by the matching APIService,
so out-of-process servers (metrics-server being the canonical one) mount
API groups into the main server's surface and discovery.

Here the ServiceReference is a base URL (the delegate's listener): the
main server proxies method/body/query through and merges the group into
/apis discovery. Names follow the reference's "<version>.<group>"
convention.

A copy of the reference package's module
(kubernetes_tpu/api/registration.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta


@dataclass
class APIServiceSpec:
    """APIServiceSpec subset: the ServiceReference collapses to the
    delegate's base URL; groupPriorityMinimum ordering is by name."""

    group: str = ""
    version: str = ""
    # delegate base URL, e.g. "http://127.0.0.1:9443" — the proxy appends
    # the original request path (/apis/<group>/<version>/...); an empty
    # URL makes the group discoverable but unavailable (503), matching an
    # APIService whose backing Service has no endpoints
    service_url: str = ""
    insecure_skip_tls_verify: bool = True


@dataclass
class APIService:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: APIServiceSpec = field(default_factory=APIServiceSpec)
    # {"conditions": [{"type": "Available", "status": "True"|"False", ...}]}
    status: dict = field(default_factory=dict)

    kind = "APIService"

    @staticmethod
    def expected_name(group: str, version: str) -> str:
        return f"{version}.{group}"
