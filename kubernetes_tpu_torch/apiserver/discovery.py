"""Discovery + OpenAPI documents, generated from the kind registry.

Reference: the apiserver serves /api and /apis group/version discovery
(APIResourceList — what kubectl uses to map kinds to endpoints) and
/openapi/v2|v3 schemas generated from the Go types. Here both documents are
reflected from the registered dataclasses: the kind registry is the
runtime.Scheme, so the discovery surface always matches what the server
actually decodes.

A copy of the reference package's module
(kubernetes_tpu/apiserver/discovery.py).
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import get_args, get_origin

from ..api.serialization import kind_class

# kinds that are cluster-scoped (namespace "" convention)
CLUSTER_SCOPED = {"Node", "Namespace", "CSINode", "PodGroup", "ClusterRole",
                  "ClusterRoleBinding", "PriorityClass", "ResourceSlice",
                  "DeviceClass", "StorageClass", "PersistentVolume",
                  "CustomResourceDefinition",
                  "ValidatingWebhookConfiguration",
                  "MutatingWebhookConfiguration",
                  "ValidatingAdmissionPolicy",
                  "ValidatingAdmissionPolicyBinding",
                  "APIService", "VolumeAttachment",
                  "CertificateSigningRequest"}

_VERBS = ["create", "delete", "get", "list", "update", "watch"]


def all_kinds() -> list[str]:
    from ..api import serialization

    serialization._register_all()
    return sorted(serialization._KINDS)


def api_versions() -> dict:
    """GET /api — metav1.APIVersions."""
    return {"kind": "APIVersions", "versions": ["v1"]}


def api_resource_list() -> dict:
    """GET /api/v1 — metav1.APIResourceList."""
    return {
        "kind": "APIResourceList",
        "groupVersion": "v1",
        "resources": [
            {
                "name": kind,
                "kind": kind,
                "namespaced": kind not in CLUSTER_SCOPED,
                "verbs": list(_VERBS),
            }
            for kind in all_kinds()
        ],
    }


def _schema_for(tp, defs: dict, seen: set) -> dict:
    origin = get_origin(tp)
    if tp is type(None):
        return {}
    if tp in (int,):
        return {"type": "integer"}
    if tp in (float,):
        return {"type": "number"}
    if tp in (bool,):
        return {"type": "boolean"}
    if tp in (str,):
        return {"type": "string"}
    if origin in (list, tuple, set):
        args = [a for a in get_args(tp) if a is not Ellipsis]
        item = _schema_for(args[0], defs, seen) if args else {}
        return {"type": "array", "items": item}
    if origin is dict:
        args = get_args(tp)
        val = _schema_for(args[1], defs, seen) if len(args) == 2 else {}
        return {"type": "object", "additionalProperties": val}
    if origin is typing.Union or origin is types.UnionType:
        # both typing.Optional[X] and PEP-604 `X | None` spellings
        non_none = [a for a in get_args(tp) if a is not type(None)]
        if len(non_none) == 1:
            return _schema_for(non_none[0], defs, seen)
        return {}
    if isinstance(tp, type) and dataclasses.is_dataclass(tp):
        name = tp.__name__
        if name not in seen:
            seen.add(name)
            defs[name] = _dataclass_schema(tp, defs, seen)
        return {"$ref": f"#/definitions/{name}"}
    return {}


def _dataclass_schema(cls, defs: dict, seen: set) -> dict:
    try:
        hints = typing.get_type_hints(cls)
    except Exception:  # noqa: BLE001 - unresolvable forward ref
        hints = {}
    props = {}
    for f in dataclasses.fields(cls):
        props[f.name] = _schema_for(hints.get(f.name, str), defs, seen)
    return {"type": "object", "properties": props}


def openapi_v2() -> dict:
    """GET /openapi/v2 — a swagger doc with definitions per kind and the
    standard CRUD paths (enough for schema-aware clients and docs)."""
    defs: dict = {}
    seen: set = set()
    for kind in all_kinds():
        _schema_for(kind_class(kind), defs, seen)
    paths = {}
    for kind in all_kinds():
        paths[f"/api/v1/{kind}"] = {
            "get": {"summary": f"list {kind}",
                    "responses": {"200": {"description": "OK"}}},
            "post": {"summary": f"create a {kind}",
                     "responses": {"201": {"description": "Created"}}},
        }
        paths[f"/api/v1/{kind}/{{name}}"] = {
            "get": {"summary": f"read a {kind}",
                    "responses": {"200": {"description": "OK"}}},
            "put": {"summary": f"replace a {kind}",
                    "responses": {"200": {"description": "OK"}}},
            "delete": {"summary": f"delete a {kind}",
                       "responses": {"200": {"description": "OK"}}},
        }
    return {
        "swagger": "2.0",
        "info": {"title": "kubernetes-tpu", "version": "v1.36.0-tpu"},
        "paths": paths,
        "definitions": defs,
    }
