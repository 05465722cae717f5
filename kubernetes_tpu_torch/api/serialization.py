"""Generic dataclass <-> JSON codec + kind registry (the runtime.Scheme).

Reference: staging/src/k8s.io/apimachinery/pkg/runtime (Scheme, serializers).
Go serializes via generated deepcopy/marshal code per type; here one
reflective codec covers every API dataclass, with a kind registry playing the
Scheme's GVK role. Wire format keys are the python field names (our API IS
the python object model; HTTP clients are in-tree).

A copy of the reference package's module
(kubernetes_tpu/api/serialization.py). Its field hints resolve inside the
package that holds this module, not by the reference's absolute name.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, get_args, get_origin, get_type_hints

_KINDS: dict[str, type] = {}
_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def register_kind(cls: type) -> type:
    _KINDS[cls.kind] = cls  # type: ignore[attr-defined]
    return cls


def kind_class(kind: str) -> type:
    if kind not in _KINDS:
        _register_all()
    return _KINDS[kind]


def _register_all() -> None:
    """Populate the registry from the api modules (runtime.Scheme builders)."""
    from . import (
        certificates,
        coordination,
        dra,
        events,
        extensions,
        rbac,
        registration,
        storage,
        types,
        workloads,
    )

    for mod in (types, storage, dra, coordination, workloads, rbac,
                extensions, events, registration, certificates):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and hasattr(obj, "kind") and dataclasses.is_dataclass(obj):
                _KINDS.setdefault(obj.kind, obj)


# Fields whose element type can't be read off the annotation (bare `tuple`).
_FIELD_ELEM_HINTS: dict[tuple[str, str], str] = {
    ("PodSpec", "volumes"): "api.storage:Volume",
    ("PodSpec", "resource_claims"): "api.dra:PodResourceClaim",
}


def _elem_hint(cls: type, field: str):
    key = (cls.__name__, field)
    spec = _FIELD_ELEM_HINTS.get(key)
    if spec is None:
        return None
    mod_path, _, name = spec.partition(":")
    import importlib

    # resolve inside this package (the api package's parent), whatever it
    # is named
    root = __package__.rsplit(".", 1)[0]
    mod = importlib.import_module(f"{root}.{mod_path.replace(':', '.')}")
    return getattr(mod, name)


def encode(obj: Any) -> Any:
    """Object -> JSON-compatible structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        if hasattr(obj, "kind"):
            out["kind"] = obj.kind
        for f in dataclasses.fields(obj):
            out[f.name] = encode(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {str(k): encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, frozenset):
        return sorted(encode(v) for v in obj)
    if hasattr(obj, "numerator") and hasattr(obj, "denominator") and not isinstance(obj, (int, bool)):
        # Fraction quantities round-trip as strings
        return str(obj)
    return obj


def _hints(cls: type) -> dict[str, Any]:
    hints = _HINTS_CACHE.get(cls)
    if hints is None:
        hints = _HINTS_CACHE[cls] = get_type_hints(cls)
    return hints


def _strip_optional(tp):
    import types as _types

    # typing.Optional[X] and PEP-604 `X | None` have different origins
    if get_origin(tp) in (typing.Union, _types.UnionType):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def decode(data: Any, cls: type | None = None, _field_of: tuple | None = None) -> Any:
    """JSON structure -> object of `cls` (or registry lookup via 'kind')."""
    if data is None:
        return None
    if cls is None:
        if isinstance(data, dict) and "kind" in data:
            cls = kind_class(data["kind"])
        else:
            return data
    cls = _strip_optional(cls)
    origin = get_origin(cls)
    if origin in (list, tuple):
        args = get_args(cls)
        elem = args[0] if args and args[0] is not Ellipsis else None
        items = [decode(v, elem) for v in data]
        return tuple(items) if origin is tuple else items
    if origin is dict:
        return dict(data)
    if cls is tuple:
        elem = _elem_hint(*_field_of) if _field_of else None
        return tuple(decode(v, elem) for v in data)
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        hints = _hints(cls)
        field_names = {f.name for f in dataclasses.fields(cls)}
        for name, value in data.items():
            # the type-tag "kind" is not a dataclass field on API objects;
            # OwnerReference legitimately HAS a `kind` field — the field-name
            # check distinguishes the two
            if name not in field_names:
                continue
            kwargs[name] = decode(value, hints.get(name), _field_of=(cls, name))
        return cls(**kwargs)
    if cls in (int, float, str, bool):
        return cls(data) if not isinstance(data, cls) else data
    return data
