"""CustomResourceDefinitions: user-defined kinds served like built-ins.

Reference: staging/src/k8s.io/apiextensions-apiserver — the third server in
the reference's delegation chain (cmd/kube-apiserver/app/server.go:176).
There, creating a CustomResourceDefinition object dynamically installs REST
storage for the named kind; instances are unstructured objects validated
against a structural OpenAPI v3 schema, and flow through storage, watch,
informers and kubectl exactly like compiled-in kinds.

Here the same effect comes from the runtime registry (`runtime.Scheme`
analogue, api/serialization._KINDS): `register_custom_kind(crd)` mints a
dynamic CustomObject subclass whose `kind` is the CRD's, registers it, and
from then on decode/encode/store/watch/informers/kubectl all handle it with
zero special cases. Validation (a structural-schema subset: type,
properties, required, enum, minimum/maximum, items, pattern) runs in the
apiserver's admission chain (apiserver/admission.py crd_admission).

A copy of the reference package's module (kubernetes_tpu/api/extensions.py).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from .meta import ObjectMeta


@dataclass
class CRDNames:
    """spec.names subset (apiextensions/v1 CustomResourceDefinitionNames)."""

    kind: str = ""
    plural: str = ""  # defaulted to lowercase(kind) + "s"

    def defaulted_plural(self) -> str:
        return self.plural or (self.kind.lower() + "s")


@dataclass
class CRDSpec:
    """apiextensions/v1 CustomResourceDefinitionSpec subset: one served
    version, a structural schema for `spec` (+ optional top-level fields)."""

    names: CRDNames = field(default_factory=CRDNames)
    group: str = "custom.example"
    scope: str = "Namespaced"  # "Namespaced" | "Cluster"
    # JSON-Schema subset applied to the instance's `spec` dict
    schema: dict = field(default_factory=dict)


@dataclass
class CustomResourceDefinition:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: CRDSpec = field(default_factory=CRDSpec)
    # "Established" once registered and ready to serve (the apiextensions
    # Established condition)
    status: dict = field(default_factory=dict)

    kind = "CustomResourceDefinition"


@dataclass
class CustomObject:
    """The unstructured instance type every registered CRD kind shares.

    Per-CRD subclasses minted by register_custom_kind override the class
    `kind`, so the reflective codec, the store's _kind_of, informers, and
    kubectl treat instances exactly like compiled-in dataclasses. `spec`
    and `status` are free-form dicts (apiextensions unstructured.Unstructured).
    """

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: dict = field(default_factory=dict)
    status: dict = field(default_factory=dict)

    kind = "CustomObject"


@dataclass
class WebhookRule:
    """admissionregistration/v1 RuleWithOperations subset."""

    operations: tuple[str, ...] = ("CREATE", "UPDATE")
    kinds: tuple[str, ...] = ("*",)

    def matches(self, operation: str, kind: str) -> bool:
        return (("*" in self.operations or operation in self.operations)
                and ("*" in self.kinds or kind in self.kinds))


@dataclass
class ValidatingWebhook:
    """admissionregistration/v1 ValidatingWebhook subset: clientConfig.url
    only (no CA bundle — plain HTTP to in-cluster endpoints here)."""

    name: str = ""
    url: str = ""
    rules: tuple[WebhookRule, ...] = ()
    failure_policy: str = "Fail"  # "Fail" | "Ignore"
    timeout_s: float = 5.0


@dataclass
class ValidatingWebhookConfiguration:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: tuple[ValidatingWebhook, ...] = ()

    kind = "ValidatingWebhookConfiguration"


@dataclass
class MutatingWebhook:
    """admissionregistration/v1 MutatingWebhook subset. The webhook's
    AdmissionReview response may carry `patchType: "JSONPatch"` with a
    base64 RFC 6902 patch (add/replace/remove), applied to the object's
    wire form before the validating phase sees it."""

    name: str = ""
    url: str = ""
    rules: tuple[WebhookRule, ...] = ()
    failure_policy: str = "Fail"  # "Fail" | "Ignore"
    timeout_s: float = 5.0


@dataclass
class MutatingWebhookConfiguration:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    webhooks: tuple[MutatingWebhook, ...] = ()

    kind = "MutatingWebhookConfiguration"


# -- ValidatingAdmissionPolicy (admissionregistration/v1, CEL) --------------


@dataclass
class Validation:
    """admissionregistration/v1 Validation: one CEL expression over
    `object` / `oldObject` / `request`; false (or an evaluation error under
    failurePolicy=Fail) rejects the request with `message`."""

    expression: str = ""
    message: str = ""


@dataclass
class AdmissionPolicySpec:
    """ValidatingAdmissionPolicySpec subset: matchConstraints (rules) +
    validations + failurePolicy.

    Reference: staging/src/k8s.io/apiserver/pkg/admission/plugin/policy/
    validating — expressions are compiled CEL over the declared variables;
    failurePolicy governs evaluation ERRORS (a false expression always
    rejects)."""

    match_rules: tuple[WebhookRule, ...] = ()
    validations: tuple[Validation, ...] = ()
    failure_policy: str = "Fail"  # "Fail" | "Ignore"


@dataclass
class ValidatingAdmissionPolicy:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    spec: AdmissionPolicySpec = field(default_factory=AdmissionPolicySpec)

    kind = "ValidatingAdmissionPolicy"


@dataclass
class ValidatingAdmissionPolicyBinding:
    """A policy takes effect only where a binding names it (the reference's
    two-object model: policies are definitions, bindings scope them).
    `namespaces` narrows the binding; empty = all namespaces."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)
    policy_name: str = ""
    namespaces: tuple[str, ...] = ()

    kind = "ValidatingAdmissionPolicyBinding"


def apply_json_patch(doc: dict, patch: list) -> dict:
    """RFC 6902 subset (add/replace/remove) over a wire document — the
    patch dialect mutating admission webhooks return (the reference's only
    supported admission patchType, plugin/webhook/mutating).

    RFC 6902 strictness preserved: every intermediate path element must
    EXIST (no auto-vivification), `replace`/`remove` of a missing member is
    an error — a typo'd path from a webhook must fail the request, never
    silently no-op (the policy-mandated mutation would just not happen)."""
    import copy as _copy

    out = _copy.deepcopy(doc)
    if not isinstance(patch, list):
        raise ValueError("patch must be a JSON array of operations")
    for op in patch:
        if not isinstance(op, dict):
            raise ValueError(f"patch operation must be an object: {op!r}")
        action = op.get("op")
        path = op.get("path", "")
        if not path.startswith("/"):
            raise ValueError(f"invalid patch path {path!r}")
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in path[1:].split("/")]
        node = out
        for p in parts[:-1]:
            if isinstance(node, list):
                i = int(p)
                if not (-len(node) <= i < len(node)):
                    raise ValueError(
                        f"patch path {path!r}: index {i} out of range"
                    )
                node = node[i]
            elif isinstance(node, dict):
                if p not in node:
                    raise ValueError(
                        f"patch path {path!r}: member {p!r} does not exist"
                    )
                node = node[p]
            else:
                raise ValueError(f"patch path {path!r} walks a scalar")
        leaf = parts[-1]
        if action in ("add", "replace"):
            if isinstance(node, list):
                if leaf == "-":
                    if action == "replace":
                        raise ValueError('replace at "-" is invalid')
                    node.append(op.get("value"))
                else:
                    i = int(leaf)
                    # RFC 6902: add allows index == len (append); beyond
                    # that is an error, NOT a silent clamp-insert
                    limit = len(node) + (1 if action == "add" else 0)
                    if not (0 <= i < limit):
                        raise ValueError(
                            f"{action} path {path!r}: index {i} out of range"
                        )
                    if action == "add":
                        node.insert(i, op.get("value"))
                    else:
                        node[i] = op.get("value")
            elif isinstance(node, dict):
                if action == "replace" and leaf not in node:
                    raise ValueError(
                        f"replace path {path!r}: member does not exist"
                    )
                node[leaf] = op.get("value")
            else:
                raise ValueError(f"patch path {path!r} targets a scalar")
        elif action == "remove":
            if isinstance(node, list):
                i = int(leaf)
                if not (0 <= i < len(node)):
                    raise ValueError(
                        f"remove path {path!r}: index {i} out of range"
                    )
                node.pop(i)
            elif leaf in node:
                del node[leaf]
            else:
                raise ValueError(
                    f"remove path {path!r}: member does not exist"
                )
        else:
            raise ValueError(f"unsupported patch op {action!r}")
    return out


# -- structural-schema validation (apiextensions pkg/apiserver/validation) --

_TYPE_MAP = {
    "object": dict,
    "array": (list, tuple),
    "string": str,
    "boolean": bool,
}


def validate_schema(value, schema: dict, path: str = "spec") -> list[str]:
    """Validate `value` against the structural-schema subset; returns a
    list of violation messages (empty = valid)."""
    errs: list[str] = []
    if not schema:
        return errs
    t = schema.get("type")
    if t:
        if t == "integer":
            if isinstance(value, bool) or not isinstance(value, int):
                return [f"{path}: expected integer, got {type(value).__name__}"]
        elif t == "number":
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                return [f"{path}: expected number, got {type(value).__name__}"]
        else:
            want = _TYPE_MAP.get(t)
            if want is None:
                return [f"{path}: unknown schema type {t!r}"]
            if not isinstance(value, want) or (
                t != "boolean" and isinstance(value, bool)
            ):
                return [f"{path}: expected {t}, got {type(value).__name__}"]
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in enum {schema['enum']}")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append(f"{path}: {value} below minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errs.append(f"{path}: {value} above maximum {schema['maximum']}")
    if isinstance(value, str) and "pattern" in schema:
        if re.search(schema["pattern"], value) is None:
            errs.append(f"{path}: {value!r} does not match pattern "
                        f"{schema['pattern']!r}")
    if isinstance(value, dict):
        for req in schema.get("required", ()):
            if req not in value:
                errs.append(f"{path}.{req}: required field missing")
        props = schema.get("properties", {})
        for k, v in value.items():
            if k in props:
                errs.extend(validate_schema(v, props[k], f"{path}.{k}"))
    if isinstance(value, (list, tuple)) and "items" in schema:
        for i, v in enumerate(value):
            errs.extend(validate_schema(v, schema["items"], f"{path}[{i}]"))
    return errs


# -- dynamic kind registry -------------------------------------------------

_BUILTIN_GUARD: set[str] | None = None


def _builtin_kinds() -> set[str]:
    global _BUILTIN_GUARD
    if _BUILTIN_GUARD is None:
        from . import serialization

        serialization._register_all()
        _BUILTIN_GUARD = set(serialization._KINDS)
    return _BUILTIN_GUARD


def validate_custom_kind(crd: CustomResourceDefinition) -> None:
    """Name/conflict validation WITHOUT side effects — the admission
    chain's half. Registration itself must only happen after the CRD
    commits to the store (a later admission denial or store conflict must
    not leak scheme/alias/scope state)."""
    from . import serialization

    kind = crd.spec.names.kind
    if not kind or not kind[0].isupper() or not kind.isalnum():
        raise ValueError(f"invalid CRD kind name {kind!r}")
    if kind in _builtin_kinds():
        raise ValueError(f"kind {kind!r} conflicts with a built-in kind")
    existing = serialization._KINDS.get(kind)
    if existing is not None and not issubclass(existing, CustomObject):
        raise ValueError(f"kind {kind!r} already registered")


def register_custom_kind(crd: CustomResourceDefinition) -> type:
    """Install the CRD's kind into the scheme: decode/encode, store,
    watches, informers, kubectl aliases, and discovery all pick it up.
    Idempotent; raises ValueError for invalid or conflicting names."""
    from ..apiserver.discovery import CLUSTER_SCOPED
    from ..cmd.kubectl import ALIASES
    from . import serialization

    validate_custom_kind(crd)
    kind = crd.spec.names.kind
    existing = serialization._KINDS.get(kind)
    if existing is not None:
        return existing
    cls = type(kind, (CustomObject,), {"kind": kind})
    serialization._KINDS[kind] = cls
    ALIASES.setdefault(kind.lower(), kind)
    ALIASES.setdefault(crd.spec.names.defaulted_plural().lower(), kind)
    if crd.spec.scope == "Cluster":
        CLUSTER_SCOPED.add(kind)
    return cls


def unregister_custom_kind(kind: str) -> None:
    """Remove a dynamic kind from the scheme (CRD deletion)."""
    from ..apiserver.discovery import CLUSTER_SCOPED
    from ..cmd.kubectl import ALIASES
    from . import serialization

    cls = serialization._KINDS.get(kind)
    if cls is None or not issubclass(cls, CustomObject) or cls is CustomObject:
        return
    del serialization._KINDS[kind]
    CLUSTER_SCOPED.discard(kind)
    for alias, target in list(ALIASES.items()):
        if target == kind:
            del ALIASES[alias]


def registered_custom_kinds() -> list[str]:
    from . import serialization

    return sorted(
        k for k, cls in serialization._KINDS.items()
        if isinstance(cls, type) and issubclass(cls, CustomObject)
        and cls is not CustomObject
    )
