"""In-tree admission plugins.

Reference: the apiserver's admission chain (mutating then validating,
staging/src/k8s.io/apiserver/pkg/admission) runs compiled-in plugins per
request. The two that matter for scheduling parity:

- priority (plugin/pkg/admission/priority): resolve a pod's
  priorityClassName to its numeric priority at create time (or apply the
  global-default class); reject unknown class names.
- namespace lifecycle (plugin/pkg/admission/namespace/lifecycle): refuse
  creates into a terminating or missing namespace.

Admission functions follow the server's AdmissionFn contract:
fn(operation, obj) raising AdmissionError to reject.

A copy of the reference package's module
(kubernetes_tpu/apiserver/admission.py). The store's iter_kind is the port's
store.iter_kind helper over Store.list.
"""

from __future__ import annotations

from ..store import iter_kind
from .server import AdmissionError


def cluster_scope_admission():
    """Mutating: cluster-scoped kinds carry no namespace. The ObjectMeta
    default ("default") would otherwise key a PriorityClass at
    "default/critical" where by-name lookups never find it — the apiserver
    strips namespace from cluster-scoped resources."""
    from .discovery import CLUSTER_SCOPED

    def admit(operation: str, obj) -> None:
        if operation == "CREATE" and getattr(obj, "kind", "") in CLUSTER_SCOPED:
            obj.meta.namespace = ""

    return admit


def priority_admission(store):
    """Mutating: pod.spec.priority from PriorityClass (admission.go)."""

    def admit(operation: str, obj) -> None:
        if operation != "CREATE" or getattr(obj, "kind", "") != "Pod":
            return
        name = obj.spec.priority_class_name
        if name:
            pc = store.try_get("PriorityClass", name)
            if pc is None:
                raise AdmissionError(
                    f"no PriorityClass with name {name} was found", code=422
                )
            obj.spec.priority = pc.value
            obj.spec.preemption_policy = pc.preemption_policy
            return
        if obj.spec.priority == 0:
            for pc in iter_kind(store, "PriorityClass"):
                if pc.global_default:
                    obj.spec.priority = pc.value
                    obj.spec.priority_class_name = pc.meta.name
                    obj.spec.preemption_policy = pc.preemption_policy
                    return

    return admit


def namespace_lifecycle_admission(store):
    """Validating: no creates into terminating/missing namespaces. A
    namespace that was never created as an object is treated as implicit
    (tests and single-tenant flows create pods without namespace objects);
    only an EXISTING namespace in Terminating phase rejects."""

    def admit(operation: str, obj) -> None:
        if operation != "CREATE":
            return
        ns_name = getattr(obj.meta, "namespace", "")
        if not ns_name:
            return
        ns = store.try_get("Namespace", ns_name)
        if ns is not None and (ns.phase == "Terminating"
                               or ns.meta.deletion_timestamp is not None):
            raise AdmissionError(
                f"namespace {ns_name} is terminating: no new objects",
                code=403,
            )

    return admit


def service_account_admission(store):
    """plugin/pkg/admission/serviceaccount (DefaultServiceAccount subset):
    default pod.spec.serviceAccountName to "default"; a pod naming a
    NON-default account that doesn't exist is rejected (the default one is
    created asynchronously by the ServiceAccount controller, so it is not
    required to exist yet — documented divergence from the reference,
    which waits for it)."""

    def admit(operation: str, obj) -> None:
        if getattr(obj, "kind", "") != "Pod":
            return
        if operation == "UPDATE":
            # pod identity is immutable (the reference's validation): an
            # update must not retarget serviceAccountName, and clearing it
            # must not erase the identity either — an empty field carries
            # the stored value forward
            stored = store.try_get("Pod", obj.meta.key)
            if stored is None:
                return
            if not obj.spec.service_account_name:
                obj.spec.service_account_name = \
                    stored.spec.service_account_name
                return
            if (stored.spec.service_account_name
                    and obj.spec.service_account_name
                    != stored.spec.service_account_name):
                raise AdmissionError(
                    "pod spec.serviceAccountName is immutable", code=422,
                )
            return
        if operation != "CREATE":
            return
        if not obj.spec.service_account_name:
            obj.spec.service_account_name = "default"
            return
        if obj.spec.service_account_name == "default":
            return
        key = f"{obj.meta.namespace}/{obj.spec.service_account_name}"
        if store.try_get("ServiceAccount", key) is None:
            raise AdmissionError(
                f"pod references service account {key} which does not "
                "exist", code=422,
            )

    return admit


def crd_admission(store):
    """apiextensions-apiserver in admission-plugin form: a
    CustomResourceDefinition CREATE validates + establishes the kind in the
    scheme (Established condition); CREATE/UPDATE of any registered custom
    kind validates the instance's spec against the CRD's structural schema
    (apiextensions pkg/apiserver/validation)."""
    from ..api.extensions import (
        CustomObject,
        validate_custom_kind,
        validate_schema,
    )

    def admit(operation: str, obj) -> None:
        if (operation == "UPDATE"
                and getattr(obj, "kind", "") == "CustomResourceDefinition"):
            try:
                validate_custom_kind(obj)
            except ValueError as e:
                raise AdmissionError(str(e), code=422)
            stored = store.try_get("CustomResourceDefinition", obj.meta.key)
            if stored is not None:
                # apiextensions: names.kind and scope are immutable — a
                # kind rename would orphan served instances and desync the
                # scheme registration
                if stored.spec.names.kind != obj.spec.names.kind:
                    raise AdmissionError(
                        "spec.names.kind is immutable", code=422)
                if stored.spec.scope != obj.spec.scope:
                    raise AdmissionError("spec.scope is immutable", code=422)
            return
        if (operation == "CREATE"
                and getattr(obj, "kind", "") == "CustomResourceDefinition"):
            try:
                validate_custom_kind(obj)
            except ValueError as e:
                raise AdmissionError(str(e), code=422)
            kind = obj.spec.names.kind
            if any(c.spec.names.kind == kind
                   and c.meta.key != obj.meta.key
                   for c in store.list_refs("CustomResourceDefinition")):
                raise AdmissionError(
                    f"kind {kind!r} is already served by another "
                    "CustomResourceDefinition", code=409)
            # registration itself happens in the server AFTER the create
            # commits — admission must be side-effect free on rejection
            obj.status["conditions"] = [
                {"type": "Established", "status": "True"}
            ]
            return
        if operation in ("CREATE", "UPDATE") and isinstance(obj, CustomObject):
            # read-only scan (list_refs): iter_kind deepcopies every CRD,
            # which puts O(CRDs) copies on the custom-object write path
            crd = next(
                (c for c in store.list_refs("CustomResourceDefinition")
                 if c.spec.names.kind == obj.kind), None,
            )
            if crd is None:
                # kind registered but its CRD is gone (deleted mid-flight)
                raise AdmissionError(
                    f"no established CustomResourceDefinition for kind "
                    f"{obj.kind!r}", code=404,
                )
            errs = validate_schema(obj.spec, crd.spec.schema)
            if errs:
                raise AdmissionError(
                    f"{obj.kind} {obj.meta.key} is invalid: "
                    + "; ".join(errs), code=422,
                )

    return admit


def cel_policy_admission(store):
    """ValidatingAdmissionPolicy (staging/src/k8s.io/apiserver/pkg/
    admission/plugin/policy/validating): CEL expressions over `object` /
    `oldObject` / `request`, evaluated for every bound policy whose match
    rules cover the request. A false expression rejects with the
    validation's message; an evaluation ERROR honors failurePolicy (Fail →
    reject, Ignore → skip), mirroring the reference's error policy. No
    webhook server involved — the policy engine runs in-process."""
    from ..api.serialization import encode
    from ..utils.cel import CELError, compile_expression

    _EXEMPT = {"ValidatingAdmissionPolicy", "ValidatingAdmissionPolicyBinding"}

    def admit(operation: str, obj) -> None:
        kind = getattr(obj, "kind", "")
        if kind in _EXEMPT:
            return
        bindings = store.list_refs("ValidatingAdmissionPolicyBinding")
        if not bindings:
            return
        ctx = None
        for b in bindings:
            if b.namespaces and getattr(obj.meta, "namespace", "") not in b.namespaces:
                continue
            policy = store.try_get("ValidatingAdmissionPolicy",
                                   b.policy_name)
            if policy is None:
                continue
            if not any(r.matches(operation, kind)
                       for r in policy.spec.match_rules):
                continue
            if ctx is None:
                old = store.try_get(kind, obj.meta.key) \
                    if operation == "UPDATE" else None
                ctx = {
                    "object": encode(obj),
                    "oldObject": encode(old) if old is not None else None,
                    "request": {"operation": operation, "kind": kind},
                }
            for v in policy.spec.validations:
                try:
                    ok = bool(compile_expression(v.expression)(ctx))
                except (CELError, TypeError, KeyError, ValueError) as e:
                    if policy.spec.failure_policy == "Ignore":
                        continue
                    raise AdmissionError(
                        f"ValidatingAdmissionPolicy {policy.meta.name!r} "
                        f"expression error: {e}", code=500,
                    )
                if not ok:
                    raise AdmissionError(
                        f"ValidatingAdmissionPolicy {policy.meta.name!r} "
                        "denied the request: "
                        + (v.message or f"failed expression: {v.expression}"),
                        code=403,
                    )

    return admit


class _WebhookCallError(Exception):
    """Transport failure OR malformed AdmissionReview response — both are
    webhook FAILURES that honor failurePolicy (the reference classifies an
    unparseable response as an error, never as a denial)."""


def _call_webhook(wh, payload: bytes) -> dict:
    """POST one AdmissionReview to a webhook; returns the validated
    `response` dict. Shared by the mutating and validating dispatchers so
    transport/response handling cannot drift between them."""
    import json as _json
    from urllib import request as _urlreq
    from urllib.error import URLError

    try:
        req = _urlreq.Request(
            wh.url, data=payload, method="POST",
            headers={"Content-Type": "application/json"},
        )
        with _urlreq.urlopen(req, timeout=wh.timeout_s) as r:
            resp = _json.loads(r.read())
    except (URLError, OSError, ValueError) as e:
        raise _WebhookCallError(f"call failed: {e}")
    if not isinstance(resp, dict) or not isinstance(
        resp.get("response"), dict
    ):
        raise _WebhookCallError(
            "malformed AdmissionReview response (missing 'response')"
        )
    return resp["response"]


def _admission_review_payload(operation: str, kind: str, obj) -> bytes:
    import json as _json

    from ..api.serialization import encode

    return _json.dumps({
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {"operation": operation, "kind": kind,
                    "object": encode(obj)},
    }).encode()


def mutating_webhook_admission(store):
    """Out-of-process MUTATING admission (staging/src/k8s.io/apiserver/pkg/
    admission/plugin/webhook/mutating): runs before the validating phase;
    an allowed response with patchType=JSONPatch applies a base64 RFC 6902
    patch to the object's wire form, and the mutated object is what every
    later plugin (and the store) sees."""
    import base64 as _b64
    import dataclasses as _dc
    import json as _json

    from ..api.extensions import apply_json_patch
    from ..api.serialization import decode, encode

    _EXEMPT = {"MutatingWebhookConfiguration",
               "ValidatingWebhookConfiguration"}

    def admit(operation: str, obj) -> None:
        kind = getattr(obj, "kind", "")
        if kind in _EXEMPT:
            return
        for cfg in store.list_refs("MutatingWebhookConfiguration"):
            for wh in cfg.webhooks:
                if not any(r.matches(operation, kind) for r in wh.rules):
                    continue
                try:
                    # re-encode per webhook: each sees its predecessors'
                    # patches (the reference's sequential mutating dispatch)
                    result = _call_webhook(
                        wh, _admission_review_payload(operation, kind, obj)
                    )
                except _WebhookCallError as e:
                    if wh.failure_policy == "Ignore":
                        continue
                    raise AdmissionError(
                        f"mutating webhook {wh.name!r} {e}", code=500,
                    )
                if not result.get("allowed", False):
                    msg = (result.get("status") or {}).get("message", "denied")
                    raise AdmissionError(
                        f"mutating webhook {wh.name!r} denied the request: "
                        f"{msg}", code=403,
                    )
                if result.get("patch"):
                    if result.get("patchType", "JSONPatch") != "JSONPatch":
                        raise AdmissionError(
                            f"mutating webhook {wh.name!r}: unsupported "
                            f"patchType {result.get('patchType')!r}", code=500,
                        )
                    try:
                        original = encode(obj)
                        patch = _json.loads(_b64.b64decode(result["patch"]))
                        patched = apply_json_patch(original, patch)
                        # identity AND system metadata are not a webhook's
                        # to change (the reference rejects such patches):
                        # uid/resourceVersion/managedFields forgeries would
                        # break GC identity, CAS, and SSA ownership
                        patched.setdefault("meta", {})
                        patched["kind"] = kind
                        patched["meta"]["name"] = obj.meta.name
                        patched["meta"]["namespace"] = obj.meta.namespace
                        orig_meta = original.get("meta", {})
                        for sysf in ("uid", "resource_version", "generation",
                                     "creation_timestamp",
                                     "deletion_timestamp", "managed_fields"):
                            if sysf in orig_meta:
                                patched["meta"][sysf] = orig_meta[sysf]
                            else:
                                patched["meta"].pop(sysf, None)
                        mutated = decode(patched)
                    except (ValueError, TypeError, KeyError, IndexError,
                            AttributeError) as e:
                        raise AdmissionError(
                            f"mutating webhook {wh.name!r} returned an "
                            f"unusable patch: {e}", code=500,
                        )
                    # mutate IN PLACE: later chain plugins and the store
                    # hold this object reference
                    for f in _dc.fields(obj):
                        setattr(obj, f.name, getattr(mutated, f.name))

    return admit


def webhook_admission(store):
    """Out-of-process validating admission
    (staging/src/k8s.io/apiserver/pkg/admission/plugin/webhook): each
    matching webhook gets an AdmissionReview POST; allowed=false rejects
    the request, call failures honor failurePolicy (Fail → reject,
    Ignore → skip). Webhook configurations themselves are exempt so a
    broken webhook can always be fixed (the reference's bootstrap
    safeguard)."""

    def admit(operation: str, obj) -> None:
        kind = getattr(obj, "kind", "")
        if kind in ("ValidatingWebhookConfiguration",
                    "MutatingWebhookConfiguration"):
            return
        payload = None
        for cfg in iter_kind(store, "ValidatingWebhookConfiguration"):
            for wh in cfg.webhooks:
                if not any(r.matches(operation, kind) for r in wh.rules):
                    continue
                if payload is None:
                    payload = _admission_review_payload(operation, kind, obj)
                try:
                    result = _call_webhook(wh, payload)
                except _WebhookCallError as e:
                    if wh.failure_policy == "Ignore":
                        continue
                    raise AdmissionError(
                        f"admission webhook {wh.name!r} {e}", code=500,
                    )
                if not result.get("allowed", False):
                    msg = (result.get("status") or {}).get("message", "denied")
                    raise AdmissionError(
                        f"admission webhook {wh.name!r} denied the request: "
                        f"{msg}", code=403,
                    )

    return admit


def default_admission_chain(store) -> list:
    """The plugins every control plane enables, in the reference's order:
    built-in mutators → MutatingAdmissionWebhook (last mutator) →
    built-in validators → ValidatingAdmissionPolicy (CEL) →
    ValidatingAdmissionWebhook (cmd/kube-apiserver admission ordering)."""
    from ..controllers.quota import quota_admission

    return [cluster_scope_admission(), priority_admission(store),
            namespace_lifecycle_admission(store),
            service_account_admission(store),
            mutating_webhook_admission(store),
            crd_admission(store),
            quota_admission(store),
            cel_policy_admission(store),
            webhook_admission(store)]
