"""Authentication + RBAC authorization for the API server.

Reference: the generic server's handler chain runs authentication (bearer
tokens among others — staging/src/k8s.io/apiserver/pkg/authentication),
then authorization (RBAC evaluator —
plugin/pkg/auth/authorizer/rbac/rbac.go) before any handler. This module
provides both stages: a static-token authenticator (the token-file
authenticator's model) and an RBAC authorizer that evaluates store-resident
Role/ClusterRole bindings per request attribute tuple
(user, verb, resource, namespace).

A copy of the reference package's module (kubernetes_tpu/apiserver/auth.py).
The store's iter_kind is the port's store.iter_kind helper over Store.list.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..api.rbac import ClusterRole, Role
from ..store import iter_kind

SYSTEM_MASTERS = "system:masters"
AUTHENTICATED = "system:authenticated"
UNAUTHENTICATED = "system:unauthenticated"
ANONYMOUS = "system:anonymous"


@dataclass(frozen=True)
class User:
    """authentication.k8s.io UserInfo subset."""

    name: str
    groups: tuple[str, ...] = ()


class AuthenticationError(Exception):
    """Invalid credentials (401; distinct from no credentials)."""


class ServiceAccountIssuer:
    """HMAC-signed ServiceAccount tokens (pkg/serviceaccount's
    JWTTokenGenerator role, symmetric-key form): the TokenRequest
    subresource mints them, authentication verifies signature + expiry and
    — like the reference — that the account still exists, so deleting a
    ServiceAccount revokes its tokens."""

    def __init__(self, store, key: bytes | None = None,
                 clock=None):
        import secrets as _secrets
        import time as _time

        self.store = store
        self.key = key or _secrets.token_bytes(32)
        self._now = clock or _time.time

    @staticmethod
    def _b64(data: bytes) -> str:
        import base64

        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()

    def _sign(self, payload: str) -> str:
        import hashlib
        import hmac as _hmac

        return self._b64(_hmac.new(self.key, payload.encode(),
                                   hashlib.sha256).digest())

    def issue(self, namespace: str, name: str,
              expiration_seconds: int = 3600) -> str:
        import json

        from ..api.rbac import service_account_username

        # a delete racing the TokenRequest must fail the request (store
        # NotFoundError), not mint an instance-unbound token that would
        # survive recreate
        sa = self.store.get("ServiceAccount", f"{namespace}/{name}")
        payload = self._b64(json.dumps({
            "sub": service_account_username(namespace, name),
            "ns": namespace, "name": name,
            # the token binds to the account INSTANCE: delete + recreate
            # must not resurrect previously minted tokens
            # (pkg/serviceaccount claims carry the UID the same way)
            "uid": sa.meta.uid,
            "exp": self._now() + expiration_seconds,
        }, sort_keys=True).encode())
        return f"sa.{payload}.{self._sign(payload)}"

    def authenticate(self, token: str) -> User | None:
        """User for a valid SA token, None when the token isn't ours
        (callers fall through to other authenticators)."""
        import base64
        import hmac as _hmac
        import json

        if not token.startswith("sa."):
            return None
        try:
            _, payload, sig = token.split(".", 2)
        except ValueError:
            return None
        if not _hmac.compare_digest(sig, self._sign(payload)):
            raise AuthenticationError("invalid service account token")
        claims = json.loads(
            base64.urlsafe_b64decode(payload + "=" * (-len(payload) % 4))
        )
        if claims["exp"] < self._now():
            raise AuthenticationError("service account token expired")
        key = f'{claims["ns"]}/{claims["name"]}'
        sa = self.store.try_get("ServiceAccount", key)
        if sa is None:
            raise AuthenticationError(
                "service account has been deleted"
            )
        if sa.meta.uid != claims.get("uid"):
            # covers both a stale uid AND an empty/absent uid claim — a
            # token that can't prove its instance binding is rejected
            raise AuthenticationError(
                "service account token predates the current account "
                "instance"
            )
        return User(claims["sub"], (
            "system:serviceaccounts",
            f'system:serviceaccounts:{claims["ns"]}',
            AUTHENTICATED,
        ))


class TokenAuthenticator:
    """Static bearer-token table (the --token-auth-file model), optionally
    chained with a ServiceAccountIssuer (the authenticator union the
    reference builds in its authn chain).

    authenticate() returns the token's user, the anonymous user when no
    credentials are presented (anonymous-auth=true semantics), and raises
    AuthenticationError for a credential that doesn't resolve — presenting a
    bad token must not silently degrade to anonymous."""

    def __init__(self, tokens: dict[str, User] | None = None,
                 sa_issuer: "ServiceAccountIssuer | None" = None):
        self._tokens = dict(tokens or {})
        self.sa_issuer = sa_issuer

    def add_token(self, token: str, user: User) -> None:
        self._tokens[token] = user

    def authenticate(self, authorization_header: str | None) -> User:
        if not authorization_header:
            return User(ANONYMOUS, (UNAUTHENTICATED,))
        scheme, _, credential = authorization_header.partition(" ")
        if scheme.lower() != "bearer" or not credential:
            raise AuthenticationError("unsupported authorization scheme")
        credential = credential.strip()
        user = self._tokens.get(credential)
        if user is None and self.sa_issuer is not None:
            user = self.sa_issuer.authenticate(credential)
        if user is None:
            raise AuthenticationError("unknown bearer token")
        if AUTHENTICATED not in user.groups:
            user = User(user.name, user.groups + (AUTHENTICATED,))
        return user


@dataclass(frozen=True)
class Attributes:
    """The authorization request tuple (authorizer.AttributesRecord)."""

    user: User
    verb: str  # get|list|watch|create|update|delete
    resource: str  # kind name
    namespace: str = ""


class RBACAuthorizer:
    """Evaluates RBAC objects from the store per request.

    Walk order mirrors rbac.go VisitRulesFor: cluster-role bindings grant
    cluster-wide; role bindings grant within their namespace (the referenced
    role may be a Role in that namespace or a ClusterRole scoped down).
    system:masters short-circuits (the superuser group the reference
    hard-codes in bootstrap policy)."""

    def __init__(self, store):
        self.store = store

    def authorize(self, attrs: Attributes) -> bool:
        if SYSTEM_MASTERS in attrs.user.groups:
            return True
        for crb in iter_kind(self.store, "ClusterRoleBinding"):
            if not any(s.matches(attrs.user) for s in crb.subjects):
                continue
            role = self.store.try_get("ClusterRole", crb.role_ref.name)
            if role and self._rules_allow(role, attrs):
                return True
        if attrs.namespace:
            for rb in iter_kind(self.store, "RoleBinding"):
                if rb.meta.namespace != attrs.namespace:
                    continue
                if not any(s.matches(attrs.user) for s in rb.subjects):
                    continue
                role = self._resolve_role(rb)
                if role and self._rules_allow(role, attrs):
                    return True
        return False

    def _resolve_role(self, rb) -> Role | ClusterRole | None:
        if rb.role_ref.kind == "ClusterRole":
            return self.store.try_get("ClusterRole", rb.role_ref.name)
        return self.store.try_get(
            "Role", f"{rb.meta.namespace}/{rb.role_ref.name}"
        )

    @staticmethod
    def _rules_allow(role, attrs: Attributes) -> bool:
        return any(r.matches(attrs.verb, attrs.resource) for r in role.rules)


def bootstrap_policy() -> list:
    """The default cluster roles the reference installs at startup
    (plugin/pkg/auth/authorizer/rbac/bootstrappolicy): admin/edit/view here
    reduced to the roles our components use."""
    from ..api.meta import ObjectMeta
    from ..api.rbac import ClusterRoleBinding, PolicyRule, RoleRef, Subject

    from ..apiserver.discovery import all_kinds

    # the reference's "view" aggregate explicitly EXCLUDES secrets
    # (bootstrappolicy/policy.go: view omits secrets "to avoid escalation");
    # enumerate readable kinds from the scheme so Secret can never ride a
    # wildcard into the any-authenticated-user grant
    # "Pod/log" is the read subresource the server authorizes separately
    # (upstream's view clusterrole includes pods/log explicitly)
    viewable = tuple(k for k in all_kinds() if k != "Secret") + ("Pod/log",)
    return [
        ClusterRole(meta=ObjectMeta(name="cluster-admin", namespace=""),
                    rules=(PolicyRule(("*",), ("*",)),)),
        ClusterRole(meta=ObjectMeta(name="view", namespace=""),
                    rules=(PolicyRule(("get", "list", "watch"), viewable),)),
        ClusterRoleBinding(
            meta=ObjectMeta(name="system:authenticated-view", namespace=""),
            subjects=(Subject("Group", AUTHENTICATED),),
            role_ref=RoleRef("ClusterRole", "view"),
        ),
    ]
