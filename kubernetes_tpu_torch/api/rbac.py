"""RBAC API types: rbac.authorization.k8s.io/v1 subset.

Reference: staging/src/k8s.io/api/rbac/v1/types.go — Role/ClusterRole carry
PolicyRules (verbs × resources, '*' wildcards); bindings attach them to
subjects (users/groups/service accounts). Namespaced Roles grant only within
their namespace; ClusterRoles grant everywhere (including via RoleBinding,
which scopes a ClusterRole's rules down to the binding's namespace).

A copy of the reference package's module (kubernetes_tpu/api/rbac.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .meta import ObjectMeta

WILDCARD = "*"


@dataclass(frozen=True)
class PolicyRule:
    """verbs × resources this rule allows (rbac/v1/types.go PolicyRule)."""

    verbs: tuple[str, ...] = ()
    resources: tuple[str, ...] = ()

    def matches(self, verb: str, resource: str) -> bool:
        return ((WILDCARD in self.verbs or verb in self.verbs)
                and (WILDCARD in self.resources or resource in self.resources))


def service_account_username(namespace: str, name: str) -> str:
    """system:serviceaccount:<ns>:<name> (serviceaccount.MakeUsername) —
    the ONE place the identity format lives (Subject.matches and the token
    issuer both derive from it)."""
    return f"system:serviceaccount:{namespace}:{name}"


@dataclass
class ServiceAccount:
    """core/v1 ServiceAccount: the in-cluster workload identity
    (pkg/apis/core types.go ServiceAccount). Token issuance lives in the
    apiserver's TokenRequest subresource (apiserver/auth.py
    ServiceAccountIssuer)."""

    meta: ObjectMeta = field(default_factory=ObjectMeta)

    kind = "ServiceAccount"


@dataclass(frozen=True)
class Subject:
    """User / Group / ServiceAccount reference."""

    kind: str  # "User" | "Group" | "ServiceAccount"
    name: str
    namespace: str = ""

    def matches(self, user) -> bool:
        if self.kind == "User":
            return self.name == user.name
        if self.kind == "Group":
            return self.name in user.groups
        if self.kind == "ServiceAccount":
            return user.name == service_account_username(
                self.namespace, self.name
            )
        return False


@dataclass(frozen=True)
class RoleRef:
    kind: str  # "Role" | "ClusterRole"
    name: str


@dataclass
class Role:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    rules: tuple[PolicyRule, ...] = ()

    kind = "Role"


@dataclass
class ClusterRole:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    rules: tuple[PolicyRule, ...] = ()

    kind = "ClusterRole"


@dataclass
class RoleBinding:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: tuple[Subject, ...] = ()
    role_ref: RoleRef = field(default_factory=lambda: RoleRef("Role", ""))

    kind = "RoleBinding"


@dataclass
class ClusterRoleBinding:
    meta: ObjectMeta = field(default_factory=ObjectMeta)
    subjects: tuple[Subject, ...] = ()
    role_ref: RoleRef = field(default_factory=lambda: RoleRef("ClusterRole", ""))

    kind = "ClusterRoleBinding"
