"""Object metadata — the subset of metav1.ObjectMeta the framework uses.

Reference: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go.

A copy of the reference package's module (kubernetes_tpu/api/meta.py).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Any

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    generation: int = 0
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    creation_timestamp: float = 0.0
    deletion_timestamp: float | None = None
    owner_references: list[OwnerReference] = field(default_factory=list)
    # server-side apply field ownership (metadata.managedFields): entries
    # {"manager", "operation", "fields": [dotted paths]} maintained by
    # apiserver/apply.py
    managed_fields: list[dict] = field(default_factory=list)

    @property
    def key(self) -> str:
        """namespace/name cache key (client-go cache.MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    def copy(self) -> "ObjectMeta":
        return replace(
            self,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            owner_references=list(self.owner_references),
            managed_fields=[dict(e) for e in self.managed_fields],
        )


def obj_key(obj: Any) -> str:
    """namespace/name key of any API object with .meta."""
    return obj.meta.key
