"""Object metadata — the subset of metav1.ObjectMeta the scheduler and the
store read.

Reference: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

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
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    deletion_timestamp: float | None = None
    # stamped by the store on every write
    resource_version: int = 0
    creation_timestamp: float = 0.0
    # who owns the object: VolumeBinding reads a generic ephemeral claim's
    # owner pod (ephemeral.VolumeIsForPod)
    owner_references: list[OwnerReference] = field(default_factory=list)

    @property
    def key(self) -> str:
        """namespace/name cache key (client-go cache.MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    def copy(self) -> "ObjectMeta":
        return replace(self, labels=dict(self.labels),
                       annotations=dict(self.annotations),
                       owner_references=list(self.owner_references))
