"""Object metadata — the subset of metav1.ObjectMeta the wave path reads.

Reference: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    deletion_timestamp: float | None = None

    @property
    def key(self) -> str:
        """namespace/name cache key (client-go cache.MetaNamespaceKeyFunc)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name
