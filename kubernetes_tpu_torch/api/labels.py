"""Label selectors and requirements.

Reference: staging/src/k8s.io/apimachinery/pkg/labels (Selector, Requirement)
and meta/v1 LabelSelector. Operators: In, NotIn, Exists, DoesNotExist, Gt, Lt.

A copy of the reference package's module (kubernetes_tpu/api/labels.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        if self.operator == IN:
            return has and labels[self.key] in self.values
        if self.operator == NOT_IN:
            # meta/v1 LabelSelector semantics: key must exist and value not in set
            # (matches LabelSelectorAsSelector conversion).
            return has and labels[self.key] not in self.values
        if self.operator in (GT, LT):
            if not has:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.operator == GT else lhs < rhs
        raise ValueError(f"unknown operator {self.operator!r}")


@dataclass(frozen=True)
class LabelSelector:
    """meta/v1 LabelSelector: AND of match_labels and match_expressions.

    A None selector matches nothing; an empty selector matches everything
    (mirrors LabelSelectorAsSelector).
    """

    match_labels: tuple[tuple[str, str], ...] = ()
    match_expressions: tuple[Requirement, ...] = ()

    @classmethod
    def of(
        cls,
        match_labels: Mapping[str, str] | None = None,
        match_expressions: Sequence[Requirement] = (),
    ) -> "LabelSelector":
        return cls(
            tuple(sorted((match_labels or {}).items())),
            tuple(match_expressions),
        )

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)

    @property
    def empty(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def canonical(self) -> str:
        """Stable string form — used for pod signatures and spread-constraint
        interning (reference: labels.Selector.String())."""
        parts = [f"{k}={v}" for k, v in self.match_labels]
        for r in self.match_expressions:
            parts.append(f"{r.key} {r.operator} ({','.join(sorted(r.values))})")
        return ",".join(parts)


def labels_subset(selector: Mapping[str, str],
                  labels: Mapping[str, str]) -> bool:
    """match_labels semantics: every selector pair present in labels
    (shared by the controllers that select pods by a plain label dict)."""
    return all(labels.get(k) == v for k, v in selector.items())


def matches_selector(sel: LabelSelector | None, labels: Mapping[str, str]) -> bool:
    if sel is None:
        return False
    return sel.matches(labels)


def format_labels(labels: Mapping[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
