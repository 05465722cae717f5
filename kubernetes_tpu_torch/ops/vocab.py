"""Cluster vocabularies: the string→column-id maps behind the device planes.

The dense kernels cannot consume strings, selectors, or taint structs; every
categorical dimension of cluster state is interned into a small append-only
vocabulary, and the planes carry integer ids into these vocabularies.

Reference points (what each vocab re-expresses as dense integer data):
- taints: pkg/scheduler/framework/plugins/tainttoleration — distinct
  (key, value, effect) triples; a pod's tolerations are pre-evaluated host-side
  into a per-vocab-entry boolean, so the device check is a gather.
- node groups: nodes sharing identical label maps (scheduler_perf clusters have
  a handful of label templates across 5k nodes); NodeAffinity/nodeSelector
  required matching (node_affinity.go:218) is evaluated once per (pod, group)
  host-side and gathered per node on device.
- selector signatures: (namespace, selector-canonical) pairs used by
  PodTopologySpread counting (podtopologyspread/filtering.go:97) — per-node
  matching-pod counts are maintained as a [nodes, S] plane so domain counts
  become segment-sums on device.
- ports: distinct (protocol, port) pairs → bit positions in the used-port
  bitset planes (node_ports.go:75).
- images: image name → column in the per-node image-size plane
  (image_locality.go:93-105).
"""

from __future__ import annotations

from typing import Hashable, Iterator


class Vocab:
    """Append-only intern table: hashable key → dense id."""

    __slots__ = ("_index", "_keys")

    def __init__(self) -> None:
        self._index: dict[Hashable, int] = {}
        self._keys: list[Hashable] = []

    def id(self, key: Hashable) -> int:
        i = self._index.get(key)
        if i is None:
            i = len(self._keys)
            self._index[key] = i
            self._keys.append(key)
        return i

    def get(self, key: Hashable) -> int | None:
        return self._index.get(key)

    def key(self, i: int) -> Hashable:
        return self._keys[i]

    def __len__(self) -> int:
        return len(self._keys)

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._keys)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._index


def next_pow2(n: int, floor: int = 1) -> int:
    """Bucketed padding size: smallest power of two ≥ max(n, floor).

    The plane layout keeps the reference package's pow2 buckets, so both
    packages build byte-identical planes from the same cluster.
    """
    n = max(n, floor)
    p = 1
    while p < n:
        p <<= 1
    return p


class ClusterVocabs:
    """All vocabularies for one cluster, shared by planes + feature extractor."""

    def __init__(self) -> None:
        # (key, value, effect) for NoSchedule/NoExecute taints
        self.taints = Vocab()
        # (key, value) for PreferNoSchedule taints (scored, not filtered)
        self.prefer_taints = Vocab()
        # canonical node-label tuple → node group id
        self.groups = Vocab()
        # topology key (e.g. topology.kubernetes.io/zone) → plane column
        self.topo_keys = Vocab()
        # per topology key: value → domain id
        self.topo_domains: dict[int, Vocab] = {}
        # (namespace, selector canonical) → selector-signature column.
        # matcher objects kept alongside for host-side pod matching.
        self.selectors = Vocab()
        self.selector_matchers: list[tuple[str, object]] = []  # (namespace, selector)
        # (protocol, port) → bit position
        self.ports = Vocab()
        # image name → column
        self.images = Vocab()
        # inter-pod affinity terms: (namespaces, selector canonical, topo key
        # idx) → term column (interpodaffinity/filtering.go:91 — the dense
        # analogue of topologyToMatchedTermCount keys its planes by term)
        self.ipa_terms = Vocab()
        self.ipa_term_matchers: list[tuple[frozenset, object, int]] = []

    def ipa_term_id(self, term) -> int:
        """Intern an AffinityTerm (nodeinfo.AffinityTerm shape: resolved
        namespaces frozenset + selector + topology_key)."""
        ki = self.topo_keys.id(term.topology_key)
        sel = term.selector
        key = (term.namespaces, sel.canonical() if sel is not None else None, ki)
        existing = self.ipa_terms.get(key)
        if existing is not None:
            return existing
        i = self.ipa_terms.id(key)
        self.ipa_term_matchers.append((term.namespaces, sel, ki))
        return i

    def ipa_term_lookup(self, term) -> int | None:
        """Existing id for an AffinityTerm, or None when not interned (the
        read-only counterpart of ipa_term_id — must mirror its key shape)."""
        ki = self.topo_keys.get(term.topology_key)
        if ki is None:
            return None
        sel = term.selector
        return self.ipa_terms.get(
            (term.namespaces, sel.canonical() if sel is not None else None, ki)
        )

    def domain_vocab(self, key_idx: int) -> Vocab:
        v = self.topo_domains.get(key_idx)
        if v is None:
            v = Vocab()
            self.topo_domains[key_idx] = v
        return v

    def group_of_labels(self, labels: dict[str, str]) -> int:
        return self.groups.id(tuple(sorted(labels.items())))

    def selector_id(self, namespace: str, selector) -> int:
        key = (namespace, selector.canonical())
        existing = self.selectors.get(key)
        if existing is not None:
            return existing
        i = self.selectors.id(key)
        self.selector_matchers.append((namespace, selector))
        return i
