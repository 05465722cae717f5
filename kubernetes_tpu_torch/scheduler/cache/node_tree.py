"""Zone-interleaved node ordering for spreading fairness.

Reference: pkg/scheduler/backend/cache/node_tree.go:32-143 — nodes are grouped
by zone and the flat list round-robins across zones so adaptive sampling
(percentageOfNodesToScore) still touches every zone.
"""

from __future__ import annotations

from ...api.types import Node

ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"


def _zone_of(node: Node) -> str:
    region = node.meta.labels.get(REGION_LABEL, "")
    zone = node.meta.labels.get(ZONE_LABEL, "")
    return f"{region}:\x00:{zone}" if (region or zone) else ""


class NodeTree:
    """Each zone's node names in insertion order, with their membership in
    a set beside them: adding or updating a node costs O(1) however many
    nodes a zone holds (a scan of the zone's list made building a
    100000-node cluster quadratic). The order and list() are the
    reference's."""

    def __init__(self) -> None:
        self._tree: dict[str, list[str]] = {}
        self._members: dict[str, set[str]] = {}
        self._zones: list[str] = []
        self.num_nodes = 0

    def add_node(self, node: Node) -> None:
        zone = _zone_of(node)
        names = self._tree.get(zone)
        if names is None:
            names = []
            self._tree[zone] = names
            self._members[zone] = set()
            self._zones.append(zone)
        members = self._members[zone]
        if node.meta.name not in members:
            names.append(node.meta.name)
            members.add(node.meta.name)
            self.num_nodes += 1

    def remove_node(self, node: Node) -> None:
        zone = _zone_of(node)
        members = self._members.get(zone)
        if members and node.meta.name in members:
            self._tree[zone].remove(node.meta.name)
            members.remove(node.meta.name)
            self.num_nodes -= 1
            if not members:
                del self._tree[zone]
                del self._members[zone]
                self._zones.remove(zone)

    def update_node(self, old: Node, new: Node) -> None:
        if _zone_of(old) != _zone_of(new):
            self.remove_node(old)
        self.add_node(new)

    def list(self) -> list[str]:
        """Round-robin interleave across zones (node_tree.go list())."""
        out: list[str] = []
        idx = [0] * len(self._zones)
        remaining = self.num_nodes
        while remaining > 0:
            progressed = False
            for zi, zone in enumerate(self._zones):
                names = self._tree[zone]
                if idx[zi] < len(names):
                    out.append(names[idx[zi]])
                    idx[zi] += 1
                    remaining -= 1
                    progressed = True
            if not progressed:
                break
        return out
