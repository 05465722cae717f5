"""Per-cycle cluster snapshot with a change feed for O(changed) consumers.

Reference: pkg/scheduler/backend/cache/snapshot.go:43 — nodeInfoMap/List plus
derived lists. The gang-simulation extensions of the reference package
(in-snapshot assume/forget, placements) are not part of the wave path.
"""

from __future__ import annotations

import itertools

from ..nodeinfo import NodeInfo

_snapshot_uids = itertools.count(1)


class Snapshot:
    def __init__(self) -> None:
        self.node_info_map: dict[str, NodeInfo] = {}
        self.node_info_list: list[NodeInfo] = []
        self.have_pods_with_affinity_list: list[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_list: list[NodeInfo] = []
        self.generation = 0
        # change feed for O(changed) consumers (the planes builder): every
        # node mutation appends its name; membership/order changes bump
        # membership_version (consumers must re-list). changelog_base is
        # the version of changelog[0] — entries older than base were
        # compacted away and force a full scan.
        self.version = 0
        self.membership_version = 0
        self.changelog: list[str] = []
        self.changelog_base = 0
        self.uid = next(_snapshot_uids)  # identity across consumer caches
        self._list_index: dict[str, int] = {}
        self._list_index_version = -1

    def list_index(self) -> dict[str, int]:
        """name -> node_info_list position, rebuilt lazily whenever
        membership (and thus order) changed."""
        if self._list_index_version != self.membership_version:
            self.refresh_list_index()
        return self._list_index

    def refresh_list_index(self) -> None:
        self._list_index = {
            ni.name: i for i, ni in enumerate(self.node_info_list)
        }
        self._list_index_version = self.membership_version

    def note_change(self, node_name: str) -> None:
        self.version += 1
        self.changelog.append(node_name)
        if len(self.changelog) > 8192:
            drop = len(self.changelog) // 2
            del self.changelog[:drop]
            self.changelog_base += drop

    def note_membership(self) -> None:
        self.membership_version += 1

    def get(self, node_name: str) -> NodeInfo | None:
        return self.node_info_map.get(node_name)

    def list_nodes(self) -> list[NodeInfo]:
        return self.node_info_list

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    def rebuild_derived_lists(self) -> None:
        self.have_pods_with_affinity_list = [
            n for n in self.node_info_list if n.pods_with_affinity
        ]
        self.have_pods_with_required_anti_affinity_list = [
            n for n in self.node_info_list if n.pods_with_required_anti_affinity
        ]
