"""Per-cycle cluster snapshot with a change feed for O(changed) consumers,
and in-snapshot gang simulation.

Reference: pkg/scheduler/backend/cache/snapshot.go:43 — nodeInfoMap/List plus
derived lists; fork extensions AssumePod/ForgetPod (:278-361) used by the
pod-group cycle so a gang's earlier pods occupy resources for later siblings
without touching the live cache, and Assume/ForgetPlacement (:363-424) which
narrow the visible node list to a placement's nodes. A copy of the
reference package's module.
"""

from __future__ import annotations

import itertools

from ..nodeinfo import NodeInfo, PodInfo

_snapshot_uids = itertools.count(1)


class Placement:
    """A named subset of nodes a gang may be packed into.

    Reference: snapshot placements + topologyaware/topology_placement.go.
    No value equality: the gang planner's `placements != [parent]` test
    compares identities, as the reference's does.
    """

    __slots__ = ("name", "node_names")

    def __init__(self, name: str, node_names: list[str]):
        self.name = name
        self.node_names = node_names


class Snapshot:
    def __init__(self) -> None:
        self.node_info_map: dict[str, NodeInfo] = {}
        self.node_info_list: list[NodeInfo] = []
        self.have_pods_with_affinity_list: list[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_list: list[NodeInfo] = []
        self.used_pvc_set: set[str] = set()
        self.generation = 0
        # gang simulation bookkeeping
        self._assumed: list[tuple[str, str]] = []  # (pod_key, node_name)
        self._placement_stack: list[list[NodeInfo]] = []
        # the cache's per-gang member accounting at the last update
        self.pod_group_states: dict[str, object] = {}
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

    # -- reads (SharedLister / NodeInfoLister) -----------------------------

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

    # -- in-snapshot assume/forget (gang cycles) ---------------------------

    def assume_pod(self, pi: PodInfo, node_name: str) -> None:
        """Occupy resources on a snapshot node (snapshot.go:278)."""
        ni = self.node_info_map.get(node_name)
        if ni is None:
            raise KeyError(f"node {node_name} not in snapshot")
        ni.add_pod(pi)
        self.note_change(node_name)
        self._assumed.append((pi.key, node_name))
        if pi.has_affinity_constraints and ni not in self.have_pods_with_affinity_list:
            self.have_pods_with_affinity_list.append(ni)
        if pi.has_required_anti_affinity and ni not in self.have_pods_with_required_anti_affinity_list:
            self.have_pods_with_required_anti_affinity_list.append(ni)

    def forget_pod(self, pod_key: str, node_name: str) -> None:
        """Revert an in-snapshot assume (snapshot.go:318)."""
        ni = self.node_info_map.get(node_name)
        if ni is None:
            return
        ni.remove_pod(pod_key)
        self.note_change(node_name)
        try:
            self._assumed.remove((pod_key, node_name))
        except ValueError:
            pass
        if not ni.pods_with_affinity and ni in self.have_pods_with_affinity_list:
            self.have_pods_with_affinity_list.remove(ni)
        if (
            not ni.pods_with_required_anti_affinity
            and ni in self.have_pods_with_required_anti_affinity_list
        ):
            self.have_pods_with_required_anti_affinity_list.remove(ni)

    # -- placements (topology-aware gang packing) --------------------------

    def assume_placement(self, placement: Placement) -> None:
        """Narrow node_info_list to the placement's nodes (snapshot.go:363)."""
        self._placement_stack.append(self.node_info_list)
        wanted = set(placement.node_names)
        self.node_info_list = [n for n in self.node_info_list if n.name in wanted]
        self.rebuild_derived_lists()
        self.note_membership()

    def forget_placement(self) -> None:
        if self._placement_stack:
            self.node_info_list = self._placement_stack.pop()
            self.rebuild_derived_lists()
            self.note_membership()

    def num_nodes_in_placement(self) -> int:
        return len(self.node_info_list)
