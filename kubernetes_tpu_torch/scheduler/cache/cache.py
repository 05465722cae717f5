r"""Live cluster cache with assumed pods and O(changed) snapshot updates.

Reference: pkg/scheduler/backend/cache/cache.go. Pod state machine
(interface.go:34-55):

    Initial --Assume--> Assumed --Add(confirm)--> Added
       |                   |  \--Forget--> (deleted)
       \--Add--> Added --Remove/expire--> (deleted)

Assumed pods occupy node resources between the scheduling decision and the
bind confirmation arriving via the informer. Nodes live in a doubly-linked
list ordered by Generation (most recent at head) so UpdateSnapshot walks only
nodes with Generation > snapshot.generation (cache.go:223-265).
"""

from __future__ import annotations

import threading

from ...api.resource import ResourceNames
from ...api.types import Node, Pod
from ..nodeinfo import NodeInfo, PodInfo, next_generation
from .node_tree import NodeTree
from .podgroup_state import PodGroupStates
from .snapshot import Snapshot


class _NodeItem:
    __slots__ = ("info", "next", "prev")

    def __init__(self, info: NodeInfo):
        self.info = info
        self.next: "_NodeItem | None" = None
        self.prev: "_NodeItem | None" = None


class Cache:
    def __init__(self, names: ResourceNames | None = None):
        self.names = names or ResourceNames()
        self._mu = threading.RLock()
        self._nodes: dict[str, _NodeItem] = {}
        self._head: _NodeItem | None = None
        self._node_tree = NodeTree()
        # pod bookkeeping
        self._assumed_pods: set[str] = set()
        self._pod_states: dict[str, PodInfo] = {}  # pods known to the cache
        self._pod_nodes: dict[str, str] = {}  # pod key -> node name
        # per-gang member accounting (podgroupstate.go); snapshotted below
        self.pod_group_states = PodGroupStates()

    # -- generation list maintenance ---------------------------------------

    def _move_to_head(self, item: _NodeItem) -> None:
        if self._head is item:
            return
        if item.prev is not None:
            item.prev.next = item.next
        if item.next is not None:
            item.next.prev = item.prev
        item.prev = None
        item.next = self._head
        if self._head is not None:
            self._head.prev = item
        self._head = item

    def _unlink(self, item: _NodeItem) -> None:
        if item.prev is not None:
            item.prev.next = item.next
        else:
            self._head = item.next
        if item.next is not None:
            item.next.prev = item.prev
        item.prev = item.next = None

    def _touch(self, name: str) -> _NodeItem:
        item = self._nodes.get(name)
        if item is None:
            item = _NodeItem(NodeInfo(self.names))
            self._nodes[name] = item
        self._move_to_head(item)
        return item

    # -- nodes -------------------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._mu:
            item = self._touch(node.meta.name)
            if item.info.node is not None:
                self._node_tree.update_node(item.info.node, node)
            else:
                self._node_tree.add_node(node)
            item.info.set_node(node)

    def update_node(self, old: Node, new: Node) -> None:
        self.add_node(new)

    def remove_node(self, node: Node) -> None:
        with self._mu:
            item = self._nodes.get(node.meta.name)
            if item is None:
                return
            self._node_tree.remove_node(node)
            # keep the item while pods still reference it (the reference
            # keeps a node-less NodeInfo until its pods drain); bump the
            # generation so the snapshot notices the removal
            item.info.node = None
            item.info.generation = next_generation()
            if not item.info.pods:
                self._unlink(item)
                del self._nodes[node.meta.name]

    def get_node_info(self, name: str) -> NodeInfo | None:
        with self._mu:
            item = self._nodes.get(name)
            return item.info if item else None

    def node_count(self) -> int:
        with self._mu:
            return sum(1 for it in self._nodes.values() if it.info.node is not None)

    # -- pods --------------------------------------------------------------

    def assume_pod(self, pod: Pod, node_name: str) -> None:
        """Tentatively place pod on node before the bind API call lands."""
        with self._mu:
            key = pod.meta.key
            if key in self._pod_states:
                raise ValueError(f"pod {key} already in cache")
            pi = PodInfo(pod, self.names)
            item = self._touch(node_name)
            item.info.add_pod(pi)
            item.info.generation = next_generation()
            self._pod_states[key] = pi
            self._pod_nodes[key] = node_name
            self._assumed_pods.add(key)

    def forget_pod(self, pod: Pod) -> None:
        """Revert an assume that failed to bind."""
        with self._mu:
            key = pod.meta.key
            if key not in self._assumed_pods:
                return
            self._remove_pod_locked(key)

    def is_assumed_key(self, key: str) -> bool:
        with self._mu:
            return key in self._assumed_pods

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._mu:
            return pod.meta.key in self._assumed_pods

    def add_pod(self, pod: Pod) -> None:
        """Informer confirms a scheduled pod (Added state)."""
        with self._mu:
            key = pod.meta.key
            if key in self._assumed_pods:
                # confirmation of our own assume
                if self._pod_nodes.get(key) == pod.spec.node_name:
                    self._assumed_pods.discard(key)
                    # refresh stored pod object (rv, status)
                    self._pod_states[key].pod = pod
                    return
                # scheduled elsewhere than assumed: redo
                self._remove_pod_locked(key)
            elif key in self._pod_states:
                self._remove_pod_locked(key)
            pi = PodInfo(pod, self.names)
            item = self._touch(pod.spec.node_name)
            item.info.add_pod(pi)
            item.info.generation = next_generation()
            self._pod_states[key] = pi
            self._pod_nodes[key] = pod.spec.node_name

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._mu:
            key = new.meta.key
            if key in self._pod_states and not (key in self._assumed_pods):
                self._remove_pod_locked(key)
            if key not in self._pod_states:
                pi = PodInfo(new, self.names)
                item = self._touch(new.spec.node_name)
                item.info.add_pod(pi)
                item.info.generation = next_generation()
                self._pod_states[key] = pi
                self._pod_nodes[key] = new.spec.node_name

    def remove_pod(self, pod: Pod) -> None:
        """Informer deletes a pod (assumed or confirmed); a no-op for a pod
        the cache does not hold."""
        with self._mu:
            if pod.meta.key in self._pod_states:
                self._remove_pod_locked(pod.meta.key)

    def _remove_pod_locked(self, key: str) -> None:
        node_name = self._pod_nodes.pop(key)
        self._pod_states.pop(key)
        self._assumed_pods.discard(key)
        item = self._nodes.get(node_name)
        if item is not None:
            item.info.remove_pod(key)
            item.info.generation = next_generation()
            self._move_to_head(item)
            if item.info.node is None and not item.info.pods:
                self._unlink(item)
                del self._nodes[node_name]

    def assumed_pod_count(self) -> int:
        with self._mu:
            return len(self._assumed_pods)

    def assumed_pods(self) -> list[Pod]:
        """The pod objects currently assumed-but-unconfirmed — the set a
        startup reconciliation must resolve against store truth (each one
        is a bind that may have half-applied before a crash)."""
        with self._mu:
            return [self._pod_states[k].pod for k in self._assumed_pods]

    def pod_count(self) -> int:
        with self._mu:
            return len(self._pod_states)

    # -- snapshot ----------------------------------------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incremental refresh: O(nodes changed since snapshot.generation).

        Reference: cache.go UpdateSnapshot:190 — walk the generation list from
        head until Generation <= snapshot.generation; rebuild the ordered list
        only when membership or affinity flags changed.
        """
        with self._mu:
            latest = self._head.info.generation if self._head else snapshot.generation
            changed_membership = False
            derived_dirty = False
            touched: list[str] = []
            item = self._head
            while item is not None and item.info.generation > snapshot.generation:
                info = item.info
                name = info.name or self._name_of(item)
                existing = snapshot.node_info_map.get(name)
                if info.node is None:
                    if existing is not None:
                        del snapshot.node_info_map[name]
                        changed_membership = True
                else:
                    if existing is None:
                        changed_membership = True
                    elif (bool(existing.pods_with_affinity)
                          != bool(info.pods_with_affinity)
                          or bool(existing.pods_with_required_anti_affinity)
                          != bool(info.pods_with_required_anti_affinity)):
                        # affinity flags flipped: derived lists must rebuild
                        # (cache.go:202-276 — ONLY then)
                        derived_dirty = True
                    elif existing.pods_with_affinity or \
                            existing.pods_with_required_anti_affinity:
                        derived_dirty = True  # stale ref sits in the lists
                    snapshot.node_info_map[name] = info.clone()
                    snapshot.note_change(name)
                    touched.append(name)
                item = item.next

            # remove snapshot nodes no longer in cache
            if len(snapshot.node_info_map) > self.node_count():
                live = {
                    it.info.name for it in self._nodes.values() if it.info.node is not None
                }
                for name in list(snapshot.node_info_map):
                    if name not in live:
                        del snapshot.node_info_map[name]
                        changed_membership = True

            if changed_membership:
                order = self._node_tree.list()
                snapshot.node_info_list = [
                    snapshot.node_info_map[n] for n in order if n in snapshot.node_info_map
                ]
                snapshot.note_membership()
                snapshot.refresh_list_index()
                snapshot.rebuild_derived_lists()
            elif touched:
                # patch replaced clones at their known positions instead of
                # rebuilding the full O(N) ordered list per update — the
                # per-pod hybrid path updates 1-2 nodes per cycle
                idx = snapshot.list_index()
                for name in touched:
                    i = idx.get(name)
                    if i is not None:
                        snapshot.node_info_list[i] = snapshot.node_info_map[name]
                if derived_dirty:
                    snapshot.rebuild_derived_lists()
            snapshot.pod_group_states = self.pod_group_states.snapshot()
            snapshot.generation = latest
            return snapshot

    def _name_of(self, item: _NodeItem) -> str:
        for name, it in self._nodes.items():
            if it is item:
                return name
        return ""
