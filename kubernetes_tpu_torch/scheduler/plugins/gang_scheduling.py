"""GangScheduling plugin: all-or-nothing pod groups via PreEnqueue + Permit.

Reference: pkg/scheduler/framework/plugins/gangscheduling/gangscheduling.go —
PreEnqueue (:121-157) rejects until the PodGroup exists and
AllPodsCount >= policy.Gang.MinCount; Permit (:160-216) returns Wait until
ScheduledPodsCount reaches quorum, activating gang siblings, then Allows every
waiting sibling. Reads snapshot pod-group state inside gang cycles and live
cache state otherwise (:185-190).
A copy of the reference package's module; its handle is the port's
framework/runtime.py Handle.
"""

from __future__ import annotations

from ...api.types import Pod
from ...utils.envknob import float_env
from ..framework import events as ev
from ..framework.events import ClusterEvent, ClusterEventWithHint, QUEUE
from ..framework.interface import Plugin, Status

# gangscheduling.go:41 — 5 minutes; env-overridable so soak rigs can shrink
# the starvation window (see README "Gang waves" runbook) without a rebuild
GANG_WAIT_TIMEOUT = float_env("KUBE_TPU_GANG_WAIT_S", 300.0)


class GangScheduling(Plugin):
    name = "GangScheduling"

    def __init__(self, handle=None):
        self.handle = handle  # scheduler Handle: .store, .cache, .queue, .framework

    def set_handle(self, handle) -> None:
        self.handle = handle

    def _group_key(self, pod: Pod) -> str | None:
        sg = pod.spec.scheduling_group
        if sg is None:
            return None
        return f"{pod.meta.namespace}/{sg.pod_group_name}"

    def events_to_register(self):
        return [
            ClusterEventWithHint(ClusterEvent(ev.POD, ev.ADD), lambda p, o, n: QUEUE),
            ClusterEventWithHint(ClusterEvent(ev.POD_GROUP, ev.ADD), lambda p, o, n: QUEUE),
        ]

    def pre_enqueue(self, pod: Pod) -> Status:
        gk = self._group_key(pod)
        if gk is None:
            return Status()
        group = self.handle.store.try_get("PodGroup", gk) if self.handle else None
        if group is None:
            return Status.unresolvable(f"PodGroup {gk} not found", plugin=self.name)
        state = self.handle.cache.pod_group_states.get(gk)
        all_count = state.all_pods_count if state else 0
        if all_count < group.spec.policy.min_count:
            return Status.unresolvable(
                f"gang has {all_count}/{group.spec.policy.min_count} pods",
                plugin=self.name,
            )
        return Status()

    def permit(self, state, pod: Pod, node_name: str):
        gk = self._group_key(pod)
        if gk is None:
            return Status(), 0.0
        group = self.handle.store.try_get("PodGroup", gk)
        if group is None:
            return Status.unschedulable(f"PodGroup {gk} disappeared", plugin=self.name), 0.0
        min_count = group.spec.policy.min_count
        # gang cycles read the snapshot state; per-pod cycles the live cache
        # (gangscheduling.go:185-190)
        snap_states = self.handle.snapshot.pod_group_states
        if state.is_pod_group_scheduling_cycle and gk in snap_states:
            gstate = snap_states[gk]
        else:
            gstate = self.handle.cache.pod_group_states.get(gk)
        assumed_or_scheduled = gstate.assumed_or_scheduled_count if gstate else 0
        if assumed_or_scheduled < min_count:
            # activate siblings stuck in unschedulable/backoff so they get a cycle
            if gstate is not None and self.handle.queue is not None:
                siblings = [
                    self.handle.store.try_get("Pod", k) for k in gstate.unscheduled
                ]
                self.handle.queue.activate([s for s in siblings if s is not None])
            return Status.wait(plugin=self.name), GANG_WAIT_TIMEOUT
        # quorum reached: allow every waiting sibling (gangscheduling.go:207-212)
        fw = self.handle.framework
        if fw is not None:
            for wp in fw.iterate_waiting_pods():
                if self._group_key(wp.pod) == gk:
                    wp.allow(self.name)
        return Status(), 0.0
