"""Framework runtime — the extension-point state machine, and the handle
its plugins read.

Reference: pkg/scheduler/framework/runtime/framework.go (frameworkImpl :57,
RunPreFilterPlugins :907, RunFilterPlugins :1078, RunScorePlugins :1320 with
its 3 passes, RunPermitPlugins :1923, WaitOnPermit :2034, SignPod :857). A
copy of the reference package's Framework
(kubernetes_tpu/scheduler/framework/runtime.py:40-513): every extension
point, run sequentially on the host. `_timed` is a plain call (the
reference samples plugin latency into metrics the port does not have yet),
and the framework takes the handle its stateful plugins read.

The handle (the reference's scheduler.py Handle) gives a plugin the
cluster state it reads: the cache (live gang member accounting), the
snapshot, the queue and framework (GangScheduling's Permit), the async
dispatcher (DefaultPreemption's evictions), and `store`:
the Scheduler's Store, or, where a framework runs without one, an
ObjectLookup holding the read side only (try_get by kind and key) over the
PodGroups and bound Pods a caller has added.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from ...api.types import Pod
from ...utils.clock import Clock
from ..nodeinfo import NodeInfo
from .cycle_state import CycleState
from .events import ClusterEventWithHint
from .interface import (
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    NodePluginScores,
    NodeToStatus,
    PreFilterResult,
    PostFilterResult,
    Status,
    WaitingPod,
    status_of,
)


class ObjectLookup:
    """The read side of a Store: objects by (kind, namespace/name key)."""

    def __init__(self) -> None:
        self._objects: dict[tuple[str, str], Any] = {}

    def add(self, obj) -> None:
        self._objects[(obj.kind, obj.meta.key)] = obj

    def try_get(self, kind: str, key: str):
        return self._objects.get((kind, key))


@dataclass
class Handle:
    """What stateful plugins get to touch (framework.Handle, interface.go:804)."""

    store: ObjectLookup = field(default_factory=ObjectLookup)
    cache: Any = None
    snapshot: Any = None
    queue: Any = None
    framework: Any = None
    # async API pipeline (SchedulerAsyncAPICalls): preemption's executor
    # routes evictions through it so PostFilter never blocks on API writes
    api_dispatcher: Any = None


DEFAULT_PERMIT_TIMEOUT = 600.0  # maxTimeout in RunPermitPlugins


class Framework:
    """One configured profile's plugin pipeline."""

    def __init__(
        self,
        plugins: Sequence[Any],
        weights: dict[str, int] | None = None,
        profile_name: str = "default-scheduler",
        clock=None,
        handle: Handle | None = None,
    ):
        self.profile_name = profile_name
        self.plugins = list(plugins)
        self.weights = dict(weights or {})
        self.clock = clock or Clock()
        self.handle = handle
        if handle is not None:
            if handle.framework is None:
                handle.framework = self
            for p in self.plugins:
                if hasattr(p, "set_handle"):
                    p.set_handle(handle)

        def having(method: str) -> list[Any]:
            return [p for p in self.plugins if callable(getattr(p, method, None))]

        self.pre_enqueue_plugins = having("pre_enqueue")
        self.queue_sort_plugins = having("less")
        self.pre_filter_plugins = having("pre_filter")
        self.filter_plugins = having("filter")
        self.post_filter_plugins = having("post_filter")
        self.pre_score_plugins = having("pre_score")
        self.score_plugins = having("score")
        self.reserve_plugins = having("reserve") + [
            p for p in having("unreserve") if not callable(getattr(p, "reserve", None))
        ]
        self.permit_plugins = having("permit")
        self.pre_bind_plugins = having("pre_bind")
        self.post_bind_plugins = having("post_bind")
        self.bind_plugins = having("bind")
        self.sign_plugins = having("sign")
        self.placement_generate_plugins = having("generate_placements")
        self.placement_score_plugins = having("score_placement")
        self._waiting_pods: dict[str, WaitingPod] = {}

    # -- queue wiring -------------------------------------------------------

    def queue_sort_less(self, a, b) -> bool:
        if self.queue_sort_plugins:
            return self.queue_sort_plugins[0].less(a, b)
        return a.timestamp < b.timestamp

    def queueing_hint_map(self) -> dict[str, list[ClusterEventWithHint]]:
        m: dict[str, list[ClusterEventWithHint]] = {}
        for p in self.plugins:
            fn = getattr(p, "events_to_register", None)
            if callable(fn):
                m[p.name] = list(fn())
        return m

    # -- timing helper ------------------------------------------------------

    def _timed(self, point: str, plugin: str, fn: Callable[[], Any]) -> Any:
        """The reference samples plugin latency here into its metrics; the
        port has no metrics yet, so this is a plain call."""
        return fn()

    # -- extension points ---------------------------------------------------

    def run_pre_filter_plugins(
        self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
    ) -> tuple[PreFilterResult | None, Status]:
        """framework.go RunPreFilterPlugins:907 — merge PreFilterResults,
        collect Skip set; UnschedulableAndUnresolvable aborts."""
        result: PreFilterResult | None = None
        skipped: set[str] = set()
        for p in self.pre_filter_plugins:
            r, st = self._timed("PreFilter", p.name, lambda p=p: p.pre_filter(state, pod, nodes))
            st = status_of(st)
            if st.is_skip:
                skipped.add(p.name)
                continue
            if not st.is_success:
                st.plugin = st.plugin or p.name
                return None, st
            if r is not None and not r.all_nodes:
                result = r if result is None else result.merge(r)
                if result.node_names is not None and not result.node_names:
                    return result, Status.unresolvable(
                        "node(s) didn't satisfy plugin(s) "
                        f"[{p.name}] simultaneously", plugin=p.name
                    )
        state.skip_filter_plugins = skipped
        return result, Status()

    def run_filter_plugins(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        """framework.go RunFilterPlugins:1078 — first rejection wins."""
        for p in self.filter_plugins:
            if p.name in state.skip_filter_plugins:
                continue
            st = status_of(
                self._timed("Filter", p.name, lambda p=p: p.filter(state, pod, node_info))
            )
            if not st.is_success:
                st.plugin = st.plugin or p.name
                return st
        return Status()

    def run_filter_plugins_batch(
        self, state: CycleState, pod: Pod, node_infos: list[NodeInfo]
    ) -> list[Status]:
        """run_filter_plugins over a node list in one call. Plugins that
        implement `filter_batch(state, pod, nodes) -> [Status|None]` answer
        all nodes at once (node-independent work runs once per pod — the
        host-side analogue of the dense kernel); others loop per node.
        Identical semantics to per-node run_filter_plugins: plugin order
        preserved, first rejection wins per node. A filter_batch returning
        None falls back to that plugin's per-node filter."""
        statuses: list[Status | None] = [None] * len(node_infos)
        pending = list(range(len(node_infos)))
        for p in self.filter_plugins:
            if p.name in state.skip_filter_plugins or not pending:
                continue
            batch = getattr(p, "filter_batch", None)
            res = None
            if callable(batch):
                nis = [node_infos[i] for i in pending]
                res = self._timed(
                    "Filter", p.name, lambda b=batch, nis=nis: b(state, pod, nis)
                )
            if res is not None and len(res) != len(pending):
                raise ValueError(
                    f"plugin {p.name} filter_batch returned {len(res)} "
                    f"statuses for {len(pending)} nodes"
                )
            if res is not None:
                still = []
                for i, st in zip(pending, res):
                    if st is None:
                        still.append(i)
                        continue
                    st = status_of(st)
                    if st.is_success:
                        still.append(i)
                    else:
                        st.plugin = st.plugin or p.name
                        statuses[i] = st
                pending = still
            else:
                still = []
                for i in pending:
                    st = status_of(self._timed(
                        "Filter", p.name,
                        lambda p=p, i=i: p.filter(state, pod, node_infos[i]),
                    ))
                    if st.is_success:
                        still.append(i)
                    else:
                        st.plugin = st.plugin or p.name
                        statuses[i] = st
                pending = still
        return [st if st is not None else Status() for st in statuses]

    def run_filter_plugins_with_nominated_pods(
        self, state: CycleState, pod: Pod, node_info: NodeInfo, nominated_pod_infos
    ) -> Status:
        """framework.go:1190 — filter twice when higher-priority nominated pods
        exist on the node: once with them assumed, once without."""
        if not nominated_pod_infos:
            return self.run_filter_plugins(state, pod, node_info)
        # pass 1: with nominated pods added
        ni = node_info.clone()
        state_clone = state.clone()
        for npi in nominated_pod_infos:
            ni.add_pod(npi)
            self.run_pre_filter_extension_add_pod(state_clone, pod, npi, ni)
        st = self.run_filter_plugins(state_clone, pod, ni)
        if not st.is_success:
            return st
        # pass 2: without
        return self.run_filter_plugins(state, pod, node_info)

    def run_pre_filter_extension_add_pod(self, state, pod, pod_info_to_add, node_info) -> Status:
        for p in self.pre_filter_plugins:
            if p.name in state.skip_filter_plugins:
                continue
            fn = getattr(p, "add_pod", None)
            if callable(fn):
                st = status_of(fn(state, pod, pod_info_to_add, node_info))
                if not st.is_success:
                    return st
        return Status()

    def run_pre_filter_extension_remove_pod(self, state, pod, pod_info_to_remove, node_info) -> Status:
        for p in self.pre_filter_plugins:
            if p.name in state.skip_filter_plugins:
                continue
            fn = getattr(p, "remove_pod", None)
            if callable(fn):
                st = status_of(fn(state, pod, pod_info_to_remove, node_info))
                if not st.is_success:
                    return st
        return Status()

    def run_post_filter_plugins(
        self, state: CycleState, pod: Pod, node_to_status: NodeToStatus
    ) -> tuple[PostFilterResult | None, Status]:
        """framework.go RunPostFilterPlugins — first success or first error wins;
        all Unschedulable -> combined Unschedulable."""
        statuses = []
        for p in self.post_filter_plugins:
            r, st = self._timed(
                "PostFilter", p.name, lambda p=p: p.post_filter(state, pod, node_to_status)
            )
            st = status_of(st)
            if st.is_success:
                return r, st
            if not st.is_rejected:
                st.plugin = st.plugin or p.name
                return r, st
            statuses.append(st)
        msg = "; ".join(s.message() for s in statuses if s.reasons)
        return None, Status.unschedulable(msg or "no postfilter plugin made progress")

    def run_pre_score_plugins(self, state: CycleState, pod: Pod,
                              nodes: list[NodeInfo],
                              skip: set[str] | frozenset = frozenset()) -> Status:
        """`skip` pre-seeds the score skip set WITHOUT running those
        plugins' pre_score — the hybrid path passes the kernel-covered
        plugins (their scores come from the device, so their host PreScore
        precompute over every node is pure waste)."""
        skipped: set[str] = set(skip)
        for p in self.pre_score_plugins:
            if p.name in skipped:
                continue
            st = status_of(
                self._timed("PreScore", p.name, lambda p=p: p.pre_score(state, pod, nodes))
            )
            if st.is_skip:
                skipped.add(p.name)
                continue
            if not st.is_success:
                st.plugin = st.plugin or p.name
                return st
        state.skip_score_plugins = skipped
        return Status()

    def run_score_plugins(
        self, state: CycleState, pod: Pod, nodes: list[NodeInfo]
    ) -> tuple[list[NodePluginScores], Status]:
        """framework.go RunScorePlugins:1320 — 3 passes: raw score per
        (plugin, node); NormalizeScore per plugin; weight + sum per node.

        The reference runs each pass under Parallelizer.Until over 16
        goroutines; host-side we run them sequentially (this path handles the
        sparse plugins only — dense scoring lives in the TPU kernel).
        """
        active = [p for p in self.score_plugins if p.name not in state.skip_score_plugins]
        all_scores: dict[str, list[tuple[str, int]]] = {ni.name: [] for ni in nodes}
        for p in active:
            raw: list = []
            batch = getattr(p, "score_batch", None)
            if callable(batch):
                vals = self._timed(
                    "Score", p.name, lambda b=batch: b(state, pod, nodes)
                )
                raw = [[ni.name, v] for ni, v in zip(nodes, vals)]
            else:
                for ni in nodes:
                    score, st = self._timed("Score", p.name, lambda p=p, ni=ni: p.score(state, pod, ni))
                    st = status_of(st)
                    if not st.is_success:
                        st.plugin = st.plugin or p.name
                        return [], st
                    raw.append([ni.name, score])
            norm = getattr(p, "normalize_score", None)
            if callable(norm):
                st = status_of(norm(state, pod, raw))
                if not st.is_success:
                    return [], st
            weight = self.weights.get(p.name, 1)
            for name, score in raw:
                if score > MAX_NODE_SCORE or score < MIN_NODE_SCORE:
                    return [], Status.as_error(
                        ValueError(f"plugin {p.name} score {score} out of range"), p.name
                    )
                all_scores[name].append((p.name, score * weight))
        out = []
        for ni in nodes:
            nps = NodePluginScores(name=ni.name, scores=all_scores[ni.name])
            nps.total_score = sum(s for _, s in nps.scores)
            out.append(nps)
        return out, Status()

    def run_reserve_plugins_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.reserve_plugins:
            fn = getattr(p, "reserve", None)
            if not callable(fn):
                continue
            st = status_of(self._timed("Reserve", p.name, lambda fn=fn: fn(state, pod, node_name)))
            if not st.is_success:
                st.plugin = st.plugin or p.name
                return st
        return Status()

    def run_reserve_plugins_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            fn = getattr(p, "unreserve", None)
            if callable(fn):
                self._timed("Unreserve", p.name, lambda fn=fn: fn(state, pod, node_name))

    def run_permit_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """framework.go RunPermitPlugins:1923 — Wait statuses accumulate into a
        WaitingPod; rejection wins immediately."""
        plugin_timeouts: dict[str, float] = {}
        for p in self.permit_plugins:
            res = self._timed("Permit", p.name, lambda p=p: p.permit(state, pod, node_name))
            st, timeout = res if isinstance(res, tuple) else (res, 0.0)
            st = status_of(st)
            if st.is_success:
                continue
            if st.is_wait:
                plugin_timeouts[p.name] = self.clock.now() + min(
                    timeout or DEFAULT_PERMIT_TIMEOUT, DEFAULT_PERMIT_TIMEOUT
                )
                continue
            st.plugin = st.plugin or p.name
            return st
        if plugin_timeouts:
            self._waiting_pods[pod.meta.key] = WaitingPod(pod, plugin_timeouts)
            return Status.wait()
        return Status()

    def wait_on_permit(self, pod: Pod, max_wait: float | None = None) -> Status:
        """framework.go WaitOnPermit:2034 — block until allowed/rejected/
        timeout. Blocks on the WaitingPod's condition variable (the
        reference blocks on a channel) — deciders wake waiters directly, no
        polling loop burning CPU in every binding thread."""
        wp = self._waiting_pods.get(pod.meta.key)
        if wp is None:
            return Status()
        deadline = min(wp.pending_plugins.values()) if wp.pending_plugins else 0.0
        hard_stop = (self.clock.now() + max_wait) if max_wait is not None else None
        while True:
            now = self.clock.now()
            if wp.decision is not None:
                break
            if now >= deadline:
                self._waiting_pods.pop(pod.meta.key, None)
                return Status.unschedulable("pod rejected: permit wait timeout")
            stop = deadline if hard_stop is None else min(deadline, hard_stop)
            # the clock owns the blocking strategy: a real clock parks on
            # the WaitingPod's condition (woken by allow/reject), a virtual
            # clock advances its own time instead of blocking wall time
            decision = self.clock.wait_for(wp.wait_for_decision, stop - now)
            if decision is not None:
                break
            if hard_stop is not None and self.clock.now() >= hard_stop:
                break
        self._waiting_pods.pop(pod.meta.key, None)
        return wp.decision if wp.decision is not None else Status.wait()

    def waiting_pod(self, key: str) -> WaitingPod | None:
        return self._waiting_pods.get(key)

    def remove_waiting_pod(self, key: str) -> None:
        """Drop a permit waiter without a decision (group-cycle revert)."""
        self._waiting_pods.pop(key, None)

    def iterate_waiting_pods(self):
        return list(self._waiting_pods.values())

    def run_pre_bind_pre_flight(self, state: CycleState, pod: Pod, node_name: str) -> set[str]:
        """Returns pre-bind plugins that will do real work (PreBindPreFlight)."""
        active = set()
        for p in self.pre_bind_plugins:
            fn = getattr(p, "pre_bind_pre_flight", None)
            if callable(fn):
                st = status_of(fn(state, pod, node_name))
                if st.is_skip:
                    continue
            active.add(p.name)
        return active

    def run_pre_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.pre_bind_plugins:
            st = status_of(
                self._timed("PreBind", p.name, lambda p=p: p.pre_bind(state, pod, node_name))
            )
            if not st.is_success:
                st.plugin = st.plugin or p.name
                return st
        return Status()

    def run_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """framework.go RunBindPlugins:1756 — first non-Skip plugin binds."""
        if not self.bind_plugins:
            return Status.as_error(RuntimeError("no bind plugin"), "")
        for p in self.bind_plugins:
            st = status_of(
                self._timed("Bind", p.name, lambda p=p: p.bind(state, pod, node_name))
            )
            if st.is_skip:
                continue
            if not st.is_success:
                st.plugin = st.plugin or p.name
            return st
        return Status.skip()

    def run_post_bind_plugins(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in self.post_bind_plugins:
            self._timed("PostBind", p.name, lambda p=p: p.post_bind(state, pod, node_name))

    # -- signatures (OpportunisticBatching) ---------------------------------

    def sign_pod(self, pod: Pod) -> str | None:
        """framework.go SignPod:857 — concatenate per-plugin fragments; any
        plugin returning None makes the pod unsignable."""
        frags = []
        for p in self.sign_plugins:
            frag = p.sign(pod)
            if frag is None:
                return None
            frags.append(f"{p.name}={frag}")
        return "|".join(frags) if frags else None

    # -- placements ---------------------------------------------------------

    def run_placement_generate_plugins(self, state, pods, parent_placement):
        placements = [parent_placement]
        for p in self.placement_generate_plugins:
            out, st = p.generate_placements(state, pods, placements)
            st = status_of(st)
            if not st.is_success:
                return placements, st
            if out:
                placements = out
        return placements, Status()

    def run_placement_score_plugins(self, state, pods, placement) -> int:
        total = 0
        for p in self.placement_score_plugins:
            score, st = p.score_placement(state, pods, placement)
            if status_of(st).is_success:
                total += score * self.weights.get(p.name, 1)
        return total
