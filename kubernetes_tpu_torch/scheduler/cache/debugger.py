"""Cache debugger: on-demand dump + cache/store/carry comparison.

Reference: pkg/scheduler/backend/cache/debugger/ — SIGUSR2 makes the
scheduler dump its cache's NodeInfos and the queue's pending pods
(dumper.go) and compare the cache against the informer truth (comparer.go:
nodes/pods present in one side but not the other). The comparer also
covers the state the device backend adds: the wave carry, K2's output
planes the next chained launch consumes, whose `used` rows are re-derived
from host truth and diffed.

A copy of the reference package's module
(kubernetes_tpu/scheduler/cache/debugger.py). `compare_carry` reads the
TorchBackend's carry: on the card a device-to-host copy of K2's `used`
output plane. Like the reference's, it is called between waves only.
"""

from __future__ import annotations

import signal


class CacheDebugger:
    def __init__(self, cache, queue, store, backend=None, log=print):
        self.cache = cache
        self.queue = queue
        self.store = store
        self.backend = backend
        self.log = log

    # -- dumper.go -----------------------------------------------------------

    def dump(self) -> str:
        """Human-readable scheduler state: per-node pod count + requested
        vector, assumed pods, queue tier depths."""
        lines = ["Dump of cached NodeInfo"]
        for name in self.cache.node_names():
            ni = self.cache.get_node_info(name)
            if ni is None:
                continue
            lines.append(
                f"  node {name}: pods={len(ni.pods)} "
                f"requested={list(ni.requested.v)} "
                f"allocatable={list(ni.allocatable.v)}"
            )
        lines.append(f"assumed pods: {self.cache.assumed_pod_count()}")
        active, backoff, unsched = self.queue.pending_pods()
        lines.append(
            f"Dump of scheduling queue: active={active} "
            f"backoff={backoff} unschedulable={unsched}"
        )
        out = "\n".join(lines)
        self.log(out)
        return out

    # -- comparer.go ---------------------------------------------------------

    def compare(self) -> list[str]:
        """Cache vs store truth. Assumed pods legitimately sit in the cache
        before their binding lands, so they are excluded from the missing-
        in-store check (the reference's comparer tolerates them the same
        way)."""
        issues: list[str] = []
        store_nodes = {n.meta.name for n in self.store.list("Node")[0]}
        cache_nodes = set(self.cache.node_names())
        for name in sorted(store_nodes - cache_nodes):
            issues.append(f"node {name} in store but not in cache")
        for name in sorted(cache_nodes - store_nodes):
            issues.append(f"node {name} in cache but not in store")
        bound: dict[str, str] = {}
        for pod in self.store.list("Pod")[0]:
            if pod.spec.node_name:
                bound[pod.meta.key] = pod.spec.node_name
        for name in cache_nodes:
            ni = self.cache.get_node_info(name)
            if ni is None:
                continue
            for key in ni.pods:
                want = bound.pop(key, None)
                if want is None:
                    if not self.cache.is_assumed_key(key):
                        issues.append(
                            f"pod {key} cached on {name} but not bound "
                            "in store (and not assumed)"
                        )
                elif want != name:
                    issues.append(
                        f"pod {key} cached on {name} but bound to {want}"
                    )
        for key, node in sorted(bound.items()):
            issues.append(f"pod {key} bound to {node} but missing from cache")
        for issue in issues:
            self.log(f"cache comparer: {issue}")
        return issues

    def compare_carry(self, snapshot) -> list[str]:
        """Device-carry coherence: re-derive planes rows from host truth and
        diff against the rows the next wave launch would consume. Only
        meaningful between waves (an in-flight wave legitimately holds
        placements the host hasn't processed)."""
        issues: list[str] = []
        if self.backend is None:
            return issues
        carry = getattr(self.backend, "_carry", None)
        if carry is None or "used" not in carry:
            return issues
        import numpy as np

        # MUST go through backend.sync, not builder.sync: the backend
        # accumulates builder.dirty_rows into its pending delta-upload set,
        # and a bare builder.sync would consume those rows behind its back,
        # leaving device planes silently stale
        planes = self.backend.sync(snapshot)
        host_used = planes.used[: planes.n]
        # the carry lives on the backend's device: one copy to the host
        dev_used = carry["used"][: planes.n].cpu().numpy()
        rows = np.flatnonzero((host_used != dev_used).any(axis=1))
        pending = getattr(self.backend, "_pending_dirty", None) or set()
        for i in rows:
            if int(i) in pending:
                continue  # host assume already queued for delta upload
            issues.append(
                f"carry row {int(i)} ({planes.node_names[int(i)]}) "
                f"diverges from host planes: host="
                f"{host_used[int(i)].tolist()} device="
                f"{dev_used[int(i)].tolist()}"
            )
        for issue in issues:
            self.log(f"carry comparer: {issue}")
        return issues

    # -- signal wiring (debugger.go ListenForSignal) -------------------------

    def install(self, signum: int = signal.SIGUSR2) -> None:
        """SIGUSR2 → dump + compare, exactly the reference's trigger."""

        def handler(_sig, _frame):
            self.dump()
            self.compare()

        signal.signal(signum, handler)
