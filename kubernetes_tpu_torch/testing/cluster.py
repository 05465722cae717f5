"""Synthetic clusters for the scale-out sweep, benches and tests.

A copy of the reference package's synthetic_cluster
(kubernetes_tpu/testing/cluster.py) for the port. It mirrors what
scheduler_perf's `createNodes`/`createPods` opcodes set up
(test/integration/scheduler_perf/scheduler_perf.go:65-79): a zone-labelled
node fleet plus an initial load of running pods, materialized straight into
the scheduler Cache and a fresh Snapshot.
"""

from __future__ import annotations

from ..api.resource import ResourceNames
from ..scheduler.cache.cache import Cache
from ..scheduler.cache.snapshot import Snapshot
from .wrappers import make_node, make_pod


def synthetic_cluster(
    n_nodes: int,
    n_zones: int = 8,
    init_pods_per_node: int = 0,
    cpu: str = "32",
    mem: str = "64Gi",
    names: ResourceNames | None = None,
):
    """Build (cache, snapshot) for an n_nodes fleet spread over n_zones.

    init_pods_per_node places running filler pods (500m cpu / 512Mi each) so
    scoring sees non-uniform utilization, like scheduler_perf's init pods.
    """
    names = names or ResourceNames()
    cache = Cache(names)
    for i in range(n_nodes):
        cache.add_node(
            make_node(f"node-{i}", cpu=cpu, mem=mem, zone=f"zone-{i % n_zones}")
        )
    for i in range(n_nodes):
        for j in range(init_pods_per_node):
            pod = make_pod(
                f"init-{i}-{j}", cpu="500m", mem="512Mi",
                labels={"app": "init"}, node_name=f"node-{i}",
            )
            cache.add_pod(pod)
    snapshot = cache.update_snapshot(Snapshot())
    return cache, snapshot
