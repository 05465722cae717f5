"""The mesh seam end to end: the pipelined loop
(kubernetes_tpu_torch.testing.pipeline.WavePipeline, depth 2) over
TPUBackend(context=MeshContext(scheduler_mesh(4))) and over
TorchBackend(device="cpu", context=MeshContext(scheduler_mesh(4))), with a
node change mid-stream: on the mixed cluster (many signatures, new
vocabulary entries: resyncs, full re-uploads, K3 row scatters and re-runs
through K4 on the mesh backend) and on a hard-spread cluster (chained
launches with cross-wave replay on the mesh). Equal logs after every
collect and re-run, equal bindings and final rng state, and the port's
waves ran through K1 + K6's plain version on 4 shards. Every comparison is
exact (integers and bools: tolerance 0).
"""

import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu import parallel as jmesh
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.cache.cache import Cache as JCache
from kubernetes_tpu.scheduler.cache.snapshot import Snapshot as JSnapshot
from kubernetes_tpu.scheduler.tpu.backend import TPUBackend
from kubernetes_tpu_torch import parallel as tmesh
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.ops import kernels as tk
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache
from kubernetes_tpu_torch.scheduler.cache import Snapshot as TSnapshot
from kubernetes_tpu_torch.scheduler.tpu.backend import TorchBackend
from kubernetes_tpu_torch.testing.mixed import (
    build_nodes,
    build_pods,
    dedup_nodes,
    dedup_pods,
    mixed_spec,
)
from tests.test_torch_pipeline import _Side, _waves_of, _wrappers
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse)


class _MeshBase:
    """Cache, snapshot and a backend on a 4-shard mesh, for one package."""

    def __init__(self, pkg, nodes):
        self.pkg = pkg
        self.names = JNames() if pkg == "jax" else TNames()
        self.cache = (JCache if pkg == "jax" else TCache)(self.names)
        for n in nodes:
            self.cache.add_node(n)
        self.snapshot = (JSnapshot if pkg == "jax" else TSnapshot)()
        self.cache.update_snapshot(self.snapshot)
        if pkg == "jax":
            self.backend = TPUBackend(self.names, context=jmesh.MeshContext(
                jmesh.scheduler_mesh(n_devices=4)))
        else:
            self.backend = TorchBackend(self.names, device="cpu", context=tmesh.MeshContext(
                tmesh.scheduler_mesh(4, device="cpu")))


def _mesh_node_change(pkg, cluster):
    """A cluster's first half of pods in waves of 8, a node added while a
    wave is in flight (mark_external -> NeedResync at the next launch ->
    drain, drop the carry, re-upload), then the second half."""
    types, meta = (jtypes, jmeta) if pkg == "jax" else (ttypes, tmeta)
    if cluster == "mixed":
        spec = mixed_spec(7, 24, 48, constraints=True)
        nodes, pods = build_nodes(spec, types, meta), build_pods(spec, types, meta)
    else:
        nodes = dedup_nodes(16, types, meta, cpu="8")
        pods = dedup_pods(48, types, meta, spread=(2, "zone"))
    side = _Side(pkg, None, base=_MeshBase(pkg, nodes))
    _waves_of(side, pods[:24], 8)
    w = _wrappers(side)
    side.cache.add_node(w.make_node("extra", cpu="64", mem="64Gi", zone="zone-1"))
    side.pipe.external(poison=False)
    _waves_of(side, pods[24:], 8)
    side.pipe.flush()
    return side


@pytest.mark.parametrize("cluster", ["mixed", "hard-spread"])
def test_mesh_pipeline_matches_reference(cluster, monkeypatch):
    """WavePipeline at depth 2 over both packages' mesh backends (4 node
    shards): the same launches raise, the same collects fall back, and
    after every collect and re-run the same hosts, carry planes,
    dedup_stats and run arrays; equal bindings and rng state. The port's
    waves went through K1 + K6 (its plain version here), the resync
    through a full put and later K3 scatters, the mesh context's."""
    jside = _mesh_node_change("jax", cluster)
    shards, real = [], tk.assign_scan_ref

    def spy(*args, comm=tk.LOCAL_COMM, **kw):
        shards.append(comm.n_shards)
        return real(*args, comm=comm, **kw)

    monkeypatch.setattr(tk, "assign_scan_ref", spy)
    tside = _mesh_node_change("port", cluster)
    assert tside.result() == jside.result()
    assert shards and set(shards) == {4}
    b = tside.backend.b
    assert b._ctx.n_shards == 4 and tside.pipe.stats["resyncs"] >= 1
    assert b.upload_stats["full"] >= 2
    if cluster == "mixed":
        assert b.upload_stats["scatter"] > 0 and tside.pipe.stats["reruns"] > 0
    else:
        assert b.pipe_stats["chained"] > 0 and b.dedup_stats["xwave_hits"] > 0
    assert any(h for e in tside.backend.log if e[0] == "collect" for h in e[1])
    assert b._inflight is None
