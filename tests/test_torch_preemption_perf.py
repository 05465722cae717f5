"""scheduler_perf's Preemption cases through both packages' harnesses at
the density that makes them preempt.

The short 20Nodes workloads put two 3-CPU victims on each 32-CPU node,
which leaves room for every 25-CPU preemptor, so neither package preempts
there (tests/test_torch_perf_workloads.py compares them exactly). Here the
same PreemptionBasic and PreemptionAsync run at 20 nodes with the
5000Nodes case's density, 4 victims a node, so each preemptor evicts two,
through the reference's WorkloadExecutor(backend="tpu", wave_size=32) and
the port's (device="cpu"), on the virtual clock of
tests/test_torch_preemption.py: PreemptionBasic (synchronous evictions)
exactly, evictions in order, bindings and rng; PreemptionAsync by
invariants (every preemptor bound, the same number of evictions, each
evicted pod of lower priority than the preemptor on its node, no node over
its CPU, memory or pod count), since its evictions run on the dispatcher's
threads and the reference's own bindings move with their timing.
"""

from __future__ import annotations

import copy

import pytest

from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.perf.harness import WorkloadExecutor as JExecutor
from kubernetes_tpu.perf.harness import load_config as jload
from kubernetes_tpu.scheduler.nodeinfo import PodInfo as JPodInfo
from kubernetes_tpu_torch.api.resource import CPU, MEM
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.perf.harness import WorkloadExecutor as TExecutor
from kubernetes_tpu_torch.perf.harness import load_config as tload
from kubernetes_tpu_torch.scheduler.nodeinfo import PodInfo as TPodInfo
from tests.test_torch_perf_workloads import JCONFIGS, TCONFIGS, _pick
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)
from tests.test_torch_preemption import both, clock  # noqa: F401 (clock: autouse)

POD_INFO = {"jax": (JPodInfo, JNames), "port": (TPodInfo, TNames)}

DENSE = {"initNodes": 20, "initPods": 80, "measurePods": 10}


def _dense_run(side, case_name):
    if side.name == "jax":
        case, wl = _pick(jload(JCONFIGS / "misc.yaml"), case_name, "20Nodes")
        kw = {"backend": "tpu", "wave_size": 32}
        cls = JExecutor
    else:
        case, wl = _pick(tload(TCONFIGS / "misc.json"), case_name, "20Nodes")
        kw = {"wave_size": 32, "device": "cpu"}
        cls = TExecutor
    wl = dict(copy.deepcopy(wl), params=dict(DENSE))
    evicted = []
    orig = side.Store.delete

    def delete(self, kind, key):
        out = orig(self, kind, key)
        if kind == "Pod":
            evicted.append(out)
        return out

    side.Store.delete = delete
    try:
        ex = cls(case, wl, **kw)
        result = ex.run()
    finally:
        side.Store.delete = orig
    pods = {p.meta.key: p for p in ex.store.pods()}
    pod_info, names_cls = POD_INFO[side.name]
    names_ = names_cls()
    requests = {k: pod_info(p, names_).request for k, p in pods.items()}
    binds = {k: p.spec.node_name for k, p in pods.items()}
    return {"binds": binds, "scheduled": result.scheduled, "evicted": evicted,
            "pods": pods, "requests": requests,
            "alloc": {n.meta.name: (n.status.allocatable["cpu"], n.status.allocatable["memory"],
                                    n.status.allocatable["pods"]) for n in ex.store.nodes()},
            "rng": ex.scheduler.algorithms["default-scheduler"].rng.getstate()}


def _invariants(r):
    """Every preemptor bound; each evicted pod of lower priority than the
    preemptor on its node; no node over its CPU, memory or pod count."""
    pres = {k: p for k, p in r["pods"].items() if p.spec.priority > 0}
    assert len(pres) == DENSE["measurePods"]
    assert all(p.spec.node_name for p in pres.values())
    on_node = {p.spec.node_name: p.spec.priority for p in pres.values()}
    for v in r["evicted"]:
        assert v.spec.priority < on_node.get(v.spec.node_name, 1 << 30)
    used: dict = {}
    for k, p in r["pods"].items():
        u = used.setdefault(p.spec.node_name, [0, 0, 0])
        req = r["requests"][k]
        u[0] += req[CPU]
        u[1] += req[MEM]
        u[2] += 1
    # the template's nodes: 32 CPU, 64Gi, 110 pods
    assert {a for a in r["alloc"].values()} == {("32", "64Gi", 110)}
    for name, (cpu_m, mem_mib, n_pods) in used.items():
        assert cpu_m <= 32000 and mem_mib <= 64 * 1024 and n_pods <= 110, name


@pytest.mark.parametrize("case_name", ["PreemptionBasic", "PreemptionAsync"])
def test_dense_preemption_cases(case_name):
    want, got = both(_dense_run, case_name)
    assert len(got["evicted"]) == len(want["evicted"]) > 0
    _invariants(want)
    _invariants(got)
    if case_name == "PreemptionBasic":
        # synchronous evictions: the same run, eviction for eviction
        assert got["binds"] == want["binds"]
        assert got["rng"] == want["rng"]
        assert ([v.meta.key for v in got["evicted"]]
                == [v.meta.key for v in want["evicted"]])
    assert got["scheduled"] == want["scheduled"] == len(got["binds"])
