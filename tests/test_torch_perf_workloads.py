"""The port's scheduler_perf harness against the reference's, workload by
workload.

Every `short` workload of misc, topology_spreading, gang,
nodedeclaredfeatures and event_handling, and volumes' SchedulingSecrets
(plain pods, no volume), runs through the reference's
`WorkloadExecutor(backend="tpu", wave_size=32)` and the port's
`WorkloadExecutor(wave_size=32, device="cpu")` (the kernels' plain
versions): equal bindings (pod key → node), equal `scheduled`, equal final
tie-break rng state (tolerance 0: names and integers). The port reads its
JSON copies of the configs, the reference its YAML.

PreemptionBasic and PreemptionAsync run with both packages'
DefaultPreemption in the profile. Their 20Nodes workloads put two 3-CPU
victims on each 32-CPU node, which leaves room for every 25-CPU
preemptor: nothing is evicted, no eviction rides the dispatcher's
threads, and both compare exactly (the reference's own bindings did not
move over repeated runs). tests/test_torch_preemption_perf.py runs them
at a density that evicts.

Both packages' schedulers run on one virtual clock whose every reading is
1 µs past the last. The queues order equal priorities by queue time and
backoff pods by expiry: on the wall clock a tie between two queue times is
broken by the heap, and whether a requeued pod's backoff has expired
(EventHandlingPodDelete's waiters, moved by the blockers' deletes) depends
on how fast the run went, so the two runs would pop in different orders.
On the virtual clock no backoff expires within a run, and an idle queue
pops its backoff pods by expiry (SchedulerPopFromBackoffQ, on by default).
"""

from __future__ import annotations

from pathlib import Path

import pytest

import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu_torch.utils.clock as tclock
from kubernetes_tpu.perf.harness import WorkloadExecutor as JExecutor
from kubernetes_tpu.perf.harness import load_config as jload
from kubernetes_tpu_torch.ops.kernels import OutOfSlice
from kubernetes_tpu_torch.perf.harness import WorkloadExecutor as TExecutor
from kubernetes_tpu_torch.perf.harness import load_config as tload
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

REPO = Path(__file__).resolve().parent.parent
JCONFIGS = REPO / "kubernetes_tpu" / "perf" / "configs"
TCONFIGS = REPO / "kubernetes_tpu_torch" / "perf" / "configs"


def _short(config: str) -> list[tuple[str, str, str]]:
    return [(config, case["name"], wl["name"])
            for case in tload(TCONFIGS / f"{config}.json")
            for wl in case["workloads"] if "short" in wl.get("labels", [])]


PARITY = [w for c in ("misc", "topology_spreading", "gang", "nodedeclaredfeatures",
                      "event_handling") for w in _short(c)]
PARITY += [w for w in _short("volumes") if w[1] == "SchedulingSecrets"]
A4B = [w for c in ("volumes", "dra") for w in _short(c) if w[1] != "SchedulingSecrets"]


@pytest.fixture(autouse=True)
def _strict_clocks(monkeypatch):
    """Both packages' Clock.now on the virtual clock (see the docstring),
    and the port's fault registry disarmed and empty."""
    last = [1000.0]

    def now(self):
        last[0] += 1e-6
        return last[0]

    monkeypatch.setattr(jclock.Clock, "now", now)
    monkeypatch.setattr(tclock.Clock, "now", now)
    tfi.registry().reset(seed=0)
    yield
    tfi.registry().reset(seed=0)


def _pick(cases: list[dict], case_name: str, wl_name: str) -> tuple[dict, dict]:
    case = next(c for c in cases if c["name"] == case_name)
    return case, next(w for w in case["workloads"] if w["name"] == wl_name)


def _outcome(executor, result):
    binds = {p.meta.key: p.spec.node_name for p in executor.store.pods()}
    rng = executor.scheduler.algorithms["default-scheduler"].rng.getstate()
    return binds, result.scheduled, rng


def _run_reference(config, case_name, wl_name, **kw):
    ex = JExecutor(*_pick(jload(JCONFIGS / f"{config}.yaml"), case_name, wl_name), **kw)
    return _outcome(ex, ex.run()), ex


def _run_port(config, case_name, wl_name, **kw):
    ex = TExecutor(*_pick(tload(TCONFIGS / f"{config}.json"), case_name, wl_name),
                   device="cpu", **kw)
    return _outcome(ex, ex.run()), ex


@pytest.mark.parametrize("config,case_name,wl_name", PARITY,
                         ids=[f"{c}:{n}/{w}" for c, n, w in PARITY])
def test_short_workload_matches_reference(config, case_name, wl_name):
    want, jex = _run_reference(config, case_name, wl_name, backend="tpu", wave_size=32)
    got, tex = _run_port(config, case_name, wl_name, wave_size=32)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert all(got[0].values()), {k: v for k, v in got[0].items() if not v}
    # the same pods in the same waves
    waves = tex.scheduler.loop.phase_profile["waves"]
    assert waves == jex.scheduler.loop.phase_profile["waves"]
    talgo = tex.scheduler.algorithms["default-scheduler"]
    assert talgo.kernel_count == jex.scheduler.algorithms["default-scheduler"].kernel_count > 0
    if case_name == "SchedulingNodeDeclaredFeatures":
        # the hybrid route: K4 and the host NodeDeclaredFeatures tail
        nodes = {n.meta.name: n for n in tex.store.nodes()}
        assert all("NUMAAlignment" in nodes[v].status.declared_features
                   for v in got[0].values())


def test_wave_mode_bindings_match_host():
    """The port's per-pod cycle (wave_size 0: K4 per pod) against the
    reference's host backend on SchedulingBasic/50Nodes, and the port's
    wave pipeline (wave_size 32) against both: the port of
    tests/test_scheduler_perf.py::test_wave_mode_bindings_match_host."""
    want, _ = _run_reference("misc", "SchedulingBasic", "50Nodes", backend="host")
    got, tex = _run_port("misc", "SchedulingBasic", "50Nodes", wave_size=0)
    assert got == want
    assert tex.scheduler.loop.phase_profile["waves"] == 0
    waves, wex = _run_port("misc", "SchedulingBasic", "50Nodes", wave_size=32)
    assert waves[:2] == want[:2]
    assert wex.scheduler.loop.phase_profile["waves"] > 0
    algo = wex.scheduler.algorithms["default-scheduler"]
    assert algo.kernel_count > 0
    assert algo.fallback_count == 0


@pytest.mark.parametrize("config,case_name,wl_name", A4B,
                         ids=[f"{c}:{n}/{w}" for c, n, w in A4B])
def test_volume_and_claim_workloads_are_out_of_slice(config, case_name, wl_name):
    """volumes' and dra's short workloads (PVC/PV templates, CSI nodes,
    resource slices and claims) raise OutOfSlice naming A4b, and no object
    of the refused op is in the store."""
    case, wl = _pick(tload(TCONFIGS / f"{config}.json"), case_name, wl_name)
    ex = TExecutor(case, wl, wave_size=32, device="cpu")
    with pytest.raises(OutOfSlice, match="A4b"):
        ex.run()
    ex.close()
    assert ex.store.pods() == []
    for kind in ("PersistentVolumeClaim", "PersistentVolume", "StorageClass", "CSINode",
                 "ResourceClaim", "ResourceSlice"):
        assert ex.store.list(kind)[0] == []
