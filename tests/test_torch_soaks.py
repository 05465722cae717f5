"""The five seeded soaks of testing/chaos.py on both packages.

Each soak runs at the reference's defaults (seed 7) in the reference
package (kubernetes_tpu.testing.chaos) and in the port
(kubernetes_tpu_torch.testing.chaos, device="cpu": the kernels' plain
versions). Both reports must be `ok`, and every field on which the
reference agrees with itself run after run must be equal in the port's
report (tolerance 0: counts).

The soaks are driven by wall-clock ticks, sleeps and thread timing (the
breaker's cooldown, the queue's backoff, the async dispatcher, the lease
clocks), so some of their counts follow timing. Which fields the
reference repeats was checked by running it four times in one process
(run_soak, run_gang_soak, run_restart_soak) and three times (run_trace_soak,
run_fleet_soak), beside the port as often:

- run_soak: every field but breaker_trips (1-2 in the reference),
  faults_fired (71-79) and retries (28-36). The probabilistic specs fire
  per visit, and the visits follow how the breaker's 50 ms cooldown and
  the 20-100 ms backoffs fall between waves;
- run_trace_soak: every field but bound and evicted (5-17 of the 96
  bound in the reference: how many pods the fleet-wide outage finds
  bound), retries (7-8), the stall counts (29-31 waves, 9-10 flushes),
  wall_clock_s and faults_fired. The reference's three runs gave 827
  faults; the port's 826-828: the bind-latency spec (probability 0.15)
  fires per bind visit, and the bind visits follow the bound/evicted
  split, so faults_fired is held to `ok` (> 0) and its deterministic
  parts are equal (the partition window, the outage's kubelet drops);
- run_gang_soak, run_restart_soak: every field but wall_clock_s;
- run_fleet_soak: every field but failovers (1-3), shard_adoptions
  (5-25), faults_fired (338-344) and the wall-clock fields: which
  survivor adopts the orphaned shard, and when, is a race between the
  members' lease rounds.

The trace soak's heavier second seed (192 pods) stays `slow`, as in the
reference's tests/test_chaos.py.
"""

from __future__ import annotations

import dataclasses

import pytest

import kubernetes_tpu.testing.chaos as jchaos
import kubernetes_tpu_torch.testing.chaos as tchaos
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu_torch.utils import faultinject as tfi
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

TIMED = ("wall_clock_s",)
# fields that follow timing in the reference's own runs (docstring)
VARIES = {
    "run_soak": ("breaker_trips", "faults_fired", "retries"),
    "run_trace_soak": ("bound", "evicted", "retries", "stall_waves", "stall_flush_events",
                       "stall_coverage_min", "partition_repair_latency_s",
                       "faults_fired") + TIMED,
    "run_gang_soak": TIMED,
    "run_restart_soak": TIMED,
    "run_fleet_soak": ("failovers", "shard_adoptions", "faults_fired",
                       "failover_latency_s") + TIMED,
}


@pytest.fixture(autouse=True)
def _clean_registries():
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)
    yield
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)


@pytest.mark.parametrize("soak", sorted(VARIES))
def test_soak_reports_match_the_reference(soak):
    ref = getattr(jchaos, soak)(seed=7)
    port = getattr(tchaos, soak)(seed=7, device="cpu")
    assert ref.ok, ref.render()
    assert port.ok, port.render()
    skip = set(VARIES[soak])
    want = {k: v for k, v in dataclasses.asdict(ref).items() if k not in skip}
    got = {k: v for k, v in dataclasses.asdict(port).items() if k not in skip}
    assert got == want, (port.render(), ref.render())
    assert port.faults_fired > 0


def test_trace_soak_outage_and_partition_are_deterministic():
    """The trace soak's scheduled faults fire on fixed visits: the 400-visit
    watch partition and the outage's 30 ticks x 12 kubelets."""
    report = tchaos.run_trace_soak(seed=7, device="cpu")
    assert report.ok, report.render()
    assert report.kubelet_outage_drops == 30 * 12
    assert report.faults_fired >= 400 + 360


@pytest.mark.slow
def test_arrival_trace_soak_second_seed_heavier():
    report = tchaos.run_trace_soak(seed=1234, pods=192, budget_s=120.0, device="cpu")
    assert report.ok, report.render()
