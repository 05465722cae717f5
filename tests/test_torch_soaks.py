"""The five seeded soaks of testing/chaos.py on both packages.

Each soak runs at the reference's defaults (seed 7) in the reference
package (kubernetes_tpu.testing.chaos) and in the port
(kubernetes_tpu_torch.testing.chaos, device="cpu": the kernels' plain
versions). Both reports must be `ok`, and every field on which the
reference agrees with itself run after run must be equal in the port's
report (tolerance 0: counts).

Both soaks run on one logical clock (`logical_clock`, patched in from
this side; neither package changes): the chaos modules' `time` and the
`Clock` of both packages' utils/clock.py (the Scheduler and its queue,
the kubelets, the lifecycle controller, the fleet members and their
leases) read seconds that pass only as the drive loop sleeps, so a 4.0 s
lease, a 6.0 s grace period or a 60 s convergence deadline holds as many
ticks on a loaded host as on an idle one. A tick also ends only when the
async dispatchers' calls have landed, and so does every
schedule_pending: a bind lands before the next member, kubelet or
controller looks. Left on the host's clock: the circuit breaker's
cooldown (its clock is bound when the module loads), retry backoffs
inside the dispatcher and the sleeps themselves, which still pass on the
wall clock as before; the dispatcher's own waits (time.monotonic is not
patched: its worker threads wait on it).

Some counts still follow thread timing (the breaker's cooldown, which of
a dispatcher's 16 workers visits a fault point first). Which fields the
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
import threading
import time
import types

import pytest

import kubernetes_tpu.scheduler.api_dispatcher as jdispatch
import kubernetes_tpu.scheduler.scheduler as jsched
import kubernetes_tpu.testing.chaos as jchaos
import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu_torch.scheduler.api_dispatcher as tdispatch
import kubernetes_tpu_torch.scheduler.scheduler as tsched
import kubernetes_tpu_torch.testing.chaos as tchaos
import kubernetes_tpu_torch.utils.clock as tclock
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


class LogicalClock:
    """Seconds that pass only as the drive loop sleeps: sleep(s) first
    waits until every open async dispatcher has landed its calls (settle),
    then sleeps s on the wall clock, as the soaks always have, and advances
    the logical seconds by s plus WORK_S, the host's work a tick stands for
    (the soaks were written for ticks that take longer than their sleep: at
    s alone the trace soak's 30-tick outage would go stale only after every
    arrival has bound, and its outage would find nothing pending). A
    blocking wait (the permit's wait_for) that times out advances them by
    its timeout."""

    START = 1.0e6
    WORK_S = 0.05

    def __init__(self):
        self._now = self.START
        self._lock = threading.Lock()
        self.dispatchers = []

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def settle(self, dispatchers=None, timeout: float = 30.0) -> None:
        """Wait (wall clock, at most `timeout`) until none of `dispatchers`
        (default: every one made since the clock started) holds a queued or
        executing call; a closed dispatcher holds none."""
        deadline = time.monotonic() + timeout
        for d in self.dispatchers if dispatchers is None else dispatchers:
            while time.monotonic() < deadline:
                with d._lock:
                    if d._closed or not (d._queued or d._executing):
                        break
                time.sleep(0.001)

    def sleep(self, seconds: float) -> None:
        self.settle()
        time.sleep(seconds)
        self.advance(seconds + self.WORK_S)


@pytest.fixture
def logical_clock(monkeypatch):
    """Both soaks on one LogicalClock (see the module docstring)."""
    lc = LogicalClock()
    chaos_time = types.SimpleNamespace(monotonic=lc.now, time=lc.now, sleep=lc.sleep,
                                       perf_counter=time.perf_counter)

    def wait_for(_clock, waiter, timeout):
        result = waiter(timeout)
        if result is None:
            lc.advance(timeout)
        return result

    for chaos, clock, dispatch, sched in ((jchaos, jclock, jdispatch, jsched),
                                          (tchaos, tclock, tdispatch, tsched)):
        monkeypatch.setattr(chaos, "time", chaos_time)
        monkeypatch.setattr(clock.Clock, "now", lambda _clock: lc.now())
        monkeypatch.setattr(clock.Clock, "sleep", lambda _clock, seconds: lc.sleep(seconds))
        monkeypatch.setattr(clock.Clock, "wait_for", wait_for)
        init = dispatch.APIDispatcher.__init__

        def made(self, *a, _init=init, **k):
            _init(self, *a, **k)
            lc.dispatchers.append(self)

        monkeypatch.setattr(dispatch.APIDispatcher, "__init__", made)
        pending = sched.Scheduler.schedule_pending

        def settled(self, *a, _pending=pending, **k):
            try:
                return _pending(self, *a, **k)
            finally:
                d = getattr(self, "api_dispatcher", None)
                if d is not None:
                    lc.settle([d])

        monkeypatch.setattr(sched.Scheduler, "schedule_pending", settled)
    return lc


@pytest.fixture(autouse=True)
def _clean_registries():
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)
    yield
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)


@pytest.mark.parametrize("soak", sorted(VARIES))
def test_soak_reports_match_the_reference(soak, logical_clock):
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
