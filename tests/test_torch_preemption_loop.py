"""The port's preemption against the reference's on the longer runs.

As tests/test_torch_preemption.py (whose sides, virtual clock and helpers
this file uses): both packages' Schedulers on the same inputs, results
held equal (tolerance 0: pod names, node names and integers):

- tests/test_nominated_fallback.py's three scenarios, with the
  kernel_count and fallback_count deltas;
- tests/test_golden_fuzz.py::test_preemption_parity_host_vs_tpu, seeds 3
  and 7.
"""

from __future__ import annotations

import random

import pytest

from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)
from tests.test_torch_preemption import (  # noqa: F401 (clock: autouse)
    _pre,
    _victim,
    both,
    clock,
    outcome,
    scheduler,
    settle,
)

# --------------------------------------------------------------------------
# tests/test_nominated_fallback.py
# --------------------------------------------------------------------------


def _fallback_setup(side, n_nodes=20, cpu="4", wave=16):
    store = side.Store()
    for i in range(n_nodes):
        store.create(side.w.make_node(f"n{i}", cpu=cpu, mem="16Gi", zone=f"z{i % 4}"))
    sched = scheduler(side, store, wave_size=wave,
                      feature_gates={"SchedulerPopFromBackoffQ": False})
    return store, sched


def _fill_and_nominate(side, store, sched):
    for i in range(20):
        store.create(_victim(side, f"victim-{i}", prio=0))
    sched.schedule_pending()
    store.create(_pre(side, "preemptor", 100))
    sched.schedule_pending()
    assert sched.queue.has_nominated_pods()
    return store.get("Pod", "default/preemptor").status.nominated_node_name


def _higher_priority_stay_on_kernel(side, clock):
    store, sched = _fallback_setup(side)
    _fill_and_nominate(side, store, sched)
    algo = sched.algorithms["default-scheduler"]
    k0, f0 = algo.kernel_count, algo.fallback_count
    for i in range(32):
        p = side.w.make_pod(f"vip-{i}", cpu="100m", mem="64Mi")
        p.spec.priority = 200
        store.create(p)
    sched.schedule_pending()
    deltas = (algo.kernel_count - k0, algo.fallback_count - f0)
    assert deltas[0] >= 32 and deltas[1] <= 1
    return outcome(store, sched), deltas


def _lower_priority_hybrid(side, clock):
    store, sched = _fallback_setup(side)
    nominee = _fill_and_nominate(side, store, sched)
    assert nominee
    algo = sched.algorithms["default-scheduler"]
    k0, f0 = algo.kernel_count, algo.fallback_count
    for i in range(4):
        store.create(_victim(side, f"low-{i}", prio=0))
    sched.schedule_pending()
    deltas = (algo.kernel_count - k0, algo.fallback_count - f0)
    assert deltas[0] >= 4 and deltas[1] <= 1
    for i in range(4):
        low = store.get("Pod", f"default/low-{i}")
        assert low.spec.node_name != nominee or not low.spec.node_name
    return outcome(store, sched), deltas


def _mixed_workload_kernel_ratio(side, clock):
    store, sched = _fallback_setup(side, n_nodes=40, cpu="8", wave=32)
    algo = sched.algorithms["default-scheduler"]
    for i in range(150):
        store.create(side.w.make_pod(f"web-{i}", cpu="200m", mem="128Mi",
                                     labels={"app": "web"}))
    sched.schedule_pending()
    for i in range(8):
        store.create(_victim(side, f"victim-{i}", cpu="3500m"))
    sched.schedule_pending()
    for i in range(4):
        store.create(_pre(side, f"pre-{i}", 100, cpu="3500m"))
    for _ in range(30):
        sched.schedule_pending()
        if all(store.get("Pod", f"default/pre-{i}").spec.node_name for i in range(4)):
            break
        clock.advance(0.2)
    mid = outcome(store, sched)
    for i in range(150):
        store.create(side.w.make_pod(f"tail-{i}", cpu="200m", mem="128Mi",
                                     labels={"app": "web"}))
    sched.schedule_pending()
    ratio = algo.kernel_count / (algo.kernel_count + algo.fallback_count)
    assert ratio >= 0.9
    return mid, outcome(store, sched)


FALLBACK = {
    "higher_priority_pods_stay_on_kernel": _higher_priority_stay_on_kernel,
    "lower_priority_pods_use_hybrid_with_protection": _lower_priority_hybrid,
    "mixed_workload_kernel_ratio": _mixed_workload_kernel_ratio,
}


@pytest.mark.parametrize("name", sorted(FALLBACK))
def test_nominated_fallback_matches_reference(clock, name):
    """test_nominated_fallback.py's scenarios: the same outcomes and the same
    kernel_count and fallback_count deltas in both packages."""
    want, got = both(FALLBACK[name], clock)
    assert got == want


# --------------------------------------------------------------------------
# test_golden_fuzz.py::test_preemption_parity_host_vs_tpu
# --------------------------------------------------------------------------


def _golden_preemption(side, clock, seed):
    zones = ("zone-a", "zone-b", "zone-c")
    rng = random.Random(seed)
    store = side.Store()
    for i in range(8):
        store.create(side.w.make_node(f"n{i}", cpu="4", mem="8Gi", zone=rng.choice(zones)))
    s = scheduler(side, store, seed=5)
    for i in range(16):
        store.create(_victim(side, f"low-{i:02d}", cpu="1800m"))
    s.schedule_pending()
    vips = [f"vip-{i}" for i in range(rng.randint(3, 5))]
    for name in vips:
        p = side.w.make_pod(name, cpu="3", mem="2Gi")
        p.spec.priority = 100
        store.create(p)
    assert settle(store, s, clock, vips, rounds=60)
    return outcome(store, s)


@pytest.mark.parametrize("seed", [3, 7])
def test_golden_preemption_parity(clock, seed):
    want, got = both(_golden_preemption, clock, seed)
    assert got == want
    assert any(n.startswith("low") for n in got["pods"])
    assert len(got["pods"]) < 16 + 5  # victims were evicted
