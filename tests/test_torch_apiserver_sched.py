"""The port's Scheduler behind its API server and over its REST client,
against the reference's.

Both packages run the same seeded workload (nodes in three zones, pods of
mixed requests, a third of them naming a PriorityClass that the API
server's priority admission resolves), every object created through the
package's own RESTStore (the nodes and every other pod as CBOR bodies):

- behind the server: APIServer(store, admission=default_admission_chain)
  on 127.0.0.1 and the Scheduler on that Store with waves (bootstrap's
  Profile(backend="tpu", wave_size=...)). Bindings, PodScheduled=False
  diagnoses and the final tie-break rng state are equal, the admitted
  priorities reach the pods, a RESTWatch from revision 0 sees one binding
  MODIFIED per bound pod, and the port behind its server equals the port
  on a plain in-process Store fed the same objects in the same order;
- over the REST client: Scheduler(RESTStore(url), Profile(wave_size=0)),
  informers list/watching over HTTP, each pod through the per-pod cycle
  and bound by a PUT of the pod (DefaultBinder on a store without the
  binding subresource). Bindings and rng equal;
- ROADMAP C19: the wave path over a RESTStore fails to bind in both
  packages (RESTStore has no bind_pods: a wave's batched bind fails for
  every pod of the wave), with the same pods unbound, the same
  PodScheduled=False status and the same rng.

Every Scheduler runs on a virtual clock (1 us a reading), so the queue's
order and backoff do not follow the host's load. The port runs with
device="cpu" (the kernels' plain versions); without a card and without
device="cpu" its Scheduler behind the server raises.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.api.meta import ObjectMeta as JObjectMeta
from kubernetes_tpu.api.types import PriorityClass as JPriorityClass
from kubernetes_tpu.apiserver.admission import default_admission_chain as jadm
from kubernetes_tpu.apiserver.server import APIServer as JAPIServer
from kubernetes_tpu.client.rest import RESTStore as JRESTStore
from kubernetes_tpu.scheduler import Profile as JProfile
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store.store import MODIFIED
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
from kubernetes_tpu_torch.api.meta import ObjectMeta as TObjectMeta
from kubernetes_tpu_torch.api.types import PriorityClass as TPriorityClass
from kubernetes_tpu_torch.apiserver.admission import default_admission_chain as tadm
from kubernetes_tpu_torch.apiserver.server import APIServer as TAPIServer
from kubernetes_tpu_torch.client.rest import RESTStore as TRESTStore
from kubernetes_tpu_torch.scheduler.scheduler import Profile as TProfile
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler as TScheduler
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.utils import faultinject as tfi
from kubernetes_tpu_torch.utils.clock import FakeClock as TFakeClock
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

SIDES = {
    "jax": SimpleNamespace(name="jax", w=jw, Store=JStore, APIServer=JAPIServer,
                           admission=jadm, REST=JRESTStore, Scheduler=JScheduler,
                           Profile=JProfile, meta=JObjectMeta,
                           PriorityClass=JPriorityClass, FakeClock=JFakeClock, kw={}),
    "port": SimpleNamespace(name="port", w=tw, Store=TStore, APIServer=TAPIServer,
                            admission=tadm, REST=TRESTStore, Scheduler=TScheduler,
                            Profile=TProfile, meta=TObjectMeta,
                            PriorityClass=TPriorityClass, FakeClock=TFakeClock,
                            kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _port_registry():
    tfi.registry().reset(seed=0)
    jfi.registry().reset(seed=0)
    yield
    tfi.registry().reset(seed=0)


def tick_clock(side):
    """The side's virtual clock at 1 us a reading: queue times keep the
    informer's order and no backoff expires inside one schedule_pending
    (on the wall clock, C19's retried pods followed the host's load)."""

    class TickClock(side.FakeClock):
        def now(self) -> float:
            with self._mu:
                self._now += 1e-6
                return self._now

    return TickClock()


def workload(side, seed: int, nodes: int = 12, pods: int = 40):
    """(priority classes, nodes, pods) of one seeded workload, built with
    the side's own wrappers."""
    rng = np.random.default_rng(seed)
    classes = [side.PriorityClass(meta=side.meta(name="high", namespace=""),
                                  value=1000)]
    ns = [side.w.make_node(f"n{i:02d}", cpu=str(int(rng.integers(4, 9))),
                           mem="16Gi", zone=f"z{i % 3}") for i in range(nodes)]
    ps = []
    for i in range(pods):
        p = side.w.make_pod(f"p{i:03d}", cpu=f"{int(rng.integers(1, 8)) * 100}m",
                            mem=f"{int(rng.integers(1, 4)) * 256}Mi",
                            labels={"app": f"a{int(rng.integers(0, 3))}"})
        if i % 3 == 0:
            p.spec.priority_class_name = "high"
        ps.append(p)
    return classes, ns, ps


def create_all(json_client, cbor_client, objs) -> None:
    for i, obj in enumerate(objs):
        (cbor_client if i % 2 else json_client).create(obj)


def outcome(pods, sched):
    sched.event_recorder.flush()
    placed = {p.meta.name: p.spec.node_name for p in pods}
    diags = {}
    for p in pods:
        for c in p.status.conditions:
            if c.type == "PodScheduled" and c.status == "False":
                diags[p.meta.name] = f"{c.reason}: {c.message}"
    return placed, diags, sched.algorithms["default-scheduler"].rng.getstate()


def serve(side):
    store = side.Store()
    server = side.APIServer(store, admission=side.admission(store))
    server.serve(0)
    return store, server


def behind_server(side, seed: int, wave: int = 8):
    """The Scheduler on the Store the server fronts; everything created
    through the REST client. Returns (outcome, priorities, binding
    MODIFIED count per pod)."""
    store, server = serve(side)
    try:
        client = side.REST(server.url)
        cbor = side.REST(server.url, wire_format="cbor")
        classes, nodes, pods = workload(side, seed)
        create_all(client, cbor, classes + nodes)
        sched = side.Scheduler(store, profiles=[side.Profile(
            backend="tpu", wave_size=wave)], clock=tick_clock(side), **side.kw)
        sched.start()
        create_all(client, cbor, pods)
        sched.schedule_pending()
        watch = client.watch("Pod", from_revision=0)
        binds: dict[str, int] = {}
        want = sum(1 for p in store.pods() if p.spec.node_name)
        give_up = time.monotonic() + 20
        while sum(binds.values()) < want and time.monotonic() < give_up:
            ev = watch.next(timeout=0.5)
            if ev is not None and ev.type == MODIFIED and ev.obj.spec.node_name:
                binds[ev.obj.meta.name] = binds.get(ev.obj.meta.name, 0) + 1
        watch.stop()
        listed, _ = client.list("Pod")
        prios = {p.meta.name: p.spec.priority for p in listed}
        return outcome(listed, sched), prios, binds
    finally:
        server.shutdown()


def in_process(side, seed: int, wave: int = 8):
    """The same objects in the same order on a plain in-process Store."""
    store = side.Store()
    classes, nodes, pods = workload(side, seed)
    for obj in classes + nodes:
        store.create(obj)
    sched = side.Scheduler(store, profiles=[side.Profile(
        backend="tpu", wave_size=wave)], clock=tick_clock(side), **side.kw)
    sched.start()
    for p in pods:
        if p.spec.priority_class_name == "high":
            p.spec.priority = 1000  # what the server's admission resolves
        store.create(p)
    sched.schedule_pending()
    return outcome(store.pods(), sched)


def over_rest(side, seed: int, wave: int):
    """Scheduler(RESTStore(url)): every object created before the
    scheduler starts, so its informers' first list holds them all."""
    store, server = serve(side)
    try:
        client = side.REST(server.url)
        cbor = side.REST(server.url, wire_format="cbor")
        classes, nodes, pods = workload(side, seed, nodes=6, pods=16)
        create_all(client, cbor, classes + nodes + pods)
        sched = side.Scheduler(side.REST(server.url), profiles=[side.Profile(
            backend="tpu", wave_size=wave)], clock=tick_clock(side), **side.kw)
        sched.start()
        sched.schedule_pending()
        return outcome(client.list("Pod")[0], sched)
    finally:
        server.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_behind_the_server(seed):
    out = {name: behind_server(side, seed) for name, side in SIDES.items()}
    (jo, jprio, jbinds), (to, tprio, tbinds) = out["jax"], out["port"]
    assert to == jo
    assert tprio == jprio
    assert {v for k, v in tprio.items() if int(k[1:]) % 3 == 0} == {1000}
    bound = {k for k, v in to[0].items() if v}
    assert len(bound) > 20
    assert tbinds == jbinds == {k: 1 for k in bound}
    assert in_process(SIDES["port"], seed) == to


@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_over_the_rest_client(seed):
    jo = over_rest(SIDES["jax"], seed, wave=0)
    to = over_rest(SIDES["port"], seed, wave=0)
    assert to == jo
    assert all(to[0].values())


def test_waves_over_the_rest_client_fail_to_bind_c19():
    """16 pods in waves of 8: the first wave's batched bind fails for each
    of its pods (SchedulerError: no bind_pods); its successor, launched on
    a carry holding those assumes, is poisoned and re-run through the
    per-pod route, whose DefaultBinder binds by PUT."""
    jo = over_rest(SIDES["jax"], 0, wave=8)
    to = over_rest(SIDES["port"], 0, wave=8)
    assert to == jo
    unbound = sorted(k for k, v in to[0].items() if not v)
    assert len(unbound) == 8 and sorted(to[1]) == unbound
    assert all("bind_pods" in d for d in to[1].values())


def test_no_card_no_cpu_raises():
    """Behind the server, as anywhere: without a card and without
    device="cpu" the port's Scheduler raises (nothing falls back)."""
    import torch

    side = SIDES["port"]
    store, server = serve(side)
    try:
        if torch.cuda.is_available():
            pytest.fail("this check is for a host without a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            side.Scheduler(store, profiles=[side.Profile(wave_size=8)])
    finally:
        server.shutdown()
