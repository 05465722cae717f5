"""One seeded cluster story through both packages' kubeadm init.

The reference's ClusterBootstrap(backend="tpu") (JAX on the CPU) and the
port's ClusterBootstrap(device="cpu") (the kernels' plain PyTorch
versions) each bring up a 16-node cluster on a FakeClock (the store's
clock too): API server,
the Scheduler with bootstrap's wave profile, the controller manager, a
hollow kubelet and a proxy per node. Both are driven by converge() through
the same story, every object created through the package's own admin
client:

- a Deployment, scaled and rolled out;
- a Service, whose EndpointSlice and the proxies' rules follow;
- a StatefulSet with a volume claim template, bound through the PV
  controller;
- a DaemonSet;
- a Job with a run duration, which ends and is deleted by
  TTLAfterFinished;
- a CronJob firing as the clock advances;
- an HPA reading PodMetrics;
- a namespace deleted through the namespace controller and the garbage
  collector;
- a node whose lease goes stale, which the lifecycle controller taints
  and whose pods it evicts.

After every step both stores hold the same objects of every kind (uids
and timestamps masked), the same bindings, the Scheduler's tie-break rng
is in the same state and every proxy's DataplaneTable holds the same
rules (the event recorders flush at each step's end only). Generated pod
and job names carry the process-wide uid counter (api/meta.py's
`_uid_counter` in both packages), so the test sets both counters before
the story.
"""

from __future__ import annotations

import dataclasses
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.api.meta as jmeta
import kubernetes_tpu.api.serialization as jser
import kubernetes_tpu.api.storage as jstorage
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.api.workloads as jwl
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu_torch.api.meta as tmeta
import kubernetes_tpu_torch.api.serialization as tser
import kubernetes_tpu_torch.api.storage as tstorage
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.api.workloads as twl
import kubernetes_tpu_torch.testing.wrappers as tw
from kubernetes_tpu.cmd.bootstrap import ClusterBootstrap as JBoot
from kubernetes_tpu.store.store import Store as JStore
from kubernetes_tpu.controllers.lifecycle import (
    UNREACHABLE_TAINT as J_UNREACHABLE,
)
from kubernetes_tpu.utils import faultinject as jfi
from kubernetes_tpu.utils.clock import FakeClock as JFakeClock
from kubernetes_tpu_torch.cmd.bootstrap import ClusterBootstrap as TBoot
from kubernetes_tpu_torch.store import Store as TStore
from kubernetes_tpu_torch.controllers.lifecycle import (
    UNREACHABLE_TAINT as T_UNREACHABLE,
)
from kubernetes_tpu_torch.utils import faultinject as tfi
from kubernetes_tpu_torch.utils.clock import FakeClock as TFakeClock
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

NODES = 16
SEED = 7
T0 = 1767225600.0  # the clocks' start, on a five-minute boundary

SIDES = {
    "jax": SimpleNamespace(name="jax", meta=jmeta, ser=jser, storage=jstorage,
                           types=jtypes, wl=jwl, w=jw, FakeClock=JFakeClock,
                           Store=JStore,
                           unreachable=J_UNREACHABLE,
                           boot=lambda **kw: JBoot(backend="tpu", **kw)),
    "port": SimpleNamespace(name="port", meta=tmeta, ser=tser, storage=tstorage,
                            types=ttypes, wl=twl, w=tw, FakeClock=TFakeClock,
                            Store=TStore,
                            unreachable=T_UNREACHABLE,
                            boot=lambda **kw: TBoot(device="cpu", **kw)),
}


@pytest.fixture(autouse=True)
def _registries():
    tfi.registry().reset(seed=0)
    jfi.registry().reset(seed=0)
    yield
    tfi.registry().reset(seed=0)


# ------------------------------------------------------------ comparison


MASK = "<masked>"
_MASKED_KEYS = {"uid", "creation_timestamp", "deletion_timestamp",
                "first_timestamp", "last_timestamp", "start_time",
                "timestamp", "last_transition_time", "time"}


def _mask(v):
    if isinstance(v, dict):
        return {k: (MASK if k in _MASKED_KEYS else _mask(x))
                for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x) for x in v]
    return v


def state(side, boot):
    """Everything the step must leave equal: every stored object of every
    kind (masked), the bindings, the rng state and the proxies' rules."""
    store = boot.store
    boot.scheduler.event_recorder.flush()
    objects = {}
    with store._mu:
        kinds = sorted(store._objects)
        for kind in kinds:
            objects[kind] = {k: _mask(side.ser.encode(o))
                             for k, o in sorted(store._objects[kind].items())}
    bindings = {p.meta.key: p.spec.node_name for p in store.pods()}
    rng = boot.scheduler.algorithms["default-scheduler"].rng.getstate()
    rules = [
        {key: dataclasses.asdict(r) for key, r in sorted(p.dataplane.rules().items())}
        for p in boot.proxiers
    ]
    return objects, bindings, rng, rules


def assert_equal(step, js, ts):
    jobj, jbind, jrng, jrules = js
    tobj, tbind, trng, trules = ts
    assert sorted(jobj) == sorted(tobj), step
    for kind in jobj:
        assert sorted(jobj[kind]) == sorted(tobj[kind]), (step, kind)
        for key in jobj[kind]:
            assert jobj[kind][key] == tobj[kind][key], (step, kind, key)
    assert jbind == tbind, step
    assert jrng == trng, step
    assert jrules == trules, step


# ----------------------------------------------------------------- story


def _template(side, labels, cpu):
    return side.wl.PodTemplateSpec(
        labels=dict(labels),
        spec=side.types.PodSpec(containers=[side.types.Container(
            requests={"cpu": cpu, "memory": "64Mi"})]),
    )


def advance(boot, seconds: float, step: float = 10.0) -> None:
    """Move the clock in steps the kubelets' heartbeats keep up with (the
    lifecycle controller's grace period is 40 s), converging after each."""
    left = seconds
    while left > 0:
        d = min(step, left)
        boot.clock.step(d)
        boot.converge()
        left -= d


def story(side, boot, rng_seed: int):
    """The steps; yields each step's name after it converged."""
    rng = np.random.default_rng(rng_seed)
    M, WL = side.meta, side.wl
    client = boot.client()

    client.create(WL.Deployment(
        meta=M.ObjectMeta(name="web"),
        spec=WL.DeploymentSpec(replicas=3, template=_template(
            side, {"app": "web"}, f"{int(rng.integers(1, 5)) * 100}m")),
    ))
    boot.converge()
    yield "deployment"

    dep = client.get("Deployment", "default/web")
    dep.spec.replicas = 6
    client.update(dep, check_version=False)
    boot.converge()
    yield "scale"

    dep = client.get("Deployment", "default/web")
    dep.spec.template = _template(side, {"app": "web"},
                                  f"{int(rng.integers(5, 9)) * 100}m")
    client.update(dep, check_version=False)
    boot.converge(rounds=30)
    yield "rollout"

    client.create(WL.Service(
        meta=M.ObjectMeta(name="web"),
        spec=WL.ServiceSpec(selector={"app": "web"},
                            ports=(WL.ServicePort(port=80, target_port=8080),),
                            cluster_ip="10.0.0.80"),
    ))
    boot.converge()
    yield "service"

    client.create(side.w.make_storage_class("local",
                                            wait_for_first_consumer=True))
    for i in range(3):
        client.create(side.w.make_pv(f"pv-{i}", storage="10Gi",
                                     storage_class="local",
                                     node_names=(f"node-{3 * i + 1}",)))
    tpl = side.storage.PersistentVolumeClaim(
        meta=M.ObjectMeta(name="data"),
        spec=side.storage.PersistentVolumeClaimSpec(
            storage_class_name="local", request={"storage": "5Gi"}),
    )
    client.create(WL.StatefulSet(
        meta=M.ObjectMeta(name="db"),
        spec=WL.StatefulSetSpec(replicas=3, template=_template(
            side, {"app": "db"}, "200m"), volume_claim_templates=(tpl,),
            pod_management_policy="Parallel"),
    ))
    boot.converge(rounds=20)
    yield "statefulset"

    client.create(WL.DaemonSet(
        meta=M.ObjectMeta(name="agent"),
        spec=WL.DaemonSetSpec(template=_template(side, {"app": "agent"},
                                                 "50m")),
    ))
    boot.converge()
    yield "daemonset"

    client.create(WL.Job(
        meta=M.ObjectMeta(name="batch"),
        spec=WL.JobSpec(completions=2, parallelism=2,
                        ttl_seconds_after_finished=30,
                        template=_template(side, {"job": "batch"}, "100m")),
    ))
    boot.converge()
    # the hollow runtime's run duration is a pod annotation, which a pod
    # template does not carry: give it to the Job's pods
    for p in sorted(boot.store.pods(), key=lambda p: p.meta.key):
        if p.meta.labels.get("job") == "batch":
            pod = client.get("Pod", p.meta.key)
            pod.meta.annotations["kubemark.io/run-seconds"] = "20"
            client.update(pod, check_version=False)
    boot.converge()
    yield "job"
    advance(boot, 30)
    yield "job done"
    advance(boot, 40)
    yield "job ttl"

    client.create(WL.CronJob(
        meta=M.ObjectMeta(name="tick"),
        spec=WL.CronJobSpec(schedule="*/5 * * * *", job_template=WL.JobSpec(
            template=_template(side, {"job": "tick"}, "100m"))),
    ))
    boot.converge()
    advance(boot, 310)
    yield "cronjob"

    client.create(WL.HorizontalPodAutoscaler(
        meta=M.ObjectMeta(name="web"),
        spec=WL.HPASpec(scale_target_name="web", min_replicas=2,
                        max_replicas=9, target_cpu_utilization_percent=50),
    ))
    for p in sorted(boot.store.pods(), key=lambda p: p.meta.key):
        if p.meta.labels.get("app") == "web":
            client.create(WL.PodMetrics(
                meta=M.ObjectMeta(name=p.meta.name),
                cpu_usage_milli=int(rng.integers(600, 900))))
    boot.converge(rounds=20)
    yield "hpa"

    client.create(WL.Namespace(meta=M.ObjectMeta(name="team-a",
                                                  namespace="")))
    client.create(WL.Deployment(
        meta=M.ObjectMeta(name="svc", namespace="team-a"),
        spec=WL.DeploymentSpec(replicas=2, template=_template(
            side, {"app": "team"}, "100m")),
    ))
    boot.converge()
    ns = client.get("Namespace", "team-a")
    ns.meta.deletion_timestamp = boot.clock.now()
    client.update(ns, check_version=False)
    boot.converge(rounds=20)
    yield "namespace"

    web = sorted(p.spec.node_name for p in boot.store.pods()
                 if p.meta.labels.get("app") == "web" and p.spec.node_name)
    victim = web[0]
    dead = next(k for k in boot.kubelets if k.node_name == victim)
    boot.kubelets.remove(dead)
    advance(boot, 60)
    node = boot.store.get("Node", victim)
    assert any(t.key == side.unreachable for t in node.spec.taints), side.name
    assert not [p for p in boot.store.pods() if p.spec.node_name == victim
                and p.meta.labels.get("app") == "web"], side.name
    yield "node lost"


def test_cluster_story_is_equal_on_both_packages():
    boots = {}
    try:
        for name, side in SIDES.items():
            # the store stamps objects on the same virtual clock (a
            # CronJob's first tick counts from its creation)
            clock = side.FakeClock(start=T0)
            boots[name] = side.boot(nodes=NODES, clock=clock,
                                    store=side.Store(clock=clock.now))
            boots[name].init()
            # events reach the store at the step's end only: a flush on the
            # wall clock's cadence would cut the recorder's aggregation at
            # a point that follows the host's load
            boots[name].scheduler.event_recorder.FLUSH_INTERVAL_S = float("inf")
        js, ts = SIDES["jax"], SIDES["port"]
        assert_equal("init", state(js, boots["jax"]), state(ts, boots["port"]))
        # generated names carry each package's uid counter
        jmeta._uid_counter = itertools.count(1)
        tmeta._uid_counter = itertools.count(1)
        steps = []
        for jstep, tstep in zip(story(js, boots["jax"], SEED),
                                story(ts, boots["port"], SEED),
                                strict=True):
            assert jstep == tstep
            assert_equal(jstep, state(js, boots["jax"]),
                         state(ts, boots["port"]))
            steps.append(jstep)
        assert len(steps) == 13
        # the story did what it says, on the port
        store = boots["port"].store
        pods = store.pods()
        web = [p for p in pods if p.meta.labels.get("app") == "web"]
        assert len(web) > 6 and all(p.spec.node_name for p in web)
        hpa = store.get("HorizontalPodAutoscaler", "default/web")
        assert hpa.status.desired_replicas > 6
        assert store.try_get("Job", "default/batch") is None
        assert store.try_get("Namespace", "team-a") is None
        assert any(j.meta.name.startswith("tick-")
                   for j in store.list("Job")[0])
        pvc = store.get("PersistentVolumeClaim", "default/data-db-0")
        assert pvc.spec.volume_name
        rules = boots["port"].proxiers[0].dataplane.rules()
        (rule,) = [r for (vip, _, _), r in rules.items() if vip == "10.0.0.80"]
        ips = {p.status.pod_ip for p in web if p.status.phase == "Running"}
        assert {b.address for b in rule.backends} == ips
    finally:
        for b in boots.values():
            b.shutdown()
