"""The loop's host units in the port against the reference's copies.

Each case runs one sequence of operations on both packages — the
reference's module and the port's copy of it — and compares what every
step returned or raised (exception types by name, objects by the fields the
loop reads; exact equality):

- the store: CRUD with resource versions, optimistic concurrency, the
  binding subresource and the batched wave bind, the status patch, watch
  replay from a revision, the atomic relist + watch, the revision probes;
- the informers: list + watch, handler streams, and a watch partition
  (injected watch.deliver drops) detected and repaired;
- the keyed heap and the scheduling queue: pop order, in-flight event
  replay through queueing hints, gated pods, backoff on an injected clock,
  pop_specific, activate, the unschedulable leftover flush, and the
  nominator the queue holds;
- the bounded retry's full-jitter backoff on an injected sleep, the fault
  registry's seeded schedules, the wave-size controller, the circuit
  breaker's state machine on an injected clock, the event recorder's
  aggregation and the API dispatcher's relevance merges.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

import pytest

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.client.informer as jinformer
import kubernetes_tpu.scheduler.api_dispatcher as jdispatch
import kubernetes_tpu.scheduler.events as jevents
import kubernetes_tpu.scheduler.framework.batch as jbatch
import kubernetes_tpu.scheduler.framework.events as jfwev
import kubernetes_tpu.scheduler.queue.heap as jheap
import kubernetes_tpu.scheduler.queue.scheduling_queue as jqueue
import kubernetes_tpu.scheduler.tpu.circuitbreaker as jbreaker
import kubernetes_tpu.scheduler.tpu.wavecontroller as jwave
import kubernetes_tpu.store.store as jstore
import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.backoff as jbackoff
import kubernetes_tpu.utils.clock as jclock
import kubernetes_tpu.utils.faultinject as jfi
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.client.informer as tinformer
import kubernetes_tpu_torch.scheduler.api_dispatcher as tdispatch
import kubernetes_tpu_torch.scheduler.events as tevents
import kubernetes_tpu_torch.scheduler.framework.batch as tbatch
import kubernetes_tpu_torch.scheduler.framework.events as tfwev
import kubernetes_tpu_torch.scheduler.queue.heap as theap
import kubernetes_tpu_torch.scheduler.queue.scheduling_queue as tqueue
import kubernetes_tpu_torch.scheduler.tpu.circuitbreaker as tbreaker
import kubernetes_tpu_torch.scheduler.tpu.wavecontroller as twave
import kubernetes_tpu_torch.store.store as tstore
import kubernetes_tpu_torch.testing.wrappers as tw
import kubernetes_tpu_torch.utils.backoff as tbackoff
import kubernetes_tpu_torch.utils.clock as tclock
import kubernetes_tpu_torch.utils.faultinject as tfi
from kubernetes_tpu.api.resource import ResourceNames as JNames
from kubernetes_tpu.scheduler.framework.interface import Status as JStatus
from kubernetes_tpu.scheduler.nodeinfo import PodInfo as JPodInfo
from kubernetes_tpu_torch.api.resource import ResourceNames as TNames
from kubernetes_tpu_torch.scheduler.framework.interface import Status as TStatus
from kubernetes_tpu_torch.scheduler.nodeinfo import PodInfo as TPodInfo
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)

J = SimpleNamespace(types=jtypes, store=jstore, informer=jinformer, heap=jheap,
                    queue=jqueue, breaker=jbreaker, wave=jwave, backoff=jbackoff,
                    clock=jclock, fi=jfi, w=jw, ev=jfwev, events=jevents,
                    dispatch=jdispatch, batch=jbatch, Names=JNames,
                    PodInfo=JPodInfo, Status=JStatus)
T = SimpleNamespace(types=ttypes, store=tstore, informer=tinformer, heap=theap,
                    queue=tqueue, breaker=tbreaker, wave=twave, backoff=tbackoff,
                    clock=tclock, fi=tfi, w=tw, ev=tfwev, events=tevents,
                    dispatch=tdispatch, batch=tbatch, Names=TNames,
                    PodInfo=TPodInfo, Status=TStatus)


@pytest.fixture(autouse=True)
def _registries():
    """Both packages' fault registries disarmed and empty around each case."""
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)
    yield
    for fi in (jfi, tfi):
        fi.registry().reset(seed=0)


def _try(trace, fn, *a, **k):
    """Append fn's result, or the name of what it raised."""
    try:
        out = fn(*a, **k)
    except Exception as e:  # noqa: BLE001 — the type is what is compared
        trace.append(("raised", type(e).__name__))
        return None
    trace.append(out)
    return out


def _pod_view(p):
    if p is None:
        return None
    return (p.meta.key, p.meta.resource_version, p.spec.node_name,
            p.status.nominated_node_name,
            [(c.type, c.status, c.reason, c.message) for c in p.status.conditions])


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------


def _store_seq(P):
    tr = []
    clock = iter(range(1000, 2000))
    s = P.store.Store(clock=lambda: float(next(clock)))
    for i in range(3):
        tr.append(_pod_view(s.create(P.w.make_pod(f"p{i}", cpu="1"))))
    s.create(P.w.make_node("n0"))
    _try(tr, s.create, P.w.make_pod("p0"))
    cur = s.get("Pod", "default/p1")
    stale = s.get("Pod", "default/p1")
    cur.meta.labels["x"] = "1"
    tr.append(_pod_view(s.update(cur)))
    stale.meta.labels["x"] = "2"
    _try(tr, s.update, stale)
    tr.append(_pod_view(s.update(stale, check_version=False)))
    _try(tr, s.update, P.w.make_pod("missing"))
    tr.append(_pod_view(s.bind_pod("default/p0", "n0")))
    _try(tr, s.bind_pod, "default/p0", "n0")
    _try(tr, s.bind_pod, "default/nope", "n0")
    cond = P.types.PodCondition("PodScheduled", "False", "Unschedulable", "0/1 nodes")
    tr.append(_pod_view(s.patch_pod_status("default/p1", condition=cond)))
    tr.append(_pod_view(s.patch_pod_status("default/p0", condition=cond)))
    tr.append(_pod_view(s.patch_pod_status("default/p2", nominated_node="n0")))
    tr.append(s.bind_pods([("default/p1", "n0"), ("default/p0", "n0"),
                           ("default/gone", "n0"), ("default/p2", "n0")]))
    tr.append(_pod_view(s.get("Pod", "default/p1")))
    tr.append(_pod_view(s.delete("Pod", "default/p2")))
    _try(tr, s.delete, "Pod", "default/p2")
    tr.append((s.contains("Pod", "default/p0"), s.contains("Pod", "default/p2"),
               s.try_get("Pod", "default/p2")))
    objs, rev = s.list("Pod")
    tr.append(([_pod_view(o) for o in objs], rev, s.revision))
    w = s.watch("Pod", from_revision=4)
    tr.append([(e.type, e.obj.meta.key, e.revision, e.seq) for e in w.drain()])
    tr.append(w.start_seq)
    refs, w2, rev2 = s.sync_watch("Pod")
    tr.append((sorted(o.meta.key for o in refs), rev2, w2.start_seq))
    s.create(P.w.make_pod("p9"))
    tr.append([(e.type, e.obj.meta.key, e.revision, e.seq) for e in w2.drain()])
    tr.append((s.latest_revision("Pod"), s.latest_revision("Node"),
               s.latest_revision("PodGroup")))
    hit = s.first_event_after("Pod", 5)
    tr.append(hit[0] if hit else None)
    tr.append(s.first_event_after("Pod", 10 ** 6))
    w.stop()
    s.create(P.w.make_pod("p10"))
    tr.append((w.stopped, w.drain()))
    tr.append([(o.meta.key, o.meta.uid != "", o.meta.creation_timestamp)
               for o in s.list("Pod")[0]])
    return tr


def test_store_sequence_matches_reference():
    got, want = _store_seq(T), _store_seq(J)
    # uids come from each package's own counter: compared as set/unset
    assert got == want


def test_store_compaction_raises_compacted():
    """A watch from a revision older than the retained log raises
    CompactedError in both; the informer relists past it."""
    out = []
    for P in (J, T):
        s = P.store.Store()
        s._log_cap = 8
        for i in range(20):
            s.create(P.w.make_pod(f"p{i}"))
        tr = []
        _try(tr, s.watch, "Pod", 1)
        w = s.watch("Pod", s.revision - 2)
        tr.append([e.obj.meta.key for e in w.drain()])
        inf = P.informer.SharedInformer(s, "Pod")
        inf.start()
        tr.append(sorted(inf.keys()))
        out.append(tr)
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# the informers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("drops", [0, 1, 3])
def test_informer_stream_and_partition_repair_match_reference(drops):
    out = []
    for P in (J, T):
        reg = P.fi.registry()
        reg.reset(seed=7)
        s = P.store.Store()
        s.create(P.w.make_node("n0"))
        s.create(P.w.make_pod("p0"))
        f = P.informer.InformerFactory(s)
        seen = []
        partitions = []
        f.set_partition_observer(lambda kind, n, lat: partitions.append((kind, n)))
        for kind in ("Pod", "Node"):
            f.informer(kind).add_handler(
                lambda et, old, new, kind=kind: seen.append(
                    (kind, et, new.meta.key, old.meta.resource_version if old else None,
                     new.meta.resource_version)))
        f.start_all()
        tr = [f.wait_for_cache_sync(), list(seen)]
        if drops:
            reg.register(P.fi.FaultSpec("watch.deliver", mode=P.fi.DROP, times=drops))
            reg.arm()
        for i in range(1, 5):
            s.create(P.w.make_pod(f"p{i}"))
        s.bind_pod("default/p1", "n0")
        s.delete("Pod", "default/p2")
        node = s.get("Node", "n0")
        node.meta.labels["x"] = "y"
        s.update(node)
        reg.disarm()
        tr.append(f.pump_all())
        tr.append(f.detect_and_repair_all())
        tr.append(f.detect_and_repair_all())
        tr.append(sorted(f.informer("Pod").keys()))
        tr.append(partitions)
        tr.append(seen)
        tr.append(f.informer("Pod").partitions_detected)
        # a late handler replays the cache as ADDs
        late = []
        f.informer("Pod").add_handler(lambda et, old, new: late.append((et, new.meta.key)))
        tr.append(sorted(late))
        tr.append(f.resync_all())
        f.stop_all()
        out.append(tr)
    assert out[1] == out[0]
    if drops:
        assert out[1][-5], "the partition must be detected"


# --------------------------------------------------------------------------
# the keyed heap and the scheduling queue
# --------------------------------------------------------------------------


def test_keyed_heap_sequence_matches_reference():
    rng = random.Random(3)
    ops = [(rng.choice("aapd"), str(rng.randrange(40)), rng.random()) for _ in range(600)]
    out = []
    for P in (J, T):
        h = P.heap.KeyedHeap(lambda x: x[0], lambda a, b: a[1] < b[1])
        tr = []
        for op, key, val in ops:
            if op == "a":
                h.add((key, val))
            elif op == "p":
                tr.append(h.pop())
            else:
                tr.append(h.delete(key))
            tr.append((len(h), h.peek(), key in h, h.get(key)))
        out.append(tr)
    assert out[0] == out[1]


def _priority_less(a, b):
    pa, pb = a.pod.spec.priority, b.pod.spec.priority
    if pa != pb:
        return pa > pb
    return a.timestamp < b.timestamp


class _Gate:
    """A PreEnqueue plugin that gates pods whose name starts with "g"."""

    name = "Gate"

    def __init__(self, P):
        self.P = P
        self.open = False

    def pre_enqueue(self, pod):
        if pod.meta.name.startswith("g") and not self.open:
            return self.P.Status.unschedulable("gated", plugin=self.name)
        return None


def _queue_seq(P, pop_from_backoff):
    tr = []
    clock = P.clock.FakeClock()
    ev = P.ev
    gate = _Gate(P)
    hints = {
        "NodeResourcesFit": [ev.ClusterEventWithHint(ev.ClusterEvent(ev.NODE, ev.ADD))],
        "Gate": [ev.ClusterEventWithHint(ev.ClusterEvent(ev.NODE, ev.UPDATE_NODE_LABEL))],
        "TaintToleration": [ev.ClusterEventWithHint(
            ev.ClusterEvent(ev.NODE, ev.UPDATE_NODE_TAINT),
            lambda pod, old, new: ev.QUEUE if pod.spec.priority > 5 else ev.QUEUE_SKIP)],
    }
    q = P.queue.SchedulingQueue(_priority_less, clock=clock, pre_enqueue_plugins=[gate],
                                queueing_hint_map=hints, pop_from_backoff=pop_from_backoff)
    names = P.Names()

    def add(name, prio):
        pod = P.w.make_pod(name, cpu="1", priority=prio)
        q.add(pod, P.PodInfo(pod, names))
        return pod

    pods = {n: add(n, pr) for n, pr in
            [("a", 1), ("b", 9), ("c", 5), ("g1", 3), ("d", 7), ("e", 0)]}
    tr.append(q.pending_pods())

    def pop():
        qpi = q.pop(timeout=0.0)
        if qpi is None:
            tr.append(None)
            return None
        tr.append((qpi.key, qpi.attempts, qpi.unschedulable_count,
                   qpi.consecutive_errors_count, qpi.timestamp))
        return qpi

    b = pop()
    d = pop()
    c = pop()
    # an event while b, d, c are in flight: replayed when they come back
    clock.step(0.3)
    q.move_all_to_active_or_backoff(ev.ClusterEvent(ev.NODE, ev.ADD), None, None)
    b.unschedulable_plugins.add("NodeResourcesFit")
    q.add_unschedulable_if_not_present(b, q.moved_count)
    d.unschedulable_plugins.add("TaintToleration")
    q.add_unschedulable_if_not_present(d, q.moved_count)
    q.add_unschedulable_if_not_present(c, q.moved_count)  # no plugin: an error
    tr.append((q.pending_pods(), q.moved_count))
    q.move_all_to_active_or_backoff(ev.ClusterEvent(ev.NODE, ev.UPDATE_NODE_TAINT), None, None)
    tr.append(q.pending_pods())
    for _ in range(4):
        pop()
    clock.step(1.05)
    for _ in range(3):
        pop()
    gate.open = True
    q.move_all_to_active_or_backoff(ev.ClusterEvent(ev.NODE, ev.UPDATE_NODE_LABEL), None, None)
    tr.append(q.pending_pods())
    g = pop()
    if g is not None:
        q.done(g.key, g.inflight_token)
    # pop_specific, activate and delete
    f = add("f", 2)
    h = add("h", 2)
    sp = q.pop_specific("default/h")
    tr.append(sp.key if sp else None)
    tr.append(q.pop_specific("default/none"))
    q.delete(f)
    tr.append((q.has_pod("default/f"), q.has_pod("default/a"), q.pending_pods()))
    q.activate([pods["a"], h])
    tr.append(q.pending_pods())
    for _ in range(3):
        pop()
    clock.step(400.0)
    q.flush_unschedulable_leftover()
    tr.append(q.pending_pods())
    for _ in range(4):
        pop()
    # the nominator the queue holds
    q.add_nominated_pod(pods["e"], "n1")
    q.add_nominated_pod(pods["b"], "n1")
    q.add_nominated_pod(pods["c"], "n2")
    tr.append((sorted(q.nominated_pods_for_node("n1")), q.nominated_node_for(pods["c"]),
               q.max_nominated_priority(), q.max_nominated_priority("default/b"),
               q.has_nominated_pods(), q.nominated_pod_info("default/e").pod.meta.key))
    q.delete_nominated_pod_if_exists(pods["b"])
    q.delete(pods["c"])
    tr.append((sorted(q.nominated_pods_for_node("n1")), q.nominated_node_for(pods["c"]),
               q.max_nominated_priority(), q.nominated_pod_info("default/c")))
    q.close()
    tr.append(q.pop(timeout=0.0))
    return tr


@pytest.mark.parametrize("pop_from_backoff", [True, False])
def test_scheduling_queue_sequence_matches_reference(pop_from_backoff):
    assert _queue_seq(T, pop_from_backoff) == _queue_seq(J, pop_from_backoff)


def test_port_queue_holds_the_one_nominator():
    """The port's queue answers the nominator calls through the Nominator
    it holds (the reference's queue is its own nominator)."""
    from kubernetes_tpu_torch.scheduler.queue import Nominator

    q = tqueue.SchedulingQueue(_priority_less)
    assert isinstance(q.nominator, Nominator)
    pod = tw.make_pod("x", cpu="1")
    q.add_nominated_pod(pod, "n0")
    assert q.nominator.nominated_node_for(pod) == "n0"
    q.delete(pod)
    assert not q.nominator.has_nominated_pods()


# --------------------------------------------------------------------------
# retry backoff, fault schedules, wave sizing, the breaker
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_backoff_on_an_injected_sleep_matches_reference(fails):
    out = []
    for P in (J, T):
        slept, backoffs = [], []
        calls = {"n": 0}

        def fn(P=P):
            calls["n"] += 1
            if calls["n"] <= fails:
                raise P.fi.TransientFault("flake")
            return calls["n"]

        tr = []
        pol = P.backoff.RetryPolicy(max_attempts=4, base_s=0.01, cap_s=0.05,
                                    retryable=(KeyError,))
        _try(tr, P.backoff.retry_call, fn, pol, random.Random(9), sleep=slept.append,
             on_backoff=lambda a, d: backoffs.append((a, d)))
        tr += [slept, backoffs, calls["n"], pol.is_retryable(KeyError()),
               pol.is_retryable(ValueError())]
        out.append(tr)
    assert out[0] == out[1]


def test_fault_registry_schedules_match_reference():
    out = []
    for P in (J, T):
        reg = P.fi.FaultRegistry(seed=42)
        reg.register(P.fi.FaultSpec("tpu.collect", probability=0.5, times=4))
        reg.register(P.fi.FaultSpec("store.create", mode=P.fi.DROP, start_after=2, times=2))
        reg.register(P.fi.FaultSpec("watch.partition", mode=P.fi.PARTITION, window=3,
                                    probability=0.3, times=2))
        reg.register(P.fi.FaultSpec("tpu.launch", transient=False, times=1))
        tr = [reg.fire("tpu.collect")]
        reg.arm()
        for i in range(30):
            for point in ("tpu.collect", "store.create", "watch.partition", "tpu.launch"):
                _try(tr, reg.fire, point)
        _try(tr, reg.register, P.fi.FaultSpec("no.such.point"))
        tr.append(reg.snapshot())
        out.append(tr)
    assert out[0] == out[1]
    # the port declares the points it fires, each one the reference's
    assert set(tfi.FAULT_POINTS) <= set(jfi.FAULT_POINTS)
    for point in ("store.create", "store.update", "store.delete", "store.bind_pod",
                  "store.patch_pod_status", "dispatcher.execute", "tpu.launch",
                  "tpu.collect", "watch.deliver", "watch.partition", "loop.wave",
                  "loop.bind_commit", "gang.permit"):
        assert point in tfi.FAULT_POINTS


@pytest.mark.parametrize("bounds", [None, (5, 256)])
def test_wave_size_controller_matches_reference(bounds, monkeypatch):
    """The port's controller (no knobs, no latency guard) sizes every wave
    as the reference's does with its knobs unset and its guard off."""
    for name in ("KUBE_TPU_WAVE_MIN_PODS", "KUBE_TPU_WAVE_MAX_PODS", "KUBE_TPU_WAVE_LATENCY_S"):
        monkeypatch.delenv(name, raising=False)  # the reference reads them
    rng = random.Random(5)
    steps = [(rng.randrange(0, 3000), rng.choice([8, 64, 512])) for _ in range(200)]
    out = []
    for P in (J, T):
        c = P.wave.WaveSizeController() if bounds is None else \
            P.wave.WaveSizeController(min_pods=bounds[0], max_pods=bounds[1])
        out.append([c.next_size(backlog, cap) for backlog, cap in steps])
    assert out[0] == out[1]
    assert len(set(out[1])) > 2


@pytest.mark.parametrize("probes", [1, 2])
def test_breaker_state_machine_on_an_injected_clock_matches_reference(probes, monkeypatch):
    for name in ("KUBE_TPU_BREAKER_THRESHOLD", "KUBE_TPU_BREAKER_COOLDOWN_S",
                 "KUBE_TPU_BREAKER_PROBES"):
        monkeypatch.delenv(name, raising=False)
    rng = random.Random(probes)
    script = [rng.choice(["fail", "fail", "ok", "benign", "allow", "allow", "tick",
                          "blocked", "probing"]) for _ in range(300)]
    out = []
    for P in (J, T):
        now = [0.0]
        seen = []
        b = P.breaker.CircuitBreaker(cooldown_s=1.0, probes=probes, clock=lambda: now[0],
                                     on_transition=lambda *t: seen.append(t))
        tr = [(b.threshold, b.state)]
        for op in script:
            if op == "fail":
                b.record_failure("device flake")
            elif op == "ok":
                b.record_success()
            elif op == "benign":
                b.record_benign()
            elif op == "allow":
                tr.append(b.allow_device_wave())
            elif op == "tick":
                now[0] += 0.4
            elif op == "blocked":
                tr.append(b.device_blocked())
            else:
                tr.append(b.probing())
            tr.append((b.state, b.consecutive_failures))
        tr += [seen, b.snapshot(), b.transitions]
        out.append(tr)
    assert out[0] == out[1]
    assert any(t[1] == "open" for t in out[1][-3])


# --------------------------------------------------------------------------
# the event recorder, the API dispatcher, the batch cache
# --------------------------------------------------------------------------


def test_event_recorder_aggregation_matches_reference():
    out = []
    for P in (J, T):
        s = P.store.Store()
        rec = P.events.EventRecorder(s, max_buffer=64)
        pods = [P.w.make_pod(f"p{i}") for i in range(30)]
        for i, p in enumerate(pods):
            rec.event(p, "Normal", "Scheduled", f"bound to n{i % 3}", correlation="wave/1")
        for p in pods[:5]:
            rec.event(p, "Warning", "FailedScheduling", "0/3 nodes are available")
            rec.event(p, "Warning", "FailedScheduling", "0/3 nodes are available")
        n = rec.flush()
        rec.event(pods[0], "Warning", "FailedScheduling", "0/3 nodes are available")
        n2 = rec.flush()
        evs = sorted((e.meta.name, e.involved_object, e.type, e.reason, e.message, e.count)
                     for e in s.list("Event")[0])
        out.append((n, n2, evs))
    assert out[0] == out[1]


def test_api_dispatcher_relevance_merges_match_reference():
    out = []
    for P in (J, T):
        d = P.dispatch.APIDispatcher(parallelism=1)
        log, tr = [], []

        def call(kind, key, tag):
            return P.dispatch.APICall(kind, key, lambda: log.append(tag),
                                      on_finish=lambda err, tag=tag: log.append(
                                          (tag, type(err).__name__ if err else None)))

        d.add(call(P.dispatch.POD_STATUS_PATCH, "a", "patch-a1"))
        d.add(call(P.dispatch.POD_STATUS_PATCH, "a", "patch-a2"))
        d.add(call(P.dispatch.POD_BINDING, "b", "bind-b"))
        _try(tr, lambda: d.add(call(P.dispatch.POD_STATUS_PATCH, "b", "patch-b")).object_key)
        d.add(call(P.dispatch.POD_STATUS_PATCH, "c", "patch-c"))
        d.supersede(["c"], P.dispatch.RELEVANCES[P.dispatch.POD_BINDING])
        d.add(call(P.dispatch.POD_BINDING, "e", "bind-e"))
        d.add(call(P.dispatch.POD_DELETE, "e", "delete-e"))
        d.drain(timeout=2.0)
        d.close()
        late = d.add(call(P.dispatch.POD_BINDING, "f", "bind-f"))
        tr += [log, type(late.error).__name__]
        out.append(tr)
    assert out[0] == out[1]


def test_batch_cache_hints_match_reference():
    out = []
    for P in (J, T):
        c = P.batch.BatchCache()
        tr = [c.has_fresh("s1"), c.get_node_hint("s1", lambda n: True)]
        c.store_schedule_results("s1", ["n2", "n0", "n1"])
        full = {"n2"}
        tr += [c.has_fresh("s1"), c.get_node_hint("s1", lambda n: n not in full)]
        full.add("n0")
        tr.append(c.get_node_hint("s1", lambda n: n not in full))
        full.add("n1")
        tr += [c.get_node_hint("s1", lambda n: n not in full), "s1" in c.entries]
        c.store_schedule_results("s2", ["n0"])
        c.flush()
        tr.append(c.entries)
        c.max_age = -1.0
        c.store_schedule_results("s3", ["n0"])
        tr += [c.has_fresh("s3"), "s3" in c.entries]
        out.append(tr)
    assert out[0] == out[1]
