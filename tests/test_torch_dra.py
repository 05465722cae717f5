"""The port's DynamicResources, its CEL subset and the DRA API against the
reference's.

Both packages run on the same inputs (the reference with
Profile(backend="tpu"), the port with device="cpu") and the results are
held equal, tolerance 0 (names, statuses, integers, booleans):

- utils/cel.py: every expression of tests/test_dra_cel.py, and a table of
  expressions over numpy-seeded devices, evaluate alike; the same
  expressions fail to compile; the compile cache;
- DynamicResources per pod on numpy-seeded DRA clusters (slices per node,
  device classes, typed and CEL selectors, prioritized lists, partitionable
  counters, claims allocated and pending, shared and missing claims):
  PreEnqueue, PreFilter, every node's Filter, Reserve, PostFilter's
  deallocation and `sign`; _ClaimState.clone (tests/test_dra.py's
  TestClaimStateClone);
- tests/test_dra.py and tests/test_dra_cel.py through both Schedulers: every
  pod's node, every claim's allocation and reservations, the
  kernel/fallback counts and the rng state, with each reference test's own
  assertions on the port's run.

Both packages' clocks are one virtual clock (tests/test_torch_volumes.py).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.testing.wrappers as jw
import kubernetes_tpu.utils.cel as jcel
import tests.test_dra as jdra_tests
import kubernetes_tpu_torch.utils.cel as tcel
from tests.test_torch_pipeline import _own_process_state  # noqa: F401 (autouse, C12)
from tests.test_torch_volumes import SIDES, _st, both, clock, run_both, scheduler  # noqa: F401


# the reference keeps its DRA fixtures in tests/test_dra.py, the port in
# its testing/wrappers.py
_JW = SimpleNamespace(**{k: v for k, v in vars(jw).items() if not k.startswith("__")},
                      make_slice=jdra_tests.make_slice, make_claim=jdra_tests.make_claim,
                      claim_pod=jdra_tests.claim_pod)


def _w(side):
    return _JW if side.name == "jax" else side.w


def node_of(store, pod_name):
    return store.get("Pod", f"default/{pod_name}").spec.node_name


# --------------------------------------------------------------------------
# the CEL subset
# --------------------------------------------------------------------------

CEL_CASES = [
    ('device.attributes["model"] == "a100"', {"attributes": {"model": "a100"}}),
    ('device.attributes["model"] == "a100"', {"attributes": {"model": "h100"}}),
    ('device.driver == "gpu.example.com"', {"driver": "gpu.example.com"}),
    ('device.name != "dev-0"', {"name": "dev-1"}),
    ('device.capacity["memory"] >= quantity("40Gi")', {"capacity": {"memory": 80 * 1024 ** 3}}),
    ('device.capacity["memory"] >= quantity("40Gi")', {"capacity": {"memory": 16 * 1024 ** 3}}),
    ('device.attributes["index"] in [0, 2, 4] && !(device.name == "dev-2")',
     {"name": "dev-0", "attributes": {"index": 0}}),
    ('device.attributes["index"] in [0, 2, 4] && !(device.name == "dev-2")',
     {"name": "dev-2", "attributes": {"index": 2}}),
    ('device.attributes["index"] in [0, 2, 4] && !(device.name == "dev-2")',
     {"name": "dev-1", "attributes": {"index": 1}}),
    ('device.attributes["index"] > 5 || device.driver == "x"', {"attributes": {"index": "7"}}),
    ('device.attributes["index"] > 5 || device.driver == "x"',
     {"driver": "x", "attributes": {"index": "1"}}),
    ('device.attributes["gone"] == "x"', {"attributes": {}}),
    ('device.attributes["gone"] > 3', {"attributes": {}}),
    ("device.unknown_field == 1", {"driver": "d"}),
    ("attributes == 1", {"driver": "d"}),
]
BAD_CEL = ["1 +", 'device.attributes["a" == 1', "&& device.name", "(", 'device.name ==']


def _seeded_cel_cases(seed: int, n: int):
    """Expressions over the attribute, capacity, driver and name of
    numpy-seeded devices."""
    rng = np.random.default_rng(seed)
    exprs = ['device.attributes["index"] < {k}', 'device.attributes["model"] == "m{k}"',
             'device.capacity["memory"] > quantity("{k}Gi")',
             'device.attributes["index"] >= {k} && device.driver == "d{j}"',
             'device.name in ["dev-{k}", "dev-{j}"] || device.attributes["model"] != "m{j}"',
             '!(device.attributes["index"] == {k})']
    out = []
    for _ in range(n):
        k, j = int(rng.integers(0, 8)), int(rng.integers(0, 3))
        dev = {"driver": f"d{int(rng.integers(0, 3))}", "name": f"dev-{int(rng.integers(0, 8))}",
               "attributes": {"index": int(rng.integers(0, 8)),
                              "model": f"m{int(rng.integers(0, 3))}"},
               "capacity": {"memory": int(rng.integers(1, 9)) * 1024 ** 3}}
        out.append((exprs[int(rng.integers(0, len(exprs)))].format(k=k, j=j), dev))
    return out


def test_cel_evaluates_as_the_reference():
    cases = CEL_CASES + _seeded_cel_cases(71, 300)
    want = [jcel.evaluate_device(e, **kw) for e, kw in cases]
    got = [tcel.evaluate_device(e, **kw) for e, kw in cases]
    assert got == want
    assert True in got and False in got
    # tests/test_dra_cel.py's expectations
    assert got[:len(CEL_CASES)] == [True, False, True, True, True, False, True, False, False,
                                    True, True, False, False, False, False]


def test_cel_compile_errors_and_cache_match_reference():
    for bad in BAD_CEL:
        with pytest.raises(jcel.CELError):
            jcel.compile_expression(bad)
        with pytest.raises(tcel.CELError):
            tcel.compile_expression(bad)
    f1 = tcel.compile_expression('device.driver == "d"')
    assert f1 is tcel.compile_expression('device.driver == "d"')


# --------------------------------------------------------------------------
# DynamicResources on seeded clusters
# --------------------------------------------------------------------------


def dra_spec(seed: int, n_nodes: int, n_pods: int) -> dict:
    """A DRA cluster as plain data from numpy's seeded generator."""
    rng = np.random.default_rng(seed)
    nodes = [{"name": f"n{i}", "devices": int(rng.integers(0, 5)),
              "speed": ["slow", "fast"][int(rng.integers(0, 2))]} for i in range(n_nodes)]
    requests = []
    for i in range(n_pods):
        kind = int(rng.integers(0, 6))
        requests.append({"kind": kind, "count": int(rng.integers(1, 3)),
                         "k": int(rng.integers(0, 4)), "shared": rng.random() < 0.15})
    return {"nodes": nodes, "pods": requests, "preallocated": int(rng.integers(0, n_nodes))}


def build_dra(side, spec, store):
    """The spec's nodes, slices (one partitionable), a DeviceClass, claims
    of every request kind and their pods; one claim allocated already.
    Returns (nodes, pods)."""
    w, dra, meta = _w(side), side.dra, side.meta
    nodes = []
    for n in spec["nodes"]:
        node = w.make_node(n["name"], cpu="8", mem="16Gi")
        nodes.append(node)
        store.create(node)
        if n["devices"]:
            store.create(w.make_slice(n["name"], n_devices=n["devices"], speed=n["speed"]))
    store.create(dra.ResourceSlice(
        meta=meta.ObjectMeta(name="mig-n0", namespace=""), node_name="n0",
        driver="gpu.example.com", pool="card0", shared_counters={"mem": {"GiB": 40}},
        devices=(dra.Device(name="half-a", consumes_counters={"mem": {"GiB": 20}}),
                 dra.Device(name="half-b", consumes_counters={"mem": {"GiB": 20}}),
                 dra.Device(name="whole", consumes_counters={"mem": {"GiB": 40}}))))
    store.create(dra.DeviceClass(meta=meta.ObjectMeta(name="fast-tpu", namespace=""),
                                 driver="tpu.example.com",
                                 selectors=(dra.DeviceSelector("speed", "In", ("fast",)),)))
    pods = []
    shared = None
    for i, r in enumerate(spec["pods"]):
        name = f"c{i}"
        kind, k = r["kind"], r["k"]
        if kind == 0:
            req = dra.DeviceRequest(name="gpu", count=r["count"])
        elif kind == 1:
            req = dra.DeviceRequest(name="d", device_class_name="fast-tpu")
        elif kind == 2:
            req = dra.DeviceRequest(name="d", count=r["count"], selectors=(
                dra.DeviceSelector("index", "Gt", (str(k),)),))
        elif kind == 3:
            req = dra.DeviceRequest(name="d", selectors=(
                dra.DeviceSelector(cel=f'device.attributes["index"] >= {k}'),))
        elif kind == 4:
            req = dra.DeviceRequest(name="accel", first_available=(
                dra.DeviceSubRequest(name="big", count=2, selectors=(
                    dra.DeviceSelector(key="speed", operator="In", values=("fast",)),)),
                dra.DeviceSubRequest(name="small", count=1)))
        else:
            req = dra.DeviceRequest(name="gpu", selectors=(
                dra.DeviceSelector(key="nonexistent", operator="DoesNotExist"),))
        if r["shared"] and shared is not None:
            name = shared
        else:
            store.create(w.make_claim(name, requests=(req,)))
            shared = shared or name
        pod = w.claim_pod(w.make_pod(f"p{i}", cpu="100m"), name)
        if i % 11 == 5:
            pod = w.claim_pod(pod, name, "missing")
        pods.append(pod)
    pre = store.get("ResourceClaim", "default/c0")
    node = spec["nodes"][spec["preallocated"]]
    if node["devices"]:
        pre.status.allocation = dra.AllocationResult(
            devices=(dra.DeviceAllocationResult("gpu", "tpu.example.com", f"{node['name']}/p0",
                                                "dev-0"),),
            node_name=node["name"])
        store.update(pre, check_version=False)
    return nodes, pods


def dra_trace(side, spec):
    """DynamicResources' answers for each pod in turn; a pod that fits is
    reserved on its first feasible node (so later pods see its devices)."""
    store = side.Store()
    nodes, pods = build_dra(side, spec, store)
    cache = side.Cache(side.Names())
    for n in nodes:
        cache.add_node(n)
    snap = side.Snapshot()
    cache.update_snapshot(snap)
    nis = snap.list_nodes()
    plugin = side.dr.DynamicResources(store)
    out = [sorted((e.event.resource, e.event.action_type, e.event.label)
                  for e in plugin.events_to_register())]
    for pod in pods:
        rec = {"sign": plugin.sign(pod), "pre_enqueue": _st(plugin.pre_enqueue(pod))}
        state = side.CycleState()
        _, st = plugin.pre_filter(state, pod, nis)
        rec["pre_filter"] = _st(st)
        if st is None or st.is_success:
            filt = [plugin.filter(state, pod, ni) for ni in nis]
            rec["filter"] = [_st(f) for f in filt]
            feasible = [ni.name for ni, f in zip(nis, filt) if f is None or f.is_success]
            if feasible:
                rec["reserve"] = _st(plugin.reserve(state, pod, feasible[0]))
                rec["pre_bind"] = _st(plugin.pre_bind(state, pod, feasible[0]))
            else:
                statuses = {ni.name: f for ni, f in zip(nis, filt)}
                r = plugin.post_filter(state, pod, statuses)
                rec["post_filter"] = None if r is None else _st(r[1] if isinstance(r, tuple)
                                                               else r)
        out.append(rec)
    claims = {c.meta.key: (None if c.status.allocation is None else (
        c.status.allocation.node_name,
        [(d.request, d.driver, d.pool, d.device) for d in c.status.allocation.devices]),
        tuple(c.status.reserved_for)) for c in store.list("ResourceClaim")[0]}
    return out, claims


@pytest.mark.parametrize("seed,n_nodes,n_pods", [(81, 6, 30), (82, 10, 40), (83, 3, 24)])
def test_dynamic_resources_matches_reference(seed, n_nodes, n_pods):
    want, got = both(dra_trace, dra_spec(seed, n_nodes, n_pods))
    assert got == want
    recs = got[0][1:]
    assert any("reserve" in r for r in recs) and any("post_filter" in r for r in recs)
    assert any(r["pre_enqueue"][0] != 0 for r in recs)


def test_claim_state_clone_matches_reference():
    """tests/test_dra.py::TestClaimStateClone on the port, and the clone's
    chained sets: what a dry run adds to the clone stays out of the
    original."""
    s = SIDES["port"].dr._ClaimState(needs_allocation=True)
    s.inv_global = [(0, "drv", "pool", object())]
    s.inv_by_node = {"n1": [(1, "drv", "n1/pool", object())]}
    s.requirements = {"default/claim": [("drv", [])]}
    c = s.clone()
    assert c.needs_allocation is True
    assert c.inv_global == s.inv_global
    assert c.inv_by_node == s.inv_by_node
    assert c.requirements == s.requirements
    # what a dry run writes into the clone (taken devices, per-node
    # allocations, the reserved node) stays out of the original, in both
    # packages alike
    for side in SIDES.values():
        base = side.dr._ClaimState(needs_allocation=True)
        base.base_taken = {("d", "p", "x")}
        base.allocations_per_node = {"n1": {"k": None}}
        clone = base.clone()
        clone.base_taken.add(("d", "p", "y"))
        clone.allocations_per_node["n1"]["j"] = None
        clone.allocations_per_node["n2"] = {}
        clone.reserved_node = "n2"
        chain = side.dr._ChainSet(base.base_taken)
        chain.add(("d", "p", "z"))
        assert base.base_taken == {("d", "p", "x")}
        assert base.allocations_per_node == {"n1": {"k": None}}
        assert base.reserved_node == ""
        assert ("d", "p", "z") in chain and ("d", "p", "x") in chain
        assert sorted(chain) == [("d", "p", "x"), ("d", "p", "z")]


# --------------------------------------------------------------------------
# tests/test_dra.py and tests/test_dra_cel.py through both Schedulers
# --------------------------------------------------------------------------


def _store(side, n_nodes=0):
    store = side.Store()
    for i in range(1, n_nodes + 1):
        store.create(_w(side).make_node(f"n{i}"))
    return store


class TestDynamicResources:
    def test_allocates_on_node_with_devices(self):
        def scenario(side, clock):
            w, store = _w(side), _store(side, 2)
            store.create(w.make_slice("n2", n_devices=2))
            store.create(w.make_claim("c1"))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "c1"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        out, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n2"
        claim = store.get("ResourceClaim", "default/c1")
        assert claim.is_allocated and claim.status.allocation.node_name == "n2"
        assert claim.status.reserved_for == ("default/p1",)
        assert out["counts"] == (1, 0)

    def test_pod_gated_until_claim_exists(self):
        def scenario(side, clock):
            w, store = _w(side), _store(side, 1)
            store.create(w.make_slice("n1"))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "missing"))
            s = scheduler(side, store)
            s.schedule_pending()
            assert node_of(store, "p1") == ""
            store.create(w.make_claim("missing"))
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n1"

    @pytest.mark.parametrize("wave_size", [0, 8])
    def test_device_exhaustion(self, wave_size):
        def scenario(side, clock):
            w, store = _w(side), _store(side, 1)
            store.create(w.make_slice("n1", n_devices=4))
            for i in range(3):
                store.create(w.make_claim(f"c{i}", requests=(
                    side.dra.DeviceRequest(name="gpu", count=2),)))
                store.create(w.claim_pod(w.make_pod(f"p{i}", cpu="1"), f"c{i}"))
            s = scheduler(side, store, wave_size=wave_size)
            s.schedule_pending()
            return store, s

        _, store, s = run_both(scenario)
        placed = sorted(i for i in range(3) if node_of(store, f"p{i}"))
        assert len(placed) == 2
        taken = set()
        for i in placed:
            devs = {(d.driver, d.pool, d.device) for d in
                    store.get("ResourceClaim", f"default/c{i}").status.allocation.devices}
            assert len(devs) == 2 and not devs & taken
            taken |= devs
        assert s.loop.phase_profile["waves"] == 0  # claim pods never ride a wave

    def test_selector_and_device_class(self):
        def scenario(side, clock):
            w, dra, store = _w(side), side.dra, _store(side, 2)
            store.create(w.make_slice("n1", speed="slow"))
            store.create(w.make_slice("n2", speed="fast"))
            store.create(dra.DeviceClass(
                meta=side.meta.ObjectMeta(name="fast-tpu", namespace=""),
                driver="tpu.example.com",
                selectors=(dra.DeviceSelector("speed", "In", ("fast",)),)))
            store.create(w.make_claim("c1", requests=(
                dra.DeviceRequest(name="d", device_class_name="fast-tpu"),)))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "c1"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == "n2"

    def test_shared_claim_second_pod_follows_allocation(self):
        def scenario(side, clock):
            w, store = _w(side), _store(side, 2)
            store.create(w.make_slice("n1"))
            store.create(w.make_claim("shared"))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "shared"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            store.create(w.claim_pod(w.make_pod("p2", cpu="1"), "shared"))
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p1") == node_of(store, "p2") == "n1"
        claim = store.get("ResourceClaim", "default/shared")
        assert set(claim.status.reserved_for) == {"default/p1", "default/p2"}

    def test_gt_selector(self):
        def scenario(side, clock):
            w, dra, store = _w(side), side.dra, _store(side, 1)
            store.create(w.make_slice("n1", n_devices=4))
            store.create(w.make_claim("c1", requests=(dra.DeviceRequest(
                name="d", selectors=(dra.DeviceSelector("index", "Gt", ("1",)),), count=2),)))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "c1"))
            s = scheduler(side, store)
            assert s.schedule_pending() == 1
            return store, s

        _, store, _ = run_both(scenario)
        claim = store.get("ResourceClaim", "default/c1")
        assert {d.device for d in claim.status.allocation.devices} == {"dev-2", "dev-3"}


def _first_available(dra, small_count):
    return dra.DeviceRequest(name="accel", first_available=(
        dra.DeviceSubRequest(name="big", count=1, selectors=(
            dra.DeviceSelector(key="kind", operator="In", values=("big",)),)),
        dra.DeviceSubRequest(name="small", count=small_count, selectors=(
            dra.DeviceSelector(key="kind", operator="In", values=("small",)),)),
    ))


class TestPrioritizedList:
    @pytest.mark.parametrize("kind,n_devices,small,want", [
        ("big", 2, 1, ["accel/big"]),
        ("small", 4, 2, ["accel/small", "accel/small"]),
        ("tiny", 1, 1, None),
    ])
    def test_first_available(self, kind, n_devices, small, want):
        """The preferred alternative, the fall-through when it is exhausted,
        and every alternative exhausted (tests/test_dra.py's three)."""
        def scenario(side, clock):
            w, store = _w(side), _store(side, 1)
            store.create(w.make_slice("n1", n_devices=n_devices, kind=kind))
            store.create(w.make_claim("c1", requests=(_first_available(side.dra, small),)))
            store.create(w.claim_pod(w.make_pod("p1", cpu="1"), "c1"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        alloc = store.get("ResourceClaim", "default/c1").status.allocation
        if want is None:
            assert node_of(store, "p1") == "" and alloc is None
        else:
            assert [d.request for d in alloc.devices] == want


class TestPartitionableDevices:
    @staticmethod
    def _mig_slice(side, node):
        dra = side.dra
        return dra.ResourceSlice(
            meta=side.meta.ObjectMeta(name=f"mig-{node}", namespace=""), node_name=node,
            driver="gpu.example.com", pool="card0", shared_counters={"mem": {"GiB": 40}},
            devices=(dra.Device(name="half-a", consumes_counters={"mem": {"GiB": 20}}),
                     dra.Device(name="half-b", consumes_counters={"mem": {"GiB": 20}}),
                     dra.Device(name="whole", consumes_counters={"mem": {"GiB": 40}})))

    def test_partitions_share_the_counter_budget(self):
        def scenario(side, clock):
            w, store = _w(side), _store(side, 1)
            store.create(self._mig_slice(side, "n1"))
            for i in range(3):
                store.create(w.make_claim(f"c{i}"))
                store.create(w.claim_pod(w.make_pod(f"p{i}", cpu="100m"), f"c{i}"))
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        placed = [i for i in range(3) if node_of(store, f"p{i}")]
        assert len(placed) == 2
        assert {d.device for i in placed for d in store.get(
            "ResourceClaim", f"default/c{i}").status.allocation.devices} == {"half-a", "half-b"}

    def test_whole_device_blocks_all_partitions(self):
        def scenario(side, clock):
            w, dra, store = _w(side), side.dra, _store(side, 1)
            store.create(self._mig_slice(side, "n1"))
            store.create(w.make_claim("big", requests=(dra.DeviceRequest(
                name="gpu", selectors=(dra.DeviceSelector(key="nonexistent",
                                                          operator="DoesNotExist"),)),)))
            store.create(w.claim_pod(w.make_pod("pbig", cpu="100m"), "big"))
            s = scheduler(side, store)
            s.schedule_pending()
            store.create(w.make_claim("two", requests=(dra.DeviceRequest(name="gpu", count=2),)))
            store.create(w.claim_pod(w.make_pod("ptwo", cpu="100m"), "two"))
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert store.get("ResourceClaim",
                         "default/big").status.allocation.devices[0].device == "half-a"
        assert node_of(store, "ptwo") == ""


def _cel_cluster(side):
    """tests/test_dra_cel.py's cluster: two nodes of 8 CPU, n0's devices
    a100 with 40Gi, n1's h100 with 80Gi."""
    dra, store = side.dra, side.Store()
    for i in range(2):
        store.create(_w(side).make_node(f"n{i}", cpu="8", mem="16Gi"))
        store.create(dra.ResourceSlice(
            meta=side.meta.ObjectMeta(name=f"slice-n{i}", namespace=""), node_name=f"n{i}",
            driver="gpu.example.com",
            devices=tuple(dra.Device(name=f"dev-{j}",
                                     attributes={"model": "a100" if i == 0 else "h100",
                                                 "index": j},
                                     capacity={"memory": (40 if i == 0 else 80) * 1024 ** 3})
                          for j in range(2))))
    return store


def _cel_claim_pod(side, store, pod_name, claim_name, cel):
    dra = side.dra
    store.create(dra.ResourceClaim(
        meta=side.meta.ObjectMeta(name=claim_name),
        spec=dra.ResourceClaimSpec(requests=(
            dra.DeviceRequest(name="gpu", count=1, selectors=(dra.DeviceSelector(cel=cel),)),))))
    p = _w(side).claim_pod(_w(side).make_pod(pod_name, cpu="1", mem="1Gi"), claim_name)
    store.create(p)
    return p


class TestCELAllocation:
    @pytest.mark.parametrize("cel,want", [
        ('device.attributes["model"] == "h100"', "n1"),
        ('device.capacity["memory"] >= quantity("60Gi")', "n1"),
        ('device.attributes["model"] == "tpu-v9"', ""),
    ])
    def test_cel_selector(self, cel, want):
        def scenario(side, clock):
            store = _cel_cluster(side)
            _cel_claim_pod(side, store, "p", "c1", cel)
            s = scheduler(side, store)
            s.schedule_pending()
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "p") == want
        alloc = store.get("ResourceClaim", "default/c1").status.allocation
        assert (alloc is None) == (want == "") and (alloc is None or alloc.node_name == want)


class TestPostFilterDeallocation:
    def test_idle_allocation_freed_on_unschedulable(self):
        def scenario(side, clock):
            dra = side.dra
            store = _cel_cluster(side)
            _cel_claim_pod(side, store, "pinned", "c1", 'device.driver == "gpu.example.com"')
            claim = store.get("ResourceClaim", "default/c1")
            claim.status.allocation = dra.AllocationResult(
                devices=(dra.DeviceAllocationResult("gpu", "gpu.example.com", "n0/default",
                                                    "dev-0"),),
                node_name="n0")
            store.update(claim, check_version=False)
            store.create(_w(side).make_pod("filler", cpu="8", mem="1Gi", node_name="n0"))
            s = scheduler(side, store)
            for _ in range(40):
                s.schedule_pending()
                if node_of(store, "pinned"):
                    break
                clock.advance(0.25)
            return store, s

        _, store, _ = run_both(scenario)
        assert node_of(store, "pinned") == "n1"
        assert store.get("ResourceClaim", "default/c1").status.allocation.node_name == "n1"
