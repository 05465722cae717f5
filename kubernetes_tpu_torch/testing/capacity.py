"""An H100 fleet's scored resources, shape points and topology keys.

The configuration past the kernels' parameter block (csrc/common.cuh: 8
scored resources, 16 shape points, 16 key slots), built as a plain spec
into either package's API types (as testing/mixed.py builds its workload),
so one configuration feeds this package and the reference alike.

Nodes: SchedulingBasic's (scheduler_perf's createNodes: 32 CPU, 64Gi, 110
pods, zones round-robin over 8), one in GPU_EVERY of them an H100 node
under the GPU Operator's MIG "mixed" strategy: `nvidia.com/gpu: 8` and the
six H100 MIG profiles (MIG_SLICES of each), beside the `ephemeral-storage`
every node has. Every node carries the fleet's topology keys (KEYS): region,
zone, hostname and 17 more (the clouds' network block, sub-block and host
layers, racks, rows, power domains, node pools, GPU cliques, ...), 20 in
all; with n_keys 40, 20 more fabric layers. A GPU clique labels GPU nodes
only.

Scheduler profiles (plugin_args): NodeResourcesFit over the ten scored
resources (cpu, memory, ephemeral-storage, nvidia.com/gpu and the six MIG
profiles; Kubernetes' "Resource Bin Packing"), LeastAllocated
(least_allocated_args) or RequestedToCapacityRatio with a 21-point shape,
utilization 0, 5, ..., 100 (rtc_args).

Keys enter the scheduler's key vocabulary only through constraints and
terms. The cluster's two anchors, running pods (anchor_pods), carry them:
the preferred anchor one preferred anti-affinity term per key past zone
and hostname, in KEYS order, against the traffic's `tier: batch` label, so
the keys take their slots in KEYS order (zone 0 and hostname 1, which the
plane builder interns first) and every traffic pod meets an existing term
on every key slot (the matched key mask over all K slots); the required
anchor one required anti-affinity term on the anti key. key_slots names
the slots the traffic's constraints and terms use: past the parameter
block's 16 with 20 keys (K 32), past one mask word's 32 with 40 (K 64).

Traffic (capacity_pods): pod i of kind i % 8 — plain SchedulingBasic pods,
MIG pods asking for one slice or two, a hard spread (DoNotSchedule) on the
hard key, a soft spread on the soft key, required anti-affinity on the
anti key (against the required anchor's app), preferred affinity on the
pref key (to the preferred anchor's app), and a pod carrying all four.
wide_pod is that last kind alone: the store-driven loop's stream, one
signature, so warm start's template covers every wave.
"""

from __future__ import annotations

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
GPU = "nvidia.com/gpu"
MIG = ("nvidia.com/mig-1g.10gb", "nvidia.com/mig-1g.20gb", "nvidia.com/mig-2g.20gb",
       "nvidia.com/mig-3g.40gb", "nvidia.com/mig-4g.40gb", "nvidia.com/mig-7g.80gb")
# one H100 node's slices of each profile (its 8 GPUs partitioned mixed)
MIG_SLICES = (14, 6, 6, 4, 2, 2)
GPU_EVERY = 5
SCORED = ("cpu", "memory", "ephemeral-storage", GPU) + MIG
# NodeResourcesFit's weight of each scored resource
WEIGHTS = (1, 1, 1, 4) + (2,) * len(MIG)

# (key, domains, layout, GPU nodes only): node i's domain is i * domains //
# n for "block" (contiguous runs) and i % domains for "ring"; capped at the
# node count
_KEYS20 = (
    (ZONE, 8, "ring", False),
    (HOSTNAME, 0, "host", False),
    ("topology.kubernetes.io/region", 2, "block", False),
    ("cloud.google.com/gce-topology-block", 10, "block", False),
    ("cloud.google.com/gce-topology-subblock", 40, "block", False),
    ("cloud.google.com/gce-topology-host", 313, "block", False),
    ("topology.k8s.aws/network-node-layer-1", 5, "block", False),
    ("topology.k8s.aws/network-node-layer-2", 20, "block", False),
    ("topology.k8s.aws/network-node-layer-3", 79, "block", False),
    ("example.com/rack", 157, "block", False),
    ("example.com/row", 20, "block", False),
    ("example.com/power-domain", 5, "block", False),
    ("cloud.google.com/gke-nodepool", 4, "ring", False),
    ("nvidia.com/gpu.clique", 125, "block", True),
    ("example.com/cooling-loop", 10, "block", False),
    ("example.com/pdu", 79, "block", False),
    ("example.com/spine", 32, "block", False),
    ("example.com/leaf", 125, "block", False),
    ("example.com/failure-domain", 3, "ring", False),
    ("example.com/maintenance-window", 6, "ring", False),
)
_KEYS40 = _KEYS20 + tuple(
    (f"fabric.example.com/layer-{j}", (2, 8, 32, 128)[j % 4], ("block", "ring")[j % 2], False)
    for j in range(20))
KEYS = {20: tuple(k for k, *_ in _KEYS20), 40: tuple(k for k, *_ in _KEYS40)}

# the key slots the traffic's hard spread, soft spread, required
# anti-affinity and preferred affinity use, by key count
_SLOTS = {20: (16, 17, 18, 19), 40: (33, 34, 35, 36)}
# a cluster within the parameter block's key slots: zone, hostname, region,
# rack; the traffic's constraints on region and rack
KEYS[4] = (ZONE, HOSTNAME, "topology.kubernetes.io/region", "example.com/rack")
_SLOTS[4] = (3, 2, 3, 2)

BATCH = {"tier": "batch"}
PREF_ANCHOR = "anchor-pref"
REQ_ANCHOR = "anchor-req"


def key_slots(n_keys: int) -> dict:
    """{role: (key, slot)} of the traffic's constraints and terms."""
    roles = ("hard", "soft", "anti", "pref")
    return {r: (KEYS[n_keys][s], s) for r, s in zip(roles, _SLOTS[n_keys])}


def rtc_shape() -> list[list[int]]:
    """A bin-packing shape sampled every 5 % of utilization: 21 points,
    score (u / 100)^2 * 100 rounded down."""
    return [[5 * k, k * k * 100 // 400] for k in range(21)]


def least_allocated_args() -> dict:
    return {"NodeResourcesFit": {"strategy": "LeastAllocated",
                                 "resources": dict(zip(SCORED, WEIGHTS))}}


def rtc_args() -> dict:
    return {"NodeResourcesFit": {"strategy": "RequestedToCapacityRatio",
                                 "resources": dict(zip(SCORED, WEIGHTS)),
                                 "shape": rtc_shape()}}


def _domain(spec, i: int, n: int) -> str | None:
    key, d, layout, gpu_only = spec
    if gpu_only and i % GPU_EVERY:
        return None
    if layout == "host":
        return f"node-{i}"
    d = max(1, min(d, n))
    idx = i * d // n if layout == "block" else i % d
    return f"{key.rsplit('/', 1)[-1]}-{idx}"


def capacity_nodes(n: int, n_keys: int, types, meta) -> list:
    """n nodes node-0.. (see the module docstring) labelled with n_keys
    topology keys (4, 20 or 40)."""
    specs = {4: tuple(s for s in _KEYS20 if s[0] in KEYS[4]), 20: _KEYS20, 40: _KEYS40}[n_keys]
    out = []
    for i in range(n):
        labels = {}
        for spec in specs:
            v = _domain(spec, i, n)
            if v is not None:
                labels[spec[0]] = v
        alloc = {"cpu": "32", "memory": "64Gi", "pods": 110, "ephemeral-storage": "100Gi"}
        if i % GPU_EVERY == 0:
            alloc[GPU] = 8
            alloc.update(zip(MIG, MIG_SLICES))
        out.append(types.Node(
            meta=meta.ObjectMeta(name=f"node-{i}", namespace="", labels=labels),
            spec=types.NodeSpec(),
            status=types.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc))))
    return out


def _term(types, labels: dict, key: str):
    return types.PodAffinityTerm(label_selector=types.LabelSelector.of(labels), topology_key=key)


def _pod(types, meta, name, requests, labels, affinity=None, spread=(), node_name=""):
    c = types.Container(name="c", requests=dict(requests))
    return types.Pod(meta=meta.ObjectMeta(name=name, namespace="default", labels=dict(labels)),
                     spec=types.PodSpec(containers=[c], affinity=affinity,
                                        topology_spread_constraints=tuple(spread),
                                        node_name=node_name))


def anchor_pods(n: int, n_keys: int, types, meta) -> list:
    """The cluster's anchors, running pods as (pod, node name): the
    preferred anchor on node-0 (one preferred anti-affinity term per key
    past zone and hostname, in KEYS order, against `tier: batch`) and the
    required anchor on node-{n // 2} (required anti-affinity against `tier:
    batch` on the anti key)."""
    keys = KEYS[n_keys]
    pref = tuple(types.WeightedPodAffinityTerm(1 + j % 7, _term(types, BATCH, k))
                 for j, k in enumerate(keys[2:]))
    a = _pod(types, meta, "anchor-pref", {"cpu": "100m", "memory": "64Mi"}, {"app": PREF_ANCHOR},
             types.Affinity(pod_anti_affinity=types.PodAntiAffinity(preferred=pref)))
    anti_key = key_slots(n_keys)["anti"][0]
    b = _pod(types, meta, "anchor-req", {"cpu": "100m", "memory": "64Mi"}, {"app": REQ_ANCHOR},
             types.Affinity(pod_anti_affinity=types.PodAntiAffinity(
                 required=(_term(types, BATCH, anti_key),))))
    return [(a, "node-0"), (b, f"node-{n // 2}")]


def _mig_requests(i: int, two: bool) -> dict:
    req = {"cpu": "1", "memory": "4Gi", "ephemeral-storage": "1Gi", MIG[i % 3]: 1}
    if two:
        req[MIG[3 + i % 3]] = 1
    return req


def _constraints(types, n_keys: int, kinds: str, app: str):
    """(affinity, spread) for the roles in `kinds` (h hard, s soft, a anti,
    p pref)."""
    ks = key_slots(n_keys)
    spread = []
    if "h" in kinds:
        spread.append(types.TopologySpreadConstraint(
            1, ks["hard"][0], "DoNotSchedule", types.LabelSelector.of({"app": app})))
    if "s" in kinds:
        spread.append(types.TopologySpreadConstraint(
            2, ks["soft"][0], "ScheduleAnyway", types.LabelSelector.of({"app": app})))
    anti = (types.PodAntiAffinity(required=(_term(types, {"app": REQ_ANCHOR}, ks["anti"][0]),))
            if "a" in kinds else None)
    aff = (types.PodAffinity(preferred=(types.WeightedPodAffinityTerm(
        10, _term(types, {"app": PREF_ANCHOR}, ks["pref"][0])),)) if "p" in kinds else None)
    affinity = (types.Affinity(pod_affinity=aff, pod_anti_affinity=anti)
                if anti is not None or aff is not None else None)
    return affinity, spread


_KINDS = ("plain", "mig1", "mig2", "hard", "soft", "anti", "pref", "wide")


def capacity_pods(lo: int, hi: int, n_keys: int, types, meta) -> list:
    """Pods p{lo}..p{hi - 1}, pod i of kind _KINDS[i % 8] (see the module
    docstring), every one labelled `tier: batch`."""
    out = []
    for i in range(lo, hi):
        kind = _KINDS[i % len(_KINDS)]
        app = kind
        requests = {"cpu": "100m", "memory": "50Mi"}
        if kind in ("mig1", "mig2"):
            requests = _mig_requests(i, kind == "mig2")
        elif kind in ("hard", "soft"):
            requests = {"cpu": "250m", "memory": "256Mi", "ephemeral-storage": "2Gi"}
        roles = {"hard": "h", "soft": "s", "anti": "a", "pref": "p", "wide": "hsap"}.get(kind, "")
        affinity, spread = _constraints(types, n_keys, roles, app)
        out.append(_pod(types, meta, f"p{i:05d}", requests, {"app": app, **BATCH}, affinity,
                        spread))
    return out


def wide_pod(i: int, n_keys: int, types, meta, requests: dict | None = None):
    """The store-driven loop's pod: SchedulingBasic's request (100m, 50Mi;
    or `requests`) with every role (hard and soft spread, required
    anti-affinity, preferred affinity) on the high key slots."""
    affinity, spread = _constraints(types, n_keys, "hsap", "wide")
    return _pod(types, meta, f"w{i:05d}", requests or {"cpu": "100m", "memory": "50Mi"},
                {"app": "wide", **BATCH}, affinity, spread)


def capacity_gang(name: str, mode: str, size: int, n_keys: int, types, meta) -> tuple:
    """(PodGroup, members): a gang of `size` (minCount) placed by zone
    (mode Required or Preferred); its members labelled gang: <name> and
    `tier: batch`, spread by the hard key (DoNotSchedule, maxSkew 1 over
    the gang), one in four a MIG pod of one slice."""
    sel = types.LabelSelector.of({"gang": name})
    spread = (types.TopologySpreadConstraint(1, key_slots(n_keys)["hard"][0], "DoNotSchedule",
                                             sel),)
    group = types.PodGroup(
        meta=meta.ObjectMeta(name=name),
        spec=types.PodGroupSpec(policy=types.GangPolicy(min_count=size),
                                constraints=types.SchedulingConstraints(topology=(
                                    types.TopologyConstraint(key=ZONE, mode=mode),))))
    members = []
    for i in range(size):
        req = _mig_requests(i, False) if i % 4 == 1 else {"cpu": "100m", "memory": "50Mi"}
        pod = _pod(types, meta, f"{name}-{i}", req, {"gang": name, **BATCH}, spread=spread)
        pod.spec.scheduling_group = types.SchedulingGroup(pod_group_name=name)
        members.append(pod)
    return group, members
