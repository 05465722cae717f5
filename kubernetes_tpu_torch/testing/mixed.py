"""A seeded mixed workload that reaches every branch of the wave kernels:
taints and tolerations (NoSchedule and PreferNoSchedule), an unschedulable
node, nodes without a zone, node images, required and preferred node
affinity, a single-name pin, host ports, pods that fit nowhere, two spread
selectors, nodes whose pod count runs out, an extended resource that only
some nodes offer, and explicit ScheduleAnyway spread over a third topology
key ("rack", absent on some nodes) in place of the system defaults.

With constraints=True the pods also carry what the single-pod kernel
computes and the wave scan does not: DoNotSchedule spread over zone,
hostname or rack, and inter-pod (anti)affinity — required affinity
(including terms on a group label whose first pod matches only itself: the
self-match bootstrap), required anti-affinity on hostname and zone keys,
and preferred affinity and anti-affinity. Once placed, such pods are the
existing pods whose terms the next pods meet. Those draws come from a second
generator, so the other fields are the same with and without them.

The workload is a plain spec (made with numpy from a seed); build_nodes /
build_pods turn it into objects of whichever package's API types module is
passed in, so one spec feeds this package and the reference alike.

The wave functions below (dedup_nodes, dedup_pods, ipa_pods) make the
signature-dedup waves the same way: a few pod shapes repeated, so that the
scan replays resident signature rows, in either package's types.

The gang functions at the end make PodGroup clusters the same way: a spec
of nodes (zones round-robin, as scheduler_perf's createNodes labels them)
and gangs (a PodGroup with an optional zone topology constraint and its
members, as createPodGroups makes them), built by build_gangs into either
package's types. gang_fuzz_spec replays the reference's seeded gang fuzz
cases; mixed_gang_spec gives members hard spread, inter-pod affinity and
host ports.

burst_pods makes the scheduling loop's streamed bursts (the reference's
tests/test_pipeline_golden.py mixed_pods) from either package's
testing.wrappers module.
"""

from __future__ import annotations

import numpy as np

MiB = 1 << 20
EXT = "example.com/dev"  # an extended resource (a plane column past PODS)


_KEYS = {"zone": "topology.kubernetes.io/zone",
         "hostname": "kubernetes.io/hostname", "rack": "rack"}


def _term(crng, own: dict, keys) -> tuple:
    """(selector labels, topology key name): a term on the pod's group label
    half of the time, else on an app label."""
    sel = ({"grp": own["grp"]} if crng.random() < 0.5
           else {"app": str(crng.choice(["a", "b"]))})
    return sel, str(crng.choice(keys))


def mixed_spec(seed: int, n_nodes: int, n_pods: int,
               constraints: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        nodes.append({
            "name": f"n{i}",
            "cpu": str(int(rng.choice([2, 4, 8]))),
            "mem": f"{int(rng.choice([4, 8, 16]))}Gi",
            "pods": int(rng.choice([4, 110], p=[0.2, 0.8])),
            "zone": None if i % 7 == 6 else f"z{i % 4}",
            "disk": str(rng.choice(["ssd", "hdd"])),
            "taint": bool(rng.random() < 0.2),
            "prefer_taint": bool(rng.random() < 0.3),
            "unschedulable": i == 3,
            "dev": int(rng.choice([0, 0, 2])),
            "rack": None if i % 5 == 0 else f"r{i % 12}",
            "images": {img: int(size) for img, size in (
                ("img-a", 300 * MiB), ("img-b", 1500 * MiB))
                if rng.random() < 0.4},
        })
    pods = []
    for i in range(n_pods):
        kind = rng.random()
        pods.append({
            "name": f"p{i}",
            "cpu": str(rng.choice(["100m", "250m", "500m", "1"])) if kind > 0.05 else "64",
            "mem": str(rng.choice(["64Mi", "256Mi", "1Gi"])),
            "app": str(rng.choice(["a", "b"])),
            "tolerate": bool(rng.random() < 0.3),
            "tolerate_prefer": bool(rng.random() < 0.3),
            "require_ssd": bool(rng.random() < 0.15),
            "prefer_ssd": int(rng.choice([0, 0, 5, 40])),
            "pin": f"n{int(rng.integers(n_nodes))}" if rng.random() < 0.05 else None,
            "port": 8080 if rng.random() < 0.1 else 0,
            "image": str(rng.choice(["", "img-a", "img-b"])),
            "dev": bool(rng.random() < 0.1),
            "spread_rack": bool(rng.random() < 0.15),
        })
    if constraints:
        crng = np.random.default_rng([seed, 7])
        for s in pods:
            s["grp"] = f"g{int(crng.integers(4))}"
            s["hard"] = ((str(crng.choice(list(_KEYS))), int(crng.choice([1, 2])))
                         if crng.random() < 0.3 else None)
            s["aff"] = (_term(crng, s, ["zone", "hostname"])
                        if crng.random() < 0.15 else None)
            s["anti"] = (_term(crng, s, ["hostname", "zone"])
                         if crng.random() < 0.15 else None)
            s["pref"] = [(int(crng.integers(1, 50)), bool(crng.random() < 0.5))
                         + _term(crng, s, ["zone", "hostname", "rack"])
                         for _ in range(int(crng.choice([0, 0, 1, 2])))]
    return {"nodes": nodes, "pods": pods}


def build_nodes(spec: dict, types, meta) -> list:
    """spec nodes → Node objects of the package whose api.types / api.meta
    modules are given."""
    out = []
    for s in spec["nodes"]:
        labels = {"kubernetes.io/hostname": s["name"], "disk": s["disk"]}
        if s["zone"] is not None:
            labels["topology.kubernetes.io/zone"] = s["zone"]
        if s["rack"] is not None:
            labels["rack"] = s["rack"]
        taints = []
        if s["taint"]:
            taints.append(types.Taint("dedicated", "infra", "NoSchedule"))
        if s["prefer_taint"]:
            taints.append(types.Taint("spot", "true", "PreferNoSchedule"))
        alloc = {"cpu": s["cpu"], "memory": s["mem"], "pods": s["pods"],
                 "ephemeral-storage": "100Gi"}
        if s["dev"]:
            alloc[EXT] = s["dev"]
        out.append(types.Node(
            meta=meta.ObjectMeta(name=s["name"], namespace="", labels=labels),
            spec=types.NodeSpec(unschedulable=s["unschedulable"],
                                taints=tuple(taints)),
            status=types.NodeStatus(
                capacity=dict(alloc), allocatable=dict(alloc),
                images=[types.ContainerImage((img,), size)
                        for img, size in s["images"].items()]),
        ))
    return out


def build_pods(spec: dict, types, meta) -> list:
    """spec pods → Pod objects of the given package (see build_nodes)."""
    out = []
    for s in spec["pods"]:
        tols = []
        if s["tolerate"]:
            tols.append(types.Toleration("dedicated", "Equal", "infra", "NoSchedule"))
        if s["tolerate_prefer"]:
            tols.append(types.Toleration("spot", "Exists", "", "PreferNoSchedule"))
        required = None
        if s["pin"] is not None:
            required = types.NodeSelector(terms=(types.NodeSelectorTerm(
                match_fields=(types.NodeSelectorRequirement(
                    "metadata.name", "In", (s["pin"],)),)),))
        elif s["require_ssd"]:
            required = types.NodeSelector(terms=(types.NodeSelectorTerm(
                match_expressions=(types.NodeSelectorRequirement(
                    "disk", "In", ("ssd",)),)),))
        preferred = ()
        if s["prefer_ssd"]:
            preferred = (types.PreferredSchedulingTerm(
                weight=s["prefer_ssd"], preference=types.NodeSelectorTerm(
                    match_expressions=(types.NodeSelectorRequirement(
                        "disk", "In", ("ssd",)),))),)
        node_aff = (types.NodeAffinity(required=required, preferred=preferred)
                    if required is not None or preferred else None)
        pod_aff, pod_anti = _pod_affinity(s, types)
        affinity = None
        if node_aff is not None or pod_aff is not None or pod_anti is not None:
            affinity = types.Affinity(node_affinity=node_aff, pod_affinity=pod_aff,
                                      pod_anti_affinity=pod_anti)
        ports = ((types.ContainerPort(container_port=s["port"],
                                      host_port=s["port"]),)
                 if s["port"] else ())
        requests = {"cpu": s["cpu"], "memory": s["mem"]}
        if s["dev"]:
            requests[EXT] = 1
        c = types.Container(name="c", image=s["image"], requests=requests,
                            ports=ports)
        spread = ()
        if s.get("hard") is not None:
            key, skew = s["hard"]
            spread += (types.TopologySpreadConstraint(
                skew, _KEYS[key], "DoNotSchedule",
                types.LabelSelector.of({"app": s["app"]})),)
        if s["spread_rack"]:
            spread += (
                types.TopologySpreadConstraint(
                    1, "rack", "ScheduleAnyway", types.LabelSelector.of({"app": "a"})),
                types.TopologySpreadConstraint(
                    2, "kubernetes.io/hostname", "ScheduleAnyway",
                    types.LabelSelector.of({"app": s["app"]})),
            )
        labels = {"app": s["app"]}
        if "grp" in s:
            labels["grp"] = s["grp"]
        out.append(types.Pod(
            meta=meta.ObjectMeta(name=s["name"], namespace="default",
                                 labels=labels),
            spec=types.PodSpec(containers=[c], affinity=affinity,
                               tolerations=tuple(tols),
                               topology_spread_constraints=spread),
        ))
    return out


def _pod_affinity(s: dict, types):
    """(PodAffinity | None, PodAntiAffinity | None) of a spec pod."""
    def term(sel, key):
        return types.PodAffinityTerm(label_selector=types.LabelSelector.of(sel),
                                     topology_key=_KEYS[key])

    req_aff = (term(*s["aff"]),) if s.get("aff") else ()
    req_anti = (term(*s["anti"]),) if s.get("anti") else ()
    pref_aff = tuple(types.WeightedPodAffinityTerm(w, term(sel, key))
                     for w, anti, sel, key in s.get("pref", ()) if not anti)
    pref_anti = tuple(types.WeightedPodAffinityTerm(w, term(sel, key))
                      for w, anti, sel, key in s.get("pref", ()) if anti)
    pod_aff = (types.PodAffinity(required=req_aff, preferred=pref_aff)
               if req_aff or pref_aff else None)
    pod_anti = (types.PodAntiAffinity(required=req_anti, preferred=pref_anti)
                if req_anti or pref_anti else None)
    return pod_aff, pod_anti


# --- signature-dedup waves ---------------------------------------------------


def dedup_nodes(n: int, types, meta, cpu: str = "4", mem: str = "8Gi") -> list:
    """n nodes n0.. of cpu/mem over two zones z0/z1 (the reference dedup
    tests' make_cluster)."""
    out = []
    for i in range(n):
        alloc = {"cpu": cpu, "memory": mem, "pods": 110, "ephemeral-storage": "100Gi"}
        out.append(types.Node(
            meta=meta.ObjectMeta(name=f"n{i}", namespace="", labels={
                _KEYS["hostname"]: f"n{i}", _KEYS["zone"]: f"z{i % 2}"}),
            spec=types.NodeSpec(),
            status=types.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc))))
    return out


def _pod(types, meta, name, cpu, mem, labels, affinity=None, spread=()):
    c = types.Container(name="c", requests={"cpu": cpu, "memory": mem})
    return types.Pod(meta=meta.ObjectMeta(name=name, namespace="default",
                                          labels=dict(labels)),
                     spec=types.PodSpec(containers=[c], affinity=affinity,
                                        topology_spread_constraints=spread))


def dedup_pods(n: int, types, meta, spread: tuple | None = None) -> list:
    """The reference dedup tests' mixed_pods: three signatures interleaved
    a b c a b c ... (1 CPU/1Gi, 900m/900Mi, 800m/800Mi), so every clone run
    is split by the other signatures' steps. spread = (max_skew, key name
    of _KEYS) adds a DoNotSchedule constraint selecting the pod's own
    labels."""
    shapes = (("a", "1", "1Gi"), ("b", "900m", "900Mi"), ("c", "800m", "800Mi"))
    out = []
    for i in range(n):
        app, cpu, mem = shapes[i % 3]
        cons = ()
        if spread is not None:
            cons = (types.TopologySpreadConstraint(
                spread[0], _KEYS[spread[1]], "DoNotSchedule",
                types.LabelSelector.of({"app": app})),)
        out.append(_pod(types, meta, f"{app}{i:02d}", cpu, mem, {"app": app},
                        spread=cons))
    return out


def ipa_pods(n: int, types, meta) -> list:
    """A wave of six repeating inter-pod affinity shapes: a plain web pod;
    a db pod with required anti-affinity to db on hostname; a cache pod
    with required affinity to cache on zone (the first one matches only
    itself: the self-match bootstrap); a web pod preferring db and avoiding
    web (preferred terms both ways); a batch pod with required
    anti-affinity to batch on zone; and a db pod preferring cache."""
    def term(app, key):
        return types.PodAffinityTerm(label_selector=types.LabelSelector.of({"app": app}),
                                     topology_key=_KEYS[key])

    shapes = (
        ("web", None),
        ("db", types.Affinity(pod_anti_affinity=types.PodAntiAffinity(
            required=(term("db", "hostname"),)))),
        ("cache", types.Affinity(pod_affinity=types.PodAffinity(
            required=(term("cache", "zone"),)))),
        ("web", types.Affinity(
            pod_affinity=types.PodAffinity(preferred=(
                types.WeightedPodAffinityTerm(10, term("db", "zone")),)),
            pod_anti_affinity=types.PodAntiAffinity(preferred=(
                types.WeightedPodAffinityTerm(5, term("web", "hostname")),)))),
        ("batch", types.Affinity(pod_anti_affinity=types.PodAntiAffinity(
            required=(term("batch", "zone"),)))),
        ("db", types.Affinity(pod_affinity=types.PodAffinity(preferred=(
            types.WeightedPodAffinityTerm(20, term("cache", "hostname")),)))),
    )
    out = []
    for i in range(n):
        app, aff = shapes[i % len(shapes)]
        out.append(_pod(types, meta, f"i{i:03d}", "250m", "256Mi", {"app": app},
                        affinity=aff))
    return out


# --- gangs ---------------------------------------------------------------------

ZONE_KEY = _KEYS["zone"]


def gang_node(name: str, zone: str | None, cpu: str = "32", mem: str = "64Gi",
              pods: int = 110) -> dict:
    return {"name": name, "zone": zone, "cpu": cpu, "mem": mem, "pods": pods}


def gang_member(name: str, cpu: str = "100m", mem: str = "50Mi", **kinds) -> dict:
    """A member spec: the harness's default pod (100m, 50Mi) unless given;
    kinds: spread=(max_skew, key name), anti=key name (required
    anti-affinity to the own group), aff=key name (preferred affinity to the
    own group), port=host port."""
    return {"name": name, "cpu": cpu, "mem": mem, **kinds}


def gang(name: str, mode: str | None, members: list[dict],
         key: str = ZONE_KEY, labelled: bool = False) -> dict:
    """A PodGroup spec: minCount = the member count; mode Required /
    Preferred adds a topology constraint on `key`, None adds none. The
    members carry no labels (the harness's default pod), or with
    `labelled` the label gang: <name>, which their spread and affinity
    terms select."""
    return {"name": name, "mode": mode, "key": key, "members": members,
            "labelled": labelled}


def perf_gang_spec(n_nodes: int, zones: int, n_groups: int, size: int,
                   mode: str | None) -> dict:
    """scheduler_perf's gang workloads (kubernetes_tpu/perf/configs/gang.yaml):
    createNodes with the default node template (32 CPU, 64Gi, 110 pods),
    zone-{i % zones}; createPodGroups of `size` default pods per group,
    named group-{g}-{first pod's sequence number}, members pod-{i}."""
    nodes = [gang_node(f"node-{i}", f"zone-{i % zones}") for i in range(n_nodes)]
    gangs = []
    for g in range(n_groups):
        seq = g * size
        gangs.append(gang(f"group-{g}-{seq}", mode,
                          [gang_member(f"pod-{seq + i}") for i in range(size)]))
    return {"nodes": nodes, "gangs": gangs}


def gang_wave_spec(modes=("Required", "Preferred", None), sizes=(3, 2, 4),
                   nodes: int = 12, zones: int = 3, cpu: str = "8",
                   pod_cpu: str = "1") -> dict:
    """The reference's gang-wave parity scenario (tests/test_gang_wave.py
    _run): nodes n{i} of `cpu` / 16Gi in z{i % zones}, one gang per size."""
    return {"nodes": [gang_node(f"n{i}", f"z{i % zones}", cpu=cpu, mem="16Gi")
                      for i in range(nodes)],
            "gangs": [gang(f"gang{g}", mode,
                           [gang_member(f"gang{g}-{i}", cpu=pod_cpu, mem=None)
                            for i in range(size)])
                      for g, (size, mode) in enumerate(zip(sizes, modes))]}


def gang_fuzz_spec(seed: int) -> dict:
    """The gangs of the reference's seeded gang fuzz case
    (tests/test_golden_fuzz.py gang_assignments): the same random.Random
    draws in the same order; the plain pods between gangs are drawn and
    left out."""
    import random

    rng = random.Random(seed)
    nodes = [gang_node(f"n{i}", ("z0", "z1", "z2")[i % 3], cpu="8", mem="16Gi")
             for i in range(12)]
    gangs = []
    for g in range(3):
        size = rng.randint(2, 4)
        roll = rng.random()
        mode = "Required" if roll < 0.4 else ("Preferred" if roll < 0.7 else None)
        members = [gang_member(f"gang{g}-{i}", cpu=rng.choice(("1", "2")), mem=None)
                   for i in range(size)]
        rng.randint(0, 3)  # the plain pods interleaved in the reference case
        gangs.append(gang(f"gang{g}", mode, members))
    return {"nodes": nodes, "gangs": gangs}


def mixed_gang_spec(seed: int, n_nodes: int, zones: int, n_gangs: int,
                    max_size: int = 6) -> dict:
    """Mixed gangs on nodes of mixed sizes: members with hard zone or
    hostname spread over their own group, required anti-affinity to their
    group on hostname, preferred affinity to it on zone, or a host port; each
    gang Required, Preferred or unconstrained, and about one in eight of
    them too large for any node (20 CPU a member). Placed gangs become the
    existing pods whose terms the next gangs meet."""
    rng = np.random.default_rng(seed)
    nodes = [gang_node(f"node-{i}", f"zone-{i % zones}",
                       cpu=str(int(rng.choice([4, 8, 16]))),
                       mem=f"{int(rng.choice([8, 16, 32]))}Gi",
                       pods=int(rng.choice([8, 110], p=[0.2, 0.8])))
             for i in range(n_nodes)]
    gangs = []
    for g in range(n_gangs):
        mode = [None, "Required", "Preferred"][int(rng.integers(3))]
        huge = bool(rng.random() < 0.125)
        members = []
        for i in range(int(rng.integers(2, max_size + 1))):
            kind = str(rng.choice(["plain", "plain", "spread", "anti", "aff", "port"]))
            extra = {}
            if kind == "spread":
                extra["spread"] = (int(rng.choice([1, 2])), str(rng.choice(["zone", "hostname"])))
            elif kind in ("anti", "aff"):
                extra[kind] = "hostname" if kind == "anti" else "zone"
            elif kind == "port":
                extra["port"] = 8080
            cpu = str(rng.choice(["250m", "500m", "1", "2"]))
            members.append(gang_member(
                f"g{g}-{i}", cpu="20" if huge else cpu,
                mem=str(rng.choice(["256Mi", "1Gi"])), **extra))
        gangs.append(gang(f"g{g}", mode, members, labelled=True))
    return {"nodes": nodes, "gangs": gangs}


def build_gang_nodes(spec: dict, types, meta) -> list:
    out = []
    for s in spec["nodes"]:
        labels = {_KEYS["hostname"]: s["name"]}
        if s["zone"] is not None:
            labels[ZONE_KEY] = s["zone"]
        alloc = {"cpu": s["cpu"], "memory": s["mem"], "pods": s["pods"],
                 "ephemeral-storage": "100Gi"}
        out.append(types.Node(
            meta=meta.ObjectMeta(name=s["name"], namespace="", labels=labels),
            spec=types.NodeSpec(),
            status=types.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc))))
    return out


def _gang_pod(types, meta, group: str, s: dict, labelled: bool):
    sel = types.LabelSelector.of({"gang": group})

    def term(key):
        return types.PodAffinityTerm(label_selector=sel, topology_key=_KEYS[key])

    affinity = None
    if s.get("anti"):
        affinity = types.Affinity(pod_anti_affinity=types.PodAntiAffinity(
            required=(term(s["anti"]),)))
    elif s.get("aff"):
        affinity = types.Affinity(pod_affinity=types.PodAffinity(
            preferred=(types.WeightedPodAffinityTerm(10, term(s["aff"])),)))
    spread = ()
    if s.get("spread"):
        skew, key = s["spread"]
        spread = (types.TopologySpreadConstraint(skew, _KEYS[key], "DoNotSchedule", sel),)
    ports = ((types.ContainerPort(container_port=s["port"], host_port=s["port"]),)
             if s.get("port") else ())
    req = {"cpu": s["cpu"]}
    if s["mem"] is not None:
        req["memory"] = s["mem"]
    return types.Pod(
        meta=meta.ObjectMeta(name=s["name"], namespace="default",
                             labels={"gang": group} if labelled else {}),
        spec=types.PodSpec(
            containers=[types.Container(name="c", requests=req, ports=ports)],
            affinity=affinity, topology_spread_constraints=spread,
            scheduling_group=types.SchedulingGroup(pod_group_name=group)))


def build_gangs(spec: dict, types, meta) -> list:
    """[(PodGroup, [member Pods])] of the given package, in spec order."""
    out = []
    for gs in spec["gangs"]:
        constraints = types.SchedulingConstraints()
        if gs["mode"] is not None:
            constraints = types.SchedulingConstraints(topology=(
                types.TopologyConstraint(key=gs["key"], mode=gs["mode"]),))
        group = types.PodGroup(
            meta=meta.ObjectMeta(name=gs["name"]),
            spec=types.PodGroupSpec(policy=types.GangPolicy(min_count=len(gs["members"])),
                                    constraints=constraints))
        out.append((group, [_gang_pod(types, meta, gs["name"], m, gs["labelled"])
                            for m in gs["members"]]))
    return out


def burst_pods(w, lo: int, hi: int, spread: bool = False, ipa: bool = False) -> list:
    """Pods lo..hi-1 of three interleaved signatures (a, b, c), built with
    `w`, either package's testing.wrappers module: every clone run is split
    across other signatures' steps, so the dedup tier re-enters mid-wave.
    With `spread` each pod carries a DoNotSchedule zone constraint (maxSkew
    5); with `ipa` every third pod carries required zone pod affinity to
    app=a (every sixth anti-affinity instead)."""
    pods = []
    for i in range(lo, hi):
        kind = i % 3
        if kind == 0:
            p = w.make_pod(f"a{i:02d}", cpu="1", mem="1Gi", labels={"app": "a"})
        elif kind == 1:
            p = w.make_pod(f"b{i:02d}", cpu="900m", mem="900Mi", labels={"app": "b"})
        else:
            p = w.make_pod(f"c{i:02d}", cpu="800m", mem="800Mi", labels={"app": "c"})
        if spread:
            p = w.with_spread(p, max_skew=5, key="topology.kubernetes.io/zone",
                              when="DoNotSchedule")
        if ipa and kind == 0:
            p = w.with_pod_affinity(p, "app", "a", "topology.kubernetes.io/zone",
                                    anti=(i % 6 == 0))
        pods.append(p)
    return pods
