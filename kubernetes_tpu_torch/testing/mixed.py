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
