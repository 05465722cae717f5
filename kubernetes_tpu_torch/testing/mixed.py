"""A seeded mixed workload that reaches every branch of the wave kernels:
taints and tolerations (NoSchedule and PreferNoSchedule), an unschedulable
node, nodes without a zone, node images, required and preferred node
affinity, a single-name pin, host ports, pods that fit nowhere, two spread
selectors, nodes whose pod count runs out, an extended resource that only
some nodes offer, and explicit ScheduleAnyway spread over a third topology
key ("rack", absent on some nodes) in place of the system defaults.

The workload is a plain spec (made with numpy from a seed); build_nodes /
build_pods turn it into objects of whichever package's API types module is
passed in, so one spec feeds this package and the reference alike.
"""

from __future__ import annotations

import numpy as np

MiB = 1 << 20
EXT = "example.com/dev"  # an extended resource (a plane column past PODS)


def mixed_spec(seed: int, n_nodes: int, n_pods: int) -> dict:
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
        affinity = None
        if required is not None or preferred:
            affinity = types.Affinity(node_affinity=types.NodeAffinity(
                required=required, preferred=preferred))
        ports = ((types.ContainerPort(container_port=s["port"],
                                      host_port=s["port"]),)
                 if s["port"] else ())
        requests = {"cpu": s["cpu"], "memory": s["mem"]}
        if s["dev"]:
            requests[EXT] = 1
        c = types.Container(name="c", image=s["image"], requests=requests,
                            ports=ports)
        spread = ()
        if s["spread_rack"]:
            spread = (
                types.TopologySpreadConstraint(
                    1, "rack", "ScheduleAnyway", types.LabelSelector.of({"app": "a"})),
                types.TopologySpreadConstraint(
                    2, "kubernetes.io/hostname", "ScheduleAnyway",
                    types.LabelSelector.of({"app": s["app"]})),
            )
        out.append(types.Pod(
            meta=meta.ObjectMeta(name=s["name"], namespace="default",
                                 labels={"app": s["app"]}),
            spec=types.PodSpec(containers=[c], affinity=affinity,
                               tolerations=tuple(tols),
                               topology_spread_constraints=spread),
        ))
    return out
