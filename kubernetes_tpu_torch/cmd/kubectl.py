"""kubectl-equivalent CLI over the REST API.

Reference: staging/src/k8s.io/kubectl + cmd/kubectl — the verb surface
(get, describe, create -f, apply -f, delete, scale, cordon/uncordon) over
client-go. Manifests use the api/serialization wire shape; `apply` is
SERVER-SIDE apply under the "kubectl" field manager (apiserver/apply.py
fieldmanager: ownership tracking, conflict detection, dropped-field
removal).

A copy of the reference package's module (kubernetes_tpu/cmd/kubectl.py).
Without PyYAML it reads a JSON manifest.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..api.serialization import decode, encode
from ..client.rest import RESTStore
from ..store.store import AlreadyExistsError, NotFoundError

DEFAULT_SERVER = "http://127.0.0.1:6443"

# kubectl resource aliases
ALIASES = {
    "pod": "Pod", "pods": "Pod", "po": "Pod",
    "node": "Node", "nodes": "Node", "no": "Node",
    "deployment": "Deployment", "deployments": "Deployment", "deploy": "Deployment",
    "replicaset": "ReplicaSet", "replicasets": "ReplicaSet", "rs": "ReplicaSet",
    "job": "Job", "jobs": "Job",
    "service": "Service", "services": "Service", "svc": "Service",
    "endpointslice": "EndpointSlice", "endpointslices": "EndpointSlice",
    "pv": "PersistentVolume", "persistentvolume": "PersistentVolume",
    "pvc": "PersistentVolumeClaim", "persistentvolumeclaim": "PersistentVolumeClaim",
    "storageclass": "StorageClass", "sc": "StorageClass",
    "podgroup": "PodGroup", "podgroups": "PodGroup", "pg": "PodGroup",
    "resourceclaim": "ResourceClaim", "resourceclaims": "ResourceClaim",
    "configmap": "ConfigMap", "configmaps": "ConfigMap", "cm": "ConfigMap",
    "secret": "Secret", "secrets": "Secret",
    "cronjob": "CronJob", "cronjobs": "CronJob", "cj": "CronJob",
    "hpa": "HorizontalPodAutoscaler",
    "horizontalpodautoscaler": "HorizontalPodAutoscaler",
    "resourcequota": "ResourceQuota", "quota": "ResourceQuota",
    "statefulset": "StatefulSet", "statefulsets": "StatefulSet",
    "sts": "StatefulSet",
    "daemonset": "DaemonSet", "daemonsets": "DaemonSet", "ds": "DaemonSet",
    "resourceslice": "ResourceSlice", "resourceslices": "ResourceSlice",
    "lease": "Lease", "leases": "Lease",
}


def _kind(resource: str) -> str:
    return ALIASES.get(resource.lower(), resource)


def _key(kind: str, name: str, namespace: str) -> str:
    # one source of truth for scoping (discovery.CLUSTER_SCOPED)
    from ..apiserver.discovery import CLUSTER_SCOPED

    return name if kind in CLUSTER_SCOPED else f"{namespace}/{name}"


def _status_of(obj) -> str:
    if obj.kind == "Pod":
        return obj.status.phase if not obj.spec.node_name else (
            f"{obj.status.phase} on {obj.spec.node_name}"
        )
    if obj.kind == "Node":
        ready = next((c for c in obj.status.conditions if c.type == "Ready"), None)
        return "Ready" if ready and ready.status == "True" else "NotReady"
    if obj.kind in ("Deployment", "ReplicaSet"):
        return f"{obj.status.ready_replicas}/{obj.spec.replicas} ready"
    if obj.kind == "Job":
        return "Complete" if obj.status.completed else f"{obj.status.succeeded} succeeded"
    if obj.kind == "PersistentVolumeClaim":
        return obj.status.phase
    return ""


def _aggregated_resource(client: RESTStore, resource: str):
    """Resolve a resource name through aggregated-API discovery: walk
    /apis (merged APIGroupList), then each group/version's proxied
    APIResourceList, matching name or kind (kubectl's RESTMapper over
    discovery). Returns (groupVersion, resource-name, namespaced)."""
    try:
        groups = client.raw_get("/apis").get("groups", [])
    except Exception:  # noqa: BLE001 - no aggregation layer configured
        return None
    want = resource.lower()
    for g in groups:
        for v in g.get("versions", []):
            gv = v["groupVersion"]
            try:
                rl = client.raw_get(f"/apis/{gv}")
            except Exception:  # noqa: BLE001 - delegate down; keep looking
                continue
            for r in rl.get("resources", []):
                if want in (r.get("name", "").lower(),
                            r.get("kind", "").lower(),
                            r.get("kind", "").lower() + "s"):
                    return gv, r["name"], bool(r.get("namespaced"))
    return None


def _get_aggregated(client: RESTStore, args) -> int:
    """kubectl get over an aggregated resource: fetch through the MAIN
    server (which proxies to the APIService delegate) and print the
    unstructured items."""
    found = _aggregated_resource(client, args.resource)
    if found is None:
        print(f"Error: the server doesn't have a resource type "
              f"{args.resource!r}", file=sys.stderr)
        return 1
    gv, rname, namespaced = found
    if namespaced and not args.all_namespaces:
        path = f"/apis/{gv}/namespaces/{args.namespace}/{rname}"
    else:
        path = f"/apis/{gv}/{rname}"
    if args.name:
        path += f"/{args.name}"
    try:
        doc = client.raw_get(path)
    except Exception as e:  # noqa: BLE001 - surfaced to the user
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        print(json.dumps(doc, indent=2))
        return 0
    items = doc.get("items", [doc])
    print("NAME\tUSAGE")
    for item in items:
        meta = item.get("metadata", {})
        usage = item.get("usage") or {}
        if not usage and item.get("containers"):
            usage = item["containers"][0].get("usage", {})
        usage_s = ",".join(f"{k}={v}" for k, v in sorted(usage.items()))
        print(f"{meta.get('name', '?')}\t{usage_s}")
    return 0


def cmd_get(client: RESTStore, args) -> int:
    kind = _kind(args.resource)
    from ..api.serialization import _KINDS, _register_all

    _register_all()
    if kind not in _KINDS:
        # not a core kind: try the aggregation layer's discovery
        return _get_aggregated(client, args)
    if args.name:
        try:
            obj = client.get(kind, _key(kind, args.name, args.namespace))
        except NotFoundError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if args.output == "json":
            print(json.dumps(encode(obj), indent=2))
        else:
            print(f"{obj.meta.name}\t{_status_of(obj)}")
        return 0
    items, _ = client.list(kind)
    visible = [
        obj for obj in sorted(items, key=lambda o: o.meta.key)
        if obj.meta.namespace in ("", args.namespace) or args.all_namespaces
    ]
    if args.output == "json":
        print(json.dumps([encode(o) for o in visible], indent=2))
    else:
        print(f"NAME\tSTATUS")
        for obj in visible:
            print(f"{obj.meta.name}\t{_status_of(obj)}")
    return 0


def cmd_describe(client: RESTStore, args) -> int:
    kind = _kind(args.resource)
    try:
        obj = client.get(kind, _key(kind, args.name, args.namespace))
    except NotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(encode(obj), indent=2))
    return 0


def _load_manifests(path: str) -> list[dict]:
    """The documents of a YAML manifest; without PyYAML, a JSON manifest
    of one document (JSON is YAML's subset: the same result)."""
    source = sys.stdin if path == "-" else open(path)
    with source if path != "-" else sys.stdin as f:
        try:
            import yaml
        except ImportError:
            return [d for d in [json.load(f)] if d]
        return [d for d in yaml.safe_load_all(f) if d]


def cmd_apply(client: RESTStore, args) -> int:
    """Server-side apply under the "kubectl" field manager (the reference's
    kubectl --server-side path): per-field ownership, conflict detection
    (--force-conflicts transfers), dropped fields removed."""
    from ..client.rest import ApplyConflictError
    from ..store.store import ConflictError

    force = getattr(args, "force_conflicts", False)
    for doc in _load_manifests(args.filename):
        obj = decode(doc)  # decode validates the manifest + resolves keys
        try:
            # a plain Conflict is a CAS race against a concurrent writer:
            # retry (the reference's patch handler retries internally); a
            # FieldManagerConflict is ownership and needs --force-conflicts
            for attempt in range(3):
                try:
                    client.apply(obj.kind, obj.meta.key, doc, "kubectl",
                                 force=force)
                    break
                except ApplyConflictError:
                    raise
                except ConflictError:
                    if attempt == 2:
                        raise
        except ApplyConflictError as e:
            print(f"Error: {e}\nhint: --force-conflicts transfers ownership",
                  file=sys.stderr)
            return 1
        except ConflictError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        print(f"{obj.kind.lower()}/{obj.meta.name} "
              f"{'created' if client.last_apply_created else 'configured'}")
    return 0


def cmd_create(client: RESTStore, args) -> int:
    for doc in _load_manifests(args.filename):
        obj = decode(doc)
        client.create(obj)
        print(f"{obj.kind.lower()}/{obj.meta.name} created")
    return 0


def cmd_delete(client: RESTStore, args) -> int:
    kind = _kind(args.resource)
    try:
        client.delete(kind, _key(kind, args.name, args.namespace))
        print(f"{kind.lower()}/{args.name} deleted")
        return 0
    except NotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


def cmd_scale(client: RESTStore, args) -> int:
    kind = _kind(args.resource)
    obj = client.get(kind, _key(kind, args.name, args.namespace))
    obj.spec.replicas = args.replicas
    client.update(obj, check_version=False)
    print(f"{kind.lower()}/{args.name} scaled to {args.replicas}")
    return 0


def cmd_cordon(client: RESTStore, args, unschedulable: bool = True) -> int:
    node = client.get("Node", args.name)
    node.spec.unschedulable = unschedulable
    client.update(node, check_version=False)
    print(f"node/{args.name} {'cordoned' if unschedulable else 'uncordoned'}")
    return 0


def cmd_patch(client: RESTStore, args) -> int:
    kind = _kind(args.resource)
    try:
        patch = json.loads(args.patch)
    except json.JSONDecodeError as e:
        print(f"Error: invalid patch JSON: {e}", file=sys.stderr)
        return 1
    try:
        client.patch(kind, _key(kind, args.name, args.namespace), patch)
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"{kind.lower()}/{args.name} patched")
    return 0


def cmd_logs(client: RESTStore, args) -> int:
    """kubectl logs: the pods/log subresource (apiserver proxies to the
    pod's kubelet /containerLogs endpoint)."""
    try:
        sys.stdout.write(client.pod_logs(
            _key("Pod", args.name, args.namespace),
            container=args.container, tail_lines=args.tail,
        ))
        return 0
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"Error: {e}", file=sys.stderr)
        return 1


def cmd_drain(client: RESTStore, args) -> int:
    """kubectl drain: cordon, then evict every pod on the node, honoring
    PodDisruptionBudgets (staging/.../kubectl/pkg/drain): an eviction that
    would take a PDB below its budget is refused and retried; --force
    overrides for pods with no budget room after the grace rounds."""
    cmd_cordon(client, args, True)
    import time as _time

    deadline = _time.monotonic() + args.timeout
    warned_ds = False
    while True:
        pods = [p for p in client.pods() if p.spec.node_name == args.name]
        # DaemonSet pods tolerate the cordon taint and would be re-minted
        # onto this node forever — real kubectl ignores them for the same
        # reason (--ignore-daemonsets is effectively mandatory)
        ds_pods = [p for p in pods if any(
            r.kind == "DaemonSet" and r.controller
            for r in p.meta.owner_references
        )]
        if ds_pods and not warned_ds:
            warned_ds = True
            for p in ds_pods:
                print(f"ignoring DaemonSet-managed pod {p.meta.key}")
        pods = [p for p in pods if p not in ds_pods]
        if not pods:
            print(f"node/{args.name} drained")
            return 0
        pdbs = list(client.iter_kind("PodDisruptionBudget"))  # once per round
        blocked = []
        for pod in pods:
            pdb = _pdb_for(pdbs, pod)
            if pdb is not None and not _consume_disruption(client, pdb, pod):
                blocked.append(pod.meta.key)
                continue
            client.delete("Pod", pod.meta.key)
            print(f"evicting pod {pod.meta.key}")
        if _time.monotonic() >= deadline:
            if blocked and args.force:
                for key in blocked:
                    client.delete("Pod", key)
                    print(f"evicting pod {key} (forced)")
                continue
            if blocked:
                print(f"error: cannot evict {len(blocked)} pod(s) "
                      f"(PodDisruptionBudget), use --force to override")
                return 1
            print(f"error: node/{args.name} still has pods after "
                  f"{args.timeout}s")
            return 1
        _time.sleep(args.poll)


def _pdb_for(pdbs, pod):
    from ..api.labels import matches_selector

    for pdb in pdbs:
        if pdb.meta.namespace != pod.meta.namespace:
            continue
        sel = pdb.spec.selector
        if sel is not None and matches_selector(sel, pod.meta.labels):
            return pdb
    return None


def _consume_disruption(client: RESTStore, pdb, pod, retries: int = 3) -> bool:
    """Atomically take one disruption from the budget: versioned
    compare-and-swap with retry, so concurrent drains (or the disruption
    controller) can't both spend the last allowed disruption — the
    client-side analogue of the server-side Eviction subresource."""
    import time as _time

    from ..store.store import ConflictError

    for _ in range(retries):
        if pdb.status.disruptions_allowed <= 0:
            return False
        pdb.status.disruptions_allowed -= 1
        pdb.status.disrupted_pods[pod.meta.name] = _time.time()
        try:
            client.update(pdb)  # CAS on resourceVersion
            return True
        except ConflictError:
            pdb = client.get("PodDisruptionBudget", pdb.meta.key)
    return False


def cmd_rollout(client: RESTStore, args) -> int:
    """kubectl rollout status|history|undo for Deployments
    (staging/.../kubectl/pkg/polymorphichelpers + rollback.go): revisions
    live on the owned ReplicaSets' deployment.kubernetes.io/revision
    annotations; undo copies a past revision's template back into the
    deployment spec (minus the pod-template-hash label)."""
    import time as _time

    kind = _kind(args.resource)
    if kind != "Deployment":
        print("error: rollout supports deployments", file=sys.stderr)
        return 1
    key = _key(kind, args.name, args.namespace)
    dep = client.get(kind, key)
    rs_list = [
        rs for rs in client.iter_kind("ReplicaSet")
        if rs.meta.namespace == dep.meta.namespace
        and any(r.kind == "Deployment" and r.name == dep.meta.name
                and r.controller for r in rs.meta.owner_references)
    ]
    rev_key = "deployment.kubernetes.io/revision"
    by_rev = {int(rs.meta.annotations.get(rev_key, 0)): rs for rs in rs_list}

    if args.action in ("pause", "resume"):
        dep.spec.paused = args.action == "pause"
        client.update(dep, check_version=False)
        print(f"deployment/{args.name} {args.action}d")
        return 0

    if args.action == "history":
        for rev in sorted(by_rev):
            rs = by_rev[rev]
            print(f"{rev}\t{rs.meta.name}\treplicas={rs.spec.replicas}")
        return 0

    if args.action == "status":
        deadline = _time.monotonic() + args.timeout
        while _time.monotonic() < deadline:
            dep = client.get(kind, key)
            if (dep.status.ready_replicas >= dep.spec.replicas
                    and dep.status.updated_replicas >= dep.spec.replicas):
                print(f'deployment "{args.name}" successfully rolled out')
                return 0
            _time.sleep(args.poll)
        print(f'error: deployment "{args.name}" not rolled out: '
              f"{dep.status.ready_replicas}/{dep.spec.replicas} ready",
              file=sys.stderr)
        return 1

    if args.action == "undo":
        current = int(dep.meta.annotations.get(rev_key, 0))
        target_rev = args.to_revision or max(
            (r for r in by_rev if r != current), default=0
        )
        if target_rev not in by_rev:
            print(f"error: revision {target_rev} not found", file=sys.stderr)
            return 1
        rs = by_rev[target_rev]
        template = rs.spec.template
        labels = {k: v for k, v in template.labels.items()
                  if k != "pod-template-hash"}
        dep.spec.template = type(template)(labels=labels, spec=template.spec)
        client.update(dep, check_version=False)
        print(f"deployment/{args.name} rolled back to revision {target_rev}")
        return 0

    print(f"error: unknown rollout action {args.action}", file=sys.stderr)
    return 1


def cmd_top(client: RESTStore, args) -> int:
    """kubectl top pods/nodes — the metrics.k8s.io view (PodMetrics
    published by kubelets)."""
    kind = _kind(args.resource)
    if kind == "Pod":
        metrics, _ = client.list("PodMetrics")
        print("NAME\tCPU(m)\tMEMORY(Mi)")
        for m in sorted(metrics, key=lambda m: m.meta.key):
            if not args.all_namespaces and m.meta.namespace != args.namespace:
                continue
            print(f"{m.meta.name}\t{m.cpu_usage_milli}m\t"
                  f"{m.memory_usage_bytes >> 20}Mi")
        return 0
    if kind == "Node":
        metrics, _ = client.list("PodMetrics")
        pods, _ = client.list("Pod")
        node_of = {p.meta.key: p.spec.node_name for p in pods}
        by_node: dict[str, list] = {}
        for m in metrics:
            node = node_of.get(m.meta.key)
            if node:
                by_node.setdefault(node, []).append(m)
        print("NAME\tCPU(m)\tMEMORY(Mi)")
        for node in sorted(n.meta.name for n in client.nodes()):
            ms = by_node.get(node, [])
            cpu = sum(m.cpu_usage_milli for m in ms)
            mem = sum(m.memory_usage_bytes for m in ms)
            print(f"{node}\t{cpu}m\t{mem >> 20}Mi")
        return 0
    print(f"error: top supports pods/nodes, not {args.resource}",
          file=sys.stderr)
    return 1


def cmd_events(client: RESTStore, args) -> int:
    """kubectl get events — the Scheduled/FailedScheduling stream."""
    events = sorted(client.iter_kind("Event"),
                    key=lambda e: getattr(e, "last_timestamp", 0))
    for ev in events:
        if not args.all_namespaces and ev.meta.namespace != args.namespace:
            continue
        print(f"{ev.type}\t{ev.reason}\t{ev.involved_object}\t"
              f"{ev.message}\t{getattr(ev, 'count', 1)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kubectl-tpu")
    parser.add_argument("--server", "-s", default=DEFAULT_SERVER)
    parser.add_argument("--cacert", default=None,
                        help="CA bundle for an https:// server")
    parser.add_argument("--namespace", "-n", default="default")
    sub = parser.add_subparsers(dest="verb", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?")
    g.add_argument("-o", "--output", choices=["wide", "json"], default="wide")
    g.add_argument("-A", "--all-namespaces", action="store_true")

    d = sub.add_parser("describe")
    d.add_argument("resource")
    d.add_argument("name")

    for verb in ("apply", "create"):
        a = sub.add_parser(verb)
        a.add_argument("-f", "--filename", required=True)
        if verb == "apply":
            a.add_argument("--force-conflicts", action="store_true",
                           dest="force_conflicts")

    rm = sub.add_parser("delete")
    rm.add_argument("resource")
    rm.add_argument("name")

    sc = sub.add_parser("scale")
    sc.add_argument("resource")
    sc.add_argument("name")
    sc.add_argument("--replicas", type=int, required=True)

    for verb in ("cordon", "uncordon"):
        c = sub.add_parser(verb)
        c.add_argument("name")

    dr = sub.add_parser("drain")
    dr.add_argument("name")
    dr.add_argument("--force", action="store_true")
    dr.add_argument("--timeout", type=float, default=5.0)
    dr.add_argument("--poll", type=float, default=0.1)

    ev = sub.add_parser("events")
    ev.add_argument("-A", "--all-namespaces", action="store_true")

    tp = sub.add_parser("top")
    tp.add_argument("resource")
    tp.add_argument("-A", "--all-namespaces", action="store_true")

    pt = sub.add_parser("patch")
    pt.add_argument("resource")
    pt.add_argument("name")
    pt.add_argument("-p", "--patch", required=True,
                    help="JSON merge patch (RFC 7386)")

    lg = sub.add_parser("logs")
    lg.add_argument("name")
    lg.add_argument("-c", "--container", default="")
    lg.add_argument("--tail", type=int, default=None)

    ro = sub.add_parser("rollout")
    ro.add_argument("action",
                    choices=["status", "history", "undo", "pause", "resume"])
    ro.add_argument("resource")
    ro.add_argument("name")
    ro.add_argument("--to-revision", type=int, default=0)
    ro.add_argument("--timeout", type=float, default=10.0)
    ro.add_argument("--poll", type=float, default=0.05)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    client = RESTStore(args.server,
                       ca_cert=getattr(args, 'cacert', None))
    verbs = {
        "get": cmd_get,
        "describe": cmd_describe,
        "apply": cmd_apply,
        "create": cmd_create,
        "delete": cmd_delete,
        "scale": cmd_scale,
        "cordon": lambda c, a: cmd_cordon(c, a, True),
        "uncordon": lambda c, a: cmd_cordon(c, a, False),
        "drain": cmd_drain,
        "events": cmd_events,
        "top": cmd_top,
        "rollout": cmd_rollout,
        "logs": cmd_logs,
        "patch": cmd_patch,
    }
    return verbs[args.verb](client, args)


if __name__ == "__main__":
    raise SystemExit(main())
