"""Server-side apply subset: managedFields tracking + conflict detection.

Reference: staging/src/k8s.io/apiserver/pkg/endpoints/handlers/fieldmanager
— every applied configuration records the field set it owns in
metadata.managedFields; a second applier touching a field owned by a
different manager gets a 409 conflict naming the owner, unless it forces
(which transfers ownership); fields a manager previously owned but dropped
from its configuration are REMOVED from the object (the semantic that
distinguishes apply from a merge patch).

Associative lists (structured-merge-diff listType=map): the list fields
the reference keys — containers/initContainers/volumes/env by `name`,
ports by `container_port`, tolerations by `key` — merge BY ELEMENT.  An
element's paths are rooted at `<list>/k=<key-value>` (the fieldsV1
`k:{...}` convention), so two appliers owning different containers of one
pod never conflict, and dropping an element removes it without touching
its siblings.  Merge-key leaves (`.../k=X/name`) are element identity, not
content: co-owning them is never a conflict (every applier of an element
must state its key).

Subset notes (vs the reference's full set-theoretic fieldsV1):
- a list field is treated as keyed only when every element is a dict
  carrying the key field (a CRD's free-form `ports: [80, 443]` stays
  atomic); keys are matched by FIELD NAME, the reference's effective
  patchMergeKey convention
- ownership is tracked for Apply operations; plain updates don't record
  per-field ownership (their writes win CAS like any update)
- the wire trigger is the `fieldManager` query parameter on PATCH (the
  reference keys on the application/apply-patch+yaml content type; this
  server's content type is owned by the json/cbor wire negotiation)

A copy of the reference package's module
(kubernetes_tpu/apiserver/apply.py).
"""

from __future__ import annotations

# identity/system metadata never owned by an applier
_META_SYSTEM = {"name", "namespace", "uid", "resource_version", "generation",
                "creation_timestamp", "deletion_timestamp", "managed_fields"}

# list FIELD NAME -> merge key (the reference's patchMergeKey tags:
# staging/src/k8s.io/api/core/v1/types.go Container/Volume/EnvVar `name`,
# ContainerPort `containerPort`, Toleration `key`)
_LIST_FIELD_KEYS = {
    "containers": "name",
    "init_containers": "name",
    "volumes": "name",
    "env": "name",
    "ports": "container_port",
    "tolerations": "key",
}


class ApplyConflict(Exception):
    def __init__(self, conflicts: list[tuple[str, str]]):
        self.conflicts = conflicts
        msg = "; ".join(
            f'field "{path}" is owned by manager {mgr!r}'
            for path, mgr in conflicts
        )
        super().__init__(
            f"Apply failed with {len(conflicts)} conflict(s): {msg}"
        )


def _escape(key: str) -> str:
    """RFC 6901 token escaping — map keys routinely contain '.' and '/'
    (app.kubernetes.io/name), so neither can be the raw separator."""
    return key.replace("~", "~0").replace("/", "~1")


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def _list_key_field(field_name: str, value) -> str | None:
    """The merge key for a list VALUE under `field_name`, or None when the
    list is atomic (unknown field, empty, or elements without the key)."""
    key = _LIST_FIELD_KEYS.get(field_name)
    if key is None or not isinstance(value, (list, tuple)) or not value:
        return None
    if all(isinstance(e, dict) and e.get(key) is not None for e in value):
        return key
    return None


def field_paths(doc: dict, prefix: str = "") -> set[str]:
    """'/'-joined, RFC 6901-escaped leaf paths of an applied configuration.
    Keyed-list elements contribute their leaves under `<list>/k=<value>`;
    atomic lists are leaves; identity/system metadata and the kind tag are
    excluded."""
    out: set[str] = set()
    for k, v in doc.items():
        if prefix == "" and k in ("kind", "apiVersion"):
            continue
        if prefix == "meta" and k in _META_SYSTEM:
            continue
        path = f"{prefix}/{_escape(k)}" if prefix else _escape(k)
        if isinstance(v, dict) and v:
            # dict recursion stays here so the meta-system exclusions apply
            out |= field_paths(v, path)
        else:
            out |= _value_paths(k, v, path)
    return out


def _value_paths(field_name: str, v, path: str) -> set[str]:
    if isinstance(v, dict):
        if not v:
            return {path}
        out: set[str] = set()
        for k2, v2 in v.items():
            out |= _value_paths(k2, v2, f"{path}/{_escape(k2)}")
        return out
    key = _list_key_field(field_name, v)
    if key is not None:
        out = set()
        for e in v:
            ep = f"{path}/k={_escape(str(e[key]))}"
            sub: set[str] = set()
            for k2, v2 in e.items():
                sub |= _value_paths(k2, v2, f"{ep}/{_escape(k2)}")
            out |= sub or {ep}
        return out
    return {path}


def _walk(doc, parts: list[str], field_name: str = ""):
    """Walk escaped path segments over dicts and keyed lists; returns the
    node or a _MISSING sentinel."""
    node = doc
    for p in parts:
        if p.startswith("k=") and isinstance(node, (list, tuple)):
            kf = _LIST_FIELD_KEYS.get(field_name)
            want = _unescape(p[2:])
            node = next(
                (e for e in node
                 if isinstance(e, dict) and str(e.get(kf)) == want),
                _MISSING,
            )
        elif isinstance(node, dict):
            k = _unescape(p)
            node = node[k] if k in node else _MISSING
            field_name = k
        else:
            return _MISSING
        if node is _MISSING:
            return _MISSING
    return node


_MISSING = object()


def _get_path(doc: dict, path: str) -> tuple:
    """(value, present) at an RFC 6901-escaped '/' path (k= aware)."""
    node = _walk(doc, path.split("/"))
    return (None, False) if node is _MISSING else (node, True)


def _delete_path(doc: dict, path: str) -> None:
    parts = path.split("/")
    # parent field name for keyed-element resolution of the LEAF
    parent_field = ""
    for p in reversed(parts[:-1]):
        if not p.startswith("k="):
            parent_field = _unescape(p)
            break
    node = _walk(doc, parts[:-1])
    if node is _MISSING:
        return
    leaf = parts[-1]
    if leaf.startswith("k=") and isinstance(node, list):
        kf = _LIST_FIELD_KEYS.get(parent_field)
        want = _unescape(leaf[2:])
        node[:] = [e for e in node
                   if not (isinstance(e, dict) and str(e.get(kf)) == want)]
    elif isinstance(node, dict):
        node.pop(_unescape(leaf), None)


def _merge(base, delta, field_name: str = ""):
    """Recursive merge: dicts merge per key, keyed lists merge per element
    (base order kept, new elements appended in applied order), everything
    else replaces (atomic)."""
    key = _list_key_field(field_name, delta)
    if (key is not None and isinstance(base, (list, tuple))
            and all(isinstance(e, dict) and e.get(key) is not None
                    for e in base)):
        # STRINGIFIED keys, exactly like field_paths/_walk build k= paths:
        # a YAML-quoted "80" and an int 80 must address the same element
        # for ownership tracking and merging alike
        delta_by_key = {str(e[key]): e for e in delta}
        base_keys = {str(b[key]) for b in base}
        out = [
            _merge(b, delta_by_key[str(b[key])])
            if str(b[key]) in delta_by_key else b
            for b in base
        ]
        out.extend(e for e in delta if str(e[key]) not in base_keys)
        return out
    if not isinstance(delta, dict) or not isinstance(base, dict):
        return delta
    out = dict(base)
    for k, v in delta.items():
        out[k] = _merge(out.get(k), v, k)
    return out


def _is_merge_key_leaf(path: str) -> bool:
    """Is this path a keyed element's identity field (`.../<list>/k=X/<kf>`)?
    Identity is shared by every applier of the element — never contested."""
    parts = path.split("/")
    if len(parts) < 3 or not parts[-2].startswith("k="):
        return False
    kf = _LIST_FIELD_KEYS.get(_unescape(parts[-3]))
    return kf is not None and _unescape(parts[-1]) == kf


def _element_prefixes(path: str) -> list[str]:
    """Every keyed-element prefix along a path (`a/b/k=X` for each k=)."""
    parts = path.split("/")
    return ["/".join(parts[: j + 1])
            for j, p in enumerate(parts) if p.startswith("k=")]


def apply_doc(stored: dict | None, applied: dict, manager: str,
              force: bool = False) -> dict:
    """FieldManager.Apply: returns the merged wire document with updated
    metadata.managed_fields; raises ApplyConflict on unforced conflicts."""
    new_paths = field_paths(applied)
    meta = (stored or {}).get("meta") or {}
    mf: list[dict] = [dict(e) for e in (meta.get("managed_fields") or ())]

    # Prefix (ancestor/descendant) overlap is a conflict only when it would
    # CLOBBER — an atomic (non-dict) value replacing the other side's
    # subtree.  An empty-map leaf over another's children merges harmlessly
    # (and is how a manager retreats from a map while others keep children).
    # Only atomic new paths can clobber downward, so the prefix scan is
    # restricted to them; exact matches use a set intersection so the
    # common (no-overlap) case stays O(n).
    atomic_new = sorted(
        p for p in new_paths
        if not isinstance(_get_path(applied, p)[0], dict)
    )
    new_sorted = sorted(new_paths)

    def _stored_atomic(o: str) -> bool:
        val, ok = _get_path(stored or {}, o)
        return ok and not isinstance(val, dict)

    conflicts: list[tuple[str, str]] = []
    contested: dict[int, set[str]] = {}
    for i, entry in enumerate(mf):
        if entry.get("manager") == manager:
            continue
        owned = set(entry.get("fields") or ())
        pairs = [(p, p) for p in new_paths & owned
                 if not _is_merge_key_leaf(p)]
        # downward clobber: an atomic new value replaces o's whole subtree
        pairs += [(p, o) for p in atomic_new for o in owned
                  if o.startswith(p + "/")]
        # upward clobber: any new path landing UNDER an owned atomic value
        # replaces it with a dict (includes empty-map leaves)
        pairs += [(p, o) for p in new_sorted for o in owned
                  if p.startswith(o + "/") and _stored_atomic(o)]
        if pairs:
            contested[i] = {o for _, o in pairs}
            seen: set[str] = set()
            for p, _ in sorted(pairs):
                if p not in seen:
                    seen.add(p)
                    conflicts.append((p, entry["manager"]))
    if conflicts:
        if not force:
            raise ApplyConflict(conflicts)
        # force: ownership of the contested fields transfers to us
        for i, hit in contested.items():
            mf[i]["fields"] = sorted(
                set(mf[i].get("fields") or ()) - hit
            )

    prev = next((e for e in mf
                 if e.get("manager") == manager
                 and e.get("operation") == "Apply"), None)
    merged = _merge(dict(stored or {}), applied)

    # fields we owned but dropped from the configuration are removed —
    # unless some other manager still owns them or anything UNDER them
    # (an empty-dict leaf like "spec/affinity" must not take another
    # manager's "spec/affinity/zone" down with it)
    if prev is not None:
        others: set[str] = set()
        for entry in mf:
            if entry is not prev:
                others |= set(entry.get("fields") or ())
        # our own new paths are protected too: reshaping an owned atomic
        # path into a dict ("spec/affinity": "none" -> {"zone": ...}) drops
        # the old leaf from our set while the new config lives UNDER it —
        # deleting the ancestor would wipe the configuration just applied
        protected = others | new_paths
        emptied: set[str] = set()
        for path in sorted(set(prev.get("fields") or ()) - new_paths):
            subtree = path + "/"
            if path in protected or any(
                o.startswith(subtree) for o in protected
            ):
                continue
            if _is_merge_key_leaf(path):
                # the element's identity survives as long as ANY manager
                # keeps content in the element; with nothing protected the
                # WHOLE element goes (dropping just the key first would
                # make the element unaddressable for later deletions)
                elem = path.rsplit("/", 1)[0]
                if any(o.startswith(elem + "/") for o in protected):
                    continue
                _delete_path(merged, elem)
                continue
            _delete_path(merged, path)
            emptied.update(_element_prefixes(path))
        # only the SPECIFIC elements whose leaves we just deleted are
        # swept when fully emptied — a user's literal {} in an atomic list
        # is data, not debris (deepest first so nested empties collapse)
        for ep in sorted(emptied, key=len, reverse=True):
            val, ok = _get_path(merged, ep)
            if ok and val == {}:
                _delete_path(merged, ep)

    mf = [e for e in mf
          if not (e.get("manager") == manager
                  and e.get("operation") == "Apply")]
    mf = [e for e in mf if e.get("fields")]  # drop fully-transferred entries
    mf.append({"manager": manager, "operation": "Apply",
               "fields": sorted(new_paths)})
    merged.setdefault("meta", {})["managed_fields"] = mf
    return merged
