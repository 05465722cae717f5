"""Versioned state store + watch bus — the etcd/apiserver-storage equivalent.

Reference: staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go (CRUD with
revisions), watcher (event.go), and the watch cache. A copy of the reference
package's store (kubernetes_tpu/store/).
"""

from .store import (  # noqa: F401
    ADDED,
    DELETED,
    MODIFIED,
    AlreadyExistsError,
    ConflictError,
    Event,
    NotFoundError,
    Store,
)


def try_delete(store: Store, kind: str, key: str):
    """store.delete for objects that may already be gone (the reference
    store's try_delete; controller and kubelet delete races are benign):
    None instead of NotFoundError."""
    try:
        return store.delete(kind, key)
    except NotFoundError:
        return None


def iter_kind(store: Store, kind: str):
    """The objects of one kind, copies as Store.list gives them (the
    reference store's iter_kind; a RESTStore's list has the same shape)."""
    objs, _ = store.list(kind)
    return iter(objs)
