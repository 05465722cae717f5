"""Keyed binary heap: update/delete by key, peek/pop min.

Reference: pkg/scheduler/backend/heap/heap.go:133 — a heap whose items are
addressable by key so queue updates are O(log n) instead of rebuild. A
copy of the reference package's module (kubernetes_tpu/scheduler/queue/heap.py).
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class KeyedHeap(Generic[T]):
    def __init__(self, key_fn: Callable[[T], str], less_fn: Callable[[T, T], bool]):
        self._key = key_fn
        self._less = less_fn
        self._items: list[T] = []
        self._index: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def get(self, key: str) -> T | None:
        i = self._index.get(key)
        return self._items[i] if i is not None else None

    def add(self, item: T) -> None:
        """Insert or replace by key."""
        key = self._key(item)
        i = self._index.get(key)
        if i is not None:
            self._items[i] = item
            self._sift_up(i)
            self._sift_down(i)
        else:
            self._items.append(item)
            self._index[key] = len(self._items) - 1
            self._sift_up(len(self._items) - 1)

    def delete(self, key: str) -> T | None:
        i = self._index.get(key)
        if i is None:
            return None
        return self._remove_at(i)

    def peek(self) -> T | None:
        return self._items[0] if self._items else None

    def pop(self) -> T | None:
        if not self._items:
            return None
        return self._remove_at(0)

    def list(self) -> list[T]:
        return list(self._items)

    def keys(self) -> list[str]:
        return list(self._index.keys())

    # -- internals ----------------------------------------------------------

    def _remove_at(self, i: int) -> T:
        item = self._items[i]
        key = self._key(item)
        last = len(self._items) - 1
        if i != last:
            self._items[i] = self._items[last]
            self._index[self._key(self._items[i])] = i
        self._items.pop()
        del self._index[key]
        if i < len(self._items):
            self._sift_up(i)
            self._sift_down(i)
        return item

    def _swap(self, i: int, j: int) -> None:
        self._items[i], self._items[j] = self._items[j], self._items[i]
        self._index[self._key(self._items[i])] = i
        self._index[self._key(self._items[j])] = j

    def _sift_up(self, i: int) -> None:
        while i > 0:
            parent = (i - 1) // 2
            if self._less(self._items[i], self._items[parent]):
                self._swap(i, parent)
                i = parent
            else:
                break

    def _sift_down(self, i: int) -> None:
        n = len(self._items)
        while True:
            smallest = i
            for c in (2 * i + 1, 2 * i + 2):
                if c < n and self._less(self._items[c], self._items[smallest]):
                    smallest = c
            if smallest == i:
                return
            self._swap(i, smallest)
            i = smallest
