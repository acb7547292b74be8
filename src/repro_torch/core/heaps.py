"""Indexed binary heaps with position tracking (paper §3.6, Figure 3).

The port's own copy of ``repro/core/heaps.py`` (plain Python, host side):
the structure the oracles of ``core/spacesaving.py`` run on.

The paper's low-latency SpaceSaving± implementation keeps the estimated
counts in a *min*-heap and the estimated errors in a *max*-heap, with a
dictionary mapping each item to its node in both heaps so that
increase/decrease-key run in O(log k) and peeking minCount / maxError is O(1).

``IndexedHeap`` is a single implementation parameterized by sign; the
dictionary lives here as ``pos`` (item -> slot in the heap array).
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Tuple


class IndexedHeap:
    """Binary heap over (key, item) with O(1) item->slot lookup.

    sign=+1 -> min-heap, sign=-1 -> max-heap. Keys are numbers.
    """

    __slots__ = ("sign", "_keys", "_items", "pos")

    def __init__(self, sign: int = 1):
        if sign not in (1, -1):
            raise ValueError(f"sign must be +1 or -1, got {sign!r}")
        self.sign = sign
        self._keys: List[float] = []
        self._items: List[Hashable] = []
        self.pos: Dict[Hashable, int] = {}

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, item: Hashable) -> bool:
        return item in self.pos

    def key_of(self, item: Hashable) -> float:
        return self.sign * self._keys[self.pos[item]]

    def peek(self) -> Tuple[Hashable, float]:
        """Top item and its key (min for sign=+1, max for sign=-1)."""
        return self._items[0], self.sign * self._keys[0]

    def push(self, item: Hashable, key: float) -> None:
        if item in self.pos:
            raise KeyError(f"duplicate push of {item!r}")
        self._keys.append(self.sign * key)
        self._items.append(item)
        self.pos[item] = len(self._keys) - 1
        self._sift_up(len(self._keys) - 1)

    def update_key(self, item: Hashable, key: float) -> None:
        i = self.pos[item]
        old = self._keys[i]
        new = self.sign * key
        self._keys[i] = new
        if new < old:
            self._sift_up(i)
        elif new > old:
            self._sift_down(i)

    def remove(self, item: Hashable) -> None:
        i = self.pos.pop(item)
        last = len(self._keys) - 1
        if i != last:
            self._keys[i] = self._keys[last]
            self._items[i] = self._items[last]
            self.pos[self._items[i]] = i
        self._keys.pop()
        self._items.pop()
        if i <= last - 1 and self._keys:
            self._sift_up(i)
            self._sift_down(i)

    def replace_top(self, item: Hashable, key: float) -> Hashable:
        """Pop the top element and push (item, key) in one O(log k) pass."""
        old_item = self._items[0]
        del self.pos[old_item]
        self._keys[0] = self.sign * key
        self._items[0] = item
        self.pos[item] = 0
        self._sift_down(0)
        return old_item

    # -- internals ---------------------------------------------------------
    def _sift_up(self, i: int) -> None:
        keys, items, pos = self._keys, self._items, self.pos
        k, it = keys[i], items[i]
        while i > 0:
            parent = (i - 1) >> 1
            if keys[parent] <= k:
                break
            keys[i], items[i] = keys[parent], items[parent]
            pos[items[i]] = i
            i = parent
        keys[i], items[i] = k, it
        pos[it] = i

    def _sift_down(self, i: int) -> None:
        keys, items, pos = self._keys, self._items, self.pos
        n = len(keys)
        k, it = keys[i], items[i]
        while True:
            child = 2 * i + 1
            if child >= n:
                break
            if child + 1 < n and keys[child + 1] < keys[child]:
                child += 1
            if keys[child] >= k:
                break
            keys[i], items[i] = keys[child], items[child]
            pos[items[i]] = i
            i = child
        keys[i], items[i] = k, it
        pos[it] = i

    def check_invariants(self) -> None:  # test helper
        for i in range(1, len(self._keys)):
            assert self._keys[(i - 1) >> 1] <= self._keys[i]
        for item, i in self.pos.items():
            assert self._items[i] == item


__all__ = ["IndexedHeap"]
