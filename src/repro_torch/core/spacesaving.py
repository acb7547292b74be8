"""SpaceSaving, Lazy SpaceSaving± and SpaceSaving± — exact reference impls.

These are the paper's algorithms (Algs 1-4) on the paper's low-latency
structure (§3.6): a min-heap on counts + a max-heap on estimated errors +
a dictionary (inside IndexedHeap) mapping items to heap slots.

The port's own copy of ``repro/core/spacesaving.py``: plain Python on
the host, the oracle the benchmarks hold the port's banks and kernels to,
and the subject of the paper-fidelity tests (including the worked
examples of §3.3 and §3.5). ``process`` takes the reference's (item,
±1) updates or the port's (N, 2) stream arrays
(``core/streams.bounded_stream``).
"""
from __future__ import annotations

import math
from typing import Dict, Hashable, Iterable, List, Tuple

import numpy as np

from .heaps import IndexedHeap
from .streams import Update


class SpaceSaving:
    """Insertion-only SpaceSaving [Metwally, Agrawal, El Abbadi '05], Alg 1+2.

    k = ceil(1/eps) counters solve l1 frequency estimation (error < eps*I,
    Lemma 5) and the phi-frequent-items problem (Lemmas 2+3).
    """

    deterministic = True
    model = "insertion-only"

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.counts = IndexedHeap(sign=+1)  # min-heap on estimated counts
        self.errors = IndexedHeap(sign=-1)  # max-heap on estimated errors
        self._n_insert = 0
        self._n_delete = 0

    # -- core ops -----------------------------------------------------------
    def insert(self, item: Hashable) -> None:
        self._n_insert += 1
        counts, errors = self.counts, self.errors
        if item in counts:
            counts.update_key(item, counts.key_of(item) + 1)
        elif len(counts) < self.capacity:
            counts.push(item, 1)
            errors.push(item, 0)
        else:
            min_item, min_count = counts.peek()
            counts.replace_top(item, min_count + 1)
            errors.remove(min_item)
            errors.push(item, min_count)

    def delete(self, item: Hashable) -> None:
        raise NotImplementedError(
            "plain SpaceSaving is insertion-only; use LazySpaceSavingPM or "
            "SpaceSavingPM in the bounded-deletion model"
        )

    # -- weighted extension (Berinde et al.; preserves Lemmas 1-5) ----------
    def insert_weighted(self, item: Hashable, w: int) -> None:
        if w <= 0:
            raise ValueError("w must be positive")
        self._n_insert += w
        counts, errors = self.counts, self.errors
        if item in counts:
            counts.update_key(item, counts.key_of(item) + w)
        elif len(counts) < self.capacity:
            counts.push(item, w)
            errors.push(item, 0)
        else:
            min_item, min_count = counts.peek()
            counts.replace_top(item, min_count + w)
            errors.remove(min_item)
            errors.push(item, min_count)

    def delete_weighted(self, item: Hashable, w: int) -> None:
        for _ in range(w):
            self.delete(item)

    def update(self, item: Hashable, sign: int) -> None:
        if sign > 0:
            self.insert(item)
        else:
            self.delete(item)

    def process(self, stream: Iterable[Update]) -> "SpaceSaving":
        for item, sign in stream:
            # numpy scalars -> python ints for dict-key stability; leave
            # other hashables (e.g. strings in the paper's examples) alone.
            if isinstance(item, (int, np.integer)):
                item = int(item)
            self.update(item, int(sign))
        return self

    # -- queries (Alg 2) ----------------------------------------------------
    def query(self, item: Hashable) -> int:
        return int(self.counts.key_of(item)) if item in self.counts else 0

    def error_of(self, item: Hashable) -> int:
        return int(self.errors.key_of(item)) if item in self.errors else 0

    def __contains__(self, item: Hashable) -> bool:
        return item in self.counts

    def __len__(self) -> int:
        return len(self.counts)

    @property
    def min_count(self) -> int:
        return int(self.counts.peek()[1]) if len(self.counts) else 0

    @property
    def max_error(self) -> int:
        return int(self.errors.peek()[1]) if len(self.errors) else 0

    @property
    def n_insert(self) -> int:
        return self._n_insert

    @property
    def n_delete(self) -> int:
        return self._n_delete

    def entries(self) -> List[Tuple[Hashable, int, int]]:
        """(item, count, error) triples — the paper's tuple notation."""
        return [
            (it, int(self.counts.key_of(it)), int(self.errors.key_of(it)))
            for it in self.counts.pos
        ]

    def frequent_items(self, threshold: float) -> set:
        """Report every monitored item with estimated frequency >= threshold."""
        return {it for it, c, _ in self.entries() if c >= threshold}

    def guaranteed_frequent_items(self) -> set:
        """Items that are *certainly* frequent: count - error still >= 0 lower
        bound; for SS± Thm 5 recall-guaranteed set is everything with f̂>0."""
        return {it for it, c, e in self.entries() if c > 0}

    # -- mergeability (Agarwal et al. '12 style) ----------------------------
    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Merge two summaries into a new one with the same capacity.

        For items monitored in both: counts and errors add. For items in only
        one summary, the other summary bounds its unseen frequency by its
        minCount (Lemma 3), which is added to both count and error.
        Keeps the top-`capacity` items by merged count.

        Preserves: count(x) >= f(x) (no underestimation for the
        insertion-only / lazy variants) and error additivity.
        """
        cls = type(self)
        m1, m2 = self.min_count if len(self) == self.capacity else 0, (
            other.min_count if len(other) == other.capacity else 0
        )
        merged: Dict[Hashable, Tuple[int, int]] = {}
        e1 = {it: (c, e) for it, c, e in self.entries()}
        e2 = {it: (c, e) for it, c, e in other.entries()}
        for it in set(e1) | set(e2):
            c1, err1 = e1.get(it, (m1, m1))
            c2, err2 = e2.get(it, (m2, m2))
            merged[it] = (c1 + c2, err1 + err2)
        top = sorted(merged.items(), key=lambda kv: -kv[1][0])[: self.capacity]
        out = cls(self.capacity)
        # push directly (bypasses insert) to set exact (count,error) pairs
        for it, (c, e) in top:
            out.counts.push(it, c)
            out.errors.push(it, e)
        out._n_insert = self._n_insert + other._n_insert
        out._n_delete = self._n_delete + other._n_delete
        return out


class LazySpaceSavingPM(SpaceSaving):
    """Lazy SpaceSaving± (paper Alg 3).

    capacity = ceil(alpha/eps): error < eps*(I-D) (Thm 2), never
    underestimates monitored items (Lemma 6), solves frequent items (Thm 3).
    Deletions of unmonitored items are ignored.
    """

    model = "bounded-deletion"

    def delete(self, item: Hashable) -> None:
        self._n_delete += 1
        if item in self.counts:
            self.counts.update_key(item, self.counts.key_of(item) - 1)
        # else: ignore (lazy)

    def delete_weighted(self, item: Hashable, w: int) -> None:
        self._n_delete += w
        if item in self.counts:
            self.counts.update_key(item, self.counts.key_of(item) - w)


class SpaceSavingPM(SpaceSaving):
    """SpaceSaving± (paper Alg 4).

    capacity = ceil(2*alpha/eps) for the Thm 4 bound |f - f̂| < eps*(I-D).
    A deletion of an unmonitored item decrements the (count, error) of the
    max-estimated-error item; the estimation may then be an under-estimate,
    but never by more than eps/2*(I-D) (Thm 4), and reporting all items with
    f̂ > 0 yields full recall (Thm 5).
    """

    model = "bounded-deletion"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.unaccounted_deletions = 0  # only non-zero on non-strict streams

    def delete(self, item: Hashable) -> None:
        self._n_delete += 1
        counts, errors = self.counts, self.errors
        if item in counts:
            counts.update_key(item, counts.key_of(item) - 1)
            return
        if len(errors) == 0:
            self.unaccounted_deletions += 1
            return
        j, max_err = errors.peek()
        if max_err <= 0:
            # Lemma 9 guarantees max_err >= 1 on strict bounded-deletion
            # streams; only reachable if the input violates strictness.
            self.unaccounted_deletions += 1
            return
        errors.update_key(j, max_err - 1)
        counts.update_key(j, counts.key_of(j) - 1)

    def delete_weighted(self, item: Hashable, w: int) -> None:
        """Weighted deletion: monitored -> subtract w; unmonitored -> spread
        across max-error items (each absorbs up to its estimated error,
        keeping errors >= 0 as Lemma 9 requires of the unit-update case)."""
        counts, errors = self.counts, self.errors
        self._n_delete += w
        if item in counts:
            counts.update_key(item, counts.key_of(item) - w)
            return
        remaining = w
        while remaining > 0 and len(errors):
            j, max_err = errors.peek()
            if max_err <= 0:
                break
            d = min(remaining, int(max_err))
            errors.update_key(j, max_err - d)
            counts.update_key(j, counts.key_of(j) - d)
            remaining -= d
        self.unaccounted_deletions += remaining


def make_sketch(kind: str, capacity: int) -> SpaceSaving:
    kind = kind.lower()
    if kind in ("spacesaving", "ss"):
        return SpaceSaving(capacity)
    if kind in ("lazy", "lazy_ss_pm", "lazyspacesavingpm"):
        return LazySpaceSavingPM(capacity)
    if kind in ("ss_pm", "sspm", "spacesavingpm"):
        return SpaceSavingPM(capacity)
    raise ValueError(f"unknown sketch kind {kind!r}")


def capacity_for(eps: float, alpha: float = 1.0, variant: str = "ss_pm") -> int:
    """Paper-prescribed capacities: alpha/eps (lazy, Thm 2/3) or
    2*alpha/eps (SS±, Thm 4/5)."""
    if variant in ("lazy", "spacesaving", "ss"):
        return math.ceil(alpha / eps)
    return math.ceil(2.0 * alpha / eps)


__all__ = ["SpaceSaving", "LazySpaceSavingPM", "SpaceSavingPM",
           "make_sketch", "capacity_for"]
