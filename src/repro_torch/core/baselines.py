"""Baseline sketches the paper compares against (§2.3-2.5, §5).

- MisraGries: deterministic insertion-only counter summary (MG summary).
- CountMin [Cormode & Muthukrishnan '05]: turnstile, never underestimates.
- CountMedian / CountSketch [Charikar et al. '02]: turnstile, unbiased.
- CSSS [Jayaram & Woodruff '18]: bounded-deletion Count-Median over a
  uniform sample of the stream, weights rescaled at query time.

CountMin / CountMedian expose a vectorized ``process`` (numpy) because the
paper's experiments feed millions of updates.

The port's own copy of ``repro/core/baselines.py`` (host side, numpy):
the hashes are drawn from ``np.random.default_rng(seed)`` in the
reference's order, so one seed gives the same sketch in both packages.
"""
from __future__ import annotations

import math
from typing import Dict, Hashable

import numpy as np

_PRIME = (1 << 61) - 1  # Mersenne prime for universal hashing


class MisraGries:
    """MG summary with k counters (deterministic, insertion-only)."""

    deterministic = True
    model = "insertion-only"

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.counters: Dict[Hashable, int] = {}

    def insert(self, item: Hashable) -> None:
        c = self.counters
        if item in c:
            c[item] += 1
        elif len(c) < self.capacity:
            c[item] = 1
        else:
            dead = []
            for it in c:
                c[it] -= 1
                if c[it] == 0:
                    dead.append(it)
            for it in dead:
                del c[it]

    def update(self, item: Hashable, sign: int) -> None:
        if sign > 0:
            self.insert(item)
        else:
            raise NotImplementedError("MG is insertion-only")

    def process(self, stream) -> "MisraGries":
        for item, sign in stream:
            self.update(int(item), int(sign))
        return self

    def query(self, item: Hashable) -> int:
        return self.counters.get(item, 0)

    def frequent_items(self, threshold: float) -> set:
        return {it for it, c in self.counters.items() if c >= threshold}


class _HashedRows:
    """Shared machinery: d rows of width w with universal hashes."""

    def __init__(self, width: int, depth: int, seed: int = 0, signed: bool = False):
        self.width = int(width)
        self.depth = int(depth)
        rng = np.random.default_rng(seed)
        self.a = rng.integers(1, _PRIME, size=depth, dtype=np.uint64)
        self.b = rng.integers(0, _PRIME, size=depth, dtype=np.uint64)
        self.signed = signed
        if signed:
            self.sa = rng.integers(1, _PRIME, size=depth, dtype=np.uint64)
            self.sb = rng.integers(0, _PRIME, size=depth, dtype=np.uint64)
        self.table = np.zeros((depth, self.width), dtype=np.int64)

    def _hash(self, items: np.ndarray) -> np.ndarray:
        """(depth, n) bucket indices."""
        x = items.astype(np.uint64)[None, :]
        h = (self.a[:, None] * x + self.b[:, None]) % _PRIME
        return (h % np.uint64(self.width)).astype(np.int64)

    def _sign(self, items: np.ndarray) -> np.ndarray:
        x = items.astype(np.uint64)[None, :]
        s = ((self.sa[:, None] * x + self.sb[:, None]) % _PRIME) & np.uint64(1)
        return (1 - 2 * s.astype(np.int64))

    def bulk_update(self, items: np.ndarray, signs: np.ndarray) -> None:
        idx = self._hash(items)
        vals = signs.astype(np.int64)[None, :]
        if self.signed:
            vals = vals * self._sign(items)
        else:
            vals = np.broadcast_to(vals, idx.shape)
        for r in range(self.depth):
            np.add.at(self.table[r], idx[r], vals[r])

    @property
    def space_counters(self) -> int:
        return self.depth * self.width


class CountMin(_HashedRows):
    """Count-Min sketch: width=ceil(e/eps), depth=ceil(ln 1/delta)."""

    deterministic = False
    model = "turnstile"

    def __init__(self, width: int, depth: int, seed: int = 0):
        super().__init__(width, depth, seed=seed, signed=False)

    @classmethod
    def from_accuracy(cls, eps: float, delta: float, seed: int = 0) -> "CountMin":
        return cls(math.ceil(math.e / eps), max(1, math.ceil(math.log(1 / delta))), seed)

    def update(self, item: Hashable, sign: int) -> None:
        self.bulk_update(np.asarray([item]), np.asarray([sign]))

    def process(self, stream: np.ndarray) -> "CountMin":
        arr = np.asarray(stream)
        self.bulk_update(arr[:, 0], arr[:, 1])
        return self

    def query(self, item) -> int:
        idx = self._hash(np.asarray([item]))[:, 0]
        return int(self.table[np.arange(self.depth), idx].min())

    def query_many(self, items: np.ndarray) -> np.ndarray:
        idx = self._hash(np.asarray(items))
        vals = self.table[np.arange(self.depth)[:, None], idx]
        return vals.min(axis=0)

    def frequent_items(self, threshold: float, candidates: np.ndarray) -> set:
        est = self.query_many(candidates)
        return set(np.asarray(candidates)[est >= threshold].tolist())


class CountMedian(_HashedRows):
    """Count-Median / CountSketch: unbiased median-of-signed-cells estimate."""

    deterministic = False
    model = "turnstile"

    def __init__(self, width: int, depth: int, seed: int = 0):
        super().__init__(width, depth, seed=seed, signed=True)

    @classmethod
    def from_accuracy(cls, eps: float, delta: float, seed: int = 0) -> "CountMedian":
        # l1 guarantee: width O(1/eps); odd depth for a clean median
        d = max(1, math.ceil(math.log(1 / delta)))
        if d % 2 == 0:
            d += 1
        return cls(math.ceil(3.0 / eps), d, seed)

    def update(self, item: Hashable, sign: int) -> None:
        self.bulk_update(np.asarray([item]), np.asarray([sign]))

    def process(self, stream: np.ndarray) -> "CountMedian":
        arr = np.asarray(stream)
        self.bulk_update(arr[:, 0], arr[:, 1])
        return self

    def query(self, item) -> float:
        it = np.asarray([item])
        idx = self._hash(it)[:, 0]
        s = self._sign(it)[:, 0]
        return float(np.median(self.table[np.arange(self.depth), idx] * s))

    def query_many(self, items: np.ndarray) -> np.ndarray:
        items = np.asarray(items)
        idx = self._hash(items)
        s = self._sign(items)
        vals = self.table[np.arange(self.depth)[:, None], idx] * s
        return np.median(vals, axis=0)

    def frequent_items(self, threshold: float, candidates: np.ndarray) -> set:
        est = self.query_many(candidates)
        return set(np.asarray(candidates)[est >= threshold].tolist())


class CSSS:
    """Count-Median Sketch Sample Simulator [Jayaram & Woodruff '18].

    Uniformly samples stream updates with probability p and runs a
    Count-Median over the sample; queries rescale by 1/p. p is chosen so the
    expected sample size is ``c * (alpha/eps) * log(universe) * log(1/delta)``
    (the paper's poly(alpha·logU/eps) sample bound with a practical constant).
    """

    deterministic = False
    model = "bounded-deletion"

    def __init__(
        self,
        eps: float,
        delta: float,
        alpha: float,
        universe: int,
        stream_len: int,
        seed: int = 0,
        sample_const: float = 1.0,
    ):
        target = sample_const * (alpha / eps) * math.log2(max(universe, 2))
        self.p = min(1.0, target / max(stream_len, 1))
        self.rng = np.random.default_rng(seed)
        self.inner = CountMedian.from_accuracy(eps / 2.0, delta, seed=seed + 1)
        self.sampled = 0

    def process(self, stream: np.ndarray) -> "CSSS":
        arr = np.asarray(stream)
        mask = self.rng.random(len(arr)) < self.p
        sub = arr[mask]
        self.sampled += len(sub)
        if len(sub):
            self.inner.bulk_update(sub[:, 0], sub[:, 1])
        return self

    def update(self, item, sign) -> None:
        if self.rng.random() < self.p:
            self.sampled += 1
            self.inner.update(item, sign)

    def query(self, item) -> float:
        return self.inner.query(item) / self.p

    def query_many(self, items: np.ndarray) -> np.ndarray:
        return self.inner.query_many(items) / self.p

    def frequent_items(self, threshold: float, candidates: np.ndarray) -> set:
        est = self.query_many(candidates)
        return set(np.asarray(candidates)[est >= threshold].tolist())


__all__ = ["MisraGries", "CountMin", "CountMedian", "CSSS"]
