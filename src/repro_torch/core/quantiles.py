"""Quantile sketches in the bounded-deletion model (paper §4).

- DyadicQuantile: generic dyadic-decomposition quantile sketch over a
  bounded universe U = 2^bits, parameterized by a per-layer frequency
  sketch factory (paper Algs 5+6).
    * DSS±  = DyadicQuantile + SpaceSaving± layers  (paper's contribution —
      the first *deterministic* quantile sketch with bounded deletions)
    * DCS   = DyadicQuantile + Count-Median layers  [Wang et al. '13]
    * DCM   = DyadicQuantile + Count-Min layers     [Cormode & M. '05]
- KLLpm: a two-sided KLL stand-in for the KLL± baseline [Zhao et al. '21]:
  rank(x) = rank_inserts(x) - rank_deletes(x) with each side a KLL sketch
  scaled for the bounded-deletion mass ratio.

The port's own copy of ``repro/core/quantiles.py`` (host side, numpy):
``dyadic_layer_capacities`` sizes the port's dyadic bank
(``sketch/dyadic.py``) as the reference's sizes its own, and the classes
are the oracles the benchmarks hold the port's quantile sketches to.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np

from .baselines import CountMedian, CountMin
from .spacesaving import LazySpaceSavingPM, SpaceSavingPM


def dyadic_layer_capacities(
    bits: int,
    total_counters: Optional[int] = None,
    eps: Optional[float] = None,
    alpha: float = 2.0,
) -> List[int]:
    """Per-layer SpaceSaving± capacities for a dyadic sketch, shared by
    the oracle (the ``DyadicQuantile`` factories below) and the port's
    bank (``sketch/dyadic.py``).

    Exactly one of ``total_counters`` / ``eps`` must be given:
      * eps-based (paper §4.2): every layer gets ceil(2·alpha·bits/eps)
        counters, so per-layer error eps/bits sums to eps·|F|₁ over the
        <= bits contributing nodes of any rank query.
      * budget-based (the experiments): ``total_counters`` split evenly.

    Either way layer l is clipped to its universe size 2^(bits-l), at
    which point the layer is exact.
    """
    if (total_counters is None) == (eps is None):
        raise ValueError("pass exactly one of total_counters / eps")
    if eps is not None:
        per_layer = max(2, math.ceil(2.0 * alpha * bits / eps))
    else:
        per_layer = max(2, total_counters // bits)
    return [min(per_layer, 1 << (bits - l)) for l in range(bits)]


class DyadicQuantile:
    """Dyadic quantile sketch over universe [0, 2^bits)."""

    def __init__(self, bits: int, layer_factory: Callable[[int], object]):
        self.bits = bits
        # layer l holds frequencies of x >> l; l = 0..bits-1
        self.layers = [layer_factory(l) for l in range(bits)]
        self.mass = 0  # |F|_1 = I - D, tracked exactly (one integer)

    # paper Alg 5 (unit weights; loop for weighted)
    def update(self, x: int, sign: int = 1) -> None:
        self.mass += sign
        for l, sk in enumerate(self.layers):
            if sign > 0:
                sk.insert(x >> l)
            else:
                sk.delete(x >> l)

    def process(self, stream) -> "DyadicQuantile":
        for item, sign in stream:
            self.update(int(item), int(sign))
        return self

    # paper Alg 6: rank(x) = estimated |{v <= x}| via dyadic decomposition
    def rank(self, x: int) -> float:
        y = int(x) + 1  # count of values strictly below y
        if y >= (1 << self.bits):
            # the single level-`bits` node covers the whole universe; its
            # frequency is the exactly-tracked total mass |F|_1
            return float(self.mass)
        r = 0.0
        lo = 0
        for l in range(self.bits - 1, -1, -1):
            if (y >> l) & 1:
                node = lo >> l
                r += max(0.0, float(self.layers[l].query(node)))
                lo += 1 << l
        return r

    def quantile(self, q: float) -> int:
        """Smallest x with rank(x) >= q * mass (binary search over universe)."""
        target = q * self.mass
        lo, hi = 0, (1 << self.bits) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.rank(mid) >= target:
                hi = mid
            else:
                lo = mid + 1
        return lo

    @property
    def space_counters(self) -> int:
        total = 0
        for sk in self.layers:
            if hasattr(sk, "capacity"):
                total += sk.capacity
            elif hasattr(sk, "space_counters"):
                total += sk.space_counters
        return total


class _CMLayer:
    """Adapts CountMin/CountMedian to the insert/delete layer protocol."""

    def __init__(self, inner):
        self.inner = inner
        self.space_counters = inner.space_counters

    def insert(self, x):
        self.inner.update(x, 1)

    def delete(self, x):
        self.inner.update(x, -1)

    def query(self, x):
        return self.inner.query(x)


def make_dss_pm(
    bits: int, eps: float, alpha: float = 2.0, variant: str = "sspm"
) -> DyadicQuantile:
    """Paper §4.2: one SS± of capacity O(alpha * bits / eps) per layer.

    Layer l has at most 2^(bits-l) distinct values; the capacity is clipped
    there, at which point the layer is exact. ``variant``: 'sspm' (Alg 4
    layers) or 'lazy' (Alg 3 layers — unmonitored deletions dropped).
    """
    caps = dyadic_layer_capacities(bits, eps=eps, alpha=alpha)
    cls = LazySpaceSavingPM if variant == "lazy" else SpaceSavingPM
    return DyadicQuantile(bits, lambda l: cls(caps[l]))


def dyadic_from_budget(
    bits: int, total_counters: int, kind: str, seed: int = 0
) -> DyadicQuantile:
    """Budgeted constructors used by the experiments: split ``total_counters``
    evenly across layers (clipped to layer universe size for counter sketches).
    kind in {'dss_pm', 'dss_lazy', 'dcs', 'dcm'}."""
    if kind in ("dss_pm", "dss_lazy"):
        caps = dyadic_layer_capacities(bits, total_counters=total_counters)
        cls = LazySpaceSavingPM if kind == "dss_lazy" else SpaceSavingPM

        def factory(l: int):
            return cls(caps[l])
    elif kind in ("dcs", "dcm"):
        per_layer = max(2, total_counters // bits)
        depth = 3
        width = max(2, per_layer // depth)
        cls = CountMedian if kind == "dcs" else CountMin

        def factory(l: int):
            w = min(width, max(2, (1 << (bits - l))))
            return _CMLayer(cls(w, depth, seed=seed + 7 * l))
    else:
        raise ValueError(kind)
    return DyadicQuantile(bits, factory)


# ---------------------------------------------------------------------------
# KLL and the KLL± stand-in
# ---------------------------------------------------------------------------

class KLL:
    """Compact KLL sketch (insertion-only), lazy compaction, k per level."""

    def __init__(self, k: int = 128, seed: int = 0):
        self.k = max(4, k)
        self.levels: List[List[float]] = [[]]
        self.rng = np.random.default_rng(seed)
        self.n = 0

    def insert(self, x: float) -> None:
        self.n += 1
        self.levels[0].append(x)
        self._compress()

    def _capacity(self, level: int) -> int:
        # geometric decay c=2/3 from the top level
        depth = len(self.levels)
        return max(2, int(self.k * (2.0 / 3.0) ** (depth - 1 - level)))

    def _compress(self) -> None:
        l = 0
        while l < len(self.levels):
            if len(self.levels[l]) > self._capacity(l):
                buf = sorted(self.levels[l])
                if len(buf) % 2 == 1:
                    # keep one element behind
                    keep = buf.pop(self.rng.integers(0, len(buf)))
                    self.levels[l] = [keep]
                else:
                    self.levels[l] = []
                off = int(self.rng.integers(0, 2))
                promoted = buf[off::2]
                if l + 1 == len(self.levels):
                    self.levels.append([])
                self.levels[l + 1].extend(promoted)
            l += 1

    def rank(self, x: float) -> float:
        r = 0.0
        for l, buf in enumerate(self.levels):
            w = 2 ** l
            r += w * sum(1 for v in buf if v <= x)
        return r


class KLLpm:
    """KLL± stand-in: separate insert/delete KLL sketches; rank difference.

    With D <= (1-1/alpha) I, rank error eps_kll*(I+D) <= eps*(I-D) when
    eps_kll = eps/(2*alpha - 1); we size both sketches accordingly.
    """

    def __init__(self, k: int = 128, seed: int = 0):
        self.ins = KLL(k=k, seed=seed)
        self.dels = KLL(k=k, seed=seed + 1)
        self.mass = 0

    def update(self, x: float, sign: int = 1) -> None:
        self.mass += sign
        if sign > 0:
            self.ins.insert(x)
        else:
            self.dels.insert(x)

    def process(self, stream) -> "KLLpm":
        for item, sign in stream:
            self.update(float(item), int(sign))
        return self

    def rank(self, x: float) -> float:
        return self.ins.rank(x) - self.dels.rank(x)

    def quantile(self, q: float) -> float:
        vals = sorted(
            {v for buf in self.ins.levels for v in buf}
            | {v for buf in self.dels.levels for v in buf}
        )
        if not vals:
            return 0.0
        target = q * self.mass
        for v in vals:
            if self.rank(v) >= target:
                return v
        return vals[-1]

    @property
    def space_counters(self) -> int:
        return sum(len(b) for b in self.ins.levels) + sum(
            len(b) for b in self.dels.levels
        )


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def true_ranks(values: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Exact rank (# of values <= q) for each query point."""
    sv = np.sort(values)
    return np.searchsorted(sv, queries, side="right").astype(np.float64)


def ks_divergence(
    sketch, values: np.ndarray, num_queries: int = 256
) -> float:
    """Kolmogorov-Smirnov divergence: max |est_cdf - true_cdf| over a grid
    of query points (the paper's §5.5 metric)."""
    if len(values) == 0:
        return 0.0
    mass = float(len(values))
    qs = np.quantile(values, np.linspace(0, 1, num_queries)).astype(np.int64)
    qs = np.unique(qs)
    tr = true_ranks(values, qs)
    worst = 0.0
    for q, t in zip(qs, tr):
        est = sketch.rank(int(q))
        worst = max(worst, abs(est - t) / mass)
    return worst


__all__ = ["dyadic_layer_capacities", "DyadicQuantile", "make_dss_pm",
           "dyadic_from_budget", "KLL", "KLLpm", "true_ranks",
           "ks_divergence"]
