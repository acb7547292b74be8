"""Per-layer sizing of the dyadic quantile sketch.

The port's own copy of ``repro/core/quantiles.py::dyadic_layer_capacities``
(the Python oracle ``DyadicQuantile`` stays in the reference; the tests
hold the port to it).
"""
from __future__ import annotations

import math
from typing import List, Optional


def dyadic_layer_capacities(
    bits: int,
    total_counters: Optional[int] = None,
    eps: Optional[float] = None,
    alpha: float = 2.0,
) -> List[int]:
    """Per-layer SpaceSaving± capacities of a dyadic sketch over
    [0, 2^bits).

    Exactly one of ``total_counters`` / ``eps``:
      * eps (paper §4.2): every layer gets ceil(2·alpha·bits/eps)
        counters, so the per-layer error eps/bits sums to eps·|F|₁ over
        the <= bits nodes of any rank query;
      * total_counters: split evenly over the layers.

    Layer l is clipped to its universe, 2^(bits-l) nodes, where it is
    exact. The float expression is the reference's, in its order, so the
    ceiling rounds as it does there.
    """
    if (total_counters is None) == (eps is None):
        raise ValueError("pass exactly one of total_counters / eps")
    if eps is not None:
        per_layer = max(2, math.ceil(2.0 * alpha * bits / eps))
    else:
        per_layer = max(2, total_counters // bits)
    return [min(per_layer, 1 << (bits - l)) for l in range(bits)]


__all__ = ["dyadic_layer_capacities"]
