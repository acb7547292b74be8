"""SketchState: the dense SpaceSaving± counter store and its queries.

Counterpart of ``repro/sketch/state.py``. Layout:
    ids:    (..., k) int32   item ids, EMPTY = -1 for free slots
    counts: (..., k) int32   estimated counts
    errors: (..., k) int32   estimated errors

All arithmetic on counts and errors is int32, as in the reference:
``sat_add`` clamps at ±(2**31-1) instead of wrapping, and every sum
over a row is taken with ``dtype=torch.int32`` because torch otherwise
widens integer sums to int64 while JAX (x64 off) keeps them in int32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..platform import DEFAULT_DEVICE, resolve_device

EMPTY = -1
# BLOCKED marks capacity-padding slots: never empty, never the minimum
# count (INT_MAX), never a spread target (error 0).
BLOCKED = -2
# POISON marks a dead row (written by the reference's fault harness only).
POISON = -3
LANES = 128
VARIANT_LAZY = 1
VARIANT_SSPM = 2
INT_MAX = 2**31 - 1
I32 = torch.int32


class SketchState(NamedTuple):
    ids: torch.Tensor     # (..., k) int32
    counts: torch.Tensor  # (..., k) int32
    errors: torch.Tensor  # (..., k) int32


def sat_add(a: torch.Tensor, b) -> torch.Tensor:
    """Saturating int32 add: clamps at ±(2**31-1) instead of wrapping.

    The reference's one-sided headroom form (``state.py:31``): the
    bounds are themselves int32-safe for any ``a`` in ±(2**31-1).
    """
    b = torch.as_tensor(b, dtype=I32, device=a.device)
    lo = (-INT_MAX) - torch.clamp(a, max=0)
    hi = INT_MAX - torch.clamp(a, min=0)
    return a + torch.minimum(torch.maximum(b, lo), hi)


def wrap_add(a: torch.Tensor, b) -> torch.Tensor:
    """int32 add that wraps modulo 2**32, as JAX's int32 ``+`` does.

    Taken in int64 and folded back, so the wrap is defined rather than
    left to the C++ signed overflow under torch's int32 kernels.
    """
    x = a.to(torch.int64) + torch.as_tensor(b, device=a.device).to(torch.int64)
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(I32)


def init(capacity: int, device=DEFAULT_DEVICE) -> SketchState:
    dev = resolve_device(device)
    return SketchState(
        ids=torch.full((capacity,), EMPTY, dtype=I32, device=dev),
        counts=torch.zeros((capacity,), dtype=I32, device=dev),
        errors=torch.zeros((capacity,), dtype=I32, device=dev),
    )


def query_many(state: SketchState, items: torch.Tensor) -> torch.Tensor:
    """Estimated count per query id; sentinel slots never match."""
    eq = (state.ids[None, :] == items.to(I32)[:, None]) \
        & (state.ids >= 0)[None, :]
    hit = torch.where(eq, state.counts[None, :], 0).sum(dim=1, dtype=I32)
    return hit * eq.any(dim=1)


def top_m(counts: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest values, lower index first among equals
    (the tie order of ``jax.lax.top_k``). Like it, refuses an m that is
    negative or past the number of values."""
    n = counts.shape[-1]
    if not 0 <= m <= n:
        raise ValueError(f"top-m needs 0 <= m <= {n} (the slots it ranks), "
                         f"got m={m}")
    return torch.sort(counts, descending=True, stable=True).indices[:m]


def topk(state: SketchState, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m (ids, counts) by estimated count (heavy-hitter report)."""
    counts = torch.where(state.ids == EMPTY, -2**31, state.counts)
    idx = top_m(counts, m)
    return state.ids[idx], counts[idx]


__all__ = ["EMPTY", "BLOCKED", "POISON", "LANES", "VARIANT_LAZY",
           "VARIANT_SSPM", "INT_MAX", "SketchState", "sat_add", "wrap_add",
           "init", "query_many", "top_m", "topk"]
