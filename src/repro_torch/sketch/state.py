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
    lo = (-INT_MAX) - torch.clamp(a, max=0)
    hi = INT_MAX - torch.clamp(a, min=0)
    if isinstance(b, torch.Tensor):
        return a + torch.minimum(torch.maximum(b.to(I32), lo), hi)
    # a Python number stays a kernel argument: a tensor made of it would
    # be a host-to-device copy, which a captured CUDA graph cannot hold
    return a + torch.minimum(torch.clamp(lo, min=int(b)), hi)


def wrap_add(a: torch.Tensor, b) -> torch.Tensor:
    """int32 add that wraps modulo 2**32, as JAX's int32 ``+`` does.

    Taken in int64 and folded back, so the wrap is defined rather than
    left to the C++ signed overflow under torch's int32 kernels. A Python
    number stays a kernel argument (no host-to-device copy).
    """
    b = b.to(torch.int64) if isinstance(b, torch.Tensor) else int(b)
    x = a.to(torch.int64) + b
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(I32)


def init(capacity: int, device=DEFAULT_DEVICE) -> SketchState:
    dev = resolve_device(device)
    return SketchState(
        ids=torch.full((capacity,), EMPTY, dtype=I32, device=dev),
        counts=torch.zeros((capacity,), dtype=I32, device=dev),
        errors=torch.zeros((capacity,), dtype=I32, device=dev),
    )


def query(state: SketchState, item) -> torch.Tensor:
    """Estimated count of one id (a 0-d int32 tensor); sentinel slots
    never match, and an id past int32 raises ``OverflowError`` as the
    reference's int32 cast does."""
    item = int(item)
    if not -2**31 <= item < 2**31:
        raise OverflowError(f"item id {item} is out of bounds for int32")
    eq = (state.ids == item) & (state.ids >= 0)
    hit = torch.where(eq, state.counts, 0).sum(dtype=I32)
    return torch.where(eq.any(), hit, 0)


def query_many(state: SketchState, items: torch.Tensor) -> torch.Tensor:
    """Estimated count per query id; sentinel slots never match."""
    eq = (state.ids[None, :] == items.to(I32)[:, None]) \
        & (state.ids >= 0)[None, :]
    hit = torch.where(eq, state.counts[None, :], 0).sum(dim=1, dtype=I32)
    return hit * eq.any(dim=1)


def top_m(counts: torch.Tensor, m: int) -> torch.Tensor:
    """Indices of the m largest values along the last axis, lower index
    first among equals (the tie order of ``jax.lax.top_k``). Like it,
    refuses an m that is negative or past the number of values."""
    n = counts.shape[-1]
    if not 0 <= m <= n:
        raise ValueError(f"top-m needs 0 <= m <= {n} (the slots it ranks), "
                         f"got m={m}")
    return torch.sort(counts, descending=True, stable=True).indices[..., :m]


def topk(state: SketchState, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m (ids, counts) by estimated count (heavy-hitter report)."""
    counts = torch.where(state.ids == EMPTY, -2**31, state.counts)
    idx = top_m(counts, m)
    return state.ids[idx], counts[idx]


def _mincount(s: SketchState) -> torch.Tensor:
    """Per row: the minimum count if the row is full (BLOCKED slots count
    as occupied; their INT_MAX counts never win), else 0."""
    full = (s.ids != EMPTY).all(dim=-1)
    mc = torch.where(s.ids == EMPTY, INT_MAX, s.counts).amin(dim=-1)
    return torch.where(full, mc, 0)


def merge(a: SketchState, b: SketchState) -> SketchState:
    """Mergeable-summaries merge (reference ``state.py:108``), batched
    over any leading axes of two same-shape states.

    Items in both sketches: counts and errors add. Items in one: the
    other sketch's min count bounds the unseen frequency, added only if
    that sketch is full. Keep the top k. BLOCKED slots are inert: they
    count as occupied for the is-full test, take no cross term and never
    reach the merged summary. Every add saturates at int32.
    """
    k = a.ids.shape[-1]
    lead = a.ids.shape[:-1]
    m_a, m_b = _mincount(a), _mincount(b)
    ids = torch.cat([a.ids, b.ids], dim=-1)
    counts = torch.cat([a.counts, b.counts], dim=-1)
    errors = torch.cat([a.errors, b.errors], dim=-1)
    cross = torch.cat([m_b[..., None].expand(*lead, k),
                       m_a[..., None].expand(*lead, k)], dim=-1)
    cross = torch.where(ids < 0, 0, cross)

    # duplicates: a stable sort by id; a non-negative id occurs at most
    # once per input, so its run has length <= 2 and a one-step shift
    # folds the pair into the run's first entry
    order = torch.sort(ids, dim=-1, stable=True).indices
    ids_s, cnt_s, err_s, cross_s = (t.gather(-1, order)
                                    for t in (ids, counts, errors, cross))
    first = torch.zeros((*lead, 1), dtype=torch.bool, device=ids.device)
    dup_prev = torch.cat([first, ids_s[..., 1:] == ids_s[..., :-1]], dim=-1)
    dup_next = torch.cat([dup_prev[..., 1:], first], dim=-1)

    def shift(v):
        return torch.cat([v[..., 1:], torch.zeros_like(v[..., :1])], dim=-1)

    cnt_m = sat_add(cnt_s, torch.where(dup_next, shift(cnt_s), cross_s))
    err_m = sat_add(err_s, torch.where(dup_next, shift(err_s), cross_s))
    valid = ~dup_prev & (ids_s >= 0)
    idx = top_m(torch.where(valid, cnt_m, -2**31), k)
    sel = valid.gather(-1, idx)
    return SketchState(
        ids=torch.where(sel, ids_s.gather(-1, idx), EMPTY),
        counts=torch.where(sel, cnt_m.gather(-1, idx), 0),
        errors=torch.where(sel, err_m.gather(-1, idx), 0))


def to_dict(state: SketchState) -> dict:
    """{item: (count, error)} of a (k,) state, for comparisons (as the
    reference: every slot but EMPTY ones)."""
    out = {}
    for i, c, e in zip(*(t.tolist() for t in state)):
        if i != EMPTY:
            out[i] = (c, e)
    return out


__all__ = ["EMPTY", "BLOCKED", "POISON", "LANES", "VARIANT_LAZY",
           "VARIANT_SSPM", "INT_MAX", "SketchState", "sat_add", "wrap_add",
           "init", "query", "query_many", "top_m", "topk", "merge",
           "to_dict"]
