"""Phase primitives of the two-phase SpaceSaving± block update.

Counterpart of ``repro/sketch/phases.py``, batched over bank rows: the
reference writes each O(k) phase for one (k,) row and ``jax.vmap``s it
over the bank (``bank.py:524-529``); here the row axis is written out.
Per-row operands are (R,) tensors; the grouped residual layout is one
flat (G,) array (G = R * B) that every row indexes at its own offset,
exactly as in the reference, so clip bounds and the bisection trip
count use the flat length G.

Every sum and prefix sum is int32 (``dtype=I32``): JAX keeps int32 sums
in int32 with x64 off, torch would widen them to int64.
"""
from __future__ import annotations

import torch

from .state import I32, sat_add


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1, dtype=I32)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=-1, dtype=I32)


def stable_partition_perm(klass: torch.Tensor) -> torch.Tensor:
    """Permutation stably grouping the last axis by integer class.

    The reference's packed single-sort key ``klass * B + index``
    (``phases.py:32``), int32 and floor-mod as there: for in-range keys
    it is the stable argsort of ``klass``.
    """
    B = klass.shape[-1]
    idx = torch.arange(B, dtype=I32, device=klass.device)
    return torch.remainder(torch.sort(klass.to(I32) * B + idx,
                                      dim=-1).values, B).long()


def segment_nets(s_items: torch.Tensor, s_weights: torch.Tensor):
    """Per-segment net weights of row-sorted (R, B) item/weight matrices.

    Returns ``(head, net)``: ``head`` marks the first entry of every
    equal-item run, ``net`` holds the run's summed weight at head
    positions (undefined elsewhere). ``s_weights`` may be (1, B) when all
    rows share one weight vector.
    """
    R, B = s_items.shape
    dev = s_items.device
    idx = torch.arange(B, dtype=I32, device=dev)
    head = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                      s_items[:, 1:] != s_items[:, :-1]], dim=1)
    c = _cumsum(s_weights)
    # next head at-or-after i: suffix minimum = flip, cummin, flip
    nh = torch.where(head, idx[None, :], B).flip(1).cummin(dim=1).values.flip(1)
    nh_after = torch.cat([nh[:, 1:], torch.full((R, 1), B, dtype=I32,
                                                 device=dev)], dim=1)
    seg_end = torch.clamp(nh_after - 1, 0, B - 1).long()
    ce = torch.cat([torch.zeros((c.shape[0], 1), dtype=I32, device=dev),
                    c[:, :-1]], dim=1)
    net = torch.gather(c.expand(R, B), 1, seg_end) - ce
    return head, net


def fill_empty_slots(ids, counts, errors, r_uids, r_net, n_ins, offset):
    """Phase 1.5: the j-th residual insert of a row (from ``offset``) takes
    the row's j-th EMPTY slot, for j < ``n_ins``. Rows: (R, K); ``r_uids``/
    ``r_net`` flat (G,); ``n_ins``/``offset`` (R,). Returns the updated
    rows and ``min(n_ins, #empties)`` per row."""
    G = r_uids.shape[0]
    empty = ids == -1
    e_rank = _cumsum(empty) - 1
    take = empty & (e_rank < n_ins[:, None])
    src = torch.clamp(offset[:, None] + e_rank, 0, G - 1).long()
    ids = torch.where(take, r_uids[src], ids)
    counts = torch.where(take, r_net[src], counts)
    errors = torch.where(take, 0, errors)
    return ids, counts, errors, torch.minimum(n_ins, _sum(empty))


def waterfill_unit_inserts(ids, counts, errors, uu, m, offset):
    """Phase 1.75: evict ``m`` unit-weight residual inserts per row at once.

    The sequential recurrence pops the argmin count and pushes it + 1,
    m times; its pops are the m smallest values of the union
    {count_j + t : t >= 0}, ordered by (value, slot). So a water level T
    is bisected, slot j absorbs T - count_j pops below it, and the first
    r eligible slots in index order take one more (see the reference,
    ``phases.py:191``, for the derivation). Rows: (R, K); ``uu`` flat
    (G,); ``m``/``offset`` (R,).
    """
    G = uu.shape[0]
    mc = m[:, None]

    def n_leq(x):
        # per-slot number of union values <= x (x: (R,) per row)
        d = torch.minimum(torch.clamp(sat_add(x[:, None], -counts), min=0), mc)
        return torch.where(counts <= x[:, None], d + 1, 0)

    lo = counts.min(dim=1).values
    hi = sat_add(lo, m)
    for _ in range(G.bit_length() + 1):   # bisects [lo, lo + m], m <= G
        mid = sat_add(lo, torch.div(sat_add(hi, -lo), 2, rounding_mode="floor"))
        ge = _sum(n_leq(mid)) >= m
        lo, hi = torch.where(ge, lo, sat_add(mid, 1)), torch.where(ge, mid, hi)
    T = lo[:, None]

    f_tm1 = _sum(n_leq(lo - 1))[:, None]
    r = mc - f_tm1
    elig = counts <= T
    rank = _cumsum(elig) - 1
    extra = elig & (rank < r)
    t = torch.where(counts <= T - 1, torch.minimum(
        torch.clamp(sat_add(T, -counts), min=0), mc), 0) + extra
    evicted = t > 0
    new_counts = sat_add(counts, t)
    v_last = new_counts - 1
    # pops strictly below T - 1, phrased at T - 1 with a strict mask
    # (T - 2 would wrap when the level sits within 2 of the negative rail)
    f_tm2 = _sum(torch.where(counts < T - 1, torch.minimum(
        torch.clamp(sat_add(T - 1, -counts), min=0), mc), 0))[:, None]
    under = (counts <= T - 1).to(I32)
    below_line = _cumsum(under) - under
    pos = torch.where(extra, f_tm1 + torch.minimum(rank, r), f_tm2 + below_line)
    pos = torch.clamp(offset[:, None] + pos, 0, G - 1).long()
    return (torch.where(evicted, uu[pos], ids), new_counts,
            torch.where(evicted, v_last, errors))


__all__ = ["stable_partition_perm", "segment_nets", "fill_empty_slots",
           "waterfill_unit_inserts"]
