"""Phase primitives of the two-phase SpaceSaving± block update.

Counterpart of ``repro/sketch/phases.py``, batched over bank rows: the
reference writes each O(k) phase for one (k,) row and ``jax.vmap``s it
over the bank (``bank.py:524-529``); here the row axis is written out.
Per-row operands are (R,) tensors; the grouped residual layout is one
flat (G,) array (G = R * B) that every row indexes at its own offset,
exactly as in the reference, so clip bounds and the bisection trip
count use the flat length G.

The single-sketch phases (``pad_rows`` through ``residual_phase``) are
batched over E stacked sketches instead, each viewed as (R, LANES) rows:
the reference ``vmap``s them over per-expert, per-layer or per-shard
sketches (``blocks.py:388``), and E = 1 is its unbatched case. The
single-sketch layout is (E, B), and the flat-layout phases above take
it flattened with ``width=B``: each sketch then clips into its own B
entries, as the reference does on its own (B,) array.

Every sum and prefix sum is int32 (``dtype=I32``): JAX keeps int32 sums
in int32 with x64 off, torch would widen them to int64.
"""
from __future__ import annotations

import torch

from .state import (BLOCKED, EMPTY, I32, INT_MAX, LANES, VARIANT_LAZY,
                    sat_add, wrap_add)


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


def _flat_index(offset, pos, G, width):
    """Where a row reads entry ``pos`` of its run in the flat (G,) layout.

    The banked layout (``width=None``) clips ``offset + pos`` to the
    whole array, as the reference's bank phases do; a stacked
    single-sketch layout clips ``pos`` to the sketch's own ``width``
    entries, as the reference does on each sketch's (B,) array."""
    if width is None:
        return torch.clamp(offset[:, None] + pos, 0, G - 1).long()
    return (offset[:, None] + torch.clamp(pos, 0, width - 1)).long()


def fill_empty_slots(ids, counts, errors, r_uids, r_net, n_ins, offset,
                     width=None):
    """Phase 1.5: the j-th residual insert of a row (from ``offset``) takes
    the row's j-th EMPTY slot, for j < ``n_ins``. Rows: (R, K); ``r_uids``/
    ``r_net`` flat (G,); ``n_ins``/``offset`` (R,); ``width`` as in
    ``_flat_index``. Returns the updated rows and ``min(n_ins, #empties)``
    per row."""
    G = r_uids.shape[0]
    empty = ids == -1
    e_rank = _cumsum(empty) - 1
    take = empty & (e_rank < n_ins[:, None])
    src = _flat_index(offset, e_rank, G, width)
    ids = torch.where(take, r_uids[src], ids)
    counts = torch.where(take, r_net[src], counts)
    errors = torch.where(take, 0, errors)
    return ids, counts, errors, torch.minimum(n_ins, _sum(empty))


def waterfill_unit_inserts(ids, counts, errors, uu, m, offset, width=None):
    """Phase 1.75: evict ``m`` unit-weight residual inserts per row at once.

    The sequential recurrence pops the argmin count and pushes it + 1,
    m times; its pops are the m smallest values of the union
    {count_j + t : t >= 0}, ordered by (value, slot). So a water level T
    is bisected, slot j absorbs T - count_j pops below it, and the first
    r eligible slots in index order take one more (see the reference,
    ``phases.py:191``, for the derivation). Rows: (R, K); ``uu`` flat
    (G,); ``m``/``offset`` (R,); ``width`` as in ``_flat_index``.
    """
    G = uu.shape[0]
    mc = m[:, None]

    def n_leq(x):
        # per-slot number of union values <= x (x: (R,) per row)
        d = torch.minimum(torch.clamp(sat_add(x[:, None], -counts), min=0), mc)
        return torch.where(counts <= x[:, None], d + 1, 0)

    lo = counts.min(dim=1).values
    hi = sat_add(lo, m)
    # bisects [lo, lo + m], m <= the run's length (the reference's trips)
    for _ in range((width or G).bit_length() + 1):
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
    pos = _flat_index(offset, pos, G, width)
    return (torch.where(evicted, uu[pos], ids), new_counts,
            torch.where(evicted, v_last, errors))


# ---------------------------------------------------------------------------
# The (E, R, LANES) row view of E stacked sketches and its phase 2
# ---------------------------------------------------------------------------

def pad_rows(ids, counts, errors):
    """View (E, k) stores as (E, R, LANES) rows, R = ceil(k / LANES).

    Padding slots carry BLOCKED ids (match nothing, never empty), INT_MAX
    counts (never the minimum) and zero errors (never spread targets).
    The result is always a fresh copy, so a kernel may update it in
    place without touching the caller's state.
    """
    k = ids.shape[-1]
    rows = -(-k // LANES)
    pad = rows * LANES - k

    def view(t, fill):
        tail = torch.full((*t.shape[:-1], pad), fill, dtype=I32,
                          device=t.device)
        return torch.cat([t, tail], dim=-1).reshape(*t.shape[:-1], rows, LANES)

    return view(ids, BLOCKED), view(counts, INT_MAX), view(errors, 0)


def row_structures(ids2, cnt2, err2):
    """Per-row tournament summaries (has_empty, min_count, max_error) of
    (E, R, LANES) rows; EMPTY slots count as INT_MAX."""
    empty = ids2 == EMPTY
    return (empty.any(dim=-1),
            torch.where(empty, INT_MAX, cnt2).amin(dim=-1),
            err2.amax(dim=-1))


def _row_of(x, r):
    """Row ``r[e]`` of each sketch e of an (E, R, LANES) tensor: (E, LANES)."""
    return x.gather(1, r[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]


def _pick_slot(ids2, cnt2, row_has_empty, row_min):
    """Tournament final (reference ``phases.py:122``), per sketch.

    Returns (r_sel, c_sel, min_count, has_empty), each (E,): the first
    EMPTY slot if the sketch has one, else the first minimum-count slot;
    ``min_count`` is the minimum over non-empty slots (INT_MAX when all
    are empty). Ties go to the lowest index, as ``jnp.argmin`` does.
    """
    has_empty = row_has_empty.any(dim=-1)
    r_e = torch.argmax(row_has_empty.to(I32), dim=-1)
    r_m = torch.argmin(row_min, dim=-1)
    min_count = row_min.gather(1, r_m[:, None])[:, 0]
    r_sel = torch.where(has_empty, r_e, r_m)
    empty = _row_of(ids2, r_sel) == EMPTY
    c_e = torch.argmax(empty.to(I32), dim=-1)
    c_m = torch.argmin(torch.where(empty, INT_MAX, _row_of(cnt2, r_sel)),
                       dim=-1)
    return r_sel, torch.where(has_empty, c_e, c_m), min_count, has_empty


def select_insert_slot(ids, counts):
    """Tournament pick of the SpaceSaving replacement slot of (E, k)
    stores: (slot, min_count, has_empty) per sketch, with the semantics
    of ``_pick_slot`` (reference ``phases.py:145``)."""
    ids2, cnt2, err2 = pad_rows(ids, counts, torch.zeros_like(counts))
    row_has_empty, row_min, _ = row_structures(ids2, cnt2, err2)
    r_sel, c_sel, min_count, has_empty = _pick_slot(
        ids2, cnt2, row_has_empty, row_min)
    return r_sel * LANES + c_sel, min_count, has_empty


def residual_phase(ids2, cnt2, err2, r_uids, r_net, start, n_ins, w_del,
                   variant: int):
    """Phase 2 of E stacked sketches (reference ``phases.py:287``).

    Per sketch: each insert ``r_uids[i]`` for i in [start, n_ins) takes
    the slot ``_pick_slot`` picks (an EMPTY one at weight w, else the
    minimum count mc at ``sat_add(mc, w)`` with error mc), and that row's
    summaries are refreshed; then (SS± only) ``w_del`` drains greedily
    from the first maximum-error slot of the first maximum-error row,
    with a plain wrapping ``- d`` as in the reference. Sketches run in
    lockstep and finished ones freeze. State (E, R, LANES); ``r_uids``,
    ``r_net`` (E, B); ``start``, ``n_ins``, ``w_del`` (E,). Returns new
    tensors; the inputs are not modified. This is the plain version of
    the CUDA kernel ``csrc/residual.cu``.
    """
    ids2, cnt2, err2 = ids2.clone(), cnt2.clone(), err2.clone()
    E, B = r_uids.shape
    sk = torch.arange(E, device=ids2.device)
    rhe, rmin, rmaxe = row_structures(ids2, cnt2, err2)

    def refresh(e, r):
        row = ids2[e, r]
        empty = row == EMPTY
        rhe[e, r] = empty.any(dim=-1)
        rmin[e, r] = torch.where(empty, INT_MAX, cnt2[e, r]).amin(dim=-1)
        rmaxe[e, r] = err2[e, r].amax(dim=-1)

    i = start.clone()
    while bool((i < n_ins).any()):
        act = i < n_ins
        g = torch.clamp(i, 0, B - 1).long()[:, None]
        uid = r_uids.gather(1, g)[:, 0]
        w = r_net.gather(1, g)[:, 0]
        r_sel, c_sel, mc, has_empty = _pick_slot(ids2, cnt2, rhe, rmin)
        e, r, c = sk[act], r_sel[act], c_sel[act]
        he = has_empty[act]
        ids2[e, r, c] = uid[act]
        cnt2[e, r, c] = torch.where(he, w[act], sat_add(mc[act], w[act]))
        err2[e, r, c] = torch.where(he, 0, mc[act])
        refresh(e, r)
        i = i + act.to(I32)

    if variant != VARIANT_LAZY:
        rem = w_del.clone()
        while True:
            r_max = torch.argmax(rmaxe, dim=-1)
            top = rmaxe.gather(1, r_max[:, None])[:, 0]
            act = (rem > 0) & (top > 0)
            if not bool(act.any()):
                break
            e, r = sk[act], r_max[act]
            row_err = err2[e, r]
            c = torch.argmax(row_err, dim=-1)
            d = torch.minimum(rem[act], row_err.gather(1, c[:, None])[:, 0])
            cnt2[e, r, c] = wrap_add(cnt2[e, r, c], -d)
            err2[e, r, c] = wrap_add(err2[e, r, c], -d)
            refresh(e, r)
            rem[act] = rem[act] - d
    return ids2, cnt2, err2


__all__ = ["stable_partition_perm", "segment_nets", "fill_empty_slots",
           "waterfill_unit_inserts", "pad_rows", "row_structures",
           "select_insert_slot", "residual_phase"]
