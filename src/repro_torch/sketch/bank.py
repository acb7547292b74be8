"""Bank engine: the stacked (R, k) SketchState and its per-row phases.

Counterpart of ``repro/sketch/bank.py`` for what the kernel path needs:
``init``, ``shard_of``, ``sort_block``, the ``HashShardRouter``, the
framework-side prep ``phase1_dense_prep`` (sorts, ``searchsorted``,
grouping: plain torch ops here, as they stayed XLA outside the Pallas
kernel), the banked residual loop ``residual_phase_banked``, the
bank-wide reads ``query_rows``/``topk_bank`` and the reductions
``merge_banks``/``consolidate``.

Row layout contract (as in the reference): BLOCKED slots (here only the
column padding ``ops.py`` adds) hold INT_MAX counts and zero errors,
inert under every phase. Weight > 0 inserts, < 0 deletes, 0 pads; item
ids are non-negative (negative ids are sentinels).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..platform import DEFAULT_DEVICE, resolve_device
from .phases import (fill_empty_slots, segment_nets, stable_partition_perm,
                     waterfill_unit_inserts)
from .state import (EMPTY, I32, VARIANT_LAZY, SketchState, merge, sat_add,
                    top_m)

_U32 = 0xFFFFFFFF


def init(capacity: int, num_rows: int, device=DEFAULT_DEVICE) -> SketchState:
    """Empty (R, k) bank of ``num_rows`` rows of ``capacity`` counters.

    (The reference's per-row capacity lists, which pad short rows with
    BLOCKED slots, arrive with the dyadic layers that need them.)
    """
    if num_rows < 1 or capacity < 1:
        raise ValueError(f"need capacity >= 1 and num_rows >= 1, got "
                         f"{capacity}, {num_rows}")
    dev = resolve_device(device)
    shape = (num_rows, capacity)
    return SketchState(
        ids=torch.full(shape, EMPTY, dtype=I32, device=dev),
        counts=torch.zeros(shape, dtype=I32, device=dev),
        errors=torch.zeros(shape, dtype=I32, device=dev),
    )


def shard_of(items: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard per id: the reference's uint32 lowbias32 hash mod S.

    Computed in int64, masked to the low 32 bits after every step: the
    products pass 2**63 and wrap, but their low 32 bits are the uint32
    product. A negative (padding) id hashes as ``id & 0xFFFFFFFF``, the
    reference's ``astype(uint32)``.
    """
    x = items.to(torch.int64) & _U32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return (x % num_shards).to(I32)


def sort_block(items: torch.Tensor, universe_bits: Optional[int]) -> torch.Tensor:
    """Ascending-id sort permutation of one (B,) block.

    The reference's choice (``bank.py:126``): the packed single-sort key
    when ``universe_bits`` proves ``item * B`` fits int32, else a stable
    argsort. The two agree for ids inside the universe.
    """
    B = items.shape[0]
    if universe_bits is not None and universe_bits + (B - 1).bit_length() <= 31:
        return stable_partition_perm(items)
    return torch.sort(items, stable=True).indices


@dataclasses.dataclass(frozen=True)
class HashShardRouter:
    """Partition router: row = lowbias32 hash shard; one owner row per id."""

    num_shards: int
    universe_bits: Optional[int] = None

    @property
    def num_rows(self) -> int:
        return self.num_shards

    def owner_of(self, items: torch.Tensor) -> torch.Tensor:
        return shard_of(items, self.num_shards)

    def route_dense(self, items: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) block -> (S, B) row views: ONE shared sort, the sorted block
        broadcast to every row with foreign weights masked to 0."""
        items = items.to(I32)
        weights = weights.to(I32)
        order = sort_block(items, self.universe_bits)
        s_items = items[order]
        s_w = weights[order]
        rows = torch.arange(self.num_rows, dtype=I32,
                            device=items.device)[:, None]
        w_routed = torch.where(self.owner_of(s_items)[None, :] == rows,
                               s_w[None, :], 0)
        return s_items[None, :].expand(self.num_rows, -1), w_routed


# ---------------------------------------------------------------------------
# Banked phase 2: every row's eviction loop in lockstep
# ---------------------------------------------------------------------------

def residual_phase_banked(ids2, cnt2, err2, h_uids, h_net, uoff, start,
                          n_ins, w_del, variant: int):
    """Bank-wide phase 2 (reference ``bank.py:337``): per row, the inserts
    ``h_uids[uoff + i]`` for i in [start, n_ins) each evict the row's
    minimum-count slot (lowest index on ties), then (SS± only) the summed
    unmonitored deletion weight ``w_del`` drains greedily from the
    maximum-error slots. Rows run in lockstep; finished rows freeze."""
    R, k = ids2.shape
    G = h_uids.shape[0]
    lane = torch.arange(k, device=ids2.device)[None, :]
    i = start.clone()
    while bool((i < n_ins).any()):
        active = i < n_ins
        g = torch.clamp(uoff + i, 0, G - 1).long()
        uid = h_uids[g]
        w = h_net[g]
        sel = torch.argmin(cnt2, dim=1)   # first minimum, as jnp.argmin
        mc = cnt2.gather(1, sel[:, None])[:, 0]
        hot = (lane == sel[:, None]) & active[:, None]
        ids2 = torch.where(hot, uid[:, None], ids2)
        cnt2 = torch.where(hot, sat_add(mc, w)[:, None], cnt2)
        err2 = torch.where(hot, mc[:, None], err2)
        i = i + active.to(I32)

    if variant != VARIANT_LAZY:
        rem = w_del.clone()
        sel = torch.argmax(err2, dim=1)
        maxe = err2.gather(1, sel[:, None])[:, 0]
        while bool(((rem > 0) & (maxe > 0)).any()):
            active = (rem > 0) & (maxe > 0)
            d = torch.where(active, torch.minimum(rem, maxe), 0)
            hot = (lane == sel[:, None]) & active[:, None]
            nd = -d[:, None]
            cnt2 = torch.where(hot, sat_add(cnt2, nd), cnt2)
            err2 = torch.where(hot, sat_add(err2, nd), err2)
            sel = torch.argmax(err2, dim=1)
            maxe = err2.gather(1, sel[:, None])[:, 0]
            rem = sat_add(rem, -d)
    return ids2, cnt2, err2


# ---------------------------------------------------------------------------
# Phase-1 prep: the framework half of the fused update
# ---------------------------------------------------------------------------

def phase1_dense_prep(bank: SketchState, row_items: torch.Tensor,
                      row_weights: torch.Tensor, variant: int):
    """Sorts, matching and grouping for one block on row-sorted (R, B) views.

    Reference ``bank.py:422``. Reads only ``bank.ids``. Returns
    ``(delta, h_uids, h_net, i0, mu, nnu, w_del)``: the (R, k) monitored
    addend, the (R, B) grouped residual layout per row
    ``[units | non-units | consumed-by-fill | rest]``, and per row the
    inserts the bulk fill consumes, the unit and non-unit insert counts
    and the summed unmonitored deletion weight.
    """
    R, k = bank.ids.shape
    B = row_items.shape[1]
    row_items = row_items.to(I32).contiguous()
    row_weights = row_weights.to(I32)

    # 1. per-row aggregation (rows are ascending by the router contract)
    head, net = segment_nets(row_items, row_weights)
    valid = head & (row_items >= 0) & (net != 0)

    # 2. monitored matching: the first occurrence is the segment head
    pos = torch.clamp(torch.searchsorted(row_items, bank.ids.contiguous(),
                                         out_int32=True), 0, B - 1).long()
    match = (row_items.gather(1, pos) == bank.ids) & (bank.ids >= 0)
    delta = torch.where(match, net.gather(1, pos), 0)
    monitored = torch.zeros((R, B + 1), dtype=torch.bool, device=bank.ids.device)
    monitored.scatter_(1, torch.where(match, pos, B), True)
    monitored = monitored[:, :B]

    # 3. residual classification + one batched grouping sort
    res_ins = valid & ~monitored & (net > 0)
    rank = torch.cumsum(res_ins, dim=1, dtype=I32) - 1
    n_ins = res_ins.sum(dim=1, dtype=I32)
    empties = (bank.ids == EMPTY).sum(dim=1, dtype=I32)
    i0 = torch.minimum(n_ins, empties)
    consumed = res_ins & (rank < i0[:, None])
    unit = res_ins & ~consumed & (net == 1)
    nonunit = res_ins & ~consumed & (net != 1)
    if variant == VARIANT_LAZY:
        w_del = torch.zeros((R,), dtype=I32, device=bank.ids.device)
    else:
        res_del = valid & ~monitored & (net < 0)
        w_del = torch.where(res_del, -net, 0).sum(dim=1, dtype=I32)
    klass = torch.where(res_ins, torch.where(unit, 0, torch.where(nonunit, 1, 2)),
                        3)
    perm = stable_partition_perm(klass)
    h_uids = row_items.gather(1, perm)
    h_net = net.gather(1, perm)
    mu = unit.sum(dim=1, dtype=I32)
    nnu = nonunit.sum(dim=1, dtype=I32)
    return delta, h_uids, h_net, i0, mu, nnu, w_del


def phase1_apply(bank: SketchState, delta, h_uids, h_net, i0, mu, nnu):
    """The per-cell half of phase 1 (reference ``bank.py:520-529``): the
    saturating add of ``delta``, the bulk empty fill and the unit-weight
    water-fill, every row reading the flat grouped layout at ``r * B``."""
    R, B = h_uids.shape
    flat_u = h_uids.reshape(-1)
    flat_n = h_net.reshape(-1)
    uoff = torch.arange(R, dtype=I32, device=bank.ids.device) * B
    counts = sat_add(bank.counts, delta)
    ids, counts, errors, _ = fill_empty_slots(
        bank.ids, counts, bank.errors, flat_u, flat_n, i0, uoff + mu + nnu)
    return waterfill_unit_inserts(ids, counts, errors, flat_u, mu, uoff)


def phase1_dense(bank: SketchState, row_items: torch.Tensor,
                 row_weights: torch.Tensor, variant: int):
    """Batched phases 1-1.75 (reference ``bank.py:499``): the prep, then
    its per-cell apply. Returns ``(ids1, cnt1, err1, h_uids, h_net, uoff,
    mu, nnu, w_del)`` with the grouped layout flattened to (R*B,), the
    banked residual loop's inputs."""
    R, B = row_items.shape
    delta, h_uids, h_net, i0, mu, nnu, w_del = phase1_dense_prep(
        bank, row_items, row_weights, variant)
    ids1, cnt1, err1 = phase1_apply(bank, delta, h_uids, h_net, i0, mu, nnu)
    uoff = torch.arange(R, dtype=I32, device=bank.ids.device) * B
    return (ids1, cnt1, err1, h_uids.reshape(-1), h_net.reshape(-1), uoff,
            mu, nnu, w_del)


# ---------------------------------------------------------------------------
# Bank-wide reads
# ---------------------------------------------------------------------------

def query_rows(bank: SketchState, rows: torch.Tensor,
               items: torch.Tensor) -> torch.Tensor:
    """Estimated count of ``items[i]`` read from its owner row ``rows[i]``."""
    rows = rows.long()
    ids_r = bank.ids[rows]
    eq = (ids_r == items.to(I32)[:, None]) & (ids_r >= 0)
    hit = torch.where(eq, bank.counts[rows], 0).sum(dim=1, dtype=I32)
    return hit * eq.any(dim=1)


def topk_bank(bank: SketchState, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-m (ids, counts) over all R·k slots; sentinels never show."""
    ids = bank.ids.reshape(-1)
    counts = torch.where(ids < 0, -2**31, bank.counts.reshape(-1))
    idx = top_m(counts, m)
    return ids[idx], counts[idx]


# ---------------------------------------------------------------------------
# Cross-bank reduction and checkpoint consolidation
# ---------------------------------------------------------------------------

def merge_banks(a: SketchState, b: SketchState) -> SketchState:
    """Row-wise mergeable-summaries merge of two same-shape (R, k) banks
    (reference ``bank.py:808``), all rows in one batched ``state.merge``.
    Valid because both banks route with the same router: row r of either
    only ever monitored ids routed to r."""
    return merge(a, b)


def consolidate(bank: SketchState) -> SketchState:
    """Fold the row axis of an (R, k) bank into one (k,) summary
    (reference ``bank.py:818``): a tree of ``state.merge`` pairing rows
    (0, 1), (2, 3), ... with an odd last row carried up a level, as the
    reference pairs them. Merge keeps the top k, so it is not
    associative: another pairing would give another summary. Each level
    is one batched merge."""
    rows = bank
    while rows.ids.shape[0] > 1:
        n = rows.ids.shape[0] // 2
        merged = merge_banks(SketchState(*(t[0:2 * n:2] for t in rows)),
                             SketchState(*(t[1:2 * n:2] for t in rows)))
        if rows.ids.shape[0] % 2:
            merged = SketchState(*(torch.cat([m, t[-1:]])
                                   for m, t in zip(merged, rows)))
        rows = merged
    return SketchState(*(t[0] for t in rows))


__all__ = ["init", "shard_of", "sort_block", "HashShardRouter",
           "residual_phase_banked", "phase1_dense_prep", "phase1_apply",
           "phase1_dense", "query_rows",
           "topk_bank", "merge_banks", "consolidate"]
