"""Bank engine: the stacked (R, k) SketchState and its per-row phases.

Counterpart of ``repro/sketch/bank.py`` for what the kernel and dense
paths need: ``init`` (per-row capacities) and ``row_capacities``,
``shard_of``, ``sort_block``, the routers (``HashShardRouter``,
``DyadicLevelRouter``, ``ShardLevelRouter``), the framework-side prep
``phase1_dense_prep`` (sorts, ``searchsorted``, grouping: plain torch
ops here, as they stayed XLA outside the Pallas kernel), the banked
residual loop ``residual_phase_banked``, the dense fused core
(``update_rows``, ``update_block_fused`` for dense routers), the
bank-wide reads ``query_rows``/``topk_bank`` and the reductions
``merge_banks``/``consolidate``. The partition core
(``_fused_partition``) is not ported yet (ROADMAP.md Queue 1 item 5).

Row layout contract (as in the reference): BLOCKED slots (a row's tail
past its capacity, and the column padding ``ops.py`` adds) hold INT_MAX
counts and zero errors, inert under every phase. Weight > 0 inserts,
< 0 deletes, 0 pads; item ids are non-negative (negative ids are
sentinels).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Sequence, Tuple, Union

import torch

from ..platform import DEFAULT_DEVICE, resolve_device
from .phases import (fill_empty_slots, segment_nets, stable_partition_perm,
                     waterfill_unit_inserts)
from .state import (BLOCKED, EMPTY, I32, INT_MAX, VARIANT_LAZY, SketchState,
                    merge, sat_add, top_m)

_U32 = 0xFFFFFFFF


def init(capacities: Union[int, Sequence[int]],
         num_rows: Optional[int] = None,
         device=DEFAULT_DEVICE) -> SketchState:
    """Empty (R, k) bank with per-row live capacities.

    ``capacities``: a per-row capacity list (a row with fewer than k =
    max(capacities) counters fills its tail with BLOCKED slots: ids -2,
    INT_MAX counts, zero errors, inert under every phase), or one int
    for ``num_rows`` equal rows.
    """
    if isinstance(capacities, numbers.Integral):
        if num_rows is None:
            raise ValueError("an int capacity needs num_rows")
        caps = [int(capacities)] * num_rows
    else:
        caps = [int(c) for c in capacities]
        if num_rows is not None and num_rows != len(caps):
            raise ValueError(f"{len(caps)} capacities for num_rows="
                             f"{num_rows}")
    if not caps or min(caps) < 1:
        raise ValueError(f"need every capacity >= 1 and at least one row, "
                         f"got {caps[:8]}")
    dev = resolve_device(device)
    k = max(caps)
    live = (torch.arange(k, device=dev)[None, :]
            < torch.tensor(caps, device=dev)[:, None])
    return SketchState(
        ids=torch.where(live, EMPTY, BLOCKED).to(I32),
        counts=torch.where(live, 0, INT_MAX).to(I32),
        errors=torch.zeros((len(caps), k), dtype=I32, device=dev),
    )


def row_capacities(bank: SketchState) -> list:
    """Live (non-BLOCKED) counters per row: the inverse of ``init``."""
    return (bank.ids != BLOCKED).sum(dim=1).tolist()


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
    kind = "partition"

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


@dataclasses.dataclass(frozen=True)
class DyadicLevelRouter:
    """Broadcast router: row l monitors ``x >> l`` (the dyadic layers)."""

    bits: int
    kind = "dense"

    @property
    def num_rows(self) -> int:
        return self.bits

    def route_dense(self, items: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) block -> (bits, B) per-layer node views from ONE shared sort
        (a right shift keeps every view ascending) and the (1, B) sorted
        weight row that every layer shares."""
        items = items.to(I32)
        weights = weights.to(I32)
        order = sort_block(items, self.bits)
        shifts = torch.arange(self.bits, dtype=I32, device=items.device)
        return items[order][None, :] >> shifts[:, None], weights[order][None, :]


@dataclasses.dataclass(frozen=True)
class ShardLevelRouter:
    """Composed shard × level router: row (s, l) = ``s * bits + l``
    monitors the level-l nodes owned by hash shard s."""

    bits: int
    num_shards: int
    kind = "dense"

    @property
    def num_rows(self) -> int:
        return self.bits * self.num_shards

    def route_dense(self, items: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) block -> (S * bits, B): the level views repeated per shard,
        each shard's weights masked to the nodes it owns."""
        nodes, w_l = DyadicLevelRouter(self.bits).route_dense(items, weights)
        shape = (self.num_rows, nodes.shape[1])
        rows = nodes[None].expand(self.num_shards, -1, -1).reshape(shape)
        return rows, self.mask_shards(nodes, w_l).reshape(shape)

    def mask_shards(self, nodes: torch.Tensor, w_l: torch.Tensor
                    ) -> torch.Tensor:
        """(bits, B) level weights -> (S, bits, B), foreign weights 0."""
        owner = shard_of(nodes, self.num_shards)
        shards = torch.arange(self.num_shards, dtype=I32,
                              device=nodes.device)[:, None, None]
        return torch.where(owner[None] == shards, w_l[None], 0)


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
# The dense fused core
# ---------------------------------------------------------------------------

def update_rows(bank: SketchState, row_items: torch.Tensor,
                row_weights: torch.Tensor, variant: int = 2) -> SketchState:
    """Ingest pre-routed row-sorted (R, B) views (reference ``bank.py:545``,
    ``_fused_dense``): ``phase1_dense``, then the banked residual loop.
    ``row_weights`` may be the (1, B) row every row shares. The loop is
    kernel 2 for CUDA banks, ``residual_phase_banked`` for CPU banks
    (``ops.sketch_block_update_banked``, the one dispatch)."""
    # ops imports this module, so it is imported here
    from ..kernels.sketch_update import ops

    return ops.sketch_block_update_banked(bank, row_items, row_weights,
                                          variant)


def update_block_fused(bank: SketchState, items: torch.Tensor,
                       weights: torch.Tensor, router,
                       variant: int = 2) -> SketchState:
    """Ingest one (B,) block into the whole bank (reference ``bank.py:719``)
    through a dense router's views and ``update_rows``."""
    if router.kind == "partition":
        raise NotImplementedError(
            "the partition core (bank._fused_partition) is not ported to "
            "repro_torch yet; ROADMAP.md Queue 1 item 5 ports it")
    return update_rows(bank, *router.route_dense(items, weights), variant)


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


def consolidate(bank: SketchState, merge_fn=merge) -> SketchState:
    """Fold the leading axis of an (R, ..., k) bank into one (..., k)
    summary (reference ``bank.py:818``): a tree of ``merge_fn`` pairing
    rows (0, 1), (2, 3), ... with an odd last row carried up a level, as
    the reference pairs them. Merge keeps the top k, so it is not
    associative: another pairing would give another summary. Each level
    is one batched merge; ``state.merge`` batches over every leading
    axis, so an (S, bits, k) bank folds to (bits, k) with it as it is
    (the reference passes a level-vmapped merge for that)."""
    rows = bank
    while rows.ids.shape[0] > 1:
        n = rows.ids.shape[0] // 2
        merged = merge_fn(SketchState(*(t[0:2 * n:2] for t in rows)),
                          SketchState(*(t[1:2 * n:2] for t in rows)))
        if rows.ids.shape[0] % 2:
            merged = SketchState(*(torch.cat([m, t[-1:]])
                                   for m, t in zip(merged, rows)))
        rows = merged
    return SketchState(*(t[0] for t in rows))


__all__ = ["init", "row_capacities", "shard_of", "sort_block",
           "HashShardRouter", "DyadicLevelRouter", "ShardLevelRouter",
           "residual_phase_banked", "phase1_dense_prep", "phase1_apply",
           "phase1_dense", "update_rows", "update_block_fused", "query_rows",
           "topk_bank", "merge_banks", "consolidate"]
