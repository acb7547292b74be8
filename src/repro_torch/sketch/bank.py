"""Bank engine: the stacked (R, k) SketchState and its per-row phases.

Counterpart of ``repro/sketch/bank.py``: ``init`` (per-row capacities)
and ``row_capacities``, ``shard_of``, ``sort_block``, the routers
(``HashShardRouter``, ``TenantRouter``, ``DyadicLevelRouter``,
``ShardLevelRouter``), the framework-side preps ``phase1_dense_prep``
and ``phase1_partition_prep`` (sorts, ``searchsorted``, grouping: plain
torch ops here, as they stayed XLA outside the Pallas kernel), the
banked residual loop ``residual_phase_banked``, the two fused cores
under ``update_block_fused``: the partition core (``_fused_partition``,
``update_single``; kernel 1 on the card) and the dense core
(``update_rows``; kernel 2 on the card), the bank-wide reads
``query_rows``/``topk_bank``/``topk_rows`` and the row-index reads of
the reference's gathers and dynamic slices (``gather_rows``,
``slice_start``), the reductions
``merge_banks``/``consolidate`` and the Double SpaceSaving± hooks
``split_signed``/``update_pair``.

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


def _partition_route_dense(router, items: torch.Tensor,
                           weights: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared partition routing (reference ``bank.py:143``): (B,) block ->
    (R, B) row views. ONE shared sort, the sorted block broadcast to every
    row with foreign weights masked to 0, so every row stays ascending and
    aggregates to exactly its own (uid, net) multiset."""
    items = items.to(I32)
    weights = weights.to(I32)
    order = sort_block(items, router.universe_bits)
    s_items = items[order]
    rows = torch.arange(router.num_rows, dtype=I32,
                        device=items.device)[:, None]
    w_routed = torch.where(router.owner_of(s_items)[None, :] == rows,
                           weights[order][None, :], 0)
    return s_items[None, :].expand(router.num_rows, -1), w_routed


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
        """(B,) block -> (S, B): sorted block broadcast, foreign weights 0."""
        return _partition_route_dense(self, items, weights)


@dataclasses.dataclass(frozen=True)
class TenantRouter:
    """Partition router for multi-tenant banks (reference ``bank.py:193``):
    row = tenant (× per-tenant hash shard), tenant-major.

    Items are composite keys ``(tenant << item_bits) | item``; the owner
    row is the tenant, or with ``num_shards > 1`` the tenant's rows
    ``[t*S, (t+1)*S)`` picked by ``shard_of`` of the item part, so each
    tenant's rows partition its stream as a per-tenant
    ``HashShardRouter(num_shards)`` would.
    """

    num_tenants: int
    item_bits: int
    num_shards: int = 1
    kind = "partition"

    @property
    def tenant_bits(self) -> int:
        return (self.num_tenants - 1).bit_length()

    @property
    def universe_bits(self) -> int:
        # the composite-key bound: packed single-sort eligibility
        return self.item_bits + self.tenant_bits

    @property
    def num_rows(self) -> int:
        return self.num_tenants * self.num_shards

    @property
    def monotone_owner(self) -> bool:
        """The owner row is non-decreasing in composite-key order (one row
        per tenant), so every row's entries form one contiguous run of the
        sorted block: the partition core then ranks by prefix-sum
        differences instead of (R, B) masks."""
        return self.num_shards == 1

    def owner_of(self, keys: torch.Tensor) -> torch.Tensor:
        keys = keys.to(I32)
        tenant = keys >> self.item_bits
        if self.num_shards == 1:
            return tenant
        item = keys & ((1 << self.item_bits) - 1)
        return tenant * self.num_shards + shard_of(item, self.num_shards)

    def route_dense(self, items: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B,) block -> (T*S, B): sorted block broadcast, foreign 0."""
        return _partition_route_dense(self, items, weights)


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


def phase1_apply(bank: SketchState, delta, h_uids, h_net, i0, mu, nnu, uoff):
    """The per-cell half of phase 1 (reference ``bank.py:520-529``,
    ``:706-711``): the saturating add of ``delta``, the bulk empty fill
    and the unit-weight water-fill, every row reading the flat (G,)
    grouped layout from ``uoff[r]``, its [units | non-units | consumed]
    run."""
    counts = sat_add(bank.counts, delta)
    ids, counts, errors, _ = fill_empty_slots(
        bank.ids, counts, bank.errors, h_uids, h_net, i0, uoff + mu + nnu)
    return waterfill_unit_inserts(ids, counts, errors, h_uids, mu, uoff)


def phase1_dense(bank: SketchState, row_items: torch.Tensor,
                 row_weights: torch.Tensor, variant: int):
    """Batched phases 1-1.75 (reference ``bank.py:499``): the prep, then
    its per-cell apply. Returns ``(ids1, cnt1, err1, h_uids, h_net, uoff,
    mu, nnu, w_del)`` with the grouped layout flattened to (R*B,), the
    banked residual loop's inputs."""
    R, B = row_items.shape
    delta, h_uids, h_net, i0, mu, nnu, w_del = phase1_dense_prep(
        bank, row_items, row_weights, variant)
    uoff = torch.arange(R, dtype=I32, device=bank.ids.device) * B
    h_uids, h_net = h_uids.reshape(-1), h_net.reshape(-1)
    ids1, cnt1, err1 = phase1_apply(bank, delta, h_uids, h_net, i0, mu, nnu,
                                    uoff)
    return ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del


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


# ---------------------------------------------------------------------------
# The partition core: global phase 1, one grouping sort for all rows
# ---------------------------------------------------------------------------

def _seg_sum(vals: torch.Tensor, start: torch.Tensor,
             end: torch.Tensor) -> torch.Tensor:
    """Per-run sums of ``vals`` over ``[start[r], end[r])``: differences of
    its int32 prefix sums, which wrap as the reference's."""
    p = torch.cumsum(vals.to(I32), dim=0, dtype=I32)
    p = torch.cat([p.new_zeros(1), p])
    return p[end.long()] - p[start.long()]


def phase1_partition_prep(bank: SketchState, items: torch.Tensor,
                          weights: torch.Tensor, router, variant: int):
    """Steps 1-3 of the partition core (reference ``_fused_partition``,
    ``bank.py:560-700``) for a raw (B,) block and a partition router.

    1. one shared sort of the block and one segment pass to per-unique
       nets, read at each segment's head;
    2. the monitored match of the stacked (R*k) ids, one ``searchsorted``
       into the sorted block (an id matches only in its owner row);
    3. the residual inserts ranked within their owner row (prefix-sum
       differences at run boundaries for a router whose owner is monotone
       in key order, else (R, B) one-hot ranks), then ONE packed-key sort
       that lays every row's [units | non-units | consumed-by-fill] run
       back to back in one (B,) array.

    Reads only ``bank.ids``. Returns ``(delta, h_uids, h_net, i0, mu,
    nnu, w_del, uoff)``: the (R, k) monitored addend, the flat (B,)
    grouped layout, and per row the inserts the bulk fill consumes, the
    unit and non-unit insert counts, the summed unmonitored deletion
    weight and the start of its run. No value is read back to the host.
    """
    S, k = bank.ids.shape
    items = items.to(I32)
    weights = weights.to(I32)
    B = items.shape[0]
    if (3 * S + 1) * B >= 2**31:
        # the grouping key is klass * B + idx with 3S + 1 classes
        raise ValueError(
            f"fused partition update needs (3*rows+1)*block < 2^31 for the "
            f"packed grouping sort; got rows={S}, block={B}. Use "
            f"path='vmap' (or fewer rows per launch).")
    dev = items.device

    # 1. shared sort + in-place segment aggregation (nets at the heads)
    order = sort_block(items, router.universe_bits)
    uids = items[order].contiguous()
    head, net = segment_nets(uids[None, :], weights[order][None, :])
    head, net = head[0], net[0]
    valid = head & (uids >= 0) & (net != 0)
    owner = router.owner_of(uids)

    # 2. monitored matching of all rows: the first occurrence is the head
    flat_ids = bank.ids.reshape(-1).contiguous()
    pos = torch.clamp(torch.searchsorted(uids, flat_ids, out_int32=True),
                      0, B - 1).long()
    match = (uids[pos] == flat_ids) & (flat_ids >= 0)
    delta = torch.where(match, net[pos], 0).reshape(S, k)
    monitored = torch.zeros(B + 1, dtype=torch.bool, device=dev)
    monitored.scatter_(0, torch.where(match, pos, B), True)
    monitored = monitored[:B]

    # 3. in-row ranks and per-row tallies, then one grouping sort
    owner_c = torch.clamp(owner, 0, S - 1).long()
    res_ins = valid & ~monitored & (net > 0)
    res_del = valid & ~monitored & (net < 0)
    empties = (bank.ids == EMPTY).sum(dim=1, dtype=I32)
    if getattr(router, "monotone_owner", False):
        rows = torch.arange(S, dtype=I32, device=dev)
        start = torch.searchsorted(owner, rows)
        end = torch.searchsorted(owner, rows, right=True)
        ex_ins = torch.cumsum(res_ins, dim=0, dtype=I32) - res_ins.to(I32)
        n_ins = _seg_sum(res_ins, start, end)
        # a gather clamps its index, as the reference's does: an entry
        # before every row's run (a negative key) reads the last entry
        rank = ex_ins - ex_ins[torch.clamp(start[owner_c], max=B - 1)]
        i0 = torch.minimum(n_ins, empties)
        consumed = res_ins & (rank < i0[owner_c])
        unit = res_ins & ~consumed & (net == 1)
        nonunit = res_ins & ~consumed & (net != 1)
        w_del = (torch.zeros(S, dtype=I32, device=dev)
                 if variant == VARIANT_LAZY
                 else _seg_sum(torch.where(res_del, -net, 0), start, end))
        mu = _seg_sum(unit, start, end)
        nnu = _seg_sum(nonunit, start, end)
    else:
        owner_mat = owner[None, :] == torch.arange(S, dtype=I32,
                                                   device=dev)[:, None]
        rank_mat = torch.cumsum(owner_mat & res_ins[None, :], dim=1,
                                dtype=I32)
        n_ins = rank_mat[:, -1]
        rank = rank_mat.gather(0, owner_c[None, :])[0] - 1
        i0 = torch.minimum(n_ins, empties)
        consumed = res_ins & (rank < i0[owner_c])
        unit = res_ins & ~consumed & (net == 1)
        nonunit = res_ins & ~consumed & (net != 1)
        w_del = (torch.zeros(S, dtype=I32, device=dev)
                 if variant == VARIANT_LAZY
                 else torch.where(owner_mat & res_del[None, :], -net[None, :],
                                  0).sum(dim=1, dtype=I32))
        mu = (owner_mat & unit[None, :]).sum(dim=1, dtype=I32)
        nnu = (owner_mat & nonunit[None, :]).sum(dim=1, dtype=I32)
    klass = torch.where(
        res_ins, owner_c.to(I32) * 3 + torch.where(
            unit, 0, torch.where(nonunit, 1, 2)), 3 * S)
    perm = stable_partition_perm(klass)
    cc = torch.stack([mu, nnu, i0], dim=1).reshape(-1)
    uoff = (torch.cumsum(cc, dim=0, dtype=I32) - cc)[0::3].contiguous()
    return delta, uids[perm], net[perm], i0, mu, nnu, w_del, uoff


def _fused_partition(bank: SketchState, items: torch.Tensor,
                     weights: torch.Tensor, router, variant: int
                     ) -> SketchState:
    """The partition core (reference ``bank.py:560``): the prep
    (``phase1_partition_prep``), then every row's per-cell update read
    from the one grouped layout at its offset: kernel 1 for CUDA banks,
    ``fused_update_ref`` (the reference's batched phases and banked
    residual loop) for CPU banks (``ops.sketch_block_update_partition``,
    the one dispatch). Bit-identical to ``blocks.block_update`` on each
    row's own substream."""
    # ops imports this module, so it is imported here
    from ..kernels.sketch_update import ops

    return ops.sketch_block_update_partition(bank, items, weights, router,
                                             variant)


def update_block_fused(bank: SketchState, items: torch.Tensor,
                       weights: torch.Tensor, router,
                       variant: int = 2) -> SketchState:
    """Ingest one (B,) block into the whole bank (reference ``bank.py:719``):
    partition routers through the partition core, dense routers through
    their views and ``update_rows``."""
    if router.kind == "partition":
        return _fused_partition(bank, items, weights, router, variant)
    return update_rows(bank, *router.route_dense(items, weights), variant)


def update_single(state: SketchState, items: torch.Tensor,
                  weights: torch.Tensor, variant: int = 2,
                  universe_bits: Optional[int] = None) -> SketchState:
    """Fused ingest of a flat (k,) sketch as a one-row bank (reference
    ``bank.py:737``): the partition core with one shard, whose run is the
    whole block. Equal to ``blocks.block_update``, bit for bit."""
    bank = SketchState(*(t[None] for t in state))
    out = _fused_partition(bank, items, weights,
                           HashShardRouter(1, universe_bits), variant)
    return SketchState(*(t[0] for t in out))


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


def gather_rows(rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Row indices as the reference's gathers read them: a negative index
    counts from the end, then every index is clamped into the bank."""
    rows = rows.long()
    return torch.where(rows < 0, rows + num_rows, rows).clamp(0, num_rows - 1)


def slice_start(tenant, num_shards: int, num_rows: int) -> int:
    """The first row of a tenant's row slice, ``tenant * S``, read as the
    reference's dynamic slice reads it: a negative start counts from the
    end of the bank, then the slice is clamped into it."""
    start = int(tenant) * num_shards
    if start < 0:
        start += num_rows
    return min(max(start, 0), num_rows - num_shards)


def topk_bank(bank: SketchState, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-m (ids, counts) over all R·k slots; sentinels never show."""
    ids = bank.ids.reshape(-1)
    counts = torch.where(ids < 0, -2**31, bank.counts.reshape(-1))
    idx = top_m(counts, m)
    return ids[idx], counts[idx]


def topk_rows(bank: SketchState, rows: torch.Tensor,
              m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m (ids, counts) over a row subset, ``m <= len(rows) * k``
    (reference ``bank.py:790``): exact for an ownership-closed subset (a
    tenant's rows) and blind to every other row."""
    rows = rows.long()
    ids = bank.ids[rows].reshape(-1)
    counts = torch.where(ids < 0, -2**31, bank.counts[rows].reshape(-1))
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


# ---------------------------------------------------------------------------
# Second-bank coupling: the Double SpaceSaving± hooks
# ---------------------------------------------------------------------------

def split_signed(weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One signed block as the family's two insert-only weight streams
    (reference ``bank.py:845``): insertions, and deletions as insertions;
    padding stays 0 on both sides."""
    w = weights.to(I32)
    return torch.clamp(w, min=0), torch.clamp(-w, min=0)


def update_pair(ins_bank: SketchState, del_bank: SketchState,
                items: torch.Tensor, weights: torch.Tensor, router,
                variant: int = 2) -> Tuple[SketchState, SketchState]:
    """Coupled two-bank ingest (reference ``bank.py:858``): both banks
    share the router, each takes its insert-only stream; they may differ
    in per-row capacities."""
    w_ins, w_del = split_signed(weights)
    return (update_block_fused(ins_bank, items, w_ins, router, variant),
            update_block_fused(del_bank, items, w_del, router, variant))


__all__ = ["init", "row_capacities", "shard_of", "sort_block",
           "HashShardRouter", "TenantRouter", "DyadicLevelRouter",
           "ShardLevelRouter", "residual_phase_banked", "phase1_dense_prep",
           "phase1_apply", "phase1_dense", "phase1_partition_prep",
           "update_rows", "update_block_fused", "update_single",
           "gather_rows", "slice_start", "query_rows", "topk_bank",
           "topk_rows", "merge_banks",
           "consolidate", "split_signed", "update_pair"]
