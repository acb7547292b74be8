"""The two-phase monitored-first block update of stacked sketches.

Counterpart of ``repro/sketch/blocks.py`` for the ``backend="block"``
path: ``_aggregate_block`` (:202), ``_valid_mask``, ``BlockPartition``,
``partition_block`` (:251), ``_phase1`` (:301), ``block_update`` (:337)
and ``block_update_batched`` (:388). Everything is batched over E
stacked sketches, as the reference ``vmap``s it; ``block_update`` is the
E = 1 case of ``block_update_batched``.

A block is segment-aggregated to per-unique net weights; monitored
deltas commute and land in one saturating gather-add (phase 1); the
leading residual inserts fill EMPTY slots (phase 1.5); unit-weight
evictions are water-filled at once (phase 1.75); only the non-unit
evictions and the SS± deletion spread run as a sequential loop
(phase 2, ``phases.residual_phase``), which the CUDA kernel
``sketch_residual_kernel`` runs on the card.

Not ported yet (ROADMAP.md Queue 1 item 4): ``apply_update``,
``process_stream`` and ``block_update_serial``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .phases import (fill_empty_slots, segment_nets, stable_partition_perm,
                     waterfill_unit_inserts)
from .state import EMPTY, I32, INT_MAX, VARIANT_LAZY, VARIANT_SSPM, \
    SketchState, sat_add


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=-1, dtype=I32)


def _aggregate_block(items: torch.Tensor, weights: torch.Tensor,
                     assume_sorted: bool = False):
    """Net weight per unique item of each (E, B) row block.

    Returns (uids, net), both (E, B): each row's uniques in ascending id
    order, then EMPTY ids with net 0. ``assume_sorted`` skips the sort
    when every row is already ascending (the sharded router's views).
    """
    items = items.to(I32)
    weights = weights.to(I32)
    E, B = items.shape
    if assume_sorted:
        s, w = items, weights
    else:
        order = torch.sort(items, dim=-1, stable=True).indices
        s, w = items.gather(1, order), weights.gather(1, order)
    head, net_h = segment_nets(s, w)
    perm = stable_partition_perm(torch.where(head, 0, 1))
    live = torch.arange(B, device=items.device) < _sum(head)[:, None]
    uids = torch.where(live, s.gather(1, perm), EMPTY)
    net = torch.where(live, net_h.gather(1, perm), 0)
    return uids, net


def _valid_mask(uids: torch.Tensor, net: torch.Tensor) -> torch.Tensor:
    """Aggregated entries that carry real work: non-sentinel id, nonzero net."""
    return (uids >= 0) & (net != 0)


class BlockPartition(NamedTuple):
    """Phase-1 output per sketch: monitored deltas applied, residual
    inserts compacted to the front."""

    counts1: torch.Tensor  # (E, k) counts after the monitored gather-add
    r_uids: torch.Tensor   # (E, B) residual insert uids, ascending, then 0
    r_net: torch.Tensor    # (E, B) net weights aligned with r_uids
    n_ins: torch.Tensor    # (E,) residual insert uniques
    w_del: torch.Tensor    # (E,) summed unmonitored deletion weight (0: lazy)
    n_res: torch.Tensor    # (E,) residual uniques incl. deletes (diagnostics)
    n_mon: torch.Tensor    # (E,) monitored uniques (diagnostics)


def partition_block(state: SketchState, uids: torch.Tensor, net: torch.Tensor,
                    variant: int = VARIANT_SSPM) -> BlockPartition:
    """Phase-1 split of aggregated (E, B) blocks against each sketch's
    monitored set: the k slot ids are binary-searched into the sorted
    uniques, so the monitored delta is one gather per slot."""
    E, B = uids.shape
    valid = _valid_mask(uids, net)
    usearch = torch.where(uids >= 0, uids, INT_MAX).contiguous()
    ids = state.ids.contiguous()
    pos = torch.clamp(torch.searchsorted(usearch, ids, out_int32=True),
                      0, B - 1).long()
    match = (usearch.gather(1, pos) == ids) & (ids >= 0)
    counts1 = sat_add(state.counts, torch.where(match, net.gather(1, pos), 0))
    monitored = torch.zeros((E, B + 1), dtype=torch.bool, device=uids.device)
    monitored.scatter_(1, torch.where(match, pos, B), True)
    monitored = monitored[:, :B]
    res_ins = valid & ~monitored & (net > 0)
    if variant == VARIANT_LAZY:
        # Lazy SS± drops unmonitored deletions entirely (Alg 3)
        w_del = torch.zeros((E,), dtype=I32, device=uids.device)
        n_res = _sum(res_ins)
    else:
        res_del = valid & ~monitored & (net < 0)
        w_del = _sum(-torch.where(res_del, net, 0))
        n_res = _sum(res_ins) + _sum(res_del)
    perm = stable_partition_perm(torch.where(res_ins, 0, 1))
    n_ins = _sum(res_ins)
    front = torch.arange(B, device=uids.device) < n_ins[:, None]
    r_uids = torch.where(front, uids.gather(1, perm), 0)
    r_net = torch.where(front, net.gather(1, perm), 0)
    n_mon = _sum(match & valid.gather(1, pos))
    return BlockPartition(counts1, r_uids, r_net, n_ins, w_del, n_res, n_mon)


def _phase1(state: SketchState, items: torch.Tensor, weights: torch.Tensor,
            variant: int, assume_sorted: bool = False):
    """Phases 1-1.75 of (E, k) sketches and (E, B) blocks.

    Returns the updated (E, k) ``ids, counts, errors``, the residual
    layout ``r_uids, r_net`` (E, B) grouped [unit inserts | non-unit
    inserts | rest], and per sketch the non-unit range ``[start, end)``
    and the summed unmonitored deletion weight: phase 2's inputs.
    """
    uids, net = _aggregate_block(items, weights, assume_sorted)
    part = partition_block(state, uids, net, variant)
    E, B = part.r_uids.shape
    dev = uids.device
    off = torch.arange(E, dtype=I32, device=dev) * B
    ids1, cnt1, err1, i0 = fill_empty_slots(
        state.ids, part.counts1, state.errors, part.r_uids.reshape(-1),
        part.r_net.reshape(-1), part.n_ins, off, width=B)
    idx = torch.arange(B, device=dev)
    remaining = (idx >= i0[:, None]) & (idx < part.n_ins[:, None])
    unit = remaining & (part.r_net == 1)
    nonunit = remaining & (part.r_net != 1)
    perm = stable_partition_perm(
        torch.where(unit, 0, torch.where(nonunit, 1, 2)))
    r_uids = part.r_uids.gather(1, perm)
    r_net = part.r_net.gather(1, perm)
    m_u = _sum(unit)
    ids1, cnt1, err1 = waterfill_unit_inserts(
        ids1, cnt1, err1, r_uids.reshape(-1), m_u, off, width=B)
    return (ids1, cnt1, err1, r_uids, r_net, m_u, m_u + _sum(nonunit),
            part.w_del)


def block_update_batched(states: SketchState, items: torch.Tensor,
                         weights: torch.Tensor, variant: int = VARIANT_SSPM,
                         assume_sorted: bool = False) -> SketchState:
    """Two-phase update of E stacked sketches, (E, k) states and (E, B)
    blocks, one phase-2 launch for all of them: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors
    (``ops.sketch_block_update_batched``, the one dispatch)."""
    # ops imports _phase1 from this module, so it is imported here
    from ..kernels.sketch_update import ops

    return ops.sketch_block_update_batched(states, items, weights, variant,
                                           assume_sorted)


def block_update(state: SketchState, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM,
                 assume_sorted: bool = False) -> SketchState:
    """Two-phase update of one (k,) sketch with one (B,) block
    (``ops.sketch_block_update``)."""
    from ..kernels.sketch_update import ops

    return ops.sketch_block_update(state, items, weights, variant,
                                   assume_sorted)


__all__ = ["BlockPartition", "partition_block", "block_update",
           "block_update_batched"]
