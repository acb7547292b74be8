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

The serial side (reference ``blocks.py:73-200,370,411``):
``apply_update`` (one signed weighted update, its ``_insert`` and
``_delete``), ``process_stream`` (the raw items scanned in order, the
oracle), ``block_update_serial`` (the scan over the block's aggregated
uniques, the ``"serial"`` backend) and ``block_partition_stats``. On
CUDA states the two scans are kernel 4 (``csrc/serial_update.cu``, its
insert adds saturating as ``apply_update``'s), one launch per call; on
CPU states, ``apply_update`` item by item.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .phases import (fill_empty_slots, segment_nets, stable_partition_perm,
                     waterfill_unit_inserts)
from .state import EMPTY, I32, INT_MAX, VARIANT_LAZY, VARIANT_SSPM, \
    SketchState, sat_add, wrap_add


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=-1, dtype=I32)


# ---------------------------------------------------------------------------
# Single weighted update, and the scans over a block
# ---------------------------------------------------------------------------

def _neg(x: torch.Tensor) -> torch.Tensor:
    """int32 negation that wraps, as JAX's (-INT_MIN is INT_MIN)."""
    return wrap_add(torch.zeros_like(x), -x.to(torch.int64))


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 where none), as ``jnp.argmax`` of a
    boolean array."""
    return torch.argmax(mask.to(I32))


def _insert(state: SketchState, item: torch.Tensor,
            w: torch.Tensor) -> SketchState:
    """Insert ``w >= 0`` of ``item`` (reference ``blocks.py:73``): add to
    its monitored slot, else take the first EMPTY slot, else evict the
    first minimum count (EMPTY slots count as INT_MAX), saturating."""
    ids, counts, errors = state
    # sentinel slots (negative ids) never count as monitored
    eq = (ids == item) & (ids >= 0)
    monitored = eq.any()
    slot_mon = _first(eq)
    empty = ids == EMPTY
    has_empty = empty.any()
    jmin = torch.argmin(torch.where(empty, INT_MAX, counts))
    min_count = counts[jmin]
    sel = torch.where(monitored, slot_mon,
                      torch.where(has_empty, _first(empty), jmin))
    new_count = torch.where(monitored, sat_add(counts[slot_mon], w),
                            torch.where(has_empty, w, sat_add(min_count, w)))
    new_error = torch.where(monitored, errors[slot_mon],
                            torch.where(has_empty, 0, min_count))
    ids, counts, errors = ids.clone(), counts.clone(), errors.clone()
    ids[sel] = item
    counts[sel] = new_count
    errors[sel] = new_error
    return SketchState(ids, counts, errors)


def _delete(state: SketchState, item: torch.Tensor, w: torch.Tensor,
            variant: int) -> SketchState:
    """Delete ``w >= 0`` of ``item`` (reference ``blocks.py:105``): from
    its monitored slot (wrapping), else Lazy drops it and SS± spreads it
    over the maximum-error slots, each absorbing up to its error."""
    ids, counts, errors = state
    eq = (ids == item) & (ids >= 0)
    monitored = eq.any()
    slot_mon = _first(eq)
    counts = counts.clone()
    counts[slot_mon] = wrap_add(counts[slot_mon],
                                torch.where(monitored, _neg(w), 0))
    if variant == VARIANT_LAZY:
        return SketchState(ids, counts, errors)
    rem = torch.where(monitored, 0, w)
    errors = errors.clone()
    while bool(rem > 0) and bool(errors.max() > 0):
        jerr = torch.argmax(errors)
        d = torch.minimum(rem, errors[jerr])
        rem = wrap_add(rem, _neg(d))
        counts[jerr] = wrap_add(counts[jerr], _neg(d))
        errors[jerr] = wrap_add(errors[jerr], _neg(d))
    return SketchState(ids, counts, errors)


def apply_update(state: SketchState, item, weight,
                 variant: int = VARIANT_SSPM) -> SketchState:
    """One signed, weighted update of a (k,) sketch (reference
    ``blocks.py:145``): weight > 0 inserts, < 0 deletes, 0 is a no-op."""
    dev = state.ids.device
    item = torch.as_tensor(item, dtype=I32, device=dev)
    weight = torch.as_tensor(weight, dtype=I32, device=dev)
    if bool(weight > 0):
        return _insert(state, item, weight)
    return _delete(state, item, torch.clamp(_neg(weight), min=0), variant)


def _apply_update_scan(state: SketchState, items: torch.Tensor,
                       weights: torch.Tensor, variant: int,
                       skip_sentinels: bool) -> SketchState:
    """``apply_update`` over the (B,) items in order (reference
    ``blocks.py:160``), on the CPU's plain path. ``skip_sentinels``: the
    aggregated uniques' EMPTY or zero-net entries leave the state as it
    is; the raw stream applies every entry."""
    for item, w in zip(items.to(I32), weights.to(I32)):
        if skip_sentinels and (int(item) == EMPTY or int(w) == 0):
            continue
        state = apply_update(state, item, w, variant)
    return state


def _scan(state: SketchState, items: torch.Tensor, weights: torch.Tensor,
          variant: int, skip_sentinels: bool) -> SketchState:
    """The scan of ``apply_update`` on one (k,) sketch: kernel 4 with its
    adds saturating for a CUDA state (a sentinel entry's weight set to 0,
    which it skips), ``_apply_update_scan`` for a CPU state."""
    if not state.ids.is_cuda:
        return _apply_update_scan(state, items, weights, variant,
                                  skip_sentinels)
    # ops imports this module, so it is imported here
    from ..kernels.sketch_update import kernel, ops

    items = items.to(I32)
    weights = weights.to(I32)
    if skip_sentinels:
        weights = torch.where(items == EMPTY, 0, weights)
    return ops.serial_update_with(kernel.sketch_update_kernel_serial, state,
                                  items, weights, variant, saturate=True)


def process_stream(state: SketchState, items: torch.Tensor,
                   weights: torch.Tensor,
                   variant: int = VARIANT_SSPM) -> SketchState:
    """Exact sequential semantics (reference ``blocks.py:186``, the
    oracle): every raw update of the (B,) block applied in order."""
    return _scan(state, items, weights, variant, skip_sentinels=False)


# ---------------------------------------------------------------------------
# Block aggregation and the phase-1 partition against the monitored set
# ---------------------------------------------------------------------------

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


def block_update_serial(state: SketchState, items: torch.Tensor,
                        weights: torch.Tensor,
                        variant: int = VARIANT_SSPM) -> SketchState:
    """The pre-two-phase baseline (reference ``blocks.py:370``, the
    ``"serial"`` backend): the block aggregated to its uniques, then
    ``apply_update`` over them in ascending id order. Kernel 4 for a CUDA
    state, the plain scan for a CPU state."""
    uids, net = _aggregate_block(items[None], weights[None])
    return _scan(state, uids[0], net[0], variant, skip_sentinels=True)


def block_partition_stats(state: SketchState, items: torch.Tensor,
                          weights: torch.Tensor,
                          variant: int = VARIANT_SSPM):
    """Diagnostics (reference ``blocks.py:411``): (n_unique, n_monitored,
    n_residual) of one (B,) block against a (k,) sketch; n_residual /
    n_unique is the two-phase update's serial fraction, an upper bound."""
    uids, net = _aggregate_block(items[None], weights[None])
    part = partition_block(SketchState(*(t[None] for t in state)), uids, net,
                           variant)
    return (int(_valid_mask(uids, net).sum()), int(part.n_mon[0]),
            int(part.n_res[0]))


__all__ = ["apply_update", "process_stream", "BlockPartition",
           "partition_block", "block_update", "block_update_serial",
           "block_update_batched", "block_partition_stats"]
