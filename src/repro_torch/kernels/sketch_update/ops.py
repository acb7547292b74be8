"""The sketch_update kernels as the sketch layers call them.

Counterpart of ``repro/kernels/sketch_update/ops.py``. Each entry point
shapes the state for its kernel, runs the framework-side phases, then
the kernel for CUDA tensors or its plain PyTorch version (``ref.py``)
for CPU tensors, and slices the padding off. The caller's state is
never modified: the kernels update fresh padded copies in place.

- ``sketch_block_update_fused`` (reference :147): pad the bank to a
  LANES multiple with BLOCKED slots (the reference kernel sees the padded
  bank, and at the INT_MAX rail the water-fill counts BLOCKED slots
  among its candidates, so the port pads the same way), the prep
  ``bank.phase1_dense_prep``, then the fused per-cell update;
- ``sketch_block_update_partition``: the partition core's update of
  one raw block (the reference's ``bank._fused_partition``, the
  ``"bank"`` backend of the frequency kind): pad, the partition prep
  ``bank.phase1_partition_prep``, then the fused per-cell update reading
  each row's run of the one grouped layout at its offset;
- ``sketch_block_update_stream`` (:196): an (NB, B) stream of raw
  blocks, prepped (a dense router's routed first) and updated block
  after block on a bank padded once, with no host round trip between
  blocks;
- ``sketch_block_update_banked`` (:107): ``bank.phase1_dense`` in torch,
  then one banked phase-2 launch over the padded bank (the split path);
- ``sketch_block_update_batched`` (:247) and ``sketch_block_update``
  (:80): ``blocks._phase1`` on E stacked sketches, their (E, R, LANES)
  row view, then one phase-2 kernel call for all E (the ``block``
  backend; two launches past 128 rows a sketch);
- ``sketch_block_update_serial`` (:268): one launch of the serial
  baseline over the raw block;
- ``sketch_unbiased_update``: the family's unbiased variant on its two
  banks, ``family.unbiased_prep``'s owner-sorted layout, then one launch
  of the unbiased kernel (the reference runs it as a plain-JAX scan,
  ``family.py:183``).

The ``*_with`` functions take the update to run (a kernel wrapper or
its plain version), so ``chip_smoke.py`` can run both on the card.
"""
from __future__ import annotations

import torch

from ...sketch.bank import (phase1_dense, phase1_dense_prep,
                           phase1_partition_prep)
from ...sketch.blocks import _phase1
from ...sketch.family import unbiased_prep
from ...sketch.phases import pad_rows
from ...sketch.state import BLOCKED, I32, INT_MAX, LANES, SketchState
from .kernel import (sketch_residual_kernel, sketch_residual_kernel_banked,
                     sketch_unbiased_kernel, sketch_update_kernel_fused,
                     sketch_update_kernel_serial)
from .ref import (fused_update_ref, residual_phase, residual_phase_banked,
                  serial_update_ref, unbiased_update_ref)


def _pad_bank(bank: SketchState) -> SketchState:
    """Fresh (R, K_pad) copies of the bank, K_pad a LANES multiple; the
    padding slots hold BLOCKED ids, INT_MAX counts and zero errors."""
    R, k = bank.ids.shape
    pad = (-k) % LANES

    def cat(t, fill):
        tail = torch.full((R, pad), fill, dtype=I32, device=t.device)
        return torch.cat([t, tail], dim=1)

    return SketchState(cat(bank.ids, BLOCKED), cat(bank.counts, INT_MAX),
                       cat(bank.errors, 0))


def prep_block(bank: SketchState, row_items: torch.Tensor,
               row_weights: torch.Tensor, variant: int):
    """The per-cell update's inputs for one block: the padded copy of the
    bank and ``phase1_dense_prep``'s ``(delta, h_uids, h_net, i0, mu, nnu,
    w_del)``. Prep reads only the ids: BLOCKED padding is not EMPTY and
    never matches, so prepping the padded bank is exact."""
    padded = _pad_bank(bank)
    return padded, phase1_dense_prep(padded, row_items, row_weights, variant)


def block_update_with(update, bank: SketchState, row_items: torch.Tensor,
                      row_weights: torch.Tensor, variant: int) -> SketchState:
    """Pad, prep, ``update`` (the fused kernel or ``fused_update_ref``),
    then slice the padding off."""
    k = bank.ids.shape[1]
    padded, prep = prep_block(bank, row_items, row_weights, variant)
    ids, counts, errors = update(*padded, *prep, variant=variant)
    return SketchState(ids[:, :k], counts[:, :k], errors[:, :k])


def sketch_block_update_fused(bank: SketchState, row_items: torch.Tensor,
                              row_weights: torch.Tensor,
                              variant: int = 2) -> SketchState:
    """Whole-bank update of one block from row-sorted (R, B) views.

    CUDA banks go through the hand-written kernel (one launch per
    block), CPU banks through its plain version; the result is the
    reference ``ops.sketch_block_update_fused``'s, bit for bit.
    """
    update = (sketch_update_kernel_fused if bank.ids.is_cuda
              else fused_update_ref)
    return block_update_with(update, bank, row_items, row_weights, variant)


def prep_partition(bank: SketchState, items: torch.Tensor,
                   weights: torch.Tensor, router, variant: int):
    """The per-cell update's inputs for one raw block under a partition
    router: the padded copy of the bank and ``phase1_partition_prep``'s
    ``(delta, h_uids, h_net, i0, mu, nnu, w_del, uoff)``."""
    padded = _pad_bank(bank)
    return padded, phase1_partition_prep(padded, items, weights, router,
                                         variant)


def partition_update_with(update, bank: SketchState, items: torch.Tensor,
                          weights: torch.Tensor, router,
                          variant: int) -> SketchState:
    """Pad, the partition prep, ``update`` (the fused kernel or
    ``fused_update_ref``, each reading row r's run from ``uoff[r]``), then
    slice the padding off."""
    k = bank.ids.shape[1]
    padded, prep = prep_partition(bank, items, weights, router, variant)
    ids, counts, errors = update(*padded, *prep, variant=variant)
    return SketchState(ids[:, :k], counts[:, :k], errors[:, :k])


def sketch_block_update_partition(bank: SketchState, items: torch.Tensor,
                                  weights: torch.Tensor, router,
                                  variant: int = 2) -> SketchState:
    """Whole-bank update of one raw (B,) block under a partition router
    (the reference's ``bank._fused_partition``): the partition prep, then
    kernel 1 (one launch per block) for CUDA banks, its plain version for
    CPU banks. Bit-identical to the reference's partition core."""
    update = (sketch_update_kernel_fused if bank.ids.is_cuda
              else fused_update_ref)
    return partition_update_with(update, bank, items, weights, router,
                                 variant)


def sketch_block_update_stream(bank: SketchState, blocks_items: torch.Tensor,
                               blocks_weights: torch.Tensor, router,
                               variant: int = 2) -> SketchState:
    """Multi-block ingest of an (NB, B) stream of raw blocks (reference
    :196): per block, the prep -> the fused update, the bank padded once
    and carried padded from block to block. A partition router's blocks
    go through the partition prep as they are; a dense router's are
    routed to their (R, B) views first.

    On the card the blocks move to the device in one copy (none if they
    are there already) and each block is one launch sequence on the
    caller's stream, with no host synchronisation between blocks: the
    prep of block i+1 queues behind block i's kernel. On the CPU it is
    the plain fold. Bit-identical to folding ``bank.update_block_fused``
    over the blocks (prep reads only the ids, and the kernel never
    touches the BLOCKED padding, so padding once is padding per block).
    """
    R, k = bank.ids.shape
    update = (sketch_update_kernel_fused if bank.ids.is_cuda
              else fused_update_ref)
    dev = bank.ids.device
    blocks_items = blocks_items.to(device=dev, dtype=I32, non_blocking=True)
    blocks_weights = blocks_weights.to(device=dev, dtype=I32,
                                       non_blocking=True)
    carry = _pad_bank(bank)
    for items, weights in zip(blocks_items, blocks_weights):
        if router.kind == "partition":
            prep = phase1_partition_prep(carry, items, weights, router,
                                         variant)
        else:
            prep = phase1_dense_prep(carry, *router.route_dense(items,
                                                                weights),
                                     variant)
        carry = SketchState(*update(*carry, *prep, variant=variant))
    return SketchState(*(t[:, :k] for t in carry))


def banked_update_with(residual, bank: SketchState, row_items: torch.Tensor,
                       row_weights: torch.Tensor, variant: int) -> SketchState:
    """``bank.phase1_dense``, pad, ``residual`` (the banked kernel or
    ``residual_phase_banked``), then slice the padding off."""
    k = bank.ids.shape[1]
    ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del = phase1_dense(
        bank, row_items, row_weights, variant)
    padded = _pad_bank(SketchState(ids1, cnt1, err1))
    ids, counts, errors = residual(*padded, h_uids, h_net, uoff, mu,
                                   mu + nnu, w_del, variant=variant)
    return SketchState(ids[:, :k], counts[:, :k], errors[:, :k])


def sketch_block_update_banked(bank: SketchState, row_items: torch.Tensor,
                               row_weights: torch.Tensor,
                               variant: int = 2) -> SketchState:
    """Whole-bank two-phase update of one block from row-sorted (R, B)
    views: phase 1 in torch, then one banked phase-2 launch. Equal to
    ``sketch_block_update_fused``, bit for bit."""
    residual = (sketch_residual_kernel_banked if bank.ids.is_cuda
                else residual_phase_banked)
    return banked_update_with(residual, bank, row_items, row_weights, variant)


def split_update_with(residual, states: SketchState, items: torch.Tensor,
                      weights: torch.Tensor, variant: int,
                      assume_sorted: bool = False) -> SketchState:
    """``blocks._phase1`` on (E, k) states and (E, B) blocks, the
    (E, R, LANES) row view, ``residual`` (the kernel or
    ``residual_phase``), then the (E, k) state back."""
    E, k = states.ids.shape
    ids1, cnt1, err1, r_uids, r_net, start, end, w_del = _phase1(
        states, items, weights, variant, assume_sorted)
    ids2, cnt2, err2 = residual(*pad_rows(ids1, cnt1, err1), r_uids, r_net,
                                start, end, w_del, variant=variant)
    return SketchState(*(t.reshape(E, -1)[:, :k] for t in (ids2, cnt2, err2)))


def sketch_block_update_batched(states: SketchState, items: torch.Tensor,
                                weights: torch.Tensor, variant: int = 2,
                                assume_sorted: bool = False) -> SketchState:
    """Two-phase update of E stacked sketches, (E, k) states and (E, B)
    blocks, with one phase-2 kernel call for all E. ``assume_sorted``: every
    row of ``items`` is already ascending (the sharded router's views)."""
    residual = (sketch_residual_kernel if states.ids.is_cuda
                else residual_phase)
    return split_update_with(residual, states, items, weights, variant,
                             assume_sorted)


def sketch_block_update(state: SketchState, items: torch.Tensor,
                        weights: torch.Tensor, variant: int = 2,
                        assume_sorted: bool = False) -> SketchState:
    """Two-phase update of one (k,) sketch with one (B,) block."""
    out = sketch_block_update_batched(
        SketchState(*(t[None] for t in state)), items[None], weights[None],
        variant, assume_sorted)
    return SketchState(*(t[0] for t in out))


def serial_update_with(update, state: SketchState, items: torch.Tensor,
                       weights: torch.Tensor, variant: int,
                       saturate: bool = False) -> SketchState:
    """The (R, LANES) row view of one (k,) sketch, ``update`` (the serial
    kernel or ``serial_update_ref``) over the (B,) items in order, then
    (k,) back. ``saturate``: the insert adds saturate, as
    ``blocks.apply_update``'s (``blocks.process_stream`` and
    ``block_update_serial``), not wrap as the reference's serial Pallas
    kernel's (``sketch_block_update_serial``)."""
    k = state.ids.shape[0]
    ids2, cnt2, err2 = update(
        *pad_rows(*state), items.to(I32).contiguous(),
        weights.to(I32).contiguous(), variant=variant, saturate=saturate)
    return SketchState(*(t.reshape(-1)[:k] for t in (ids2, cnt2, err2)))


def sketch_block_update_serial(state: SketchState, items: torch.Tensor,
                               weights: torch.Tensor,
                               variant: int = 2) -> SketchState:
    """The pre-two-phase baseline: every raw update of the (B,) block
    applied in order to one (k,) sketch, one launch per block."""
    update = (sketch_update_kernel_serial if state.ids.is_cuda
              else serial_update_ref)
    return serial_update_with(update, state, items, weights, variant)


def unbiased_update_with(update, ins: SketchState, dels: SketchState,
                        items: torch.Tensor, weights: torch.Tensor,
                        u: torch.Tensor, router):
    """``family.unbiased_prep``, then ``update`` (the unbiased kernel or
    ``unbiased_update_ref``) on copies of both banks. Returns the new
    (insert bank, delete bank)."""
    s_items, s_w, perm, roff = unbiased_prep(items, weights, router)
    out = update(*(t.clone() for t in ins), *(t.clone() for t in dels),
                 s_items, s_w, u.to(torch.float32).contiguous(), perm, roff)
    return SketchState(*out[:3]), SketchState(*out[3:])


def sketch_unbiased_update(ins: SketchState, dels: SketchState,
                           items: torch.Tensor, weights: torch.Tensor,
                           u: torch.Tensor, router):
    """The unbiased variant's update of one raw (B,) block: one launch of
    the unbiased kernel for CUDA banks (both banks, one CTA a row), its
    plain version for CPU banks. ``u``: (2, B) float32 uniforms, row 0
    for the insert bank and row 1 for the delete bank, by position in
    the id-sorted block."""
    update = (sketch_unbiased_kernel if ins.ids.is_cuda
              else unbiased_update_ref)
    return unbiased_update_with(update, ins, dels, items, weights, u, router)


__all__ = ["prep_block", "block_update_with", "sketch_block_update_fused",
           "prep_partition", "partition_update_with",
           "sketch_block_update_partition", "sketch_block_update_stream",
           "banked_update_with", "sketch_block_update_banked",
           "split_update_with", "sketch_block_update_batched",
           "sketch_block_update", "serial_update_with",
           "sketch_block_update_serial", "unbiased_update_with",
           "sketch_unbiased_update"]
