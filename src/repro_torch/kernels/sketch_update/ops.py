"""The fused bank update as the sketch layers call it.

Counterpart of ``repro/kernels/sketch_update/ops.py``
(``_pad_bank`` at :68, ``sketch_block_update_fused`` at :147): pad the
bank to a LANES multiple with BLOCKED slots (the reference kernel sees
the padded bank, and at the INT_MAX rail the water-fill counts BLOCKED
slots among its candidates, so the port pads the same way), run the
framework-side prep, then the
per-cell update: the CUDA kernel for CUDA tensors, its plain PyTorch
version for CPU tensors.
"""
from __future__ import annotations

import torch

from ...sketch.bank import phase1_dense_prep
from ...sketch.state import BLOCKED, I32, INT_MAX, LANES, SketchState
from .kernel import sketch_update_kernel_fused
from .ref import fused_update_ref


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
    """Pad, prep, ``update`` (the kernel wrapper or ``fused_update_ref``),
    then slice the padding off. The caller's bank is not modified: the
    update is a function of the bank, as in the reference, and the padded
    copy is the one the kernel updates in place."""
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


__all__ = ["prep_block", "block_update_with", "sketch_block_update_fused"]
