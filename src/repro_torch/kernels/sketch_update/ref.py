"""Plain PyTorch versions of the sketch_update kernels.

Each computes what its CUDA kernel computes, and what the reference's
Pallas kernel body computes, in eager PyTorch. ``ops.py`` runs them for
CPU tensors; ``chip_smoke.py`` holds each kernel against its plain
version on the card.

- ``fused_update_ref``: the fused bank update (``csrc/fused_update.cu``,
  reference ``_fused_kernel_tile``, ``kernel.py:75``), on the dense
  prep's (R, B) layout or the partition prep's flat one with per-row
  offsets;
- ``residual_phase_banked`` (``sketch/bank.py``): the banked phase 2
  (kernel 2 of ``fused_update.cu``, reference ``_residual_kernel_banked``);
- ``residual_phase`` (``sketch/phases.py``): phase 2 of stacked single
  sketches (``csrc/residual.cu``, reference ``_residual_kernel``);
- ``serial_update_ref``: one update per raw item
  (``csrc/serial_update.cu``, reference ``_serial_kernel`` and
  ``_apply_one``, ``kernel.py:317``).
"""
from __future__ import annotations

import torch

from ...sketch.bank import phase1_apply, residual_phase_banked
from ...sketch.phases import residual_phase
from ...sketch.state import I32, INT_MAX, VARIANT_LAZY, SketchState


def fused_update_ref(ids, counts, errors, delta, h_uids, h_net, i0, mu, nnu,
                     w_del, uoff=None, variant: int = 2):
    """One block's per-cell update of the (R, K) bank.

    ``h_uids``/``h_net``: the grouped residual layout, (R, B) with row r's
    run at ``r * B`` (the dense prep, ``bank.phase1_dense_prep``), or flat
    (G,) with row r's run at ``uoff[r]`` (the partition prep,
    ``bank.phase1_partition_prep``); ``i0, mu, nnu, w_del``: (R,) per-row
    scalars. Returns new ``(ids, counts, errors)``; the inputs are not
    modified.
    """
    if uoff is None:
        R, B = h_uids.shape
        uoff = torch.arange(R, dtype=I32, device=ids.device) * B
        h_uids, h_net = h_uids.reshape(-1), h_net.reshape(-1)
    ids, counts, errors = phase1_apply(SketchState(ids, counts, errors),
                                       delta, h_uids, h_net, i0, mu, nnu,
                                       uoff)
    return residual_phase_banked(ids, counts, errors, h_uids, h_net, uoff,
                                 mu, mu + nnu, w_del, variant)


def _wrap32(x: int) -> int:
    """Python int folded into int32, as an int32 add wraps."""
    return (x + 2**31) % 2**32 - 2**31


def _sat32(x: int) -> int:
    """Python int clamped to +-(2**31 - 1), as ``state.sat_add`` clamps."""
    return max(-INT_MAX, min(INT_MAX, x))


def serial_update_ref(ids2, cnt2, err2, items, weights, variant: int = 2,
                      saturate: bool = False):
    """The raw items applied one at a time, in order, to one (R, 128)
    sketch: the reference's ``_apply_one`` per item, its ``jnp.where``
    selects written as branches. Its int32 adds wrap; with ``saturate``
    the two insert adds saturate, as ``blocks.apply_update``'s. Returns
    new tensors; the inputs are not modified."""
    add = _sat32 if saturate else _wrap32
    shape = ids2.shape
    ids, counts, errors = (t.reshape(-1).clone() for t in (ids2, cnt2, err2))
    for item, w in zip(items.tolist(), weights.tolist()):
        if w == 0:
            continue
        # jnp.maximum(-w, 0) in int32: -INT_MIN wraps to INT_MIN, hence 0
        wd = max(_wrap32(-w), 0)
        eq = (ids == item) & (ids >= 0)
        if bool(eq.any()):                       # monitored: add w
            j = int(torch.argmax(eq.to(I32)))
            counts[j] = (add(int(counts[j]) + w) if w > 0
                         else _wrap32(int(counts[j]) - wd))
        elif w > 0:
            empty = ids == -1
            if bool(empty.any()):                # the first EMPTY slot
                j = int(torch.argmax(empty.to(I32)))
                ids[j], counts[j], errors[j] = item, w, 0
            else:                                # evict the minimum count
                j = int(torch.argmin(counts))
                mc = int(counts[j])
                ids[j], counts[j], errors[j] = item, add(mc + w), mc
        elif variant != VARIANT_LAZY:            # SS±: spread the deletion
            rem = wd
            while rem > 0:
                j = int(torch.argmax(errors))
                d = min(rem, int(errors[j]))
                if d <= 0:
                    break
                counts[j] = _wrap32(int(counts[j]) - d)
                errors[j] = _wrap32(int(errors[j]) - d)
                rem -= d
    return ids.reshape(shape), counts.reshape(shape), errors.reshape(shape)


__all__ = ["fused_update_ref", "residual_phase_banked", "residual_phase",
           "serial_update_ref"]
