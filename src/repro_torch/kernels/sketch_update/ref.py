"""Plain PyTorch version of the fused SpaceSaving± bank update.

Computes what the CUDA kernel (``csrc/fused_update.cu``) computes, and
what the reference's Pallas tile body ``_fused_kernel_tile``
(``repro/kernels/sketch_update/kernel.py:75``) computes, over the whole
(R, K) bank in eager PyTorch: the same five steps, rows in lockstep.
``ops.py`` runs it for CPU tensors; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

from ...sketch.bank import phase1_apply, residual_phase_banked
from ...sketch.state import I32, SketchState


def fused_update_ref(ids, counts, errors, delta, h_uids, h_net, i0, mu, nnu,
                     w_del, variant: int = 2):
    """One block's per-cell update of the (R, K) bank.

    ``h_uids``/``h_net``: (R, B) grouped residual layout per row; ``i0,
    mu, nnu, w_del``: (R,) per-row scalars from ``bank.phase1_dense_prep``.
    Returns new ``(ids, counts, errors)``; the inputs are not modified.
    """
    R, B = h_uids.shape
    ids, counts, errors = phase1_apply(SketchState(ids, counts, errors),
                                       delta, h_uids, h_net, i0, mu, nnu)
    uoff = torch.arange(R, dtype=I32, device=ids.device) * B
    return residual_phase_banked(ids, counts, errors, h_uids.reshape(-1),
                                 h_net.reshape(-1), uoff, mu, mu + nnu, w_del,
                                 variant)


__all__ = ["fused_update_ref"]
