"""Flash attention as its callers take it, in the model layout.

Counterpart of ``repro/kernels/flash_attention/ops.py:26``: q (B, S, H,
hd) and k, v (B, T, KV, hd) in, (B, S, H, hd) out in q's dtype. CUDA
tensors go through the hand-written kernel (``kernel.py``), CPU tensors
through its plain version (``ref.py``). The reference pads hd to 128
lanes and folds heads into its grid; the port does neither outside the
kernel.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bkv: int = 128) -> torch.Tensor:
    """GQA attention with a causal and an optional sliding-window mask.

    ``bq``/``bkv`` are the reference's tile sizes, taken for API parity:
    the shapes it refuses are refused here too (S a multiple of
    ``min(bq, S)``, T of ``min(bkv, T)``). The CUDA kernel picks its own
    tiles; the result does not depend on them beyond f32 rounding.
    """
    S, T = q.shape[1], k.shape[1]
    bq, bkv = min(bq, S), min(bkv, T)
    if bq < 1 or bkv < 1 or S % bq or T % bkv:
        raise ValueError(f"flash_attention: S={S} must be a multiple of "
                         f"bq={bq} and T={T} of bkv={bkv}")
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


__all__ = ["flash_attention"]
