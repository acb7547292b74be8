"""Decode attention as the serving path takes it, in the serve layout.

Counterpart of ``repro/kernels/decode_attention/ops.py:22``: q (B, KV,
G, hd), caches (B, C, KV, hd), valid (B, C) bool in; ``(ctx, mass)``
out, ctx (B, KV, G, hd) in v's dtype and mass (B, C) f32. CUDA tensors
go through the hand-written kernel (``kernel.py``), CPU tensors through
its plain version (``ref.py``). The reference pads hd to 128 lanes and
transposes both caches to kv-head-major; the port does neither.
"""
from __future__ import annotations

import torch

from .kernel import decode_attention_kernel
from .ref import decode_attention_ref


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor):
    """One-token GQA attention over a budgeted cache, with the per-slot
    attention mass summed over every q-head (the weighted-insert stream
    of the heavy-hitter cache). Rows with no valid slot give ctx = 0 and
    mass = 0."""
    if q.is_cuda:
        return decode_attention_kernel(q, k_cache, v_cache, valid)
    return decode_attention_ref(q, k_cache, v_cache, valid)


__all__ = ["decode_attention"]
