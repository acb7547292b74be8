"""Plain PyTorch version of the decode-attention kernel.

What ``csrc/decode_attention.cu`` computes, and what the reference's
Pallas kernel (``repro/kernels/decode_attention/kernel.py:61``)
computes: one query token per sequence and q-head against a budgeted
(B, C, KV, hd) cache with a per-slot validity mask, a single-shot f32
softmax, the context in v's dtype and the per-slot probability mass.
As in the Pallas kernel: the inputs upcast to f32, scores multiplied by
``1/sqrt(hd)``, -1e9 at invalid slots, the denominator clamped at
1e-30, p kept in f32 through ``p @ v``, p = 0 on a row with no valid
slot (so its context and mass are 0), and the mass summed over the G
q-heads of a kv-head, then over the kv-heads in order 0..KV-1.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e9


def decode_flops(valid_slots: int, KV: int, G: int, hd: int) -> int:
    """The least work of one call: 4·hd FLOPs per valid slot per q-head
    (q·k and p·v, a multiply-add each), ``valid_slots`` summed over the
    batch rows. ``chip_smoke.py``'s bound and the op's FLOP formula
    (``ops.py``) both count this."""
    return 4 * valid_slots * KV * G * hd


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, valid: torch.Tensor):
    """q (B, KV, G, hd); caches (B, C, KV, hd); valid (B, C) bool.

    Returns ``(ctx, mass)``: ctx (B, KV, G, hd) in v's dtype, mass (B, C)
    f32, which sums to KV·G on every row with a valid slot."""
    KV, hd = q.shape[1], q.shape[-1]
    scores = torch.einsum("bkgh,btkh->bkgt", q.float(), k_cache.float()) * (
        1.0 / math.sqrt(hd))
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    p = torch.where(valid.any(dim=1)[:, None, None, None], p, 0.0)
    ctx = torch.einsum("bkgt,btkh->bkgh", p, v_cache.float())
    per_head = p.sum(dim=2)  # (B, KV, C)
    mass = torch.zeros_like(per_head[:, 0])
    for kv in range(KV):
        mass = mass + per_head[:, kv]
    return ctx.to(v_cache.dtype), mass


__all__ = ["NEG_INF", "decode_flops", "decode_attention_ref"]
