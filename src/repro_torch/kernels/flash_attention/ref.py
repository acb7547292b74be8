"""Plain PyTorch version of the flash-attention kernel.

What ``csrc/flash_attention.cu`` computes, and what the reference's
Pallas kernel (``repro/kernels/flash_attention/kernel.py:82``) computes,
with the whole (S, T) score matrix in f32: the inputs upcast to f32,
scores multiplied by ``1/sqrt(hd)`` of the unpadded hd, -1e30 for the
pairs the masks refuse, an f32 softmax, the output cast to q's dtype.
Query and key positions are aligned at the sequence ends (``q_offset =
T - S``), so a query block of S rows at the end of a T-long cache sees
keys up to its own position. ``ops.py`` runs it for CPU tensors;
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def allowed_pairs(S: int, T: int, causal: bool, window: int,
                  device=None) -> torch.Tensor:
    """(S, T) bool: which keys each query row may attend to."""
    qpos = torch.arange(S, device=device)[:, None] + (T - S)
    kpos = torch.arange(T, device=device)[None, :]
    allowed = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        allowed &= kpos <= qpos
    if window:
        allowed &= kpos > qpos - window
    return allowed


def allowed_count(S: int, T: int, causal: bool, window: int) -> int:
    """How many (q, k) pairs ``allowed_pairs`` allows, counted row by row
    on the host without building the (S, T) mask (so a FLOP formula may
    call it inside ``FakeTensorMode``): query row i sits at key position
    i + T - S and sees the keys from its window's start to itself
    (causal) or to T - 1."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(B: int, S: int, T: int, H: int, hd: int, causal: bool,
                window: int) -> int:
    """The least work of one call: 4·hd FLOPs per allowed (q, k) pair per
    q-head (q·k and p·v, a multiply-add each). ``chip_smoke.py``'s bound
    and the op's FLOP formula (``ops.py``) both count this."""
    return 4 * B * H * hd * allowed_count(S, T, causal, window)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """GQA attention: q (B, S, H, hd), k and v (B, T, KV, hd), H a multiple
    of KV; q-head h reads kv-head ``h // (H // KV)``. Returns (B, S, H, hd)
    in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    allowed = allowed_pairs(S, T, causal, window, q.device)
    scores = torch.where(allowed, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


__all__ = ["NEG_INF", "allowed_pairs", "allowed_count", "flash_flops",
           "flash_attention_ref"]
