"""Top-k gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

For the data-parallel gradient exchange the dominant collective is the
all-reduce of every gradient leaf. Top-k compression exchanges only
(values, flat indices) of the k largest-magnitude coordinates per leaf,
plus local error feedback (the residual is added back into the next
step's gradient) [Stich et al.; Lin et al. DGC]. The exchange itself
(``dp_exchange.compressed_psum``) needs the mesh: ROADMAP item 19.

Ties among equal magnitudes go to the lowest flat index first, as
``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
promises no order among ties).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

F32 = torch.float32


class TopK(NamedTuple):
    values: torch.Tensor   # (k,) f32
    indices: torch.Tensor  # (k,) int32 flat index
    shape: Tuple[int, ...]


def topk_compress(g: torch.Tensor, k: int) -> TopK:
    flat = g.reshape(-1).to(F32)
    _, idx = torch.sort(flat.abs(), descending=True, stable=True)
    idx = idx[:k]
    return TopK(values=flat[idx], indices=idx.to(torch.int32),
                shape=tuple(g.shape))


def topk_decompress(t: TopK) -> torch.Tensor:
    n = 1
    for d in t.shape:
        n *= d
    out = torch.zeros((n,), dtype=F32, device=t.values.device)
    out.index_add_(0, t.indices.long(), t.values)
    return out.reshape(t.shape)


def error_feedback_update(g: torch.Tensor, residual: torch.Tensor,
                          k: int) -> Tuple[TopK, torch.Tensor]:
    """Compress (g + residual); return (compressed, new residual)."""
    corrected = g.to(F32) + residual
    comp = topk_compress(corrected, k)
    new_residual = corrected - topk_decompress(comp)
    return comp, new_residual


__all__ = ["TopK", "topk_compress", "topk_decompress",
           "error_feedback_update"]
