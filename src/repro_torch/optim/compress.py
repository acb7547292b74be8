"""Top-k gradient compression with error feedback (counterpart of
``repro/optim/compress.py``).

For the data-parallel gradient exchange the dominant collective is the
all-reduce of every gradient leaf. Top-k compression exchanges only
(values, flat indices) of the k largest-magnitude coordinates per leaf,
plus local error feedback (the residual is added back into the next
step's gradient) [Stich et al.; Lin et al. DGC]. The exchange itself is
``train.dp_exchange.compressed_psum_leaf``.

The k indices come largest magnitude first, ties to the lowest flat
index, as ``jax.lax.top_k`` gives them: the first k of a stable
descending sort (``torch.topk`` promises no order among ties). On the
card that sort is taken whole; on the CPU only the candidates at or
above the k-th largest magnitude are sorted (the same k, in the same
order), which keeps a leaf of 10^8 elements to a second.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

F32 = torch.float32


class TopK(NamedTuple):
    values: torch.Tensor   # (k,) f32
    indices: torch.Tensor  # (k,) int32 flat index
    shape: Tuple[int, ...]


def _top_indices(a: torch.Tensor, k: int) -> torch.Tensor:
    """The first k of a stable descending sort of the 1-D ``a``.

    On the CPU: the k-th largest value by ``np.partition`` (NaN orders
    last there and first in the sort, as the largest value in both),
    then a stable sort of the candidates at or above it, kept in index
    order: every element of the first k is a candidate, so the two
    orders agree on them."""
    n = a.numel()
    if a.is_cuda or k >= n:
        return torch.sort(a, descending=True, stable=True).indices[:k]
    kth = np.partition(a.numpy(), n - k)[n - k]
    cand = torch.nonzero((a >= float(kth)) | torch.isnan(a)).reshape(-1)
    return cand[torch.sort(a[cand], descending=True, stable=True).indices[:k]]


def topk_compress(g: torch.Tensor, k: int) -> TopK:
    flat = g.reshape(-1).to(F32)
    idx = _top_indices(flat.abs(), k)
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
