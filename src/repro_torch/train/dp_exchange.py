"""Data-parallel gradient exchange with top-k compression.

Counterpart of ``repro/train/dp_exchange.py``. The plain data-parallel
path all-reduces every gradient leaf over the data axis (bytes = leaf
size x steps). ``compressed_psum_leaf`` exchanges only the top-k
(value, index) pairs of each rank: an all-gather of 2k elements per rank
instead of a full all-reduce, with error feedback keeping the residual
local (DGC-style). For a leaf of n elements on an A-way axis:

    dense all-reduce   ~ 2n bytes on the wire (ring)
    compressed         ~ A x 2k x 4 bytes  (all-gather of pairs)

a win whenever k << n/A. It is an optional path (off by default): top-k
is lossy.

The collectives run on a ``torch.distributed`` process group (the mesh
axis's, ``build_compressed_allreduce``). Summation order: the gathered
pairs are added rank-major with ``index_add_``, which adds in order on
the CPU (the reference's ``.at[].add`` order, so a leaf's sum is the
reference's bit for bit) and with atomics on CUDA (any order: the sum of
A values at one index agrees within A ulps of its largest term). The
dense leaves' all-reduce sums in the backend's order (gloo's or NCCL's),
within the same A ulps. Indices and the residual are exact everywhere.
"""
from __future__ import annotations

import torch

from ..models.transformer import tree_map
from ..optim.compress import topk_compress

F32 = torch.float32


def compressed_psum_leaf(g: torch.Tensor, residual: torch.Tensor, k: int,
                         group=None):
    """Compress (g + residual), all-gather the pairs over ``group``, sum.

    Returns (summed dense gradient, new residual). Leaves of at most 4k
    elements stay dense (compression would not reduce bytes) and keep
    their residual as it is."""
    import torch.distributed as dist

    n = g.numel()
    if n <= 4 * k:
        out = g.to(F32, copy=True)
        dist.all_reduce(out, group=group)
        return out, residual
    flat = (g.to(F32) + residual).reshape(-1)
    comp = topk_compress(flat, k)
    new_residual = flat.clone()
    new_residual[comp.indices.long()] = 0.0
    A = dist.get_world_size(group)
    # rank-major (A * k,) gathers: rank a's pairs at [a * k, (a + 1) * k)
    all_vals = torch.empty((A * k,), dtype=F32, device=g.device)
    all_idx = torch.empty((A * k,), dtype=torch.int32, device=g.device)
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(all_vals, comp.values, group=group)
    gather(all_idx, comp.indices, group=group)
    dense = torch.zeros((n,), dtype=F32, device=g.device)
    dense.index_add_(0, all_idx.long(), all_vals)
    return dense.reshape(g.shape), new_residual.reshape(g.shape)


def build_compressed_allreduce(mesh, k_frac: float = 0.01,
                               axis: str = "data"):
    """Returns allreduce(grads, residuals) -> (grads_summed, residuals).

    ``grads`` are this rank's gradients (a tree of nested dicts and
    tuples, as the models' params); each leaf is exchanged over the
    process group of the mesh's ``axis`` with k = max(1, n * k_frac).
    Every rank calls it with trees of the same structure and shapes.
    """
    group = mesh.get_group(axis)

    def allreduce(grads, residuals):
        def per_leaf(g, r):
            k = max(1, int(g.numel() * k_frac))
            return compressed_psum_leaf(g, r, k, group)

        pairs = tree_map(per_leaf, grads, residuals)
        return (tree_map(lambda _, p: p[0], grads, pairs),
                tree_map(lambda _, p: p[1], grads, pairs))

    return allreduce


__all__ = ["compressed_psum_leaf", "build_compressed_allreduce"]
