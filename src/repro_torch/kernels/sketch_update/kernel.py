"""Wrapper of the CUDA fused bank-update kernel (``csrc/fused_update.cu``).

Replaces the Pallas TPU kernel ``sketch_update_kernel_fused``
(``repro/kernels/sketch_update/kernel.py:144``). One CTA per bank row
applies the whole per-cell update in place; the wrapper checks its
operands, launches on the current stream and raises on a refused
launch. It takes CUDA tensors only: ``ops.py`` sends CPU tensors to the
plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

_SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "fused_update.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def entry_point():
    """The kernel's C entry point, building its library first if needed."""
    fn = _build.load(_SOURCE).sketch_fused_update
    fn.argtypes = [_P] * 10 + [_I] * 4 + [_P]
    fn.restype = _I
    return fn


def sketch_update_kernel_fused(ids, counts, errors, delta, h_uids, h_net,
                               i0, mu, nnu, w_del, *, variant: int = 2):
    """Apply one block's per-cell update to the (R, K) bank in place.

    ``ids, counts, errors, delta``: (R, K) int32; ``h_uids, h_net``:
    (R, B) int32 grouped residual layout per row; ``i0, mu, nnu,
    w_del``: (R,) int32 per-row scalars (``bank.phase1_dense_prep``).
    Returns ``(ids, counts, errors)``, the same tensors, updated.
    """
    R, K = ids.shape
    B = h_uids.shape[1]
    named = dict(ids=ids, counts=counts, errors=errors, delta=delta,
                 h_uids=h_uids, h_net=h_net, i0=i0, mu=mu, nnu=nnu,
                 w_del=w_del)
    shapes = dict(ids=(R, K), counts=(R, K), errors=(R, K), delta=(R, K),
                  h_uids=(R, B), h_net=(R, B), i0=(R,), mu=(R,), nnu=(R,),
                  w_del=(R,))
    for name, t in named.items():
        if t.device != ids.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {ids.device} "
                             f"(got {t.device}); CPU tensors take ref.py")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 (lazy) or 2 (SS±), got {variant}")
    if R < 1 or K < 1 or B < 1 or R * B >= 2**31 or R * K >= 2**31:
        raise ValueError(f"unsupported shape R={R}, K={K}, B={B}")
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry_point()(*(t.data_ptr() for t in named.values()),
                            R, K, B, variant, stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error "
                           f"{err}")
    sketch_update_kernel_fused.launches += 1
    return ids, counts, errors


# launches since the last reset (chip_smoke.py reads it around the main path)
sketch_update_kernel_fused.launches = 0

__all__ = ["entry_point", "sketch_update_kernel_fused"]
