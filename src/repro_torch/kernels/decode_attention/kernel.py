"""Wrapper of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``decode_attention_kernel``
(``repro/kernels/decode_attention/kernel.py:61``). It takes the serve
layout as it is, q (B, KV, G, hd) and caches (B, C, KV, hd): the kernel
reads each slot's row of a kv-head in place, so the caches are not
transposed to kv-head-major as the reference's wrapper does.

One call is one launch of the kernel's three passes (chunked scores and
partial softmax, combine, mass) on the current stream. The wrapper
checks its operands (CUDA, contiguous, q, k, v in one dtype of f32 or
bf16, valid bool), allocates the outputs and the f32 scratch, raises on
a refused launch and counts its launches. CPU tensors take ``ref.py``
in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib

import torch

from .. import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "decode_attention.cu")
_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 7 + (ctypes.c_float,)
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256


@functools.lru_cache(maxsize=None)
def chunk_slots() -> int:
    """Cache slots per chunk of the kernel's first pass (its ``CHUNK``)."""
    fn = _build.load(SOURCE).decode_attention_chunk
    fn.restype = ctypes.c_int
    return fn()


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, valid: torch.Tensor):
    """q (B, KV, G, hd), caches (B, C, KV, hd), valid (B, C) bool, on the
    card. Returns ``(ctx, mass)``: ctx (B, KV, G, hd) in v's dtype, mass
    (B, C) f32."""
    what = "decode_attention_kernel"
    _build.check_operands(what, dict(q=q, k_cache=k_cache,
                                     v_cache=v_cache, valid=valid), q.device)
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{what}: q (B, KV, G, hd) and caches (B, C, KV, hd)"
                         f" expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, KV, G, hd = q.shape
    C = k_cache.shape[1]
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (B, KV, hd) \
            or tuple(valid.shape) != (B, C) or min(B, KV, G, hd, C) < 1:
        raise ValueError(f"{what}: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} and valid "
                         f"{tuple(valid.shape)} do not fit")
    if hd > MAX_HD:
        raise ValueError(f"{what}: hd = {hd} > {MAX_HD} is not supported")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{what}: q and the caches must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"{what}: valid must be bool, got {valid.dtype}")
    if max(B, KV) > 65535:
        raise ValueError(f"{what}: B = {B} and KV = {KV} must be <= 65535")
    nchunks = -(-C // chunk_slots())
    f32 = dict(dtype=torch.float32, device=q.device)
    ctx = torch.empty((B, KV, G, hd), dtype=v_cache.dtype, device=q.device)
    mass = torch.empty((B, C), **f32)
    scores = torch.empty((B, KV, G, C), **f32)
    part_m = torch.empty((B, KV, nchunks, G), **f32)
    part_l = torch.empty((B, KV, nchunks, G), **f32)
    part_ctx = torch.empty((B, KV, nchunks, G, hd), **f32)
    row_m = torch.empty((B, KV, G), **f32)
    row_l = torch.empty((B, KV, G), **f32)
    bf16 = q.dtype == torch.bfloat16
    vec = ((hd * q.element_size()) % 16 == 0
           and _build.aligned16(k_cache, v_cache))
    tensors = (q, k_cache, v_cache, valid, ctx, mass, scores, part_m, part_l,
               part_ctx, row_m, row_l)
    _build.launch(
        _build.entry_point(SOURCE, "decode_attention_fwd", _ARGTYPES),
        [*(t.data_ptr() for t in tensors), int(bf16), B, C, KV, G, hd,
         int(vec), 1.0 / math.sqrt(hd)], q.device, what)
    decode_attention_kernel.launches += 1
    return ctx, mass


# launches since the last reset (chip_smoke.py reads them around its runs)
decode_attention_kernel.launches = 0

__all__ = ["SOURCE", "MAX_HD", "chunk_slots", "decode_attention_kernel"]
