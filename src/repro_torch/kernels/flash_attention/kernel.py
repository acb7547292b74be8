"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_kernel``
(``repro/kernels/flash_attention/kernel.py:82``). It takes the model
layout as it is, q (B, S, H, hd) and k, v (B, T, KV, hd): the kernel
folds heads into its grid and finds each q-head's kv-head as ``h // G``,
so nothing is transposed, expanded or padded in device memory.

The wrapper checks its operands (CUDA, f32 or bf16, one dtype,
contiguous), launches on the current stream, raises on a refused launch
and counts its launches. CPU tensors take ``ref.py`` in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
MAX_HD = 256
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 10 + (ctypes.c_float,)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """GQA attention on the card: q (B, S, H, hd), k and v (B, T, KV, hd),
    one dtype (f32 or bf16), hd <= 256. Returns (B, S, H, hd) in q's
    dtype."""
    what = "flash_attention_kernel"
    _build.check_operands(what, dict(q=q, k=k, v=v), q.device)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q (B, S, H, hd) and k, v (B, T, KV, hd) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or min(B, S, T, KV, hd) < 1 \
            or H % KV:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (H a multiple of KV)")
    if hd > MAX_HD:
        raise ValueError(f"{what}: hd = {hd} > {MAX_HD} is not supported")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share one dtype of "
                         f"{_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"{what}: window must be >= 0, got {window}")
    if B * H > 65535:
        raise ValueError(f"{what}: B * H = {B * H} > 65535 (the grid's y)")
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    vec = hd % (8 if bf16 else 4) == 0 and _build.aligned16(q, k, v, out)
    _build.launch(
        _build.entry_point(SOURCE, "flash_attention_fwd", _ARGTYPES),
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(bf16),
         B, S, T, H, KV, hd, int(causal), window, int(vec),
         1.0 / math.sqrt(hd)], q.device, what)
    flash_attention_kernel.launches += 1
    return out


# launches since the last reset (chip_smoke.py reads them around its runs)
flash_attention_kernel.launches = 0

__all__ = ["SOURCE", "MAX_HD", "flash_attention_kernel"]
