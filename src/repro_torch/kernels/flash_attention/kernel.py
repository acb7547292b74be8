"""Wrapper of the CUDA flash-attention kernels (``csrc/*.cu``).

They replace the Pallas TPU kernel ``flash_attention_kernel``
(``repro/kernels/flash_attention/kernel.py:82``). Three kernels share the
work by shape, chosen before the launch by ``flash_path``:

- ``"wgmma"`` (``csrc/flash_wgmma.cu``): bf16 with hd 64, 128 or 256 and
  16-byte aligned operands, on Hopper's wgmma fed by TMA;
- ``"mma"`` (``csrc/flash_attention.cu``): every other bf16 shape, on
  mma.sync;
- ``"f32"`` (``csrc/flash_attention.cu``): f32 on the CUDA cores.

All take the model layout as it is, q (B, S, H, hd) and k, v (B, T, KV,
hd): the kernels fold heads into their grid and find each q-head's
kv-head as ``h // G``, so nothing is transposed, expanded or padded in
device memory.

The wrapper checks its operands (none requiring grad while grad mode is
on, CUDA, f32 or bf16, one dtype, contiguous), launches on the current
stream, raises on a refused launch (never retrying on another path) and
counts its launches per path in ``flash_attention_kernel.launches``.
CPU tensors take ``ref.py`` in ``ops.py``; a gradient goes through
``ops.FlashAttentionFn``.
"""
from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from .. import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"      # the mma and f32 kernels
WGMMA_SOURCE = CSRC / "flash_wgmma.cu"    # the wgmma kernel
SOURCES = (SOURCE, WGMMA_SOURCE)
MAX_HD = 256
WGMMA_HD = (64, 128, 256)
PATHS = ("wgmma", "mma", "f32")
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 10 + (ctypes.c_float,)
_WGMMA_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
                   + (ctypes.c_float,))
_DTYPES = (torch.float32, torch.bfloat16)


def flash_path(dtype: torch.dtype, hd: int, aligned: bool) -> str:
    """The kernel that takes a shape: ``"wgmma"`` for bf16 with hd in
    ``WGMMA_HD`` and every operand 16-byte aligned (the TMA's rule),
    ``"mma"`` for any other bf16 shape, ``"f32"`` for f32."""
    if dtype == torch.float32:
        return "f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_path: no kernel for {dtype}")
    return "wgmma" if hd in WGMMA_HD and aligned else "mma"


def _launch(path: str, q, k, v, out, causal: bool, window: int) -> None:
    """Launch ``path``'s kernel on checked operands; count the launch."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if path == "wgmma":
        fn = _build.entry_point(WGMMA_SOURCE, "flash_wgmma_fwd",
                                _WGMMA_ARGTYPES)
        args = [*ptrs, B, S, T, H, KV, hd, int(causal), window, scale]
    else:
        bf16 = path == "mma"
        vec = hd % (8 if bf16 else 4) == 0 and _build.aligned16(q, k, v, out)
        fn = _build.entry_point(SOURCE, "flash_attention_fwd", _ARGTYPES)
        args = [*ptrs, int(bf16), B, S, T, H, KV, hd, int(causal), window,
                int(vec), scale]
    _build.launch(fn, args, q.device, f"flash_attention_kernel ({path})")
    flash_attention_kernel.launches[path] += 1


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """GQA attention on the card: q (B, S, H, hd), k and v (B, T, KV, hd),
    one dtype (f32 or bf16), hd <= 256. Returns (B, S, H, hd) in q's
    dtype."""
    what = "flash_attention_kernel"
    _build.refuse_grad(what, dict(q=q, k=k, v=v))
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
    path = flash_path(q.dtype, hd, _build.aligned16(q, k, v, out))
    _launch(path, q, k, v, out, causal, window)
    return out


# launches per path since the last reset (chip_smoke.py reads them)
flash_attention_kernel.launches = dict.fromkeys(PATHS, 0)

__all__ = ["SOURCE", "WGMMA_SOURCE", "SOURCES", "MAX_HD", "WGMMA_HD",
           "PATHS", "flash_path", "flash_attention_kernel"]
