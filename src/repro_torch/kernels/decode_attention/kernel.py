"""Wrapper of the CUDA decode-attention kernel
(``csrc/decode_attention.cu``).

Replaces the Pallas TPU kernel ``decode_attention_kernel``
(``repro/kernels/decode_attention/kernel.py:61``). It takes the serve
layout as it is, q (B, KV, G, hd) and caches (B, C, KV, hd): a CTA reads
a chunk of one sequence's slots with every kv-head of them, one
contiguous span of the cache, so the caches are not transposed to
kv-head-major as the reference's wrapper does.

One call is two launches on the current stream: the split (per chunk of
slots: scores, the chunk's max, sum and context) and the combine (the
rows' softmax, the per-slot mass and ctx). ``decode_layout`` is the
source's layout of a shape, a function of (B, C, KV, G, hd) and never of
the dtype; the wrapper passes its chunk and scratch size, and the C
entry refuses a launch where either disagrees with its own. The wrapper
checks its operands (CUDA, contiguous; the caches one dtype of f32 or
bf16, q the caches' dtype or f32 over a bf16 cache; valid bool),
allocates ctx (in the caches' dtype), the mass and one flat f32
scratch, raises on a refused launch and counts its launches. CPU
tensors take ``ref.py`` in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import NamedTuple

import torch

from .. import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "decode_attention.cu")
_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 9 + (ctypes.c_float,))
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256

# the source's layout constants (tests/test_torch_layouts.py holds them to
# the .cu's constexprs)
G_MAX = 8               # q-heads per head group
THREADS_MAX = 512       # consumer threads, up to 2 q-heads
THREADS_MAX_WIDE = 256  # consumer threads, 3-8 q-heads
MIN_THREADS = 128       # consumer threads at least
STAGE_F32_BYTES = 65536  # a sub-chunk's K rows, counted in f32
SUB_MAX = 32            # slots per sub-chunk at most
SCORE_FLOATS = 8192     # a chunk's scores in shared memory
CHUNK_MAX = 256         # slots per chunk at most
TARGET_CTAS = 264       # the split's CTAs: 2 per SM on the H100's 132
COMBINE_CTAS = 264      # the combine's CTAs at least
COMBINE_SLOTS = 256     # slots per combine CTA at most


class DecodeLayout(NamedTuple):
    """How the kernel cuts one shape (the fields of the source's
    ``Layout``, in its order, then the scratch's f32 words)."""
    hdp: int        # hd rounded up to 8 elements
    units: int      # 8-element units of a row
    lanes: int      # lanes per row, a power of 2
    kvh: int        # kv-heads per head group (KV where it fits)
    gh: int         # q-heads per head group
    gmax: int       # gh rounded up to a power of 2
    rep: int        # lane groups per kv-head, each a share of the slots
    threads: int    # consumer threads of the split
    sub: int        # slots per sub-chunk (one ring stage)
    chunk: int      # slots per split CTA
    nchunks: int    # chunks per sequence
    kv_groups: int  # head groups along KV
    g_groups: int   # head groups along G
    combine: int    # combine CTAs per sequence
    scratch: int    # f32 words of the scratch

    @property
    def split_ctas(self) -> int:
        """CTAs of the split per sequence (times B for the grid)."""
        return self.nchunks * self.kv_groups * self.g_groups


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.lru_cache(maxsize=256)
def decode_layout(B: int, C: int, KV: int, G: int, hd: int) -> DecodeLayout:
    """The source's ``make_layout``: lanes per row from hd, kv-heads and
    q-heads per CTA from the thread budget, a sub-chunk of about 64 KB
    of f32 K rows, and the chunk that gives the split about
    ``TARGET_CTAS`` CTAs (a multiple of the sub-chunk, within the scores'
    shared memory); the combine gets at least ``COMBINE_CTAS`` CTAs of at
    most ``COMBINE_SLOTS`` slots each."""
    hdp = _cdiv(hd, 8) * 8
    units = hdp // 8
    lanes = _pow2ceil(units)
    gh = min(G, G_MAX)
    gmax = _pow2ceil(gh)
    tmax = THREADS_MAX if gmax <= 2 else THREADS_MAX_WIDE
    kvh = min(KV, tmax // lanes)
    rows = kvh * lanes
    tmin = min(MIN_THREADS, tmax)
    rep = 1 if rows >= tmin else tmin // rows
    threads = _cdiv(rows * rep, 32) * 32
    sub = min(max(STAGE_F32_BYTES // (kvh * hdp * 4), 1), SUB_MAX)
    kv_groups, g_groups = _cdiv(KV, kvh), _cdiv(G, gh)
    want = _cdiv(TARGET_CTAS, kv_groups * g_groups * B)
    chunk = _cdiv(_cdiv(C, want), sub) * sub
    cmax = max(min(SCORE_FLOATS // (kvh * gh), CHUNK_MAX) // sub * sub, sub)
    chunk = min(max(chunk, sub), cmax)
    nchunks = _cdiv(C, chunk)
    combine = max(_cdiv(COMBINE_CTAS, B), _cdiv(C, COMBINE_SLOTS))
    pairs = B * nchunks * KV * G
    return DecodeLayout(hdp, units, lanes, kvh, gh, gmax, rep, threads, sub,
                        chunk, nchunks, kv_groups, g_groups, combine,
                        B * C * KV * G + pairs * (2 + hdp))


def source_layout(B: int, C: int, KV: int, G: int, hd: int) -> DecodeLayout:
    """The layout as the built source computes it (on a machine that can
    build it)."""
    fn = _build.load(SOURCE).decode_attention_layout
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 16)()
    fn(B, C, KV, G, hd, ctypes.addressof(out))
    # the scratch size comes back as two C ints: high word, then the low
    # word read as unsigned
    return DecodeLayout(*out[:14],
                        (out[15] << 32) | ctypes.c_uint32(out[14]).value)


_entry = (None, None)   # (source, its bound entry point): bound once


def _fwd():
    global _entry
    if _entry[0] != SOURCE:   # a test may point SOURCE at another file
        _entry = (SOURCE, _build.entry_point(SOURCE, "decode_attention_fwd",
                                             _ARGTYPES))
    return _entry[1]


def _check(q, k_cache, v_cache, valid):
    what = "decode_attention_kernel"
    named = dict(q=q, k_cache=k_cache, v_cache=v_cache, valid=valid)
    _build.refuse_grad(what, named)
    _build.check_operands(what, named, q.device)
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
    cache = k_cache.dtype
    if cache not in _DTYPES or v_cache.dtype != cache \
            or q.dtype not in (cache, torch.float32):
        raise ValueError(f"{what}: the caches must share one dtype of "
                         f"{_DTYPES} and q be theirs or float32, got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"{what}: valid must be bool, got {valid.dtype}")
    if max(B, KV) > 65535:
        raise ValueError(f"{what}: B = {B} and KV = {KV} must be <= 65535")


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, valid: torch.Tensor):
    """q (B, KV, G, hd), caches (B, C, KV, hd), valid (B, C) bool, on the
    card. Returns ``(ctx, mass)``: ctx (B, KV, G, hd) in the caches'
    dtype, mass (B, C) f32. An f32 q over a bf16 cache reads the bf16
    rows as they are: the result equals, bit for bit, the call on the
    cache upcast to f32 with ctx cast back to bf16."""
    _check(q, k_cache, v_cache, valid)
    B, KV, G, hd = q.shape
    C = k_cache.shape[1]
    lay = decode_layout(B, C, KV, G, hd)
    dev = q.device
    ctx = torch.empty((B, KV, G, hd), dtype=v_cache.dtype, device=dev)
    mass = torch.empty((B, C), dtype=torch.float32, device=dev)
    scratch = torch.empty((lay.scratch,), dtype=torch.float32, device=dev)
    vec = hd % 8 == 0 and _build.aligned16(k_cache, v_cache)
    _build.launch(
        _fwd(),
        [q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
         valid.data_ptr(), ctx.data_ptr(), mass.data_ptr(),
         scratch.data_ptr(), lay.scratch, int(q.dtype == torch.bfloat16),
         int(k_cache.dtype == torch.bfloat16), B, C, KV, G, hd, int(vec),
         lay.chunk, 1.0 / math.sqrt(hd)], dev, "decode_attention_kernel")
    decode_attention_kernel.launches += 1
    return ctx, mass


# launches since the last reset (chip_smoke.py reads them around its runs)
decode_attention_kernel.launches = 0

__all__ = ["SOURCE", "MAX_HD", "DecodeLayout", "decode_layout",
           "source_layout", "decode_attention_kernel"]
