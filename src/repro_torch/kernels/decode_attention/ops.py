"""Decode attention as the serving path takes it, in the serve layout.

Counterpart of ``repro/kernels/decode_attention/ops.py:22``: q (B, KV,
G, hd), caches (B, C, KV, hd), valid (B, C) bool in; ``(ctx, mass)``
out, ctx (B, KV, G, hd) in v's dtype and mass (B, C) f32. CUDA tensors
go through the hand-written kernel (``kernel.py``), CPU tensors through
its plain version (``ref.py``). The reference pads hd to 128 lanes and
transposes both caches to kv-head-major; the port does neither.

Kernel 6 is the torch op ``repro_torch::decode_attention`` (``op``): its
CUDA implementation launches the kernel (``kernel.py:175``), its CPU
implementation is the plain version; its fake rule gives ctx's and the
f32 mass's shapes and dtypes; its FLOP formula counts ``ref.
decode_flops``, over the valid slots of real data and over every slot
of fake or meta data, whose values a trace does not know. It has no
gradient (it serves decode only): a call whose inputs require grad in
grad mode raises.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import decode_attention_kernel
from .ref import decode_attention_ref, decode_flops


def _refuse_grad(q, k_cache, v_cache, valid) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("repro_torch::decode_attention has no gradient: "
                           "call it on operands that do not require grad, "
                           "or under torch.no_grad()")


# Defined on a ``torch.library.Library`` as kernel 5's op is
# (``flash_attention/ops.py`` says why).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k_cache, Tensor v_cache, "
            "Tensor valid) -> (Tensor, Tensor)")


def _kernel(q, k_cache, v_cache, valid):
    return decode_attention_kernel(q, k_cache, v_cache, valid)


def _plain(q, k_cache, v_cache, valid):
    return decode_attention_ref(q, k_cache, v_cache, valid)


_LIB.impl("decode_attention", _kernel, "CUDA")
_LIB.impl("decode_attention", _plain, "CPU")


@torch.library.register_fake("repro_torch::decode_attention", lib=_LIB)
def _fake(q, k_cache, v_cache, valid):
    B, KV, G, hd = q.shape
    return (q.new_empty((B, KV, G, hd), dtype=v_cache.dtype),
            q.new_empty((B, k_cache.shape[1]), dtype=torch.float32))


# Kernel 6: one-token GQA attention and the per-slot mass.
op = torch.ops.repro_torch.decode_attention.default


@register_flop_formula(torch.ops.repro_torch.decode_attention, get_raw=True)
def _flops(q, k_cache, v_cache, valid, *, out_val=None, **kwargs) -> int:
    _, KV, G, hd = q.shape
    if valid.device.type == "meta" or _is_fake(valid):
        slots = valid.numel()
    else:
        slots = int(valid.sum())
    return decode_flops(slots, KV, G, hd)


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor):
    """One-token GQA attention over a budgeted cache, with the per-slot
    attention mass summed over every q-head (the weighted-insert stream
    of the heavy-hitter cache). Rows with no valid slot give ctx = 0 and
    mass = 0."""
    _refuse_grad(q, k_cache, v_cache, valid)
    return op(q, k_cache, v_cache, valid)


__all__ = ["op", "decode_attention"]
