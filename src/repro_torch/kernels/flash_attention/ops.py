"""Flash attention as its callers take it, in the model layout.

Counterpart of ``repro/kernels/flash_attention/ops.py:26``: q (B, S, H,
hd) and k, v (B, T, KV, hd) in, (B, S, H, hd) out in q's dtype. CUDA
tensors go through the hand-written kernel (``kernel.py``), CPU tensors
through its plain version (``ref.py``). The reference pads hd to 128
lanes and folds heads into its grid; the port does neither outside the
kernel.

Kernel 5 is the torch op ``repro_torch::flash_attention`` (``op``):

- its CUDA implementation launches the kernel (``kernel.py:79``), its
  CPU implementation is the plain version, and no other device has one;
- its fake rule gives the output's shape and dtype, so ``FakeTensorMode``
  and ``meta`` tensors trace it without running anything;
- its gradient is the vector-Jacobian product of the plain version at
  the saved inputs (``FlashAttentionFn.backward``). That is the
  reference's gradient: training there differentiates its plain-JAX
  attention (``jax.grad``), and its Pallas kernel has no backward;
  neither package has a backward kernel;
- its FLOP formula (``torch.utils.flop_counter``) counts ``ref.
  flash_flops``, the work ``chip_smoke.py``'s bound counts. A counting
  mode sees the op and not the plain version's products inside it.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import flash_attention_kernel
from .ref import flash_attention_ref, flash_flops


# The op is defined on a ``torch.library.Library`` with one Python kernel
# per device: the dispatcher calls the kernel's wrapper straight from C++,
# without ``torch.library.custom_op``'s Python layers (the serving decode
# step is host-bound; ``tools/op_overhead.py`` times the op against the
# wrapper on the card).
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window) -> Tensor")


def _kernel(q, k, v, causal, window):
    return flash_attention_kernel(q, k, v, causal=causal, window=window)


def _plain(q, k, v, causal, window):
    return flash_attention_ref(q, k, v, causal=causal, window=window)


_LIB.impl("flash_attention", _kernel, "CUDA")
_LIB.impl("flash_attention", _plain, "CPU")


@torch.library.register_fake("repro_torch::flash_attention", lib=_LIB)
def _fake(q, k, v, causal, window):
    return torch.empty_like(q)


# Kernel 5: GQA attention of q (B, S, H, hd) over k, v (B, T, KV, hd),
# causal and/or windowed, out (B, S, H, hd) in q's dtype.
op = torch.ops.repro_torch.flash_attention.default


class FlashAttentionFn:
    """Kernel 5 with a gradient, by its earlier name: ``FlashAttentionFn.
    apply(q, k, v, causal, window)`` is the op. ``backward`` is the op's
    gradient: it recomputes ``flash_attention_ref`` on the saved inputs,
    its (S, T) scores in f32, and returns its input gradients (the op
    looks it up at each backward, so a profiler may wrap it in a span)."""

    @staticmethod
    def apply(q, k, v, causal: bool, window: int) -> torch.Tensor:
        return op(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(n)
                       for t, n in zip(saved, need))
            out = flash_attention_ref(q, k, v, causal=ctx.causal,
                                      window=ctx.window)
            wrt = [t for t in (q, k, v) if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, dout))
        return (*(next(got) if n else None for n in need), None, None)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


torch.library.register_autograd(
    "repro_torch::flash_attention",
    lambda ctx, dout: FlashAttentionFn.backward(ctx, dout),
    setup_context=_setup_context, lib=_LIB)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, window, *, out_shape=None,
           **kwargs) -> int:
    B, S, H, hd = q_shape
    return flash_flops(B, S, k_shape[1], H, hd, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bkv: int = 128) -> torch.Tensor:
    """GQA attention with a causal and an optional sliding-window mask.

    ``bq``/``bkv`` are the reference's tile sizes, taken for API parity:
    the shapes it refuses are refused here too (S a multiple of
    ``min(bq, S)``, T of ``min(bkv, T)``). The CUDA kernel picks its own
    tiles; the result does not depend on them beyond f32 rounding.
    """
    S, T = q.shape[1], k.shape[1]
    bq, bkv = min(bq, S), min(bkv, T)
    if bq < 1 or bkv < 1 or S % bq or T % bkv:
        raise ValueError(f"flash_attention: S={S} must be a multiple of "
                         f"bq={bq} and T={T} of bkv={bkv}")
    return op(q, k, v, causal, window)


__all__ = ["op", "FlashAttentionFn", "flash_attention"]
