"""Shared transformer layers: norms, RoPE, GQA attention (full, sliding
window, encoder, cross), decode attention with per-slot attention mass
(the SS± KV-eviction path's input), and the MLP flavors of the configs
(SwiGLU, GeLU, squared-ReLU, biased QKV, qk-norm).

Counterpart of ``repro/models/layers.py``. Params are nested dicts of
tensors with a mirrored "axes" tree of logical dim names, as there.

Attention goes through the port's kernels where the reference attends in
plain JAX: prefill and training (``_causal_full``, ``_banded_local``)
through kernel 5 (``kernels/flash_attention``), one token against a
cache through kernel 6 (``kernels/decode_attention``). CUDA tensors
launch the kernel; CPU tensors, and ``attention="plain"``, take its
plain version (``ref.py``). Training differentiates kernel 5 through
``FlashAttentionFn`` (its backward: the plain version's gradient, the
reference's); kernel 6 serves decode only and refuses inputs that
require grad. The kernels keep the scores in f32 where the
reference keeps bf16 models' (S, S) scores and P in bf16, so a bf16
model agrees with the reference within bf16 rounding, not bit for bit.

On a mesh (``parallel.sharding.use_mesh``) the params are DTensors and
the reference's ``shard`` calls lay out q, k, the attention output and
the MLP's hidden and output. Kernels 5 and 6 run under
``sharding.local_map`` on each rank's shard: kernel 5 on the rank's
batch rows and q-heads, with the kv-heads those q-heads read (a
replicated k/v is cut to them); kernel 6 on the rank's batch rows with
the cache's slots gathered over the axes "cache" binds, since its mass
is summed over the q-heads inside the kernel and a rank's partial
softmax over its slots could not be rescaled head by head after it.

JAX's type promotion is kept by hand: ``torch.einsum`` refuses mixed
dtypes, so every product promotes its operands first (``ein``), as
``jnp.result_type`` would; Python scalars stay weak in both frameworks.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.parallel import sharding as psh

F32 = torch.float32
BF16 = torch.bfloat16
ATTENTION = ("kernel", "plain")


def ein(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` over operands promoted to one dtype, as JAX's
    einsum promotes (bf16 with f32 gives f32)."""
    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.einsum(eq, *(t.to(dt) for t in ops))


def check_attention(attention: str) -> str:
    if attention not in ATTENTION:
        raise ValueError(f"attention must be one of {ATTENTION}, "
                         f"got {attention!r}")
    return attention


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, hd); positions: (seq,) or broadcastable. The
    rotation pairs the two halves of hd (``jnp.split``), not neighbours."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    angles = positions.float()[..., None] * freqs      # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]               # add the head dim
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (training / prefill): kernel 5
# ---------------------------------------------------------------------------

def _project_qkv(x, p, cfg: ModelConfig):
    q = ein("bsd,dhk->bshk", x, p["wq"])
    k = ein("bsd,dhk->bshk", x, p["wk"])
    v = ein("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attend(q, k, v, causal: bool, window: int, attention: str):
    """GQA attention in the model layout (``_attend_local``), on each
    rank's shard when q is a DTensor: q by ("batch", "seq", "heads"),
    k and v by ("batch", "seq", "kv"); a rank whose q-heads are split
    and whose kv-heads are not takes the kv-heads its q-heads read
    (``_kv_for_heads``)."""
    if not psh.is_dtensor(q):
        return _attend_local(q, k, v, causal, window, attention)
    H, KV = q.shape[2], k.shape[2]
    qs = psh.act_spec(q.shape, "batch", "seq", "heads", None).spec
    ks = psh.act_spec(k.shape, "batch", "seq", "kv", None).spec

    def local(q, k, v):
        k, v = _kv_for_heads(q, k, v, qs[2], H, KV)
        return _attend_local(q, k, v, causal, window, attention)

    return psh.local_map(local, (q, k, v), (qs, ks, ks), qs)


def _kv_for_heads(q, k, v, heads_axes, H: int, KV: int):
    """k, v cut to the kv-heads this rank's q-heads read, where the q-heads
    are split over ``heads_axes`` and k, v hold every kv-head (the rules
    replicate a kv dim its axes do not divide). q-head h reads kv-head
    h // G: a run of whole groups is a slice of kv-heads, a part of one
    group is one kv-head, anything else repeats each q-head's kv-head."""
    h_loc = q.shape[2]
    if h_loc == H or k.shape[2] != KV:
        return k, v
    G = H // KV
    i, _ = psh.shard_index(heads_axes)
    kv = torch.arange(i * h_loc, (i + 1) * h_loc, device=k.device) // G
    if h_loc % G == 0:
        kv = kv[::G]
    elif G % h_loc == 0:
        kv = kv[:1]
    return k.index_select(2, kv), v.index_select(2, kv)


def _attend_local(q, k, v, causal: bool, window: int, attention: str):
    """GQA attention in the model layout, q (B, S, H, hd) and k, v (B, T,
    KV, hd), sequence ends aligned: kernel 5 for CUDA tensors under
    ``attention="kernel"`` (through ``FlashAttentionFn`` when grad mode
    is on and an input requires grad), its plain version otherwise. No
    tile rule (the reference model has none: Whisper's cross-attention
    has T = 1,500), unlike ``ops.flash_attention``'s Pallas API
    parity."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (t.to(dt).contiguous() for t in (q, k, v))
    if check_attention(attention) == "kernel" and q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return flash_attention_kernel(q, k, v, causal=causal, window=window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def attention(
    x: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    kind: str,                      # full | swa | local | global | encoder
    positions: torch.Tensor,
    cross_states: Optional[torch.Tensor] = None,
    return_kv: bool = False,
    attention: str = "kernel",
):
    """Training/prefill attention. cross_states: encoder hidden states
    (B, F, D) for Whisper's cross-attention (K/V projected from them with
    this block's wk/wv, no mask, no rope).

    ``swa``/``local`` layers attend to keys j <= i and j > i - window (the
    reference's ``_banded_local`` band; where S <= window that is the
    causal mask, its ``_causal_full`` branch), and refuse an S past the
    window that is not a multiple of it, as the reference does.
    ``full``/``global`` are causal, ``encoder`` and cross-attention
    unmasked. With ``return_kv`` also returns the (rope'd) K/V."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    if cross_states is None:
        q, kk, vv = _project_qkv(x, p, cfg)
        q = rope(q, positions, cfg.rope_theta)
        kk = rope(kk, positions, cfg.rope_theta)
    else:
        q = ein("bsd,dhk->bshk", x, p["wq"])
        kk = ein("bsd,dhk->bshk", cross_states, p["wk"])
        vv = ein("bsd,dhk->bshk", cross_states, p["wv"])
    window = 0
    if kind in ("swa", "local") and cross_states is None:
        if S > cfg.window and S % cfg.window:
            raise ValueError(f"seq {S} must be a multiple of window "
                             f"{cfg.window}")
        window = cfg.window
    q = psh.shard(q, "batch", "seq", "heads", None)
    kk = psh.shard(kk, "batch", "seq", "kv", None)
    causal = kind != "encoder" and cross_states is None
    out = _attend(q, kk, vv, causal, window, attention)
    out = out.reshape(B, S, H * hd)
    out = ein("bsh,hd->bsd", out, p["wo"])
    out = psh.shard(out, "batch", "seq", "embed")
    if return_kv:
        return out, (kk, vv)
    return out


# ---------------------------------------------------------------------------
# Decode attention (one new token against a KV cache): kernel 6
# ---------------------------------------------------------------------------

def decode_attend(q, cache_k, cache_v, valid, attention: str = "kernel"):
    """Kernel 6 or its plain version (``_decode_attend_local``); with a
    DTensor among the inputs, on each rank's batch rows (every q-head,
    the slots gathered over the axes "cache" binds), ctx and mass split
    as the rows are."""
    if not any(psh.is_dtensor(t) for t in (q, cache_k, cache_v, valid)):
        return _decode_attend_local(q, cache_k, cache_v, valid, attention)
    ins = (q, cache_k, cache_v, valid)
    rows = [psh.lead_spec(t.shape, "batch") for t in ins]
    return psh.local_map(lambda *a: _decode_attend_local(*a, attention),
                         ins, rows, (rows[0], rows[3]))


def _decode_attend_local(q, cache_k, cache_v, valid,
                         attention: str = "kernel"):
    """q (B, KV, G, hd), caches (B, C, KV, hd), valid (B, C) bool ->
    (ctx (B, KV, G, hd) in the caches' dtype, mass (B, C) f32 summed over
    the q-heads; 0 on a row with no valid slot). Kernel 6 for CUDA
    tensors under ``attention="kernel"``, its plain version otherwise.

    Where q is f32 and the cache bf16 (f32 params over ``build_cache``'s
    bf16 cache), both the kernel and its plain version take the cache as
    it is and compute in f32, the reference's f32 score product, with ctx
    in the cache's dtype: bit for bit the call on the cache upcast to f32
    with ctx cast back, without the upcast copy. Other mixes are promoted
    to one dtype first."""
    out_dtype = cache_v.dtype
    if not (q.dtype == torch.float32 and cache_k.dtype == torch.bfloat16
            and cache_v.dtype == torch.bfloat16):
        dt = torch.promote_types(torch.promote_types(q.dtype, cache_k.dtype),
                                 cache_v.dtype)
        q, cache_k, cache_v = (t.to(dt) for t in (q, cache_k, cache_v))
    q, cache_k, cache_v = (t.contiguous() for t in (q, cache_k, cache_v))
    valid = valid.contiguous()
    if check_attention(attention) == "kernel" and q.is_cuda:
        ctx, mass = decode_attention_kernel(q, cache_k, cache_v, valid)
    else:
        ctx, mass = decode_attention_ref(q, cache_k, cache_v, valid)
    return ctx.to(out_dtype), mass


def attention_decode(
    x: torch.Tensor,                # (B, 1, D)
    p: dict,
    cfg: ModelConfig,
    cache_k: torch.Tensor,          # (B, C, KV, hd), RoPE already applied
    cache_v: torch.Tensor,          # (B, C, KV, hd)
    valid: torch.Tensor,            # (B, C) bool
    position: torch.Tensor,         # (B,) current absolute position
    attention: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out (B,1,D), mass (B,C) f32, (k_new, v_new)).

    ``mass`` is the softmax probability mass each cache slot received,
    summed over heads. Through kernel 6, so a row with no valid slot gives
    out 0 and mass 0 (the guard of ``serve/decode._gqa_attend``), where
    the reference's unguarded softmax averages such a row uniformly."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // KV
    q, k, v = _project_qkv(x, p, cfg)
    q = rope(q, position[:, None], cfg.rope_theta)
    k = rope(k, position[:, None], cfg.rope_theta)
    ctx, mass = decode_attend(q[:, 0].reshape(B, KV, G, hd), cache_k,
                              cache_v, valid, attention)
    out = ein("bsh,hd->bsd", ctx.to(x.dtype).reshape(B, 1, H * hd), p["wo"])
    return out, mass, (k[:, 0], v[:, 0])


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def _act(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":          # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    if kind == "relu2":         # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    h = _act(ein("bsd,df->bsf", x, p["wi0"]), cfg.act)
    if cfg.mlp_gated:
        h = h * ein("bsd,df->bsf", x, p["wi1"])
    h = psh.shard(h, "batch", "seq", "ff")
    return psh.shard(ein("bsf,fd->bsd", h, p["wo"]), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Param init helpers (params tree + logical-axes tree, same structure)
# ---------------------------------------------------------------------------

def _norm_init(gen, shape, scale, dtype, device):
    """Standard normal values drawn in f32 from ``gen``, scaled, cast."""
    return (torch.randn(shape, generator=gen, dtype=F32, device=device)
            * scale).to(dtype)


def init_attention(gen, cfg: ModelConfig, dtype=BF16, device=None):
    H, KV, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_model)
    s = 0.02
    p = {
        "wq": _norm_init(gen, (D, H, hd), s, dtype, device),
        "wk": _norm_init(gen, (D, KV, hd), s, dtype, device),
        "wv": _norm_init(gen, (D, KV, hd), s, dtype, device),
        "wo": _norm_init(gen, (H * hd, D), s / math.sqrt(2 * cfg.num_layers),
                         dtype, device),
    }
    a = {
        "wq": "embed,heads,head_dim",
        "wk": "embed,kv,head_dim",
        "wv": "embed,kv,head_dim",
        "wo": "heads,embed",  # fused (H*hd) dim shards like heads
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=dtype, device=device)
        a["bq"], a["bk"], a["bv"] = ("heads,head_dim", "kv,head_dim",
                                     "kv,head_dim")
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        a["q_norm"] = a["k_norm"] = "head_dim"
    return p, a


def init_mlp(gen, cfg: ModelConfig, dtype=BF16, device=None):
    D, Fd = cfg.d_model, cfg.d_ff
    s = 0.02
    p = {
        "wi0": _norm_init(gen, (D, Fd), s, dtype, device),
        "wo": _norm_init(gen, (Fd, D), s / math.sqrt(2 * cfg.num_layers),
                         dtype, device),
    }
    a = {"wi0": "embed,ff", "wo": "ff,embed"}
    if cfg.mlp_gated:
        p["wi1"] = _norm_init(gen, (D, Fd), s, dtype, device)
        a["wi1"] = "embed,ff"
    return p, a
