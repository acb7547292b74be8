"""Mamba2 (SSD, state-space duality) in chunked matmul form.

Counterpart of ``repro/models/ssm.py``: chunk-local attention-like
einsums plus a small inter-chunk state recurrence [arXiv:2405.21060
§6], n_groups = 1. The reference's ``lax.scan`` over chunks is a Python
loop here.

Layer params:
  in_proj:  (D, 2*Din + 2*N + nh)   -> [z, x, B, C, dt]
  conv_w:   (4, Din + 2*N)          depthwise causal conv over [x, B, C]
  conv_b:   (Din + 2*N,)
  A_log:    (nh,)    dt_bias: (nh,)    skip D: (nh,)
  norm:     (Din,)   gated RMSNorm
  out_proj: (Din, D)
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _norm_init, ein, rms_norm
from repro_torch.parallel import sharding as psh

F32 = torch.float32
BF16 = torch.bfloat16


def dims(cfg: ModelConfig):
    Din = cfg.ssm_expand * cfg.d_model
    nh = Din // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = Din + 2 * N
    return Din, nh, N, conv_dim


def init_mamba(gen, cfg: ModelConfig, dtype=BF16, device=None):
    D = cfg.d_model
    Din, nh, N, conv_dim = dims(cfg)
    s = 0.02
    p = {
        "in_proj": _norm_init(gen, (D, 2 * Din + 2 * N + nh), s, dtype, device),
        "conv_w": _norm_init(gen, (4, conv_dim), 0.2, dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=F32,
                                          device=device)),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=device),
        "skip": torch.ones((nh,), dtype=F32, device=device),
        "norm": torch.ones((Din,), dtype=dtype, device=device),
        "out_proj": _norm_init(gen, (Din, D),
                               s / math.sqrt(2 * max(cfg.num_layers, 1)),
                               dtype, device),
    }
    a = {
        "in_proj": "embed,inner",
        "conv_w": "conv,inner",
        "conv_b": "inner",
        "A_log": "state",
        "dt_bias": "state",
        "skip": "state",
        "norm": "inner",
        "out_proj": "inner,embed",
    }
    return p, a


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel 4: (B, S, C) -> (B, S, C)."""
    K, S = w.shape[0], x.shape[1]
    out = 0
    for i in range(K):
        shift = K - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S] if shift else x
        out = out + xi * w[i]
    return F.silu(out + b)


def _split_proj(u, p, cfg: ModelConfig):
    Din, nh, N, conv_dim = dims(cfg)
    zxbcdt = ein("bsd,de->bse", u, p["in_proj"])
    z = zxbcdt[..., :Din]
    xBC = zxbcdt[..., Din: Din + conv_dim]
    dt = zxbcdt[..., Din + conv_dim:]
    return z, xBC, dt


def mamba_layer(u: torch.Tensor, p: dict, cfg: ModelConfig,
                return_state: bool = False):
    """Training/prefill SSD. u: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns the decode cache after the whole
    sequence: {'conv': the last K-1 pre-conv inputs (bf16), 'state': the
    final SSM state}, the layout of ``init_ssm_cache``. S must be a
    multiple of the chunk ``min(ssm_chunk, S)``, as in the reference."""
    B, S, D = u.shape
    Din, nh, N, conv_dim = dims(cfg)
    hp = cfg.ssm_head_dim
    cl = min(cfg.ssm_chunk, S)
    if S % cl:
        raise ValueError(f"seq {S} % chunk {cl} != 0")
    nc = S // cl

    z, xBC_pre, dt = _split_proj(u, p, cfg)
    xBC = _causal_conv(xBC_pre, p["conv_w"], p["conv_b"])
    x = xBC[..., :Din]
    Bm = xBC[..., Din: Din + N].float()
    Cm = xBC[..., Din + N:].float()

    x = psh.shard(x, "batch", "seq", "inner")
    xh = x.reshape(B, S, nh, hp).float()
    dt = F.softplus(dt.float() + p["dt_bias"])                     # (B,S,nh)
    a = -torch.exp(p["A_log"])                                      # (nh,)
    dA = dt * a

    xc = xh.reshape(B, nc, cl, nh, hp)
    dtc = dt.reshape(B, nc, cl, nh)
    dAc = dA.reshape(B, nc, cl, nh)
    Bc = Bm.reshape(B, nc, cl, N)
    Cc = Cm.reshape(B, nc, cl, N)

    cum = torch.cumsum(dAc, dim=2)                                  # (B,nc,cl,nh)
    # intra-chunk "attention": L[q,t] = exp(cum_q - cum_t) for q >= t; the
    # mask is applied before the exp (the exponent is positive above it)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B,nc,q,t,nh)
    causal = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                   device=u.device))
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  -1e30))
    scores = ein("bcqn,bctn->bcqt", Cc, Bc)
    M = scores[..., None] * decay                                   # (B,nc,q,t,nh)
    xdt = xc * dtc[..., None]                                       # (B,nc,cl,nh,hp)
    y_intra = ein("bcqth,bcthp->bcqhp", M, xdt)

    # chunk states: S_c = sum_t exp(cum_last - cum_t) * dt_t * B_t x_t^T
    last = cum[:, :, -1:, :]                                        # (B,nc,1,nh)
    rem = torch.exp(last - cum)                                     # (B,nc,cl,nh)
    Sc = ein("bctn,bcth,bcthp->bchpn", Bc, rem * dtc, xc)

    # inter-chunk recurrence over nc (the reference's lax.scan)
    chunk_decay = torch.exp(last[:, :, 0, :])                       # (B,nc,nh)
    s = torch.zeros((B, nh, hp, N), dtype=F32, device=u.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c][:, :, None, None] + Sc[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                           # (B,nc,nh,hp,N)
    y_inter = ein("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum), s_prevs)

    y = (y_intra + y_inter).reshape(B, S, nh, hp)
    y = y + xh * p["skip"][None, None, :, None]
    y = y.reshape(B, S, Din).to(u.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = psh.shard(ein("bsi,id->bsd", y, p["out_proj"]), "batch", "seq",
                    "embed")
    if not return_state:
        return out
    # decode cache: the state after the last chunk; the conv history is
    # the last K-1 pre-conv inputs (what the depthwise conv needs next)
    if S < 3:
        xBC_pre = F.pad(xBC_pre, (0, 0, 3 - S, 0))
    cache = {"conv": xBC_pre[:, -3:].to(BF16), "state": s}
    return out, cache


# ---------------------------------------------------------------------------
# Decode: constant-size state recurrence
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, device=None):
    Din, nh, N, conv_dim = dims(cfg)
    hp = cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, 3, conv_dim), dtype=BF16, device=device),
        "state": torch.zeros((batch, nh, hp, N), dtype=F32, device=device),
    }


def mamba_decode_step(u: torch.Tensor, cache: dict, p: dict,
                      cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """u: (B, 1, D); cache: {'conv', 'state'} -> (out (B,1,D), new cache)."""
    B = u.shape[0]
    Din, nh, N, conv_dim = dims(cfg)
    hp = cfg.ssm_head_dim

    z, xBC, dt = _split_proj(u, p, cfg)
    xBC = xBC[:, 0]                                                  # (B, conv_dim)
    hist = torch.cat([cache["conv"], xBC[:, None, :].to(BF16)], dim=1)
    w = p["conv_w"]                                                  # (4, conv_dim)
    conv_out = F.silu((hist * w[None]).sum(dim=1) + p["conv_b"])
    new_conv = hist[:, 1:]

    x = conv_out[..., :Din]
    Bm = conv_out[..., Din: Din + N].float()
    Cm = conv_out[..., Din + N:].float()
    xh = x.reshape(B, nh, hp).float()
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])                # (B, nh)
    a = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * a)                                          # (B, nh)

    state = cache["state"] * dA[:, :, None, None] + ein(
        "bn,bh,bhp->bhpn", Bm, dt1, xh)
    y = ein("bn,bhpn->bhp", Cm, state) + xh * p["skip"][None, :, None]
    y = y.reshape(B, 1, Din).to(u.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = ein("bsi,id->bsd", y, p["out_proj"])
    return out, {"conv": new_conv, "state": state}
