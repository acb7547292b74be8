"""Mixture-of-Experts FFN with capacity-based sort/gather dispatch.

Counterpart of ``repro/models/moe.py``: tokens are sorted by assigned
expert, truncated at per-expert capacity C, scattered into an (E, C, D)
buffer, run through a batched expert matmul and combined back weighted
by the router gates. FLOPs scale with tokens x top_k x capacity_factor.

The reference's dispatch groups follow the active mesh's data-parallel
axis; the port's model does not read the mesh yet (ROADMAP item 19b),
so there is one group, which is what the reference computes without a
mesh. Ties keep the reference's order: ``top_k`` prefers the lower
expert index, the expert sort is stable, the run starts are left-side
``searchsorted``. The per-expert counts are bit-exact; the combine is a
scatter-add in x's dtype (``index_add_``), whose bf16 rounding order may
differ.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, _norm_init, ein

F32 = torch.float32


def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = 0.02
    p = {
        "router": _norm_init(gen, (D, E), s, F32, device),  # router kept f32
        "wi0": _norm_init(gen, (E, D, Fd), s, dtype, device),
        "wi1": _norm_init(gen, (E, D, Fd), s, dtype, device),
        "wo": _norm_init(gen, (E, Fd, D), s / math.sqrt(2 * cfg.num_layers),
                         dtype, device),
    }
    a = {
        "router": "embed,experts",
        "wi0": "experts,embed,ff",
        "wi1": "experts,embed,ff",
        "wo": "experts,ff,embed",
    }
    return p, a


def _num_dispatch_groups(T: int) -> int:
    """Dispatch groups: the mesh's data-parallel shard count in the
    reference; 1 without a mesh, the port's model's case until item
    19b."""
    return 1


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x: torch.Tensor, p: dict,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), expert_counts (E,) int32).

    expert_counts is the per-expert routed-token count, the stream the
    SS± load sketch ingests."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    G = _num_dispatch_groups(T)
    Tl = T // G
    C = max(1, int(math.ceil(Tl * K * cfg.capacity_factor / E)))
    dev = x.device

    xf = x.reshape(G, Tl, D)
    logits = ein("gtd,de->gte", xf.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, K)                              # (G, Tl, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # flatten the assignments and sort them by expert id, per group
    e_flat = expert.reshape(G, Tl * K)
    g_flat = gate.reshape(G, Tl * K)
    t_flat = torch.arange(Tl, device=dev).repeat_interleave(K)[None].expand(
        G, -1)
    order = torch.argsort(e_flat, dim=1, stable=True)
    e_s = e_flat.gather(1, order)
    g_s = g_flat.gather(1, order)
    t_s = t_flat.gather(1, order)

    # position within each expert's run; drop beyond capacity
    starts = torch.searchsorted(
        e_s, torch.arange(E, device=dev)[None].expand(G, -1).contiguous())
    pos = torch.arange(Tl * K, device=dev)[None] - starts.gather(1, e_s)
    keep = pos < C
    dest = torch.where(keep, e_s * C + pos, E * C)              # (G, Tl*K)

    # dispatch into a (G, E*C+1, D) buffer; the overflow row E*C is
    # written and dropped
    gidx = torch.arange(G, device=dev)[:, None]
    picked = xf[gidx, t_s]                                      # (G, Tl*K, D)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buf[gidx, dest] = picked
    xb = buf[:, : E * C].reshape(G, E, C, D)

    h = _act(ein("gecd,edf->gecf", xb, p["wi0"]), cfg.act)
    h = h * ein("gecd,edf->gecf", xb, p["wi1"])
    yb = ein("gecf,efd->gecd", h, p["wo"])

    # combine: gather back to token order, weight by gate, scatter-add
    yflat = torch.cat([yb.reshape(G, E * C, D),
                       torch.zeros((G, 1, D), dtype=yb.dtype, device=dev)],
                      dim=1)
    contrib = yflat[gidx, dest]                                 # (G, Tl*K, D)
    contrib = contrib * g_s[..., None].to(x.dtype) * keep[..., None]
    out = torch.zeros((G, Tl, D), dtype=x.dtype, device=dev)
    for g in range(G):
        out[g].index_add_(0, t_s[g], contrib[g].to(x.dtype))

    counts = torch.bincount(e_flat.reshape(-1), minlength=E).to(torch.int32)
    return out.reshape(B, S, D), counts
