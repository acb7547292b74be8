"""Mixture-of-Experts FFN with capacity-based sort/gather dispatch.

Counterpart of ``repro/models/moe.py``: tokens are sorted by assigned
expert, truncated at per-expert capacity C, scattered into an (E, C, D)
buffer, run through a batched expert matmul and combined back weighted
by the router gates. FLOPs scale with tokens x top_k x capacity_factor.

Dispatch is group-local, as the reference's: ``_num_dispatch_groups``
reads the active mesh's "groups" axes (the data-parallel ones), one
group per data shard, and capacity binds per group; without a mesh there
is one group. On a mesh the routing, the sort, ``searchsorted`` and the
scatters (which have no DTensor rule) run under ``sharding.local_map``
on each rank's groups, and the expert matmuls between the reference's
``shard`` calls run on DTensors, experts split over "model". Ties keep
the reference's order: ``top_k`` prefers the lower
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
from repro_torch.parallel import sharding as psh

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
    """Dispatch groups: the size of the mesh axes the "groups" rule binds
    (the data-parallel shard count), or 1 without a mesh, when nothing
    binds, or when that size does not divide the T tokens."""
    mesh, rules = psh.current_mesh(), psh.current_rules()
    if mesh is None or rules is None:
        return 1
    ax = rules.act.get("groups")
    if ax is None:
        return 1
    names = psh.axis_names(mesh)
    n = 1
    for a in ((ax,) if isinstance(ax, str) else tuple(ax)):
        if a in names:
            n *= mesh.size(names.index(a))
    return n if (n > 1 and T % n == 0) else 1


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

    xf = psh.shard(x.reshape(G, Tl, D), "groups", None, "embed")
    router = p["router"]
    if psh.is_dtensor(xf):
        def groups(*rest):
            return psh.lead_spec((G,) + rest, "groups")

        whole = psh.PartitionSpec(*([None] * router.ndim))
        xb, gate, route = psh.local_map(
            lambda xf, r: _dispatch(xf, r, cfg, C),
            (xf, router), (groups(Tl, D), whole),
            (groups(E, C, D), groups(Tl * K), groups(4, Tl * K)))
    else:
        xb, gate, route = _dispatch(xf, router, cfg, C)
    xb = psh.shard(xb, "groups", "experts", None, "embed")

    h = _act(ein("gecd,edf->gecf", xb, p["wi0"]), cfg.act)
    h = h * ein("gecd,edf->gecf", xb, p["wi1"])
    h = psh.shard(h, "groups", "experts", None, "ff")
    yb = ein("gecf,efd->gecd", h, p["wo"])
    yb = psh.shard(yb, "groups", "experts", None, "embed")

    if psh.is_dtensor(yb):
        out, counts = psh.local_map(
            lambda yb, gate, route: _combine(yb, gate, route, Tl, x.dtype),
            (yb, gate, route),
            (groups(E, C, D), groups(Tl * K), groups(4, Tl * K)),
            (groups(Tl, D), groups(E)))
    else:
        out, counts = _combine(yb, gate, route, Tl, x.dtype)
    out = psh.shard(out, "groups", None, "embed")
    return out.reshape(B, S, D), counts.sum(0, dtype=torch.int32)


def _dispatch(xf, router, cfg: ModelConfig, C: int):
    """Route each group's tokens (xf (G, Tl, D)) into its (E, C) buffer:
    (xb (G, E, C, D), the sorted assignments' gates (G, Tl*K) f32, and
    their expert, token, destination row and kept flag (G, 4, Tl*K)
    int32)."""
    G, Tl, D = xf.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dev = xf.device
    logits = ein("gtd,de->gte", xf.float(), router)
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
    buf = torch.zeros((G, E * C + 1, D), dtype=xf.dtype, device=dev)
    buf[gidx, dest] = picked
    xb = buf[:, : E * C].reshape(G, E, C, D)
    route = torch.stack([e_s, t_s, dest, keep.long()], dim=1)
    return xb, g_s, route.to(torch.int32)


def _combine(yb, g_s, route, Tl: int, dtype):
    """Each group's expert outputs (yb (G, E, C, D)) gathered back to
    token order, weighted by the gates and scatter-added: (out (G, Tl, D),
    the per-group expert counts (G, E) int32)."""
    G, E, C, D = yb.shape
    dev = yb.device
    e_s, t_s, dest, keep = route.long().unbind(1)
    gidx = torch.arange(G, device=dev)[:, None]
    yflat = torch.cat([yb.reshape(G, E * C, D),
                       torch.zeros((G, 1, D), dtype=yb.dtype, device=dev)],
                      dim=1)
    contrib = yflat[gidx, dest]                                 # (G, Tl*K, D)
    contrib = contrib * g_s[..., None].to(dtype) * keep.bool()[..., None]
    out = torch.zeros((G, Tl, D), dtype=dtype, device=dev)
    for g in range(G):
        out[g].index_add_(0, t_s[g], contrib[g].to(dtype))
    # per-expert counts of a known size (bincount's size follows the data)
    counts = torch.zeros((G, E), dtype=torch.int32, device=dev).scatter_add_(
        1, e_s, torch.ones_like(e_s, dtype=torch.int32))
    return out, counts
