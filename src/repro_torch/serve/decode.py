"""serve_step builder: advance every sequence in the batch by one token.

Counterpart of ``repro/serve/decode.py``. A loop over the period-stacked
params and cache (the reference's ``lax.scan``). Per layer kind:

  attention   ring-buffer write + GQA decode attention over valid slots
  hh (SS±)    SpaceSaving replacement insert -> attend -> weighted
              monitored inserts of the received mass -> periodic halving
  mamba       constant-state SSD recurrence
  mamba_attn  mamba + the zamba2 shared attention block (own cache)
  decoder_x   whisper: self-attn ring + unmasked cross-attn over the
              precomputed encoder K/V

Every decode attention is kernel 6 (``layers.decode_attend``), which
returns the context with the per-slot mass the SS± cache ingests. The
kernel keeps P in f32 through P·V where the reference casts P to the
cache's dtype first, so a bf16 context agrees within bf16 rounding.

On a mesh (``parallel.sharding.use_mesh``, DTensor params and a cache
laid out by ``kv_cache.cache_axes``: slots over "model") the embedding
and the logits are laid out by the reference's ``shard`` calls. Each
attention cache step (the ring write, the SS± insert, attend, mass,
decay) runs under ``sharding.local_map`` on the rank's batch rows with
every q-head and every slot: the slots are gathered over "model" for
kernel 6 (see ``models.layers``), so the mass, and the SS± counts made
from it, are the whole-cache ones; the new entry is laid back out as the
old one was, and the new cache by ``cache_axes``.

The step is functional, as the reference's: the cache passed in is not
modified (a ring write or an insert writes a copy).

Returns (logits (B,1,V), new_cache, aux); aux carries the step's MoE
expert counts (the SS± load sketch's input, ``sketch.stats``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba_decode_step
from repro_torch.models.transformer import (_embed, _kinds, _unembed,
                                           tree_leaves, tree_map, tree_stack)
from repro_torch.parallel import sharding as psh
from repro_torch.platform import DEFAULT_DEVICE, resolve_device
from repro_torch.serve import h2o
from repro_torch.serve.kv_cache import _is_hh, cache_axes

I32 = torch.int32


# ---------------------------------------------------------------------------
# Attention decode primitives
# ---------------------------------------------------------------------------

def _gqa_attend(q, cache_k, cache_v, valid, attention: str = "kernel"):
    """q: (B,KV,G,hd); cache: (B,C,KV,hd); valid: (B,C) ->
    (ctx (B,KV,G,hd), mass (B,C)); a row with no valid slot gives 0."""
    return L.decode_attend(q, cache_k, cache_v, valid, attention)


def _project_decode(x, p, cfg: ModelConfig, pos, use_rope: bool = True):
    """x: (B,1,D) -> q (B,KV,G,hd), k_new/v_new (B,KV,hd)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = L._project_qkv(x, p, cfg)
    if use_rope:
        q = L.rope(q, pos[:, None], cfg.rope_theta)
        k = L.rope(k, pos[:, None], cfg.rope_theta)
    # on a mesh, every head on each rank's rows (see _on_rows)
    q, k, v = (psh.shard(t, "batch", None, None, None) for t in (q, k, v))
    return q[:, 0].reshape(B, KV, H // KV, hd), k[:, 0], v[:, 0]


def _out_proj(ctx, p, cfg: ModelConfig):
    B = ctx.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    return L.ein("bh,hd->bd", ctx.reshape(B, H * hd), p["wo"])[:, None]


def _on_rows(step, entry, q, *args):
    """``step(entry, q, *args) -> (ctx, new entry)``, an attention cache
    step; with a DTensor among its inputs, on each rank's batch rows with
    every slot and head (entry leaves, q (B,KV,G,hd) and each (B, ...)
    arg split by "batch" alone), ctx and the new entry split by rows
    (``serve_step`` lays the new cache out after)."""
    names = list(entry)
    ins = [entry[n] for n in names] + [q, *args]
    if not any(psh.is_dtensor(t) for t in ins):
        return step(entry, q, *args)

    def local(*xs):
        ctx, new = step(dict(zip(names, xs)), *xs[len(names):])
        return (ctx,) + tuple(new[n] for n in names)

    ctx, *new = psh.local_map(
        local, ins, [psh.lead_spec(t.shape, "batch") for t in ins],
        [psh.lead_spec(t.shape, "batch") for t in (q, *ins[:len(names)])])
    return ctx, dict(zip(names, new))


def _ring_step(entry, q, k_new, v_new, pos, attention="kernel"):
    """The ring write at slot pos % C and the attention over the valid
    slots: (ctx, {'k', 'v'})."""
    B, C = entry["k"].shape[:2]
    slot = (pos % C).long()
    bidx = torch.arange(B, device=q.device)
    k_cache = entry["k"].clone()
    v_cache = entry["v"].clone()
    k_cache[bidx, slot] = k_new.to(k_cache.dtype)
    v_cache[bidx, slot] = v_new.to(v_cache.dtype)
    valid = (torch.arange(C, device=q.device)[None, :]
             < torch.clamp_max(pos + 1, C)[:, None])
    ctx, _ = _gqa_attend(q, k_cache, v_cache, valid, attention)
    return ctx, {"k": k_cache, "v": v_cache}


def _ring_attn_decode(x, p, cfg: ModelConfig, entry, pos,
                      attention="kernel"):
    """Ring-buffer KV decode. entry: {'k','v'} (B,C,KV,hd); pos: (B,)."""
    q, k_new, v_new = _project_decode(x, p, cfg, pos)
    ctx, new = _on_rows(
        lambda e, q, k, v, pos: _ring_step(e, q, k, v, pos, attention),
        entry, q, k_new, v_new, pos)
    return _out_proj(ctx, p, cfg), new


def _hh_attn_decode(x, p, cfg: ModelConfig, entry, pos, decay_period: int,
                    attention="kernel"):
    """SS± heavy-hitter KV decode (see serve/h2o.py): insert, attend, add
    the mass, and halve every ``decay_period`` steps on row 0's position
    (the reference's tick)."""
    q, k_new, v_new = _project_decode(x, p, cfg, pos)
    ctx, entry = _on_rows(
        lambda e, q, k, v, pos, tick: hh_attend_step(
            e, q, k, v, pos, decay_period, attention, tick_pos=tick),
        entry, q, k_new, v_new, pos, pos[:1])
    return _out_proj(ctx, p, cfg), entry


def hh_attend_step(entry, q, k_new, v_new, pos, decay_period: int,
                   attention="kernel", tick_pos=None):
    """One SS± decode step after the projection: insert the token
    (k_new/v_new (B,KV,hd) cast to the cache's dtype), attend over the
    valid slots, add the mass averaged over the q (B,KV,G,hd) heads, and
    halve every ``decay_period`` steps on row 0's position (``tick_pos``,
    (1,), where ``pos`` holds a rank's rows of the batch). Returns
    (ctx (B,KV,G,hd), new entry)."""
    tick_pos = pos[:1] if tick_pos is None else tick_pos
    entry, _ = h2o.hh_insert(entry, pos, k_new, v_new)
    valid = h2o.hh_valid(entry)
    ctx, mass = _gqa_attend(q, entry["k"], entry["v"], valid, attention)
    entry = h2o.hh_add_mass(entry, mass / max(q.shape[1] * q.shape[2], 1))
    if decay_period:
        decayed = h2o.hh_decay(entry)
        tick = (tick_pos[0] % decay_period) == (decay_period - 1)
        entry = {name: (torch.where(tick, decayed[name], t)
                        if t.dtype == I32 else t)
                 for name, t in entry.items()}
    return ctx, entry


def _cross_attn_decode(x, p, entry, cfg: ModelConfig, attention="kernel"):
    """Whisper cross-attention against precomputed encoder K/V (no rope)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = psh.shard(L.project(x, p["wq"], "heads", None), "batch", None, None,
                  None)[:, 0].reshape(B, KV, H // KV, hd)
    valid = torch.ones(entry["xk"].shape[:2], dtype=torch.bool,
                       device=x.device)
    ctx, _ = _gqa_attend(q, entry["xk"], entry["xv"], valid, attention)
    return _out_proj(ctx, p, cfg)


# ---------------------------------------------------------------------------
# Per-layer decode
# ---------------------------------------------------------------------------

def _decode_layer(x, lp, entry, kind, cfg: ModelConfig, pos, shared,
                  hh: bool, decay_period: int, attention="kernel"):
    """Returns (x, new_entry, expert_counts)."""
    E = max(cfg.num_experts, 1)
    counts = torch.zeros((E,), dtype=I32, device=x.device)

    if kind.startswith("mamba"):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, new_ssm = mamba_decode_step(
            h, {"conv": entry["conv"], "state": entry["state"]}, lp["mamba"],
            cfg)
        x = x + y
        new_entry = dict(new_ssm)
        if kind == "mamba_attn":
            h = L.rms_norm(x, shared["ln1"], cfg.norm_eps)
            if hh:
                a, new_attn = _hh_attn_decode(h, shared["attn"], cfg,
                                              entry["attn"], pos,
                                              decay_period, attention)
            else:
                a, new_attn = _ring_attn_decode(h, shared["attn"], cfg,
                                                entry["attn"], pos, attention)
            x = x + a
            x = x + L.mlp(L.rms_norm(x, shared["ln2"], cfg.norm_eps),
                          shared["mlp"], cfg)
            new_entry["attn"] = new_attn
        return x, new_entry, counts

    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if hh:
        a, new_entry = _hh_attn_decode(h, lp["attn"], cfg, entry, pos,
                                       decay_period, attention)
    else:
        ring = {"k": entry["k"], "v": entry["v"]}
        a, new_entry = _ring_attn_decode(h, lp["attn"], cfg, ring, pos,
                                         attention)
        if kind == "decoder_x":
            new_entry = {**new_entry, "xk": entry["xk"], "xv": entry["xv"]}
    x = x + a
    if kind == "decoder_x":
        h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + _cross_attn_decode(h, lp["xattn"], entry, cfg, attention)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, counts = moe_ffn(h, lp["ffn"], cfg)
    else:
        y = L.mlp(h, lp["ffn"], cfg)
    return x + y, new_entry, counts


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------

def check_on(device: torch.device, what: str, t: torch.Tensor) -> None:
    """Raise where ``t`` is not on the device type a step was built for."""
    if t.device.type != device.type:
        raise ValueError(f"{what} was built for {device.type} and got a "
                         f"tensor on {t.device.type}")


def build_serve_step(cfg: ModelConfig, context: int, decay_period: int = 8192,
                     attention: str = "kernel", device=DEFAULT_DEVICE):
    """Returns serve_step(params, cache, tokens (B,1)) ->
    (logits (B,1,V), new_cache, aux). ``device`` is where the step runs
    (it raises without a card by default); ``attention`` picks the
    kernels or their plain versions on the card (CPU tensors always take
    the plain versions)."""
    dev = resolve_device(device)
    L.check_attention(attention)
    kinds, rem_kinds = _kinds(cfg)
    hh_flags = {k: _is_hh(cfg, k, context) for k in set(kinds) | set(rem_kinds)}
    E = max(cfg.num_experts, 1)

    def serve_step(params, cache, tokens):
        check_on(dev, "serve_step", tokens)
        x = _embed(params, cfg, tokens, None)
        pos = cache["pos"]                                  # (B,)
        shared = params.get("shared_attn")

        periods = []
        counts = torch.zeros((E,), dtype=I32, device=x.device)
        for i in range(tree_leaves(params["periods"])[0].shape[0]):
            lp = tree_map(lambda t: t[i], params["periods"])
            ce = tree_map(lambda t: t[i], cache["periods"])
            new_entries = {}
            for j, kind in enumerate(kinds):
                x, ne, c = _decode_layer(
                    x, lp[f"pos{j}"], ce[f"pos{j}"], kind, cfg, pos, shared,
                    hh_flags[kind], decay_period, attention)
                new_entries[f"pos{j}"] = ne
                counts = counts + c
            periods.append(new_entries)

        new_cache = {"periods": tree_stack(periods), "pos": pos + 1}
        for i, kind in enumerate(rem_kinds):
            x, ne, c = _decode_layer(
                x, params[f"rem{i}"], cache[f"rem{i}"], kind, cfg, pos,
                shared, hh_flags[kind], decay_period, attention)
            new_cache[f"rem{i}"] = ne
            counts = counts + c

        if psh.current_mesh() is not None:
            new_cache = psh.distribute(
                new_cache, cache_axes(cfg, tokens.shape[0], context), "act")
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = psh.shard(_unembed(params, cfg, x), "batch", None, "vocab")
        return logits, new_cache, {"expert_counts": counts}

    return serve_step

