"""Unified decoder-only / encoder-decoder transformer covering the dense,
MoE, SSM and hybrid families.

Counterpart of ``repro/models/transformer.py``, with its param tree:
the config's ``layer_pattern()`` gives a repeating period (gemma3: 5
local + 1 global; zamba2: 5 mamba + 1 mamba with the shared attention
block); each period position's params are stacked with a leading
(num_periods,) dim under ``periods/pos{i}``, remainder layers sit
unstacked under ``rem{i}``, Zamba2's shared block under
``shared_attn`` and Whisper's encoder under ``encoder``. The reference
``lax.scan``s over periods; here a Python loop walks them
(``maybe_scan``), each stacked leaf unbound once per forward. Remat
(the reference's ``jax.checkpoint`` of each period's body) is
``torch.utils.checkpoint``: the period's activations are recomputed in
the backward. Gradients flow through everything, kernel 5 included
(its op carries the plain attention's gradient).

On a mesh (``parallel.sharding.use_mesh``, params laid out by
``sharding.distribute``) the forward runs on DTensors: the embedding,
the encoder frames and the logits are laid out by the reference's
``shard`` calls, as are the layers' activations, and the prefill's
cache is laid out by ``serve.kv_cache.cache_axes``.

Every function that attends takes ``attention="kernel" | "plain"``
(see ``layers.attention``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.ssm import init_mamba, mamba_layer
from repro_torch.parallel import sharding as psh
from repro_torch.platform import DEFAULT_DEVICE, resolve_device

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32


# ---------------------------------------------------------------------------
# Nested-dict trees (the reference's pytrees)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and tuples of the same
    structure (a NamedTuple, such as a train state, keeps its type)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple):
        out = [tree_map(fn, *ts) for ts in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_stack(trees):
    """Stack a list of same-structure trees along a new leading dim (one
    tree: a view with the dim added, no copy)."""
    if len(trees) == 1:
        return tree_map(lambda t: t.unsqueeze(0), trees[0])
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen, kind: str, cfg: ModelConfig, dtype, device):
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=dtype, device=device)  # noqa: E731
    if kind.startswith("mamba"):
        mp, ma = init_mamba(gen, cfg, dtype, device)
        return {"ln1": ones(), "mamba": mp}, {"ln1": "embed", "mamba": ma}
    p = {"ln1": ones(), "ln2": ones()}
    a = {"ln1": "embed", "ln2": "embed"}
    p["attn"], a["attn"] = L.init_attention(gen, cfg, dtype, device)
    if kind == "decoder_x":  # whisper decoder: + cross-attention
        p["xattn"], a["xattn"] = L.init_attention(gen, cfg, dtype, device)
        p["lnx"], a["lnx"] = ones(), "embed"
    if cfg.family == "moe":
        p["ffn"], a["ffn"] = init_moe(gen, cfg, dtype, device)
    else:
        p["ffn"], a["ffn"] = L.init_mlp(gen, cfg, dtype, device)
    return p, a


def _stack(trees):
    """Stack a list of (param, axes) pairs along a new leading 'period' dim."""
    params = tree_map(lambda *xs: torch.stack(xs), *[t[0] for t in trees])
    axes = tree_map(lambda s: f"period,{s}" if s else "period", trees[0][1])
    return params, axes


def _generator(gen, device: torch.device):
    """A ``torch.Generator`` on ``device``: ``gen`` itself, or a new one
    seeded with it when it is an int (None: the default generator)."""
    if gen is None or isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def init_params(gen, cfg: ModelConfig, dtype=BF16, device=DEFAULT_DEVICE):
    """Returns (params, axes) trees with identical structure, drawn from
    ``gen`` (a seeded ``torch.Generator`` on ``device``, or an int seed).
    The values are not the reference's (``jax.random`` bits); the tests
    carry the reference's params over with ``convert.params_from_reference``.
    """
    dev = resolve_device(device)
    gen = _generator(gen, dev)
    pattern, n_periods, remainder = cfg.layer_pattern()
    D, V = cfg.d_model, cfg.vocab_size
    dec_kind = [("decoder_x" if cfg.family == "encdec" else k) for k in pattern]
    ones = lambda: torch.ones((D,), dtype=dtype, device=dev)  # noqa: E731

    # std 0.02 (GPT-2-style): with tie_embeddings the same matrix is the
    # unembed, so std 1.0 would give sqrt(D)-scale logits (loss >> ln V).
    params: Dict = {"embed": L._norm_init(gen, (V, D), 0.02, dtype, dev)}
    axes: Dict = {"embed": "vocab,embed"}

    stacked_p, stacked_a = {}, {}
    for pos, kind in enumerate(dec_kind):
        per_period = [_init_layer(gen, kind, cfg, dtype, dev)
                      for _ in range(n_periods)]
        stacked_p[f"pos{pos}"], stacked_a[f"pos{pos}"] = _stack(per_period)
    params["periods"], axes["periods"] = stacked_p, stacked_a

    for i, kind in enumerate(remainder):
        rk = "decoder_x" if cfg.family == "encdec" else kind
        params[f"rem{i}"], axes[f"rem{i}"] = _init_layer(gen, rk, cfg, dtype,
                                                         dev)

    if cfg.family == "hybrid":
        sp = {"ln1": ones(), "ln2": ones()}
        sa = {"ln1": "embed", "ln2": "embed"}
        sp["attn"], sa["attn"] = L.init_attention(gen, cfg, dtype, dev)
        sp["mlp"], sa["mlp"] = L.init_mlp(gen, cfg, dtype, dev)
        params["shared_attn"], axes["shared_attn"] = sp, sa

    if cfg.family == "encdec":
        ep, ea = _stack([_init_layer(gen, "encoder", cfg, dtype, dev)
                         for _ in range(cfg.encoder_layers)])
        params["encoder"] = {"layers": ep, "final_norm": ones()}
        axes["encoder"] = {"layers": ea, "final_norm": "embed"}

    params["final_norm"] = ones()
    axes["final_norm"] = "embed"
    if not cfg.tie_embeddings:
        params["unembed"] = L._norm_init(gen, (D, V), 0.02, dtype, dev)
        axes["unembed"] = "embed,vocab"
    return params, axes


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _unstack(xs, n: int) -> list:
    """The ``n`` per-step trees of ``xs``: each leaf unbound once (the same
    values, as views). Under autograd ``unbind``'s backward is one stack
    of the steps' gradients, where indexing ``p[i]`` step by step would
    back each step with a zero tensor of the whole stacked leaf."""
    if isinstance(xs, dict):
        per = {k: _unstack(v, n) for k, v in xs.items()}
        return [{k: per[k][i] for k in xs} for i in range(n)]
    return list(torch.unbind(xs, 0))


def maybe_scan(cfg: ModelConfig, body, carry, xs):
    """The reference's ``lax.scan`` over the leading dim of ``xs`` (or its
    unrolled loop under ``cfg.unroll_scan``; here both are the loop).
    Returns (carry, the per-step outputs stacked)."""
    n = tree_leaves(xs)[0].shape[0]
    ys = []
    for step in _unstack(xs, n):
        carry, y = body(carry, step)
        ys.append(y)
    if ys and tree_leaves(ys[0]):
        return carry, tree_stack(ys)
    return carry, (ys[0] if ys else None)


def _ring_from_prefill(k, v, ctx_len: int):
    """Scatter the last min(C, S) prefill K/V into ring-slot order: token t
    lives at slot t % C, the cache a step-by-step decode would build."""
    B, S = k.shape[0], k.shape[1]
    C = ctx_len
    Cp = min(C, S)
    slots = torch.arange(S - Cp, S, device=k.device) % C
    kc = torch.zeros((B, C) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros((B, C) + tuple(v.shape[2:]), dtype=v.dtype,
                     device=v.device)
    kc[:, slots] = k[:, -Cp:]
    vc[:, slots] = v[:, -Cp:]
    return kc, vc


def _collect_attn_entry(k, v, kind, cfg: ModelConfig, collect_ctx: int):
    """The decode cache entry of one attention layer from prefill K/V; on
    a mesh, built from each rank's batch rows and kv-heads (the slots
    whole; ``prefill_forward`` lays the cache out after)."""
    from repro_torch.serve.kv_cache import _is_hh

    if not psh.is_dtensor(k):
        return _collect_attn_entry_local(k, v, kind, cfg, collect_ctx)
    kv = psh.act_spec(k.shape, "batch", "seq", "kv", None).spec
    slots = psh.PartitionSpec(kv[0], None, kv[2], None)
    rows = psh.PartitionSpec(kv[0], None)
    names = ("k", "v", "ids", "counts", "errors")

    def local(k, v):
        e = _collect_attn_entry_local(k, v, kind, cfg, collect_ctx)
        return tuple(e[n] for n in names if n in e)

    out = psh.local_map(local, (k, v), (kv, kv), (slots, slots) + (rows,) * (
        3 if _is_hh(cfg, kind, collect_ctx) else 0))
    return dict(zip(names, out))


def _collect_attn_entry_local(k, v, kind, cfg: ModelConfig,
                              collect_ctx: int):
    from repro_torch.serve.kv_cache import _is_hh, cache_len_for

    C = cache_len_for(cfg, kind, collect_ctx)
    kc, vc = _ring_from_prefill(k, v, C)
    entry = {"k": kc, "v": vc}
    if _is_hh(cfg, kind, collect_ctx):
        # cold-start residents: the last C prefill tokens, uniform counts
        B, S = k.shape[0], k.shape[1]
        Cp = min(C, S)
        idx = torch.arange(S - Cp, S, device=k.device)
        ids = torch.full((B, C), -1, dtype=I32, device=k.device)
        ids[:, idx % C] = idx.to(I32)
        entry["ids"] = ids
        entry["counts"] = (ids >= 0).to(I32)
        entry["errors"] = torch.zeros((B, C), dtype=I32, device=k.device)
    return entry


def _shared_block(x, sp, cfg: ModelConfig, positions, collect_ctx=None,
                  attention="kernel"):
    """Zamba2's shared attention+MLP block (weights reused in the stack)."""
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    entry = None
    if collect_ctx is None:
        x = x + L.attention(h, sp["attn"], cfg, "full", positions,
                            attention=attention)
    else:
        a, (k, v) = L.attention(h, sp["attn"], cfg, "full", positions,
                                return_kv=True, attention=attention)
        x = x + a
        entry = _collect_attn_entry(k, v, "mamba_attn", cfg, collect_ctx)
    x = x + L.mlp(L.rms_norm(x, sp["ln2"], cfg.norm_eps), sp["mlp"], cfg)
    return x, entry


def _decoder_layer(x, lp, kind, cfg: ModelConfig, positions, cross_states,
                   shared, collect_ctx=None, attention="kernel"):
    """Returns (x, expert_counts, cache_entry | None)."""
    E = max(cfg.num_experts, 1)
    counts = torch.zeros((E,), dtype=I32, device=x.device)
    entry = None
    if kind.startswith("mamba"):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        if collect_ctx is None:
            x = x + mamba_layer(h, lp["mamba"], cfg)
        else:
            y, entry = mamba_layer(h, lp["mamba"], cfg, return_state=True)
            x = x + y
        if kind == "mamba_attn":
            x, attn_entry = _shared_block(x, shared, cfg, positions,
                                          collect_ctx, attention)
            if collect_ctx is not None:
                entry = {**entry, "attn": attn_entry}
        return x, counts, entry
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if collect_ctx is None:
        x = x + L.attention(h, lp["attn"], cfg, kind, positions,
                            attention=attention)
    else:
        a, (k, v) = L.attention(h, lp["attn"], cfg, kind, positions,
                                return_kv=True, attention=attention)
        x = x + a
        entry = _collect_attn_entry(k, v, kind, cfg, collect_ctx)
    if "xattn" in lp:
        h = L.rms_norm(x, lp["lnx"], cfg.norm_eps)
        x = x + L.attention(h, lp["xattn"], cfg, "full", positions,
                            cross_states=cross_states, attention=attention)
        if collect_ctx is not None:
            # precomputed cross K/V for decode (no rope on cross attention)
            entry["xk"] = L.project(cross_states, lp["xattn"]["wk"], "kv",
                                    None)
            entry["xv"] = L.project(cross_states, lp["xattn"]["wv"], "kv",
                                    None)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, counts = moe_ffn(h, lp["ffn"], cfg)
    else:
        y = L.mlp(h, lp["ffn"], cfg)
    return x + y, counts, entry


def _run_stack(x, params, cfg: ModelConfig, positions, cross_states,
               kinds_period, remainder, remat: bool = True, collect_ctx=None,
               attention="kernel"):
    """Returns (x, expert_counts, cache | None)."""
    shared = params.get("shared_attn")
    E = max(cfg.num_experts, 1)

    def period_body(x, period_params):
        counts = torch.zeros((E,), dtype=I32, device=x.device)
        entries = {}
        for pos, kind in enumerate(kinds_period):
            x, c, e = _decoder_layer(
                x, period_params[f"pos{pos}"], kind, cfg, positions,
                cross_states, shared, collect_ctx, attention)
            counts = counts + c
            if collect_ctx is not None:
                entries[f"pos{pos}"] = e
        return x, (counts, entries)

    body = period_body
    if remat:   # the reference's jax.checkpoint(period_body)
        # the recompute runs in the backward, on autograd's device thread
        # for CUDA tensors: it re-enters the forward's mesh
        mesh, rules = psh.current_mesh(), psh.current_rules()

        def in_mesh(x, period_params):
            with psh.use_mesh(mesh, rules):
                return period_body(x, period_params)

        def body(x, period_params):
            return checkpoint(in_mesh, x, period_params,
                              use_reentrant=False)
    x, (counts, period_entries) = maybe_scan(cfg, body, x,
                                             params["periods"])
    expert_counts = counts.sum(dim=0, dtype=I32)
    cache = None
    if collect_ctx is not None:
        cache = {"periods": period_entries}
    for i, kind in enumerate(remainder):
        x, c, e = _decoder_layer(x, params[f"rem{i}"], kind, cfg, positions,
                                 cross_states, shared, collect_ctx, attention)
        expert_counts = expert_counts + c
        if collect_ctx is not None:
            cache[f"rem{i}"] = e
    return x, expert_counts, cache


def _kinds(cfg: ModelConfig):
    pattern, _, remainder = cfg.layer_pattern()
    enc = cfg.family == "encdec"
    return (tuple("decoder_x" if enc else k for k in pattern),
            tuple("decoder_x" if enc else k for k in remainder))


def _embed(params, cfg: ModelConfig, tokens, vision):
    table = params["embed"].to(BF16)
    if psh.is_dtensor(table) or psh.is_dtensor(tokens):
        # on each rank's rows, the table gathered: DTensor's own indexing
        # by a row-split DTensor of tokens has no backward on torch 2.11
        B, S = tokens.shape
        P = psh.PartitionSpec
        x = psh.local_map(lambda t, i: t[i.long()], (table, tokens),
                          (P(None, None), psh.lead_spec((B, S), "batch")),
                          psh.lead_spec((B, S, table.shape[1]), "batch"))
    else:
        x = table[tokens.long()]
    x = x * math.sqrt(cfg.d_model)
    if vision is not None:
        x = torch.cat([vision.to(x.dtype), x], dim=1)
    return psh.shard(x, "batch", "seq", "embed")


def _encode(params, cfg: ModelConfig, frames, dtype, attention):
    """Whisper's encoder over the frame embeddings: the cross states."""
    if frames is None:
        raise ValueError("whisper needs frame embeddings")
    enc = psh.shard(frames.to(dtype), "batch", "seq", "embed")
    enc_pos = torch.arange(enc.shape[1], device=enc.device)

    def enc_body(h, lp):
        h, _, _ = _decoder_layer(h, lp, "encoder", cfg, enc_pos, None, None,
                                 attention=attention)
        return h, None

    enc, _ = maybe_scan(cfg, enc_body, enc, params["encoder"]["layers"])
    return L.rms_norm(enc, params["encoder"]["final_norm"], cfg.norm_eps)


def _unembed(params, cfg: ModelConfig, x):
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(BF16)
    return L.ein("bsd,dv->bsv", x, unembed)


def forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,                     # (B, S_text)
    vision: Optional[torch.Tensor] = None,    # (B, Fv, D) llava patch embeds
    frames: Optional[torch.Tensor] = None,    # (B, Fa, D) whisper frames
    remat: bool = True,
    attention: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), expert_counts (E,)). S = vision+text."""
    kinds, rem_kinds = _kinds(cfg)
    x = _embed(params, cfg, tokens, vision)
    positions = torch.arange(x.shape[1], device=x.device)
    cross_states = None
    if cfg.family == "encdec":
        cross_states = _encode(params, cfg, frames, x.dtype, attention)
    x, expert_counts, _ = _run_stack(x, params, cfg, positions, cross_states,
                                     kinds, rem_kinds, remat=remat,
                                     attention=attention)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (psh.shard(_unembed(params, cfg, x), "batch", "seq", "vocab"),
            expert_counts)


def prefill_forward(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    context: int,
    vision: Optional[torch.Tensor] = None,
    frames: Optional[torch.Tensor] = None,
    attention: str = "kernel",
):
    """Full-sequence forward that also fills the decode cache.

    Returns (last-token logits (B, 1, V), cache), the cache
    layout-identical to ``serve.kv_cache.build_cache(cfg, B, context)``
    after S decode steps (ring slots, SSD state, Whisper's cross K/V;
    SS± entries cold-started, see ``_collect_attn_entry``).
    """
    kinds, rem_kinds = _kinds(cfg)
    x = _embed(params, cfg, tokens, vision)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)
    cross_states = None
    if cfg.family == "encdec":
        cross_states = _encode(params, cfg, frames, x.dtype, attention)
    x, _, cache = _run_stack(x, params, cfg, positions, cross_states, kinds,
                             rem_kinds, remat=False, collect_ctx=context,
                             attention=attention)
    cache["pos"] = torch.full((B,), S, dtype=I32, device=x.device)
    if psh.current_mesh() is not None:
        from repro_torch.serve.kv_cache import cache_axes
        cache = psh.distribute(cache, cache_axes(cfg, B, context), "act")
    x = L.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return (psh.shard(_unembed(params, cfg, x), "batch", None, "vocab"),
            cache)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = True,
            attention: str = "kernel"):
    """Masked next-token cross-entropy; returns (loss, aux). Differentiable
    in the params, kernel 5's op included: the train
    step (``train/step.py``) takes its gradient."""
    logits, expert_counts = forward(
        params, cfg, batch["tokens"], vision=batch.get("vision"),
        frames=batch.get("frames"), remat=remat, attention=attention)
    labels = batch["labels"]
    S_text = labels.shape[1]

    def token_nll(logits, labels):
        # the vision prefix predicts nothing
        logits = logits[:, -S_text:].float()
        lse = torch.logsumexp(logits, dim=-1)
        return lse - logits.gather(-1, labels.long()[..., None])[..., 0]

    if psh.is_dtensor(logits):
        # the label pick reads each row's whole vocab: on each rank's rows,
        # the vocab gathered (DTensor's own gather backward would build a
        # zero gradient of the global logits' size on every rank)
        rows = psh.act_spec(labels.shape, "batch", "seq").spec
        nll = psh.local_map(
            token_nll, (logits, labels),
            (psh.act_spec(logits.shape, "batch", "seq", None).spec, rows),
            rows)
    else:
        nll = token_nll(logits, labels)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(labels, dtype=F32)
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss, {"expert_counts": expert_counts}
