"""KV-cache tree builders.

Counterpart of ``repro/serve/kv_cache.py``. One cache entry per period
position (mirroring the stacked-param layout of ``models.transformer``),
each with a leading (num_periods,) dim; remainder layers get unstacked
entries. Kinds:

  'full'        ring buffer, capacity = context length
  'swa'/'local' ring buffer, capacity = min(window, context)
  'global'      ring buffer, or the SS± heavy-hitter cache when the config
                sets hh_kv_budget and the context exceeds HH_ENGAGE_CTX
  'mamba'       SSD constant-size state {'conv', 'state'}
  'mamba_attn'  mamba + a KV entry for the shared attention block
  'decoder_x'   (whisper) self-attn ring + precomputed cross K/V

``build_cache`` (tensors) and ``cache_spec`` (shapes and dtypes, plus the
logical-axes tree) are driven by one layout function, so they agree.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.platform import DEFAULT_DEVICE, resolve_device

BF16 = torch.bfloat16
F32 = torch.float32
I32 = torch.int32

# SS± eviction engages only where a dense cache would be long-context
# infeasible. A module attribute read at call time: tests set it low to
# engage the SS± cache at smoke size.
HH_ENGAGE_CTX = 65536


def cache_len_for(cfg: ModelConfig, kind: str, context: int) -> int:
    """Physical slot count for a layer kind at a given logical context."""
    if kind in ("swa", "local"):
        return min(cfg.window, context)
    if _is_hh(cfg, kind, context):
        return cfg.hh_kv_budget
    return context


def _is_hh(cfg: ModelConfig, kind: str, context: int) -> bool:
    """SS± heavy-hitter eviction applies to unwindowed attention layers
    (gemma3 'global', zamba2's shared 'mamba_attn' block) when the
    context is past HH_ENGAGE_CTX and the config sets a budget."""
    if kind not in ("global", "mamba_attn", "full"):
        return False
    return bool(cfg.hh_kv_budget) and context > HH_ENGAGE_CTX


def _attn_entry(cfg: ModelConfig, B: int, C: int, hh: bool) -> Dict[str, Tuple]:
    """(shape, dtype, logical axes) triplets for one attention KV entry."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    e = {
        "k": ((B, C, KV, hd), BF16, ("batch", "cache", "kv", None)),
        "v": ((B, C, KV, hd), BF16, ("batch", "cache", "kv", None)),
    }
    if hh:
        # the SS± sketch fused with the KV payload: ids = absolute token
        # positions, counts = quantized accumulated attention mass,
        # errors = SS± estimated error (serve/h2o.py)
        e["ids"] = ((B, C), I32, ("batch", "cache"))
        e["counts"] = ((B, C), I32, ("batch", "cache"))
        e["errors"] = ((B, C), I32, ("batch", "cache"))
    return e


def _mamba_entry(cfg: ModelConfig, B: int) -> Dict[str, Tuple]:
    Din, nh, N, conv_dim = ssm_mod.dims(cfg)
    hp = cfg.ssm_head_dim
    return {
        "conv": ((B, 3, conv_dim), BF16, ("batch", None, "inner")),
        "state": ((B, nh, hp, N), F32, ("batch", "inner", None, None)),
    }


def _entry_layout(cfg: ModelConfig, kind: str, B: int, context: int):
    """Layout dict for one layer position."""
    C = cache_len_for(cfg, kind, context)
    if kind == "mamba":
        return _mamba_entry(cfg, B)
    if kind == "mamba_attn":
        out = _mamba_entry(cfg, B)
        out["attn"] = _attn_entry(cfg, B, C, _is_hh(cfg, kind, context))
        return out
    if kind == "decoder_x":
        out = _attn_entry(cfg, B, C, False)
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        Fr = cfg.encoder_frames
        out["xk"] = ((B, Fr, KV, hd), BF16, ("batch", "frames", "kv", None))
        out["xv"] = ((B, Fr, KV, hd), BF16, ("batch", "frames", "kv", None))
        return out
    return _attn_entry(cfg, B, C, _is_hh(cfg, kind, context))


def _is_leaf(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 and isinstance(t[0], tuple)


def _map_layout(fn, lay):
    if _is_leaf(lay):
        return fn(lay)
    return {k: _map_layout(fn, v) for k, v in lay.items()}


def _layout(cfg: ModelConfig, B: int, context: int):
    """The whole cache layout: {periods: {pos_i: entry}, rem_i: entry,
    pos}. Period entries get a leading (num_periods,) dim."""
    pattern, n_periods, remainder = cfg.layer_pattern()
    enc = cfg.family == "encdec"
    kinds = tuple("decoder_x" if enc else k for k in pattern)
    rem = tuple("decoder_x" if enc else k for k in remainder)

    def add_period_dim(t):
        return ((n_periods,) + t[0], t[1], ("period",) + t[2])

    layout = {"periods": {}, "pos": ((B,), I32, ("batch",))}
    for i, kind in enumerate(kinds):
        layout["periods"][f"pos{i}"] = _map_layout(
            add_period_dim, _entry_layout(cfg, kind, B, context))
    for i, kind in enumerate(rem):
        layout[f"rem{i}"] = _entry_layout(cfg, kind, B, context)
    return layout


def build_cache(cfg: ModelConfig, batch: int, context: int,
                device=DEFAULT_DEVICE):
    """Zero-initialized cache tensors on ``device``; SS± ``ids`` start at
    EMPTY (-1)."""
    dev = resolve_device(device)
    lay = _layout(cfg, batch, context)
    cache = _map_layout(
        lambda t: torch.zeros(t[0], dtype=t[1], device=dev), lay)
    return _fix_hh_ids(cache)


def _fix_hh_ids(cache):
    def walk(c, name=None):
        if isinstance(c, dict):
            return {k: walk(v, k) for k, v in c.items()}
        return torch.full_like(c, -1) if name == "ids" else c
    return walk(cache)


def cache_spec(cfg: ModelConfig, batch: int, context: int):
    """(shapes tree of (shape, dtype) pairs, logical-axes tree): the
    reference's ShapeDtypeStruct spec, without allocating."""
    lay = _layout(cfg, batch, context)
    spec = _map_layout(lambda t: (t[0], t[1]), lay)
    axes = _map_layout(lambda t: ",".join(a or "" for a in t[2]), lay)
    return spec, axes


def cache_axes(cfg: ModelConfig, batch: int, context: int):
    """Just the logical-axes tree (strings)."""
    return cache_spec(cfg, batch, context)[1]


__all__ = ["HH_ENGAGE_CTX", "cache_len_for", "build_cache", "cache_spec",
           "cache_axes"]
