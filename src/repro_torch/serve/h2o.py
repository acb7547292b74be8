"""SS±-driven heavy-hitter KV cache ("H2O via SpaceSaving±").

Counterpart of ``repro/serve/h2o.py``. A bounded KV cache with
accumulated-attention-mass eviction is the SpaceSaving algorithm: the
cache's slot set is the sketch's monitored set, quantized attention mass
is the count, and the paper's replacement rule (evict the argmin count;
the newcomer inherits minCount as its estimated error) is the eviction
policy. Every ``decay_period`` steps half of each monitored count is
deleted (a bounded-deletion batch with alpha = 2), so the mass is
windowed.

Per (batch row, layer): one sketch fused with the KV payload, ids (C,)
int32 absolute positions, counts (C,) int32 quantized mass, errors (C,)
int32. The reference vmaps one row's insert over the batch; here the
insert is one batched gather/scatter over rows, on the port's
``sketch.phases.select_insert_slot`` (the same tournament, ties to the
lowest slot). The integer state is bit for bit the reference's on the
same inputs.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.sketch.phases import select_insert_slot

I32 = torch.int32
EMPTY = -1
MASS_SCALE = 1024.0  # quantization: 1.0 attention mass -> 1024 counts


def quantize_mass(mass: torch.Tensor) -> torch.Tensor:
    """round(mass * 1024) to int32; halves to even, as ``jnp.round``."""
    return torch.round(mass * MASS_SCALE).to(I32)


def _insert_token_row(ids, counts, errors, k_row, v_row, pos, k_new, v_new):
    """SpaceSaving insert of one (position, kv) into one row's cache:
    ids/counts/errors (C,), k_row/v_row (C, KV, hd). Returns the updated
    tuple and the slot written (``hh_insert`` on a batch of one)."""
    entry = {"ids": ids[None], "counts": counts[None], "errors": errors[None],
             "k": k_row[None], "v": v_row[None]}
    out, sel = hh_insert(entry, torch.as_tensor(pos).reshape(1),
                         k_new[None], v_new[None])
    return (out["ids"][0], out["counts"][0], out["errors"][0], out["k"][0],
            out["v"][0], sel[0])


def hh_insert(entry: Dict[str, torch.Tensor], pos: torch.Tensor, k_new,
              v_new):
    """SpaceSaving replacement insert of one token per row.

    entry: {'k': (B,C,KV,hd), 'v': ..., 'ids': (B,C), 'counts', 'errors'};
    pos: (B,) absolute position; k_new/v_new: (B, KV, hd). The token takes
    the row's first EMPTY slot, else its first minimum-count slot, with
    count = error = that minimum (0 for an EMPTY slot): the paper's Alg 1,
    whose weight w is the token's first-step mass, added right after by
    ``hh_add_mass``. Returns (new entry, the slot written (B,))."""
    sel, mc, has_empty = select_insert_slot(entry["ids"], entry["counts"])
    min_count = torch.where(has_empty, 0, mc).to(I32)
    rows = torch.arange(sel.shape[0], device=sel.device)
    out = {name: entry[name].clone()
           for name in ("ids", "counts", "errors", "k", "v")}
    out["ids"][rows, sel] = pos.to(I32)
    out["counts"][rows, sel] = min_count
    out["errors"][rows, sel] = min_count
    out["k"][rows, sel] = k_new.to(out["k"].dtype)
    out["v"][rows, sel] = v_new.to(out["v"].dtype)
    return out, sel


def hh_add_mass(entry: Dict[str, torch.Tensor],
                mass: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted monitored inserts: every resident slot's count grows by
    the quantized attention mass it just received (mass (B, C) f32); an
    int32 add that wraps, as the reference's."""
    q = torch.where(entry["ids"] == EMPTY, 0, quantize_mass(mass))
    return {**entry, "counts": entry["counts"] + q}


def hh_decay(entry: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Windowed-mass deletion: halve monitored counts and errors (the
    counts are non-negative, so floor division is the reference's)."""
    empty = entry["ids"] == EMPTY
    counts = torch.where(empty, 0, entry["counts"] // 2)
    errors = torch.where(empty, 0, entry["errors"] // 2)
    return {**entry, "counts": counts, "errors": errors}


def hh_valid(entry: Dict[str, torch.Tensor]) -> torch.Tensor:
    return entry["ids"] != EMPTY  # (B, C)


def hh_heavy_positions(entry: Dict[str, torch.Tensor], m: int):
    """Top-m resident positions by estimated mass (diagnostics); ties to
    the lower slot, as ``jax.lax.top_k``."""
    key = torch.where(entry["ids"] == EMPTY, -(2**31), entry["counts"])
    vals, idx = torch.sort(key, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :m], idx[:, :m]
    return entry["ids"].gather(1, idx), vals
