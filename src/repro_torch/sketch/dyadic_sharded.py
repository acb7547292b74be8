"""Hash-sharded Dyadic SpaceSaving±: the shard × level bank on one card.

Counterpart of ``repro/sketch/dyadic_sharded.py`` on one device: row
(s, l) of the (S, bits, k) bank is a SpaceSaving± summary of the
level-l nodes with ``shard_of(node, S) == s``. A block is routed by the
composed ``bank.ShardLevelRouter`` and ingested by the dense core
(``bank.update_block_fused``: ``phase1_dense`` and kernel 2 on the card).
Each shard carries the full single-bank per-level sizing, because a
node's whole mass lands on one shard. Queries read each node's owner
row, with no merge error; ``merge`` pairs two banks row by row;
``consolidate`` folds the shards into one ``dyadic.DyadicState``.

The reference's ``shard_map`` path over a device mesh waits for the
port's mesh (ROADMAP.md Queue 1 item 19).

Items must lie in [0, 2^bits); weight > 0 inserts, < 0 deletes, 0 pads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.quantiles import dyadic_layer_capacities
from ..platform import DEFAULT_DEVICE, resolve_device
from . import bank as bk
from .bank import ShardLevelRouter, shard_of
from .dyadic import (DyadicState, _add_mass, _layer_index, _node_counts,
                     _rank_terms, feed_blocks, lockstep_quantile_search)
from .state import I32, VARIANT_SSPM, SketchState, wrap_add


class DyadicShardedState(NamedTuple):
    """Shard-major stacked bank and the exactly tracked total mass."""

    bank: SketchState     # each field (S, bits, k) int32
    mass: torch.Tensor    # () int32, |F|_1 = I - D

    @property
    def num_shards(self) -> int:
        return self.bank.ids.shape[0]

    @property
    def bits(self) -> int:
        return self.bank.ids.shape[1]

    @property
    def capacity(self) -> int:
        return self.bank.ids.shape[2]

    @property
    def flat_bank(self) -> SketchState:
        """The engine's (S * bits, k) row view (row = s * bits + l)."""
        S, bits, k = self.bank.ids.shape
        return SketchState(*(t.reshape(S * bits, k) for t in self.bank))


def init(bits: int, num_shards: int, total_counters: Optional[int] = None,
         *, eps: Optional[float] = None, alpha: float = 2.0,
         device=DEFAULT_DEVICE) -> DyadicShardedState:
    """Empty bank; every shard gets the full per-level sizing
    (``dyadic_layer_capacities``), so the bank holds num_shards × one
    dyadic bank's counters."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    caps = dyadic_layer_capacities(bits, total_counters=total_counters,
                                   eps=eps, alpha=alpha)
    dev = resolve_device(device)
    flat = bk.init(list(caps) * num_shards, device=dev)
    k = flat.ids.shape[1]
    return DyadicShardedState(
        bank=SketchState(*(t.reshape(num_shards, bits, k) for t in flat)),
        mass=torch.zeros((), dtype=I32, device=dev))


def layer_capacities(state: DyadicShardedState) -> list:
    """Per-shard live counters per layer (the same on every shard)."""
    return bk.row_capacities(SketchState(*(t[0] for t in state.bank)))


def space_counters(state: DyadicShardedState) -> int:
    """Total live counters over all shards and layers."""
    return state.num_shards * sum(layer_capacities(state))


# ---------------------------------------------------------------------------
# Update: one composed-router bank update
# ---------------------------------------------------------------------------

def update_block(state: DyadicShardedState, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM, *,
                 path: str = "auto") -> DyadicShardedState:
    """Apply one block of signed weighted updates to the whole bank.

    ``path``: ``"bank"`` (the composed router on the (S * bits, k) bank)
    or ``"auto"``, which is ``"bank"`` here: no device mesh is active in
    the port.
    """
    if path == "shard_map":
        raise NotImplementedError(
            "path='shard_map' is not ported to repro_torch yet; ROADMAP.md "
            "Queue 1 item 19 (parallel/sharding.py) ports it")
    if path not in ("auto", "bank"):
        raise ValueError(f"unknown path {path!r}")
    items = items.to(I32)
    weights = weights.to(I32)
    S, bits, k = state.bank.ids.shape
    flat = bk.update_block_fused(state.flat_bank, items, weights,
                                 ShardLevelRouter(bits, S), variant)
    return DyadicShardedState(
        bank=SketchState(*(t.reshape(S, bits, k) for t in flat)),
        mass=_add_mass(state.mass, weights))


def process_stream(state: DyadicShardedState, items: np.ndarray,
                   weights: np.ndarray, variant: int = VARIANT_SSPM,
                   block: int = 1024, path: str = "auto"
                   ) -> DyadicShardedState:
    """Host-side convenience: feed a whole stream in fixed-size blocks
    (``dyadic.feed_blocks``)."""
    return feed_blocks(
        lambda st_, i, w: update_block(st_, i, w, variant, path=path),
        state, items, weights, block)


# ---------------------------------------------------------------------------
# Queries: owner-shard rank / quantile
# ---------------------------------------------------------------------------

def _owner_rank(index, state: DyadicShardedState,
                xs: torch.Tensor) -> torch.Tensor:
    """rank_many against a ``dyadic._layer_index`` of the flat bank: every
    (shard, level) row answers the level's nodes, and each node takes its
    owner row's answer."""
    S, bits, _ = state.bank.ids.shape
    y, nodes, take = _rank_terms(xs, bits)                  # (n, bits)
    n = nodes.shape[0]
    per_row = nodes.T[None].expand(S, bits, n).reshape(S * bits, n)
    est = _node_counts(index, per_row).reshape(S, bits, n)
    owner = shard_of(nodes, S).long()                       # (n, bits)
    est = est.permute(2, 1, 0).gather(2, owner[..., None])[..., 0]
    r = torch.where(take, est.clamp(min=0), 0).sum(dim=1, dtype=I32)
    # y >= 2^bits: the whole-universe node's frequency is the exact mass
    return torch.where(y >= (1 << bits), state.mass, r)


def rank_many(state: DyadicShardedState, xs: torch.Tensor) -> torch.Tensor:
    """Estimated rank(x) = |{v <= x}| per query, each node read from its
    owner (shard_of(node), level) row."""
    return _owner_rank(_layer_index(state.flat_bank), state, xs)


def rank(state: DyadicShardedState, x) -> int:
    xs = torch.tensor([int(x)], dtype=I32, device=state.mass.device)
    return int(rank_many(state, xs)[0])


def quantile_many(state: DyadicShardedState, qs: torch.Tensor
                  ) -> torch.Tensor:
    """Per-query quantiles by the shared lockstep search on owner-shard
    ranks."""
    index = _layer_index(state.flat_bank)
    return lockstep_quantile_search(
        lambda xs: _owner_rank(index, state, xs), state.mass, state.bits, qs)


def quantile(state: DyadicShardedState, q: float) -> int:
    qs = torch.tensor([q], dtype=torch.float32, device=state.mass.device)
    return int(quantile_many(state, qs)[0])


# ---------------------------------------------------------------------------
# Merge / checkpoint consolidation
# ---------------------------------------------------------------------------

def merge(a: DyadicShardedState, b: DyadicShardedState) -> DyadicShardedState:
    """Row-wise merge of two same-shape banks (same S, same hash); the
    masses add. Merged rows carry no BLOCKED slots."""
    merged = bk.merge_banks(a.flat_bank, b.flat_bank)
    return DyadicShardedState(
        bank=SketchState(*(t.reshape(a.bank.ids.shape) for t in merged)),
        mass=wrap_add(a.mass, b.mass))


def consolidate(state: DyadicShardedState) -> DyadicState:
    """The S shards of every level folded into ONE ``DyadicState`` by
    ``bank.consolidate``'s tree, the merge batched over the levels (the
    compact checkpoint view, with the merged-summary error bounds)."""
    return DyadicState(bank=bk.consolidate(state.bank), mass=state.mass)


def __getattr__(name):
    # the reference's client-specific spelling (repro/sketch/dyadic_sharded.py):
    # the same update_block under the old name, warning once
    if name == "ingest":
        from .api import deprecated_alias

        globals()["ingest"] = deprecated_alias(
            "repro_torch.sketch.dyadic_sharded.ingest",
            "repro_torch.sketch.api.update("
            "SketchSpec(kind='quantile', shards=S, ...), ...)",
            update_block)
        return globals()["ingest"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DyadicShardedState", "init", "layer_capacities",
           "space_counters", "update_block", "process_stream", "rank",
           "rank_many", "quantile", "quantile_many", "merge", "consolidate"]
