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

On a mesh whose "shards" axes divide S, ``path="shard_map"`` (what
``"auto"`` takes for an axis of 2 or more) routes the levels replicated
and each rank updates its own shards' rows, ``bank.update_rows`` on the
``to_local()`` (S/n · bits, k) bank (kernel 2 on the card): the bank is
a DTensor, ``Shard(0)`` over those axes, and ``mass`` stays a plain
tensor, the same on every rank. The reads gather first (``gathered``).

Items must lie in [0, 2^bits); weight > 0 inserts, < 0 deletes, 0 pads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.quantiles import dyadic_layer_capacities
from ..platform import DEFAULT_DEVICE, resolve_device
from ..parallel import sharding as psh
from . import bank as bk
from .bank import DyadicLevelRouter, ShardLevelRouter, shard_of
from .dyadic import (DyadicState, _add_mass, _layer_index, _node_counts,
                     _rank_terms, feed_blocks, lockstep_quantile_search)
from .sharded import _mesh_local, _on_mesh, _shard_mesh_axes
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


def gathered(state: DyadicShardedState) -> DyadicShardedState:
    """``state`` with its bank whole on every rank (a mesh-sharded bank's
    leaves gathered), any other state as it is."""
    if not psh.is_dtensor(state.bank.ids):
        return state
    return DyadicShardedState(
        bank=SketchState(*(psh.full(t) for t in state.bank)), mass=state.mass)


def layer_capacities(state: DyadicShardedState) -> list:
    """Per-shard live counters per layer (the same on every shard)."""
    return bk.row_capacities(
        SketchState(*(t[0] for t in gathered(state).bank)))


def space_counters(state: DyadicShardedState) -> int:
    """Total live counters over all shards and layers."""
    return state.num_shards * sum(layer_capacities(state))


# ---------------------------------------------------------------------------
# Update: one composed-router bank update, or shard_map over the mesh
# ---------------------------------------------------------------------------

def _update_block_shard_map(state: DyadicShardedState, items: torch.Tensor,
                            weights: torch.Tensor, variant: int,
                            axes) -> DyadicShardedState:
    """shard_map ingest: each mesh slice updates its own shards' rows.

    Level routing (the one shared sort and shift broadcast) happens
    replicated; the per-shard weight masks are (S, bits, B), of which
    each rank takes its shards' rows, so the update moves no bytes
    across ranks: each rank runs the dense core on its local
    (S_loc * bits, k) rows.
    """
    S, bits, k = state.bank.ids.shape
    B = items.shape[0]
    mesh, place, lo, hi, local = _mesh_local(state.bank, axes)
    nodes, w_l = DyadicLevelRouter(bits).route_dense(items, weights)
    w_routed = ShardLevelRouter(bits, S).mask_shards(nodes, w_l)
    s_loc = hi - lo
    row_items = nodes[None].expand(s_loc, bits, B).reshape(s_loc * bits, B)
    flat = SketchState(*(t.reshape(s_loc * bits, k) for t in local))
    out = bk.update_rows(flat, row_items,
                         w_routed[lo:hi].reshape(s_loc * bits, B), variant)
    return DyadicShardedState(
        bank=_on_mesh(SketchState(*(t.reshape(s_loc, bits, k) for t in out)),
                      mesh, place),
        mass=_add_mass(state.mass, weights))


def update_block(state: DyadicShardedState, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM, *,
                 path: str = "auto") -> DyadicShardedState:
    """Apply one block of signed weighted updates to the whole bank.

    ``path``: ``"auto"``, the ``"shard_map"`` path when a mesh is active
    whose "shards" axes have size 2 or more and divide S, else
    ``"bank"``; ``"bank"``, the composed router on the (S * bits, k)
    bank, one fused update; ``"shard_map"``, the mesh path (a size-1 mesh
    too). All give the same bank, bit for bit.
    """
    items = items.to(I32)
    weights = weights.to(I32)
    if path == "auto":
        axes = _shard_mesh_axes(state.num_shards)
        path = "shard_map" if axes else "bank"
    elif path == "shard_map":
        axes = _shard_mesh_axes(state.num_shards, min_size=1)
        if not axes:
            raise ValueError(
                "path='shard_map' needs an active mesh whose 'shards' "
                "logical axes divide num_shards "
                "(repro_torch.parallel.sharding.use_mesh)")
    if path == "shard_map":
        return _update_block_shard_map(state, items, weights, variant, axes)
    if path != "bank":
        raise ValueError(f"unknown path {path!r}")
    state = gathered(state)
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
    state = gathered(state)
    return _owner_rank(_layer_index(state.flat_bank), state, xs)


def rank(state: DyadicShardedState, x) -> int:
    xs = torch.tensor([int(x)], dtype=I32, device=state.mass.device)
    return int(rank_many(state, xs)[0])


def quantile_many(state: DyadicShardedState, qs: torch.Tensor
                  ) -> torch.Tensor:
    """Per-query quantiles by the shared lockstep search on owner-shard
    ranks."""
    state = gathered(state)
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
    a, b = gathered(a), gathered(b)
    merged = bk.merge_banks(a.flat_bank, b.flat_bank)
    return DyadicShardedState(
        bank=SketchState(*(t.reshape(a.bank.ids.shape) for t in merged)),
        mass=wrap_add(a.mass, b.mass))


def consolidate(state: DyadicShardedState) -> DyadicState:
    """The S shards of every level folded into ONE ``DyadicState`` by
    ``bank.consolidate``'s tree, the merge batched over the levels (the
    compact checkpoint view, with the merged-summary error bounds)."""
    state = gathered(state)
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


__all__ = ["DyadicShardedState", "init", "gathered", "layer_capacities",
           "space_counters", "update_block", "process_stream", "rank",
           "rank_many", "quantile", "quantile_many", "merge", "consolidate"]
