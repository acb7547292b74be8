"""Hash-sharded SpaceSaving± bank: S per-shard sketches, one launch/block.

Counterpart of ``repro/sketch/sharded.py`` on one device: shard s of
the stacked (S, k) bank monitors the ids with ``shard_of(id, S) == s``.
A block is ingested by one launch: by default (``path="auto"`` =
``"block"``) through the bank's partition core, one shared sort and one
grouping of the raw block for every shard; ``"kernel"`` and ``"vmap"``
route it first (the sorted block broadcast to every row, foreign weights
masked to 0). ``update_block_serial_reference`` updates the routed
shards one after another, the oracle. Queries read the owner shard, so
there is no merge error. ``merge`` pairs two banks shard by shard;
``consolidate`` folds the shards into one summary for checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.sketch_update.ops import sketch_block_update_fused
from ..platform import DEFAULT_DEVICE
from . import bank as bk
from . import state as st
from .bank import HashShardRouter, shard_of
from .blocks import block_update, block_update_batched
from .state import VARIANT_SSPM, SketchState


class ShardedSketch(NamedTuple):
    """Stacked per-shard states; shard s owns ids with shard_of(id) == s."""

    bank: SketchState  # each field (S, k) int32

    @property
    def num_shards(self) -> int:
        return self.bank.ids.shape[0]


def init(total_capacity: int, num_shards: int,
         device=DEFAULT_DEVICE) -> ShardedSketch:
    """Empty bank of ceil(total / S) counters per shard."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    k = -(-total_capacity // num_shards)
    return ShardedSketch(bank=bk.init(k, num_shards, device=device))


def route_block(items: torch.Tensor, weights: torch.Tensor, num_shards: int,
                universe_bits: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-sort hash routing: (B,) block -> (S, B) per-shard views."""
    return HashShardRouter(num_shards, universe_bits).route_dense(items, weights)


def update_block(state: ShardedSketch, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM, *,
                 universe_bits: Optional[int] = None,
                 path: str = "auto") -> ShardedSketch:
    """Route one block shard-by-hash and ingest it with one launch.

    ``path`` as in the reference (``sharded.py:235``), on one device:
    ``"auto"`` (with no mesh, ``"block"``) and ``"block"``, the bank's
    partition core; ``"kernel"``, the fused bank update on the routed
    views; ``"vmap"``, the masked-row ``blocks.block_update_batched`` over
    the S shard sketches (one batched phase-2 launch). All give the same
    bank, bit for bit. ``"shard_map"`` needs the mesh of ROADMAP.md
    Queue 1 item 19 and raises.
    """
    if path == "shard_map":
        raise NotImplementedError(
            "path='shard_map' is not ported to repro_torch yet; ROADMAP.md "
            "Queue 1 item 19 (parallel/sharding.py) ports it")
    if path in ("auto", "block"):
        router = HashShardRouter(state.num_shards, universe_bits)
        return ShardedSketch(bank=bk.update_block_fused(
            state.bank, items, weights, router, variant))
    if path not in ("kernel", "vmap"):
        raise ValueError(f"unknown path {path!r}; use 'auto', 'block', "
                         f"'kernel' or 'vmap'")
    items_b, w_routed = route_block(items, weights, state.num_shards,
                                    universe_bits)
    if path == "kernel":
        bank = sketch_block_update_fused(state.bank, items_b, w_routed,
                                         variant)
    else:
        bank = block_update_batched(state.bank, items_b, w_routed, variant,
                                    assume_sorted=True)
    return ShardedSketch(bank=bank)


def update_block_serial_reference(state: ShardedSketch, items: torch.Tensor,
                                  weights: torch.Tensor,
                                  variant: int = VARIANT_SSPM,
                                  universe_bits: Optional[int] = None
                                  ) -> ShardedSketch:
    """The oracle (reference ``sharded.py:295``): route, then update each
    shard with ``blocks.block_update`` on its own view, one shard after
    another (S launches of kernel 3 on the card)."""
    items_b, w_routed = route_block(items, weights, state.num_shards,
                                    universe_bits)
    outs = [block_update(SketchState(*(t[s] for t in state.bank)),
                         items_b[s], w_routed[s], variant, assume_sorted=True)
            for s in range(state.num_shards)]
    return ShardedSketch(bank=SketchState(*(torch.stack(f)
                                            for f in zip(*outs))))


def query_many(state: ShardedSketch, items: torch.Tensor) -> torch.Tensor:
    """Estimated frequency per query id, answered by its owner shard."""
    items = items.to(torch.int32)
    return bk.query_rows(state.bank, shard_of(items, state.num_shards), items)


def query(state: ShardedSketch, item) -> torch.Tensor:
    """Estimated frequency of one id, from its owner shard."""
    item = int(item)
    if not -2**31 <= item < 2**31:
        raise OverflowError(f"item id {item} is out of bounds for int32")
    ids = torch.tensor([item], dtype=torch.int32, device=state.bank.ids.device)
    return query_many(state, ids)[0]


def topk(state: ShardedSketch, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global top-m (ids, counts): flat top-k over all S·k slots."""
    return bk.topk_bank(state.bank, m)


def merge(a: ShardedSketch, b: ShardedSketch) -> ShardedSketch:
    """Shard-wise mergeable-summaries merge of two same-shape banks: both
    route with the same hash, so shard s of either only monitored ids
    owned by s and the merged bank keeps the ownership invariant."""
    return ShardedSketch(bank=bk.merge_banks(a.bank, b.bank))


def consolidate(state: ShardedSketch) -> SketchState:
    """All shards folded into one (k,) summary by ``bank.consolidate``'s
    tree: the compact global view for checkpoints, with the merged
    summary's error bounds (queries on the live bank have no merge
    error). S·k counters collapse to k."""
    return bk.consolidate(state.bank)


def to_dict(state: ShardedSketch) -> dict:
    """Union of the per-shard {item: (count, error)} (ids are disjoint)."""
    out = {}
    for s in range(state.num_shards):
        out.update(st.to_dict(SketchState(*(t[s] for t in state.bank))))
    return out


def __getattr__(name):
    # the reference's client-specific spelling (repro/sketch/sharded.py):
    # the same update_block under the old name, warning once
    if name == "ingest":
        from .api import deprecated_alias

        globals()["ingest"] = deprecated_alias(
            "repro_torch.sketch.sharded.ingest",
            "repro_torch.sketch.api.update("
            "SketchSpec(kind='frequency', shards=S, ...), ...)",
            update_block)
        return globals()["ingest"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ShardedSketch", "init", "shard_of", "route_block",
           "update_block", "update_block_serial_reference", "query_many", "query", "topk", "merge",
           "consolidate", "to_dict"]
