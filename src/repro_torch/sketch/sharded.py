"""Hash-sharded SpaceSaving± bank: S per-shard sketches, one launch/block.

Counterpart of ``repro/sketch/sharded.py``: shard s of the stacked
(S, k) bank monitors the ids with ``shard_of(id, S) == s``. On one
device a block is ingested by one launch: by default (``path="auto"``
with no mesh = ``"block"``) through the bank's partition core, one
shared sort and one grouping of the raw block for every shard;
``"kernel"`` and ``"vmap"`` route it first (the sorted block broadcast
to every row, foreign weights masked to 0).
``update_block_serial_reference`` updates the routed shards one after
another, the oracle. Queries read the owner shard, so there is no merge
error. ``merge`` pairs two banks shard by shard; ``consolidate`` folds
the shards into one summary for checkpoints.

On a mesh (``parallel.sharding.use_mesh``) the shard dim rides the mesh
axes the "shards" logical rule binds (the data axes): the bank's three
leaves are DTensors, ``Shard(0)`` over those mesh dimensions and
``Replicate()`` over the rest, and ``path="shard_map"`` (what
``"auto"`` takes for an axis of 2 or more) routes the replicated block
on every rank and updates the rank's own S/n rows with
``blocks.block_update_batched`` (kernel 3 on the card) on their
``to_local()`` tensors: the update moves no bytes across ranks. Kernels
never see a DTensor. The reads and the single-device paths gather a
mesh-sharded bank first (``gathered``), as the reference's GSPMD does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels.sketch_update.ops import sketch_block_update_fused
from ..parallel import sharding as psh
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

    @property
    def capacity(self) -> int:
        """Per-shard capacity k (total budget = num_shards * k)."""
        return self.bank.ids.shape[1]


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


def gathered(state: ShardedSketch) -> ShardedSketch:
    """``state`` with its bank whole on every rank: a mesh-sharded bank's
    leaves gathered (``parallel.sharding.full``), any other state as it
    is."""
    if not psh.is_dtensor(state.bank.ids):
        return state
    return ShardedSketch(bank=SketchState(*(psh.full(t) for t in state.bank)))


def _axis_sizes(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(psh.axis_names(mesh).index(a))
    return n


def _shard_mesh_axes(num_shards: int, min_size: int = 2):
    """Mesh axes for the bank's shard dim, or None for the single-device
    path.

    ``min_size``: the auto path only leaves the single-device path for an
    axis of 2 or more; an explicit path='shard_map' accepts size-1
    meshes.
    """
    mesh = psh.current_mesh()
    if mesh is None:
        return None
    axes = psh.mesh_axis("shards")
    if not axes:
        return None
    n = _axis_sizes(mesh, axes)
    if n < min_size or num_shards % n != 0:
        return None
    return axes


def _row_block(mesh, axes, rows: int) -> Tuple[int, int]:
    """This rank's [lo, hi) rows of a dim of ``rows`` split over ``axes``
    in mesh order (DTensor's order for ``Shard(0)`` on several mesh
    dimensions)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the active mesh")
    idx, n = 0, 1
    for d, name in enumerate(psh.axis_names(mesh)):
        if name in axes:
            idx = idx * mesh.size(d) + coord[d]
            n *= mesh.size(d)
    per = rows // n
    return idx * per, (idx + 1) * per


def _local_rows(t: torch.Tensor, mesh, place, lo: int, hi: int):
    """Rows [lo, hi) of a bank leaf: the local tensor of a DTensor already
    laid out as ``place`` on ``mesh``, else a slice of the whole leaf."""
    if psh.is_dtensor(t):
        if t.device_mesh == mesh and tuple(t.placements) == place:
            return t.to_local()
        t = psh.full(t)
    return t[lo:hi]


def _mesh_local(state_bank: SketchState, axes):
    """(mesh, placements, lo, hi, local bank) of a bank whose dim 0 the
    shard_map path splits over ``axes``."""
    mesh = psh.current_mesh()
    place = psh.placements(psh.PartitionSpec(axes), mesh)
    lo, hi = _row_block(mesh, axes, state_bank.ids.shape[0])
    local = SketchState(*(_local_rows(t, mesh, place, lo, hi)
                          for t in state_bank))
    return mesh, place, lo, hi, local


def _on_mesh(local: SketchState, mesh, place) -> SketchState:
    """The rank's local rows back as the DTensor bank (no communication)."""
    from torch.distributed.tensor import DTensor

    return SketchState(*(DTensor.from_local(t, mesh, place, run_check=False)
                         for t in local))


def _update_block_shard_map(state: ShardedSketch, items: torch.Tensor,
                            weights: torch.Tensor, variant: int,
                            universe_bits: Optional[int],
                            axes) -> ShardedSketch:
    """shard_map ingest: each mesh slice updates its own S/n shard rows.

    Routing happens replicated (O(B log B) vector work on the raw block,
    every rank the whole block); each rank takes its rows of the routed
    views and runs ``block_update_batched`` on its local bank, so the
    update moves no bytes across ranks. A whole (not mesh-sharded) state
    is split on the way in.
    """
    S = state.num_shards
    mesh, place, lo, hi, local = _mesh_local(state.bank, axes)
    items_b, w_routed = route_block(items, weights, S, universe_bits)
    out = block_update_batched(local, items_b[lo:hi], w_routed[lo:hi],
                               variant, assume_sorted=True)
    return ShardedSketch(bank=_on_mesh(out, mesh, place))


def update_block(state: ShardedSketch, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM, *,
                 universe_bits: Optional[int] = None,
                 path: str = "auto") -> ShardedSketch:
    """Route one block shard-by-hash and ingest it with one launch.

    ``path`` as in the reference (``sharded.py:235``): ``"auto"``, the
    ``"shard_map"`` path when a mesh is active whose "shards" axes have
    size 2 or more and divide S, else ``"block"``; ``"block"``, the
    bank's partition core; ``"kernel"``, the fused bank update on the
    routed views; ``"vmap"``, the masked-row ``blocks.
    block_update_batched`` over the S shard sketches (one batched phase-2
    launch); ``"shard_map"``, the mesh path (a size-1 mesh too). All
    give the same bank, bit for bit; the mesh path's is mesh-sharded.
    """
    if path == "auto":
        axes = _shard_mesh_axes(state.num_shards)
        path = "shard_map" if axes else "block"
    elif path == "shard_map":
        axes = _shard_mesh_axes(state.num_shards, min_size=1)
        if not axes:
            mesh = psh.current_mesh()
            bound = psh.mesh_axis("shards") if mesh is not None else None
            if mesh is None or not bound:
                raise ValueError(
                    "path='shard_map' needs an active mesh with a 'shards' "
                    "logical rule (repro_torch.parallel.sharding.use_mesh)")
            raise ValueError(
                f"path='shard_map' needs num_shards divisible by the "
                f"'shards' mesh axes {bound} (total size "
                f"{_axis_sizes(mesh, bound)}); got num_shards="
                f"{state.num_shards}")
    if path == "shard_map":
        return _update_block_shard_map(state, items, weights, variant,
                                       universe_bits, axes)
    if path not in ("block", "kernel", "vmap"):
        raise ValueError(f"unknown path {path!r}; use 'auto', 'block', "
                         f"'kernel', 'vmap' or 'shard_map'")
    state = gathered(state)
    if path == "block":
        router = HashShardRouter(state.num_shards, universe_bits)
        return ShardedSketch(bank=bk.update_block_fused(
            state.bank, items, weights, router, variant))
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
    state = gathered(state)
    items_b, w_routed = route_block(items, weights, state.num_shards,
                                    universe_bits)
    outs = [block_update(SketchState(*(t[s] for t in state.bank)),
                         items_b[s], w_routed[s], variant, assume_sorted=True)
            for s in range(state.num_shards)]
    return ShardedSketch(bank=SketchState(*(torch.stack(f)
                                            for f in zip(*outs))))


def query_many(state: ShardedSketch, items: torch.Tensor) -> torch.Tensor:
    """Estimated frequency per query id, answered by its owner shard."""
    state = gathered(state)
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
    return bk.topk_bank(gathered(state).bank, m)


def merge(a: ShardedSketch, b: ShardedSketch) -> ShardedSketch:
    """Shard-wise mergeable-summaries merge of two same-shape banks: both
    route with the same hash, so shard s of either only monitored ids
    owned by s and the merged bank keeps the ownership invariant."""
    return ShardedSketch(bank=bk.merge_banks(gathered(a).bank,
                                             gathered(b).bank))


def consolidate(state: ShardedSketch) -> SketchState:
    """All shards folded into one (k,) summary by ``bank.consolidate``'s
    tree: the compact global view for checkpoints, with the merged
    summary's error bounds (queries on the live bank have no merge
    error). S·k counters collapse to k."""
    return bk.consolidate(gathered(state).bank)


def to_dict(state: ShardedSketch) -> dict:
    """Union of the per-shard {item: (count, error)} (ids are disjoint)."""
    state = gathered(state)
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
           "update_block", "update_block_serial_reference", "gathered",
           "query_many", "query", "topk", "merge", "consolidate", "to_dict"]
