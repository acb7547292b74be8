"""Dyadic SpaceSaving±: the quantile sketch on one stacked bank.

Counterpart of ``repro/sketch/dyadic.py`` (the paper's Algs 5-6):
``bits`` SpaceSaving± sketches, one per dyadic layer, layer l monitoring
the frequencies of ``x >> l``, held as ONE (bits, k) bank whose layers
have the per-layer capacities of ``core.quantiles.dyadic_layer_capacities``
(a layer with fewer than k counters fills its tail with BLOCKED slots).
A block is routed with one shared sort (``bank.DyadicLevelRouter``: the
sorted block right-shifted per layer, a (1, B) weight row) and ingested
by one of four paths, each giving the same bank, bit for bit:

- ``"kernel"``: ``ops.sketch_block_update_fused`` (kernel 1 on the card);
- ``"bank"``: ``bank.update_rows``, the dense core, whose residual loop
  is kernel 2 on the card;
- ``"block"``: ``blocks.block_update_batched`` over the layers as E
  stacked sketches, whose phase 2 is kernel 3 on the card;
- ``"serial"``: ``blocks.block_update_serial`` layer by layer, the A/B
  baseline (kernel 4 on the card, one launch per layer).

|F|₁ is tracked exactly as an int32 scalar that wraps as the
reference's int32 sum does.

``rank(x)`` sums at most ``bits`` node frequencies: layer l contributes
node 2·(y >> (l+1)) iff bit l of y = x + 1 is set. The reference reads
them with a (bits, n, k) comparison; here each layer's ids are sorted
once and every node's slots are found by binary search, with the same
sum over matching live slots (``_LayerIndex``). ``quantile_many`` is the
reference's lockstep binary search with its float32 rank target.

Items must lie in [0, 2^bits); weight > 0 inserts, < 0 deletes, 0 pads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.quantiles import dyadic_layer_capacities
from ..kernels.sketch_update.ops import sketch_block_update_fused
from ..platform import DEFAULT_DEVICE, resolve_device
from . import bank as bk
from .blocks import block_update_batched, block_update_serial
from .state import I32, VARIANT_SSPM, SketchState, merge as state_merge, \
    wrap_add


class DyadicState(NamedTuple):
    """Stacked dyadic bank and the exactly tracked total mass."""

    bank: SketchState     # each field (bits, k) int32
    mass: torch.Tensor    # () int32, |F|_1 = I - D

    @property
    def bits(self) -> int:
        return self.bank.ids.shape[0]

    @property
    def capacity(self) -> int:
        return self.bank.ids.shape[1]


def init(bits: int, total_counters: Optional[int] = None, *,
         eps: Optional[float] = None, alpha: float = 2.0,
         device=DEFAULT_DEVICE) -> DyadicState:
    """Empty bank sized by ``eps`` (+ ``alpha``, paper §4.2) or by
    ``total_counters`` split over the layers."""
    caps = dyadic_layer_capacities(bits, total_counters=total_counters,
                                   eps=eps, alpha=alpha)
    dev = resolve_device(device)
    return DyadicState(bank=bk.init(caps, device=dev),
                       mass=torch.zeros((), dtype=I32, device=dev))


def layer_capacities(state: DyadicState) -> list:
    """Live (non-BLOCKED) counters per layer."""
    return bk.row_capacities(state.bank)


def space_counters(state: DyadicState) -> int:
    """Total live counters over the layers."""
    return sum(layer_capacities(state))


# ---------------------------------------------------------------------------
# Update: one shared sort, one bank update
# ---------------------------------------------------------------------------

def layer_items(items: torch.Tensor, bits: int) -> torch.Tensor:
    """(B,) items -> (bits, B) per-layer node ids (one broadcast shift)."""
    shifts = torch.arange(bits, dtype=I32, device=items.device)[:, None]
    return items.to(I32)[None, :] >> shifts


def _add_mass(mass: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``mass + weights.sum()`` in wrapping int32, as the reference's."""
    return wrap_add(mass, weights.sum(dtype=I32))


def update_block(state: DyadicState, items: torch.Tensor,
                 weights: torch.Tensor, variant: int = VARIANT_SSPM,
                 path: str = "bank") -> DyadicState:
    """Apply a block of signed weighted updates to every layer at once.

    ``path``: ``"kernel"`` (the fused bank update), ``"bank"`` (the dense
    core), ``"block"`` (the layers as stacked sketches) or ``"serial"``
    (``blocks.block_update_serial`` layer by layer: on the card one
    kernel-4 launch per layer, the A/B baseline); the same bank from
    each, bit for bit.
    """
    items = items.to(I32)
    weights = weights.to(I32)
    items_l, weights_l = bk.DyadicLevelRouter(state.bits).route_dense(
        items, weights)
    if path == "kernel":
        bank = sketch_block_update_fused(state.bank, items_l, weights_l,
                                         variant)
    elif path == "bank":
        bank = bk.update_rows(state.bank, items_l, weights_l, variant)
    elif path == "block":
        # the stacked-sketch path takes one weight row per sketch
        bank = block_update_batched(state.bank, items_l,
                                    weights_l.expand(items_l.shape), variant,
                                    assume_sorted=True)
    elif path == "serial":
        layers = [block_update_serial(SketchState(*(t[l] for t in state.bank)),
                                      items_l[l], weights_l[0], variant)
                  for l in range(state.bits)]
        bank = SketchState(*(torch.stack(f) for f in zip(*layers)))
    else:
        raise ValueError(f"unknown path {path!r}")
    return DyadicState(bank=bank, mass=_add_mass(state.mass, weights))


def feed_blocks(update_fn, state, items: np.ndarray, weights: np.ndarray,
                block: int):
    """Pad-and-chunk host driver shared by both dyadic banks: the last
    block is zero-weight padded so every call sees one (bits, block)
    shape; each block goes to the state's device."""
    items = np.asarray(items, np.int32)
    weights = np.asarray(weights, np.int32)
    n = len(items)
    nb = max(1, -(-n // block))
    pi = np.zeros(nb * block, np.int32)
    pw = np.zeros(nb * block, np.int32)
    pi[:n] = items
    pw[:n] = weights
    dev = state.bank.ids.device
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        state = update_fn(state, torch.as_tensor(pi[sl], device=dev),
                          torch.as_tensor(pw[sl], device=dev))
    return state


def process_stream(state: DyadicState, items: np.ndarray,
                   weights: np.ndarray, variant: int = VARIANT_SSPM,
                   block: int = 1024, path: str = "bank") -> DyadicState:
    """Host-side convenience: feed a whole stream in fixed-size blocks."""
    return feed_blocks(
        lambda st, i, w: update_block(st, i, w, variant, path),
        state, items, weights, block)


# ---------------------------------------------------------------------------
# Queries: batched rank / quantile over the dyadic decomposition
# ---------------------------------------------------------------------------

class _LayerIndex(NamedTuple):
    """Each row's ids sorted, with the prefix sums of the live slots'
    counts in that order: the sum over a node's matching slots is one
    difference of two prefix sums."""

    ids: torch.Tensor    # (R, k) int32, ascending per row
    csum: torch.Tensor   # (R, k + 1) int64, exact


def _layer_index(bank: SketchState) -> _LayerIndex:
    ids, order = torch.sort(bank.ids, dim=1, stable=True)
    counts = torch.where(ids >= 0, bank.counts.gather(1, order), 0)
    csum = torch.cumsum(counts.to(torch.int64), dim=1)
    return _LayerIndex(ids, torch.cat([csum.new_zeros(csum.shape[0], 1),
                                       csum], dim=1))


def _node_counts(index: _LayerIndex, nodes: torch.Tensor) -> torch.Tensor:
    """(R, n) nodes -> row r's estimate of each of its nodes: the int32
    sum of the counts of row r's live slots holding the node (0 where
    none does), which is the reference's masked ``query_many`` sum."""
    nodes = nodes.contiguous()
    lo = torch.searchsorted(index.ids, nodes)
    hi = torch.searchsorted(index.ids, nodes, right=True)
    s = index.csum.gather(1, hi) - index.csum.gather(1, lo)
    # fold the exact sum into int32, as the reference's int32 sum wraps
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(I32)


def _rank_terms(xs: torch.Tensor, bits: int):
    """For queries x: y = x + 1 (wrapping int32), each layer's node
    2·(y >> (l+1)) and whether it is taken (bit l of y), both (n, bits)."""
    y = wrap_add(xs.to(I32), 1)
    lvl = torch.arange(bits, dtype=I32, device=xs.device)[None, :]
    nodes = 2 * (y[:, None] >> (lvl + 1))
    take = ((y[:, None] >> lvl) & 1) > 0
    return y, nodes, take


def _rank_from(index: _LayerIndex, mass: torch.Tensor, bits: int,
               xs: torch.Tensor) -> torch.Tensor:
    y, nodes, take = _rank_terms(xs, bits)
    est = _node_counts(index, nodes.T).T                    # (n, bits)
    r = torch.where(take, est.clamp(min=0), 0).sum(dim=1, dtype=I32)
    # y >= 2^bits: the one level-`bits` node is the whole universe, whose
    # frequency is the exactly tracked |F|_1
    return torch.where(y >= (1 << bits), mass, r)


def rank_many(state: DyadicState, xs: torch.Tensor) -> torch.Tensor:
    """Estimated rank(x) = |{v <= x}| per query point, int32. Negative
    layer estimates count as 0, as in the reference."""
    return _rank_from(_layer_index(state.bank), state.mass, state.bits, xs)


def rank(state: DyadicState, x) -> int:
    xs = torch.tensor([int(x)], dtype=I32, device=state.mass.device)
    return int(rank_many(state, xs)[0])


def lockstep_quantile_search(rank_fn, mass: torch.Tensor, bits: int,
                             qs: torch.Tensor) -> torch.Tensor:
    """Smallest x with rank(x) >= q·|F|₁ per query: a lockstep binary
    search over the universe, bits + 1 rounds, converged queries frozen.
    The rank target is float32, as in the reference (x64 off there): for
    |F|₁ past 2^24 it can round by a few ranks, and the port rounds the
    same way."""
    target = qs.to(torch.float32) * mass.to(torch.float32)
    lo = torch.zeros(qs.shape, dtype=I32, device=qs.device)
    hi = torch.full(qs.shape, (1 << bits) - 1, dtype=I32, device=qs.device)
    for _ in range(bits + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        pred = rank_fn(mid).to(torch.float32) >= target
        lo = torch.where(active & ~pred, mid + 1, lo)
        hi = torch.where(active & pred, mid, hi)
    return lo


def quantile_many(state: DyadicState, qs: torch.Tensor) -> torch.Tensor:
    """Per-query quantiles (``lockstep_quantile_search``), the layers
    indexed once for all rounds."""
    index = _layer_index(state.bank)
    return lockstep_quantile_search(
        lambda xs: _rank_from(index, state.mass, state.bits, xs),
        state.mass, state.bits, qs)


def quantile(state: DyadicState, q: float) -> int:
    qs = torch.tensor([q], dtype=torch.float32, device=state.mass.device)
    return int(quantile_many(state, qs)[0])


# ---------------------------------------------------------------------------
# Merge: layer-wise mergeable-summaries reduction
# ---------------------------------------------------------------------------

def merge(a: DyadicState, b: DyadicState) -> DyadicState:
    """Layer-wise merge of two same-shape banks (``state.merge`` batched
    over the layers, BLOCKED-aware; merged rows hold up to k counters);
    the masses add."""
    return DyadicState(bank=state_merge(a.bank, b.bank),
                       mass=wrap_add(a.mass, b.mass))


def __getattr__(name):
    # the reference's client-specific spelling (repro/sketch/dyadic.py):
    # the same update_block under the old name, warning once
    if name == "ingest":
        from .api import deprecated_alias

        globals()["ingest"] = deprecated_alias(
            "repro_torch.sketch.dyadic.ingest",
            "repro_torch.sketch.api.update("
            "SketchSpec(kind='quantile', ...), ...)",
            update_block)
        return globals()["ingest"]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DyadicState", "init", "layer_capacities", "space_counters",
           "layer_items", "update_block", "feed_blocks", "process_stream",
           "rank_many", "rank", "lockstep_quantile_search", "quantile_many",
           "quantile", "merge"]
