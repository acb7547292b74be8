"""Deterministic fault injection for the sharded SpaceSaving± banks.

Counterpart of ``repro/sketch/faults.py``. A :class:`FaultPlan` says,
seeded and deterministic, which shard suffers which fault at which
ingest block; :class:`StreamSession` (``fault_plan=``) applies it on the
block boundary, so every chaos run reproduces from its seed:

- ``drop``: shard s's slice of the block is lost (its weights zeroed);
- ``duplicate``: shard s's slice is ingested twice;
- ``corrupt``: shard s's rows are sentinel-poisoned after the ingest
  (ids POISON, counts and errors -1), which ``elastic.scan_rows``
  detects;
- ``delay``: shard s's slice lands ``delay_steps`` blocks late, and the
  shard's host reports ``delay_s`` more to an attached straggler monitor.

``FaultPlan.random`` draws with numpy's ``default_rng(seed)`` in the
reference's order, so one seed gives one plan in both packages. Shard
ownership is ``bank.shard_of`` on host tensors, the owners every router
and query uses. The session's replay log records the intended block
before injection: faults corrupt the live state, never the recovery
truth.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bank as bk
from .state import POISON, SketchState

KINDS = ("drop", "duplicate", "corrupt", "delay")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault: ``kind`` hits shard ``row`` at ingest block ``step``."""

    step: int
    row: int
    kind: str
    delay_steps: int = 1      # 'delay': blocks until the slice lands
    delay_s: float = 0.0      # 'delay': added to the shard's block time

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"FaultEvent.kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == "delay" and self.delay_steps < 1:
            raise ValueError(
                f"delay_steps must be >= 1, got {self.delay_steps}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`; ``events_at(step)``
    is what the session reads each block."""

    events: Tuple[FaultEvent, ...] = ()

    @classmethod
    def random(cls, seed: int, n_steps: int, rows: int, n_faults: int = 4,
               kinds: Sequence[str] = KINDS) -> "FaultPlan":
        """Seeded plan over steps 1..n_steps (block sequence numbers start
        at 1), drawn as the reference draws it."""
        rng = np.random.default_rng(seed)
        evs = []
        for _ in range(n_faults):
            evs.append(FaultEvent(
                step=int(rng.integers(1, max(n_steps, 1) + 1)),
                row=int(rng.integers(0, max(rows, 1))),
                kind=str(rng.choice(list(kinds))),
                delay_steps=int(rng.integers(1, 4)),
                delay_s=float(rng.uniform(1.0, 5.0)),
            ))
        return cls(events=tuple(sorted(evs, key=lambda e: e.step)))

    def events_at(self, step: int) -> List[FaultEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def max_step(self) -> int:
        return max((e.step for e in self.events), default=-1)


@dataclasses.dataclass
class FaultOutcome:
    """One block after injection: ``blocks`` to ingest now, in order (the
    faulted block first, then duplicates); ``deferred`` (due step, items,
    weights) slices for later blocks; ``poison_rows`` to poison after the
    ingest; ``delay_s`` per row for the straggler monitor."""

    blocks: List[Tuple[np.ndarray, np.ndarray]]
    deferred: List[Tuple[int, np.ndarray, np.ndarray]]
    poison_rows: List[int]
    delay_s: Dict[int, float]


def _owners(items: np.ndarray, num_shards: int) -> np.ndarray:
    """``bank.shard_of`` of host ids (int32, as the reference casts them)."""
    ids = torch.from_numpy(np.asarray(items).astype(np.int32))
    return bk.shard_of(ids, num_shards).numpy()


def shard_slice(items: np.ndarray, weights: np.ndarray, row: int,
                num_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """(items, weights) with every weight not owned by ``row`` zeroed."""
    w = np.where(_owners(items, num_shards) == row, weights, 0)
    return items, w.astype(weights.dtype)


def drop_shard(items: np.ndarray, weights: np.ndarray, row: int,
               num_shards: int) -> np.ndarray:
    """Weights with shard ``row``'s slice removed (its block was lost)."""
    w = np.where(_owners(items, num_shards) == row, 0, weights)
    return w.astype(weights.dtype)


def inject(plan: Optional[FaultPlan], step: int, num_shards: int,
           items: np.ndarray, weights: np.ndarray) -> FaultOutcome:
    """Apply every fault scheduled for ``step`` to one block. With no plan
    (or no event at this step) the block passes through; events of a row
    past the shard count are no-ops (a plan survives a shrink)."""
    items = np.asarray(items)
    weights = np.asarray(weights)
    out = FaultOutcome(blocks=[], deferred=[], poison_rows=[], delay_s={})
    events = plan.events_at(step) if plan is not None else []
    w = weights
    extra: List[Tuple[np.ndarray, np.ndarray]] = []
    for ev in events:
        if ev.row >= num_shards:
            continue
        if ev.kind == "drop":
            w = drop_shard(items, w, ev.row, num_shards)
        elif ev.kind == "duplicate":
            extra.append(shard_slice(items, weights, ev.row, num_shards))
        elif ev.kind == "delay":
            si, sw = shard_slice(items, weights, ev.row, num_shards)
            w = drop_shard(items, w, ev.row, num_shards)
            out.deferred.append((step + ev.delay_steps, si, sw))
            out.delay_s[ev.row] = max(out.delay_s.get(ev.row, 0.0),
                                      ev.delay_s)
        elif ev.kind == "corrupt":
            out.poison_rows.append(ev.row)
    out.blocks = [(items, w)] + extra
    return out


def _poison(bank: SketchState, rows: Sequence[int]) -> SketchState:
    """A copy of the bank with ``rows`` (of the leading axis) poisoned."""
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=bank.ids.device)
    ids, counts, errors = (t.clone() for t in bank)
    ids[idx] = POISON
    counts[idx] = -1
    errors[idx] = -1
    return SketchState(ids, counts, errors)


def poison_rows(state, rows: Sequence[int]):
    """Sentinel-poison shard ``rows`` of a sharded state, as a torn write
    or a dead host would leave them: ids POISON, counts and errors -1.
    Works on ``ShardedSketch`` ((S, k)) and ``DyadicShardedState``
    ((S, bits, k): the whole shard, every level). A new state; the given
    one is not written."""
    return state._replace(bank=_poison(state.bank, rows))


def faulty_update_block_fused(plan: Optional[FaultPlan], step: int,
                              bank: SketchState, items, weights, router,
                              variant: int = 2):
    """``bank.update_block_fused`` with the plan's step-``step`` events:
    the same updates the healthy path runs on the faulted blocks, rows
    poisoned after. Returns ``(bank, deferred)``: the caller ingests the
    deferred slices at their due step."""
    out = inject(plan, step, router.num_rows,
                 np.asarray(_host(items)), np.asarray(_host(weights)))
    dev = bank.ids.device
    for bi, bw in out.blocks:
        bank = bk.update_block_fused(
            bank, torch.as_tensor(np.asarray(bi, np.int32), device=dev),
            torch.as_tensor(np.asarray(bw, np.int32), device=dev), router,
            variant)
    if out.poison_rows:
        bank = _poison(bank, out.poison_rows)
    return bank, out.deferred


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


__all__ = ["KINDS", "FaultEvent", "FaultPlan", "FaultOutcome",
           "shard_slice", "drop_shard", "inject", "poison_rows",
           "faulty_update_block_fused"]
