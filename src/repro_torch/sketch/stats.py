"""Token statistics and MoE expert-load tracking over sliding windows.

Counterpart of ``repro/sketch/stats.py``. Each tracker owns one
:class:`~repro_torch.sketch.session.StreamSession` of a frequency
``SketchSpec`` and pushes one aggregated batch a step; a batch expires
after ``window`` further pushes (re-ingested with negated weights), so
at most 1/window of the live mass is deleted a step: the alpha <= 2
bounded-deletion regime Thm 4 sizes the capacity for. ``shards=S``
puts a tracker on the hash-partitioned bank at the same total budget.
``state_dict``/``load_state_dict`` speak the reference's layouts (the
tagged sketch dict plus ``insertions``, ``deletions`` and the FIFO as
``fifo_u``/``fifo_c``), so a tracker saved by either package loads in
the other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..platform import DEFAULT_DEVICE
from . import api
from . import state as st
from .session import StreamSession


def _aggregate_np(tokens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    uids, counts = np.unique(np.asarray(tokens).ravel(), return_counts=True)
    return uids.astype(np.int32), counts.astype(np.int32)


def _variant_name(variant: int) -> str:
    return "lazy" if variant == st.VARIANT_LAZY else "sspm"


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


@dataclasses.dataclass
class StatsReport:
    items: np.ndarray
    counts: np.ndarray
    insertions: int
    deletions: int

    @property
    def alpha_bound(self) -> float:
        """Empirical alpha: I/(I-D) (paper Table 2)."""
        live = max(self.insertions - self.deletions, 1)
        return self.insertions / live


class _WindowedTracker:
    """The session plumbing TokenStats and ExpertLoadStats share: one
    windowed StreamSession and the reference's attribute surface
    (settable ``state``, ``insertions``, ``deletions``)."""

    def __init__(self, capacity: int, window: int, variant: int, block: int,
                 shards: Optional[int], universe_bits: Optional[int],
                 device):
        self.capacity = capacity
        self.window = window
        self.variant = variant
        self.block = block
        spec = api.SketchSpec(
            kind="frequency", k=capacity, variant=_variant_name(variant),
            shards=shards or None, bits=universe_bits, backend="bank")
        # donate=False: the trackers expose .state, which a caller may
        # keep across later updates
        self.bank = StreamSession(spec, block=block, window=window,
                                  donate=False, device=device)

    @property
    def shards(self) -> Optional[int]:
        return self.bank.spec.shards

    @property
    def state(self):
        """The (k,) SketchState (single-sketch trackers only)."""
        return None if self.bank.spec.shards else self.bank.state

    @state.setter
    def state(self, value) -> None:
        if self.bank.spec.shards:
            raise ValueError(
                f"{type(self).__name__}(shards=S) has no single (k,) state "
                f"to assign; restore via load_state_dict (bank layout: "
                f"(S, k) arrays + 'shards')")
        self.bank.state = value

    @property
    def insertions(self) -> int:
        return self.bank.insertions

    @insertions.setter
    def insertions(self, value: int) -> None:
        self.bank.insertions = int(value)

    @property
    def deletions(self) -> int:
        return self.bank.deletions

    @deletions.setter
    def deletions(self, value: int) -> None:
        self.bank.deletions = int(value)

    def query(self, items) -> np.ndarray:
        return _host(self.bank.query_many(np.asarray(items, np.int32)))

    def merge_from(self, other) -> None:
        """Cross-host reduction (mergeable summaries; shard-wise when
        sharded)."""
        # the reference tracker's own messages for these two cases
        if bool(self.shards) != bool(other.shards):
            raise ValueError("cannot merge sharded and unsharded trackers")
        if self.shards and self.shards != other.shards:
            raise ValueError(
                f"shard count mismatch: {self.shards} != {other.shards}")
        self.bank.merge_from(other.bank)

    def state_dict(self) -> dict:
        d = self.bank.save()
        d.update(
            insertions=self.bank.insertions,
            deletions=self.bank.deletions,
            fifo_u=[u for u, _ in self.bank.batch_fifo],
            fifo_c=[c for _, c in self.bank.batch_fifo],
        )
        return d

    def load_state_dict(self, d: dict) -> None:
        # the scheduling keys are required: a bare api.save() dict lacks
        # them, and zeroing the window accounting would corrupt reports
        self.bank.load(d)
        self.bank.insertions = int(d["insertions"])
        self.bank.deletions = int(d["deletions"])
        fifo = self.bank.batch_fifo
        fifo.clear()
        fifo.extend((np.asarray(u), np.asarray(c))
                    for u, c in zip(d["fifo_u"], d["fifo_c"]))


class TokenStats(_WindowedTracker):
    """SS± heavy-token tracking over a sliding window of batches."""

    def __init__(self, capacity: int = 4096, window: int = 64,
                 variant: int = st.VARIANT_SSPM, block: int = 8192,
                 shards: Optional[int] = None,
                 universe_bits: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(capacity, window, variant, block, shards,
                         universe_bits, device)

    def update(self, tokens) -> None:
        uids, counts = _aggregate_np(np.asarray(tokens))
        self.bank.push(uids, counts)

    def topk(self, m: int = 16) -> StatsReport:
        ids, counts = self.bank.topk(min(m, self.capacity))
        return StatsReport(items=_host(ids), counts=_host(counts),
                           insertions=self.insertions,
                           deletions=self.deletions)


class ExpertLoadStats(_WindowedTracker):
    """SS± over the expert-id stream of a MoE model: each step's (E,)
    routed-token counts go in as weighted insertions, and a window of
    steps expires through bounded deletions."""

    def __init__(self, num_experts: int, capacity: Optional[int] = None,
                 window: int = 128, variant: int = st.VARIANT_SSPM,
                 shards: Optional[int] = None, device=DEFAULT_DEVICE):
        self.E = num_experts
        super().__init__(
            capacity or max(8, num_experts // 2), window, variant,
            block=max(num_experts, 2), shards=shards,
            universe_bits=max(int(num_experts - 1).bit_length(), 1),
            device=device)
        self._ids = np.arange(num_experts, dtype=np.int32)

    def update(self, expert_counts) -> None:
        self.bank.push(self._ids, np.asarray(expert_counts, np.int32))

    def hot_experts(self, phi: float = 0.125) -> StatsReport:
        """Experts with windowed load >= phi * live mass (the paper's
        phi-heavy hitters)."""
        ids, counts = self.bank.topk(self.capacity)
        ids, counts = _host(ids), _host(counts)
        live = max(self.insertions - self.deletions, 1)
        mask = counts >= phi * live
        return StatsReport(items=ids[mask], counts=counts[mask],
                           insertions=self.insertions,
                           deletions=self.deletions)


__all__ = ["StatsReport", "TokenStats", "ExpertLoadStats"]
