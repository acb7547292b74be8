"""StreamSession: the stateful host-side companion of the sketch API.

Counterpart of ``repro/sketch/session.py`` (``StreamSession``, :132):
block buffering (``extend``/``observe`` auto-flush full blocks, the
tail zero-weight padded), validated ``ingest``, windowed deletion
scheduling (``push`` expires whole batches, ``observe`` single items,
after ``window`` steps), queries that flush first, and tagged
checkpoints with an optional scheduling snapshot.

Ingest runs eagerly: there is no compiled-ingest cache, because
nothing is traced. The reference's fault injection, straggler monitor,
replay log and ``BlockFeeder`` are not part of this port yet
(ROADMAP.md Queue 1 items 8 and 14).
"""
from __future__ import annotations

import collections
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from ..platform import DEFAULT_DEVICE, resolve_device
from . import api
from .api import SketchSpec


class StreamSession:
    """Streaming front-end over one :class:`SketchSpec` on one device.

    ``block``: fixed ingest block length. ``window``: optional
    bounded-deletion horizon, in pushes for ``push`` and in observations
    for ``observe``. ``state``: resume from an existing state.
    ``device``: where the state lives (CUDA unless asked).
    """

    def __init__(self, spec: SketchSpec, block: int = 8192,
                 window: Optional[int] = None, state=None,
                 device=DEFAULT_DEVICE):
        if block < 2:
            raise ValueError(f"block must be >= 2, got {block}")
        self.spec = spec
        self.block = int(block)
        self.window = window
        self.device = resolve_device(device)
        self.state = state if state is not None else api.make(spec, self.device)
        self.insertions = 0
        self.deletions = 0
        # positive mass validated into this session: the prior_mass bound
        # api.validate_block holds each new block against
        self.ingested_mass = 0
        self.blocks_ingested = 0
        self._buf_i: List[np.ndarray] = []
        self._buf_w: List[np.ndarray] = []
        self._buf_n = 0
        self._batch_fifo: Deque[Tuple[np.ndarray, np.ndarray]] = \
            collections.deque()
        self._item_fifo: Deque[Tuple[int, int]] = collections.deque()

    # -- low-level ingest --------------------------------------------------

    def ingest_block(self, items, weights) -> None:
        """Feed ONE exactly block-sized, already-padded int32 block."""
        items = torch.as_tensor(items, dtype=torch.int32, device=self.device)
        weights = torch.as_tensor(weights, dtype=torch.int32,
                                  device=self.device)
        self.state = api.adapter_for(self.spec).update(
            self.spec, self.state, items, weights)
        self.blocks_ingested += 1

    def ingest(self, items, weights) -> None:
        """Validate, chunk to the session block, pad, and ingest now.
        Items and weights are host arrays or tensors on any device (copied
        to the host for validation)."""
        items = api.host_array(items).ravel()
        weights = api.host_array(weights).ravel()
        self.ingested_mass += api.validate_block(
            self.spec, items, weights, prior_mass=self.ingested_mass)
        items = items.astype(np.int32)
        weights = weights.astype(np.int32)
        for s in range(0, len(items), self.block):
            ci = items[s:s + self.block]
            cw = weights[s:s + self.block]
            pad = self.block - len(ci)
            if pad:
                ci = np.pad(ci, (0, pad))  # weight-0 tail = padding
                cw = np.pad(cw, (0, pad))
            self.ingest_block(ci, cw)

    # -- buffered streaming ------------------------------------------------

    def extend(self, items, weights=None) -> None:
        """Buffer signed weighted updates; auto-flush full blocks.
        ``weights=None`` = unit inserts."""
        items = api.host_array(items).ravel()
        weights = (np.ones(len(items), np.int32) if weights is None
                   else api.host_array(weights).ravel())
        self.ingested_mass += api.validate_block(
            self.spec, items, weights, prior_mass=self.ingested_mass)
        self._append(items.astype(np.int32), weights.astype(np.int32))

    def _append(self, items: np.ndarray, weights: np.ndarray) -> None:
        self._buf_i.append(items)
        self._buf_w.append(weights)
        self._buf_n += len(items)
        if self._buf_n >= self.block:
            self._drain(keep_partial=True)

    def observe(self, item: int, weight: int = 1) -> None:
        """One observation; with ``window`` set, the observation that falls
        off the horizon is deleted in the same step (bounded deletion)."""
        item = int(item)
        weight = int(weight)
        if item < 0:
            raise ValueError(
                f"negative item id {item}: ids must be >= 0 (negative ids "
                f"are the EMPTY/BLOCKED sentinels)")
        int32_max = int(np.iinfo(np.int32).max)
        if abs(weight) > int32_max:
            raise ValueError(f"weight {weight} does not fit int32")
        if weight > 0 and self.ingested_mass + weight > int32_max:
            raise ValueError(
                f"observation of weight {weight} on a session already "
                f"holding {self.ingested_mass} positive mass could carry a "
                f"counter past int32 max ({int32_max})")
        expire = self.window is not None and len(self._item_fifo) >= self.window
        if expire:
            old_i, old_w = self._item_fifo[0]
            frag_i = np.asarray([item, old_i], np.int32)
            frag_w = np.asarray([weight, -old_w], np.int32)
        else:
            frag_i = np.asarray([item], np.int32)
            frag_w = np.asarray([weight], np.int32)
        self._append(frag_i, frag_w)
        self.insertions += weight
        if weight > 0:
            self.ingested_mass += weight
        if self.window is not None:
            self._item_fifo.append((item, weight))
            if expire:
                self._item_fifo.popleft()
                self.deletions += old_w

    def flush(self) -> None:
        """Ingest everything buffered, padding the final partial block."""
        self._drain(keep_partial=False)

    def _drain(self, keep_partial: bool) -> None:
        if not self._buf_n:
            return
        items = np.concatenate(self._buf_i)
        weights = np.concatenate(self._buf_w)
        n_full = (len(items) // self.block) * self.block
        for s in range(0, n_full, self.block):
            self.ingest_block(items[s:s + self.block],
                              weights[s:s + self.block])
        tail = len(items) - n_full
        if not keep_partial and tail:
            pad = self.block - tail
            self.ingest_block(np.pad(items[n_full:], (0, pad)),
                              np.pad(weights[n_full:], (0, pad)))
        keep = keep_partial and tail
        self._buf_i = [items[n_full:]] if keep else []
        self._buf_w = [weights[n_full:]] if keep else []
        self._buf_n = tail if keep else 0

    # -- windowed batch scheduling -----------------------------------------

    def push(self, items, weights) -> None:
        """Ingest one batch now; after ``window`` further pushes it is
        re-ingested with negated weights. Buffered updates flush first."""
        self.flush()
        items = api.host_array(items).ravel()
        weights = api.host_array(weights).ravel()
        self.ingest(items, weights)
        self.insertions += int(weights.sum())
        if self.window is None:
            return
        self._batch_fifo.append((items.astype(np.int32),
                                 weights.astype(np.int32)))
        while len(self._batch_fifo) > self.window:
            di, dw = self._batch_fifo.popleft()
            self.deletions += int(dw.sum())
            self.ingest(di, -dw)

    @property
    def alpha_bound(self) -> float:
        """Empirical alpha = I / (I - D) (paper Table 2)."""
        return self.insertions / max(self.insertions - self.deletions, 1)

    # -- queries (flush first: a query sees every prior update) ------------

    def query_many(self, items) -> torch.Tensor:
        self.flush()
        return api.query_many(self.spec, self.state, items)

    def query(self, item) -> torch.Tensor:
        self.flush()
        return api.query(self.spec, self.state, item)

    def topk(self, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
        self.flush()
        return api.topk(self.spec, self.state, m)

    # -- checkpointing -----------------------------------------------------

    def save(self, include_schedule: bool = False) -> dict:
        """Tagged checkpoint dict (``api.save``).

        ``include_schedule=False`` flushes first and saves the sketch only.
        ``include_schedule=True`` does not flush: it adds the reference's
        ``sched_*`` keys (buffer, expiry FIFOs, totals, block cursor,
        window) so ``load`` resumes mid-stream in either package.
        """
        if not include_schedule:
            self.flush()
            return api.save(self.spec, self.state)
        d = api.save(self.spec, self.state)

        def cat(frags):
            return np.concatenate(frags) if frags else np.zeros(0, np.int32)

        d["sched_buf_items"] = cat(self._buf_i)
        d["sched_buf_weights"] = cat(self._buf_w)
        d["sched_item_fifo_items"] = np.asarray(
            [i for i, _ in self._item_fifo], np.int32)
        d["sched_item_fifo_weights"] = np.asarray(
            [w for _, w in self._item_fifo], np.int32)
        d["sched_batch_items"] = cat([b for b, _ in self._batch_fifo])
        d["sched_batch_weights"] = cat([w for _, w in self._batch_fifo])
        d["sched_batch_lens"] = np.asarray(
            [len(b) for b, _ in self._batch_fifo], np.int64)
        d["sched_batch_tenants"] = np.full(len(self._batch_fifo), -1, np.int64)
        d["sched_insertions"] = self.insertions
        d["sched_deletions"] = self.deletions
        d["sched_seq"] = self.blocks_ingested
        d["sched_window"] = -1 if self.window is None else int(self.window)
        d["sched_error_slack"] = 0
        return d

    def load(self, d: dict) -> None:
        """Restore from a ``save`` dict of either package; all scheduling
        state resets, then a ``sched_*`` snapshot is restored on top."""
        self._buf_i, self._buf_w, self._buf_n = [], [], 0
        self._batch_fifo.clear()
        self._item_fifo.clear()
        self.insertions = 0
        self.deletions = 0
        self.blocks_ingested = 0
        self.spec = api.infer_spec(self.spec, d)
        self.state = api.restore(self.spec, d, self.device)
        if "sched_seq" in d:
            self._restore_schedule(d)

    def _restore_schedule(self, d: dict) -> None:
        saved_w = int(np.asarray(d["sched_window"]))
        saved_window = None if saved_w < 0 else saved_w
        if self.window != saved_window:
            raise ValueError(
                f"checkpoint carries window={saved_window} but this session "
                f"was built with window={self.window}")
        tenants = np.asarray(d.get("sched_batch_tenants", []))
        if (tenants >= 0).any() or len(d.get("sched_deferred_due", [])) \
                or int(np.asarray(d.get("sched_error_slack", 0))):
            raise NotImplementedError(
                "the checkpoint carries per-tenant expiries, delayed fault "
                "slices or resize slack; ROADMAP.md Queue 1 items 12 and 14 "
                "port those")
        bi = np.asarray(d["sched_buf_items"], np.int32)
        bw = np.asarray(d["sched_buf_weights"], np.int32)
        self._buf_i = [bi] if len(bi) else []
        self._buf_w = [bw] if len(bw) else []
        self._buf_n = len(bi)
        self._item_fifo.extend(
            (int(i), int(w)) for i, w in zip(
                np.asarray(d["sched_item_fifo_items"]),
                np.asarray(d["sched_item_fifo_weights"])))
        cat_i = np.asarray(d["sched_batch_items"], np.int32)
        cat_w = np.asarray(d["sched_batch_weights"], np.int32)
        s = 0
        for n in np.asarray(d["sched_batch_lens"], np.int64):
            self._batch_fifo.append((cat_i[s:s + n], cat_w[s:s + n]))
            s += int(n)
        self.insertions = int(np.asarray(d["sched_insertions"]))
        self.deletions = int(np.asarray(d["sched_deletions"]))
        self.blocks_ingested = int(np.asarray(d["sched_seq"]))


__all__ = ["StreamSession"]
