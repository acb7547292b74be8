"""Elastic, fault-tolerant operation over the SpaceSaving± banks.

Counterpart of ``repro/sketch/elastic.py`` on one device:

- **resize**: ``reshard`` (the hash-sharded frequency bank) and
  ``reshard_dyadic`` (the shard × level quantile bank) move every live
  counter to its new owner row ``shard_of(id, S')``. A hash partition
  gives each id one old row and one new row, so counters that land in
  one new row have disjoint ids and their union is exact; a row given
  more counters than its capacity keeps its top-k' by count, and its
  largest dropped count is its ``error_slack``, the widening of the
  post-resize query bound. Host numpy, as the reference's (a rare
  control-plane step whose slack accounting stays auditable).
- **detection and degraded serving**: ``scan_rows`` checks the
  invariants every healthy row keeps; ``mask_rows`` resets dead rows;
  ``query_many_degraded`` answers from the surviving rows with a
  ``reliable`` mask.
- **recovery**: ``recover_session`` rebuilds the state from a
  ``save(include_schedule=True)`` checkpoint and the session's replay
  log through the session's compiled ingest, into a state of its own,
  and splices only the dead rows into the live state.

A mesh-sharded state (``parallel.sharding.use_mesh``) is gathered
before a resize; ``reshard_session`` asks the mesh
(``parallel.sharding.mesh_resize``) whether the new shard count still
divides the "shards" axes, and warns when a resize leaves them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import sharding as psh
from . import bank as bk
from . import dyadic_sharded as dysh
from . import sharded as shd
from . import state as st
from .dyadic_sharded import DyadicShardedState
from .sharded import ShardedSketch
from .state import BLOCKED, EMPTY, INT_MAX, SketchState


@dataclasses.dataclass(frozen=True)
class ResizeReport:
    """What a resize did to the bank and to the error bounds.

    ``row_slack[s']``: the largest counter dropped from new row s' (0
    when everything fit), the extra mass an unmonitored id of that row
    may carry. ``error_slack``: the largest over the rows, the one
    scalar a session carries forward."""

    old_rows: int
    new_rows: int
    moved: int              # live counters re-routed
    dropped: int            # counters that did not fit their new row
    dropped_mass: int       # summed count of dropped entries
    row_slack: np.ndarray   # (new_rows,) max dropped count per new row

    @property
    def error_slack(self) -> int:
        return int(self.row_slack.max(initial=0))


def _host(t: torch.Tensor) -> np.ndarray:
    """An int64 host copy of a leaf (a mesh-sharded one gathered)."""
    return psh.full(t).detach().cpu().numpy().astype(np.int64)


def _owners(ids: np.ndarray, num_shards: int) -> np.ndarray:
    """``bank.shard_of`` of host ids, int64."""
    return bk.shard_of(torch.from_numpy(ids.astype(np.int32)),
                       num_shards).numpy().astype(np.int64)


def _reroute(ids: np.ndarray, counts: np.ndarray, errors: np.ndarray,
             owner: np.ndarray, caps_new: Sequence[int], device=None
             ) -> Tuple[SketchState, np.ndarray, int, int]:
    """Place live (id, count, error) entries into their new owner rows.

    Entries go into each row in descending-count order (a stable sort by
    (owner, -count)); a row over capacity keeps its top-cap and the first
    dropped count is the row's slack. The new bank has the BLOCKED
    capacity padding of ``caps_new``. Returns ``(bank, row_slack,
    dropped, dropped_mass)``."""
    caps = np.asarray([int(c) for c in caps_new], np.int64)
    R = len(caps)
    k = int(caps.max()) if R else 0
    order = np.lexsort((-counts, owner))
    ow = owner[order]
    ids_s, cnt_s, err_s = ids[order], counts[order], errors[order]
    n = len(ow)
    idx = np.arange(n)
    if n:
        starts = np.r_[0, np.flatnonzero(np.diff(ow)) + 1]
        run_len = np.diff(np.r_[starts, n])
        rank = idx - np.repeat(starts, run_len)
    else:
        rank = idx
    keep = rank < caps[ow]
    row_slack = np.zeros(R, np.int64)
    first_drop = ~keep & (rank == caps[ow])
    row_slack[ow[first_drop]] = cnt_s[first_drop]
    dropped = int((~keep).sum())
    dropped_mass = int(cnt_s[~keep].sum())
    real = np.arange(k)[None, :] < caps[:, None]
    new_ids = np.where(real, EMPTY, BLOCKED).astype(np.int64)
    new_cnt = np.where(real, 0, INT_MAX).astype(np.int64)
    new_err = np.zeros((R, k), np.int64)
    new_ids[ow[keep], rank[keep]] = ids_s[keep]
    new_cnt[ow[keep], rank[keep]] = cnt_s[keep]
    new_err[ow[keep], rank[keep]] = err_s[keep]
    bank = SketchState(*(torch.as_tensor(a.astype(np.int32), device=device)
                         for a in (new_ids, new_cnt, new_err)))
    return bank, row_slack, dropped, dropped_mass


def _live_entries(bank: SketchState):
    """Flat (ids, counts, errors) of every live counter of the bank."""
    ids, cnt, err = (_host(t).reshape(-1) for t in bank)
    live = ids >= 0
    return ids[live], cnt[live], err[live]


def reshard(state: ShardedSketch, new_shards: int, *,
            per_shard_capacity: Optional[int] = None
            ) -> Tuple[ShardedSketch, ResizeReport]:
    """Live S -> S' resize of a hash-sharded frequency bank: every live
    counter moves to ``shard_of(id, S')`` with its count and error. The
    default capacity keeps the total budget (ceil(S·k / S')); with
    ``new_shards=1`` that holds every counter (a lossless consolidate)."""
    if new_shards < 1:
        raise ValueError(f"new_shards must be >= 1, got {new_shards}")
    state = shd.gathered(state)
    S, k = state.bank.ids.shape
    k_new = per_shard_capacity or -(-(S * k) // new_shards)
    ids, cnt, err = _live_entries(state.bank)
    bank, slack, dropped, dmass = _reroute(
        ids, cnt, err, _owners(ids, new_shards), [k_new] * new_shards,
        state.bank.ids.device)
    report = ResizeReport(
        old_rows=S, new_rows=new_shards, moved=len(ids) - dropped,
        dropped=dropped, dropped_mass=dmass, row_slack=slack)
    return ShardedSketch(bank=bank), report


def reshard_dyadic(state: DyadicShardedState, new_shards: int
                   ) -> Tuple[DyadicShardedState, ResizeReport]:
    """Live S -> S' resize of the shard × level quantile bank: level l's
    nodes move to row ``(shard_of(node, S'), l)``; every (shard, level)
    row keeps the full one-host layer capacity, and ``mass`` carries
    over."""
    if new_shards < 1:
        raise ValueError(f"new_shards must be >= 1, got {new_shards}")
    state = dysh.gathered(state)
    S, bits, k = state.bank.ids.shape
    caps = bk.row_capacities(SketchState(*(t[0] for t in state.bank)))
    ids, cnt, err = (_host(t) for t in state.flat_bank)
    level = np.broadcast_to(np.arange(bits, dtype=np.int64)[None, :, None],
                            (S, bits, k)).reshape(S * bits, k)
    live = ids >= 0
    ids_l, cnt_l, err_l, lvl_l = ids[live], cnt[live], err[live], level[live]
    owner = _owners(ids_l, new_shards) * bits + lvl_l
    bank, slack, dropped, dmass = _reroute(
        ids_l, cnt_l, err_l, owner, list(caps) * new_shards,
        state.bank.ids.device)
    k_new = bank.ids.shape[1]
    report = ResizeReport(
        old_rows=S * bits, new_rows=new_shards * bits,
        moved=len(ids_l) - dropped, dropped=dropped, dropped_mass=dmass,
        row_slack=slack)
    return DyadicShardedState(
        bank=SketchState(*(t.reshape(new_shards, bits, k_new) for t in bank)),
        mass=state.mass), report


def _reshard_merge_reference(state: ShardedSketch,
                             new_shards: int) -> SketchState:
    """``reshard`` spelled with ``state.merge`` (the oracle): new row s'
    is the merge of every old row masked to the ids s' owns, at a width
    that holds every co-landing counter. The masked views are never full,
    so the merge adds no cross term and gives the exact union."""
    S, k = state.bank.ids.shape
    W = S * k
    ids_all, cnt_all, err_all = (_host(t) for t in state.bank)
    dev = state.bank.ids.device

    def padded(a, fill):
        return torch.as_tensor(np.pad(a, (0, W - k), constant_values=fill)
                               .astype(np.int32), device=dev)

    rows = []
    for s_new in range(new_shards):
        acc = None
        for r in range(S):
            ids_r = ids_all[r]
            live = ids_r >= 0
            own = np.zeros(k, bool)
            if live.any():
                own[live] = _owners(ids_r[live], new_shards) == s_new
            view = SketchState(padded(np.where(own, ids_r, EMPTY), EMPTY),
                               padded(np.where(own, cnt_all[r], 0), 0),
                               padded(np.where(own, err_all[r], 0), 0))
            acc = view if acc is None else st.merge(acc, view)
        rows.append(acc)
    return SketchState(*(torch.stack(f) for f in zip(*rows)))


# ---------------------------------------------------------------------------
# Shard-loss detection and degraded serving
# ---------------------------------------------------------------------------

def scan_rows(bank: SketchState) -> np.ndarray:
    """Per-row health scan, True for a dead or corrupt row: ids below
    BLOCKED, EMPTY slots with a count or error, BLOCKED slots without
    INT_MAX count and zero error, live slots with a negative count or
    error, or a live id twice in a row."""
    ids, cnt, err = (_host(t) for t in bank)
    if ids.ndim == 1:
        ids, cnt, err = ids[None], cnt[None], err[None]
    empty = ids == EMPTY
    blocked = ids == BLOCKED
    live = ids >= 0
    bad = (ids < BLOCKED).any(axis=1)
    bad |= (empty & ((cnt != 0) | (err != 0))).any(axis=1)
    bad |= (blocked & ((cnt != INT_MAX) | (err != 0))).any(axis=1)
    bad |= (live & ((cnt < 0) | (err < 0))).any(axis=1)
    for r in range(ids.shape[0]):
        row_live = ids[r][live[r]]
        if len(np.unique(row_live)) != len(row_live):
            bad[r] = True
    return bad


def mask_rows(bank: SketchState, dead: np.ndarray,
              caps: Optional[Sequence[int]] = None) -> SketchState:
    """Dead rows reset to empty rows (``caps`` restores each row's BLOCKED
    capacity pattern; full capacity by default), so the bank keeps
    serving. A new bank."""
    R, k = bank.ids.shape
    caps = [k] * R if caps is None else [int(c) for c in caps]
    fresh = bk.init(caps, device=bank.ids.device)
    if fresh.ids.shape[1] != k:
        raise ValueError(f"caps imply width {fresh.ids.shape[1]}, bank "
                         f"has {k}")
    dead_col = torch.as_tensor(np.asarray(dead, bool),
                               device=bank.ids.device)[:, None]
    return SketchState(*(torch.where(dead_col, f, b)
                         for f, b in zip(fresh, bank)))


def query_many_degraded(state: ShardedSketch, items, dead: np.ndarray
                        ) -> Tuple[torch.Tensor, np.ndarray]:
    """Owner-shard estimates and a per-query ``reliable`` mask: an id owned
    by a dead row answers 0 with ``reliable=False`` (unknown, not absent);
    dead rows are masked before the read."""
    dev = state.bank.ids.device
    items = torch.as_tensor(np.asarray(items).astype(np.int32), device=dev)
    dead = np.asarray(dead, bool)
    safe = mask_rows(state.bank, dead)
    owner = bk.shard_of(items.cpu(), state.num_shards).numpy()
    est = bk.query_rows(safe, torch.as_tensor(owner, device=dev), items)
    return est, ~dead[owner]


# ---------------------------------------------------------------------------
# Recovery: checkpoint + replay-log rebuild, dead rows spliced back
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    rows: Tuple[int, ...]       # rows rebuilt (empty = the whole state)
    replayed_blocks: int        # blocks re-ingested after the checkpoint
    seconds: float


def _splice_rows(live, rebuilt, rows: Sequence[int]):
    """``live`` with ``rows`` of every tensor's leading axis taken from
    ``rebuilt`` (a new state). A 0-d tensor (the dyadic ``mass``) takes
    the rebuilt value: mass is global, and the rebuild is the fault-free
    truth."""
    from .session import _leaves, _like

    out = []
    for lv, rb in zip(_leaves(live), _leaves(rebuilt)):
        if lv.dim() == 0:
            out.append(rb.clone())
            continue
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=lv.device)
        t = lv.clone()
        t[idx] = rb[idx]
        out.append(t)
    return _like(live, out)


def dead_shards(spec, state) -> np.ndarray:
    """(S,) mask of the dead or corrupt shards of a session state: the
    frequency bank's rows, or a dyadic shard any of whose levels is
    corrupt (a shard is one failure domain)."""
    bank = state.bank
    if bank.ids.dim() == 3:
        S, bits, k = bank.ids.shape
        per_level = scan_rows(SketchState(*(t.reshape(S * bits, k)
                                            for t in bank)))
        return per_level.reshape(S, bits).any(axis=1)
    return scan_rows(bank)


def recover_session(session, saved: dict,
                    rows: Optional[Sequence[int]] = None) -> RecoveryReport:
    """Rebuild lost shard rows from checkpoint + replay, exactly once.

    ``saved`` is a ``session.save(include_schedule=True)`` dict. The
    checkpointed state is restored and every logged block after it is
    ingested again, in order, through the session's compiled ingest (on
    the card it copies the rebuilt state in, after moving the live
    state's shared buffers to memory of its own); then ``rows`` (default:
    those ``dead_shards`` flags) are spliced into the live state, the
    others keeping their live values. An unsharded spec takes the whole
    rebuilt state. Raises when the log no longer covers the checkpoint.
    """
    from . import api

    t0 = time.perf_counter()
    if "sched_seq" not in saved:
        raise ValueError(
            "recovery needs a save(include_schedule=True) checkpoint "
            "(plain api.save dicts carry no replay cursor)")
    saved_seq = int(np.asarray(saved["sched_seq"]))
    log = list(session.replay_log)
    if log and log[0][0] > saved_seq + 1:
        raise ValueError(
            f"replay log starts at block {log[0][0]} but the checkpoint "
            f"was taken at block {saved_seq}; blocks "
            f"{saved_seq + 1}..{log[0][0] - 1} are gone — raise "
            f"StreamSession(replay=...) above the checkpoint cadence")
    spec = api.infer_spec(session.spec, saved)
    if (spec.kind, spec.shards) != (session.spec.kind, session.spec.shards):
        raise ValueError(
            f"checkpoint layout (kind={spec.kind!r}, shards={spec.shards}) "
            f"does not match the live session "
            f"(kind={session.spec.kind!r}, shards={session.spec.shards}); "
            f"recover into a matching session, or load() it outright")
    rebuilt = api.restore(spec, saved, session.device)
    replayed = 0
    for seq, items, weights in log:
        if seq <= saved_seq:
            continue
        rebuilt = session._compiled(rebuilt, items, weights)
        replayed += 1
    if session.spec.shards is None:
        session.state = rebuilt
        rows = ()
    else:
        if rows is None:
            rows = np.flatnonzero(dead_shards(session.spec, session.state))
        rows = tuple(int(r) for r in rows)
        if rows:
            session.state = _splice_rows(session.state, rebuilt, rows)
    return RecoveryReport(rows=rows, replayed_blocks=replayed,
                          seconds=time.perf_counter() - t0)


def reshard_session(session, new_shards: int) -> ResizeReport:
    """Resize a live session's backend S -> S' in place: flush, reshard
    the state (frequency or dyadic bank by kind), set the spec's
    ``shards``, take the compiled ingest of the new spec's cell and add
    the resize's ``error_slack`` to ``session.error_slack``. Under a mesh
    the "shards" logical rule is re-checked for the new count
    (``parallel.sharding.mesh_resize``): leaving the shard_map path is
    allowed (ingest falls back to the fused single-launch path) and
    warns."""
    import warnings

    from .session import _ingest_fn

    if session.spec.shards is None:
        raise ValueError(
            "reshard_session needs a sharded spec (shards=S); an "
            "unsharded summary has no shard axis to resize")
    session.flush()
    if session.spec.kind == "frequency":
        new_state, report = reshard(session.state, new_shards)
    else:
        new_state, report = reshard_dyadic(session.state, new_shards)
    old_axes = psh.mesh_resize("shards", session.spec.shards)
    new_axes = psh.mesh_resize("shards", new_shards)
    if old_axes and not new_axes:
        warnings.warn(
            f"resize {session.spec.shards}->{new_shards} leaves the mesh "
            f"'shards' axes {old_axes} (not a divisor); ingest falls back "
            f"to the fused single-launch path", stacklevel=2)
    session.spec = dataclasses.replace(session.spec, shards=new_shards)
    session.state = new_state
    session._compiled = _ingest_fn(session.spec, session.block,
                                   session.donate)
    session.error_slack += report.error_slack
    return report


__all__ = ["ResizeReport", "RecoveryReport", "reshard", "reshard_dyadic",
           "reshard_session", "scan_rows", "dead_shards", "mask_rows",
           "query_many_degraded", "recover_session"]
