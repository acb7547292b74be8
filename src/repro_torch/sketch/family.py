"""The SpaceSaving± family: Double and unbiased SpaceSaving±, CR-precis.

Counterpart of ``repro/sketch/family.py``:

- **Double SpaceSaving±** (``SketchSpec(variant="double")``): two
  (R, k) banks sharing one router, insertions into the insert bank and
  deletions into the delete bank as insertions (``bank.update_pair``:
  two kernel-1 launches a block on the partition layout). The estimate
  subtracts the delete bank's guaranteed count ``max(count - error, 0)``
  and is clamped at 0. Capacities split ``k_I : k_D = alpha : alpha-1``.
- **Unbiased SpaceSaving±** (``variant="unbiased"``): the same two banks,
  each applying Ting's randomized eviction: an evicting insert of weight
  w adds w to the minimum count and adopts the incoming id only when
  ``u * (mc + w) < w`` for a uniform u. The estimate is the raw
  difference, not clamped. On the card one launch of
  ``csrc/unbiased_update.cu`` updates both banks (one CTA per bank row).
- **CR-precis** (``backend="crprecis"``): t counter rows, row j indexed
  by ``x mod p_j`` for t distinct primes just below ``k // t``; signed
  weights add linearly (one scatter-add a block, plain torch ops, as the
  reference's plain JAX).

The unbiased variant's uniforms differ from the reference's. The
reference draws them from ``jax.random`` keys split per block position;
the port does not reproduce ``jax.random.split``. It derives them from
the state's (2,) uint32 key with a counter-based integer hash defined
here (``draw``: ``uniforms`` and ``next_key``), computed in int64 and
masked to 32 bits, so the CPU and the card give the same bits. One
uniform per block
position and bank: a position belongs to one row, whose update reads it.
Fed the reference's own uniforms (``u[b] = u_ref[b, owner(b)]``), the
port's row update is the reference's ``_unbiased_rows`` bit for bit.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..platform import DEFAULT_DEVICE, resolve_device
from . import bank as bk
from .phases import stable_partition_perm
from .state import EMPTY, I32, SketchState, sat_add, top_m

# api's layout tags (api imports this module after its registry)
_LAYOUT_DOUBLE = 3
_LAYOUT_CRPRECIS = 4
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Double / unbiased SpaceSaving±: two coupled banks
# ---------------------------------------------------------------------------

class DoubleState(NamedTuple):
    """Two coupled (R, k) banks and the unbiased variant's key."""

    ins: SketchState    # (R, k_I) insert summary
    dels: SketchState   # (R, k_D) delete summary (deletions as inserts)
    key: torch.Tensor   # (2,) uint32; zeros for the deterministic variant


def double_capacities(total: int, alpha: float) -> Tuple[int, int]:
    """Split a total counter budget into (k_I, k_D) at alpha : alpha-1,
    which equalises the two sides' worst cases under bounded deletion."""
    total = int(total)
    if total < 2:
        raise ValueError(
            f"variant='double'/'unbiased' needs k >= 2 (one counter per "
            f"bank), got k={total}")
    k_i = int(round(total * alpha / (2.0 * alpha - 1.0)))
    k_i = min(max(k_i, 1), total - 1)
    return k_i, total - k_i


def init_double(total: int, alpha: float, num_rows: int = 1, seed: int = 0,
                unbiased: bool = False, device=DEFAULT_DEVICE) -> DoubleState:
    """Empty coupled banks; per-row caps split the total budget evenly.
    The unbiased key is ``[0, seed & 0xFFFFFFFF]``, the bits of the
    reference's ``jax.random.PRNGKey(seed)`` (its seed taken as 32 bits)."""
    dev = resolve_device(device)
    k_i, k_d = double_capacities(total, alpha)
    key = [0, seed & _U32] if unbiased else [0, 0]
    return DoubleState(
        ins=bk.init(-(-k_i // num_rows), num_rows, device=dev),
        dels=bk.init(-(-k_d // num_rows), num_rows, device=dev),
        key=torch.tensor(key, dtype=torch.int64, device=dev).to(torch.uint32))


def update_double(state: DoubleState, items: torch.Tensor,
                  weights: torch.Tensor, router) -> DoubleState:
    """Deterministic Double SS± ingest: two kernel-1 launches a block."""
    ins, dels = bk.update_pair(state.ins, state.dels, items, weights, router)
    return DoubleState(ins, dels, state.key)


# -- the unbiased variant's uniforms ----------------------------------------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 values masked to 32 bits (``bank.shard_of``'s
    finalizer): products wrap past 2^63, their low 32 bits are the
    uint32 product's."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def _hash(key: torch.Tensor, stream: int, counter: torch.Tensor
          ) -> torch.Tensor:
    """32 random bits (int64) per counter of one stream of a (2,) key."""
    k = key.to(torch.int64) & _U32
    h = _mix32((k[0] ^ ((stream * 0x9E3779B9) & _U32)) & _U32)
    h = _mix32(h ^ k[1])
    return _mix32(_mix32(h ^ counter) ^ h)


def uniforms(key: torch.Tensor, n: int) -> torch.Tensor:
    """(2, n) float32 uniforms in [0, 1) of a (2,) uint32 key: row 0 for
    the insert bank, row 1 for the delete bank, one per block position
    (the top 24 bits of ``_hash`` times 2^-24, exact in float32)."""
    counter = torch.arange(n, dtype=torch.int64, device=key.device)
    bits = torch.stack([_hash(key, s, counter) for s in (0, 1)])
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def next_key(key: torch.Tensor) -> torch.Tensor:
    """The key the next block draws from: stream 2 of this one."""
    counter = torch.arange(2, dtype=torch.int64, device=key.device)
    return _hash(key, 2, counter).to(torch.uint32)


# -- the unbiased row update --------------------------------------------------

def unbiased_prep(items: torch.Tensor, weights: torch.Tensor, router):
    """Owner-sorted flat layout of one block for both banks.

    The block is sorted by id (``bank.sort_block``, the reference's
    routing order: block position b is the b-th entry of the sorted
    block). Position b belongs to class ``owner(b)`` where its weight is
    positive (the insert bank's row), ``R + owner(b)`` where negative
    (the delete bank's), ``2R`` where it is a no-op (zero weight, a
    negative id or an owner outside the bank). A stable sort by class
    lists each row's positions in block order. Returns ``(s_items, s_w,
    perm, roff)``: the sorted (B,) ids and signed weights, the (B,)
    positions by class and the (2R+1,) class starts.
    """
    items = items.to(I32)
    weights = weights.to(I32)
    R = router.num_rows
    order = bk.sort_block(items, router.universe_bits)
    s_items = items[order]
    s_w = weights[order]
    w_ins, w_del = bk.split_signed(s_w)
    owner = router.owner_of(s_items)
    routed = (s_items >= 0) & (owner >= 0) & (owner < R)
    klass = torch.where(routed & (w_ins > 0), owner,
                        torch.where(routed & (w_del > 0), owner + R, 2 * R))
    if (2 * R + 1) * items.shape[0] < 2**31:
        perm = stable_partition_perm(klass)    # the packed single sort
    else:
        perm = torch.sort(klass, stable=True).indices
    bounds = torch.arange(2 * R + 1, dtype=I32, device=items.device)
    roff = torch.searchsorted(klass[perm].contiguous(), bounds,
                              out_int32=True)
    return s_items, s_w, perm.to(I32), roff


def draw(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a block of ``n`` updates draws from a (2,) key: its (2, n)
    uniforms and the key the next block draws from. The one key schedule
    of the unbiased ingest."""
    return uniforms(key, n), next_key(key)


def update_unbiased(state: DoubleState, items: torch.Tensor,
                    weights: torch.Tensor, router) -> DoubleState:
    """Unbiased-variant ingest: randomized eviction on both banks, one
    launch of the unbiased kernel for CUDA banks (its plain version for
    CPU banks), the uniforms drawn from the state's key (``draw``)."""
    from ..kernels.sketch_update import ops

    u, key = draw(state.key, items.shape[0])
    ins, dels = ops.sketch_unbiased_update(state.ins, state.dels, items,
                                           weights, u, router)
    return DoubleState(ins, dels, key)


# -- reads, merge, consolidation ----------------------------------------------

def _guaranteed_rows(bank: SketchState, rows: torch.Tensor,
                     items: torch.Tensor) -> torch.Tensor:
    """Owner-row guaranteed count ``max(count - error, 0)`` per item;
    unmonitored and sentinel ids answer 0."""
    items = items.to(I32)
    ids_r = bank.ids[rows]
    val_r = torch.clamp(bank.counts[rows] - bank.errors[rows], min=0)
    eq = (ids_r == items[:, None]) & (ids_r >= 0)
    return torch.where(eq, val_r, 0).sum(dim=1, dtype=I32) * eq.any(dim=1)


def query_many_double(state: DoubleState, items: torch.Tensor,
                      clamp: bool = True,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The combined estimate from each item's owner row of both banks.

    ``clamp=True`` (double): the insert bank's count minus the delete
    bank's guaranteed count, clamped at 0, so it never underestimates.
    ``clamp=False`` (unbiased): the raw difference of the two counts.
    ``rows`` replaces ``shard_of`` for other routers (the tenant layout);
    both banks share one router, so one row vector serves both."""
    items = items.to(I32)
    R = state.ins.ids.shape[0]
    rows = bk.gather_rows(bk.shard_of(items, R) if rows is None else rows, R)
    if clamp:
        est = bk.query_rows(state.ins, rows, items) \
            - _guaranteed_rows(state.dels, rows, items)
        return torch.clamp(est, min=0)
    return bk.query_rows(state.ins, rows, items) \
        - bk.query_rows(state.dels, rows, items)


# the (rows, k_I, k_D) match of topk_double is built this many entries at a
# time (about 1 GB of intermediates)
_MATCH_ENTRIES = 1 << 26


def topk_double(state: DoubleState, m: int,
                clamp: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m by the combined estimate over the insert bank's monitored
    slots, each looked up in the same row of the delete bank. The match
    is built over chunks of rows (the result is the same)."""
    R, k_i = state.ins.ids.shape
    k_d = state.dels.ids.shape[1]
    step = max(1, _MATCH_ENTRIES // max(k_i * k_d, 1))
    d_val = (torch.clamp(state.dels.counts - state.dels.errors, min=0)
             if clamp else state.dels.counts)
    parts = []
    for lo in range(0, R, step):
        ins_ids = state.ins.ids[lo:lo + step]
        del_ids = state.dels.ids[lo:lo + step]
        eq = ((del_ids[:, None, :] == ins_ids[:, :, None])
              & (del_ids >= 0)[:, None, :] & (ins_ids >= 0)[:, :, None])
        parts.append(torch.where(eq, d_val[lo:lo + step, None, :], 0)
                     .sum(dim=-1, dtype=I32))
    cnt_d = torch.cat(parts) if parts else state.ins.counts[:0]
    est = state.ins.counts - cnt_d
    if clamp:
        est = torch.clamp(est, min=0)
    ids = state.ins.ids.reshape(-1)
    score = torch.where(ids >= 0, est.reshape(-1), -2**31)
    idx = top_m(score, m)
    return ids[idx], score[idx]


def merge_double(a: DoubleState, b: DoubleState) -> DoubleState:
    """Row-wise mergeable-summaries merge of each side; the left key
    survives."""
    return DoubleState(ins=bk.merge_banks(a.ins, b.ins),
                       dels=bk.merge_banks(a.dels, b.dels), key=a.key)


def consolidate_double(state: DoubleState) -> DoubleState:
    """Both banks folded to one row (identity when single-row)."""
    if state.ins.ids.shape[0] == 1:
        return state

    def lift(s):
        return SketchState(*(t[None] for t in bk.consolidate(s)))

    return DoubleState(ins=lift(state.ins), dels=lift(state.dels),
                       key=state.key)


# ---------------------------------------------------------------------------
# CR-precis: deterministic linear counter rows with prime moduli
# ---------------------------------------------------------------------------

class CRPrecisState(NamedTuple):
    counts: torch.Tensor   # (t, b) int32 linear counters; row j uses primes[j]
    primes: torch.Tensor   # (t,) int32 distinct moduli, descending


def _primes_descending(below: int, count: int) -> list:
    """The ``count`` largest primes <= below (trial division, host)."""
    out = []
    n = int(below)
    while n >= 2 and len(out) < count:
        if all(n % p for p in range(2, int(math.isqrt(n)) + 1)):
            out.append(n)
        n -= 1
    if len(out) < count:
        raise ValueError(
            f"cannot find {count} distinct primes <= {below}; raise the "
            f"counter budget k (crprecis needs k >= ~{count * 8})")
    return out


def crprecis_depth(total: int) -> int:
    """Row count t for a total counter budget."""
    return 4 if total >= 64 else 2


def init_crprecis(total: int, device=DEFAULT_DEVICE) -> CRPrecisState:
    """t prime-modulus counter rows whose widths sum to at most total."""
    dev = resolve_device(device)
    t = crprecis_depth(total)
    primes = _primes_descending(int(total) // t, t)
    return CRPrecisState(
        counts=torch.zeros((t, primes[0]), dtype=I32, device=dev),
        primes=torch.tensor(primes, dtype=I32, device=dev))


def _cols(state: CRPrecisState, items: torch.Tensor) -> torch.Tensor:
    """(t, n) counter columns ``x mod p_j``: floor modulo, as the
    reference's ``%``."""
    return torch.remainder(items.to(I32)[None, :], state.primes[:, None])


def update_crprecis(state: CRPrecisState, items: torch.Tensor,
                    weights: torch.Tensor) -> CRPrecisState:
    """Linear signed update ``C[j, x mod p_j] += w``: one int32 scatter-add
    of the block (it wraps, as the reference's; integer adds commute, so
    every order gives the same delta), then a saturating add."""
    t, b = state.counts.shape
    cols = _cols(state, items)
    rows = torch.arange(t, dtype=torch.int64, device=cols.device)[:, None]
    flat = (rows * b + cols).reshape(-1)
    w = weights.to(I32)[None, :].expand(t, -1).reshape(-1)
    delta = torch.zeros(t * b, dtype=I32, device=cols.device)
    delta.index_add_(0, flat, w)
    return CRPrecisState(counts=sat_add(state.counts, delta.reshape(t, b)),
                         primes=state.primes)


def query_many_crprecis(state: CRPrecisState,
                        items: torch.Tensor) -> torch.Tensor:
    """Min-over-rows estimate, clamped at 0; negative ids answer 0."""
    items = items.to(I32)
    cols = _cols(state, items).long()
    vals = state.counts.gather(1, cols)
    est = torch.clamp(vals.amin(dim=0), min=0)
    return torch.where(items >= 0, est, 0)


def topk_crprecis(state: CRPrecisState, m: int,
                  bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m by a scan of the whole universe (CR-precis stores no ids);
    an estimate of 0 reports EMPTY, as the SpaceSaving layouts do."""
    universe = torch.arange(1 << bits, dtype=I32, device=state.counts.device)
    est = query_many_crprecis(state, universe)
    idx = top_m(est, m)
    vals = est[idx]
    return torch.where(vals > 0, universe[idx], EMPTY), vals


def merge_crprecis(a: CRPrecisState, b: CRPrecisState) -> CRPrecisState:
    """Linear merge: counters add (the moduli must match)."""
    return CRPrecisState(counts=sat_add(a.counts, b.counts), primes=a.primes)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------

def _no_rank(spec):
    raise ValueError(
        f"rank/quantile queries need kind='quantile'; this spec is "
        f"kind={spec.kind!r}. Build a SketchSpec(kind='quantile', "
        f"bits=..., ...) to get the dyadic bank.")


def _i32(d, key: str, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(d[key]).astype(np.int32), device=device)


class DoubleAdapter:
    """variant 'double' (deterministic) or 'unbiased' (randomized
    eviction), sharded or not. With ``spec.tenants`` the rows go
    tenant-major and both banks route composite keys through
    ``bank.TenantRouter``, the layout of ``sketch/tenant.py``."""

    def __init__(self, unbiased: bool = False):
        self.unbiased = unbiased

    def _rows(self, spec) -> int:
        return (spec.tenants or 1) * (spec.shards or 1)

    def _router(self, spec, num_rows: Optional[int] = None):
        # the row count comes from the state where given: tenant specs of
        # one layout share a compiled-ingest cell whose spec says tenants=1
        rows = num_rows if num_rows is not None else self._rows(spec)
        if spec.tenants is not None:
            shards = spec.shards or 1
            return bk.TenantRouter(rows // shards, spec.bits, shards)
        return bk.HashShardRouter(rows, spec.bits)

    def make(self, spec, device) -> DoubleState:
        return init_double(spec.capacity, spec.alpha, self._rows(spec),
                           unbiased=self.unbiased, device=device)

    def device_of(self, state) -> torch.device:
        return state.ins.ids.device

    def update(self, spec, state, items, weights):
        fn = update_unbiased if self.unbiased else update_double
        return fn(state, items, weights,
                  self._router(spec, state.ins.ids.shape[0]))

    def query_many(self, spec, state, items):
        rows = None
        if spec.tenants is not None:
            rows = self._router(spec, state.ins.ids.shape[0]).owner_of(items)
        return query_many_double(state, items, clamp=not self.unbiased,
                                 rows=rows)

    def topk(self, spec, state, m):
        # tenant specs answer in composite keys, as the tenant layout's
        return topk_double(state, m, clamp=not self.unbiased)

    def topk_tenant(self, spec, state, tenant, m):
        """One tenant's top-m over its own rows of both banks, raw
        items."""
        shards = spec.shards or 1
        lo = bk.slice_start(tenant, shards, state.ins.ids.shape[0])

        def rows(s):
            return SketchState(*(t[lo:lo + shards] for t in s))

        keys, vals = topk_double(DoubleState(rows(state.ins),
                                             rows(state.dels), state.key),
                                 m, clamp=not self.unbiased)
        return torch.where(keys >= 0, keys & ((1 << spec.bits) - 1),
                           keys), vals

    def rank_many(self, spec, state, xs):
        _no_rank(spec)

    quantile_many = rank_many

    def merge(self, spec, a, b):
        return merge_double(a, b)

    def consolidate(self, spec, state):
        if spec.tenants is not None:
            # folding rows would collapse the tenancy
            return state
        return consolidate_double(state)

    def save(self, spec, state) -> Dict[str, Any]:
        def host(t):
            return t.detach().cpu().numpy()

        return {
            "layout": np.int32(_LAYOUT_DOUBLE),
            "family": np.int32(2 if self.unbiased else 1),
            "ids": host(state.ins.ids),
            "counts": host(state.ins.counts),
            "errors": host(state.ins.errors),
            "ids_del": host(state.dels.ids),
            "counts_del": host(state.dels.counts),
            "errors_del": host(state.dels.errors),
            "key": host(state.key),
            "shards": np.int32(spec.shards or 0),
            "tenants": np.int32(spec.tenants or 0),
            "item_bits": np.int32(spec.bits or 0),
        }

    def restore(self, spec, d, device) -> DoubleState:
        ins = SketchState(*(_i32(d, k, device)
                            for k in ("ids", "counts", "errors")))
        dels = SketchState(*(_i32(d, k, device)
                             for k in ("ids_del", "counts_del", "errors_del")))
        got = ins.ids.shape[0]
        if got != self._rows(spec):
            raise ValueError(
                f"checkpoint has {got} rows, spec asks for "
                f"{self._rows(spec)} (tenants={spec.tenants}, "
                f"shards={spec.shards}); restore with a matching spec "
                f"(or consolidate first)")
        key = torch.as_tensor(np.asarray(d["key"]).astype(np.uint32),
                              device=device)
        return DoubleState(ins=ins, dels=dels, key=key)


class CRPrecisAdapter:
    """backend='crprecis': the deterministic linear-counter baseline."""

    def make(self, spec, device) -> CRPrecisState:
        return init_crprecis(spec.capacity, device=device)

    def device_of(self, state) -> torch.device:
        return state.counts.device

    def update(self, spec, state, items, weights):
        return update_crprecis(state, items, weights)

    def query_many(self, spec, state, items):
        return query_many_crprecis(state, items)

    def topk(self, spec, state, m):
        if spec.bits is None or spec.bits > 20:
            raise ValueError(
                "crprecis stores no item ids, so topk needs an enumerable "
                "universe: set SketchSpec.bits <= 20 (scan cost 2^bits), "
                "or keep your own candidate set and use query_many")
        return topk_crprecis(state, m, spec.bits)

    def rank_many(self, spec, state, xs):
        _no_rank(spec)

    quantile_many = rank_many

    def merge(self, spec, a, b):
        if not torch.equal(a.primes.cpu(), b.primes.cpu()):
            raise ValueError(
                "cannot merge crprecis summaries with different prime "
                "moduli (different k budgets); rebuild at one budget")
        return merge_crprecis(a, b)

    def consolidate(self, spec, state):
        return state

    def save(self, spec, state) -> Dict[str, Any]:
        return {
            "layout": np.int32(_LAYOUT_CRPRECIS),
            "counts": state.counts.detach().cpu().numpy(),
            "primes": state.primes.detach().cpu().numpy(),
        }

    def restore(self, spec, d, device) -> CRPrecisState:
        return CRPrecisState(counts=_i32(d, "counts", device),
                             primes=_i32(d, "primes", device))


__all__ = ["DoubleState", "CRPrecisState", "double_capacities",
           "init_double", "update_double", "uniforms", "next_key", "draw",
           "unbiased_prep", "update_unbiased", "query_many_double",
           "topk_double", "merge_double", "consolidate_double",
           "crprecis_depth", "init_crprecis", "update_crprecis",
           "query_many_crprecis", "topk_crprecis", "merge_crprecis",
           "DoubleAdapter", "CRPrecisAdapter"]
