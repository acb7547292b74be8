"""Multi-tenant sketch layout: thousands of streams in one fused bank.

Counterpart of ``repro/sketch/tenant.py``. One ``(T*S, k)`` bank, rows
tenant-major, a ``bank.TenantRouter`` mapping composite keys
``(tenant << item_bits) | item`` onto the owning tenant's rows, and the
whole fleet ingests one block with one partition-core update (kernel 1
on the card, each row's run of the flat layout read from ``uoff[r]``).
Composite keys never collide across tenants and the partition core is
bit-identical to ``blocks.block_update`` on each row's routed view, so
every tenant's rows evolve as an independent per-tenant sketch fed the
same fragments would.

Layout contract (as in the reference):

- tenant t owns rows ``[t*S, (t+1)*S)``; its capacity ``cap_t`` splits
  ``ceil(cap_t / S)`` per row through the bank's BLOCKED capacity masks;
- queries gather the owner row only, per-tenant top-k reads the tenant's
  row slice only; the global ``topk`` speaks composite keys;
- cold tenants spill to a tagged flat numpy dict (``spill_rows``) and
  re-admit exactly (``admit_rows``: ``state.merge`` against the cleared
  rows, the rows' BLOCKED masks imposed again). Every row function here
  returns new tensors and writes into none it was given: a session's
  state may share its memory with the captured ingest's buffers;
- per-tenant quantiles run a quantile spec over composite keys: rank is
  a range difference inside the tenant's key range (``tenant_rank_many``),
  quantiles a lockstep search over the item part (``tenant_quantile_many``).
"""
from __future__ import annotations

import numbers
from typing import Any, Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..platform import DEFAULT_DEVICE
from . import bank as bk
from . import dyadic as dy
from . import state as st
from .blocks import block_update
from .state import BLOCKED, EMPTY, I32, INT_MAX, SketchState

# api.LAYOUT_FREQUENCY (api imports this module after its registry)
_LAYOUT_FREQUENCY = 1


# ---------------------------------------------------------------------------
# Composite routing keys
# ---------------------------------------------------------------------------

def tenant_bits_for(num_tenants: int) -> int:
    """High bits a composite key spends on the tenant id."""
    return (int(num_tenants) - 1).bit_length()


def pack_keys(tenants, items, item_bits: int):
    """Composite routing keys ``(tenant << item_bits) | item``.

    Host inputs give int64 (a malformed tenant/item pair then overflows
    visibly, and ``api.validate_block``'s int32 range check catches it);
    tensors give int32, as the spec's validation already guarantees
    ``tenant_bits + item_bits <= 31``.
    """
    if isinstance(tenants, torch.Tensor) or isinstance(items, torch.Tensor):
        dev = (tenants if isinstance(tenants, torch.Tensor) else items).device
        t = torch.as_tensor(tenants, device=dev).to(I32)
        x = torch.as_tensor(items, device=dev).to(I32)
        return (t << item_bits) | x
    t = np.asarray(tenants, np.int64)
    x = np.asarray(items, np.int64)
    return (t << item_bits) | x


def unpack_keys(keys, item_bits: int):
    """Inverse of :func:`pack_keys`: ``(tenants, items)``."""
    mask = (1 << item_bits) - 1
    return keys >> item_bits, keys & mask


# ---------------------------------------------------------------------------
# The multi-tenant bank
# ---------------------------------------------------------------------------

class TenantBank(NamedTuple):
    """One ``(T*S, k)`` bank holding every tenant's counters (the shard
    count and item bits live in the spec and the router)."""

    bank: SketchState

    @property
    def num_rows(self) -> int:
        return self.bank.ids.shape[0]


def init_tenants(caps: Union[int, Sequence[int]],
                 num_tenants: Optional[int] = None, num_shards: int = 1,
                 device=DEFAULT_DEVICE) -> TenantBank:
    """Empty multi-tenant bank; tenant t owns rows ``[t*S, (t+1)*S)``.

    ``caps``: one capacity for ``num_tenants`` tenants, or one per tenant.
    Each tenant's budget splits ``ceil(cap_t / S)`` per shard row, the
    split an independent ``SketchSpec(shards=S)`` sketch of ``cap_t``
    counters makes.
    """
    if isinstance(caps, numbers.Integral):
        if num_tenants is None or num_tenants < 1:
            raise ValueError("an int capacity needs num_tenants >= 1")
        caps = [int(caps)] * num_tenants
    else:
        caps = [int(c) for c in caps]
        if num_tenants is not None and num_tenants != len(caps):
            raise ValueError(f"{len(caps)} capacities for num_tenants="
                             f"{num_tenants}")
    row_caps = [-(-c // num_shards) for c in caps for _ in range(num_shards)]
    return TenantBank(bank=bk.init(row_caps, device=device))


def router_for(num_tenants: int, item_bits: int,
               num_shards: int = 1) -> bk.TenantRouter:
    """The routing companion of :func:`init_tenants`."""
    return bk.TenantRouter(num_tenants, item_bits, num_shards)


def update_block(tb: TenantBank, keys: torch.Tensor, weights: torch.Tensor,
                 router: bk.TenantRouter, variant: int = 2) -> TenantBank:
    """One partition-core update ingesting a composite-key block for all
    tenants (one kernel-1 launch on the card)."""
    return TenantBank(
        bank=bk.update_block_fused(tb.bank, keys, weights, router, variant))


def query_many_tenant(tb: TenantBank, keys: torch.Tensor,
                      router: bk.TenantRouter) -> torch.Tensor:
    """Estimated count per composite key, read from its owner row only."""
    keys = keys.to(I32)
    rows = bk.gather_rows(router.owner_of(keys), tb.num_rows)
    return bk.query_rows(tb.bank, rows, keys)


def _items_of(keys: torch.Tensor, item_bits: int) -> torch.Tensor:
    """The item part of composite keys; sentinels stay as they are."""
    return torch.where(keys >= 0, keys & ((1 << item_bits) - 1), keys)


def topk_tenant(tb: TenantBank, tenant, m: int, *, num_shards: int,
                item_bits: int):
    """One tenant's top-m (raw items, counts); never crosses tenants."""
    start = bk.slice_start(tenant, num_shards, tb.num_rows)
    sub = SketchState(*(t[start:start + num_shards] for t in tb.bank))
    keys, vals = bk.topk_bank(sub, m)
    return _items_of(keys, item_bits), vals


def topk_tenants(tb: TenantBank, tenants: torch.Tensor, m: int, *,
                 num_shards: int, item_bits: int):
    """Batched per-tenant top-m: one row gather of (n, S*k) answers every
    subscription of a service tick, then ``state.top_m`` along the last
    axis (lower index first among equal counts, as ``lax.top_k``).
    Returns ``(items, counts)`` of shape (n, m)."""
    tenants = tenants.to(I32)
    rows = (tenants[:, None] * num_shards
            + torch.arange(num_shards, dtype=I32, device=tenants.device))
    rows = bk.gather_rows(rows, tb.num_rows)
    n = tenants.shape[0]
    ids = tb.bank.ids[rows].reshape(n, -1)
    cnt = tb.bank.counts[rows].reshape(n, -1)
    score = torch.where(ids < 0, -2**31, cnt)
    idx = st.top_m(score, m)
    return (_items_of(ids.gather(1, idx), item_bits), score.gather(1, idx))


# ---------------------------------------------------------------------------
# Cold-row spill and exact re-admission
# ---------------------------------------------------------------------------

def tenant_rows(tenant: int, num_shards: int) -> np.ndarray:
    """The row indices tenant ``tenant`` owns (host-side helper)."""
    t = int(tenant)
    return np.arange(t * num_shards, (t + 1) * num_shards)


def _rows_on(bank: SketchState, rows) -> torch.Tensor:
    rows = torch.as_tensor(np.asarray(rows), device=bank.ids.device)
    return bk.gather_rows(rows, bank.ids.shape[0])


def _with_rows(bank: SketchState, rows: torch.Tensor,
               new: SketchState) -> SketchState:
    """A copy of ``bank`` with ``rows`` replaced by ``new``'s rows."""
    out = SketchState(*(t.clone() for t in bank))
    for t, v in zip(out, new):
        t[rows] = v.to(I32)
    return out


def extract_rows(bank: SketchState, rows) -> SketchState:
    """The rows' content (n, k): the spill payload."""
    rows = _rows_on(bank, rows)
    return SketchState(*(t[rows] for t in bank))


def clear_rows(bank: SketchState, rows) -> SketchState:
    """The bank with ``rows`` reset to empty, their BLOCKED capacity masks
    kept (a new bank; ``bank`` is not written)."""
    rows = _rows_on(bank, rows)
    blocked = bank.ids[rows] == BLOCKED
    return _with_rows(bank, rows, SketchState(
        ids=torch.where(blocked, BLOCKED, EMPTY),
        counts=torch.where(blocked, INT_MAX, 0),
        errors=torch.zeros_like(bank.errors[rows])))


def admit_rows(bank: SketchState, rows, spilled: SketchState) -> SketchState:
    """Merge a spilled row bundle back into its rows and impose the rows'
    capacity masks again (a new bank; ``bank`` is not written).

    Rows pair exactly (both sides only held keys routed to that row).
    Against cleared rows, which the service re-admits before any new
    traffic reaches the tenant, the merge is content-exact: the empty
    side adds no cross term and the merged row packs the spilled items
    (at most cap of them) at its front, so the BLOCKED tail drops nothing.
    Against live rows it is the capacity-``cap`` mergeable-summaries
    merge.
    """
    rows = _rows_on(bank, rows)
    live = SketchState(*(t[rows] for t in bank))
    over = live.ids == BLOCKED
    merged = st.merge(live, SketchState(*(t.to(device=bank.ids.device,
                                                dtype=I32) for t in spilled)))
    return _with_rows(bank, rows, SketchState(
        ids=torch.where(over, BLOCKED, merged.ids),
        counts=torch.where(over, INT_MAX, merged.counts),
        errors=torch.where(over, 0, merged.errors)))


def spill_rows(bank: SketchState, tenant: int, num_shards: int,
               item_bits: int) -> Dict[str, Any]:
    """Tagged flat numpy dict (npz-safe) of one tenant's rows: the
    frequency triple of its (S, k) row slice with ``tenant``, ``shards``
    and ``item_bits``, the reference's spill format."""
    sp = extract_rows(bank, tenant_rows(tenant, num_shards))
    return {
        "layout": np.int32(_LAYOUT_FREQUENCY),
        "tenant": np.int32(tenant),
        "shards": np.int32(num_shards),
        "item_bits": np.int32(item_bits),
        "ids": sp.ids.cpu().numpy(),
        "counts": sp.counts.cpu().numpy(),
        "errors": sp.errors.cpu().numpy(),
    }


def admit_spill(bank: SketchState, d: Dict[str, Any]) -> SketchState:
    """Re-admit a :func:`spill_rows` dict (of either package) into its
    tenant's rows."""
    for key in ("tenant", "shards", "ids", "counts", "errors"):
        if key not in d:
            raise ValueError(
                f"spill dict is missing key {key!r} (truncated write?); a "
                f"tenant spill carries tenant/shards/item_bits + the "
                f"ids/counts/errors triple")
    rows = tenant_rows(int(np.asarray(d["tenant"])),
                       int(np.asarray(d["shards"])))
    spilled = SketchState(*(torch.as_tensor(
        np.asarray(d[key]).astype(np.int32), device=bank.ids.device)
        for key in ("ids", "counts", "errors")))
    return admit_rows(bank, rows, spilled)


# ---------------------------------------------------------------------------
# Per-tenant quantiles over a composite-key dyadic bank
# ---------------------------------------------------------------------------

def _base(state: dy.DyadicState, tenant, item_bits: int) -> torch.Tensor:
    """The tenant's first composite key, a 0-d int32 tensor."""
    return torch.as_tensor(tenant, device=state.mass.device).to(I32) \
        << item_bits


def _range_ranks(index, state: dy.DyadicState, base: torch.Tensor,
                 item_bits: int):
    """rank(base - 1) and the tenant's mass rank(base + 2^bits - 1) -
    rank(base - 1) from the indexed layers."""
    edges = torch.stack([base - 1, base + ((1 << item_bits) - 1)])
    r = dy._rank_from(index, state.mass, state.bits, edges)
    return r[0], r[1] - r[0]


def tenant_rank_many(state: dy.DyadicState, tenant, xs: torch.Tensor,
                     item_bits: int) -> torch.Tensor:
    """Per-tenant rank(x) = |{v <= x, v in tenant}| as a range difference.

    The tenant's values occupy the key range [base, base + 2^item_bits),
    so its rank is rank(base + x) - rank(base - 1) (0 for tenant 0's left
    edge, rank(-1)). The error adds the two endpoints' estimates: at most
    twice the single-rank bound.
    """
    base = _base(state, tenant, item_bits)
    lo = dy.rank_many(state, (base - 1)[None])[0]
    return dy.rank_many(state, base + xs.to(I32)) - lo


def tenant_mass(state: dy.DyadicState, tenant, item_bits: int) -> torch.Tensor:
    """One tenant's live mass |F_t|₁ (the range mass of its key range)."""
    index = dy._layer_index(state.bank)
    return _range_ranks(index, state, _base(state, tenant, item_bits),
                        item_bits)[1]


def tenant_quantile_many(state: dy.DyadicState, tenant, qs: torch.Tensor,
                         item_bits: int) -> torch.Tensor:
    """Per-tenant quantiles: the lockstep search over the item part only,
    [0, 2^item_bits) in item_bits + 1 rounds, with the tenant's offset
    rank and range mass (the layers indexed once for all rounds)."""
    index = dy._layer_index(state.bank)
    base = _base(state, tenant, item_bits)
    lo, mass = _range_ranks(index, state, base, item_bits)

    def rank_fn(xs):
        return dy._rank_from(index, state.mass, state.bits, base + xs) - lo

    return dy.lockstep_quantile_search(rank_fn, mass, item_bits,
                                       qs.to(torch.float32))


# ---------------------------------------------------------------------------
# The per-row oracle
# ---------------------------------------------------------------------------

def reference_row_update(row_state: SketchState, keys, weights,
                         router: bk.TenantRouter, row: int,
                         variant: int = 2) -> SketchState:
    """One row's independent step: ``blocks.block_update`` on the row's own
    routed view of a raw composite-key block, the ground truth the fused
    update must match bit for bit on every row (usable on a row sample)."""
    dev = row_state.ids.device
    keys, weights = (x.to(dev, I32) if isinstance(x, torch.Tensor) else
                     torch.as_tensor(np.asarray(x).astype(np.int32),
                                     device=dev) for x in (keys, weights))
    order = bk.sort_block(keys, router.universe_bits)
    s_keys = keys[order]
    w_row = torch.where(router.owner_of(s_keys) == row, weights[order], 0)
    return block_update(row_state, s_keys, w_row, variant, assume_sorted=True)


def update_serial_reference(tb: TenantBank, keys, weights,
                            router: bk.TenantRouter,
                            variant: int = 2) -> TenantBank:
    """Reference: route, then update every row on its own, one by one."""
    outs = [reference_row_update(SketchState(*(t[r] for t in tb.bank)), keys,
                                 weights, router, r, variant)
            for r in range(router.num_rows)]
    return TenantBank(bank=SketchState(*(torch.stack(f) for f in zip(*outs))))


# ---------------------------------------------------------------------------
# The SketchSpec(tenants=...) adapter
# ---------------------------------------------------------------------------

class TenantAdapter:
    """``SketchSpec(tenants=T)``: one (T*S, k) bank (``shards`` means
    per-tenant hash shards). The tenant count comes from the state's
    shape, never from ``spec.tenants``: the compiled-ingest cache keys
    tenant specs that share a layout onto one cell
    (``session.ingest_cache_spec``), whose spec says ``tenants=1``."""

    def _shards(self, spec) -> int:
        return spec.shards or 1

    def _tenants_of(self, spec, state) -> int:
        return state.bank.ids.shape[0] // self._shards(spec)

    def _router(self, spec, state) -> bk.TenantRouter:
        return bk.TenantRouter(self._tenants_of(spec, state), spec.bits,
                               self._shards(spec))

    def make(self, spec, device) -> TenantBank:
        caps = spec.tenant_caps
        if caps is None:
            # the total budget split evenly, ceil so each tenant has one
            caps = [-(-spec.capacity // spec.tenants)] * spec.tenants
        return init_tenants(list(caps), num_shards=self._shards(spec),
                            device=device)

    def device_of(self, state) -> torch.device:
        return state.bank.ids.device

    def update(self, spec, state, items, weights):
        return update_block(state, items, weights, self._router(spec, state),
                            spec.variant_id)

    def query_many(self, spec, state, items):
        return query_many_tenant(state, items, self._router(spec, state))

    def topk(self, spec, state, m):
        """Global top-m across all tenants, in composite keys."""
        return bk.topk_bank(state.bank, m)

    def topk_tenant(self, spec, state, tenant, m):
        return topk_tenant(state, tenant, m, num_shards=self._shards(spec),
                           item_bits=spec.bits)

    def rank_many(self, spec, state, xs):
        raise ValueError(
            f"rank/quantile queries need kind='quantile'; this spec is "
            f"kind={spec.kind!r}. Tenant quantiles run on a quantile spec "
            f"over composite keys (tenant_rank_many / "
            f"tenant_quantile_many).")

    quantile_many = rank_many

    def merge(self, spec, a, b):
        # rows pair exactly (one router); merged rows hold up to k
        return TenantBank(bank=bk.merge_banks(a.bank, b.bank))

    def consolidate(self, spec, state):
        # folding rows would collapse the tenancy; the compact per-tenant
        # view is spill_rows / topk_tenant
        return state

    def save(self, spec, state) -> Dict[str, Any]:
        return {
            "layout": np.int32(_LAYOUT_FREQUENCY),
            "ids": state.bank.ids.cpu().numpy(),
            "counts": state.bank.counts.cpu().numpy(),
            "errors": state.bank.errors.cpu().numpy(),
            "tenants": np.int32(self._tenants_of(spec, state)),
            "shards": np.int32(spec.shards or 0),
            "item_bits": np.int32(spec.bits),
        }

    def restore(self, spec, d, device) -> TenantBank:
        fields = SketchState(*(torch.as_tensor(
            np.asarray(d[key]).astype(np.int32), device=device)
            for key in ("ids", "counts", "errors")))
        want = spec.tenants * self._shards(spec)
        got = fields.ids.shape[0]
        if got != want:
            raise ValueError(
                f"checkpoint has {got} rows but the spec's layout "
                f"(tenants={spec.tenants} x shards={self._shards(spec)}) "
                f"needs {want}; restore through infer_spec(spec, d)")
        return TenantBank(bank=fields)


__all__ = ["TenantBank", "TenantAdapter", "tenant_bits_for", "pack_keys",
           "unpack_keys", "init_tenants", "router_for", "update_block",
           "query_many_tenant", "topk_tenant", "topk_tenants", "tenant_rows",
           "extract_rows", "clear_rows", "admit_rows", "spill_rows",
           "admit_spill", "tenant_rank_many", "tenant_mass",
           "tenant_quantile_many", "reference_row_update",
           "update_serial_reference"]
