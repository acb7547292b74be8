"""SketchService: the multi-tenant sketch-serving loop.

Counterpart of ``repro/serve/sketch_service.py``. One service hosts one
``SketchSpec(tenants=T)`` layout, a single (T*S, k) bank, and turns
interleaved per-tenant traffic into a few block-sized updates per tick
(one kernel-1 launch each on the card) instead of one ingest per tenant.
Every stage of ``tick`` is batched across tenants:

1. re-admission: spilled tenants that this tick's traffic or queries
   touch come back first (``tenant.admit_spill``, exact), so no update or
   query sees a cold row;
2. coalesced ingest: every tenant's pending fragments (composite keys,
   packed at ``submit``) in tenant order, each followed by the window
   expiries that came due on that tenant's own FIFO
   (``StreamSession.schedule_batch``), chunked into zero-weight-padded
   blocks and fed through :class:`~repro_torch.sketch.session.BlockFeeder`
   (block i staged while block i-1 computes);
3. batched point queries: every ticket's keys in one ``api.query_many``
   on a device tensor, sliced back per ticket;
4. subscriptions: due top-k subscriptions in one row gather
   (``tenant.topk_tenants``) where every due one asks the same m, else
   per tenant; quantile subscriptions run the per-tenant lockstep search
   (``tenant.tenant_quantile_many``) on a composite-key dyadic bank;
5. eviction: tenants idle for ``spill_after`` ticks (no traffic, no
   subscription) spill their rows to tagged numpy dicts and their rows
   clear.

A tick is the consistency barrier: after ``tick()`` returns, every update
submitted before it is visible, exactly once, to every query it answers.
``save()`` bundles the session checkpoint with its schedule (per-tenant
FIFOs under the ``sched_batch_tenants`` tags), the spill store and the
tick cursor; ``load`` of that bundle resumes as if never interrupted.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..platform import DEFAULT_DEVICE
from ..sketch import api
from ..sketch import tenant as tn
from ..sketch.session import BlockFeeder, StreamSession


class QueryTicket:
    """One pending point query: resolved at the next ``tick``.

    ``result()`` ticks if the ticket is still open, so a query never sees
    a state older than the updates submitted before it. ``latency_s`` is
    resolve time minus submit time.
    """

    __slots__ = ("tenant", "items", "_service", "_value",
                 "t_submit", "t_resolve")

    def __init__(self, service: "SketchService", tenant: int,
                 items: np.ndarray):
        self._service = service
        self.tenant = int(tenant)
        self.items = items
        self._value: Optional[np.ndarray] = None
        self.t_submit = time.perf_counter()
        self.t_resolve: Optional[float] = None

    def result(self) -> np.ndarray:
        if self._value is None:
            self._service.tick()
        return self._value

    @property
    def resolved(self) -> bool:
        return self._value is not None

    @property
    def latency_s(self) -> float:
        if self.t_resolve is None:
            raise ValueError("ticket not resolved yet; call result() "
                             "or tick() first")
        return self.t_resolve - self.t_submit


class SketchService:
    """Multi-tenant serving front-end over one ``SketchSpec``.

    Frequency mode (``spec.tenants`` set): per-tenant counts and top-k on
    the (T*S, k) tenant bank, any registered variant (sspm, lazy, and the
    family's double and unbiased, whose rows stay resident: no spill).
    Quantile mode (``spec.kind ==
    'quantile'``): pass ``tenant_bits``, the split of the dyadic spec's
    keys into tenant and item; per-tenant quantile subscriptions, no
    top-k, no spill.

    ``window``: each tenant's bounded-deletion horizon in ticks (a tick's
    batch of tenant t expires after ``window`` further ticks with traffic
    from t). ``spill_after``: spill a tenant's rows after that many idle
    ticks. ``depth``: the feeder's in-flight depth. ``device``: where the
    bank lives (CUDA unless asked).
    """

    def __init__(self, spec: api.SketchSpec, *, block: int = 8192,
                 window: Optional[int] = None, depth: int = 2,
                 spill_after: Optional[int] = None,
                 tenant_bits: Optional[int] = None, donate: bool = True,
                 device=DEFAULT_DEVICE):
        if spec.kind == "quantile":
            if tenant_bits is None:
                raise ValueError(
                    "quantile-mode service needs tenant_bits: the dyadic "
                    "spec has no tenants axis, so the key split "
                    "(tenant_bits high | item_bits low) must be given")
            if spec.shards is not None:
                raise ValueError(
                    "quantile-mode service supports unsharded dyadic specs "
                    "only (tenant_rank_many reads one DyadicState)")
            if spill_after is not None:
                raise ValueError(
                    "spill is row-granular; the dyadic layout has no "
                    "per-tenant rows to spill — use spill_after=None")
            if tenant_bits < 1 or tenant_bits >= spec.bits:
                raise ValueError(
                    f"tenant_bits={tenant_bits} must leave item bits: "
                    f"0 < tenant_bits < bits={spec.bits}")
            self.num_tenants = 1 << tenant_bits
            self.item_bits = spec.bits - tenant_bits
        else:
            if spec.tenants is None:
                raise ValueError(
                    "frequency-mode service needs a tenant layout: build "
                    "the spec with tenants=T (SketchSpec(tenants=...))")
            if tenant_bits is not None:
                raise ValueError(
                    "tenant_bits is the quantile-mode key split; frequency "
                    "specs carry tenants= in the spec itself")
            self.num_tenants = spec.tenants
            self.item_bits = spec.bits
        self.spec = spec
        self.session = StreamSession(spec, block=block, window=window,
                                     donate=donate, device=device)
        self.device = self.session.device
        self.feeder = BlockFeeder(self.session, depth=depth)
        self.spill_after = spill_after
        if spill_after is not None and not self._spillable():
            raise ValueError(
                f"spill_after needs the base tenant-bank layout (variant "
                f"sspm/lazy); variant={spec.variant!r} keeps all rows "
                f"resident — use spill_after=None")
        # per-tenant pending (keys, weights) fragments
        self._pending: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        self._tickets: List[QueryTicket] = []
        self._topk_subs: Dict[int, Dict[str, Any]] = {}
        self._quant_subs: Dict[int, Dict[str, Any]] = {}
        self._spilled: Dict[int, Dict[str, Any]] = {}
        self._last_active: Dict[int, int] = {}
        self._tick = 0
        # a list here records every (items, weights) block fed, so a
        # parity check can replay the blocks through the per-row oracle
        self.trace_blocks: Optional[List[Tuple[np.ndarray, np.ndarray]]] \
            = None
        self.stats = {"updates": 0, "queries": 0, "ticks": 0, "blocks": 0,
                      "spills": 0, "admits": 0}

    def _spillable(self) -> bool:
        return isinstance(self.session.state, tn.TenantBank)

    @property
    def tick_count(self) -> int:
        return self._tick

    # -- traffic intake ----------------------------------------------------

    def _check_tenant(self, tenant: int) -> int:
        tenant = int(tenant)
        if not 0 <= tenant < self.num_tenants:
            raise ValueError(
                f"tenant {tenant} out of range [0, {self.num_tenants})")
        return tenant

    def _pack(self, tenant: int, items) -> np.ndarray:
        items = api.host_array(items).ravel()
        if len(items) and (items.min() < 0
                           or items.max() >= (1 << self.item_bits)):
            raise ValueError(
                f"items must lie in [0, 2^{self.item_bits}) — larger ids "
                f"would alias another tenant's key range; rebucket or "
                f"raise bits")
        return tn.pack_keys(np.full(len(items), tenant, np.int64),
                            items.astype(np.int64), self.item_bits)

    def submit(self, tenant: int, items, weights=None) -> None:
        """Queue one tenant's signed weighted updates for the next tick
        (``weights=None``: unit inserts; negative weights delete)."""
        tenant = self._check_tenant(tenant)
        keys = self._pack(tenant, items)
        weights = (np.ones(len(keys), np.int32) if weights is None
                   else api.host_array(weights).ravel())
        api.validate_block(self.spec, keys, weights)
        self._pending.setdefault(tenant, []).append(
            (keys.astype(np.int32), weights.astype(np.int32)))
        self.stats["updates"] += len(keys)

    def query(self, tenant: int, items) -> QueryTicket:
        """Point-query estimates for one tenant's raw items; resolved at
        the next ``tick`` (or on ``result()``)."""
        tenant = self._check_tenant(tenant)
        items = api.host_array(items).ravel()
        ticket = QueryTicket(self, tenant, items)
        self._tickets.append(ticket)
        self.stats["queries"] += len(items)
        return ticket

    # -- continuous subscriptions ------------------------------------------

    def subscribe_topk(self, tenant: int, m: int, every: int = 1) -> None:
        """Refresh the tenant's top-m every ``every`` ticks
        (``topk_result``)."""
        if self.spec.kind != "frequency":
            raise ValueError("top-k subscriptions need a frequency spec")
        tenant = self._check_tenant(tenant)
        self._topk_subs[tenant] = {
            "m": int(m), "every": max(1, int(every)),
            "due": self._tick, "value": None}

    def subscribe_quantile(self, tenant: int, qs, every: int = 1) -> None:
        """Refresh the tenant's quantiles every ``every`` ticks
        (``quantile_result``)."""
        if self.spec.kind != "quantile":
            raise ValueError(
                "quantile subscriptions need a quantile-mode service "
                "(SketchSpec(kind='quantile') + tenant_bits)")
        tenant = self._check_tenant(tenant)
        self._quant_subs[tenant] = {
            "qs": np.asarray(qs, np.float32).ravel(),
            "every": max(1, int(every)), "due": self._tick, "value": None}

    def unsubscribe(self, tenant: int) -> None:
        self._topk_subs.pop(int(tenant), None)
        self._quant_subs.pop(int(tenant), None)

    def topk_result(self, tenant: int):
        return self._topk_subs[int(tenant)]["value"]

    def quantile_result(self, tenant: int):
        return self._quant_subs[int(tenant)]["value"]

    # -- the serving loop --------------------------------------------------

    def tick(self) -> None:
        """One batched service step (the module docstring's stages)."""
        # 1) exact re-admission before any of this tick's work
        touched = set(self._pending) | {t.tenant for t in self._tickets}
        for t in sorted(touched & set(self._spilled)):
            self._admit(t)
        # 2) coalesce updates and due window expiries across tenants
        frags_i: List[np.ndarray] = []
        frags_w: List[np.ndarray] = []
        for t in sorted(self._pending):
            parts = self._pending[t]
            ki = (np.concatenate([i for i, _ in parts])
                  if len(parts) > 1 else parts[0][0])
            kw = (np.concatenate([w for _, w in parts])
                  if len(parts) > 1 else parts[0][1])
            frags_i.append(ki)
            frags_w.append(kw)
            # the tick's batch ages on tenant t's own horizon; expiries
            # due now join the stream after it
            for di, dw in self.session.schedule_batch(ki, kw, tenant=t):
                frags_i.append(di)
                frags_w.append(dw)
            self._last_active[t] = self._tick
        self._pending.clear()
        if frags_i:
            self._ingest(np.concatenate(frags_i), np.concatenate(frags_w))
        # 3) every point query in one owner-row gather
        if self._tickets:
            keys = np.concatenate([self._pack(t.tenant, t.items)
                                   for t in self._tickets])
            est = api.query_many(
                self.spec, self.session.state,
                torch.from_numpy(keys.astype(np.int32)).to(self.device)
            ).cpu().numpy()
            now = time.perf_counter()
            s = 0
            for t in self._tickets:
                n = len(t.items)
                t._value = est[s:s + n]
                t.t_resolve = now
                s += n
            self._tickets.clear()
        # 4) due subscriptions, batched where the layout allows
        self._refresh_subscriptions()
        # 5) evict cold tenants
        if self.spill_after is not None:
            self._spill_idle()
        self._tick += 1
        self.stats["ticks"] += 1

    def _ingest(self, items: np.ndarray, weights: np.ndarray) -> None:
        """The tick's stream in zero-weight-padded blocks through the
        feeder; the flush is the tick's barrier."""
        B = self.session.block
        for s in range(0, len(items), B):
            ci, cw = items[s:s + B], weights[s:s + B]
            pad = B - len(ci)
            if pad:
                ci = np.pad(ci, (0, pad))
                cw = np.pad(cw, (0, pad))
            if self.trace_blocks is not None:
                self.trace_blocks.append((ci.copy(), cw.copy()))
            self.feeder.feed(ci, cw)
            self.stats["blocks"] += 1
        self.feeder.flush()

    def _refresh_subscriptions(self) -> None:
        due_topk = [t for t, s in self._topk_subs.items()
                    if self._tick >= s["due"] and t not in self._spilled]
        if due_topk:
            ms = {self._topk_subs[t]["m"] for t in due_topk}
            if self._spillable() and len(ms) == 1:
                items, vals = tn.topk_tenants(
                    self.session.state,
                    torch.tensor(due_topk, dtype=torch.int32,
                                 device=self.device),
                    ms.pop(), num_shards=self.spec.shards or 1,
                    item_bits=self.item_bits)
                items, vals = items.cpu().numpy(), vals.cpu().numpy()
                for i, t in enumerate(due_topk):
                    self._topk_subs[t]["value"] = (items[i], vals[i])
            else:
                for t in due_topk:
                    sub = self._topk_subs[t]
                    ids, vals = api.tenant_topk(
                        self.spec, self.session.state, t, sub["m"])
                    sub["value"] = (ids.cpu().numpy(), vals.cpu().numpy())
            for t in due_topk:
                self._topk_subs[t]["due"] = (self._tick
                                             + self._topk_subs[t]["every"])
        for t, sub in self._quant_subs.items():
            if self._tick < sub["due"]:
                continue
            sub["value"] = self._quantiles(t, sub["qs"])
            sub["due"] = self._tick + sub["every"]

    def _quantiles(self, tenant: int, qs: np.ndarray) -> np.ndarray:
        return tn.tenant_quantile_many(
            self.session.state, tenant,
            torch.from_numpy(np.asarray(qs, np.float32).ravel()).to(
                self.device), self.item_bits).cpu().numpy()

    def _spill_idle(self) -> None:
        keep = set(self._topk_subs) | set(self._quant_subs) \
            | set(self._pending)
        for t, last in list(self._last_active.items()):
            if (t in keep or t in self._spilled
                    or self._tick - last < self.spill_after):
                continue
            self._spill(t)

    def _spill(self, tenant: int) -> None:
        shards = self.spec.shards or 1
        bank = self.session.state.bank
        self._spilled[tenant] = tn.spill_rows(bank, tenant, shards,
                                              self.item_bits)
        self.session.state = tn.TenantBank(
            bank=tn.clear_rows(bank, tn.tenant_rows(tenant, shards)))
        self.stats["spills"] += 1

    def _admit(self, tenant: int) -> None:
        bank = tn.admit_spill(self.session.state.bank,
                              self._spilled.pop(tenant))
        self.session.state = tn.TenantBank(bank=bank)
        self._last_active[tenant] = self._tick
        self.stats["admits"] += 1

    # -- synchronous conveniences ------------------------------------------

    def _settle(self, tenant: Optional[int] = None) -> None:
        if self._pending or self._tickets:
            self.tick()
        if tenant is not None and tenant in self._spilled:
            self._admit(tenant)

    def topk(self, tenant: int, m: int):
        """The tenant's current top-m (raw items, counts); settles pending
        traffic first."""
        tenant = self._check_tenant(tenant)
        self._settle(tenant)
        ids, vals = api.tenant_topk(self.spec, self.session.state, tenant, m)
        return ids.cpu().numpy(), vals.cpu().numpy()

    def quantile(self, tenant: int, qs) -> np.ndarray:
        """The tenant's current quantiles (quantile mode); settles first."""
        tenant = self._check_tenant(tenant)
        self._settle(tenant)
        return self._quantiles(tenant, qs)

    # -- crash / resume ----------------------------------------------------

    def save(self) -> Dict[str, Any]:
        """Checkpoint bundle: the session with its per-tenant schedule, the
        spill store and the tick cursor. Pending (unticked) traffic and
        open tickets are not in it: a tick is the durability boundary, as
        only the tick that ingests a request acknowledges it."""
        return {
            "session": self.session.save(include_schedule=True),
            "spilled": {int(t): dict(d) for t, d in self._spilled.items()},
            "tick": int(self._tick),
            "last_active": {int(t): int(v)
                            for t, v in self._last_active.items()},
        }

    def load(self, d: Dict[str, Any]) -> None:
        self.session.load(d["session"])
        self.feeder = BlockFeeder(self.session, depth=self.feeder.depth)
        self._spilled = {int(t): dict(v) for t, v in d["spilled"].items()}
        self._last_active = {int(t): int(v)
                             for t, v in d["last_active"].items()}
        self._tick = int(d["tick"])
        self._pending.clear()
        self._tickets.clear()


__all__ = ["QueryTicket", "SketchService"]
