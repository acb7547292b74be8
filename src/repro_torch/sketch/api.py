"""One spec-driven front-end over the port's SpaceSaving± layouts.

Counterpart of ``repro/sketch/api.py``, every layout the reference
registers, on every backend the reference runs it:

- ``kind="frequency"``, plain (``shards=None``) or hash-sharded
  (``shards=S``), variants "sspm" and "lazy", on ``"bank"`` (the
  default: the partition core, kernel 1 on the card), ``"block"`` (the
  two-phase block update), ``"kernel"`` (the fused kernel on the routed
  views) or ``"serial"`` (the scan over each block's uniques; sharded,
  the per-shard oracle);
- the family (``sketch/family.py``): ``variant="double"`` and
  ``"unbiased"`` (two coupled banks, plain, sharded or multi-tenant) and
  ``backend="crprecis"`` (plain sspm specs);
- ``kind="frequency"`` with ``tenants=T`` (``sketch/tenant.py``): one
  (T·S, k) bank ingesting composite keys ``(tenant << bits) | item`` on
  ``"bank"``, per-tenant reads through ``tenant_topk``;
- ``kind="quantile"`` (Dyadic SpaceSaving±, ``sketch/dyadic.py``) on
  ``"bank"`` (the dense core), ``"block"``, ``"kernel"`` or
  ``"serial"``, and its shard × level bank (``shards=S``,
  ``sketch/dyadic_sharded.py``) on ``"bank"``, with the rank and
  quantile queries.

``SketchSpec`` keeps the reference's fields, defaults and checks.
Adapters are looked up in a registry keyed as the reference's
(``register_adapter``, ``adapter_for``). Checkpoints are the reference's
tagged numpy dicts (layout tags 1-4), so a state saved by either package
restores in the other.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.quantiles import dyadic_layer_capacities
from ..core.spacesaving import capacity_for
from ..kernels.sketch_update.ops import sketch_block_update_fused
from ..platform import DEFAULT_DEVICE, resolve_device
from . import bank as bk
from . import blocks
from . import dyadic as dy
from . import dyadic_sharded as dysh
from . import sharded as shd
from . import state as st
from .bank import HashShardRouter
from .state import VARIANT_LAZY, VARIANT_SSPM, SketchState

KINDS = ("frequency", "quantile")
# variant name -> engine-layer integer; the family's banks run plain
# SpaceSaving updates on insert-only streams (reference api.py:66-73)
VARIANTS = {"sspm": VARIANT_SSPM, "lazy": VARIANT_LAZY,
            "double": VARIANT_SSPM, "unbiased": VARIANT_SSPM}
FAMILY_VARIANTS = ("double", "unbiased")
BACKENDS = ("bank", "block", "kernel", "serial")

# the reference's integer layout tags (api.py:79-82)
LAYOUT_FREQUENCY = 1
LAYOUT_QUANTILE = 2
LAYOUT_DOUBLE = 3     # two coupled banks (Double / unbiased SpaceSaving±)
LAYOUT_CRPRECIS = 4   # CR-precis prime-modulus counter array


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Frozen description of one SpaceSaving± summary.

    Size with exactly one of ``k`` (total live counters, split per shard,
    or per layer for quantile kinds) or ``eps`` (+ ``alpha``, the paper's
    Thm 2/4 and §4.2 prescriptions). ``bits`` bounds the item universe to
    [0, 2^bits): required for quantile kinds (it fixes the layer count),
    optional for frequency kinds (it enables the packed single-sort
    router). ``backend`` picks the execution path: ``"bank"`` (the
    default, the reference's production path), ``"block"`` and
    ``"kernel"`` give the same state, bit for bit, the CUDA kernels on
    the card and their plain PyTorch versions on the CPU; ``"serial"``,
    the reference's A/B baseline, scans each block's uniques in id order
    and so differs from them where a block evicts (as the reference's
    does).
    ``backends_for(kind, shards)`` lists what a layout runs.

    ``tenants=T`` selects the multi-tenant layout (``sketch/tenant.py``):
    one (T·S, k) bank of composite keys ``(tenant << bits) | item``, rows
    tenant-major, ``shards`` meaning per-tenant hash shards and ``bits``
    required. Size it with ``k``/``eps`` (split evenly across tenants) or
    ``tenant_caps`` (one capacity per tenant).
    """

    kind: str = "frequency"
    k: Optional[int] = None
    eps: Optional[float] = None
    alpha: float = 2.0
    variant: str = "sspm"
    shards: Optional[int] = None
    bits: Optional[int] = None
    backend: str = "bank"
    tenants: Optional[int] = None
    tenant_caps: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"SketchSpec.kind must be one of {KINDS}, got {self.kind!r}")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"SketchSpec.variant must be one of {tuple(VARIANTS)}, got "
                f"{self.variant!r} (the integer VARIANT_* constants belong "
                f"to the engine layer; the spec speaks names)")
        if self.backend not in BACKENDS + ("crprecis",):
            raise ValueError(
                f"SketchSpec.backend must be one of "
                f"{BACKENDS + ('crprecis',)}, got {self.backend!r}")
        if self.tenant_caps is not None and not isinstance(self.tenant_caps,
                                                           tuple):
            # the spec stays hashable (a cache key): any sequence is
            # stored as the canonical tuple
            object.__setattr__(self, "tenant_caps",
                               tuple(int(c) for c in self.tenant_caps))
        n_sizing = ((self.k is not None) + (self.eps is not None)
                    + (self.tenant_caps is not None))
        if n_sizing != 1:
            raise ValueError(
                "size the spec with exactly one of k (total counters), "
                "eps (+ alpha) or tenant_caps (per-tenant counters); got "
                f"k={self.k}, eps={self.eps}, tenant_caps={self.tenant_caps}")
        if self.kind == "quantile" and self.bits is None:
            raise ValueError(
                "kind='quantile' needs bits (the dyadic universe bound "
                "[0, 2^bits) fixes the layer count)")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1 or None, got {self.shards}")
        if self.variant in FAMILY_VARIANTS and self.kind != "frequency":
            raise ValueError(
                f"variant={self.variant!r} (the Double/unbiased "
                f"SpaceSaving± family) is a frequency-kind layout; "
                f"kind={self.kind!r} does not support it")
        self._check_tenants()
        supported = backends_for(self.kind, self.shards, self.variant,
                                 self.tenants)
        if self.backend not in supported:
            raise ValueError(
                f"backend {self.backend!r} is not supported for "
                f"kind={self.kind!r}, shards={self.shards}, "
                f"variant={self.variant!r}, tenants={self.tenants}; "
                f"supported: {supported}")

    def _check_tenants(self) -> None:
        """The multi-tenant layout's conditions (reference ``api.py:168``):
        a frequency kind with ``bits``, composite keys within int32, and
        one positive capacity per tenant in ``tenant_caps``."""
        if self.tenant_caps is not None and self.tenants is None:
            raise ValueError(
                "tenant_caps sizes the multi-tenant layout; set tenants=T "
                "(the per-tenant capacity list has no meaning without it)")
        if self.tenants is None:
            return
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1 or None, got {self.tenants}")
        if self.kind != "frequency":
            raise ValueError(
                "tenants=T is a frequency-kind layout; per-tenant quantiles "
                "run a plain quantile spec over composite keys instead "
                "(repro_torch.sketch.tenant.tenant_rank_many)")
        if self.bits is None:
            raise ValueError(
                "tenants=T needs bits (the per-tenant item-universe bound "
                "composite keys (tenant << bits) | item are packed against)")
        tb = (self.tenants - 1).bit_length()
        if tb + self.bits > 31:
            raise ValueError(
                f"composite keys need tenant_bits + bits <= 31 to fit the "
                f"int32 id dtype; got tenants={self.tenants} ({tb} bits) "
                f"with bits={self.bits}")
        if self.tenant_caps is not None:
            if len(self.tenant_caps) != self.tenants:
                raise ValueError(
                    f"tenant_caps has {len(self.tenant_caps)} entries for "
                    f"tenants={self.tenants}")
            if min(self.tenant_caps) < 1:
                raise ValueError(
                    f"every tenant needs >= 1 counter; got "
                    f"min(tenant_caps)={min(self.tenant_caps)}")
            if self.variant in FAMILY_VARIANTS:
                raise ValueError(
                    "tenant_caps (per-tenant BLOCKED masks) is a "
                    "base-layout feature; the family's k_I/k_D split "
                    "sizes evenly — use k or eps with "
                    f"variant={self.variant!r}")

    @property
    def variant_id(self) -> int:
        """The engine-layer integer variant (VARIANT_LAZY / VARIANT_SSPM)."""
        return VARIANTS[self.variant]

    @property
    def capacity(self) -> int:
        """Resolved total live-counter budget of one frequency summary."""
        if self.kind != "frequency":
            raise ValueError(
                "capacity is the frequency-kind budget; quantile kinds size "
                "per layer — use layer_capacities()")
        if self.tenant_caps is not None:
            return int(sum(self.tenant_caps))
        if self.k is not None:
            return int(self.k)
        return capacity_for(self.eps, self.alpha,
                            "lazy" if self.variant == "lazy" else "ss_pm")

    def layer_capacities(self) -> list:
        """Per-layer counters of one quantile summary."""
        if self.kind != "quantile":
            raise ValueError("layer_capacities() applies to quantile kinds")
        return dyadic_layer_capacities(
            self.bits, total_counters=self.k, eps=self.eps, alpha=self.alpha)


def backends_for(kind: str, shards: Optional[int], variant: str = "sspm",
                 tenants: Optional[int] = None) -> Tuple[str, ...]:
    """The execution paths a (kind, sharded?, variant, tenants?) layout
    supports, as the reference's (``api.py:243``): every backend for the
    base layouts but the sharded quantile bank (``"bank"`` only), CR-
    precis beside them for plain sspm frequency specs, ``"bank"`` for the
    family and tenant layouts."""
    if tenants or variant in FAMILY_VARIANTS:
        return ("bank",) if kind == "frequency" else ()
    if kind == "quantile" and shards:
        return ("bank",)
    if kind == "frequency" and not shards:
        return BACKENDS + (("crprecis",) if variant == "sspm" else ())
    return BACKENDS


def variants_for(kind: str) -> Tuple[str, ...]:
    """Variant names a kind supports, as the reference's (``api.py:273``):
    the family variants are frequency-only."""
    return tuple(VARIANTS) if kind == "frequency" else ("sspm", "lazy")


# ---------------------------------------------------------------------------
# Input validation: one home for the block conventions (api.py:282)
# ---------------------------------------------------------------------------

def validate_block(spec: SketchSpec, items, weights, *,
                   prior_mass: int = 0) -> int:
    """Check one host (numpy) block against the package conventions.

    Ids are non-negative ints (negative ids are sentinels) that fit
    int32; weight > 0 inserts, < 0 deletes, 0 pads; the block's weight
    magnitudes sum within int32, no item's net weight could carry a
    counter already holding up to ``prior_mass`` past int32, for
    quantile kinds every real item lies in [0, 2^bits), and for tenant
    specs every real composite key in [0, tenants << bits). Returns the
    block's positive mass.
    """
    i_shape = np.shape(items)
    w_shape = np.shape(weights)
    if len(i_shape) != 1:
        raise ValueError(
            f"items must be 1-D (one block of ids), got shape {i_shape}")
    if i_shape != w_shape:
        raise ValueError(
            f"items/weights length mismatch: {i_shape} vs {w_shape}; pad "
            f"the short side with weight-0 entries (the padding convention)")
    i = np.asarray(items)
    w = np.asarray(weights)
    if i.dtype.kind not in "iu" or w.dtype.kind not in "iu":
        raise ValueError(
            f"items/weights must be integer arrays (ids and signed counts), "
            f"got dtypes {i.dtype}/{w.dtype}")
    # the reference's checks, each a reduction over one pass: with the
    # device no longer waiting on launches, this is the ingest's host cost
    real = w != 0
    i_real = i if real.all() else i[real]
    if i_real.size and i_real.min() < 0:
        bad = int(i_real[i_real < 0][0])
        raise ValueError(
            f"negative item id {bad}: ids must be >= 0 (negative ids are "
            f"the EMPTY/BLOCKED sentinels). To pad a block, keep any id "
            f"and set its weight to 0.")
    int32_max = np.iinfo(np.int32).max
    i64 = i_real.astype(np.int64, copy=False)
    if i64.size and i64.max() > int32_max:
        bad = int(i_real[i64 > int32_max][0])
        raise ValueError(
            f"item id {bad} exceeds int32 (the device-side id dtype); "
            f"hash or re-bucket ids into [0, 2^31) before ingest")
    w64 = w.astype(np.int64, copy=False)
    magnitudes = np.abs(w64)
    if magnitudes.max(initial=0) > int32_max:
        raise ValueError("weights must fit int32 (the device-side count dtype)")
    wsum = int(magnitudes.sum())
    if wsum > int32_max:
        raise ValueError(
            f"block weight magnitudes sum to {wsum} > int32 max "
            f"({int32_max}): split the block or rescale the weights")
    # |w| + w = 2 max(w, 0): the positive mass from the two sums
    pos_mass = (wsum + int(w64.sum())) // 2
    if prior_mass and pos_mass:
        uniq, inv = np.unique(i[real], return_inverse=True)
        net = np.zeros(uniq.size, dtype=np.int64)
        np.add.at(net, inv, w[real].astype(np.int64))
        worst = int(net.max(initial=0))
        if worst > 0 and int(prior_mass) + worst > int32_max:
            bad = int(uniq[int(np.argmax(net))])
            raise ValueError(
                f"item {bad} accumulates net weight {worst} in this block "
                f"while the target state already holds up to "
                f"{int(prior_mass)} positive mass: its counter could cross "
                f"int32 max ({int32_max}). Split the block, rescale "
                f"weights, or checkpoint-and-reset the session.")
    if spec.kind == "quantile" and i64.size and i64.max() >= 1 << spec.bits:
        bad = int(i_real[i64 >= 1 << spec.bits][0])
        raise ValueError(
            f"item {bad} is outside the dyadic universe [0, 2^{spec.bits}"
            f"); raise SketchSpec.bits or bucket ids before ingest")
    if spec.tenants is not None and i64.size \
            and i64.max() >= spec.tenants << spec.bits:
        bad = int(i_real[i64 >= spec.tenants << spec.bits][0])
        raise ValueError(
            f"composite key {bad} is outside the tenant key space "
            f"[0, {spec.tenants} << {spec.bits}); pack keys with "
            f"tenant.pack_keys(tenant, item, item_bits={spec.bits}) and keep "
            f"items inside [0, 2^{spec.bits})")
    return pos_mass


# ---------------------------------------------------------------------------
# Adapters: the frequency and quantile layouts, plain and hash-sharded
# ---------------------------------------------------------------------------

def _fields(d, device) -> SketchState:
    return SketchState(*(torch.as_tensor(np.asarray(d[key]).astype(np.int32),
                                         device=device)
                         for key in ("ids", "counts", "errors")))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tagged(layout: int, bank: SketchState, **extra) -> Dict[str, Any]:
    """A checkpoint dict: the layout tag, the bank's three fields as numpy
    arrays, then ``extra`` (``mass``, ``shards``)."""
    return {"layout": np.int32(layout), "ids": _to_numpy(bank.ids),
            "counts": _to_numpy(bank.counts),
            "errors": _to_numpy(bank.errors), **extra}


def _shard_fields(spec, d, device) -> SketchState:
    """A sharded checkpoint's fields, refused unless it holds the spec's
    shard count."""
    fields = _fields(d, device)
    if fields.ids.shape[0] != spec.shards:
        raise ValueError(
            f"checkpoint has {fields.ids.shape[0]} shards, spec asks for "
            f"{spec.shards}; restore with a matching spec (or consolidate "
            f"first)")
    return fields


def _mass(d, device) -> torch.Tensor:
    """A checkpoint's |F|_1 as a 0-d int32 tensor."""
    return torch.as_tensor(np.asarray(d["mass"]).astype(np.int32).reshape(()),
                           device=device)


def _no_rank(spec: SketchSpec):
    raise ValueError(
        f"rank/quantile queries need kind='quantile'; this spec is "
        f"kind={spec.kind!r}. Build a SketchSpec(kind='quantile', "
        f"bits=..., ...) to get the dyadic bank.")


class _FrequencyAdapter:
    """shards=None: the flat (k,) SketchState."""

    def make(self, spec, device) -> SketchState:
        return st.init(spec.capacity, device=device)

    def device_of(self, state) -> torch.device:
        return state.ids.device

    def update(self, spec, state, items, weights):
        v = spec.variant_id
        if spec.backend == "bank":
            return bk.update_single(state, items, weights, v, spec.bits)
        if spec.backend == "block":
            return blocks.block_update(state, items, weights, v)
        if spec.backend == "serial":
            return blocks.block_update_serial(state, items, weights, v)
        # "kernel": the flat sketch as a one-row bank, routed like the
        # reference (api.py:419-431)
        row_items, row_weights = HashShardRouter(1, spec.bits).route_dense(
            items, weights)
        bank1 = SketchState(*(t[None] for t in state))
        out = sketch_block_update_fused(bank1, row_items, row_weights, v)
        return SketchState(*(t[0] for t in out))

    def query_many(self, spec, state, items):
        return st.query_many(state, items)

    def topk(self, spec, state, m):
        return st.topk(state, m)

    def rank_many(self, spec, state, xs):
        _no_rank(spec)

    quantile_many = rank_many

    def merge(self, spec, a, b):
        return st.merge(a, b)

    def consolidate(self, spec, state):
        return state

    def save(self, spec, state) -> Dict[str, Any]:
        return _tagged(LAYOUT_FREQUENCY, state)

    def restore(self, spec, d, device) -> SketchState:
        return _fields(d, device)


class _ShardedFrequencyAdapter:
    """shards=S: the hash-partitioned ShardedSketch bank."""

    # spec backend -> sharded.update_block path name (api.py:466)
    _PATHS = {"bank": "auto", "block": "vmap", "kernel": "kernel"}

    def make(self, spec, device) -> shd.ShardedSketch:
        return shd.init(spec.capacity, spec.shards, device=device)

    def device_of(self, state) -> torch.device:
        return state.bank.ids.device

    def update(self, spec, state, items, weights):
        if spec.backend == "serial":
            return shd.update_block_serial_reference(
                state, items, weights, spec.variant_id,
                universe_bits=spec.bits)
        return shd.update_block(state, items, weights, spec.variant_id,
                                universe_bits=spec.bits,
                                path=self._PATHS[spec.backend])

    def query_many(self, spec, state, items):
        return shd.query_many(state, items)

    def topk(self, spec, state, m):
        return shd.topk(state, m)

    def rank_many(self, spec, state, xs):
        _no_rank(spec)

    quantile_many = rank_many

    def merge(self, spec, a, b):
        return shd.merge(a, b)

    def consolidate(self, spec, state):
        return shd.consolidate(state)

    def save(self, spec, state) -> Dict[str, Any]:
        return _tagged(LAYOUT_FREQUENCY, shd.gathered(state).bank,
                       shards=np.int32(spec.shards))

    def restore(self, spec, d, device) -> shd.ShardedSketch:
        return shd.ShardedSketch(bank=_shard_fields(spec, d, device))


class _DyadicAdapter:
    """shards=None quantile: the (bits, k) dyadic layer bank."""

    def make(self, spec, device) -> dy.DyadicState:
        return dy.init(spec.bits, total_counters=spec.k, eps=spec.eps,
                       alpha=spec.alpha, device=device)

    def device_of(self, state) -> torch.device:
        return state.bank.ids.device

    def update(self, spec, state, items, weights):
        return dy.update_block(state, items, weights, spec.variant_id,
                               path=spec.backend)

    def query_many(self, spec, state, items):
        # leaf-layer reads: layer 0 monitors x >> 0 = x itself
        return st.query_many(SketchState(*(t[0] for t in state.bank)), items)

    def topk(self, spec, state, m):
        # the leaf row through the BLOCKED-aware bank top-k
        return bk.topk_bank(SketchState(*(t[:1] for t in state.bank)), m)

    def rank_many(self, spec, state, xs):
        return dy.rank_many(state, xs)

    def quantile_many(self, spec, state, qs):
        return dy.quantile_many(state, qs)

    def merge(self, spec, a, b):
        return dy.merge(a, b)

    def consolidate(self, spec, state):
        return state

    def save(self, spec, state) -> Dict[str, Any]:
        return _tagged(LAYOUT_QUANTILE, state.bank,
                       mass=np.int32(int(state.mass)))

    def restore(self, spec, d, device) -> dy.DyadicState:
        return dy.DyadicState(bank=_fields(d, device), mass=_mass(d, device))


class _DyadicShardedAdapter:
    """shards=S quantile: the shard × level bank."""

    def make(self, spec, device) -> dysh.DyadicShardedState:
        return dysh.init(spec.bits, spec.shards, total_counters=spec.k,
                         eps=spec.eps, alpha=spec.alpha, device=device)

    def device_of(self, state) -> torch.device:
        return state.bank.ids.device

    def update(self, spec, state, items, weights):
        return dysh.update_block(state, items, weights, spec.variant_id,
                                 path="auto")

    def query_many(self, spec, state, items):
        # leaf-layer reads from each id's owner (shard, level 0) row
        items = items.to(torch.int32)
        state = dysh.gathered(state)
        leaf = SketchState(*(t[:, 0] for t in state.bank))
        return bk.query_rows(leaf, bk.shard_of(items, state.num_shards),
                             items)

    def topk(self, spec, state, m):
        return bk.topk_bank(SketchState(
            *(t[:, 0] for t in dysh.gathered(state).bank)), m)

    def rank_many(self, spec, state, xs):
        return dysh.rank_many(state, xs)

    def quantile_many(self, spec, state, qs):
        return dysh.quantile_many(state, qs)

    def merge(self, spec, a, b):
        return dysh.merge(a, b)

    def consolidate(self, spec, state):
        return dysh.consolidate(state)

    def save(self, spec, state) -> Dict[str, Any]:
        return _tagged(LAYOUT_QUANTILE, dysh.gathered(state).bank,
                       mass=np.int32(int(state.mass)),
                       shards=np.int32(spec.shards))

    def restore(self, spec, d, device) -> dysh.DyadicShardedState:
        return dysh.DyadicShardedState(bank=_shard_fields(spec, d, device),
                                       mass=_mass(d, device))


# registry key (reference api.py:627): (kind, sharded?, axis, tenants?);
# the axis tells same-kind layout families apart: "base" (the plain
# store), "double"/"unbiased" (the family), "crprecis"
_REGISTRY: Dict[Tuple[str, bool, str, bool], Any] = {}


def spec_axis(spec: SketchSpec) -> str:
    """The registry's layout-family axis of a spec."""
    if spec.backend == "crprecis":
        return "crprecis"
    if spec.variant in FAMILY_VARIANTS:
        return spec.variant
    return "base"


def register_adapter(kind: str, sharded: bool, adapter,
                     axis: str = "base", tenants: bool = False) -> None:
    """Plug a layout's adapter into the spec-driven surface."""
    _REGISTRY[(kind, sharded, axis, tenants)] = adapter


def adapter_for(spec: SketchSpec):
    try:
        return _REGISTRY[(spec.kind, spec.shards is not None,
                          spec_axis(spec), spec.tenants is not None)]
    except KeyError:
        raise ValueError(
            f"no adapter registered for kind={spec.kind!r}, "
            f"sharded={spec.shards is not None}, axis={spec_axis(spec)!r}, "
            f"tenants={spec.tenants is not None}") from None


register_adapter("frequency", False, _FrequencyAdapter())
register_adapter("frequency", True, _ShardedFrequencyAdapter())
register_adapter("quantile", False, _DyadicAdapter())
register_adapter("quantile", True, _DyadicShardedAdapter())

# the family layouts (family.py and tenant.py never import this module at
# their top, so the imports after the registry are acyclic), each on its
# registry axis, and the multi-tenant layouts: the base variants through
# TenantAdapter, the family's through the tenant-aware DoubleAdapter
from . import family as _family  # noqa: E402
from . import tenant as _tenant  # noqa: E402

for _sharded in (False, True):
    register_adapter("frequency", _sharded, _family.DoubleAdapter(),
                     axis="double")
    register_adapter("frequency", _sharded,
                     _family.DoubleAdapter(unbiased=True), axis="unbiased")
    register_adapter("frequency", _sharded, _tenant.TenantAdapter(),
                     tenants=True)
    register_adapter("frequency", _sharded, _family.DoubleAdapter(),
                     axis="double", tenants=True)
    register_adapter("frequency", _sharded,
                     _family.DoubleAdapter(unbiased=True), axis="unbiased",
                     tenants=True)
register_adapter("frequency", False, _family.CRPrecisAdapter(),
                 axis="crprecis")
del _sharded


# ---------------------------------------------------------------------------
# The uniform functional surface
# ---------------------------------------------------------------------------

def make(spec: SketchSpec, device=DEFAULT_DEVICE):
    """Empty state for ``spec`` on ``device`` (CUDA unless asked)."""
    return adapter_for(spec).make(spec, resolve_device(device))


def _as_ids(x, device) -> torch.Tensor:
    """int32 tensor on ``device`` from a tensor, an array or Python ints.

    As the reference's ``jnp.asarray(x, jnp.int32)``: a tensor or a numpy
    array keeps its low 32 bits (the reference truncates an int64 array
    with x64 off), while a Python int (or a sequence of them) outside
    int32 raises ``OverflowError``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    arr = np.asarray(x)
    if not isinstance(x, np.ndarray) and arr.size and arr.dtype.kind in "iuO":
        lo, hi = int(arr.min()), int(arr.max())
        if lo < -2**31 or hi >= 2**31:
            bad = lo if lo < -2**31 else hi
            raise OverflowError(f"Python integer {bad} out of bounds for "
                                f"int32 (the device-side id dtype)")
    return torch.as_tensor(arr.astype(np.int32), device=device)


def host_array(x) -> np.ndarray:
    """A host (numpy) view of a block given as an array-like or as a tensor
    on any device (copied to the host): the form ``validate_block``
    checks, as the reference checks its device arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def update(spec: SketchSpec, state, items, weights=None, *, path=None):
    """Ingest one block of signed weighted updates; returns the new state.

    ``weights=None`` means unit inserts. Every input, tensors included, is
    validated (``validate_block``, on a host copy) before it is cast to
    int32 and moved to the state's device. ``path=`` is the deprecated
    spelling of the spec's ``backend`` (it warns and replaces it).
    """
    if path is not None:
        warnings.warn(
            "api.update(..., path=...) is deprecated; the execution path "
            "is part of the spec — use dataclasses.replace(spec, "
            "backend=...) instead", DeprecationWarning, stacklevel=2)
        spec = dataclasses.replace(spec, backend=path)
    ad = adapter_for(spec)
    dev = ad.device_of(state)
    if weights is None:
        weights = np.ones(np.shape(items), np.int32)
    validate_block(spec, host_array(items), host_array(weights))
    return ad.update(spec, state, _as_ids(items, dev), _as_ids(weights, dev))


def query_many(spec: SketchSpec, state, items) -> torch.Tensor:
    """Estimated frequency per query id."""
    ad = adapter_for(spec)
    return ad.query_many(spec, state, _as_ids(items, ad.device_of(state)))


def query(spec: SketchSpec, state, item) -> torch.Tensor:
    """Estimated frequency of one id; an id past int32 raises
    ``OverflowError``, as the reference's int32 cast does."""
    return query_many(spec, state, [item])[0]


def topk(spec: SketchSpec, state, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m (ids, counts) heavy hitters by estimated count (of the leaf
    layer for quantile kinds). On ``tenants=T`` specs the ids are
    composite keys; one tenant's raw items come from ``tenant_topk``."""
    return adapter_for(spec).topk(spec, state, m)


def tenant_topk(spec: SketchSpec, state, tenant,
                m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tenant's top-m (raw items, counts), read from the tenant's own
    rows only (multi-tenant specs)."""
    ad = adapter_for(spec)
    if spec.tenants is None or not hasattr(ad, "topk_tenant"):
        raise ValueError(
            f"tenant_topk needs a multi-tenant spec (tenants=T); this spec "
            f"has tenants={spec.tenants}. Use topk for the global answer.")
    return ad.topk_tenant(spec, state, tenant, m)


def rank_many(spec: SketchSpec, state, xs) -> torch.Tensor:
    """Estimated rank(x) = |{v <= x}| per query (quantile kinds only)."""
    ad = adapter_for(spec)
    return ad.rank_many(spec, state, _as_ids(xs, ad.device_of(state)))


def rank(spec: SketchSpec, state, x) -> int:
    return int(rank_many(spec, state, [x])[0])


def quantile_many(spec: SketchSpec, state, qs) -> torch.Tensor:
    """Smallest x with rank(x) >= q·|F|₁ per query (quantile kinds only);
    the q values are taken as float32, as the reference takes them."""
    ad = adapter_for(spec)
    dev = ad.device_of(state)
    if isinstance(qs, torch.Tensor):
        qs = qs.to(device=dev, dtype=torch.float32)
    else:
        qs = torch.as_tensor(np.asarray(qs, np.float32), device=dev)
    return ad.quantile_many(spec, state, qs)


def quantile(spec: SketchSpec, state, q: float) -> int:
    return int(quantile_many(spec, state, [q])[0])


def merge(spec: SketchSpec, a, b):
    """Mergeable-summaries merge of two same-spec states (cross-host)."""
    return adapter_for(spec).merge(spec, a, b)


def consolidate(spec: SketchSpec, state):
    """A sharded state folded into its single summary (checkpoint
    compaction); the identity for unsharded specs."""
    return adapter_for(spec).consolidate(spec, state)


# ---------------------------------------------------------------------------
# Checkpointing: the reference's tagged flat dicts
# ---------------------------------------------------------------------------

def save(spec: SketchSpec, state) -> Dict[str, Any]:
    """Flat numpy dict with the reference's integer layout tag."""
    return adapter_for(spec).save(spec, state)


def infer_spec(spec: SketchSpec, d: Dict[str, Any]) -> SketchSpec:
    """Adapt ``spec``'s layout axes (kind, shards, tenants, the family
    axis) to a checkpoint dict (reference ``api.py:812``). An untagged
    dict is a quantile one where it holds ``mass``; a quantile spec
    without ``bits`` takes them from the dict's layer count, a tenant
    spec from its ``item_bits``. Tag 3 (the family's two banks) gives the
    variant its ``family`` field names (1 double, 2 unbiased), tag 4 the
    ``crprecis`` backend. Where the stored layout does not run the spec's
    backend, the backend becomes ``"bank"``, as the reference's does."""
    known = {LAYOUT_FREQUENCY: "frequency", LAYOUT_QUANTILE: "quantile",
             LAYOUT_DOUBLE: "double/unbiased family",
             LAYOUT_CRPRECIS: "crprecis"}
    tag = int(np.asarray(d["layout"])) if "layout" in d else None
    if tag is not None and tag not in known:
        raise ValueError(
            f"unknown checkpoint layout tag {tag} (known: {known}); the "
            f"dict is corrupted or written by a newer layout")
    kind = ("quantile" if tag == LAYOUT_QUANTILE
            or (tag is None and "mass" in d) else "frequency")
    shards = int(np.asarray(d["shards"])) if "shards" in d else 0
    shards = shards or None
    changes: Dict[str, Any] = {}
    if kind != spec.kind:
        changes["kind"] = kind
        if kind == "quantile" and spec.bits is None:
            changes["bits"] = int(np.asarray(d["ids"]).shape[-2])
    if shards != spec.shards:
        changes["shards"] = shards
    raw_tenants = d.get("tenants")
    n_tenants = int(np.asarray(raw_tenants)) if raw_tenants is not None else 0
    tenants = (n_tenants or None) if kind == "frequency" else None
    if tenants != spec.tenants:
        changes["tenants"] = tenants
        if spec.tenant_caps is not None:
            # caps sized for another fleet: the restored rows carry their
            # own BLOCKED masks, so the spec takes the dict's live counters
            changes["tenant_caps"] = None
            changes["k"] = int((np.asarray(d["ids"]) != st.BLOCKED).sum())
        if tenants is not None and spec.bits is None:
            changes["bits"] = int(np.asarray(d["item_bits"]))
    if tag == LAYOUT_DOUBLE:
        want = ("unbiased" if int(np.asarray(d.get("family", 1))) == 2
                else "double")
        if spec.variant != want:
            changes["variant"] = want
        if spec.backend != "bank":
            changes["backend"] = "bank"
    elif tag == LAYOUT_CRPRECIS:
        if spec.backend != "crprecis":
            changes["backend"] = "crprecis"
        if spec.variant != "sspm":
            changes["variant"] = "sspm"
    else:
        if spec.variant in FAMILY_VARIANTS:
            changes["variant"] = "sspm"
        if spec.backend == "crprecis":
            changes["backend"] = "bank"
    if changes and "backend" not in changes:
        # the stored layout may not run the spec's backend
        probe = {**{f.name: getattr(spec, f.name)
                    for f in dataclasses.fields(spec)}, **changes}
        if spec.backend not in backends_for(probe["kind"], probe["shards"],
                                            probe["variant"],
                                            probe["tenants"]):
            changes["backend"] = "bank"
    return dataclasses.replace(spec, **changes) if changes else spec


def _validate_checkpoint(spec: SketchSpec, d: Dict[str, Any]) -> None:
    """Reject truncated or corrupted dicts before any state is built: the
    keys present (``mass`` too for quantile kinds, the ``_del`` bank for
    the family, ``counts`` and ``primes`` for CR-precis), integer fields
    of one shape per bank, an integer scalar mass."""
    axis = spec_axis(spec)
    if axis == "crprecis":
        for key in ("counts", "primes"):
            if key not in d:
                raise ValueError(
                    f"checkpoint dict is missing key {key!r} (truncated "
                    f"write?); a crprecis checkpoint needs counts + primes")
            if np.asarray(d[key]).dtype.kind not in "iu":
                raise ValueError(
                    f"checkpoint field {key!r} has dtype "
                    f"{np.asarray(d[key]).dtype}; crprecis counters and "
                    f"moduli are integer arrays")
        return
    required = ["ids", "counts", "errors"]
    if spec.kind == "quantile":
        required.append("mass")
    triples = [("ids", "counts", "errors")]
    if axis in FAMILY_VARIANTS:
        required += ["ids_del", "counts_del", "errors_del"]
        triples.append(("ids_del", "counts_del", "errors_del"))
    missing = [k for k in required if k not in d]
    if missing:
        raise ValueError(
            f"checkpoint dict is missing key(s) {missing} (truncated "
            f"write?); a {spec.kind!r} checkpoint needs {required}")
    for keys in triples:
        shapes = {}
        for key in keys:
            arr = np.asarray(d[key])
            if arr.dtype.kind not in "iu":
                raise ValueError(
                    f"checkpoint field {key!r} has dtype {arr.dtype}; "
                    f"sketch counters are integer arrays")
            shapes[key] = arr.shape
        if len(set(shapes.values())) != 1:
            raise ValueError(
                f"checkpoint counter fields disagree in shape: {shapes}")
    if spec.kind == "quantile":
        mass = np.asarray(d["mass"])
        if mass.dtype.kind not in "iu" or mass.size != 1:
            raise ValueError(
                f"checkpoint field 'mass' must be an integer scalar "
                f"(|F|₁), got dtype {mass.dtype}, shape {mass.shape}")


def restore(spec: SketchSpec, d: Dict[str, Any], device=DEFAULT_DEVICE):
    """State from a ``save`` dict of either package (or the untagged
    pre-redesign layouts), on ``device``. The spec's kind, shards, family
    axis and tenants must be the dict's (``infer_spec`` adapts a
    spec)."""
    inferred = infer_spec(spec, d)
    if (inferred.kind, inferred.shards, spec_axis(inferred),
            inferred.tenants) != \
            (spec.kind, spec.shards, spec_axis(spec), spec.tenants):
        raise ValueError(
            f"checkpoint layout is kind={inferred.kind!r}, "
            f"shards={inferred.shards}, axis={spec_axis(inferred)!r}, "
            f"tenants={inferred.tenants}, but the spec says "
            f"kind={spec.kind!r}, shards={spec.shards}, "
            f"axis={spec_axis(spec)!r}, tenants={spec.tenants}; restore "
            f"through infer_spec(spec, d) (StreamSession.load does)")
    _validate_checkpoint(spec, d)
    return adapter_for(spec).restore(spec, d, resolve_device(device))


# ---------------------------------------------------------------------------
# Deprecated spellings (reference api.py:972)
# ---------------------------------------------------------------------------

def deprecated_alias(old: str, new: str, fn):
    """``fn`` under an old name: the first call warns (DeprecationWarning,
    once per alias), every call forwards as it is; ``__wrapped__`` is
    ``fn``."""
    warned = []

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not warned:
            warned.append(True)
            warnings.warn(
                f"{old} is deprecated; use {new} (the spec-driven "
                f"repro_torch.sketch.api surface)", DeprecationWarning,
                stacklevel=2)
        return fn(*args, **kwargs)

    return wrapper


__all__ = ["KINDS", "VARIANTS", "FAMILY_VARIANTS", "BACKENDS",
           "LAYOUT_FREQUENCY", "LAYOUT_QUANTILE", "LAYOUT_DOUBLE",
           "LAYOUT_CRPRECIS", "SketchSpec", "backends_for", "variants_for",
           "validate_block", "host_array", "spec_axis", "register_adapter",
           "adapter_for", "make", "update", "query_many", "query", "topk",
           "tenant_topk", "rank_many", "rank", "quantile_many", "quantile",
           "merge", "consolidate", "save", "infer_spec", "restore",
           "deprecated_alias"]
