"""The port's partition core against the reference package.

``bank._fused_partition`` (the frequency kind's ``backend="bank"``, the
reference's production default) on the CPU, where ``ops`` runs kernel 1's
plain version on the partition layout (one flat grouped array, a per-row
offset): ``update_single``, ``update_block_fused`` under
``HashShardRouter(S)`` and ``TenantRouter`` (one row per tenant: the
monotone branch; per-tenant shards: the one-hot branch), the sharded
paths ``auto``/``block`` against the reference's and its serial oracle
(``tests/test_bank.py::TestEngineCore``/``TestRoutingInvariants``,
``tests/test_sharded.py``'s fused-equals-serial grid), ``topk_rows``,
``split_signed``, ``update_pair``, the edge cases of the sketch (k = 1, 3,
200; B = 1; all-padding blocks; net-zero cancellation; deletes on an empty
sketch; counts at INT_MAX; the packed key's size limit), and the spec
registry. Inputs come from numpy seeds; the state is int32, so every
comparison is exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from helpers import random_strict_stream
from repro.core.streams import bounded_stream
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import blocks as jbl
from repro.sketch import sharded as jshd
from repro.sketch import state as jst
from repro_torch.kernels.sketch_update import ops as tops
from repro_torch.kernels.sketch_update.ref import fused_update_ref
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import sharded as tshd
from repro_torch.sketch import state as tst

IMAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(want, got, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _signed(rng, n, universe):
    items = rng.integers(0, universe, n).astype(np.int32)
    return items, rng.choice([-2, -1, 1, 1, 1, 3, 0], n).astype(np.int32)


# -- update_single: the flat sketch as a one-row partition -----------------

@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("bits", [None, 9])
def test_update_single_matches_reference(variant, bits):
    """``TestEngineCore::test_update_single_bit_identical_to_block_update``:
    three blocks, equal to the reference's ``update_single`` and
    ``blocks.block_update``."""
    rng = np.random.default_rng(7 + variant)
    js, ts = jst.init(48), tst.init(48, device="cpu")
    for blk in range(3):
        items, weights = random_strict_stream(rng, 256, 300, 0.3)
        js = jbk.update_single(js, jnp.asarray(items), jnp.asarray(weights),
                               variant, bits)
        ts = tbk.update_single(ts, _t(items), _t(weights), variant, bits)
        _eq(js, ts, f"block {blk}")
    want = jst.init(48)
    rng = np.random.default_rng(7 + variant)
    for _ in range(3):
        items, weights = random_strict_stream(rng, 256, 300, 0.3)
        want = jbl.block_update(want, jnp.asarray(items),
                                jnp.asarray(weights), variant)
    _eq(want, ts, "block_update")


# -- update_block_fused under the partition routers ------------------------

@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("variant", [1, 2])
def test_hash_router_bank_matches_reference(S, variant):
    """Three signed blocks into an (S, 40) bank, with the packed sort
    (universe_bits) and without."""
    rng = np.random.default_rng(S * 10 + variant)
    for bits in (10, None):
        jr, tr = jbk.HashShardRouter(S, bits), tbk.HashShardRouter(S, bits)
        jb, tb = jbk.init(40, S), tbk.init(40, S, device="cpu")
        for blk in range(3):
            items, w = _signed(rng, 333, 1 << 10)
            jb = jbk.update_block_fused(jb, jnp.asarray(items),
                                        jnp.asarray(w), jr, variant)
            tb = tbk.update_block_fused(tb, _t(items), _t(w), tr, variant)
            _eq(jb, tb, f"S={S} bits={bits} block {blk}")


@pytest.mark.parametrize("T,shards", [(4, 1), (3, 2), (1, 1)])
@pytest.mark.parametrize("variant", [1, 2])
def test_tenant_router_bank_matches_reference(T, shards, variant):
    """A TenantRouter bank over composite keys: one row per tenant (the
    monotone branch, ranks by prefix-sum differences) and per-tenant hash
    shards (the one-hot branch); the router's properties as the
    reference's."""
    item_bits = 7
    jr = jbk.TenantRouter(T, item_bits, shards)
    tr = tbk.TenantRouter(T, item_bits, shards)
    assert (tr.tenant_bits, tr.universe_bits, tr.num_rows,
            tr.monotone_owner) == (jr.tenant_bits, jr.universe_bits,
                                   jr.num_rows, jr.monotone_owner)
    rng = np.random.default_rng(T * 100 + shards * 10 + variant)
    keys = rng.integers(0, T << item_bits, 500).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(jr.owner_of(jnp.asarray(keys))),
                                  tr.owner_of(_t(keys)).numpy())
    for a, b in zip(jr.route_dense(jnp.asarray(keys), jnp.ones(500, jnp.int32)),
                    tr.route_dense(_t(keys), torch.ones(500,
                                                        dtype=torch.int32))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jb, tb = jbk.init(30, T * shards), tbk.init(30, T * shards, device="cpu")
    for blk in range(3):
        items, w = _signed(rng, 400, T << item_bits)
        if blk == 2:
            items[::5] = -1        # padding keys sort before every tenant
            w[::5] = 0
        jb = jbk.update_block_fused(jb, jnp.asarray(items), jnp.asarray(w),
                                    jr, variant)
        tb = tbk.update_block_fused(tb, _t(items), _t(w), tr, variant)
        _eq(jb, tb, f"block {blk}")


@dataclasses.dataclass(frozen=True)
class _DenseRanked(tbk.TenantRouter):
    """A one-row-per-tenant router whose owner is monotone, made to take
    the one-hot branch."""

    @property
    def monotone_owner(self) -> bool:
        return False


@pytest.mark.parametrize("variant", [1, 2])
def test_monotone_and_one_hot_ranks_agree(variant):
    """The partition prep's two branches give the same layout, scalars and
    delta on one bank and block (keys with padding, net-zero pairs,
    rows that fill, evict and drain)."""
    rng = np.random.default_rng(variant)
    bank = tbk.init(16, 5, device="cpu")
    for _ in range(2):
        items, w = _signed(rng, 300, 5 << 6)
        items[::9] = -1
        bank = tbk.update_block_fused(bank, _t(items), _t(w),
                                      tbk.TenantRouter(5, 6), variant)
    items, w = _signed(rng, 300, 5 << 6)
    a = tbk.phase1_partition_prep(bank, _t(items), _t(w),
                                  tbk.TenantRouter(5, 6), variant)
    b = tbk.phase1_partition_prep(bank, _t(items), _t(w), _DenseRanked(5, 6),
                                  variant)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_partition_route_dense_is_the_reference_routing():
    """``TestRoutingInvariants::test_hash_partition_fixed``'s inputs through
    the shared partition routing: the same (S, B) views."""
    s = bounded_stream("zipf", 777, 0.5, universe=1 << 8, order="interleaved",
                       seed=5)[:777]
    items, weights = s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)
    for S, bits in ((4, 8), (3, None)):
        want = jbk.HashShardRouter(S, bits).route_dense(jnp.asarray(items),
                                                        jnp.asarray(weights))
        got = tbk.HashShardRouter(S, bits).route_dense(_t(items), _t(weights))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- the sharded paths (tests/test_sharded.py) ------------------------------

def _stream(dist, n, ratio, seed):
    s = bounded_stream(dist, n, ratio, order="interleaved", seed=seed)[:n]
    return s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("S,ktot,B,dist,ratio", [
    (4, 256, 1024, "zipf", 0.2),
    (2, 128, 512, "caida", 0.5),
    (8, 512, 2048, "binomial", 0.75),
    (3, 96, 777, "zipf", 0.5),     # S and B neither powers of two
])
def test_fused_equals_serial_routed_reference(variant, S, ktot, B, dist,
                                              ratio):
    """``test_sharded.py::test_fused_equals_serial_routed_reference``: the
    default path (the partition core) equals the per-shard serial oracle,
    in both packages, on a cold and a warm bank."""
    js, ts = jshd.init(ktot, S), tshd.init(ktot, S, device="cpu")
    js_ref, ts_ref = js, ts
    for seed in (S + B, S + B + 1):
        items, w = _stream(dist, B, ratio, seed)
        js = jshd.update_block(js, jnp.asarray(items), jnp.asarray(w),
                               variant, universe_bits=16)
        ts = tshd.update_block(ts, _t(items), _t(w), variant,
                               universe_bits=16)
        js_ref = jshd.update_block_serial_reference(
            js_ref, jnp.asarray(items), jnp.asarray(w), variant,
            universe_bits=16)
        ts_ref = tshd.update_block_serial_reference(
            ts_ref, _t(items), _t(w), variant, universe_bits=16)
        _eq(js.bank, ts.bank, "auto")
        _eq(js_ref.bank, ts_ref.bank, "serial reference")
        _eq(js.bank, ts_ref.bank, "auto vs serial reference")


@pytest.mark.parametrize("path", ["vmap", "kernel", "block"])
def test_alternate_paths_match_fused(path):
    """``test_sharded.py::test_alternate_paths_match_fused``, the port's
    paths against its default."""
    items, w = _stream("zipf", 1024, 0.5, seed=11)
    s0 = tshd.init(128, 4, device="cpu")
    base = tshd.update_block(s0, _t(items), _t(w), universe_bits=16)
    _eq(jshd.update_block(jshd.init(128, 4), jnp.asarray(items),
                          jnp.asarray(w), universe_bits=16).bank, base.bank)
    other = tshd.update_block(s0, _t(items), _t(w), universe_bits=16,
                              path=path)
    for a, b in zip(base.bank, other.bank):
        assert torch.equal(a, b)


def test_all_padding_block_is_noop():
    """``test_sharded.py::test_all_padding_block_is_noop``."""
    warm = tshd.update_block(tshd.init(64, 4, device="cpu"),
                             _t(np.array([4, 4, 6, 9], np.int32)),
                             torch.ones(4, dtype=torch.int32))
    for pad in ([0, 0, 0, 0], [9, 3, 9, 1], [-1, -1, -1, -1]):
        out = tshd.update_block(warm, _t(np.array(pad, np.int32)),
                                torch.zeros(4, dtype=torch.int32))
        for a, b in zip(out.bank, warm.bank):
            assert torch.equal(a, b)


# -- edge cases of one sketch (the repo's verify notes) ---------------------

def _rail(js):
    """The sketch's live counts lifted to INT_MAX (saturated)."""
    ids = np.asarray(js.ids)
    c = np.where(ids >= 0, IMAX, np.asarray(js.counts)).astype(np.int32)
    return jst.SketchState(js.ids, jnp.asarray(c), js.errors)


@pytest.mark.parametrize("k", [1, 3, 200])
@pytest.mark.parametrize("variant", [1, 2])
def test_edge_cases_match_reference(k, variant):
    """k = 1, 3 and 200 (not a lane multiple) through ``update_single``:
    a B = 1 block, a delete on the empty sketch, an all-padding block,
    net-zero cancellation inside a block, a warm block, then counts at
    the INT_MAX rail meeting inserts of new and monitored ids."""
    rng = np.random.default_rng(k + variant)
    warm_i, warm_w = random_strict_stream(rng, 300, 3 * k + 7, 0.3)
    fresh = (np.arange(2 * k + 40) + 10 * k + 100).astype(np.int32)
    blocks = [
        ("delete on empty", [5], [-3]),
        ("B = 1", [5], [2]),
        ("all padding", [7, 7, -1, 3], [0, 0, 0, 0]),
        ("net zero", [9, 9, 4, 4, 9], [2, -2, 1, -1, 0]),
        ("warm", warm_i, warm_w),
        ("rail", np.concatenate([fresh, warm_i[:20]]),
         np.ones(len(fresh) + 20, np.int32)),
    ]
    js, ts = jst.init(k), tst.init(k, device="cpu")
    for name, items, w in blocks:
        items = np.asarray(items, np.int32)
        w = np.asarray(w, np.int32)
        if name == "rail":
            js = _rail(js)
            ts = tst.SketchState(*(_t(np.asarray(x)) for x in js))
        js = jbk.update_single(js, jnp.asarray(items), jnp.asarray(w),
                               variant)
        ts = tbk.update_single(ts, _t(items), _t(w), variant)
        _eq(js, ts, name)


def test_packed_grouping_key_limit_raises_as_the_reference():
    """(3S + 1) * B must stay below 2^31 for the grouping sort's key."""
    S, B = 683, 1 << 20    # (3 * 683 + 1) * 2^20 = 2,150,629,376 > 2^31
    items = np.zeros(B, np.int32)
    with pytest.raises(ValueError) as want:
        jbk.update_block_fused(jbk.init(1, S), jnp.asarray(items),
                               jnp.asarray(items), jbk.HashShardRouter(S), 2)
    with pytest.raises(ValueError) as got:
        tbk.update_block_fused(tbk.init(1, S, device="cpu"), _t(items),
                               _t(items), tbk.HashShardRouter(S), 2)
    assert str(got.value) == str(want.value)


# -- the plain version on the two layouts -----------------------------------

@pytest.mark.parametrize("variant", [1, 2])
def test_fused_update_ref_offsets_equal_the_row_layout(variant):
    """``fused_update_ref`` on the flat (R*B,) layout with ``uoff = r * B``
    equals its (R, B) call (the dense prep's layout)."""
    rng = np.random.default_rng(variant)
    R, K, B = 5, 40, 128
    bank = tbk.init(K, R, device="cpu")
    router = tbk.HashShardRouter(R, 10)
    for _ in range(3):
        items, w = _signed(rng, B, 1 << 10)
        prep = tbk.phase1_dense_prep(bank, *router.route_dense(_t(items),
                                                               _t(w)), variant)
        rows = fused_update_ref(*bank, *prep, variant=variant)
        delta, h_uids, h_net, *scalars = prep
        uoff = torch.arange(R, dtype=torch.int32) * B
        flat = fused_update_ref(*bank, delta, h_uids.reshape(-1),
                                h_net.reshape(-1), *scalars, uoff,
                                variant=variant)
        for a, b in zip(rows, flat):
            assert torch.equal(a, b)
        bank = tst.SketchState(*rows)


@pytest.mark.parametrize("variant", [1, 2])
def test_partition_ops_entry_points_agree(variant):
    """``ops.partition_update_with(fused_update_ref)`` and
    ``sketch_block_update_partition`` give the bank of
    ``bank.update_block_fused`` and of the dense route through
    ``sketch_block_update_fused``; the caller's bank is left as it was."""
    rng = np.random.default_rng(20 + variant)
    router = tbk.HashShardRouter(4, 10)
    bank = tbk.init(100, 4, device="cpu")
    for _ in range(3):
        items, w = _signed(rng, 500, 1 << 10)
        before = [t.clone() for t in bank]
        a = tops.partition_update_with(fused_update_ref, bank, _t(items),
                                       _t(w), router, variant)
        b = tops.sketch_block_update_partition(bank, _t(items), _t(w), router,
                                               variant)
        c = tops.sketch_block_update_fused(
            bank, *router.route_dense(_t(items), _t(w)), variant)
        for x, y, z, old, now in zip(a, b, c, before, bank):
            assert torch.equal(x, y) and torch.equal(x, z)
            assert torch.equal(old, now)
        bank = a


# -- top-k over rows and the Double SpaceSaving± hooks ----------------------

def test_topk_rows_matches_reference():
    rng = np.random.default_rng(3)
    jr, tr = jbk.TenantRouter(4, 8), tbk.TenantRouter(4, 8)
    jb, tb = jbk.init(20, 4), tbk.init(20, 4, device="cpu")
    items, w = _signed(rng, 600, 4 << 8)
    jb = jbk.update_block_fused(jb, jnp.asarray(items), jnp.asarray(w), jr, 2)
    tb = tbk.update_block_fused(tb, _t(items), _t(w), tr, 2)
    for rows, m in (([1], 5), ([0, 2], 40), ([3, 1, 0], 60)):
        want = jbk.topk_rows(jb, jnp.asarray(rows, jnp.int32), m)
        got = tbk.topk_rows(tb, _t(np.asarray(rows, np.int32)), m)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_split_signed_and_update_pair_match_reference():
    rng = np.random.default_rng(4)
    w = np.array([3, -2, 0, 1, -2**31 + 1, 2**31 - 1], np.int32)
    for a, b in zip(jbk.split_signed(jnp.asarray(w)), tbk.split_signed(_t(w))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jr, tr = jbk.HashShardRouter(3, 10), tbk.HashShardRouter(3, 10)
    ji, jd = jbk.init([30, 20, 25]), jbk.init([12, 10, 8])
    ti, td = (tbk.init([30, 20, 25], device="cpu"),
              tbk.init([12, 10, 8], device="cpu"))
    for _ in range(3):
        items, w = _signed(rng, 300, 1 << 10)
        ji, jd = jbk.update_pair(ji, jd, jnp.asarray(items), jnp.asarray(w),
                                 jr, 2)
        ti, td = tbk.update_pair(ti, td, _t(items), _t(w), tr, 2)
        _eq(ji, ti, "insert bank")
        _eq(jd, td, "delete bank")


# -- the spec registry ------------------------------------------------------

def test_registry_lookup_and_registration():
    """``adapter_for`` goes through the registry: a registered layout is
    found, a missing one raises ValueError as the reference's does."""
    spec = tapi.SketchSpec(k=64)
    base = tapi.adapter_for(spec)
    assert tapi.spec_axis(spec) == japi.spec_axis(japi.SketchSpec(k=64))
    key = ("frequency", False, "base", False)
    try:
        tapi.register_adapter("frequency", False, "stand-in")
        assert tapi.adapter_for(spec) == "stand-in"
        del tapi._REGISTRY[key]
        with pytest.raises(ValueError, match="no adapter registered"):
            tapi.adapter_for(spec)
    finally:
        tapi.register_adapter("frequency", False, base)
    assert tapi.adapter_for(spec) is base
