"""The port's multi-tenant layout (``sketch/tenant.py``, ``SketchSpec(
tenants=T)``) against the reference package, on ``tests/test_tenant.py``'s
grids.

Routing (composite keys, ``TenantRouter``'s owner map, the routed views),
isolation (a tenant bank fed coalesced composite-key blocks equals the
reference's bank bit for bit and answers every per-tenant query and top-k
as independent per-tenant sketches fed the same fragments; variants sspm
and lazy, delete fractions 0.0/0.5/0.9, per-tenant shards 1 and 2, the
per-row oracle), spill and re-admission (the spill dicts, the cleared and
re-admitted banks equal the reference's; dicts cross packages), the
per-tenant quantiles over a composite-key dyadic bank, and the session's
tenant plumbing (one compiled-ingest cell per layout, per-tenant window
FIFOs through checkpoints of either package, legacy schedule dicts).
The ``double`` cases run the family's tenant layout (both banks
tenant-major); replay recovery on a tenant spec equals a never-failed
twin. Inputs come from numpy seeds; the state is int32, so every comparison is
exact.
"""
from __future__ import annotations

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from helpers import random_strict_stream
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import session as jses
from repro.sketch import tenant as jtn
from repro_torch import convert
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import session as tses
from repro_torch.sketch import tenant as ttn

BITS = 8
UNIVERSE = 1 << BITS
CPU = "cpu"


def _tenant_streams(seed, T, n=400, delete_frac=0.3):
    """One strict bounded-deletion stream per tenant."""
    rng = np.random.default_rng(seed)
    return [random_strict_stream(rng, n, UNIVERSE, delete_frac)
            for _ in range(T)]


def _interleave(streams, seed=0):
    """Fragments of all tenants' streams, shuffled together with each
    tenant's own order kept: [(tenant, items, weights)]."""
    rng = np.random.default_rng(seed)
    per = {t: [(t, np.asarray(items[a:a + 37], np.int32),
                np.asarray(weights[a:a + 37], np.int32))
               for a in range(0, len(items), 37)]
           for t, (items, weights) in enumerate(streams)}
    labels = np.repeat(np.arange(len(streams)), [len(per[t]) for t in per])
    rng.shuffle(labels)
    cur = dict.fromkeys(per, 0)
    out = []
    for t in labels:
        out.append(per[t][cur[t]])
        cur[t] += 1
    return out


def _blocks_of(frags, T, block=96):
    """Padded composite-key blocks and, per block, each tenant's raw
    fragment (the independent twins' feed)."""
    keys = np.concatenate([
        ttn.pack_keys(np.full(len(i), t), i, BITS) for t, i, _ in frags]
    ).astype(np.int32)
    weights = np.concatenate([w for _, _, w in frags]).astype(np.int32)
    nb = -(-len(keys) // block)
    keys = np.pad(keys, (0, nb * block - len(keys)))
    weights = np.pad(weights, (0, nb * block - len(weights)))
    blocks = [(keys[s:s + block], weights[s:s + block])
              for s in range(0, len(keys), block)]
    per_tenant = []
    for ci, cw in blocks:
        tt, it = ttn.unpack_keys(ci.astype(np.int64), BITS)
        per_tenant.append({
            t: (it[(tt == t) & (cw != 0)].astype(np.int32),
                cw[(tt == t) & (cw != 0)])
            for t in range(T) if ((tt == t) & (cw != 0)).any()})
    return blocks, per_tenant


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bank(jbank, tbank, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), jbank, tbank):
        np.testing.assert_array_equal(np.asarray(a), _np(b),
                                      err_msg=f"{msg}: {name}")


def _specs(**fields):
    return japi.SketchSpec(**fields), tapi.SketchSpec(**fields)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_pack_unpack_keys_match_the_reference():
    t = np.asarray([0, 3, 7], np.int64)
    x = np.asarray([0, 200, 255], np.int64)
    k = ttn.pack_keys(t, x, BITS)
    assert k.dtype == np.int64
    np.testing.assert_array_equal(k, jtn.pack_keys(t, x, BITS))
    tt, xx = ttn.unpack_keys(k, BITS)
    np.testing.assert_array_equal(tt, t)
    np.testing.assert_array_equal(xx, x)
    # tensors stay int32, as the reference's device arrays do
    kt = ttn.pack_keys(torch.as_tensor(t), torch.as_tensor(x), BITS)
    assert kt.dtype == torch.int32
    np.testing.assert_array_equal(
        kt.numpy(), np.asarray(jtn.pack_keys(jnp.asarray(t, jnp.int32),
                                             jnp.asarray(x, jnp.int32),
                                             BITS)))
    assert ttn.tenant_bits_for(8) == jtn.tenant_bits_for(8) == 3
    assert ttn.tenant_bits_for(1) == jtn.tenant_bits_for(1) == 0


@pytest.mark.parametrize("shards", [1, 4])
def test_router_owner_map_matches_the_reference(shards):
    T = 3 if shards > 1 else 8
    jr, tr = jbk.TenantRouter(T, BITS, shards), ttn.router_for(T, BITS,
                                                               shards)
    assert (tr.num_rows, tr.universe_bits) == (jr.num_rows, jr.universe_bits)
    items = np.arange(UNIVERSE)
    keys = np.concatenate([jtn.pack_keys(np.full(UNIVERSE, t), items, BITS)
                           for t in range(T)]).astype(np.int32)
    want = np.asarray(jr.owner_of(jnp.asarray(keys)))
    np.testing.assert_array_equal(tr.owner_of(torch.as_tensor(keys)).numpy(),
                                  want)
    if shards > 1:   # each tenant's rows partition it as its own hash shards
        per = tbk.shard_of(torch.as_tensor(items, dtype=torch.int32),
                           shards).numpy()
        np.testing.assert_array_equal(
            want.reshape(T, -1), np.arange(T)[:, None] * shards + per)


def test_route_dense_masks_foreign_weights():
    keys = ttn.pack_keys(np.arange(4), np.full(4, 9), BITS).astype(np.int32)
    ri, rw = ttn.router_for(4, BITS).route_dense(torch.as_tensor(keys),
                                                 torch.ones(4, dtype=torch.int32))
    ji, jw = jbk.TenantRouter(4, BITS, 1).route_dense(
        jnp.asarray(keys), jnp.ones(4, jnp.int32))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(rw.numpy(), np.asarray(jw))
    # each row keeps exactly its own tenant's unit weight
    np.testing.assert_array_equal(rw.sum(dim=1).numpy(), np.ones(4))


@pytest.mark.parametrize("fields,match", [
    (dict(kind="quantile", bits=8, eps=0.1, tenants=4), "frequency"),
    (dict(kind="frequency", k=8, bits=8, tenant_caps=(4, 4)), "tenant"),
    (dict(kind="frequency", k=8, tenants=4), "bits"),
    (dict(kind="frequency", k=8, bits=30, tenants=16), "31"),
    (dict(kind="frequency", bits=8, tenants=2, tenant_caps=(4, 4, 4)),
     "entries"),
    (dict(kind="frequency", bits=8, tenants=2, tenant_caps=(4, 0)),
     "counter"),
    (dict(kind="frequency", k=8, bits=8, tenants=0), "tenants"),
    (dict(kind="frequency", k=8, bits=8, tenants=2, backend="block"),
     "not supported"),
])
def test_spec_validation_matches_the_reference(fields, match):
    with pytest.raises(ValueError, match=match):
        japi.SketchSpec(**fields)
    with pytest.raises(ValueError, match=match):
        tapi.SketchSpec(**fields)


def test_composite_keys_outside_the_tenant_space_are_refused():
    jspec, tspec = _specs(kind="frequency", k=8, bits=BITS, tenants=2)
    for spec, validate in ((jspec, japi.validate_block),
                           (tspec, tapi.validate_block)):
        with pytest.raises(ValueError, match="pack_keys"):
            validate(spec, np.asarray([2 << BITS]), np.asarray([1]))
        # a padding slot may hold any id
        assert validate(spec, np.asarray([5, 2 << BITS]),
                        np.asarray([1, 0])) == 1


# ---------------------------------------------------------------------------
# Isolation parity
# ---------------------------------------------------------------------------

def _mt_fields(T, variant, shards, k_t):
    kw = dict(kind="frequency", k=T * k_t, bits=BITS, tenants=T,
              variant=variant)
    if shards > 1:
        kw["shards"] = shards
    return kw


def _assert_parity(T, variant, shards, k_t, delete_frac, seed):
    """The tenant bank equals the reference's after every block, and each
    tenant's queries and top-k equal an independent per-tenant sketch's
    (the port's) fed the same fragments. A ``double`` bank is compared as
    its two banks; its top-k reads the insert bank's candidates (m = 4)."""
    jspec, tspec = _specs(**_mt_fields(T, variant, shards, k_t))
    solo = tapi.SketchSpec(kind="frequency", k=k_t, bits=BITS,
                           variant=variant,
                           shards=shards if shards > 1 else None)
    frags = _interleave(_tenant_streams(seed, T, delete_frac=delete_frac),
                        seed=seed)
    blocks, per_tenant = _blocks_of(frags, T)
    js, ts = japi.make(jspec), tapi.make(tspec, CPU)
    twins = [tapi.make(solo, CPU) for _ in range(T)]
    for b, ((ci, cw), pt) in enumerate(zip(blocks, per_tenant)):
        js = japi.update(jspec, js, jnp.asarray(ci), jnp.asarray(cw))
        ts = tapi.update(tspec, ts, ci, cw)
        for jb, tb in ([(js.ins, ts.ins), (js.dels, ts.dels)]
                       if variant == "double" else [(js.bank, ts.bank)]):
            _same_bank(jb, tb, f"block {b}")
        for t, (it, wt) in pt.items():
            twins[t] = tapi.update(solo, twins[t], it, wt)
    probe = np.arange(UNIVERSE, dtype=np.int32)
    for t in range(T):
        pk = ttn.pack_keys(np.full(UNIVERSE, t), probe, BITS).astype(np.int32)
        q = tapi.query_many(tspec, ts, pk)
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(japi.query_many(jspec, js, pk)))
        np.testing.assert_array_equal(
            q.numpy(), tapi.query_many(solo, twins[t], probe).numpy(),
            err_msg=f"tenant {t} ({variant}, S={shards}, del={delete_frac})")
        m = 4 if variant == "double" else k_t
        i_mt, v_mt = tapi.tenant_topk(tspec, ts, t, m)
        ji, jv = japi.tenant_topk(jspec, js, t, m)
        i_1, v_1 = tapi.topk(solo, twins[t], m)
        for got, want in ((i_mt, ji), (v_mt, jv), (i_mt, i_1), (v_mt, v_1)):
            np.testing.assert_array_equal(got.numpy(), _np(want))
    return ts, tspec


@pytest.mark.parametrize("variant", ["sspm", "lazy", "double"])
@pytest.mark.parametrize("delete_frac", [0.0, 0.5, 0.9])
def test_isolation_parity(variant, delete_frac):
    # k_t = 6 at alpha = 2 splits k_I = 4, k_D = 2 per tenant, the solo
    # twin's capacities
    _assert_parity(T=5, variant=variant, shards=1, k_t=6,
                   delete_frac=delete_frac, seed=11)


@pytest.mark.parametrize("variant", ["sspm", "double"])
def test_isolation_parity_sharded(variant):
    _assert_parity(T=3, variant=variant, shards=2, k_t=6, delete_frac=0.4,
                   seed=13)


@pytest.mark.parametrize("seed,delete_frac", [(101, 0.0), (2024, 0.3),
                                              (65535, 0.7)])
def test_isolation_parity_seeds(seed, delete_frac):
    """The reference's hypothesis fuzz at fixed seeds: T = 3, k_t = 4."""
    _assert_parity(T=3, variant="sspm", shards=1, k_t=4,
                   delete_frac=delete_frac, seed=seed)


@pytest.mark.parametrize("variant_id", [1, 2])
@pytest.mark.parametrize("shards", [1, 2])
def test_fused_matches_serial_reference(variant_id, shards):
    """The fused update equals the per-row oracle (every row on its own
    routed view), and both equal the reference's."""
    T = 5
    router = ttn.router_for(T, BITS, shards)
    tb = ttn.init_tenants(6, num_tenants=T, num_shards=shards, device=CPU)
    jb = jtn.init_tenants(6, num_tenants=T, num_shards=shards)
    blocks, _ = _blocks_of(_interleave(_tenant_streams(3, T), seed=3), T)
    ref = tb
    for ci, cw in blocks:
        tb = ttn.update_block(tb, torch.as_tensor(ci), torch.as_tensor(cw),
                              router, variant_id)
        ref = ttn.update_serial_reference(ref, ci, cw, router, variant_id)
        jb = jtn.update_block(jb, jnp.asarray(ci), jnp.asarray(cw),
                              jtn.router_for(T, BITS, shards), variant_id)
    _same_bank(jb.bank, tb.bank, "fused")
    _same_bank(jb.bank, ref.bank, "serial oracle")


def test_global_topk_speaks_composite_keys():
    jspec, tspec = _specs(kind="frequency", k=16, bits=BITS, tenants=4)
    keys = ttn.pack_keys(np.full(9, 2), np.full(9, 7), BITS).astype(np.int32)
    ts = tapi.update(tspec, tapi.make(tspec, CPU), keys, np.ones(9, np.int32))
    js = japi.update(jspec, japi.make(jspec), jnp.asarray(keys),
                     jnp.ones(9, jnp.int32))
    ids, vals = tapi.topk(tspec, ts, 3)
    ji, jv = japi.topk(jspec, js, 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    t, x = ttn.unpack_keys(int(ids[0]), BITS)
    assert (t, x, int(vals[0])) == (2, 7, 9)
    with pytest.raises(ValueError, match="multi-tenant"):
        tapi.tenant_topk(tapi.SketchSpec(k=8), tapi.make(
            tapi.SketchSpec(k=8), CPU), 0, 2)


def test_tenant_caps_row_capacities():
    jspec, tspec = _specs(kind="frequency", bits=BITS, tenants=3,
                          tenant_caps=[2, 5, 3])
    assert tspec.tenant_caps == (2, 5, 3) and hash(tspec)
    ts = tapi.make(tspec, CPU)
    np.testing.assert_array_equal((ts.bank.ids != -2).sum(dim=1).numpy(),
                                  [2, 5, 3])
    assert tspec.capacity == jspec.capacity == 10
    _same_bank(japi.make(jspec).bank, ts.bank, "make")
    # eps sizing splits the budget evenly, ceil per tenant
    jspec, tspec = _specs(kind="frequency", eps=0.1, bits=BITS, tenants=3,
                          shards=2)
    _same_bank(japi.make(jspec).bank, tapi.make(tspec, CPU).bank, "eps")


def test_topk_tenants_equals_per_tenant_topk():
    T, S = 4, 2
    jspec, tspec = _specs(kind="frequency", k=T * 6, bits=BITS, tenants=T,
                          shards=S)
    blocks, _ = _blocks_of(_interleave(_tenant_streams(8, T), seed=8), T)
    ts, js = tapi.make(tspec, CPU), japi.make(jspec)
    for ci, cw in blocks:
        ts = tapi.update(tspec, ts, ci, cw)
        js = japi.update(jspec, js, jnp.asarray(ci), jnp.asarray(cw))
    tenants = np.asarray([3, 0, 2, 3, -1, 9], np.int32)  # repeats, clamps
    items, vals = ttn.topk_tenants(ts, torch.as_tensor(tenants), 5,
                                   num_shards=S, item_bits=BITS)
    ji, jv = jtn.topk_tenants(js, jnp.asarray(tenants), 5, num_shards=S,
                              item_bits=BITS)
    np.testing.assert_array_equal(items.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    for i, t in enumerate(tenants[:4]):
        one_i, one_v = tapi.tenant_topk(tspec, ts, int(t), 5)
        np.testing.assert_array_equal(items[i].numpy(), one_i.numpy())
        np.testing.assert_array_equal(vals[i].numpy(), one_v.numpy())


# ---------------------------------------------------------------------------
# Spill / exact re-admission
# ---------------------------------------------------------------------------

def _built_banks(T=4, S=1, k_t=6, seed=5):
    fields = dict(kind="frequency", k=T * k_t, bits=BITS, tenants=T,
                  shards=S if S > 1 else None)
    jspec, tspec = _specs(**fields)
    ts, js = tapi.make(tspec, CPU), japi.make(jspec)
    blocks, _ = _blocks_of(_interleave(_tenant_streams(seed, T), seed=seed),
                           T)
    for ci, cw in blocks:
        ts = tapi.update(tspec, ts, ci, cw)
        js = japi.update(jspec, js, jnp.asarray(ci), jnp.asarray(cw))
    _same_bank(js.bank, ts.bank, "built")
    return jspec, js, tspec, ts


@pytest.mark.parametrize("shards", [1, 2])
def test_spill_admit_roundtrip_matches_the_reference(shards):
    jspec, js, tspec, ts = _built_banks(S=shards)
    S = tspec.shards or 1
    pk = ttn.pack_keys(np.ones(UNIVERSE), np.arange(UNIVERSE),
                       BITS).astype(np.int32)
    before_q = tapi.query_many(tspec, ts, pk).numpy()
    before_topk = tapi.tenant_topk(tspec, ts, 1, 6)
    snapshot = [t.clone() for t in ts.bank]

    d = ttn.spill_rows(ts.bank, 1, S, BITS)
    jd = jtn.spill_rows(js.bank, 1, S, BITS)
    assert set(d) == set(jd)
    for key in d:
        np.testing.assert_array_equal(d[key], np.asarray(jd[key]))
        assert np.asarray(d[key]).dtype == np.asarray(jd[key]).dtype, key
    cleared = ttn.clear_rows(ts.bank, ttn.tenant_rows(1, S))
    jcleared = jtn.clear_rows(js.bank, jtn.tenant_rows(1, S))
    _same_bank(jcleared, cleared, "cleared")
    # the bank the rows came from is not written
    assert all(torch.equal(a, b) for a, b in zip(snapshot, ts.bank))
    gone = tapi.query_many(tspec, ttn.TenantBank(bank=cleared), pk).numpy()
    assert (gone == 0).all()
    np.testing.assert_array_equal((cleared.ids == -2).sum(dim=1).numpy(),
                                  (ts.bank.ids == -2).sum(dim=1).numpy())

    # npz round trip, and each package admits the other's dict
    buf = io.BytesIO()
    np.savez(buf, **d)
    buf.seek(0)
    d2 = dict(np.load(buf))
    admitted = ttn.TenantBank(bank=ttn.admit_spill(cleared, d2))
    jadmitted = jtn.admit_spill(jcleared, {k: np.asarray(v)
                                           for k, v in jd.items()})
    _same_bank(jadmitted, admitted.bank, "admitted")
    _same_bank(jtn.admit_spill(jcleared, d), admitted.bank, "ref admits port")
    _same_bank(jadmitted, ttn.admit_spill(cleared, jd), "port admits ref")
    np.testing.assert_array_equal(
        tapi.query_many(tspec, admitted, pk).numpy(), before_q)
    # content-exact, but equal counts may change order in top-k
    after_topk = tapi.tenant_topk(tspec, admitted, 1, 6)
    pairs = lambda tk: sorted(zip(tk[1].tolist(), tk[0].tolist()))
    assert pairs(before_topk) == pairs(after_topk)
    for t in (0, 2, 3):
        rows = ttn.tenant_rows(t, S)
        np.testing.assert_array_equal(ts.bank.ids[rows].numpy(),
                                      admitted.bank.ids[rows].numpy())


def test_admit_spill_rejects_truncated_dict():
    _, _, _, ts = _built_banks()
    d = ttn.spill_rows(ts.bank, 0, 1, BITS)
    d.pop("counts")
    with pytest.raises(ValueError, match="missing"):
        ttn.admit_spill(ts.bank, d)


@pytest.mark.parametrize("shards", [1, 2])
def test_spill_dict_restores_alike_in_both_packages(shards):
    """A spill dict (one tenant's (S, k) rows of composite keys) read by
    ``convert.to_port`` and by the reference's ``api.restore``: the same
    S-shard bank, answering the same queries; with one shard, the
    tenant's own counts."""
    _, _, tspec, ts = _built_banks(S=shards)
    d = ttn.spill_rows(ts.bank, 2, shards, BITS)
    spec, state = convert.to_port(d, device=CPU)
    assert (spec.shards, spec.bits, spec.tenants) == (shards, BITS, None)
    jspec = japi.infer_spec(japi.SketchSpec(k=1, bits=BITS), d)
    jstate = japi.restore(jspec, d)
    _same_bank(jstate.bank, state.bank, "restored spill")
    pk = ttn.pack_keys(np.full(UNIVERSE, 2), np.arange(UNIVERSE),
                       BITS).astype(np.int32)
    got = tapi.query_many(spec, state, pk).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(japi.query_many(jspec, jstate, jnp.asarray(pk))))
    if shards == 1:
        np.testing.assert_array_equal(
            got, tapi.query_many(tspec, ts, pk).numpy())


# ---------------------------------------------------------------------------
# Quantile tenancy (composite-key dyadic bank)
# ---------------------------------------------------------------------------

def test_tenant_quantiles_match_the_reference():
    T_BITS, I_BITS = 2, 8
    jspec, tspec = _specs(kind="quantile", eps=0.02, bits=T_BITS + I_BITS)
    js, ts = japi.make(jspec), tapi.make(tspec, CPU)
    rng = np.random.default_rng(9)
    per_tenant = {}
    for t in range(1 << T_BITS):
        vals = rng.integers(0, 1 << I_BITS, 600)
        per_tenant[t] = np.sort(vals)
        keys = ttn.pack_keys(np.full(len(vals), t), vals,
                             I_BITS).astype(np.int32)
        js = japi.update(jspec, js, jnp.asarray(keys),
                         jnp.ones(len(vals), jnp.int32))
        ts = tapi.update(tspec, ts, keys, np.ones(len(vals), np.int32))
    qs = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    xs = np.asarray([0, 7, 100, 255], np.int32)
    for t in range(1 << T_BITS):
        mass = int(ttn.tenant_mass(ts, t, I_BITS))
        assert mass == int(jtn.tenant_mass(js, t, I_BITS)) \
            == len(per_tenant[t])
        got = ttn.tenant_quantile_many(ts, t, torch.as_tensor(qs), I_BITS)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jtn.tenant_quantile_many(
                js, t, jnp.asarray(qs), I_BITS)))
        ranks = ttn.tenant_rank_many(ts, t, torch.as_tensor(xs), I_BITS)
        np.testing.assert_array_equal(
            ranks.numpy(), np.asarray(jtn.tenant_rank_many(
                js, t, jnp.asarray(xs), I_BITS)))
        for q, g in zip(qs[1:4], got.numpy()[1:4]):
            got_rank = np.searchsorted(per_tenant[t], g, side="right")
            # two endpoints' error over the whole bank's mass
            assert abs(got_rank - q * mass) <= 2 * 0.02 * mass * (
                1 << T_BITS) + 1
    with pytest.raises(ValueError, match="quantile"):
        fspec = tapi.SketchSpec(k=8, bits=BITS, tenants=2)
        tapi.rank_many(fspec, tapi.make(fspec, CPU), [1])


# ---------------------------------------------------------------------------
# Session plumbing: one cache cell per layout, per-tenant window FIFOs
# ---------------------------------------------------------------------------

def test_ingest_cache_normalizes_tenant_layouts():
    # a total k no other test uses, so no other test's cell hides a miss
    specs = [
        tapi.SketchSpec(kind="frequency", k=53, bits=BITS, tenants=2),
        tapi.SketchSpec(kind="frequency", k=53, bits=BITS, tenants=4),
        tapi.SketchSpec(kind="frequency", bits=BITS, tenants=4,
                        tenant_caps=(14, 13, 13, 13)),
    ]
    norm = {tses.ingest_cache_spec(s) for s in specs}
    assert norm == {tapi.SketchSpec(kind="frequency", k=53, bits=BITS,
                                    tenants=1)}
    assert jses.ingest_cache_spec(japi.SketchSpec(
        kind="frequency", k=53, bits=BITS, tenants=4)).tenants == 1
    before = tses.ingest_cache_stats()["entries"]
    sessions = [tses.StreamSession(s, block=64, device=CPU) for s in specs]
    assert tses.ingest_cache_stats()["entries"] - before <= 1
    assert len({id(s._compiled) for s in sessions}) == 1
    for spec, s in zip(specs, sessions):
        keys = ttn.pack_keys(np.full(5, spec.tenants - 1),
                             np.arange(5), BITS)
        s.ingest(keys, np.ones(5, np.int32))
        np.testing.assert_array_equal(
            s.query_many(keys.astype(np.int32)).numpy(), np.ones(5))


def test_ingest_cache_spec_identity_for_plain_specs():
    spec = tapi.SketchSpec(kind="frequency", k=8, bits=BITS)
    assert tses.ingest_cache_spec(spec) is spec


def _feed_fifo(s, lo, hi):
    for i in range(lo, hi):
        t = i % 3
        keys = ttn.pack_keys(np.full(6, t), np.arange(6) + 10 * t, BITS)
        s.push(keys, np.ones(6, np.int32), tenant=t)


@pytest.mark.parametrize("resume_in", ["port", "reference"])
def test_per_tenant_window_fifos_roundtrip(resume_in):
    """Each tenant's window FIFO survives a checkpoint of either package:
    a resumed session equals the uninterrupted twin, and the port equals
    the reference throughout."""
    jspec, tspec = _specs(kind="frequency", k=64, bits=BITS, tenants=4)
    twin = tses.StreamSession(tspec, block=32, window=2, device=CPU)
    jtwin = jses.StreamSession(jspec, block=32, window=2)
    _feed_fifo(twin, 0, 12)
    _feed_fifo(jtwin, 0, 12)

    s1 = tses.StreamSession(tspec, block=32, window=2, device=CPU)
    _feed_fifo(s1, 0, 7)
    d = s1.save(include_schedule=True)
    j1 = jses.StreamSession(jspec, block=32, window=2)
    _feed_fifo(j1, 0, 7)
    jd = j1.save(include_schedule=True)
    for key in ("sched_batch_tenants", "sched_batch_lens",
                "sched_batch_items", "sched_batch_weights"):
        np.testing.assert_array_equal(d[key], np.asarray(jd[key]), key)
    if resume_in == "port":
        s2 = tses.StreamSession(tspec, block=32, window=2, device=CPU)
        s2.load(jd)
    else:
        s2 = jses.StreamSession(jspec, block=32, window=2)
        s2.load(d)
    assert sorted(s2.batch_fifos, key=str) == sorted(twin.batch_fifos,
                                                     key=str)
    _feed_fifo(s2, 7, 12)
    probe = ttn.pack_keys(np.repeat(np.arange(4), UNIVERSE),
                          np.tile(np.arange(UNIVERSE), 4),
                          BITS).astype(np.int32)
    want = twin.query_many(probe).numpy()
    np.testing.assert_array_equal(np.asarray(jtwin.query_many(probe)), want)
    np.testing.assert_array_equal(_np(s2.query_many(probe)), want)
    assert (twin.insertions, twin.deletions) == \
        (s2.insertions, s2.deletions) == (jtwin.insertions, jtwin.deletions)


def test_schedule_batch_returns_due_expiries():
    tspec = tapi.SketchSpec(kind="frequency", k=16, bits=BITS, tenants=2)
    jspec = japi.SketchSpec(kind="frequency", k=16, bits=BITS, tenants=2)
    ts = tses.StreamSession(tspec, block=16, window=1, device=CPU)
    js = jses.StreamSession(jspec, block=16, window=1)
    batches = [(t, np.arange(3, dtype=np.int32) + t * UNIVERSE,
                np.asarray([1, 2, 3], np.int32)) for t in (0, 1, 0, 0)]
    for t, i, w in batches:
        got = ts.schedule_batch(i, w, tenant=t)
        want = js.schedule_batch(i, w, tenant=t)
        assert len(got) == len(want)
        for (gi, gw), (wi, ww) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gw, ww)
    assert (ts.insertions, ts.deletions) == (js.insertions, js.deletions) \
        == (24, 12)
    assert [len(ts.batch_fifos[t]) for t in (None, 0, 1)] == [0, 1, 1]
    # without a window nothing is queued and nothing falls due
    free = tses.StreamSession(tspec, block=16, device=CPU)
    assert free.schedule_batch(batches[0][1], batches[0][2], 0) == []


def test_merge_from_carries_every_tenants_fifo():
    tspec = tapi.SketchSpec(kind="frequency", k=64, bits=BITS, tenants=4)
    a = tses.StreamSession(tspec, block=32, window=3, device=CPU)
    b = tses.StreamSession(tspec, block=32, window=3, device=CPU)
    _feed_fifo(a, 0, 4)
    _feed_fifo(b, 4, 8)
    want = {t: len(a.batch_fifos.get(t, ())) + len(b.batch_fifos.get(t, ()))
            for t in (None, 0, 1, 2)}
    a.merge_from(b)
    assert {t: len(a.batch_fifos.get(t, ())) for t in want} == want


def test_legacy_schedule_dict_loads_onto_default_fifo():
    jspec, tspec = _specs(kind="frequency", k=32, bits=BITS, tenants=2)
    s = jses.StreamSession(jspec, block=32, window=3)
    keys = ttn.pack_keys(np.zeros(4), np.arange(4), BITS)
    s.push(keys, np.ones(4, np.int32))  # the default (None) schedule
    d = s.save(include_schedule=True)
    d.pop("sched_batch_tenants")        # a dict from before the tags
    s2 = tses.StreamSession(tspec, block=32, window=3, device=CPU)
    fifo_before = s2.batch_fifo
    s2.load(d)
    assert s2.batch_fifo is fifo_before  # the stats trackers alias it
    assert len(s2.batch_fifo) == 1 and list(s2.batch_fifos) == [None]


def test_tenant_checkpoint_roundtrip_and_infer():
    jspec, js, tspec, ts = _built_banks(S=2)
    d = tapi.save(tspec, ts)
    jd = japi.save(jspec, js)
    assert set(d) == set(jd)
    for key in d:
        np.testing.assert_array_equal(d[key], np.asarray(jd[key]))
    plain = tapi.SketchSpec(kind="frequency", k=24, bits=BITS)
    inferred = tapi.infer_spec(plain, d)
    assert (inferred.tenants, inferred.shards) == (4, 2)
    jinf = japi.infer_spec(japi.SketchSpec(kind="frequency", k=24,
                                           bits=BITS), d)
    assert (inferred.tenants, inferred.shards, inferred.bits, inferred.k) \
        == (jinf.tenants, jinf.shards, jinf.bits, jinf.k)
    _same_bank(js.bank, tapi.restore(inferred, jd, CPU).bank, "port restores")
    _same_bank(japi.restore(jinf, d).bank, ts.bank, "ref restores")
    with pytest.raises(ValueError, match="infer_spec"):
        tapi.restore(plain, d, CPU)
    # tenant caps sized for another fleet give way to the dict's counters
    caps = tapi.SketchSpec(bits=BITS, tenants=2, tenant_caps=(3, 4))
    inf2, jinf2 = tapi.infer_spec(caps, d), japi.infer_spec(
        japi.SketchSpec(bits=BITS, tenants=2, tenant_caps=(3, 4)), d)
    assert (inf2.tenants, inf2.tenant_caps, inf2.k) == \
        (jinf2.tenants, jinf2.tenant_caps, jinf2.k)
    # a dict without item_bits takes them from a spec without bits
    back = tapi.infer_spec(tapi.SketchSpec(k=8), d)
    assert back.bits == BITS and back.tenants == 4
    # convert carries tenant checkpoints both ways
    spec, state = convert.to_port(jd, device=CPU)
    assert (spec.tenants, spec.shards, spec.bits) == (4, 2, BITS)
    _same_bank(js.bank, state.bank, "to_port")
    _same_bank(japi.restore(jinf, convert.to_reference(spec, state)).bank,
               ts.bank, "to_reference")
    # a session loads the reference's checkpoint onto the tenant layout
    sess = tses.StreamSession(plain, block=32, device=CPU)
    sess.load(jd)
    assert sess.spec.tenants == 4
    _same_bank(js.bank, sess.state.bank, "session load")


def test_recover_session_on_tenant_spec_waits_for_item_14():
    """Replay recovery on a tenant spec as the reference's (the name is
    the placeholder's, kept so the test's id carries over; item 14 has
    landed). Unsharded, the whole state is rebuilt: the live bank,
    poisoned after a schedule checkpoint, comes back equal to the
    reference's recovery and to a twin that never failed; an unknown
    option is refused."""
    from repro.sketch import elastic as jel
    from repro.sketch import faults as jfl
    from repro_torch.sketch import elastic as tel
    from repro_torch.sketch import faults as tfl

    jspec, tspec = _specs(kind="frequency", k=32, bits=BITS, tenants=4)
    js = jses.StreamSession(jspec, block=32, replay=16)
    ts = tses.StreamSession(tspec, block=32, replay=16, device=CPU)
    twin = tses.StreamSession(tspec, block=32, device=CPU)
    rng = np.random.default_rng(21)
    keys = ttn.pack_keys(rng.integers(0, 4, 96), rng.integers(0, UNIVERSE, 96),
                         BITS).astype(np.int32)
    for s in (js, ts, twin):
        s.ingest(keys[:32], np.ones(32, np.int32))
    jck, tck = js.save(include_schedule=True), ts.save(include_schedule=True)
    for s in (js, ts, twin):
        s.ingest(keys[32:], np.ones(64, np.int32))
    js.state = jfl.poison_rows(js.state, [1, 3])
    ts.state = tfl.poison_rows(ts.state, [1, 3])
    assert list(np.flatnonzero(tel.dead_shards(tspec, ts.state))) == [1, 3]
    jrep = jel.recover_session(js, jck)
    trep = tel.recover_session(ts, tck)
    assert (trep.rows, trep.replayed_blocks) == (jrep.rows,
                                                 jrep.replayed_blocks) \
        == ((), 2)
    _same_bank(js.state.bank, ts.state.bank, "recovered")
    _same_bank(twin.state.bank, ts.state.bank, "never failed")
    with pytest.raises(TypeError, match="replay_log"):
        tses.StreamSession(tspec, block=32, replay_log=16, device=CPU)


def test_topk_tenant_of_a_negative_tenant_reads_as_the_reference():
    """A negative tenant's row slice counts from the end of the bank, as
    the reference's dynamic slice reads it (it used to clamp to row 0)."""
    for shards in (1, 2):
        jspec, tspec = _specs(kind="frequency", k=3 * 24, bits=BITS,
                              tenants=3, **({"shards": 2} if shards > 1
                                            else {}))
        rng = np.random.default_rng(shards)
        keys = ttn.pack_keys(rng.integers(0, 3, 256),
                             rng.integers(0, 64, 256), BITS).astype(np.int32)
        js = japi.update(jspec, japi.make(jspec), keys, np.ones(256, np.int32))
        ts = tapi.update(tspec, tapi.make(tspec, CPU), keys,
                         np.ones(256, np.int32))
        for t in (-1, -2, -3, -7, 0, 2, 3, 9):
            for want, got in zip(japi.tenant_topk(jspec, js, t, 4),
                                 tapi.tenant_topk(tspec, ts, t, 4)):
                np.testing.assert_array_equal(got.numpy(), _np(want),
                                              err_msg=f"tenant {t}")
