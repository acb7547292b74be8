"""The port's SpaceSaving± family (``sketch/family.py``) against the
reference package, on ``tests/test_family.py``'s grid.

Double SpaceSaving± and CR-precis are held bit for bit: both banks (or
the counter rows) after every block, ``query_many``, ``topk``, merge,
consolidate, save/restore in both directions and through ``convert``,
plain, sharded and multi-tenant. The unbiased variant draws other
uniforms than the reference (the port does not reproduce
``jax.random.split``), so its row update is held in two ways: fed the
reference's own uniforms (drawn in the test as ``family.py:139-144``
draws them, ``u[b] = u_ref[b, owner(b)]`` for sorted position b) it is
the reference's ``_unbiased_rows`` bit for bit; on its own uniforms it
keeps the reference test's properties (exact mass per bank,
determinism per seed, no clamp). The package's exports are the
reference's. Inputs come from numpy seeds; the state is int32, so every
comparison is exact.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

import repro.sketch as jsketch
from helpers import random_strict_stream
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import family as jfam
from repro.sketch.session import StreamSession as JSession
from repro_torch import convert
from repro_torch import sketch as tsketch
from repro_torch.kernels.sketch_update import ops as tops
from repro_torch.kernels.sketch_update.ref import unbiased_update_ref
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import family as tfam
from repro_torch.sketch.session import StreamSession as TSession

BITS = 10
UNIVERSE = 1 << BITS
CPU = "cpu"
BLOCK = 256


def _stream(seed, n=2048, delete_frac=0.3, universe=UNIVERSE):
    rng = np.random.default_rng(seed)
    return random_strict_stream(rng, n, universe, delete_frac)


def _exact(items, weights, universe=UNIVERSE):
    f = np.zeros(universe, np.int64)
    np.add.at(f, items, weights)
    return f


def _specs(**kw):
    return japi.SketchSpec(**kw), tapi.SketchSpec(**kw)


def _same_dict(want, got, msg=""):
    assert set(want) == set(got), msg
    for key in want:
        np.testing.assert_array_equal(np.asarray(want[key]),
                                      np.asarray(got[key]),
                                      err_msg=f"{msg}: {key}")


def _same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.cpu().numpy(),
                                  err_msg=msg)


def _fed(jspec, tspec, items, weights, block=BLOCK):
    """Both packages fed the same blocks through ``api.update``; the saved
    states are held equal after every block."""
    js, ts = japi.make(jspec), tapi.make(tspec, device=CPU)
    for b, i in enumerate(range(0, len(items), block)):
        it, w = items[i:i + block], weights[i:i + block]
        js = japi.update(jspec, js, it, w)
        ts = tapi.update(tspec, ts, it, w)
        _same_dict(japi.save(jspec, js), tapi.save(tspec, ts), f"block {b}")
    return js, ts


# ---------------------------------------------------------------------------
# Double SpaceSaving±
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,alpha", [(300, 2.0), (2, 2.0), (400000, 2.0),
                                         (64, 1.25), (97, 4.0)])
def test_double_capacities_split(total, alpha):
    assert tfam.double_capacities(total, alpha) \
        == jfam.double_capacities(total, alpha)
    with pytest.raises(ValueError, match="k >= 2"):
        tfam.double_capacities(1, alpha)


@pytest.mark.parametrize("shards", [None, 4])
def test_double_two_sided_bound(shards):
    """Both banks equal the reference's after every block, every universe
    id answers as there, and the family bound holds per owner row."""
    items, weights = _stream(0)
    jspec, tspec = _specs(kind="frequency", k=64, variant="double",
                          shards=shards, bits=BITS)
    js, ts = _fed(jspec, tspec, items, weights)
    probe = np.arange(UNIVERSE)
    est = tapi.query_many(tspec, ts, probe)
    _same(japi.query_many(jspec, js, probe), est)
    est = est.numpy().astype(np.int64)
    k_i, k_d = tfam.double_capacities(64, tspec.alpha)
    R = shards or 1
    per_i, per_d = -(-k_i // R), -(-k_d // R)
    owner = tbk.shard_of(torch.arange(UNIVERSE, dtype=torch.int32),
                         R).numpy()
    so = owner[items]
    ins_r = np.bincount(so[weights > 0], minlength=R).astype(float)
    del_r = np.bincount(so[weights < 0], minlength=R).astype(float)
    slack = (ins_r / per_i + del_r / per_d)[owner]
    assert (np.abs(est - _exact(items, weights)) <= slack + 1e-9).all()
    assert est.min() >= 0


@pytest.mark.parametrize("shards", [None, 3])
def test_double_topk_reports_heavy_hitters(shards):
    items, weights = _stream(1, n=4096, delete_frac=0.4)
    jspec, tspec = _specs(kind="frequency", k=128, variant="double",
                          bits=BITS, shards=shards)
    js, ts = _fed(jspec, tspec, items, weights)
    k_i, k_d = tfam.double_capacities(128, tspec.alpha)
    for m in (1, 7, k_i - (k_i % (shards or 1))):
        ids, vals = tapi.topk(tspec, ts, m)
        want_ids, want_vals = japi.topk(jspec, js, m)
        _same(want_ids, ids, f"m={m}")
        _same(want_vals, vals, f"m={m}")
    ins = int(weights[weights > 0].sum())
    dels = int(-weights[weights < 0].sum())
    slack = ins / k_i + dels / k_d
    ids, _ = tapi.topk(tspec, ts, k_i - (k_i % (shards or 1)))
    got = {int(x) for x in ids.numpy() if x >= 0}
    assert set(np.flatnonzero(_exact(items, weights) > 2 * slack)) <= got


def test_topk_double_chunks_rows_without_changing_the_result(monkeypatch):
    """The (rows, k_I, k_D) match built a few rows at a time gives the
    one-chunk answer, both variants."""
    items, weights = _stream(2, n=2048, delete_frac=0.4)
    for variant in ("double", "unbiased"):
        spec = tapi.SketchSpec(k=96, variant=variant, shards=5, bits=BITS)
        st = tapi.update(spec, tapi.make(spec, device=CPU), items, weights)
        whole = tfam.topk_double(st, 40, clamp=variant == "double")
        monkeypatch.setattr(tfam, "_MATCH_ENTRIES", 1)
        parts = tfam.topk_double(st, 40, clamp=variant == "double")
        monkeypatch.undo()
        for a, b in zip(whole, parts):
            assert torch.equal(a, b)


def test_double_ingests_deletes_as_second_bank_inserts():
    jspec, tspec = _specs(kind="frequency", k=32, variant="double")
    items = np.arange(8, dtype=np.int32)
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), items,
                     np.ones(8, np.int32))
    js = japi.update(jspec, japi.make(jspec), items, np.ones(8, np.int32))
    ins_counts = int(ts.ins.counts.sum())
    ts = tapi.update(tspec, ts, items[:4], -np.ones(4, np.int32))
    js = japi.update(jspec, js, items[:4], -np.ones(4, np.int32))
    _same_dict(japi.save(jspec, js), tapi.save(tspec, ts))
    assert int(ts.ins.counts.sum()) == ins_counts
    assert int(ts.dels.counts.sum()) == 4
    est = tapi.query_many(tspec, ts, items)
    np.testing.assert_array_equal(est.numpy(), [0, 0, 0, 0, 1, 1, 1, 1])


@pytest.mark.parametrize("seed,split_frac,delete_frac",
                         [(0, 0.1, 0.0), (17, 0.5, 0.3), (4242, 0.9, 0.45),
                          (9999, 0.33, 0.2)])
def test_double_merge_meets_family_bound(seed, split_frac, delete_frac):
    """The reference's hypothesis property at fixed draws: the merge of
    two halves equals the reference's merge, within the whole stream's
    family slack."""
    items, weights = _stream(seed, n=1024, delete_frac=delete_frac,
                             universe=256)
    cut = int(len(items) * split_frac)
    jspec, tspec = _specs(kind="frequency", k=48, variant="double", bits=8)
    ja = japi.update(jspec, japi.make(jspec), items[:cut], weights[:cut])
    jb = japi.update(jspec, japi.make(jspec), items[cut:], weights[cut:])
    ta = tapi.update(tspec, tapi.make(tspec, device=CPU), items[:cut],
                     weights[:cut])
    tb = tapi.update(tspec, tapi.make(tspec, device=CPU), items[cut:],
                     weights[cut:])
    merged = tapi.merge(tspec, ta, tb)
    _same_dict(japi.save(jspec, japi.merge(jspec, ja, jb)),
               tapi.save(tspec, merged))
    est = tapi.query_many(tspec, merged, np.arange(256)).numpy()
    k_i, k_d = tfam.double_capacities(48, tspec.alpha)
    ins = int(weights[weights > 0].sum())
    dels = int(-weights[weights < 0].sum())
    f = _exact(items, weights, 256)
    assert np.abs(est - f).max() <= ins / k_i + dels / k_d + 1e-9


@pytest.mark.parametrize("variant", ["double", "unbiased"])
def test_double_consolidate_equals_the_reference(variant):
    items, weights = _stream(3, n=1024)
    jspec, tspec = _specs(kind="frequency", k=64, variant=variant,
                          shards=5, bits=BITS)
    js = japi.update(jspec, japi.make(jspec), items, weights)
    # the same banks in both packages (the unbiased ones differ when fed)
    ts = tapi.restore(tspec, japi.save(jspec, js), CPU)
    jc, tc = japi.consolidate(jspec, js), tapi.consolidate(tspec, ts)
    for want, got in ((jc.ins, tc.ins), (jc.dels, tc.dels)):
        for a, b in zip(want, got):
            _same(a, b)
    _same(jc.key, tc.key)
    one = tapi.SketchSpec(kind="frequency", k=64, variant=variant)
    assert tapi.consolidate(one, tc) is tc


# ---------------------------------------------------------------------------
# Unbiased SpaceSaving±
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def _ref_uniforms(key, B, R):
    """(B, R) uniforms as ``_unbiased_rows`` draws them
    (``family.py:139-144``): a key split per block position."""
    def step(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.uniform(sub, (R,))

    return jax.lax.scan(step, key, None, length=B)[1]


def _routers(kind, R, bits):
    if kind == "hash":
        return jbk.HashShardRouter(R, bits), tbk.HashShardRouter(R, bits)
    T, S = R
    return jbk.TenantRouter(T, bits, S), tbk.TenantRouter(T, bits, S)


@pytest.mark.parametrize("kind,R,k,delete_frac", [
    ("hash", 1, 6, 0.3),
    ("hash", 1, 64, 0.45),
    ("hash", 4, 16, 0.3),
    ("hash", 3, 2, 0.2),
    ("tenant", (3, 1), 12, 0.4),
    ("tenant", (2, 2), 8, 0.3),
])
def test_unbiased_row_update_fed_the_reference_uniforms(kind, R, k,
                                                        delete_frac):
    """The port's plain row update (the unbiased kernel's plain version),
    fed the reference's own uniforms, is the reference's
    ``update_unbiased`` bit for bit, block after block."""
    bits = 6
    jr, tr = _routers(kind, R, bits)
    rows = tr.num_rows
    universe = 1 << (bits + (tr.tenant_bits if kind == "tenant" else 0))
    js = jfam.init_double(k * rows, 2.0, rows, seed=5, unbiased=True)
    ts = tapi.restore(tapi.SketchSpec(k=k * rows, variant="unbiased",
                                      shards=rows),
                      {"layout": np.int32(3), "family": np.int32(2),
                       "ids": np.asarray(js.ins.ids),
                       "counts": np.asarray(js.ins.counts),
                       "errors": np.asarray(js.ins.errors),
                       "ids_del": np.asarray(js.dels.ids),
                       "counts_del": np.asarray(js.dels.counts),
                       "errors_del": np.asarray(js.dels.errors),
                       "key": np.asarray(js.key), "shards": np.int32(rows),
                       "tenants": np.int32(0), "item_bits": np.int32(0)},
                      CPU)
    items, weights = _stream(11 + rows, n=4 * BLOCK, delete_frac=delete_frac,
                             universe=universe)
    for b in range(4):
        it = items[b * BLOCK:(b + 1) * BLOCK]
        w = weights[b * BLOCK:(b + 1) * BLOCK]
        if b == 3:          # padding inside a block is a no-op
            w = np.where(np.arange(BLOCK) % 5 == 0, 0, w).astype(np.int32)
        key_i, key_d, _ = jax.random.split(js.key, 3)
        u_i = np.asarray(_ref_uniforms(key_i, BLOCK, rows))
        u_d = np.asarray(_ref_uniforms(key_d, BLOCK, rows))
        js = jfam.update_unbiased(js, jnp.asarray(it), jnp.asarray(w), jr)
        s_items, _, _, _ = tfam.unbiased_prep(torch.from_numpy(it),
                                              torch.from_numpy(w), tr)
        owner = np.clip(tr.owner_of(s_items).numpy(), 0, rows - 1)
        pos = np.arange(BLOCK)
        u = torch.from_numpy(np.stack([u_i[pos, owner], u_d[pos, owner]]))
        ins, dels = tops.unbiased_update_with(
            unbiased_update_ref, ts.ins, ts.dels, torch.from_numpy(it),
            torch.from_numpy(w), u, tr)
        ts = tfam.DoubleState(ins, dels, ts.key)
        for want, got in ((js.ins, ins), (js.dels, dels)):
            for name, a, g in zip(("ids", "counts", "errors"), want, got):
                _same(a, g, f"block {b} {name}")


def test_unbiased_prep_lists_each_rows_positions_in_block_order():
    rng = np.random.default_rng(7)
    items = torch.from_numpy(rng.integers(0, 64, 300).astype(np.int32))
    weights = torch.from_numpy(rng.choice([-3, -1, 0, 1, 2], 300)
                               .astype(np.int32))
    router = tbk.HashShardRouter(5, 6)
    s_items, s_w, perm, roff = tfam.unbiased_prep(items, weights, router)
    assert torch.equal(s_items, torch.sort(items, stable=True).values)
    owner = router.owner_of(s_items).numpy()
    p = perm.numpy()
    roff = roff.numpy()
    assert roff[0] == 0 and roff[-1] == int((s_w != 0).sum())
    for c in range(10):
        seg = p[roff[c]:roff[c + 1]]
        assert (np.diff(seg) > 0).all()
        side = s_w.numpy()[seg]
        assert ((side > 0) if c < 5 else (side < 0)).all()
        assert (owner[seg] == c % 5).all()
    assert sorted(p[roff[-1]:]) == sorted(np.flatnonzero(s_w.numpy() == 0))


def test_uniforms_are_a_function_of_the_key():
    key = torch.tensor([0, 5], dtype=torch.uint32)
    u = tfam.uniforms(key, 4096)
    assert u.shape == (2, 4096) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    assert not torch.equal(u[0], u[1])
    assert torch.equal(u, tfam.uniforms(key.clone(), 4096))
    nxt = tfam.next_key(key)
    assert nxt.dtype == torch.uint32 and not torch.equal(nxt, key)
    assert not torch.equal(tfam.uniforms(nxt, 16), u[:, :16])
    # the first n positions do not depend on n
    assert torch.equal(tfam.uniforms(key, 100), u[:, :100])


@pytest.mark.parametrize("shards", [None, 4])
def test_unbiased_conserves_stream_mass_per_bank(shards):
    items, weights = _stream(2, n=2048, delete_frac=0.35)
    spec = tapi.SketchSpec(kind="frequency", k=64, variant="unbiased",
                           bits=BITS, shards=shards)
    state = tapi.make(spec, device=CPU)
    for i in range(0, len(items), BLOCK):
        state = tapi.update(spec, state, items[i:i + BLOCK],
                            weights[i:i + BLOCK])
    assert int(state.ins.counts.sum()) == int(weights[weights > 0].sum())
    assert int(state.dels.counts.sum()) == int(-weights[weights < 0].sum())


def test_unbiased_is_deterministic_per_seed():
    items, weights = _stream(3, n=1024)
    spec = tapi.SketchSpec(kind="frequency", k=64, variant="unbiased",
                           bits=BITS)
    s1, s2 = tapi.make(spec, device=CPU), tapi.make(spec, device=CPU)
    for i in range(0, len(items), BLOCK):
        s1 = tapi.update(spec, s1, items[i:i + BLOCK], weights[i:i + BLOCK])
        s2 = tapi.update(spec, s2, items[i:i + BLOCK], weights[i:i + BLOCK])
    _same_dict(tapi.save(spec, s1), tapi.save(spec, s2))
    # another seed's key gives another state
    s3 = tfam.init_double(64, 2.0, seed=9, unbiased=True, device=CPU)
    for i in range(0, len(items), BLOCK):
        s3 = tapi.update(spec, s3, items[i:i + BLOCK], weights[i:i + BLOCK])
    assert not torch.equal(s3.ins.ids, s1.ins.ids) \
        or not torch.equal(s3.ins.counts, s1.ins.counts)


def test_unbiased_estimates_are_not_clamped():
    """The raw difference may go below zero: a deleted id evicted from
    the tiny insert bank survives in the delete bank."""
    spec = tapi.SketchSpec(kind="frequency", k=4, variant="unbiased")
    n = 64
    items = np.concatenate([[7], np.arange(100, 100 + n)]).astype(np.int32)
    state = tapi.update(spec, tapi.make(spec, device=CPU), items,
                        np.ones(n + 1, np.int32))
    state = tapi.update(spec, state, np.asarray([7], np.int32),
                        np.asarray([-1], np.int32))
    est = int(tapi.query_many(spec, state, np.asarray([7]))[0])
    k_i, _ = tfam.double_capacities(4, spec.alpha)
    assert est <= n // k_i
    # 7 left the insert bank (it holds 3 counters and 64 later ids) but
    # the delete bank has it: the estimate is the raw -1, not 0
    if 7 not in state.ins.ids.tolist():
        assert est == -1


def test_unbiased_init_key_is_the_reference_prng_key():
    for seed in (0, 5, -1, 2**32 + 7):
        want = np.asarray(jfam.init_double(8, 2.0, seed=seed,
                                           unbiased=True).key)
        got = tfam.init_double(8, 2.0, seed=seed, unbiased=True,
                               device=CPU).key
        np.testing.assert_array_equal(want, got.numpy())
        assert got.dtype == torch.uint32


# ---------------------------------------------------------------------------
# CR-precis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total", [16, 63, 64, 256, 1000, 400000])
def test_crprecis_primes_respect_budget(total):
    want = jfam.init_crprecis(total)
    got = tfam.init_crprecis(total, device=CPU)
    _same(want.primes, got.primes)
    assert tuple(got.counts.shape) == tuple(want.counts.shape)
    assert int(got.primes.sum()) <= total
    assert tfam.crprecis_depth(total) == jfam.crprecis_depth(total)
    with pytest.raises(ValueError, match="prime"):
        tfam.init_crprecis(4, device=CPU)


def test_crprecis_never_underestimates():
    items, weights = _stream(4, n=2048, delete_frac=0.4)
    jspec, tspec = _specs(kind="frequency", k=128, backend="crprecis",
                          bits=BITS)
    js, ts = _fed(jspec, tspec, items, weights)
    probe = np.arange(UNIVERSE)
    est = tapi.query_many(tspec, ts, probe)
    _same(japi.query_many(jspec, js, probe), est)
    assert (est.numpy() >= _exact(items, weights)).all()
    # negative ids answer 0, as in the reference
    odd = np.asarray([-1, -7, 3], np.int32)
    _same(japi.query_many(jspec, js, odd), tapi.query_many(tspec, ts, odd))


def test_crprecis_update_wraps_and_saturates_as_the_reference():
    """Weights whose per-counter delta passes int32 inside one block wrap
    in the scatter-add, then land with a saturating add, in both."""
    jspec, tspec = _specs(kind="frequency", k=64, backend="crprecis",
                          bits=8)
    big = 2**30
    items = np.asarray([3, 3, 17, 5], np.int32)
    weights = np.asarray([big, big - 1, 1, 1], np.int32)
    js, ts = japi.make(jspec), tapi.make(tspec, device=CPU)
    for _ in range(3):
        js = jfam.update_crprecis(js, jnp.asarray(items), jnp.asarray(weights))
        ts = tfam.update_crprecis(ts, torch.from_numpy(items),
                                  torch.from_numpy(weights))
        _same(js.counts, ts.counts)


def test_crprecis_merge_is_linear():
    items, weights = _stream(5, n=1024)
    jspec, tspec = _specs(kind="frequency", k=64, backend="crprecis",
                          bits=BITS)
    whole = tapi.update(tspec, tapi.make(tspec, device=CPU), items, weights)
    a = tapi.update(tspec, tapi.make(tspec, device=CPU), items[:600],
                    weights[:600])
    b = tapi.update(tspec, tapi.make(tspec, device=CPU), items[600:],
                    weights[600:])
    merged = tapi.merge(tspec, a, b)
    assert torch.equal(merged.counts, whole.counts)
    ja = japi.update(jspec, japi.make(jspec), items[:600], weights[:600])
    jb = japi.update(jspec, japi.make(jspec), items[600:], weights[600:])
    _same_dict(japi.save(jspec, japi.merge(jspec, ja, jb)),
               tapi.save(tspec, merged))


def test_crprecis_merge_rejects_mismatched_moduli():
    spec_a = tapi.SketchSpec(kind="frequency", k=64, backend="crprecis")
    spec_b = tapi.SketchSpec(kind="frequency", k=128, backend="crprecis")
    with pytest.raises(ValueError, match="moduli"):
        tapi.merge(spec_a, tapi.make(spec_a, device=CPU),
                   tapi.make(spec_b, device=CPU))


def test_crprecis_topk_needs_enumerable_universe():
    spec = tapi.SketchSpec(kind="frequency", k=64, backend="crprecis")
    with pytest.raises(ValueError, match="bits"):
        tapi.topk(spec, tapi.make(spec, device=CPU), 4)
    with pytest.raises(ValueError, match="bits"):
        wide = tapi.SketchSpec(kind="frequency", k=64, backend="crprecis",
                               bits=21)
        tapi.topk(wide, tapi.make(wide, device=CPU), 4)
    jspec, tspec = _specs(kind="frequency", k=64, backend="crprecis", bits=8)
    it = np.asarray([3, 3, 5], np.int32)
    w = np.asarray([2, 3, 1], np.int32)
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), it, w)
    js = japi.update(jspec, japi.make(jspec), it, w)
    ids, vals = tapi.topk(tspec, ts, 2)
    assert int(ids[0]) == 3 and int(vals[0]) == 5
    for m in (2, 9, 256):
        for want, got in zip(japi.topk(jspec, js, m), tapi.topk(tspec, ts, m)):
            _same(want, got, f"m={m}")


# ---------------------------------------------------------------------------
# Checkpoints, sessions, the registry
# ---------------------------------------------------------------------------

FAMILY_CELLS = [
    ("double", dict(variant="double")),
    ("double-sh", dict(variant="double", shards=4)),
    ("unbiased", dict(variant="unbiased")),
    ("unbiased-sh", dict(variant="unbiased", shards=4)),
    ("crprecis", dict(backend="crprecis")),
]


@pytest.mark.parametrize("label,spec_kw", FAMILY_CELLS)
def test_family_save_restore_roundtrip(label, spec_kw):
    """The tags, ``infer_spec`` and ``restore`` as the reference's; a dict
    of either package restores in the other with the same answers, and
    ``convert`` carries the state both ways."""
    items, weights = _stream(6, n=1024)
    jspec, tspec = _specs(kind="frequency", k=64, bits=BITS, **spec_kw)
    js, ts = japi.make(jspec), tapi.make(tspec, device=CPU)
    for i in range(0, len(items), BLOCK):
        js = japi.update(jspec, js, items[i:i + BLOCK], weights[i:i + BLOCK])
        ts = tapi.update(tspec, ts, items[i:i + BLOCK], weights[i:i + BLOCK])
    jd, td = japi.save(jspec, js), tapi.save(tspec, ts)
    assert set(jd) == set(td)
    for key in jd:
        assert np.asarray(jd[key]).dtype == np.asarray(td[key]).dtype, key
    if label.startswith("unbiased"):
        # other uniforms, other banks: the reference's state crosses over
        ts = tapi.restore(tspec, jd, CPU)
        td = tapi.save(tspec, ts)
    _same_dict(jd, td)
    base_j, base_t = _specs(kind="frequency", k=64, bits=BITS)
    for d in (jd, td):
        inf_t, inf_j = tapi.infer_spec(base_t, d), japi.infer_spec(base_j, d)
        assert (inf_t.variant, inf_t.backend, inf_t.shards, inf_t.kind) \
            == (inf_j.variant, inf_j.backend, inf_j.shards, inf_j.kind)
        assert tapi.spec_axis(inf_t) == tapi.spec_axis(tspec)
    probe = np.arange(UNIVERSE)
    inferred = tapi.infer_spec(base_t, jd)
    restored = tapi.restore(inferred, jd, CPU)
    _same(japi.query_many(jspec, js, probe),
          tapi.query_many(inferred, restored, probe))
    back = japi.restore(japi.infer_spec(base_j, td), td)
    _same_dict(japi.save(jspec, back), td)
    # one more ingest after restore works in both (the key survives)
    nxt = (items[:BLOCK], weights[:BLOCK])
    _same_dict(japi.save(jspec, japi.update(jspec, js, *nxt)),
               tapi.save(tspec, tapi.update(tspec, restored, *nxt))) \
        if not label.startswith("unbiased") else \
        tapi.update(inferred, restored, *nxt)
    # convert both ways
    spec, state = convert.to_port(jd, device=CPU)
    assert tapi.spec_axis(spec) == tapi.spec_axis(tspec)
    assert spec.shards == tspec.shards
    _same_dict(jd, tapi.save(spec, state))
    got = japi.restore(japi.infer_spec(base_j, convert.to_reference(
        spec, state)), convert.to_reference(spec, state))
    _same_dict(jd, japi.save(jspec, got))


def test_family_restore_wrong_axis_fails_loudly():
    for kw in (dict(variant="double"), dict(backend="crprecis")):
        spec_d = tapi.SketchSpec(kind="frequency", k=64, **kw)
        spec_p = tapi.SketchSpec(kind="frequency", k=64)
        d = tapi.save(spec_d, tapi.make(spec_d, device=CPU))
        with pytest.raises(ValueError, match="infer_spec"):
            tapi.restore(spec_p, d, CPU)
        with pytest.raises(ValueError, match="infer_spec"):
            tapi.restore(spec_d, tapi.save(spec_p,
                                           tapi.make(spec_p, device=CPU)),
                         CPU)
    spec = tapi.SketchSpec(kind="frequency", k=64, variant="double",
                           shards=2)
    d = tapi.save(spec, tapi.make(spec, device=CPU))
    del d["counts_del"]
    with pytest.raises(ValueError, match="missing"):
        tapi.restore(spec, d, CPU)
    with pytest.raises(ValueError, match="rows"):
        bad = tapi.save(spec, tapi.make(spec, device=CPU))
        tapi.adapter_for(spec).restore(
            tapi.SketchSpec(kind="frequency", k=64, variant="double",
                            shards=3), bad, CPU)


@pytest.mark.parametrize("spec_kw", [dict(variant="double"),
                                     dict(variant="unbiased"),
                                     dict(backend="crprecis")])
def test_family_session_zero_consumer_changes(spec_kw):
    """A session ingests, queries, saves and loads a family spec with the
    base layouts' consumer code; the deterministic members equal the
    reference's session, and a checkpoint of either loads in the other."""
    items, weights = _stream(7, n=1500)
    jspec, tspec = _specs(kind="frequency", k=64, bits=BITS, **spec_kw)
    js, ts = JSession(jspec, block=BLOCK), TSession(tspec, block=BLOCK,
                                                    device=CPU)
    js.extend(items, weights)
    ts.extend(items, weights)
    probe = np.arange(UNIVERSE)
    q = ts.query_many(probe)
    if spec_kw.get("variant") != "unbiased":
        _same(js.query_many(probe), q)
        _same_dict(js.save(), ts.save())
    d = ts.save()
    t2 = TSession(tapi.SketchSpec(kind="frequency", k=64, bits=BITS),
                  block=BLOCK, device=CPU)
    t2.load(d)
    assert torch.equal(t2.query_many(probe), q)
    j2 = JSession(japi.SketchSpec(kind="frequency", k=64, bits=BITS),
                  block=BLOCK)
    j2.load(d)
    _same(j2.query_many(probe), q)
    t3 = TSession(tapi.SketchSpec(kind="frequency", k=64, bits=BITS),
                  block=BLOCK, device=CPU)
    t3.load(js.save())
    _same(js.query_many(probe), t3.query_many(probe))


def test_family_specs_and_registry_as_the_reference():
    for kw in (dict(variant="double"), dict(variant="unbiased"),
               dict(backend="crprecis"), dict(variant="double", shards=3),
               dict(variant="unbiased", tenants=4, bits=8),
               dict(variant="double", tenants=4, bits=8, shards=2)):
        jspec, tspec = _specs(kind="frequency", k=64, **kw)
        assert tspec.capacity == jspec.capacity
        assert tspec.variant_id == jspec.variant_id
        assert tapi.spec_axis(tspec) == japi.spec_axis(jspec)
        assert type(tapi.adapter_for(tspec)).__name__ \
            == type(japi.adapter_for(jspec)).__name__
    for bad in (dict(kind="quantile", k=64, bits=8, variant="double"),
                dict(bits=8, tenants=2, tenant_caps=(8, 8),
                     variant="unbiased"),
                dict(k=64, backend="crprecis", shards=2),
                dict(k=64, backend="crprecis", variant="lazy"),
                dict(k=64, variant="double", backend="block")):
        with pytest.raises(ValueError) as want:
            japi.SketchSpec(**bad)
        with pytest.raises(ValueError) as got:
            tapi.SketchSpec(**bad)
        assert str(got.value) == str(want.value)
    assert tapi.VARIANTS == japi.VARIANTS


def test_sketch_package_exports_the_reference_names():
    want = set(jsketch.__all__) - {"jax_sketch"}
    assert set(tsketch.__all__) == want
    for name in want:
        assert getattr(tsketch, name) is not None, name
    assert tsketch.FaultPlan is tsketch.faults.FaultPlan
    assert tsketch.StreamSession is tsketch.session.StreamSession
    with pytest.raises(AttributeError):
        tsketch.jax_sketch


@pytest.mark.parametrize("variant", ["double", "unbiased"])
@pytest.mark.parametrize("shards", [None, 2])
def test_family_tenant_specs_as_the_reference(variant, shards):
    """Multi-tenant family specs: per-tenant rows on both banks, composite
    keys, ``tenant_topk`` in raw items; the double banks equal the
    reference's, the unbiased ones are held on the reference's state."""
    from repro_torch.sketch import tenant as ttn

    T, bits = 3, 6
    jspec, tspec = _specs(kind="frequency", k=T * 24, bits=bits, tenants=T,
                          shards=shards, variant=variant)
    rng = np.random.default_rng(31)
    tenants = rng.integers(0, T, 1024)
    items, weights = random_strict_stream(rng, 1024, 1 << bits, 0.3)
    keys = ttn.pack_keys(tenants, items, bits).astype(np.int32)
    js, ts = japi.make(jspec), tapi.make(tspec, device=CPU)
    for i in range(0, 1024, BLOCK):
        js = japi.update(jspec, js, keys[i:i + BLOCK], weights[i:i + BLOCK])
        ts = tapi.update(tspec, ts, keys[i:i + BLOCK], weights[i:i + BLOCK])
    if variant == "unbiased":
        ts = tapi.restore(tspec, japi.save(jspec, js), CPU)
    _same_dict(japi.save(jspec, js), tapi.save(tspec, ts))
    probe = ttn.pack_keys(np.repeat(np.arange(T), 64),
                          np.tile(np.arange(64), T), bits).astype(np.int32)
    probe = np.concatenate([probe, [T << bits, (T + 5) << bits]]) \
        .astype(np.int32)   # keys past the last tenant clamp as there
    _same(japi.query_many(jspec, js, probe),
          tapi.query_many(tspec, ts, probe))
    for t in (0, 2, -1, T + 1):
        for want, got in zip(japi.tenant_topk(jspec, js, t, 5),
                             tapi.tenant_topk(tspec, ts, t, 5)):
            _same(want, got, f"tenant {t}")
    for want, got in zip(japi.topk(jspec, js, 9), tapi.topk(tspec, ts, 9)):
        _same(want, got)
    assert tapi.consolidate(tspec, ts) is ts
    spec, state = convert.to_port(japi.save(jspec, js), device=CPU)
    assert (spec.tenants, spec.shards, spec.variant) == (T, shards, variant)
    _same_dict(japi.save(jspec, js), tapi.save(spec, state))
