"""The port's sketch primitives against their JAX reference functions.

Each case makes its inputs with a numpy seed, hands the same arrays to
``repro`` (JAX) and ``repro_torch`` (torch, on the CPU) and requires
exact equality: the sketch state is int32, so there is no tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro.sketch import bank as jbk
from repro.sketch import phases as jph
from repro.sketch import state as jst
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import phases as tph
from repro_torch.sketch import state as tst

IMAX = 2**31 - 1


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _near_rail(rng, shape):
    """int32 values spread over the whole range, many within 3 of a rail."""
    pick = rng.integers(0, 4, shape)
    vals = np.where(pick == 0, IMAX - rng.integers(0, 4, shape),
                    np.where(pick == 1, -IMAX + rng.integers(0, 4, shape),
                             rng.integers(-IMAX, IMAX, shape)))
    return vals.astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_sat_add_near_rail(seed):
    rng = np.random.default_rng(seed)
    a, b = _near_rail(rng, 4096), _near_rail(rng, 4096)
    _eq(jst.sat_add(jnp.asarray(a), jnp.asarray(b)), tst.sat_add(_t(a), _t(b)))


def test_shard_of_full_id_range_and_padding():
    rng = np.random.default_rng(1)
    ids = np.concatenate([
        rng.integers(0, IMAX, 4000), [0, 1, IMAX, IMAX - 1, 2**30],
        [-1, -2, -3, -IMAX - 1]]).astype(np.int32)
    for S in (1, 3, 4, 128, 1000):
        _eq(jbk.shard_of(jnp.asarray(ids), S), tbk.shard_of(_t(ids), S), f"S={S}")


@pytest.mark.parametrize("bits", [None, 12, 30])
def test_sort_block_and_route(bits):
    rng = np.random.default_rng(2)
    items = rng.integers(0, 1 << 12, 256).astype(np.int32)
    weights = rng.integers(-3, 4, 256).astype(np.int32)
    _eq(jbk.sort_block(jnp.asarray(items), bits), tbk.sort_block(_t(items), bits))
    ji, jw = jbk.HashShardRouter(4, bits).route_dense(jnp.asarray(items),
                                                      jnp.asarray(weights))
    ti, tw = tbk.HashShardRouter(4, bits).route_dense(_t(items), _t(weights))
    _eq(ji, ti)
    _eq(jw, tw)


@pytest.mark.parametrize("shared", [False, True])
def test_segment_nets(shared):
    rng = np.random.default_rng(3)
    R, B = 5, 300
    items = np.sort(rng.integers(0, 60, (R, B)), axis=1).astype(np.int32)
    weights = rng.integers(-4, 5, (1 if shared else R, B)).astype(np.int32)
    jh, jn = jph.segment_nets(jnp.asarray(items), jnp.asarray(weights))
    th, tn = tph.segment_nets(_t(items), _t(weights))
    _eq(jh, th)
    # net is defined at segment heads only
    np.testing.assert_array_equal(np.asarray(jn)[np.asarray(jh)],
                                  tn.numpy()[th.numpy()])


def _rows(rng, R, K, rail=False):
    ids = rng.integers(-1, 50, (R, K)).astype(np.int32)
    counts = (_near_rail(rng, (R, K)) if rail
              else rng.integers(-5, 40, (R, K)).astype(np.int32))
    errors = rng.integers(0, 6, (R, K)).astype(np.int32)
    blocked = rng.random((R, K)) < 0.1
    ids[blocked] = -2
    counts[blocked] = IMAX
    errors[blocked] = 0
    return ids, counts, errors


@pytest.mark.parametrize("seed", range(3))
def test_fill_empty_slots(seed):
    rng = np.random.default_rng(seed)
    R, K, B = 6, 70, 40
    ids, counts, errors = _rows(rng, R, K)
    uids = rng.integers(100, 200, R * B).astype(np.int32)
    nets = rng.integers(1, 9, R * B).astype(np.int32)
    n_ins = rng.integers(0, 30, R).astype(np.int32)
    off = (np.arange(R) * B + rng.integers(0, B, R)).astype(np.int32)
    want = jax.vmap(jph.fill_empty_slots, in_axes=(0, 0, 0, None, None, 0, 0))(
        *map(jnp.asarray, (ids, counts, errors, uids, nets, n_ins, off)))
    got = tph.fill_empty_slots(*map(_t, (ids, counts, errors, uids, nets,
                                         n_ins, off)))
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("rail", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_waterfill_unit_inserts(seed, rail):
    rng = np.random.default_rng(10 + seed)
    R, K, B = 6, 90, 64
    ids, counts, errors = _rows(rng, R, K, rail)
    uu = rng.integers(100, 10_000, R * B).astype(np.int32)
    m = rng.integers(0, B + 1, R).astype(np.int32)
    off = (np.arange(R) * B).astype(np.int32)
    want = jax.vmap(jph.waterfill_unit_inserts, in_axes=(0, 0, 0, None, 0, 0))(
        *map(jnp.asarray, (ids, counts, errors, uu, m, off)))
    got = tph.waterfill_unit_inserts(*map(_t, (ids, counts, errors, uu, m, off)))
    for w, g in zip(want, got):
        _eq(w, g)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_phase1_dense_prep(variant, warm):
    rng = np.random.default_rng(20 + variant + 2 * warm)
    S, K, B = 4, 50, 256
    jb = jbk.init([K] * S)
    if warm:
        items = rng.integers(0, 300, B).astype(np.int32)
        jb = jbk.update_block_fused(jb, jnp.asarray(items),
                                    jnp.ones(B, jnp.int32),
                                    jbk.HashShardRouter(S, 16), variant)
    items = rng.integers(0, 300, B).astype(np.int32)
    weights = rng.choice([-2, -1, 0, 1, 1, 2, 5], B).astype(np.int32)
    ri, rw = jbk.HashShardRouter(S, 16).route_dense(jnp.asarray(items),
                                                    jnp.asarray(weights))
    want = jbk.phase1_dense_prep(jb, ri, rw, variant)
    tb = tst.SketchState(*(_t(np.asarray(x)) for x in jb))
    got = tbk.phase1_dense_prep(tb, _t(np.asarray(ri)), _t(np.asarray(rw)),
                                variant)
    names = ("delta", "h_uids", "h_net", "i0", "mu", "nnu", "w_del")
    for name, w, g in zip(names, want, got):
        _eq(w, g.reshape(-1) if name in ("h_uids", "h_net") else g, name)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("rail", [False, True])
def test_residual_phase_banked(variant, rail):
    rng = np.random.default_rng(30 + variant + 2 * rail)
    R, K, B = 5, 60, 32
    ids, counts, errors = _rows(rng, R, K, rail)
    ids[ids == -1] = 7   # the eviction loop only runs once empties are gone
    h_uids = rng.integers(100, 999, R * B).astype(np.int32)
    h_net = rng.integers(-3, 12, R * B).astype(np.int32)
    uoff = (np.arange(R) * B).astype(np.int32)
    start = rng.integers(0, 10, R).astype(np.int32)
    n_ins = (start + rng.integers(0, 20, R)).astype(np.int32)
    w_del = rng.integers(0, 200, R).astype(np.int32)
    args = (ids, counts, errors, h_uids, h_net, uoff, start, n_ins, w_del)
    want = jbk.residual_phase_banked(*map(jnp.asarray, args), variant)
    got = tbk.residual_phase_banked(*map(_t, args), variant)
    for w, g in zip(want, got):
        _eq(w, g)


def test_topk_tie_order_matches_lax_top_k():
    rng = np.random.default_rng(5)
    ids = rng.integers(-2, 40, (3, 50)).astype(np.int32)
    counts = rng.integers(0, 4, (3, 50)).astype(np.int32)   # many ties
    jb = jst.SketchState(*(jnp.asarray(x) for x in (ids, counts, counts)))
    tb = tst.SketchState(*(_t(x) for x in (ids, counts, counts)))
    for w, g in zip(jbk.topk_bank(jb, 40), tbk.topk_bank(tb, 40)):
        _eq(w, g)
    for w, g in zip(jst.topk(jst.SketchState(*(x[0] for x in jb)), 20),
                    tst.topk(tst.SketchState(*(x[0] for x in tb)), 20)):
        _eq(w, g)


@pytest.mark.parametrize("variant", [1, 2])
def test_phase1_dense(variant):
    rng = np.random.default_rng(40 + variant)
    S, K, B = 3, 40, 200
    items = rng.integers(0, 500, B).astype(np.int32)
    jb = jbk.update_block_fused(jbk.init([K] * S), jnp.asarray(items),
                                jnp.ones(B, jnp.int32),
                                jbk.HashShardRouter(S, 16), variant)
    items = rng.integers(0, 500, B).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], B).astype(np.int32)
    ri, rw = jbk.HashShardRouter(S, 16).route_dense(jnp.asarray(items),
                                                    jnp.asarray(weights))
    want = jbk.phase1_dense(jb, ri, rw, variant)
    tb = tst.SketchState(*(_t(np.asarray(x)) for x in jb))
    got = tbk.phase1_dense(tb, _t(np.asarray(ri)), _t(np.asarray(rw)), variant)
    for w, g in zip(want, got):
        _eq(w, g)
