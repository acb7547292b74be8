"""The port's shard × level dyadic bank (``repro_torch.sketch.
dyadic_sharded``) against the reference package on one device.

Same numpy inputs through ``repro.sketch.dyadic_sharded`` (its ``bank``
path: the composed router and the dense fused core) and the port (the
dense core with kernel 2's plain version on the CPU): sizing, the
``ShardLevelRouter``, updates, owner-shard ranks and quantiles, merge,
``consolidate`` and checkpoints, int32 and tolerance 0; ranks within
eps·|F|₁ against the Python oracle, as ``tests/test_dyadic_sharded.py``
holds the reference.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from repro.core import quantiles as jq
from repro.core.streams import bounded_stream, exact_stats
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import dyadic as jdy
from repro.sketch import dyadic_sharded as jds
from repro.sketch.session import StreamSession as JSession
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import dyadic as tdy
from repro_torch.sketch import dyadic_sharded as tds
from repro_torch.sketch.session import StreamSession as TSession

BITS = 8
EPS = 0.15


def _stream(seed, bits=BITS, n_insert=1200, ratio=0.5):
    s = bounded_stream("zipf", n_insert, ratio, universe=1 << bits, seed=seed,
                       order="interleaved")
    return s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)


def _assert_state(js, ts, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), js.bank, ts.bank):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")
    assert int(js.mass) == int(ts.mass), msg


def _states(shards, variant, items, weights, block, sizing=None, bits=BITS):
    sizing = sizing or dict(eps=EPS)
    js = jds.process_stream(jds.init(bits, shards, **sizing), items, weights,
                            variant, block=block, path="bank")
    ts = tds.process_stream(tds.init(bits, shards, **sizing, device="cpu"),
                            items, weights, variant, block=block)
    return js, ts


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sizing_matches_reference(shards):
    for sizing in (dict(eps=EPS), dict(total_counters=300),
                   dict(eps=0.01, alpha=3.0)):
        js = jds.init(BITS, shards, **sizing)
        ts = tds.init(BITS, shards, **sizing, device="cpu")
        _assert_state(js, ts, str(sizing))
        assert tds.layer_capacities(ts) == jds.layer_capacities(js)
        assert tds.space_counters(ts) == jds.space_counters(js)
        assert (ts.num_shards, ts.bits, ts.capacity) == \
            (js.num_shards, js.bits, js.capacity)
    with pytest.raises(ValueError):
        tds.init(BITS, 0, eps=EPS, device="cpu")


@pytest.mark.parametrize("bits,shards,B", [(8, 4, 256), (24, 3, 256),
                                           (10, 1, 64)])
def test_shard_level_router_matches_reference(bits, shards, B):
    rng = np.random.default_rng(bits + shards)
    items = rng.integers(0, 1 << bits, B).astype(np.int32)
    weights = rng.choice([-1, 0, 1, 2], B).astype(np.int32)
    jr, jw = jbk.ShardLevelRouter(bits, shards).route_dense(
        jnp.asarray(items), jnp.asarray(weights))
    router = tbk.ShardLevelRouter(bits, shards)
    tr, tw = router.route_dense(torch.from_numpy(items),
                                torch.from_numpy(weights))
    assert router.num_rows == bits * shards == tr.shape[0]
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    nodes, w_l = tbk.DyadicLevelRouter(bits).route_dense(
        torch.from_numpy(items), torch.from_numpy(weights))
    jn, jwl = jbk.DyadicLevelRouter(bits).route_dense(jnp.asarray(items),
                                                      jnp.asarray(weights))
    np.testing.assert_array_equal(
        np.asarray(jbk.ShardLevelRouter(bits, shards).mask_shards(jn, jwl)),
        router.mask_shards(nodes, w_l).numpy())


@pytest.mark.parametrize("variant", [2, 1])
@pytest.mark.parametrize("shards,block,n_insert", [(4, 256, 1200),
                                                   (3, 1, 40),
                                                   (1, 128, 800)])
def test_update_matches_reference(variant, shards, block, n_insert):
    items, weights = _stream(shards * 10 + block, n_insert=n_insert)
    js, ts = _states(shards, variant, items, weights, block)
    _assert_state(js, ts, f"{shards}/{block}")
    # an all-padding block changes nothing
    pad = torch.zeros(64, dtype=torch.int32)
    again = tds.update_block(ts, pad + 5, pad)
    _assert_state(js, again, "padding")


def test_update_paths():
    ts = tds.init(BITS, 2, eps=EPS, device="cpu")
    one = torch.ones(4, dtype=torch.int32)
    _assert_state(tds.update_block(ts, one, one, path="bank"),
                  tds.update_block(ts, one, one, path="auto"), "auto")
    # no mesh: the reference's ValueError (the port's message names its
    # own module where the reference's names its own)
    with pytest.raises(ValueError) as want:
        jds.update_block(jds.init(BITS, 2, eps=EPS), jnp.asarray(one.numpy()),
                         jnp.asarray(one.numpy()), path="shard_map")
    with pytest.raises(ValueError) as got:
        tds.update_block(ts, one, one, path="shard_map")
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)
    with pytest.raises(ValueError, match="unknown path"):
        tds.update_block(ts, one, one, path="kernel")


QS = np.concatenate([[0.0, 1.0, 1e-4, 1.5],
                     np.linspace(0, 1, 21)]).astype(np.float32)


@pytest.mark.parametrize("variant", [2, 1])
@pytest.mark.parametrize("shards", [1, 4])
def test_owner_rank_and_quantile_match_reference(variant, shards):
    items, weights = _stream(40 + shards, n_insert=1000)
    js, ts = _states(shards, variant, items, weights, 256)
    xs = np.concatenate([np.arange(-3, (1 << BITS) + 3),
                         [2**31 - 1, -2**31, -2]]).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jds.rank_many(js, jnp.asarray(xs))),
        tds.rank_many(ts, torch.from_numpy(xs)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jds.quantile_many(js, jnp.asarray(QS))),
        tds.quantile_many(ts, torch.from_numpy(QS)).numpy())
    assert tds.rank(ts, 100) == jds.rank(js, 100)
    assert tds.quantile(ts, 0.5) == jds.quantile(js, 0.5)


@pytest.mark.parametrize("variant", [2, 1])
def test_rank_within_bound_against_the_oracle(variant):
    items, weights = _stream(51, n_insert=1200)
    js, ts = _states(4, variant, items, weights, 256)
    oracle = jq.make_dss_pm(BITS, eps=EPS, alpha=2.0,
                            variant="lazy" if variant == 1 else "sspm")
    oracle.process(zip(items.tolist(), weights.tolist()))
    stats = exact_stats(np.stack([items, weights], axis=1))
    freq = np.zeros(1 << BITS, np.int64)
    for v, c in stats.frequencies.items():
        freq[v] = c
    true = np.cumsum(freq)
    mass = int(true[-1])
    xs = np.arange(1 << BITS, dtype=np.int32)
    got = tds.rank_many(ts, torch.from_numpy(xs)).numpy()
    ora = np.asarray([oracle.rank(int(x)) for x in xs])
    assert np.abs(got - true).max() <= EPS * mass
    assert np.abs(ora - true).max() <= EPS * mass


@pytest.mark.parametrize("variant", [2, 1])
def test_merge_and_consolidate_match_reference(variant):
    a_items, a_w = _stream(61, n_insert=900)
    b_items, b_w = _stream(62, n_insert=600)
    ja, ta = _states(4, variant, a_items, a_w, 256)
    jb, tb = _states(4, variant, b_items, b_w, 256)
    _assert_state(jds.merge(ja, jb), tds.merge(ta, tb), "merge")
    for shards in (4, 3, 1):
        js, ts = _states(shards, variant, a_items, a_w, 256)
        jc, tc = jds.consolidate(js), tds.consolidate(ts)
        assert isinstance(tc, tdy.DyadicState)
        _assert_state(jc, tc, f"consolidate S={shards}")
    xs = np.arange(1 << BITS, dtype=np.int32)
    np.testing.assert_array_equal(
        tdy.rank_many(tc, torch.from_numpy(xs)).numpy(),
        np.asarray(jdy.rank_many(jc, jnp.asarray(xs))))


def test_bank_consolidate_folds_the_leading_axis_with_a_given_merge():
    """``bank.consolidate``'s tree over an (S, bits, k) bank equals the
    reference's, which folds with a level-vmapped merge; a merge_fn is
    called once a tree level."""
    items, weights = _stream(70, n_insert=700)
    js, ts = _states(5, 2, items, weights, 128)
    calls = []

    def merge(a, b):
        calls.append(a.ids.shape)
        return tbk.merge_banks(a, b)

    got = tbk.consolidate(ts.bank, merge_fn=merge)
    _assert_state(jds.consolidate(js), tdy.DyadicState(got, ts.mass))
    assert [c[0] for c in calls] == [2, 1, 1]


@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_spec_session_and_checkpoints_match_reference(variant):
    jspec = japi.SketchSpec(kind="quantile", eps=EPS, bits=BITS, shards=4,
                            variant=variant)
    tspec = tapi.SketchSpec(kind="quantile", eps=EPS, bits=BITS, shards=4,
                            variant=variant, backend="bank")
    items, weights = _stream(80, n_insert=900)
    js, ts = JSession(jspec, block=256), TSession(tspec, block=256,
                                                  device="cpu")
    js.ingest(items, weights)
    ts.ingest(items, weights)
    _assert_state(js.state, ts.state, "session")
    probe = np.arange(0, 1 << BITS, 3)
    np.testing.assert_array_equal(np.asarray(js.query_many(probe)),
                                  ts.query_many(probe).numpy())
    for a, b in zip(js.topk(12), ts.topk(12)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(js.rank_many(probe)),
                                  ts.rank_many(probe).numpy())
    np.testing.assert_array_equal(np.asarray(js.quantile_many(QS)),
                                  ts.quantile_many(QS).numpy())
    _assert_state(js.consolidated(), ts.consolidated(), "consolidated")
    jd, td = japi.save(jspec, js.state), tapi.save(tspec, ts.state)
    assert set(jd) == set(td)
    for key in jd:
        np.testing.assert_array_equal(np.asarray(jd[key]), td[key],
                                      err_msg=key)
    _assert_state(japi.restore(jspec, td), tapi.restore(tspec, jd, "cpu"),
                  "restore")
    with pytest.raises(ValueError, match="shards"):
        tapi.restore(tapi.SketchSpec(kind="quantile", eps=EPS, bits=BITS,
                                     shards=2, backend="bank"),
                     dict(jd, shards=np.int32(2)), "cpu")
