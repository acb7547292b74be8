"""The port's Dyadic SpaceSaving± (``repro_torch.sketch.dyadic``) against
the reference package.

Same numpy inputs through ``repro.sketch.dyadic`` (its ``kernel`` path
runs the Pallas kernel in interpret mode on the CPU) and the port (the
kernels' plain versions on the CPU): the layer sizing, per-row bank
``init``, the dyadic routers on both ``sort_block`` branches, every
update path, ranks, quantiles, merge, checkpoints, int32 and tolerance
0; the rank error against the Python oracle ``DyadicQuantile`` within
eps·|F|₁, as ``tests/test_dyadic_jax.py`` holds the reference; and the
port's sorted rank lookup against the reference's direct comparison.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.core.quantiles import dyadic_layer_capacities
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import dyadic as tdy
from repro_torch.sketch.state import SketchState

BITS = 8
EPS = 0.15
INT_MAX = 2**31 - 1


def _stream(seed, bits=BITS, n_insert=1200, ratio=0.5, order="interleaved"):
    s = bounded_stream("zipf", n_insert, ratio, universe=1 << bits, seed=seed,
                       order=order)
    return s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)


def _blocks(items, weights, block, padding_at=None):
    """(B,) blocks of the stream, the last zero-weight padded; an
    all-padding block inserted before block ``padding_at``."""
    n = len(items)
    nb = max(1, -(-n // block))
    pi = np.zeros(nb * block, np.int32)
    pw = np.zeros(nb * block, np.int32)
    pi[:n], pw[:n] = items, weights
    out = [(pi[b * block:(b + 1) * block], pw[b * block:(b + 1) * block])
           for b in range(nb)]
    if padding_at is not None:
        pad = (np.arange(block, dtype=np.int32) % 7, np.zeros(block, np.int32))
        out.insert(padding_at, pad)
    return out


def _assert_bank(jbank, tbank, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), jbank, tbank):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _assert_state(js, ts, msg=""):
    _assert_bank(js.bank, ts.bank, msg)
    assert int(js.mass) == int(ts.mass), msg
    assert ts.mass.dtype == torch.int32 and ts.mass.shape == ()


def _states(sizing, variant, path, blocks, bits=BITS):
    js = jdy.init(bits, **sizing)
    ts = tdy.init(bits, **sizing, device="cpu")
    for it, w in blocks:
        js = jdy.update_block(js, jnp.asarray(it), jnp.asarray(w), variant,
                              path=path)
        ts = tdy.update_block(ts, torch.from_numpy(it), torch.from_numpy(w),
                              variant, path=path)
    return js, ts


# -- sizing, per-row init, routers -----------------------------------------

@pytest.mark.parametrize("bits", range(1, 31))
def test_layer_capacities_match_reference(bits):
    for eps in (1e-5, 1e-3, 7e-3, 0.01, 0.15, 0.5, 2.0):
        for alpha in (1.0, 2.0, 3.5):
            assert dyadic_layer_capacities(bits, eps=eps, alpha=alpha) == \
                jq.dyadic_layer_capacities(bits, eps=eps, alpha=alpha)
    for k in (1, 2, bits, 512, 3 * bits + 1, 96000 * bits, 2**31 - 1):
        assert dyadic_layer_capacities(bits, total_counters=k) == \
            jq.dyadic_layer_capacities(bits, total_counters=k)
    for bad in (dict(), dict(total_counters=8, eps=0.1)):
        with pytest.raises(ValueError):
            dyadic_layer_capacities(bits, **bad)


def test_bits_24_sizing_is_the_papers():
    caps = dyadic_layer_capacities(24, eps=1e-3, alpha=2.0)
    assert caps[:8] == [96000] * 8 and caps[-1] == 2
    assert sum(caps) == 899070


@pytest.mark.parametrize("caps", [[5, 3, 1], [4], [128, 128], [2, 9, 9, 2],
                                  [200, 1, 77]])
def test_per_row_init_matches_reference(caps):
    got = tbk.init(caps, device="cpu")
    _assert_bank(jbk.init(caps), got, str(caps))
    assert tbk.row_capacities(got) == jbk.row_capacities(jbk.init(caps)) \
        == caps
    assert tbk.init(caps, num_rows=len(caps), device="cpu").ids.shape == \
        got.ids.shape


def test_equal_rows_init_keeps_its_form():
    _assert_bank(jbk.init(6, 3), tbk.init(6, 3, device="cpu"), "int")
    _assert_bank(jbk.init(6, 3), tbk.init(np.int64(6), 3, device="cpu"),
                 "numpy int")
    for bad in (lambda: tbk.init(6, device="cpu"),
                lambda: tbk.init([3, 0], device="cpu"),
                lambda: tbk.init([3, 2], num_rows=3, device="cpu"),
                lambda: tbk.init([], device="cpu")):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("bits,B", [(8, 256), (12, 512), (24, 256),
                                    (24, 300)])
def test_dyadic_level_router_matches_reference(bits, B):
    """Both ``sort_block`` branches: the packed key (bits + log2 B <= 31)
    and the stable sort (bits = 24: 24 + 8 > 31); zero-weight entries
    (any id) and repeated ids."""
    rng = np.random.default_rng(bits * 1000 + B)
    items = rng.integers(0, 1 << bits, B).astype(np.int32)
    items[::5] = items[0]
    weights = rng.choice([-2, -1, 0, 1, 1, 3], B).astype(np.int32)
    jr, jw = jbk.DyadicLevelRouter(bits).route_dense(jnp.asarray(items),
                                                     jnp.asarray(weights))
    tr, tw = tbk.DyadicLevelRouter(bits).route_dense(torch.from_numpy(items),
                                                     torch.from_numpy(weights))
    assert tw.shape == (1, B) and tr.shape == (bits, B)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(
        tdy.layer_items(torch.from_numpy(items), bits).numpy(),
        np.asarray(jdy.layer_items(jnp.asarray(items), bits)))


# -- updates: every path against the reference's --------------------------

GRID = [
    # (sizing, bits, block, stream seed, n_insert, padding block at)
    (dict(eps=EPS), BITS, 256, 1, 1200, 2),
    (dict(eps=EPS), BITS, 1, 2, 40, 5),
    (dict(total_counters=512), 10, 256, 3, 1500, None),
]


@pytest.mark.parametrize("path", ["kernel", "bank", "block"])
@pytest.mark.parametrize("variant", [2, 1])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_update_block_matches_reference(path, variant, case):
    sizing, bits, block, seed, n_insert, pad_at = GRID[case]
    # deletion-heavy: the whole bounded-deletion budget of alpha = 2
    items, weights = _stream(seed, bits, n_insert)
    js, ts = _states(sizing, variant, path,
                     _blocks(items, weights, block, pad_at), bits)
    _assert_state(js, ts, f"{path}/{variant}/{case}")
    assert tdy.layer_capacities(ts) == jdy.layer_capacities(js)
    assert tdy.space_counters(ts) == jdy.space_counters(js)
    assert (ts.bits, ts.capacity) == (js.bits, js.capacity)


@pytest.mark.parametrize("variant", [2, 1])
def test_process_stream_matches_reference(variant):
    items, weights = _stream(4, n_insert=900)
    js = jdy.process_stream(jdy.init(BITS, eps=EPS), items, weights, variant,
                            block=128)
    ts = tdy.process_stream(tdy.init(BITS, eps=EPS, device="cpu"), items,
                            weights, variant, block=128)
    _assert_state(js, ts, "process_stream")


def test_paths_that_wait_raise():
    ts = tdy.init(BITS, eps=EPS, device="cpu")
    one = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown path"):
        tdy.update_block(ts, one, one, path="vmap")


@pytest.mark.parametrize("variant", [2, 1])
def test_serial_path_matches_reference(variant):
    """``path="serial"`` (it raised until the serial backend was ported):
    ``block_update_serial`` layer by layer, against the reference's
    vmapped serial scan and the port's ``"bank"`` path, with the mass."""
    items, weights = _stream(5, n_insert=300)
    js = jdy.init(BITS, eps=EPS)
    ts = tdy.init(BITS, eps=EPS, device="cpu")
    bank = ts
    for it, w in _blocks(items, weights, 128):
        js = jdy.update_block(js, jnp.asarray(it), jnp.asarray(w), variant,
                              path="serial")
        ts = tdy.update_block(ts, torch.from_numpy(it), torch.from_numpy(w),
                              variant, path="serial")
        bank = tdy.update_block(bank, torch.from_numpy(it),
                                torch.from_numpy(w), variant, path="bank")
        _assert_state(js, ts, "serial")
    _assert_state(js, bank, "bank")


def test_mass_wraps_as_int32():
    ts = tdy.init(4, eps=0.5, device="cpu")
    ts = ts._replace(mass=torch.tensor(INT_MAX, dtype=torch.int32))
    js = jdy.init(4, eps=0.5)._replace(mass=jnp.int32(INT_MAX))
    it, w = np.array([3, 5], np.int32), np.array([1, 1], np.int32)
    js = jdy.update_block(js, jnp.asarray(it), jnp.asarray(w))
    ts = tdy.update_block(ts, torch.from_numpy(it), torch.from_numpy(w))
    assert int(ts.mass) == int(js.mass) == -2**31 + 1


# -- queries ----------------------------------------------------------------

def _query_points(bits):
    return np.concatenate([np.arange(-3, (1 << bits) + 3),
                           [INT_MAX, INT_MAX - 1, -2**31, -2]]).astype(np.int32)


QS = np.concatenate([[0.0, 1.0, 0.5, 1e-4, 0.999, 1.5, -0.25],
                     np.linspace(0, 1, 41)]).astype(np.float32)


@pytest.mark.parametrize("variant", [2, 1])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_rank_and_quantile_match_reference(variant, case):
    sizing, bits, block, seed, n_insert, pad_at = GRID[case]
    items, weights = _stream(seed + 10, bits, n_insert)
    js, ts = _states(sizing, variant, "bank",
                     _blocks(items, weights, block, pad_at), bits)
    xs = _query_points(bits)
    np.testing.assert_array_equal(
        np.asarray(jdy.rank_many(js, jnp.asarray(xs))),
        tdy.rank_many(ts, torch.from_numpy(xs)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jdy.quantile_many(js, jnp.asarray(QS))),
        tdy.quantile_many(ts, torch.from_numpy(QS)).numpy())
    for x in (0, 17, (1 << bits) - 1, 1 << bits):
        assert tdy.rank(ts, x) == jdy.rank(js, x)
    for q in (0.0, 0.3, 1.0):
        assert tdy.quantile(ts, q) == jdy.quantile(js, q)


def test_queries_of_an_empty_sketch():
    ts = tdy.init(BITS, eps=EPS, device="cpu")
    js = jdy.init(BITS, eps=EPS)
    xs = _query_points(BITS)
    np.testing.assert_array_equal(
        tdy.rank_many(ts, torch.from_numpy(xs)).numpy(),
        np.asarray(jdy.rank_many(js, jnp.asarray(xs))))
    np.testing.assert_array_equal(
        tdy.quantile_many(ts, torch.from_numpy(QS)).numpy(),
        np.asarray(jdy.quantile_many(js, jnp.asarray(QS))))


def _direct_rank(state, xs):
    """The reference's rank_many written out: the (bits, n, k) comparison
    of every layer's slots with every query's node, at once."""
    bits = state.bits
    y = xs.long() + 1
    y = (y + 2**31) % 2**32 - 2**31
    lvl = torch.arange(bits)[None, :]
    nodes = 2 * (y[:, None] >> (lvl + 1))                  # (n, bits)
    take = ((y[:, None] >> lvl) & 1) > 0
    ids = state.bank.ids.long()[:, None, :]                # (bits, 1, k)
    eq = (ids == nodes.T[:, :, None]) & (ids >= 0)         # (bits, n, k)
    est = torch.where(eq, state.bank.counts.long()[:, None, :], 0).sum(-1)
    est = (est + 2**31) % 2**32 - 2**31
    r = torch.where(take, est.T.clamp(min=0), 0).sum(1)
    r = (r + 2**31) % 2**32 - 2**31
    return torch.where(y >= (1 << bits), state.mass.long(), r).int()


@pytest.mark.parametrize("seed", range(4))
def test_sorted_rank_lookup_equals_the_direct_comparison(seed):
    """The port's sorted lookup against the full (bits, n, k) comparison,
    on states the sketch would not make: ids held twice in a row (their
    counts add, past int32 too), sentinel and negative ids, negative and
    INT_MAX counts, queries at the int32 rails."""
    rng = np.random.default_rng(seed)
    bits, k = 6, 40
    ids = rng.integers(-3, 1 << bits, (bits, k)).astype(np.int32)
    ids[:, :4] = ids[:, 4:8]                        # duplicates
    counts = rng.integers(-5, 50, (bits, k)).astype(np.int32)
    counts[0, :3] = INT_MAX
    counts[1, 5] = -2**31
    state = tdy.DyadicState(
        bank=SketchState(torch.from_numpy(ids), torch.from_numpy(counts),
                         torch.zeros(bits, k, dtype=torch.int32)),
        mass=torch.tensor(int(rng.integers(0, 10**6)), dtype=torch.int32))
    xs = torch.from_numpy(_query_points(bits))
    assert torch.equal(tdy.rank_many(state, xs), _direct_rank(state, xs))
    jstate = jdy.DyadicState(
        bank=jbk.init([k] * bits)._replace(ids=jnp.asarray(ids),
                                           counts=jnp.asarray(counts)),
        mass=jnp.int32(int(state.mass)))
    np.testing.assert_array_equal(
        np.asarray(jdy.rank_many(jstate, jnp.asarray(xs.numpy()))),
        tdy.rank_many(state, xs).numpy())


# -- the rank guarantee against the Python oracle -------------------------

def _live(stream_items, stream_weights):
    stats = exact_stats(np.stack([stream_items, stream_weights], axis=1))
    live = []
    for v, c in stats.frequencies.items():
        live.extend([v] * c)
    return np.asarray(sorted(live), np.int64), stats


@pytest.mark.parametrize("variant", [2, 1])
@pytest.mark.parametrize("alpha", [1.5, 2.0, 4.0])
def test_rank_within_bound_against_the_oracle(variant, alpha):
    """``tests/test_dyadic_jax.py``'s differential: the port and the
    oracle (same layer sizing) each within eps·|F|₁ of the true ranks,
    and so within 2·eps·|F|₁ of each other."""
    items, weights = _stream(7 + int(alpha * 2), BITS, 1200,
                             ratio=1.0 - 1.0 / alpha)
    ts = tdy.process_stream(
        tdy.init(BITS, eps=EPS, alpha=alpha, device="cpu"), items, weights,
        variant, block=256, path="kernel")
    oracle = jq.make_dss_pm(BITS, eps=EPS, alpha=alpha,
                            variant="lazy" if variant == 1 else "sspm")
    oracle.process(zip(items.tolist(), weights.tolist()))
    live, stats = _live(items, weights)
    mass = stats.insertions - stats.deletions
    assert int(ts.mass) == mass
    xs = np.unique(np.concatenate([
        np.quantile(live, np.linspace(0, 1, 33)).astype(np.int64),
        [0, (1 << BITS) - 1]]))
    true = np.asarray([(live <= x).sum() for x in xs])
    got = tdy.rank_many(ts, torch.from_numpy(xs.astype(np.int32))).numpy()
    ora = np.asarray([oracle.rank(int(x)) for x in xs])
    bound = EPS * mass
    assert np.abs(got - true).max() <= bound
    assert np.abs(ora - true).max() <= bound
    assert np.abs(got - ora).max() <= 2 * bound
    for q in (0.1, 0.5, 0.9):
        x = tdy.quantile(ts, q)
        assert (live <= x).sum() >= q * mass - bound
        assert x == 0 or (live <= x - 1).sum() < q * mass + bound


# -- merge and checkpoints -------------------------------------------------

@pytest.mark.parametrize("variant", [2, 1])
def test_merge_matches_reference(variant):
    a_items, a_w = _stream(21, n_insert=700)
    b_items, b_w = _stream(22, n_insert=500)
    ja, ta = _states(dict(eps=EPS), variant, "bank",
                     _blocks(a_items, a_w, 128))
    jb, tb = _states(dict(eps=EPS), variant, "bank",
                     _blocks(b_items, b_w, 128))
    _assert_state(jdy.merge(ja, jb), tdy.merge(ta, tb), "merge")
    _assert_state(jdy.merge(ja, ja), tdy.merge(ta, ta), "self")


@pytest.mark.parametrize("backend", ["kernel", "bank", "block"])
def test_checkpoints_cross_load_both_ways(backend):
    jspec = japi.SketchSpec(kind="quantile", eps=EPS, bits=BITS,
                            backend=backend)
    tspec = tapi.SketchSpec(kind="quantile", eps=EPS, bits=BITS,
                            backend=backend)
    items, weights = _stream(31, n_insert=600)
    js, ts = japi.make(jspec), tapi.make(tspec, device="cpu")
    for it, w in _blocks(items, weights, 256):
        js = japi.update(jspec, js, it, w)
        ts = tapi.update(tspec, ts, it, w)
    jd, td = japi.save(jspec, js), tapi.save(tspec, ts)
    assert set(jd) == set(td)
    for key in jd:
        np.testing.assert_array_equal(np.asarray(jd[key]), td[key],
                                      err_msg=key)
        assert np.asarray(jd[key]).dtype == td[key].dtype, key
    _assert_state(japi.restore(jspec, td), tapi.restore(tspec, jd, "cpu"),
                  "restore")
    # an untagged dict with a mass is a quantile one
    untagged = {k: v for k, v in jd.items() if k != "layout"}
    freq = tapi.SketchSpec(k=64)
    assert tapi.infer_spec(freq, untagged) == \
        tapi.SketchSpec(kind="quantile", k=64, bits=BITS)
    assert dataclasses.asdict(tapi.infer_spec(freq, untagged)) == \
        dataclasses.asdict(japi.infer_spec(japi.SketchSpec(k=64), untagged))
    _assert_state(js, tapi.restore(tspec, untagged, "cpu"), "untagged")
