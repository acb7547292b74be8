"""The mesh paths of the port's sharded banks (``path="shard_map"`` of
``repro_torch.sketch.sharded`` and ``dyadic_sharded``) against the
reference.

Size-1 mesh: the cases of the reference's own size-1-mesh tests
(``tests/test_sharded.py::test_shard_map_path_matches_fused``,
``tests/test_dyadic_sharded.py`` ``TestDifferentialShardMap``,
``test_shard_map_matches_bank_path``, ``test_shard_map_requires_mesh``)
on their shapes and seeds, in a one-rank gloo group in this process.
The reference side runs its single-device path (``"block"``/``"bank"``):
its shard_map path is that path bit for bit (the reference's tests above
hold it so) and takes ~45 s a case to run eagerly here.

Four ranks: one spawned gloo group (``test_torch_ranks.suite_sketch``) on a
(4,) mesh over ("data",) and a (2, 2) mesh over ("data", "model"):
sharded S in {4, 8} x both variants, dyadic S = 4, a ``StreamSession``
(shards=8, backend="bank") under ``use_mesh``, the not-divisible
``ValueError`` and ``reshard_session`` 8 -> 6 and 8 -> 3. Every rank's
gathered bank must equal the reference's ``path="block"`` run on the
same stream, ids, counts and errors, bit for bit.

The port's messages name its own module (``repro_torch.parallel...``)
where the reference's name ``repro.parallel...``; they are compared with
that one substitution.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401,E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.core.quantiles import make_dss_pm  # noqa: E402
from repro.core.streams import bounded_stream, exact_stats  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro.sketch import api as japi  # noqa: E402
from repro.sketch import dyadic_sharded as jds  # noqa: E402
from repro.sketch import elastic as jel  # noqa: E402
from repro.sketch import sharded as jshd  # noqa: E402
from repro.sketch.session import StreamSession as JSession  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.sketch import dyadic_sharded as tds  # noqa: E402
from repro_torch.sketch import sharded as tshd  # noqa: E402
from test_torch_ranks import one_rank_group, run_ranks  # noqa: E402

BITS = 8
EPS = 0.15


def _msg(port_message: str) -> str:
    return port_message.replace("repro_torch.", "repro.")


def _same_bank(jbank, tbank, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), jbank, tbank):
        np.testing.assert_array_equal(np.asarray(a), tsh.full(b).numpy(),
                                      err_msg=f"{msg}: {name}")


@pytest.fixture(scope="module")
def size1_mesh(tmp_path_factory):
    with one_rank_group(tmp_path_factory.mktemp("mesh1")):
        yield make_smoke_mesh(1, device="cpu")


# -- size-1 mesh: the reference's tests/test_sharded.py:86 ------------------

def test_shard_map_path_matches_fused(size1_mesh):
    s = bounded_stream("zipf", 512, 0.25, order="interleaved", seed=3)[:512]
    items, w = s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)
    want = jshd.update_block(jshd.init(64, 4), jnp.asarray(items),
                             jnp.asarray(w))
    s0 = tshd.init(64, 4, device="cpu")
    ti, tw = torch.from_numpy(items), torch.from_numpy(w)
    base = tshd.update_block(s0, ti, tw)
    with tsh.use_mesh(size1_mesh):
        assert tsh.mesh_axis("shards") == ("data",)
        # "auto" stays on the single device for a size-1 axis
        assert not tsh.is_dtensor(tshd.update_block(s0, ti, tw).bank.ids)
        out = tshd.update_block(s0, ti, tw, path="shard_map")
        assert tsh.is_dtensor(out.bank.ids)
        again = tshd.update_block(out, ti, tw, path="shard_map")
    _same_bank(want.bank, out.bank, "shard_map")
    _same_bank(want.bank, base.bank, "block")
    twice = jshd.update_block(want, jnp.asarray(items), jnp.asarray(w))
    _same_bank(twice.bank, again.bank, "shard_map twice")
    # the reads of a mesh-sharded bank gather it
    probe = torch.arange(-2, 5000, dtype=torch.int32)
    np.testing.assert_array_equal(
        np.asarray(jshd.query_many(twice, jnp.asarray(probe.numpy()))),
        tshd.query_many(again, probe).numpy())
    for a, b in zip(jshd.topk(twice, 20), tshd.topk(again, 20)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _same_bank(jshd.merge(twice, want).bank, tshd.merge(again, out).bank,
               "merge")
    _same_bank(jshd.consolidate(twice), tshd.consolidate(again),
               "consolidate")
    assert jshd.to_dict(twice) == tshd.to_dict(again)
    # a single-device path takes a mesh-sharded state (gathered first)
    _same_bank(twice.bank, tshd.update_block(out, ti, tw, path="vmap").bank,
               "vmap after shard_map")


@pytest.mark.parametrize("total,S", [(64, 4), (100, 3), (5, 8)])
def test_sharded_sketch_capacity_is_the_references(size1_mesh, total, S):
    """``ShardedSketch.capacity`` (the per-shard k), on a whole and on a
    mesh-sharded bank."""
    want = jshd.init(total, S)
    got = tshd.init(total, S, device="cpu")
    assert (got.capacity, got.num_shards) == (want.capacity, want.num_shards)
    with tsh.use_mesh(size1_mesh):
        one = torch.ones(4, dtype=torch.int32)
        on_mesh = tshd.update_block(got, one, one, path="shard_map")
    assert tsh.is_dtensor(on_mesh.bank.ids)
    assert (on_mesh.capacity, on_mesh.num_shards) == (want.capacity, S)


# -- size-1 mesh: the reference's tests/test_dyadic_sharded.py:85-139 -------

def _live_values(stream):
    stats = exact_stats(stream)
    out = []
    for v, c in stats.frequencies.items():
        out.extend([v] * c)
    return np.asarray(sorted(out), dtype=np.int64), stats


def _differential(mesh, seed, alpha, variant, num_shards=4, block=64,
                  bits=BITS, eps=EPS, n_insert=1200):
    """The reference's ``run_differential``: the port on ``path=
    "shard_map"`` under the size-1 mesh, the reference on its bank
    path, both banks equal; ranks of the port, the oracle and the
    truth."""
    stream = bounded_stream("zipf", n_insert, 1.0 - 1.0 / alpha,
                            universe=1 << bits, seed=seed,
                            order="interleaved")
    live, stats = _live_values(stream)
    items = stream[:, 0].astype(np.int32)
    weights = stream[:, 1].astype(np.int32)
    js = jds.process_stream(jds.init(bits, num_shards, eps=eps, alpha=alpha),
                            items, weights, variant=variant, block=block,
                            path="bank")
    with tsh.use_mesh(mesh):
        ts = tds.process_stream(
            tds.init(bits, num_shards, eps=eps, alpha=alpha, device="cpu"),
            items, weights, variant=variant, block=block, path="shard_map")
    assert tsh.is_dtensor(ts.bank.ids)
    _same_bank(js.bank, ts.bank, f"seed {seed} alpha {alpha} v{variant}")
    oracle = make_dss_pm(bits, eps=eps, alpha=alpha,
                         variant="lazy" if variant == 1 else "sspm"
                         ).process(stream)
    assert int(ts.mass) == int(js.mass) == oracle.mass == stats.residual_mass
    qs = np.unique(np.concatenate([
        np.quantile(live, np.linspace(0, 1, 33)).astype(np.int64),
        [0, (1 << bits) - 1]]))
    tr = np.searchsorted(live, qs, side="right").astype(np.float64)
    xs = torch.from_numpy(qs.astype(np.int32))
    got = tds.rank_many(ts, xs).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jds.rank_many(js, jnp.asarray(qs, jnp.int32))))
    pr = np.asarray([oracle.rank(int(q)) for q in qs], np.float64)
    return js, ts, oracle, live, stats, got.astype(np.float64), pr, tr, \
        eps * stats.residual_mass


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("alpha", [1.25, 2.0, 4.0])
def test_rank_within_bound_across_alpha(size1_mesh, variant, alpha):
    *_, jr, pr, tr, bound = _differential(size1_mesh, seed=11, alpha=alpha,
                                          variant=variant)
    assert np.max(np.abs(jr - tr)) <= bound
    assert np.max(np.abs(pr - tr)) <= bound
    assert np.max(np.abs(jr - pr)) <= bound


def test_quantiles_match_oracle_within_rank_bound(size1_mesh):
    js, ts, oracle, live, stats, *_, bound = _differential(
        size1_mesh, seed=7, alpha=2.0, variant=2)
    qs = np.asarray([0.1, 0.25, 0.5, 0.75, 0.9, 0.99])
    got = tds.quantile_many(ts, torch.from_numpy(qs.astype(np.float32)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jds.quantile_many(
            js, jnp.asarray(qs, jnp.float32))))
    for q, xt in zip(qs, got.numpy()):
        xo = oracle.quantile(float(q))
        tt = np.searchsorted(live, xt, side="right")
        to = np.searchsorted(live, xo, side="right")
        assert abs(tt - q * stats.residual_mass) <= bound + 1
        assert abs(to - q * stats.residual_mass) <= bound + 1


@pytest.mark.parametrize("variant", [1, 2])
def test_shard_map_matches_bank_path(size1_mesh, variant):
    stream = bounded_stream("zipf", 500, 0.25, universe=1 << BITS, seed=3,
                            order="interleaved")
    items = stream[:, 0].astype(np.int32)
    weights = stream[:, 1].astype(np.int32)
    want = jds.process_stream(jds.init(BITS, 4, total_counters=256), items,
                              weights, variant=variant, block=128,
                              path="bank")
    s0 = tds.init(BITS, 4, total_counters=256, device="cpu")
    base = tds.process_stream(s0, items, weights, variant=variant,
                              block=128, path="bank")
    with tsh.use_mesh(size1_mesh):
        assert tsh.mesh_axis("shards") == ("data",)
        out = tds.process_stream(s0, items, weights, variant=variant,
                                 block=128, path="shard_map")
        # "auto" on a size-1 axis: the bank path
        auto = tds.process_stream(s0, items, weights, variant=variant,
                                  block=128)
    assert not tsh.is_dtensor(auto.bank.ids)
    for got in (base, out, auto):
        _same_bank(want.bank, got.bank, f"v{variant}")
        assert int(got.mass) == int(want.mass)
    # the reads of the mesh-sharded state, and consolidate / merge
    _same_bank(jds.consolidate(want).bank, tds.consolidate(out).bank,
               "consolidate")
    merged = tds.merge(out, out)
    _same_bank(jds.merge(want, want).bank, merged.bank, "merge")
    assert tds.layer_capacities(out) == jds.layer_capacities(want)
    assert tds.space_counters(out) == jds.space_counters(want)


def test_shard_map_requires_mesh():
    one = torch.zeros(8, dtype=torch.int32)
    for jfn, tfn in (
            (lambda: jds.update_block(jds.init(BITS, 2, total_counters=128),
                                      jnp.zeros(8, jnp.int32),
                                      jnp.zeros(8, jnp.int32),
                                      path="shard_map"),
             lambda: tds.update_block(tds.init(BITS, 2, total_counters=128,
                                               device="cpu"), one, one,
                                      path="shard_map")),
            (lambda: jshd.update_block(jshd.init(64, 4),
                                       jnp.zeros(8, jnp.int32),
                                       jnp.zeros(8, jnp.int32),
                                       path="shard_map"),
             lambda: tshd.update_block(tshd.init(64, 4, device="cpu"), one,
                                       one, path="shard_map"))):
        with pytest.raises(ValueError) as want:
            jfn()
        with pytest.raises(ValueError) as got:
            tfn()
        assert _msg(str(got.value)) == str(want.value)


# -- four ranks ---------------------------------------------------------------

KTOT, UBITS, QBITS, SESSION_K = 128, 12, 8, 96


def _rng_stream(seed, n, universe):
    s = bounded_stream("zipf", n, 0.5, universe=universe, seed=seed,
                       order="interleaved")
    return s[:, 0].astype(np.int32), s[:, 1].astype(np.int32)


def _blocks(items, weights, B, n_blocks):
    pad = B * n_blocks - len(items)
    it = np.concatenate([items, np.zeros(max(pad, 0), np.int32)])[:B * n_blocks]
    w = np.concatenate([weights, np.zeros(max(pad, 0), np.int32)])[:B * n_blocks]
    return it.reshape(n_blocks, B), w.reshape(n_blocks, B)


class _JMesh:
    """The reference's context on an AbstractMesh, for what raises or warns
    before any device work (``use_mesh``'s ``with mesh:`` does not take
    an AbstractMesh)."""

    def __init__(self, shape, names):
        self.mesh = AbstractMesh(shape, names)

    def __enter__(self):
        self.old = (jsh._CTX.mesh, jsh._CTX.rules)
        jsh._CTX.mesh = self.mesh
        jsh._CTX.rules = jsh.default_rules()

    def __exit__(self, *exc):
        jsh._CTX.mesh, jsh._CTX.rules = self.old


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    items, weights = _blocks(*_rng_stream(21, 1200, 1 << UBITS), 512, 3)
    q_items, q_weights = _blocks(*_rng_stream(22, 500, 1 << QBITS), 256, 3)
    s_items, s_weights = _rng_stream(23, 1000, 1 << UBITS)
    probe = np.arange(-1, 1 << UBITS, 3, dtype=np.int32)
    q_probe = np.arange(-2, (1 << QBITS) + 2, dtype=np.int32)
    inputs = dict(items=items, weights=weights, q_items=q_items,
                  q_weights=q_weights, s_items=s_items, s_weights=s_weights,
                  probe=probe, q_probe=q_probe, ktot=np.int32(KTOT),
                  ubits=np.int32(UBITS), qbits=np.int32(QBITS),
                  session_k=np.int32(SESSION_K))
    outs = run_ranks("sketch", 4, tmp_path_factory.mktemp("mesh4"), inputs)
    return inputs, outs


def _same(outs, key, want):
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[key], np.asarray(want),
                                      err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("mesh", ["line", "grid"])
@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("variant", [1, 2])
def test_sharded_shard_map_on_four_ranks(four_ranks, mesh, S, variant):
    inp, outs = four_ranks
    st = jshd.init(KTOT, S)
    for it, w in zip(inp["items"], inp["weights"]):
        st = jshd.update_block(st, jnp.asarray(it), jnp.asarray(w), variant,
                               universe_bits=UBITS, path="block")
    key = f"{mesh}/sharded/{S}/{variant}"
    for name, a in zip(("ids", "counts", "errors"), st.bank):
        _same(outs, f"{key}/{name}", a)
    _same(outs, f"{key}/query",
          jshd.query_many(st, jnp.asarray(inp["probe"])))
    # each rank held its S / |data| rows: (4,) splits over 4, (2, 2) over 2
    _same(outs, f"{key}/local_rows", S // (4 if mesh == "line" else 2))


@pytest.mark.parametrize("mesh", ["line", "grid"])
@pytest.mark.parametrize("variant", [1, 2])
def test_dyadic_shard_map_on_four_ranks(four_ranks, mesh, variant):
    inp, outs = four_ranks
    st = jds.init(QBITS, 4, total_counters=256)
    for it, w in zip(inp["q_items"], inp["q_weights"]):
        st = jds.update_block(st, jnp.asarray(it), jnp.asarray(w), variant,
                              path="bank")
    key = f"{mesh}/dyadic/{variant}"
    for name, a in zip(("ids", "counts", "errors"), st.bank):
        _same(outs, f"{key}/{name}", a)
    _same(outs, f"{key}/mass", st.mass)
    _same(outs, f"{key}/rank", jds.rank_many(st, jnp.asarray(inp["q_probe"])))


@pytest.fixture(scope="module")
def session_reference(four_ranks):
    inp, _ = four_ranks
    spec = japi.SketchSpec(k=SESSION_K, shards=8, bits=UBITS, backend="bank")
    sess = JSession(spec, block=256)
    sess.ingest(inp["s_items"], inp["s_weights"])
    sess.flush()
    return (japi.save(spec, sess.state), sess.query_many(inp["probe"]),
            sess.topk(10))


@pytest.mark.parametrize("mesh", ["line", "grid"])
def test_session_under_a_mesh_takes_shard_map(four_ranks, session_reference,
                                              mesh):
    _, outs = four_ranks
    saved, query, (ids, counts) = session_reference
    key = f"{mesh}/session"
    _same(outs, f"{key}/dtensor", True)
    # the session's compiled-ingest cell is the mesh layout's own
    _same(outs, f"{key}/own_cell", True)
    for name, a in saved.items():
        _same(outs, f"{key}/save/{name}", a)
    _same(outs, f"{key}/query", query)
    _same(outs, f"{key}/topk_ids", ids)
    _same(outs, f"{key}/topk_counts", counts)


def test_not_divisible_errors_on_four_ranks(four_ranks):
    _, outs = four_ranks
    one = jnp.ones(8, jnp.int32)
    with _JMesh((4,), ("data",)):
        with pytest.raises(ValueError) as shd_err:
            jshd.update_block(jshd.init(60, 6), one, one, path="shard_map")
        with pytest.raises(ValueError) as dy_err:
            jds.update_block(jds.init(8, 6, total_counters=256), one, one,
                             path="shard_map")
    for out in outs:
        assert _msg(str(out["divisible/sharded"])) == str(shd_err.value)
        assert _msg(str(out["divisible/dyadic"])) == str(dy_err.value)


@pytest.mark.parametrize("new", [6, 3])
def test_reshard_session_on_a_mesh(four_ranks, new):
    inp, outs = four_ranks
    spec = japi.SketchSpec(k=SESSION_K, shards=8, bits=UBITS, backend="bank")
    half = len(inp["s_items"]) // 2
    # the reference's warning, on an AbstractMesh of the same shape
    with _JMesh((2, 2), ("data", "model")):
        sess = JSession(spec, block=256)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jel.reshard_session(sess, new)
    want_warn = "\n".join(str(w.message) for w in caught)
    assert bool(want_warn) == (new == 3)
    sess = JSession(spec, block=256)
    sess.ingest(inp["s_items"][:half], inp["s_weights"][:half])
    jel.reshard_session(sess, new)
    sess.ingest(inp["s_items"][half:], inp["s_weights"][half:])
    sess.flush()
    key = f"reshard/{new}"
    for out in outs:
        assert _msg(str(out[f"{key}/warnings"])) == want_warn
    # 6 stays on the 2-way data axis (shard_map), 3 falls back
    _same(outs, f"{key}/dtensor", new == 6)
    _same(outs, f"{key}/slack", sess.error_slack)
    for name, a in japi.save(sess.spec, sess.state).items():
        _same(outs, f"{key}/save/{name}", a)
