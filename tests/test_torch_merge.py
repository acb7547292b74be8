"""Merge and consolidation of the port against the reference package.

``state.merge``, ``bank.merge_banks`` / ``consolidate``,
``sharded.merge`` / ``consolidate`` / ``query`` / ``to_dict``,
``api.merge`` / ``consolidate`` and ``StreamSession.merge_from`` /
``consolidated`` of ``repro_torch`` on the CPU, held to ``repro``'s on
the same numpy inputs, int32, tolerance 0. The grids follow the
reference's own tests: ``test_api_parity.py:196``, ``test_api.py:428,
511, 527``, ``test_sharded.py:233, 249, 321``, ``test_bank.py:107,
119``, ``test_core_spacesaving.py:249, 268`` and
``test_checkpoint.py:62``.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import sharded as jshd
from repro.sketch import state as jst
from repro.sketch.session import StreamSession as JSession
from repro_torch.core.streams import zipf_interleaved_stream
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import sharded as tshd
from repro_torch.sketch import state as tst
from repro_torch.sketch.session import StreamSession as TSession

BITS = 12
BLOCK = 256
INT_MAX = 2**31 - 1


def _np(state):
    return tuple(np.asarray(t) for t in state)


def _j(arrays):
    return jst.SketchState(*(jnp.asarray(a) for a in arrays))


def _t(arrays):
    return tst.SketchState(*(torch.from_numpy(np.array(a)) for a in arrays))


def _assert_same(want, got, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{msg}: {name}")


def _random_bank(rng, R, k, fill, blocked=0, big=False):
    """(R, k) numpy bank: distinct non-negative ids per row on a share
    ``fill`` of the slots, EMPTY elsewhere, the last ``blocked`` slots of
    row 0 BLOCKED (INT_MAX counts, zero errors); counts near INT_MAX
    where ``big`` (the merged sums saturate)."""
    ids = np.full((R, k), -1, np.int32)
    for r in range(R):
        live = rng.random(k) < fill
        ids[r, live] = rng.choice(4 * k, live.sum(), replace=False)
    hi = INT_MAX if big else 60
    counts = np.where(ids >= 0, rng.integers(0, hi, (R, k)), 0).astype(np.int32)
    errors = np.where(ids >= 0, np.minimum(rng.integers(0, 20, (R, k)),
                                           counts), 0).astype(np.int32)
    if blocked:
        ids[0, -blocked:] = -2
        counts[0, -blocked:] = INT_MAX
        errors[0, -blocked:] = 0
    return ids, counts, errors


MERGE_GRID = [  # R, k, fill of a, fill of b, BLOCKED slots, big counts
    (1, 16, 1.0, 1.0, 0, False),      # both full: both cross terms
    (1, 16, 0.5, 1.0, 0, False),      # one full
    (1, 16, 0.4, 0.3, 0, False),      # neither full: no cross term
    (4, 33, 1.0, 1.0, 0, True),       # sums past int32 saturate
    (5, 16, 1.0, 0.7, 3, False),      # BLOCKED slots in row 0
    (3, 128, 0.9, 1.0, 0, False),
    (2, 8, 0.0, 1.0, 0, False),       # an empty sketch
]


@pytest.mark.parametrize("R,k,fa,fb,blocked,big", MERGE_GRID)
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_banks_matches_reference(R, k, fa, fb, blocked, big, seed):
    rng = np.random.default_rng(seed)
    a = _random_bank(rng, R, k, fa, blocked, big)
    b = _random_bank(rng, R, k, fb, blocked, big)
    want = jbk.merge_banks(_j(a), _j(b))
    got = tbk.merge_banks(_t(a), _t(b))
    _assert_same(want, got, "merge_banks")
    # row-wise: each row is the (k,) state.merge of that row
    for r in range(R):
        row = tst.merge(_t([x[r] for x in a]), _t([x[r] for x in b]))
        _assert_same(_np(jst.merge(_j([x[r] for x in a]),
                                   _j([x[r] for x in b]))), row, f"row {r}")
        _assert_same(row, [t[r] for t in got], f"batched row {r}")


@pytest.mark.parametrize("R", [1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("fill,blocked", [(1.0, 0), (0.6, 0), (1.0, 2)])
def test_consolidate_pairs_rows_as_the_reference(R, fill, blocked):
    """The tree pairs rows (0, 1), (2, 3), ... with an odd last row
    carried up: merge keeps the top k, so any other pairing would give
    another summary."""
    rng = np.random.default_rng(R)
    bank = _random_bank(rng, R, 24, fill, blocked)
    _assert_same(jbk.consolidate(_j(bank)), tbk.consolidate(_t(bank)),
                 f"R={R}")


def test_blocked_rows_merge_cleanly():
    """BLOCKED capacity padding never surfaces through merge
    (``test_bank.py:119``): the banks are the reference's per-row
    capacity banks, updated by the reference."""
    a = jbk.update_rows(jbk.init([4, 2]),
                        jnp.asarray([[1, 2, 3, 7], [1, 4, 6, 8]], jnp.int32),
                        jnp.ones((2, 4), jnp.int32), 2)
    b = jbk.update_rows(jbk.init([4, 2]),
                        jnp.asarray([[2, 5, 5, 9], [3, 3, 6, 6]], jnp.int32),
                        jnp.ones((2, 4), jnp.int32), 2)
    got = tbk.merge_banks(_t(_np(a)), _t(_np(b)))
    _assert_same(jbk.merge_banks(a, b), got)
    assert (got.ids >= -1).all()
    assert (got.counts[got.ids < 0] == 0).all()


def _sharded_pair(S, ktot, seeds, variant=2):
    """Two sharded banks fed by the port on bounded-deletion streams."""
    out = []
    for seed in seeds:
        s = zipf_interleaved_stream(1500, 0.25, universe=1 << BITS, seed=seed)
        state = tshd.init(ktot, S, device="cpu")
        out.append(tshd.update_block(state, torch.from_numpy(s[:, 0]),
                                     torch.from_numpy(s[:, 1]), variant,
                                     universe_bits=BITS))
    return out


@pytest.mark.parametrize("S,ktot", [(4, 256), (3, 96), (8, 128)])
@pytest.mark.parametrize("variant", [1, 2])
def test_sharded_merge_consolidate_match_reference(S, ktot, variant):
    """``test_sharded.py:233``: the shard-wise merge is the per-shard
    ``state.merge``; consolidate, query and to_dict as the reference's."""
    a, b = _sharded_pair(S, ktot, (1, 2), variant)
    ja, jb = (jshd.ShardedSketch(bank=_j(_np(x.bank))) for x in (a, b))
    m = tshd.merge(a, b)
    jm = jshd.merge(ja, jb)
    _assert_same(jm.bank, m.bank, "merge")
    for s in range(S):
        _assert_same(tst.merge(*(tst.SketchState(*(t[s] for t in x.bank))
                                 for x in (a, b))),
                     [t[s] for t in m.bank], f"shard {s}")
    _assert_same(jshd.consolidate(jm), tshd.consolidate(m), "consolidate")
    assert tshd.to_dict(m) == jshd.to_dict(jm)
    for item in (0, 5, 77, 4095, int(m.bank.ids.max())):
        assert int(tshd.query(m, item)) == int(jshd.query(jm, item)), item


def test_consolidate_no_underestimation_insert_only():
    """``test_sharded.py:249``."""
    S, ktot = 4, 512
    rng = np.random.default_rng(9)
    toks = (rng.zipf(1.4, 4096) % 100).astype(np.int32)
    bank = tshd.update_block(tshd.init(ktot, S, device="cpu"),
                             torch.from_numpy(toks),
                             torch.ones(len(toks), dtype=torch.int32))
    cons = tshd.consolidate(bank)
    assert cons.ids.shape == (ktot // S,)
    freq = collections.Counter(toks.tolist())
    for it, (c, _) in tst.to_dict(cons).items():
        assert c >= freq.get(it, 0)
    jbank = jshd.ShardedSketch(bank=_j(_np(bank.bank)))
    _assert_same(jshd.consolidate(jbank), cons)


def test_to_dict_union():
    """``test_sharded.py:321``."""
    bank = tshd.update_block(
        tshd.init(64, 2, device="cpu"),
        torch.tensor([1, 2, 3, 1], dtype=torch.int32),
        torch.ones(4, dtype=torch.int32))
    d = tshd.to_dict(bank)
    assert d[1][0] == 2 and d[2][0] == 1 and d[3][0] == 1


def test_state_query_and_to_dict_match_reference():
    rng = np.random.default_rng(4)
    arrays = _random_bank(rng, 1, 40, 0.8, blocked=3)
    flat = [x[0] for x in arrays]
    js, ts = _j(flat), _t(flat)
    assert tst.to_dict(ts) == jst.to_dict(js)
    for item in [*flat[0][:8].tolist(), -1, -2, 999]:
        assert int(tst.query(ts, item)) == int(jst.query(js, item)), item
    with pytest.raises(OverflowError):
        tst.query(ts, 2**31)


def _streams(seed):
    rng = np.random.default_rng(seed)
    items = rng.zipf(1.4, BLOCK * 6).astype(np.int32) % (1 << BITS)
    weights = np.where(rng.random(BLOCK * 6) < 0.25, -1, 1).astype(np.int32)
    weights[:BLOCK] = 1
    return items, weights


def _api_states(shards, variant, seed):
    """The same blocks through both packages' ``api.update``."""
    jspec = japi.SketchSpec(k=64, variant=variant, shards=shards, bits=BITS)
    tspec = tapi.SketchSpec(k=64, variant=variant, shards=shards, bits=BITS)
    items, weights = _streams(seed)
    js, ts = japi.make(jspec), tapi.make(tspec, "cpu")
    for b in range(6):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        js = japi.update(jspec, js, items[sl], weights[sl])
        ts = tapi.update(tspec, ts, items[sl], weights[sl])
    return jspec, tspec, js, ts


def _leaves(state):
    return tuple(state.bank if hasattr(state, "bank") else state)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_api_merge_consolidate_parity(shards, variant):
    """``test_api_parity.py:196`` (frequency kind): ``api.merge`` is the
    layout's merge, ``api.consolidate`` its consolidate (the identity
    unsharded), both as the reference's."""
    jspec, tspec, ja, ta = _api_states(shards, variant, 0)
    _, _, jb, tb = _api_states(shards, variant, 1)
    _assert_same(_leaves(ja), _leaves(ta), "state a")
    merged = tapi.merge(tspec, ta, tb)
    _assert_same(_leaves(japi.merge(jspec, ja, jb)), _leaves(merged), "merge")
    direct = (tst.merge(ta, tb) if shards is None else tshd.merge(ta, tb))
    _assert_same(_leaves(direct), _leaves(merged), "direct")
    cons = tapi.consolidate(tspec, merged)
    _assert_same(japi.consolidate(jspec, japi.merge(jspec, ja, jb)), cons,
                 "consolidate")
    if shards is None:
        assert cons is merged


def _zipf_items(seed):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, 1500) % 96).astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_merge_preserves_overestimate_and_bound(seed):
    """``test_core_spacesaving.py:249`` on the port's summaries: the merge
    of two insert-only sketches never underestimates and stays within
    the additive bound; bit-equal to the reference's merge."""
    k = 24
    s1, s2 = _zipf_items(2 * seed), _zipf_items(2 * seed + 1)
    spec = tapi.SketchSpec(k=k, bits=BITS)
    a = tapi.update(spec, tapi.make(spec, "cpu"), s1, np.ones(len(s1), np.int32))
    b = tapi.update(spec, tapi.make(spec, "cpu"), s2, np.ones(len(s2), np.int32))
    m = tst.merge(a, b)
    _assert_same(jst.merge(_j(_np(a)), _j(_np(b))), m)
    freq = collections.Counter(s1.tolist()) + collections.Counter(s2.tolist())
    for it, (c, _) in tst.to_dict(m).items():
        if it >= 0:
            assert c >= freq.get(it, 0)
    bound = (len(s1) + len(s2)) / k * 2
    probe = torch.tensor(sorted(freq), dtype=torch.int32)
    est = tst.query_many(m, probe)
    for it, e in zip(probe.tolist(), est.tolist()):
        assert abs(e - freq[it]) <= bound


def test_merge_lazy_bounded_deletion():
    """``test_core_spacesaving.py:268``: Lazy SS± summaries of two
    inserts-first bounded-deletion streams merge without
    underestimating a monitored item."""
    k = 32
    spec = tapi.SketchSpec(k=k, variant="lazy", bits=BITS)
    states, streams = [], []
    for seed in (1, 2):
        s = zipf_interleaved_stream(1000, 0.4, universe=64, seed=seed)
        order = np.argsort(s[:, 1] < 0, kind="stable")   # inserts first
        s = s[order]
        streams.append(s)
        st = tapi.make(spec, "cpu")
        # one update a block: the reference's sketch takes them in order
        for lo in range(len(s)):
            st = tapi.update(spec, st, s[lo:lo + 1, 0], s[lo:lo + 1, 1])
        states.append(st)
    m = tst.merge(*states)
    _assert_same(jst.merge(*(_j(_np(x)) for x in states)), m)
    both = np.concatenate(streams)
    f = collections.Counter()
    for it, w in both:
        f[int(it)] += int(w)
    for it, (c, _) in tst.to_dict(m).items():
        assert c >= f.get(it, 0)


def _freq_specs(**kw):
    kw.setdefault("k", 64)
    kw.setdefault("bits", BITS)
    return japi.SketchSpec(**kw), tapi.SketchSpec(**kw)


def test_session_merge_from_rejects_layout_mismatch():
    """``test_api.py:428``."""
    a = TSession(tapi.SketchSpec(k=64, bits=BITS), block=32, device="cpu")
    for other in (dict(shards=4), dict(k=32), dict(variant="lazy")):
        spec = tapi.SketchSpec(**{"k": 64, "bits": BITS, **other})
        with pytest.raises(ValueError, match="different layouts"):
            a.merge_from(TSession(spec, block=32, device="cpu"))
    # backend is an execution path, not a layout: merge allowed
    a.merge_from(TSession(tapi.SketchSpec(k=64, bits=BITS, backend="block"),
                          block=32, device="cpu"))


def test_merge_from_rejects_window_mismatch_both_directions():
    """``test_api.py:511`` (on the frequency kind, the port's)."""
    spec = tapi.SketchSpec(k=64, bits=BITS)
    a = TSession(spec, block=32, window=10, device="cpu")
    b = TSession(spec, block=32, window=20, device="cpu")
    c = TSession(spec, block=32, device="cpu")
    for x, y in ((a, b), (b, a), (a, c), (c, a)):
        with pytest.raises(ValueError, match="window"):
            x.merge_from(y)


def test_merge_from_carries_pending_expiries():
    """``test_api.py:527``, both packages side by side."""
    sessions = []
    for spec, make in zip(_freq_specs(k=256),
                          (JSession, lambda *a, **kw: TSession(
                              *a, device="cpu", **kw))):
        a = make(spec, block=64, window=2)
        b = make(spec, block=64, window=2)
        for step in range(3):
            a.push(np.full(4, 10 + step, np.int32), np.ones(4, np.int32))
            b.push(np.full(4, 20 + step, np.int32), np.ones(4, np.int32))
        a.merge_from(b)
        assert len(a.batch_fifo) == 4
        for step in range(4):
            a.push(np.full(4, 30 + step, np.int32), np.ones(4, np.int32))
        for item in (11, 12, 21, 22):
            assert int(a.query(item)) == 0, item
        assert a.deletions == 4 * (a.insertions // 4 - 2)
        sessions.append(a)
    js, ts = sessions
    _assert_same(_leaves(js.state), _leaves(ts.state))
    assert (js.insertions, js.deletions) == (ts.insertions, ts.deletions)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_session_merge_from_and_consolidated_match_reference(shards, variant):
    """Two hosts' sessions merged, then consolidated, in both packages
    (the reference's kernel backend in interpret mode)."""
    jspec, tspec = (m.SketchSpec(k=96, variant=variant, shards=shards,
                                 bits=BITS, backend="kernel")
                    for m in (japi, tapi))
    got = []
    for spec, make in ((jspec, JSession),
                       (tspec, lambda *a, **kw: TSession(*a, device="cpu",
                                                         **kw))):
        host = [make(spec, block=BLOCK) for _ in range(2)]
        for seed, sess in enumerate(host):
            s = zipf_interleaved_stream(1200, 0.5, universe=1 << BITS,
                                        seed=seed + 3)
            sess.extend(s[:, 0], s[:, 1])
        host[0].merge_from(host[1])
        got.append((host[0].state, host[0].consolidated()))
    (js, jc), (ts, tc) = got
    _assert_same(_leaves(js), _leaves(ts), "merged")
    _assert_same(_leaves(jc), _leaves(tc), "consolidated")


def test_consolidated_checkpoint_roundtrip_across_packages():
    """``test_checkpoint.py:62``: consolidate after merge of sharded
    sessions survives a checkpoint round trip, into either package,
    with every query answer intact."""
    spec = tapi.SketchSpec(k=128, shards=4, bits=8)
    rng = np.random.default_rng(3)
    a, b = (TSession(spec, block=512, window=8, device="cpu")
            for _ in range(2))
    for _ in range(4):
        a.push(rng.integers(0, 256, 128), np.ones(128, np.int64))
        b.push(rng.integers(0, 256, 128), np.ones(128, np.int64))
    a.merge_from(b)
    cons = a.consolidated()
    assert cons.ids.shape == (128 // 4,)
    flat = tapi.SketchSpec(k=32, bits=8)
    d = tapi.save(flat, cons)
    probe = np.arange(256)
    want = tapi.query_many(flat, cons, probe)
    back = tapi.restore(flat, d, "cpu")
    assert torch.equal(tapi.query_many(flat, back, probe), want)
    jflat = japi.SketchSpec(k=32, bits=8)
    jback = japi.restore(jflat, d)
    np.testing.assert_array_equal(
        np.asarray(japi.query_many(jflat, jback, jnp.asarray(probe))),
        want.numpy())
    sd = a.save(include_schedule=True)
    c = TSession(spec, block=512, window=8, device="cpu")
    c.load(sd)
    _assert_same(c.consolidated(), cons)
