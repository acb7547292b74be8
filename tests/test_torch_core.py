"""The port's host-side oracles (``repro_torch.core``: ``heaps``,
``spacesaving``, ``baselines``, ``quantiles``) against the reference's
(``repro.core``), exactly.

Every case is deterministic: the updates are seeded numpy arrays
(``repro_torch.core.streams.zipf_interleaved_stream``, a Zipf(1.1)
bounded-deletion stream, interleaved), fed as they are to both packages.
Held equal:

- the §3.3 and §3.5 worked examples (Figures 1 and 2), at their stated
  entries too;
- SpaceSaving (insertion-only), Lazy SpaceSaving± and SpaceSaving± at
  capacities 1, 7 and 64 over three streams: ``entries()``, every
  estimate and error, ``min_count``, ``max_error``,
  ``guaranteed_frequent_items``, ``unaccounted_deletions``; weighted
  updates; ``merge``; ``make_sketch`` and ``capacity_for``;
- ``IndexedHeap`` (min and max) under seeded sequences of push,
  update_key, remove and replace_top: the top, the size and every key
  after each operation;
- MisraGries, CountMin, CountMedian and CSSS at equal seeds: their
  tables (and CSSS's sample) and estimates;
- DSS± (both variants), the budgeted DSS±/DSS-lazy/DCS/DCM, KLL and
  KLL±: ranks on a grid and quantiles, ``true_ranks`` and
  ``ks_divergence``.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import baselines as jbase
from repro.core import heaps as jheaps
from repro.core import quantiles as jq
from repro.core import spacesaving as jss
from repro_torch.core import baselines as tbase
from repro_torch.core import heaps as theaps
from repro_torch.core import quantiles as tq
from repro_torch.core import spacesaving as tss
from repro_torch.core.streams import zipf_interleaved_stream

A, B, C = "A", "B", "C"
PAPER_STREAM = [(A, 1), (A, 1), (A, 1), (C, 1), (A, -1), (B, 1), (A, 1),
                (C, -1), (B, -1)]
SEEDS = (0, 1, 2)
CAPACITIES = (1, 7, 64)
UNIVERSE = 256
QBITS = 10


def _stream(seed, n=3000, ratio=0.5, universe=UNIVERSE):
    return zipf_interleaved_stream(n, ratio, universe=universe, skew=1.1,
                                   seed=seed)


def _state(sk):
    return dict(entries=sorted(sk.entries()), min_count=sk.min_count,
                max_error=sk.max_error, n_insert=sk.n_insert,
                n_delete=sk.n_delete,
                guaranteed=sorted(sk.guaranteed_frequent_items()),
                unaccounted=getattr(sk, "unaccounted_deletions", None))


def _same(got, want, items):
    assert _state(got) == _state(want)
    for it in items:
        assert got.query(it) == want.query(it)
        assert got.error_of(it) == want.error_of(it)


# ---------------------------------------------------------------------------
# SpaceSaving, Lazy SpaceSaving±, SpaceSaving±
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix,cls,want", [
    (9, "LazySpaceSavingPM", {A: (3, 0), B: (1, 1)}),
    (9, "SpaceSavingPM", {A: (3, 0), B: (0, 0)}),
    (7, "SpaceSavingPM", {A: (3, 0), B: (2, 1)}),
])
def test_worked_examples(prefix, cls, want):
    """§3.3 (Figure 1, Lazy SS±) and §3.5 (Figure 2, SS±, after 7 and 9
    updates), capacity 2."""
    got = getattr(tss, cls)(2).process(PAPER_STREAM[:prefix])
    ref = getattr(jss, cls)(2).process(PAPER_STREAM[:prefix])
    assert {it: (c, e) for it, c, e in got.entries()} == want
    _same(got, ref, (A, B, C))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", CAPACITIES)
@pytest.mark.parametrize("kind", ["ss", "lazy", "sspm"])
def test_sketches_on_seeded_streams(kind, k, seed):
    stream = _stream(seed)
    if kind == "ss":
        stream = stream[stream[:, 1] > 0]
    got = tss.make_sketch(kind, k).process(stream)
    ref = jss.make_sketch(kind, k).process(stream)
    assert type(got).__name__ == type(ref).__name__
    _same(got, ref, range(UNIVERSE))
    assert got.frequent_items(3) == ref.frequent_items(3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["lazy", "sspm"])
def test_weighted_updates(kind, seed):
    rng = np.random.default_rng(100 + seed)
    items = rng.integers(0, 40, 400)
    weights = rng.integers(1, 6, 400)
    signs = np.where(rng.random(400) < 0.7, 1, -1)
    got, ref = tss.make_sketch(kind, 16), jss.make_sketch(kind, 16)
    for it, w, s in zip(items.tolist(), weights.tolist(), signs.tolist()):
        for sk in (got, ref):
            if s > 0:
                sk.insert_weighted(it, w)
            else:
                sk.delete_weighted(it, w)
    _same(got, ref, range(40))


@pytest.mark.parametrize("kind", ["ss", "lazy", "sspm"])
def test_merge(kind):
    s1, s2 = _stream(10, ratio=0.0), _stream(11, ratio=0.0)
    if kind != "ss":
        s1, s2 = _stream(10), _stream(11)
    got = tss.make_sketch(kind, 32).process(s1).merge(
        tss.make_sketch(kind, 32).process(s2))
    ref = jss.make_sketch(kind, 32).process(s1).merge(
        jss.make_sketch(kind, 32).process(s2))
    _same(got, ref, range(UNIVERSE))


def test_lemma9_counterexample_equals_the_reference():
    """An interleaved stream on which SpaceSaving± drives an error to -1:
    the reference's ``test_lemma9_error_sum_and_nonneg`` fails when its
    hypothesis strategy draws such a stream (seed 394961921, 712
    inserts, alpha 4, universe 256, interleaved). The error sum (15)
    still covers the unmonitored mass (12); the sign bound does not hold.
    The port's SpaceSavingPM equals the reference's entry for entry, the
    -1 included."""
    from repro.core.streams import bounded_stream as ref_stream
    from repro.core.streams import exact_stats

    stream = ref_stream("zipf", 712, delete_ratio=1.0 - 1.0 / 4.0,
                        universe=256, skew=1.1, order="interleaved",
                        seed=394961921)
    k = jss.capacity_for(0.1, 4.0, "ss_pm")
    got = tss.SpaceSavingPM(k).process(stream)
    ref = jss.SpaceSavingPM(k).process(stream)
    _same(got, ref, range(256))
    errors = [e for _, _, e in got.entries()]
    assert min(errors) == -1 and sum(errors) == 15
    stats = exact_stats(stream)
    monitored = {it for it, _, _ in got.entries()}
    assert sum(c for it, c in stats.frequencies.items()
               if it not in monitored) == 12


@pytest.mark.parametrize("eps,alpha,variant", [
    (1e-3, 2.0, "ss_pm"), (1e-3, 2.0, "lazy"), (0.3, 1.5, "ss"),
    (1e-5, 2.0, "sspm")])
def test_capacity_for(eps, alpha, variant):
    assert tss.capacity_for(eps, alpha, variant) == \
        jss.capacity_for(eps, alpha, variant)


def test_make_sketch_refuses_unknown_kinds():
    with pytest.raises(ValueError, match="unknown sketch kind"):
        tss.make_sketch("countmin", 4)


def test_plain_spacesaving_refuses_deletions():
    with pytest.raises(NotImplementedError):
        tss.SpaceSaving(4).process([(1, 1), (1, -1)])


# ---------------------------------------------------------------------------
# IndexedHeap
# ---------------------------------------------------------------------------

def _heap_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, 4, n).tolist(),
                    rng.integers(0, 30, n).tolist(),
                    rng.integers(-50, 50, n).tolist()))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sign", [1, -1])
def test_indexed_heap_sequences(sign, seed):
    got, ref = theaps.IndexedHeap(sign), jheaps.IndexedHeap(sign)
    next_item = 1000
    for op, item, key in _heap_ops(seed):
        if op == 0 or not len(ref):
            if item in ref:
                continue
            for h in (got, ref):
                h.push(item, key)
        elif op == 1:
            item = sorted(ref.pos)[item % len(ref)]
            for h in (got, ref):
                h.update_key(item, key)
        elif op == 2:
            item = sorted(ref.pos)[item % len(ref)]
            for h in (got, ref):
                h.remove(item)
        else:
            assert got.replace_top(next_item, key) == \
                ref.replace_top(next_item, key)
            next_item += 1
        got.check_invariants()
        assert len(got) == len(ref)
        if len(ref):
            assert got.peek() == ref.peek()
        assert {it: got.key_of(it) for it in got.pos} == \
            {it: ref.key_of(it) for it in ref.pos}


def test_indexed_heap_refuses_bad_input():
    with pytest.raises(ValueError):
        theaps.IndexedHeap(0)
    h = theaps.IndexedHeap()
    h.push("x", 1)
    with pytest.raises(KeyError, match="duplicate"):
        h.push("x", 2)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_misra_gries(seed):
    stream = _stream(seed, ratio=0.0)
    got = tbase.MisraGries(25).process(stream)
    ref = jbase.MisraGries(25).process(stream)
    assert got.counters == ref.counters
    assert got.frequent_items(5) == ref.frequent_items(5)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["CountMin", "CountMedian"])
def test_count_sketches(name, seed):
    stream = _stream(seed)
    got = getattr(tbase, name).from_accuracy(0.02, 0.01, seed=seed)
    ref = getattr(jbase, name).from_accuracy(0.02, 0.01, seed=seed)
    got.process(stream)
    ref.process(stream)
    np.testing.assert_array_equal(got.table, ref.table)
    items = np.arange(UNIVERSE)
    np.testing.assert_array_equal(got.query_many(items),
                                  ref.query_many(items))
    assert got.query(3) == ref.query(3)
    assert got.frequent_items(20, items) == ref.frequent_items(20, items)
    assert got.space_counters == ref.space_counters


@pytest.mark.parametrize("seed", SEEDS)
def test_csss(seed):
    stream = _stream(seed, n=6000)
    kw = dict(eps=0.05, delta=0.05, alpha=2.0, universe=UNIVERSE,
              stream_len=len(stream), seed=seed)
    got, ref = tbase.CSSS(**kw).process(stream), jbase.CSSS(**kw).process(
        stream)
    assert (got.p, got.sampled) == (ref.p, ref.sampled)
    np.testing.assert_array_equal(got.inner.table, ref.inner.table)
    items = np.arange(UNIVERSE)
    np.testing.assert_array_equal(got.query_many(items),
                                  ref.query_many(items))
    for it in (0, 1, 7):
        got.update(it, 1)
        ref.update(it, 1)
    assert got.query(0) == ref.query(0)


# ---------------------------------------------------------------------------
# Quantiles
# ---------------------------------------------------------------------------

def _qstream(seed):
    return zipf_interleaved_stream(3000, 0.5, universe=1 << QBITS, skew=0.8,
                                   seed=seed)


def _values(stream):
    """The live multiset of a strict bounded-deletion stream."""
    live = {}
    for it, s in stream.tolist():
        live[it] = live.get(it, 0) + s
    return np.repeat(np.asarray(list(live), np.int64),
                     np.asarray(list(live.values()), np.int64))


GRID = np.linspace(0, (1 << QBITS) - 1, 33).astype(np.int64)
QS = (0.0, 0.01, 0.25, 0.5, 0.75, 0.99, 1.0)


def _same_quantiles(got, ref, values):
    assert got.mass == ref.mass
    assert [got.rank(int(x)) for x in GRID] == [ref.rank(int(x))
                                                 for x in GRID]
    assert [got.quantile(q) for q in QS] == [ref.quantile(q) for q in QS]
    assert tq.ks_divergence(got, values) == jq.ks_divergence(ref, values)


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_dss_pm(variant, seed):
    stream = _qstream(seed)
    got = tq.make_dss_pm(QBITS, 0.2, variant=variant).process(stream)
    ref = jq.make_dss_pm(QBITS, 0.2, variant=variant).process(stream)
    assert got.space_counters == ref.space_counters
    for gl, rl in zip(got.layers, ref.layers):
        assert sorted(gl.entries()) == sorted(rl.entries())
    _same_quantiles(got, ref, _values(stream))


@pytest.mark.parametrize("kind", ["dss_pm", "dss_lazy", "dcs", "dcm"])
def test_dyadic_from_budget(kind):
    stream = _qstream(5)
    got = tq.dyadic_from_budget(QBITS, 600, kind, seed=3).process(stream)
    ref = jq.dyadic_from_budget(QBITS, 600, kind, seed=3).process(stream)
    assert got.space_counters == ref.space_counters
    _same_quantiles(got, ref, _values(stream))


@pytest.mark.parametrize("total,eps", [(600, None), (None, 0.1),
                                       (None, 1e-3)])
def test_layer_capacities(total, eps):
    assert tq.dyadic_layer_capacities(QBITS, total, eps) == \
        jq.dyadic_layer_capacities(QBITS, total, eps)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_kll(seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, 1 << QBITS, 2000).tolist()
    got, ref = tq.KLL(k=32, seed=seed), jq.KLL(k=32, seed=seed)
    for x in xs:
        got.insert(x)
        ref.insert(x)
    assert got.levels == ref.levels
    assert [got.rank(int(x)) for x in GRID] == [ref.rank(int(x))
                                                 for x in GRID]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_kll_pm(seed):
    stream = _qstream(seed)
    got = tq.KLLpm(k=32, seed=seed).process(stream)
    ref = jq.KLLpm(k=32, seed=seed).process(stream)
    assert got.space_counters == ref.space_counters
    _same_quantiles(got, ref, _values(stream))


def test_true_ranks():
    values = _values(_qstream(7))
    np.testing.assert_array_equal(tq.true_ranks(values, GRID),
                                  jq.true_ranks(values, GRID))
    assert tq.ks_divergence(None, np.asarray([])) == 0.0
