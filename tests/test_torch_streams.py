"""The port's paper streams (``repro_torch.core.streams``) against the
reference's generators (``repro.core.streams``), array for array.

Held equal with ``np.array_equal`` (and the same dtype): ``bounded_stream``
on the 4 x 2 x 2 grid of distributions, deletion patterns and orders at
2,000 insertions and ratio 0.5, and Zipf at ratio 0.9375 (alpha = 16)
with both patterns and both orders; each generator alone. The same
``ValueError``s for an unknown distribution, pattern or order, and for
interleaved deletions that are not a sub-multiset of the insertions.
``zipf_interleaved_stream`` (the port's own stream, once named
``bounded_stream``) is pinned to checksums of its output taken before the
rename, so its bits did not move.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest

from repro.core import streams as ref
from repro_torch.core import streams as port

DISTS = ("zipf", "binomial", "uniform", "caida")
PATTERNS = ("random", "targeted")
ORDERS = ("inserts_first", "interleaved")


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("dist", DISTS)
def test_bounded_stream_is_the_references(dist, pattern, order):
    kw = dict(delete_pattern=pattern, order=order, seed=3)
    assert _same(port.bounded_stream(dist, 2000, 0.5, **kw),
                 ref.bounded_stream(dist, 2000, 0.5, **kw))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_alpha_16_is_the_references(pattern, order):
    kw = dict(universe=1 << 12, delete_pattern=pattern, order=order, seed=5)
    got = port.bounded_stream("zipf", 2000, 0.9375, **kw)
    assert _same(got, ref.bounded_stream("zipf", 2000, 0.9375, **kw))
    assert (got[:, 1] < 0).sum() == 1875


def test_the_defaults_are_the_references():
    got = port.bounded_stream("zipf", 1000, 0.5)
    assert _same(got, ref.bounded_stream("zipf", 1000, 0.5))
    # inserts_first: every deletion after every insertion
    assert (got[:1000, 1] == 1).all() and (got[1000:, 1] == -1).all()


@pytest.mark.parametrize("skew", [0.8, 1.0, 1.3])
def test_each_generator_is_the_references(skew):
    n, U = 3000, 1 << 10
    assert _same(port.zipf_insertions(n, U, skew, seed=7),
                 ref.zipf_insertions(n, U, skew, seed=7))
    assert _same(port.binomial_insertions(n, U, seed=7),
                 ref.binomial_insertions(n, U, seed=7))
    assert _same(port.uniform_insertions(n, U, seed=7),
                 ref.uniform_insertions(n, U, seed=7))
    assert _same(port.caida_like_insertions(n, U, seed=7),
                 ref.caida_like_insertions(n, U, seed=7))
    ins = ref.zipf_insertions(n, U, skew, seed=8)
    assert _same(port.deletions_random(ins, 1200, seed=9),
                 ref.deletions_random(ins, 1200, seed=9))
    for m in (0, 1, 1200, n, n + 5):
        assert _same(port.deletions_targeted(ins, m),
                     ref.deletions_targeted(ins, m))


def test_targeted_breaks_ties_by_first_occurrence():
    ins = np.array([5, 3, 9, 3, 5, 7, 9, 9, 1], np.int64)
    # frequencies: 5:2 3:2 9:3 7:1 1:1 -> 7, 1, then 5, 3 (first seen)
    want = np.array([7, 1, 5, 5, 3], np.int64)
    assert _same(port.deletions_targeted(ins, 5), want)
    assert _same(ref.deletions_targeted(ins, 5), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaved_order_matches_first_occurrences(seed):
    rng = np.random.default_rng(seed)
    ins = rng.integers(0, 16, size=400).astype(np.int64)
    dels = rng.permutation(ins)[:150]
    got = port.make_stream(ins, dels, "interleaved", seed=seed)
    assert _same(got, ref.make_stream(ins, dels, "interleaved", seed=seed))
    # strict turnstile: no prefix drives an item below 0
    port.exact_stats(got)


def test_vector_uniforms_are_the_scalar_draws():
    """``make_stream`` draws its deletion times in one vector call where
    the reference draws one scalar a matched position."""
    low = np.array([0, 3, 7, 7, 1000, 99_999], np.int64) + 0.5
    vec = np.random.default_rng(11).uniform(low, 100_000 + 0.5)
    rng = np.random.default_rng(11)
    loop = np.array([rng.uniform(float(lo), 100_000 + 0.5) for lo in low])
    assert np.array_equal(vec, loop)


def test_the_same_value_errors():
    ins = np.arange(10, dtype=np.int64)
    for mod in (port, ref):
        with pytest.raises(ValueError, match="unknown distribution"):
            mod.bounded_stream("pareto", 100, 0.5)
        with pytest.raises(ValueError, match="unknown delete_pattern"):
            mod.bounded_stream("zipf", 100, 0.5, delete_pattern="oldest")
        with pytest.raises(ValueError, match="unknown pattern"):
            mod.bounded_stream("zipf", 100, 0.5, order="sorted")
        with pytest.raises(ValueError, match="sub-multiset"):
            mod.make_stream(ins, np.array([3, 3], np.int64), "interleaved")
        with pytest.raises(ValueError, match="sub-multiset"):
            mod.make_stream(ins, np.array([42], np.int64), "interleaved")


# sha256 of zipf_interleaved_stream's output (C-ordered int64 bytes), taken
# on the tree before the rename, when the function was named bounded_stream
PINNED = [
    ((600, 0.5), dict(universe=1 << 12, seed=3), (900, 2),
     "9f791c068c65307c89325560abf0a389265adfbbb28654647f91e2896ced6d8c"),
    ((1500, 0.25), dict(universe=1 << 10, skew=1.1, seed=7), (1875, 2),
     "42174d764f7f159ff8d1482a3c0cbcb3f7220a0c126597b37885f1bcb970a8bb"),
]


@pytest.mark.parametrize("args,kw,shape,digest", PINNED)
def test_renamed_generator_keeps_its_bits(args, kw, shape, digest):
    s = port.zipf_interleaved_stream(*args, **kw)
    assert s.shape == shape and s.dtype == np.int64
    assert hashlib.sha256(np.ascontiguousarray(s).tobytes()).hexdigest() \
        == digest


def test_mixed_traffic_keeps_its_bits():
    """``mixed_traffic`` draws its items as it did before the paper's
    generators came in (sha256 pinned on the tree before)."""
    ops = port.mixed_traffic(8, 2000, seed=1)
    h = hashlib.sha256()
    for op in ops:
        h.update(repr(op[:2]).encode())
        for a in op[2:]:
            h.update(np.ascontiguousarray(a).tobytes())
    assert (len(ops), h.hexdigest()) == (
        53, "0290c1f16826b4b78987f53eb1aad006d41e5f540f521c1208353733413bd78e")


def test_core_exports_the_references_names():
    import repro.core
    import repro_torch.core

    assert repro_torch.core.__all__ == repro.core.__all__
    assert all(hasattr(repro_torch.core, name)
               for name in repro_torch.core.__all__)
