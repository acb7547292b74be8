"""The water level as kernel 1 searches it, held to the plain bisection.

Kernel 1 (``csrc/fused_update.cu``) finds the water level T of a row's
m unit inserts as the reference does, by bisecting [lo, lo + m] with
int32 level sums that may wrap (``phases.waterfill_unit_inserts``,
reference ``src/repro/sketch/phases.py:191``), but it evaluates the next
``levels`` trips of the bisection in one pass over the row: every
threshold those trips can probe (the tree of their midpoints), then a
walk down the tree with those sums, stopping at the first trip that
changes neither bound (every later trip repeats it). Off the int32
rails, a level sum is taken as (x + 1) #{c <= x} - sum{c <= x} mod 2^32;
on them, slot by slot. The placement then ranks the slots in index
order. ``model_waterfill`` below is that algebra written plainly in
numpy; these tests hold it to the port's and the reference's
``waterfill_unit_inserts`` (ids, counts, errors) on seeded rows: equal
counts, counts at both int32 rails, BLOCKED padding at INT_MAX, m = 0, 1
and B, and rows of 65,536 slots whose probe sums pass 2^31 (asserted).
The kernel itself meets such rows on the card (``chip_smoke.py``'s
``wrap`` cases, ``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro.sketch import phases as jph
from repro_torch.sketch import phases as tph

IMAX = 2**31 - 1
IMIN = -2**31
BLOCKED = -2
_jwaterfill = jax.jit(jax.vmap(jph.waterfill_unit_inserts,
                               in_axes=(0, 0, 0, None, 0, 0)))


def wrap32(x):
    """int64 (or Python int) folded into int32, as an int32 add wraps."""
    return (x + 2**31) % 2**32 - 2**31


def sat_add(a, b):
    """The reference's one-sided saturating add (state.py:31), int64 in,
    int32 out."""
    lo = -IMAX - np.minimum(a, 0)
    hi = IMAX - np.maximum(a, 0)
    return wrap32(a + np.minimum(np.maximum(b, lo), hi))


def n_leq(c, x, m):
    """Per slot: the values <= x of {c, c + 1, ...}, clipped to m + 1."""
    d = np.clip(sat_add(x, wrap32(-c)), 0, m)
    return np.where(c <= x, d + 1, 0)


def off_rails(lo, m) -> bool:
    return lo != IMIN and lo <= IMAX - m


def level_sum(c, x, m, exact) -> int:
    """The row's int32 level sum at x, wrapped; off the rails by the
    kernel's closed form."""
    if exact:
        under = c <= x
        return int(wrap32((int(x) + 1) * int(under.sum()) - int(c[under].sum())))
    return int(wrap32(int(n_leq(c, x, m).sum())))


def midpoint(lo, hi) -> int:
    return int(sat_add(lo, sat_add(hi, wrap32(-lo)) // 2))


def bisection_level(c, m, trips) -> int:
    """The reference's water level: ``trips`` trips of the bisection of
    [lo, lo + m], each sum slot by slot in wrapping int32."""
    lo = int(c.min())
    hi = int(sat_add(lo, m))
    for _ in range(trips):
        mid = midpoint(lo, hi)
        ge = level_sum(c, mid, m, False) >= m
        lo, hi = (lo, mid) if ge else (int(sat_add(mid, 1)), hi)
    return lo


def tree_level(c, m, levels, trips):
    """Kernel 1's water level: ``levels`` trips a pass over the row, the
    walk stopped at the first trip that changes neither bound. Returns
    (T, passes); asserts the stop comes within the reference's
    ``trips``."""
    lo = int(c.min())
    hi = int(sat_add(lo, m))
    exact = off_rails(lo, m)
    nodes = 2**levels - 1
    moved = passes = 0
    while True:
        bounds, mids = [(lo, hi)], []
        for n in range(nodes):
            l, h = bounds[n]
            mids.append(midpoint(l, h))
            if 2 * n + 2 < nodes:
                bounds += [(l, mids[n]), (int(sat_add(mids[n], 1)), h)]
        sums = [level_sum(c, x, m, exact) for x in mids]
        passes += 1
        n = 0
        for _ in range(levels):
            ge = sums[n] >= m
            mid = midpoint(lo, hi)
            assert mid == mids[n]
            nlo, nhi = (lo, mid) if ge else (int(sat_add(mid, 1)), hi)
            if (nlo, nhi) == (lo, hi):
                assert moved <= trips
                return lo, passes
            lo, hi, moved = nlo, nhi, moved + 1
            n = 2 * n + (1 if ge else 2)


def model_waterfill(ids, counts, errors, uu, m, offset, levels):
    """One row's water-fill as kernel 1 computes it: T by ``tree_level``,
    the level sums at T - 1, then each slot's pops by its index-order
    ranks among the eligible (count <= T) and under (count <= T - 1)
    slots. int64 arrays in, new (ids, counts, errors) out."""
    if m == 0:
        return ids, counts, errors
    G = len(uu)
    c = counts
    T, _ = tree_level(c, m, levels, G.bit_length() + 1)
    tm1 = int(wrap32(T - 1))
    if off_rails(int(c.min()), m):
        under = c <= tm1
        n_under, s_under = int(under.sum()), int(c[under].sum())
        f1, f2 = wrap32(T * n_under - s_under), wrap32(tm1 * n_under - s_under)
    else:
        f1 = wrap32(int(n_leq(c, tm1, m).sum()))
        f2 = wrap32(int(np.where(c < tm1, np.clip(sat_add(tm1, wrap32(-c)),
                                                  0, m), 0).sum()))
    extra_n = wrap32(m - f1)
    elig, under = c <= T, c <= tm1
    rank = np.cumsum(elig) - elig
    below = np.cumsum(under) - under
    extra = elig & (rank < extra_n)
    t = np.where(under, np.clip(sat_add(T, wrap32(-c)), 0, m), 0) + extra
    pos = np.where(extra, wrap32(f1 + np.minimum(rank, extra_n)),
                   wrap32(f2 + below))
    src = np.clip(wrap32(offset + pos), 0, G - 1)
    nc = sat_add(c, t)
    hit = t > 0
    return (np.where(hit, uu[src], ids), nc, np.where(hit, nc - 1, errors))


DOMAINS = ("random", "equal", "rail+", "rail-", "blocked", "wrap")
LEVELS = (1, 2, 3, 4)


@functools.lru_cache(maxsize=None)
def domain(kind):
    """Rows (ids, counts, errors), the flat (R * B,) unit-insert uids, the
    per-row m (0, 1, B and random) and offsets r * B; numpy int32 from a
    seed. ``wrap``: one row of 65,536 slots at one count with m = B =
    65,536, whose first probe sum passes 2^31."""
    rng = np.random.default_rng(DOMAINS.index(kind))
    R, K, B = (1, 65536, 65536) if kind == "wrap" else (4, 300, 256)
    ids = (1 << 20) + np.arange(R * K).reshape(R, K)
    errors = rng.integers(0, 5, (R, K))
    if kind in ("random", "blocked"):
        counts = rng.integers(0, 60, (R, K))
    elif kind in ("equal", "wrap"):
        counts = np.full((R, K), 5)
    elif kind == "rail+":
        counts = IMAX - rng.integers(0, 40, (R, K))
    else:
        counts = -IMAX + rng.integers(0, 40, (R, K))
    if kind in ("blocked", "rail+"):
        ids[:, -K // 8:], counts[:, -K // 8:], errors[:, -K // 8:] = (
            BLOCKED, IMAX, 0)
    m = np.array([B] if kind == "wrap" else [0, 1, B, rng.integers(2, B)])
    uu = (1 << 24) + rng.permutation(R * B)
    offset = np.arange(R) * B
    as32 = lambda a: np.asarray(a).astype(np.int32)
    return tuple(map(as32, (ids, counts, errors, uu, m, offset)))


@functools.lru_cache(maxsize=None)
def references(kind):
    """The reference's and the port's water-fill of a domain, numpy."""
    args = domain(kind)
    want = _jwaterfill(*map(jnp.asarray, args))
    port = tph.waterfill_unit_inserts(*(torch.from_numpy(a) for a in args))
    return ([np.asarray(w) for w in want], [p.numpy() for p in port])


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", DOMAINS)
def test_tree_search_equals_the_bisection(kind, levels):
    """Row by row, the water-fill with ``levels`` trips a pass gives the
    reference's and the port's ids, counts and errors."""
    ids, counts, errors, uu, m, offset = domain(kind)
    want, port = references(kind)
    for w, p in zip(want, port):
        np.testing.assert_array_equal(w, p)
    i64 = lambda a: a.astype(np.int64)
    for r in range(len(m)):
        got = model_waterfill(i64(ids[r]), i64(counts[r]), i64(errors[r]),
                              i64(uu), int(m[r]), int(offset[r]), levels)
        for name, w, g in zip(("ids", "counts", "errors"), want, got):
            np.testing.assert_array_equal(w[r], g, err_msg=f"row {r} {name}")


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", DOMAINS)
def test_tree_level_is_the_bisections_level(kind, levels):
    """T itself, against the reference's fixed trip count; ``levels``
    trips a pass take ceil(trips / levels) passes at most."""
    _, counts, _, uu, m, _ = domain(kind)
    trips = len(uu).bit_length() + 1
    for r in range(len(m)):
        if m[r] == 0:
            continue
        c = counts[r].astype(np.int64)
        T, passes = tree_level(c, int(m[r]), levels, trips)
        assert T == bisection_level(c, int(m[r]), trips), f"row {r}"
        assert passes <= -(-(int(m[r]).bit_length() + 2) // levels)


def test_wrap_rows_really_wrap():
    """The wrap domain's first probe sums past 2^31 slot by slot, so the
    int32 sum the reference compares is negative there."""
    _, counts, _, _, m, _ = domain("wrap")
    c = counts[0].astype(np.int64)
    lo = int(c.min())
    x = midpoint(lo, int(sat_add(lo, int(m[0]))))
    total = int(n_leq(c, x, int(m[0])).sum())
    assert total >= 2**31
    assert level_sum(c, x, int(m[0]), True) == wrap32(total) < 0
    assert level_sum(c, x, int(m[0]), False) == wrap32(total)


@pytest.mark.parametrize("seed", range(4))
def test_closed_form_level_sum_is_the_slot_sum_off_the_rails(seed):
    """Off the rails, (x + 1) #{c <= x} - sum{c <= x} mod 2^32 is the
    slot-by-slot sum, at every x in [lo, lo + m]."""
    rng = np.random.default_rng(100 + seed)
    lo = int(rng.choice([IMIN + 1, -IMAX + 7, -5, 0, 1 << 30, IMAX - 300]))
    m = int(rng.integers(1, 300))
    c = np.concatenate([[lo], lo + rng.integers(0, 2 * m + 5, 500)])
    c = np.minimum(c, IMAX).astype(np.int64)
    assert off_rails(lo, m)
    for x in range(lo, lo + m + 1, max(m // 17, 1)):
        assert level_sum(c, x, m, True) == level_sum(c, x, m, False)
