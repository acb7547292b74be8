"""The SS± drain as a selection, held to the plain residual phases.

The residual kernels (``csrc/residual.cu``, kernel 2 of
``csrc/fused_update.cu``) drain the unmonitored deletion weight rem in
one parallel selection, not in the plain versions' greedy chain: a
search for the threshold t* (the least t with the sum of the errors
above t within rem), then one pass in index order over the slots at
exactly t* (``csrc/residual_common.cuh`` derives it). ``model_drain``
below is that algebra written plainly in torch (a binary search and a
cumsum for the ranks); these tests hold it to ``phases.residual_phase``
and ``bank.residual_phase_banked`` on seeded inputs built at the
selection's edges (``chip_smoke.drain_domains``: ties at the threshold
inside a row and across rows, rem at a prefix sum, rem past the total,
error sums past 2^31, errors of every sign, EMPTY and BLOCKED slots),
and hold those plain versions to the reference's on the same inputs.
The kernels themselves meet the same inputs on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro.sketch import bank as jbk
from repro.sketch import phases as jph
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import phases as tph
from repro_torch.sketch.state import sat_add, wrap_add

ROOT = pathlib.Path(__file__).resolve().parents[1]
_jresidual = jax.jit(jph.residual_phase, static_argnums=8)
_jbanked = jax.jit(jbk.residual_phase_banked, static_argnums=9)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
KINDS = CS.DRAIN_KINDS


def model_drain(counts, errors, rem, saturating):
    """The drain of ``rem`` over one domain's flat (N,) slots as a
    selection: t* by a binary search on F(t) = sum of errors > t (int64),
    the slots above t* drained fully, then rem - F(t*) taken t* at a time
    from the slots at t* in index order. Counts give up d by sat_add or by
    a wrapping subtract. Returns new (counts, errors)."""
    e = errors.long()
    if rem <= 0 or int(e.max()) <= 0:
        return counts.clone(), errors.clone()

    def F(t):
        return int(torch.where(e > t, e, 0).sum())

    if F(0) <= rem:
        ts, q, last = 0, 0, 0
    else:
        lo, hi = 0, int(e.max())       # F(lo) > rem >= F(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if F(mid) <= rem else (mid, hi)
        ts = hi
        q, last = divmod(rem - F(ts), ts)
    at = (e == ts) & (ts > 0)
    rank = torch.cumsum(at.long(), 0) - 1
    d = torch.where(e > ts, e, 0)
    d = torch.where(at & (rank < q), ts, d)
    d = torch.where(at & (rank == q), last, d).to(torch.int32)
    new_c = sat_add(counts, -d) if saturating else wrap_add(counts, -d)
    return new_c, errors - d


def _split_inputs(kind, E, k, seed):
    """Kernel 3's layout: E sketches' (R, 128) rows, BLOCKED past k, with
    no insert to place (start = n_ins = 0): the drain alone."""
    ids, counts, errors, rem = CS.drain_domains(kind, E, k, seed)
    rows = tph.pad_rows(*(torch.as_tensor(a) for a in (ids, counts, errors)))
    zero = torch.zeros(E, dtype=torch.int32)
    B = 4
    layout = (torch.zeros((E, B), dtype=torch.int32),) * 2
    return rows, (*layout, zero, zero, torch.as_tensor(rem))


def _banked_inputs(kind, R, K, seed):
    """Kernel 2's layout: R rows of K slots, unpadded, the drain alone."""
    ids, counts, errors, rem = CS.drain_domains(kind, R, K, seed)
    state = tuple(torch.as_tensor(a) for a in (ids, counts, errors))
    zero = torch.zeros(R, dtype=torch.int32)
    flat = torch.zeros(4 * R, dtype=torch.int32)
    return state, (flat, flat, zero, zero, zero, torch.as_tensor(rem))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_selection_equals_residual_phase(kind, seed):
    (ids2, cnt2, err2), args = _split_inputs(kind, 3, 700, seed)
    got = tph.residual_phase(ids2, cnt2, err2, *args, 2)
    assert torch.equal(got[0], ids2)
    for e in range(3):
        want_c, want_e = model_drain(cnt2[e].reshape(-1), err2[e].reshape(-1),
                                     int(args[4][e]), saturating=False)
        assert torch.equal(got[1][e].reshape(-1), want_c), (kind, e)
        assert torch.equal(got[2][e].reshape(-1), want_e), (kind, e)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_selection_equals_residual_phase_banked(kind, seed):
    (ids, cnt, err), args = _banked_inputs(kind, 3, 601, seed)
    got = tbk.residual_phase_banked(ids, cnt, err, *args, 2)
    assert torch.equal(got[0], ids)
    for r in range(3):
        want_c, want_e = model_drain(cnt[r], err[r], int(args[5][r]),
                                     saturating=True)
        assert torch.equal(got[1][r], want_c), (kind, r)
        assert torch.equal(got[2][r], want_e), (kind, r)


def test_selection_counts_a_threshold_inside_the_ties():
    """On the tie case the selection ends inside the run of slots at
    t* = 1,000: seven of them drain fully, the eighth gives up 123, and
    the others keep their errors; the count rail decides wrap or sat."""
    (_, cnt2, err2), args = _split_inputs("ties", 1, 700, 0)
    e = err2.reshape(-1)
    c = cnt2.reshape(-1)
    rem = int(args[4][0])
    new_c, new_e = model_drain(c, e, rem, saturating=False)
    at = (e == 1000).nonzero().flatten()
    assert len(at) > 8
    assert new_e[at].tolist()[:9] == [0] * 7 + [877, 1000]
    assert int((e - new_e).long().sum()) == rem
    sat_c, _ = model_drain(c, e, rem, saturating=True)
    railed = (c < -2**31 + 1000) & (new_e < e)
    assert railed.any()
    assert bool((new_c[railed] > 0).all())           # wrapped
    assert bool((sat_c[railed] == -2**31 + 1).all())  # saturated


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_equal_the_reference_on_the_drain_cases(kind):
    """The plain versions the kernels are held to agree with the
    reference's on the drain cases, evictions included: the single-sketch
    phase 2 (one sketch, as the reference runs it) and the banked one."""
    ids, counts, errors, rem = CS.drain_domains(kind, 2, 640, 5)
    uids, net = CS.drain_inserts(2, 64, 5)
    for e in range(2):
        rows = jph.pad_rows(*(jnp.asarray(a[e]) for a in (ids, counts, errors)))
        args = (jnp.asarray(uids[e]), jnp.asarray(net[e]), jnp.int32(0),
                jnp.int32(CS.DRAIN_INSERTS), jnp.int32(rem[e]))
        want = _jresidual(*rows, *args, 2)
        got = tph.residual_phase(
            *(torch.as_tensor(np.array(r))[None] for r in rows),
            torch.as_tensor(uids[e:e + 1]), torch.as_tensor(net[e:e + 1]),
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), CS.DRAIN_INSERTS, dtype=torch.int32),
            torch.as_tensor(rem[e:e + 1]), 2)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b[0].numpy()), (kind, e)
    flat_u, flat_n = uids.reshape(-1), net.reshape(-1)
    uoff = np.arange(2, dtype=np.int32) * 64
    start = np.zeros(2, np.int32)
    n_ins = start + CS.DRAIN_INSERTS
    args = (flat_u, flat_n, uoff, start, n_ins, rem)
    want = _jbanked(*(jnp.asarray(a) for a in (ids, counts, errors, *args)), 2)
    got = tbk.residual_phase_banked(
        *(torch.as_tensor(a) for a in (ids, counts, errors, *args)), 2)
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), kind
