"""The port's compressed data-parallel exchange
(``repro_torch.train.dp_exchange``) against the reference's.

The reference's ``compressed_psum_leaf`` runs under ``jax.vmap(...,
axis_name="data")`` over A stacked ranks in this process (its
``psum``/``all_gather`` over the vmapped axis); the port's runs on gloo
groups of A = 1, 2 and 4 ranks in one spawned group of four
(``test_torch_ranks.suite_exchange``), then ``build_compressed_allreduce``
over a small tree on a (4,) mesh. Each case runs 3 steps carrying the
residual: dense leaves (n <= 4k, the boundary n = 4k too), large leaves
at ``k_frac`` 0.01 and 0.25 (n = 4k + 1), and leaves whose magnitudes
tie, where the lowest flat index wins.

Tolerance: the new residuals are exact (the same k indices zeroed, the
rest g + residual), and so are the compressed leaves' sums on the CPU:
the gathered pairs' ``index_add_`` adds in rank order there, as the
reference's ``.at[].add``. A dense leaf's all-reduce sums its A terms in
gloo's ring order, not the reference's, so it is held within A ulps of
the largest term's magnitude at that leaf: |got - want| <= A * 2^-23 *
max|g|. (On the card ``index_add_`` adds with atomics, in any order:
the same A-ulp bound holds there.)
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401,E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import dp_exchange as jde  # noqa: E402
from repro_torch.train import dp_exchange as tde  # noqa: E402
from test_torch_ranks import run_ranks  # noqa: E402

WORLD, STEPS = 4, 3
EPS32 = float(np.finfo(np.float32).eps)

# name -> (shape, k, kind of values, residual at the start)
CASES = {
    "dense": ((6, 5), 8, "normal", "zero"),
    "boundary": ((8, 5), 10, "normal", "zero"),
    "large": ((40, 25), 10, "normal", "normal"),
    "quarter": ((7, 143), 250, "normal", "zero"),
    "ties": ((64, 32), 20, "ties", "zero"),
    "ties_small_k": ((3, 7, 11), 1, "ties", "normal"),
}
TREE = {"a": (64, 32), "c": (10,), "d": (3, 5, 7), "e": (4,)}
K_FRAC = 0.05


def _values(rng, kind, shape):
    if kind == "ties":
        return (rng.integers(-2, 3, shape) * 0.5).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(5)
    inp = {"k_frac": np.float32(K_FRAC), "tree_steps": np.int32(STEPS)}
    for name, (shape, k, kind, r0) in CASES.items():
        inp[f"{name}/g"] = _values(rng, kind, (STEPS, WORLD, *shape))
        inp[f"{name}/k"] = np.int32(k)
        inp[f"{name}/r0"] = (np.zeros((WORLD, *shape), np.float32)
                             if r0 == "zero" else
                             0.1 * _values(rng, "normal", (WORLD, *shape)))
    for name, shape in TREE.items():
        inp[f"tree.{name}/g"] = _values(rng, "normal", (STEPS, WORLD, *shape))
        inp[f"tree.{name}/r0"] = np.zeros((WORLD, *shape), np.float32)
    return inp


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    inp = _inputs()
    return inp, run_ranks("exchange", WORLD, tmp_path_factory.mktemp("dp4"),
                          inp)


def _reference(G, R0, k, A):
    """Per rank, per step: (sum, residual) of the reference's leaf
    function vmapped over each group of A consecutive ranks."""
    fn = jax.jit(jax.vmap(lambda g, r: jde.compressed_psum_leaf(g, r, k,
                                                                "data"),
                          axis_name="data"))
    out = {}
    for lo in range(0, WORLD, A):
        ranks = slice(lo, lo + A)
        r = jnp.asarray(R0[ranks])
        for step in range(G.shape[0]):
            terms = np.asarray(G[step, ranks]) + np.asarray(r)
            s, r = fn(jnp.asarray(G[step, ranks]), r)
            for i, rank in enumerate(range(lo, lo + A)):
                out[rank, step] = (np.asarray(s[i]), np.asarray(r[i]),
                                   float(np.abs(terms).max()))
    return out


def _check(got_sum, got_res, want, A, dense, label):
    s, r, scale = want
    np.testing.assert_array_equal(got_res, r, err_msg=f"{label} residual")
    np.testing.assert_allclose(got_sum, s, rtol=0,
                               atol=A * EPS32 * scale if dense else 0,
                               err_msg=f"{label} sum")


@pytest.mark.parametrize("A", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_compressed_psum_leaf_matches_the_vmapped_reference(four_ranks, case,
                                                           A):
    inp, outs = four_ranks
    shape, k, _, _ = CASES[case]
    want = _reference(inp[f"{case}/g"], inp[f"{case}/r0"], k, A)
    n = int(np.prod(shape))
    for rank, out in enumerate(outs):
        for step in range(STEPS):
            got_s = out[f"{case}/{A}/{step}/sum"]
            got_r = out[f"{case}/{A}/{step}/residual"]
            _check(got_s, got_r, want[rank, step], A, n <= 4 * k,
                   f"{case} A={A} rank {rank} step {step}")
            if n > 4 * k:
                # exactly k entries zeroed, all of them among the summed
                assert int((got_r == 0).sum()) >= k
    if n <= 4 * k:
        # dense: the residual is carried as it came
        for rank, out in enumerate(outs):
            np.testing.assert_array_equal(out[f"{case}/{A}/0/residual"],
                                          inp[f"{case}/r0"][rank])


def test_build_compressed_allreduce_over_a_tree(four_ranks):
    inp, outs = four_ranks
    for name, shape in TREE.items():
        n = int(np.prod(shape))
        k = max(1, int(n * K_FRAC))
        want = _reference(inp[f"tree.{name}/g"], inp[f"tree.{name}/r0"], k,
                          WORLD)
        for rank, out in enumerate(outs):
            for step in range(STEPS):
                _check(out[f"tree/{step}/{name}/sum"],
                       out[f"tree/{step}/{name}/residual"],
                       want[rank, step], WORLD, n <= 4 * k,
                       f"tree {name} rank {rank} step {step}")


def test_top_indices_are_the_stable_sorts():
    """``compress._top_indices``' candidate path on the CPU (the k-th
    largest by partition, then the candidates sorted) against the whole
    stable sort, on ties, NaNs and k from 1 to n."""
    from repro_torch.optim.compress import _top_indices

    rng = np.random.default_rng(9)
    for trial in range(60):
        n = int(rng.integers(1, 200))
        a = torch.from_numpy((rng.integers(0, 5, n) * 0.25).astype(
            np.float32))
        if trial % 3 == 0:
            a[torch.from_numpy(rng.integers(0, n, 3))] = float("nan")
        for k in {1, n, int(rng.integers(1, n + 1))}:
            want = torch.sort(a, descending=True, stable=True).indices[:k]
            assert torch.equal(_top_indices(a, k), want), (trial, n, k)


def test_leaf_on_one_rank_is_the_top_k_scatter(tmp_path):
    """One rank in this process: the sum is the top-k scatter of g +
    residual and the two add back up to it, exactly."""
    from test_torch_ranks import one_rank_group

    rng = np.random.default_rng(3)
    g = torch.from_numpy(_values(rng, "ties", (50, 40)))
    r = torch.from_numpy(_values(rng, "normal", (50, 40)))
    with one_rank_group(tmp_path):
        s, new_r = tde.compressed_psum_leaf(g, r, 37)
    assert torch.equal(s + new_r, g + r)
    assert int((s != 0).sum()) <= 37
    want = jax.vmap(lambda a, b: jde.compressed_psum_leaf(a, b, 37, "data"),
                    axis_name="data")(jnp.asarray(g.numpy())[None],
                                      jnp.asarray(r.numpy())[None])
    np.testing.assert_array_equal(s.numpy(), np.asarray(want[0][0]))
    np.testing.assert_array_equal(new_r.numpy(), np.asarray(want[1][0]))
