"""The port's optimizer (``repro_torch/optim``) against the reference's
(``repro/optim``).

``adamw_update`` is fed the same numpy gradients over 5 steps from the
same params, with and without clipping, with weight decay skipping 1-D
leaves (``decay_min_ndim``) and with ``lr`` a float and each schedule;
params, master weights, moments, step and metrics are held at rtol =
atol = 1e-6 (f32; the global norm sums its leaves in another order and
``pow``/``cos`` may round differently in the last place, so not bit for
bit). Schedules are held on a grid of steps at the same tolerance.
``topk_compress`` (ties among equal magnitudes to the lowest index, as
``jax.lax.top_k``), ``topk_decompress`` and ``error_feedback_update``
are equal on inputs full of ties. The reference's own
``tests/test_optim.py`` cases run on the port at the end.
"""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro import optim as J
from repro.optim.adamw import AdamWConfig as JConfig
from repro_torch import optim as T
from repro_torch.optim import AdamWConfig as TConfig

TOL = 1e-6
SHAPES = {"w": (8, 8), "scale": (8,), "nested": {"b": (3, 4, 5),
                                                 "bias": (5,)}}


def _draw(rng, scale=1.0):
    def leaf(shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"w": leaf(SHAPES["w"]), "scale": leaf(SHAPES["scale"]),
            "nested": {k: leaf(s) for k, s in SHAPES["nested"].items()}}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k],
                                                     f"{prefix}/{k}").items()}
    return {prefix: tree}


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(got, want, what=""):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w), what
    for k in w:
        if isinstance(g[k], torch.Tensor):
            assert str(g[k].dtype).removeprefix("torch.") == str(
                np.asarray(w[k]).dtype), f"{what}{k}"
        np.testing.assert_allclose(_f32(g[k]), _f32(w[k]), rtol=TOL,
                                   atol=TOL, err_msg=f"{what}{k}")


def _schedules():
    return {
        "float": (3e-3, 3e-3),
        "constant": (J.constant_schedule(2e-3), T.constant_schedule(2e-3)),
        "linear": (J.linear_schedule(1e-2, 2, 6, floor=1e-4),
                   T.linear_schedule(1e-2, 2, 6, floor=1e-4)),
        "cosine": (J.cosine_schedule(1e-2, 2, 6),
                   T.cosine_schedule(1e-2, 2, 6)),
    }


@pytest.mark.parametrize("lr", ["float", "constant", "linear", "cosine"])
@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
@pytest.mark.parametrize("decay_min_ndim", [2, 1])
def test_adamw_update_five_steps(lr, clip, decay_min_ndim):
    jlr, tlr = _schedules()[lr]
    kw = dict(clip_norm=clip, decay_min_ndim=decay_min_ndim,
              weight_decay=0.1)
    jcfg, tcfg = JConfig(lr=jlr, **kw), TConfig(lr=tlr, **kw)
    rng = np.random.default_rng(0)
    p0 = _draw(rng)
    jp, tp = _jax(p0), _torch(p0)
    js, ts = J.adamw_init(jp), T.adamw_init(tp)
    upd = jax.jit(lambda g, s, p: J.adamw_update(g, s, p, jcfg))
    for step in range(5):
        g = _draw(rng, scale=0.5 * (step + 1))
        jp, js, jm = upd(_jax(g), js, jp)
        tp, ts, tm = T.adamw_update(_torch(g), ts, tp, tcfg)
        what = f"step {step + 1} "
        _close(tp, jp, what + "params")
        _close(ts.master, js.master, what + "master")
        _close(ts.m, js.m, what + "m")
        _close(ts.v, js.v, what + "v")
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32 and ts.step.dim() == 0
        for k in ("grad_norm", "lr"):
            assert tm[k].dtype == torch.float32 and tm[k].dim() == 0
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_adamw_over_bf16_params_keeps_their_dtype():
    rng = np.random.default_rng(1)
    p0 = _draw(rng)
    jp, tp = _jax(p0, jnp.bfloat16), _torch(p0, torch.bfloat16)
    js, ts = J.adamw_init(jp), T.adamw_init(tp)
    _close(ts.master, js.master, "init master ")
    cfg = dict(lr=1e-2)
    for _ in range(3):
        g = _draw(rng)
        jp, js, _ = jax.jit(lambda g, s, p: J.adamw_update(
            g, s, p, JConfig(**cfg)))(_jax(g, jnp.bfloat16), js, jp)
        tp, ts, _ = T.adamw_update(_torch(g, torch.bfloat16), ts, tp,
                                   TConfig(**cfg))
    _close(ts.master, js.master, "master ")
    # each bf16 param is its master weight rounded, in both packages
    for k, v in _flat(tp).items():
        assert v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _f32(v), _f32(_flat(ts.master)[k].to(torch.bfloat16)))


@pytest.mark.parametrize("name", ["constant", "linear", "cosine"])
def test_schedules_on_a_grid(name):
    jf, tf = _schedules()[name]
    for step in range(0, 12):
        want = jf(jnp.asarray(step, jnp.int32))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=TOL,
                                   atol=TOL, err_msg=f"{name} step {step}")


def test_global_norm_and_clip():
    g = _draw(np.random.default_rng(4), scale=3.0)
    want = J.global_norm(_jax(g))
    np.testing.assert_allclose(float(T.global_norm(_torch(g))), float(want),
                               rtol=TOL)
    jc, jn = J.clip_by_global_norm(_jax(g), 1.0)
    tc, tn = T.clip_by_global_norm(_torch(g), 1.0)
    _close(tc, jc, "clipped ")
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)


def _ties(n, seed):
    """Values from a handful of magnitudes of both signs: ties galore."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, size=n) * 0.5).astype(np.float32)


@pytest.mark.parametrize("shape,k", [((64,), 8), ((6, 7), 5), ((3, 4, 5), 60),
                                     ((40,), 1)])
def test_topk_compress_ties_as_the_reference(shape, k):
    x = _ties(int(np.prod(shape)), seed=k).reshape(shape)
    want = J.topk_compress(jnp.asarray(x), k)
    got = T.topk_compress(torch.from_numpy(x), k)
    assert got.shape == want.shape == shape
    assert got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(T.topk_decompress(got).numpy(),
                                  np.asarray(J.topk_decompress(want)))


def test_error_feedback_update_as_the_reference():
    rng = np.random.default_rng(5)
    g = _ties(96, 5).reshape(8, 12)
    r = (0.25 * rng.integers(-2, 3, size=(8, 12))).astype(np.float32)
    jr, tr = jnp.asarray(r), torch.from_numpy(r)
    for step in range(3):
        jc, jr = J.error_feedback_update(jnp.asarray(g), jr, k=10)
        tc, tr = T.error_feedback_update(torch.from_numpy(g), tr, k=10)
        np.testing.assert_array_equal(tc.indices.numpy(),
                                      np.asarray(jc.indices), f"{step}")
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


# --- the reference's own cases (tests/test_optim.py) on the port ----------

def test_adamw_converges_least_squares():
    W = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8), dtype=torch.bfloat16)}
    state = T.adamw_init(params)
    cfg = TConfig(lr=1e-2, weight_decay=0.0)

    def loss(p):
        return torch.mean((p["w"].float() - W) ** 2)

    l0 = float(loss(params))
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        val = loss({"w": w})
        (g,) = torch.autograd.grad(val, [w])
        params, state, _ = T.adamw_update({"w": g}, state, params, cfg)
    assert float(val.detach()) < 0.02 * l0


def test_weight_decay_skips_1d():
    params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,))}
    state = T.adamw_init(params)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    cfg = TConfig(lr=1e-1, weight_decay=0.5, clip_norm=None)
    p2, _, _ = T.adamw_update(zero_g, state, params, cfg)
    assert float((p2["scale"] - 1.0).abs().max()) == 0.0   # no decay on 1-D
    assert float(p2["w"].max()) < 1.0                       # decayed


def test_clip_by_global_norm():
    clipped, norm = T.clip_by_global_norm({"a": torch.ones((10,)) * 3.0},
                                          1.0)
    np.testing.assert_allclose(float(T.global_norm(clipped)), 1.0, rtol=1e-5)
    np.testing.assert_allclose(float(norm), np.sqrt(90.0), rtol=1e-5)


def test_schedules():
    cos = T.cosine_schedule(1.0, warmup=10, total=100)
    lin = T.linear_schedule(1.0, warmup=10, total=100)
    assert float(cos(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(cos(torch.tensor(10))), 1.0, rtol=1e-6)
    assert float(cos(torch.tensor(100))) <= 0.1 + 1e-6
    np.testing.assert_allclose(float(lin(torch.tensor(5))), 0.5, rtol=1e-6)
    assert float(lin(torch.tensor(100))) < 1e-6


@settings(max_examples=25, deadline=None)
@given(n=st.integers(8, 200), k=st.integers(1, 8),
       seed=st.integers(0, 2**31 - 1))
def test_topk_roundtrip_properties(n, k, seed):
    gn = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    comp = T.topk_compress(torch.from_numpy(gn), min(k, n))
    d = T.topk_decompress(comp).numpy()
    kept = comp.indices.numpy()
    np.testing.assert_allclose(d[kept], gn[kept], rtol=1e-6)
    mask = np.ones(n, bool)
    mask[kept] = False
    assert (d[mask] == 0).all()
    if mask.any():
        assert np.abs(gn[kept]).min() >= np.abs(gn[mask]).max() - 1e-6


def test_error_feedback_conserves_mass():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        64).astype(np.float32))
    comp, r2 = T.error_feedback_update(g, torch.zeros(64), k=8)
    total = T.topk_decompress(comp) + r2
    np.testing.assert_allclose(total.numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6)
