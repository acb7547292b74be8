"""``repro_torch.models.layers`` against ``repro.models.layers``.

The same inputs, made from numpy seeds, go through both packages with f32
params, at tolerances for f32: rtol = atol = 1e-5 for the norms, RoPE
and the MLPs; 2e-5 for attention (the port's plain flash version takes
the softmax over f32 scores with -1e30 at masked pairs, the reference
its own chain; both f32). On CPU tensors the port attends through the
kernels' plain versions, and ``attention="kernel"`` and ``"plain"`` are
the same computation there. Where the reference refuses a shape, the
port refuses it too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.models import layers as TL

TOL = 1e-5
ATTN_TOL = 2e-5


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                               np.float32), rtol=tol, atol=tol)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _attn_params(cfg, seed, bias=False, qk_norm=False):
    D, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    wq, wk, wv, wo = _normal(seed, (D, H, hd), (D, KV, hd), (D, KV, hd),
                             (H * hd, D), scale=0.1)
    p = dict(wq=wq, wk=wk, wv=wv, wo=wo)
    if bias:
        p.update(zip(("bq", "bk", "bv"), _normal(
            seed + 1, (H, hd), (KV, hd), (KV, hd), scale=0.1)))
    if qk_norm:
        p["q_norm"], p["k_norm"] = [1 + 0.1 * a for a in _normal(
            seed + 2, (hd,), (hd,))]
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def test_rms_norm():
    x, s = _normal(0, (2, 5, 48), (48,))
    _close(TL.rms_norm(_t(x), _t(s), 1e-6),
           jax.jit(JL.rms_norm)(jnp.asarray(x), jnp.asarray(s)), TOL)
    # a bf16 input keeps its dtype through the f32 arithmetic
    xb = _t(x).bfloat16()
    got = TL.rms_norm(xb, _t(s))
    want = jax.jit(JL.rms_norm)(jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(s))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, 1e-2)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_half_split(theta):
    x, = _normal(1, (2, 7, 3, 16))
    pos = np.arange(7, dtype=np.int32) + 100
    jrope = jax.jit(JL.rope, static_argnums=2)
    _close(TL.rope(_t(x), _t(pos), theta),
           jrope(jnp.asarray(x), jnp.asarray(pos), theta), TOL)
    # the decode layout: one position per row
    pos1 = np.array([[5], [70000]], np.int32)
    _close(TL.rope(_t(x[:, :1]), _t(pos1), theta),
           jrope(jnp.asarray(x[:, :1]), jnp.asarray(pos1), theta), 1e-4)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("gelu", True), ("relu2", False)])
def test_mlp(act, gated):
    jcfg, tcfg = _cfgs("qwen2_7b", act=act, mlp_gated=gated)
    x, wi0, wi1, wo = _normal(2, (2, 5, 64), (64, 128), (64, 128), (128, 64),
                              scale=0.3)
    p = dict(wi0=wi0, wo=wo, **({"wi1": wi1} if gated else {}))
    _close(TL.mlp(_t(x), {k: _t(v) for k, v in p.items()}, tcfg),
           jax.jit(lambda x, p: JL.mlp(x, p, jcfg))(
               jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}),
           TOL)


def test_gelu_is_the_tanh_form():
    x, = _normal(3, (1000,), scale=3.0)
    _close(TL._act(_t(x), "gelu"),
           jax.jit(lambda x: JL._act(x, "gelu"))(jnp.asarray(x)), 1e-6)
    erf = torch.nn.functional.gelu(_t(x))
    assert (erf - TL._act(_t(x), "gelu")).abs().max() > 1e-4


def test_ein_promotes_as_jax():
    a = torch.ones((2, 3), dtype=torch.bfloat16)
    b = torch.ones((3, 4), dtype=torch.float32)
    assert TL.ein("ij,jk->ik", a, b).dtype == torch.float32
    assert TL.ein("ij,jk->ik", a, b.bfloat16()).dtype == torch.bfloat16


# kind, arch, S: full (qwen2: biased QKV), global and local (gemma3:
# qk-norm; S = 32 > window 16 runs the reference's banded branch, S = 12
# its causal one), swa (mixtral), encoder (whisper, unmasked)
ATTN_CASES = [
    ("full", "qwen2_7b", 24),
    ("global", "gemma3_27b", 32),
    ("local", "gemma3_27b", 32),
    ("local", "gemma3_27b", 12),
    ("swa", "mixtral_8x7b", 48),
    ("encoder", "whisper_medium", 20),
]


@pytest.mark.parametrize("kind,arch,S", ATTN_CASES)
def test_attention(kind, arch, S):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _attn_params(jcfg, 10, bias=jcfg.qkv_bias,
                          qk_norm=jcfg.qk_norm)
    x, = _normal(4, (2, S, jcfg.d_model))
    pos = np.arange(S, dtype=np.int32)
    want, (wk, wv) = jax.jit(lambda x, p, pos: JL.attention(
        x, p, jcfg, kind, pos, return_kv=True))(jnp.asarray(x), jp,
                                                jnp.asarray(pos))
    got, (gk, gv) = TL.attention(_t(x), tp, tcfg, kind, _t(pos),
                                 return_kv=True)
    _close(got, want, ATTN_TOL)
    _close(gk, wk, TOL)
    _close(gv, wv, TOL)
    plain = TL.attention(_t(x), tp, tcfg, kind, _t(pos), attention="plain")
    assert torch.equal(plain, got)


def test_cross_attention_has_no_tile_rule():
    """Whisper's cross-attention over T frames that no tile divides."""
    jcfg, tcfg = _cfgs("whisper_medium")
    jp, tp = _attn_params(jcfg, 11)
    x, enc = _normal(5, (2, 7, 64), (2, 150, 64))
    pos = np.arange(7, dtype=np.int32)
    _close(TL.attention(_t(x), tp, tcfg, "full", _t(pos),
                        cross_states=_t(enc)),
           jax.jit(lambda x, p, pos, enc: JL.attention(
               x, p, jcfg, "full", pos, cross_states=enc))(
               jnp.asarray(x), jp, jnp.asarray(pos), jnp.asarray(enc)),
           ATTN_TOL)


def test_banded_local_refuses_as_the_reference():
    jcfg, tcfg = _cfgs("gemma3_27b")
    jp, tp = _attn_params(jcfg, 12, qk_norm=True)
    x, = _normal(6, (1, 24, 64))        # 24 > window 16, not a multiple
    pos = np.arange(24, dtype=np.int32)
    with pytest.raises(AssertionError):
        jax.jit(lambda x, p, pos: JL.attention(x, p, jcfg, "local", pos))(
            jnp.asarray(x), jp, jnp.asarray(pos))
    with pytest.raises(ValueError, match="multiple of window"):
        TL.attention(_t(x), tp, tcfg, "local", _t(pos))


def test_attention_decode():
    jcfg, tcfg = _cfgs("gemma3_27b")
    jp, tp = _attn_params(jcfg, 13, qk_norm=True)
    B, C, KV, hd = 2, 40, jcfg.num_kv_heads, jcfg.resolved_head_dim
    x, k, v = _normal(7, (B, 1, 64), (B, C, KV, hd), (B, C, KV, hd))
    valid = np.random.default_rng(8).random((B, C)) < 0.6
    pos = np.array([37, 12], np.int32)
    out, mass, (kn, vn) = jax.jit(lambda *a: JL.attention_decode(
        a[0], a[1], jcfg, *a[2:]))(
        jnp.asarray(x), jp, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(valid), jnp.asarray(pos))
    got, gmass, (gk, gv) = TL.attention_decode(
        _t(x), tp, tcfg, _t(k), _t(v), _t(valid), _t(pos))
    _close(got, out, ATTN_TOL)
    _close(gmass, mass, ATTN_TOL)
    _close(gk, kn, TOL)
    _close(gv, vn, TOL)


def test_attention_argument_is_checked():
    jcfg, tcfg = _cfgs("qwen2_7b")
    _, tp = _attn_params(jcfg, 14, bias=True)
    x = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError, match="attention must be one of"):
        TL.attention(x, tp, tcfg, "full", torch.arange(4), attention="fast")


def _reference_init(fn, cfg):
    """(param shapes and dtypes, axes) of a reference init helper, traced
    without running it."""
    axes = {}

    def params(key):
        p, axes["a"] = fn(key, cfg)
        return p

    shapes = jax.eval_shape(params, jax.random.PRNGKey(0))
    return shapes, axes["a"]


def test_init_helpers_match_the_reference_layout():
    jcfg, tcfg = _cfgs("qwen2_7b")
    jp, ja = _reference_init(JL.init_attention, jcfg)
    tp, ta = TL.init_attention(torch.Generator().manual_seed(0), tcfg,
                               device="cpu")
    assert ta == ja
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    jm, jma = _reference_init(JL.init_mlp, jcfg)
    tm, tma = TL.init_mlp(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    assert tma == jma and set(tm) == set(jm)
    # the scales of the reference's draws
    assert abs(float(tm["wi0"].float().std()) - 0.02) < 0.002
