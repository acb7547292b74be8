"""``repro_torch.serve.h2o`` and ``kv_cache`` against the reference.

Bit for bit: the SS± heavy-hitter cache's integer state (ids, counts,
errors) and its K/V payload on the same inputs: the reference's own
sequences (``tests/test_serve.py``'s ``test_hh_cache_spacesaving_invariants``
and ``test_hh_decay_halves_monitored_mass``) fed to both packages, a
long evicting sequence with per-step masses from the reference's
``_gqa_attend`` over the cache, decays on the reference's tick,
quantization halves (round half to even), ``hh_heavy_positions`` ties,
and ``_insert_token_row``. The cache layouts (shapes, dtypes, EMPTY ids)
are the reference's for every config at contexts 32, 64 and 128, with
``HH_ENGAGE_CTX`` as it is and at 32 (set in both packages; a module
attribute read at call time).

Then the SS± decode path itself (``tests/test_serve.py``'s
``test_hh_decode_runs_long_context``: gemma3 and zamba2, HH_ENGAGE_CTX =
32, context 128, 8 steps from an empty cache, ``decay_period`` 16,
teacher-forced on the reference's tokens): ids bit for bit; counts
within 8 (one quantum a step: the port's decode mass is summed in
another order and may round the other way at a half); logits within
rtol = atol = 0.05 (bf16) and, with f32 params, a bf16 ulp (2^-8) of the
largest logit: the cache is bf16 and the reference rounds P to bf16
before P·V where the port keeps it in f32. Last, ``serve_step``s with
f32 params from the reference's prefill cache (f32 K/V), within 1e-4 of
the largest logit.
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
from repro.serve import build_prefill_step as jprefill
from repro.serve import build_serve_step as jstep
from repro.serve import h2o as JH
from repro.serve import kv_cache as jkv
from repro.serve.decode import _gqa_attend as jgqa
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_reference
from repro_torch.serve import build_prefill_step
from repro_torch.serve import build_serve_step as tstep
from repro_torch.serve import h2o as TH
from repro_torch.serve import kv_cache as tkv

from test_torch_transformer import reference_params


def _entry(B, C, KV, hd, ids=None, counts=None, errors=None):
    ids = np.full((B, C), -1, np.int32) if ids is None else ids
    counts = np.zeros((B, C), np.int32) if counts is None else counts
    errors = np.zeros((B, C), np.int32) if errors is None else errors
    kv = np.zeros((B, C, KV, hd), np.float32)
    j = dict(k=jnp.asarray(kv, jnp.bfloat16), v=jnp.asarray(kv, jnp.bfloat16),
             ids=jnp.asarray(ids), counts=jnp.asarray(counts),
             errors=jnp.asarray(errors))
    t = dict(k=torch.zeros(kv.shape, dtype=torch.bfloat16),
             v=torch.zeros(kv.shape, dtype=torch.bfloat16),
             ids=torch.from_numpy(ids.copy()),
             counts=torch.from_numpy(counts.copy()),
             errors=torch.from_numpy(errors.copy()))
    return j, t


def _same(jentry, tentry):
    for name in ("ids", "counts", "errors"):
        np.testing.assert_array_equal(tentry[name].numpy(),
                                      np.asarray(jentry[name]), err_msg=name)
    for name in ("k", "v"):
        np.testing.assert_array_equal(
            tentry[name].view(torch.int16).numpy(),
            np.asarray(jentry[name]).view(np.int16), err_msg=name)


_jinsert = jax.jit(JH.hh_insert)
_jadd = jax.jit(JH.hh_add_mass)
_jdecay = jax.jit(JH.hh_decay)


def test_the_reference_invariants_sequence():
    """test_serve.py:38's churn: a heavy position receives most of the
    mass every step; both packages evict the same slots."""
    B, C, KV, hd = 2, 8, 2, 4
    j, t = _entry(B, C, KV, hd)
    rng = np.random.default_rng(0)
    heavy = 3
    for pos in range(40):
        kn = rng.standard_normal((B, KV, hd)).astype(np.float32)
        jk = jnp.asarray(kn, jnp.bfloat16)
        tk = torch.from_numpy(kn).bfloat16()
        p = np.full((B,), pos, np.int32)
        j, jsel = _jinsert(j, jnp.asarray(p), jk, jk)
        t, tsel = TH.hh_insert(t, torch.from_numpy(p), tk, tk)
        np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
        mass = (np.where(np.asarray(j["ids"]) == heavy, 0.9, 0.1 / C)
                * (pos >= heavy)).astype(np.float32)
        j = _jadd(j, jnp.asarray(mass))
        t = TH.hh_add_mass(t, torch.from_numpy(mass))
        _same(j, t)
    assert (t["ids"].numpy() == heavy).any(axis=1).all()


def test_the_reference_decay_sequence():
    """test_serve.py:75: halving counts and errors, EMPTY slots to 0."""
    j, t = _entry(1, 4, 1, 2, ids=np.array([[0, 1, 2, -1]], np.int32),
                  counts=np.array([[100, 50, 7, 9]], np.int32),
                  errors=np.array([[10, 4, 1, 9]], np.int32))
    _same(_jdecay(j), TH.hh_decay(t))
    np.testing.assert_array_equal(TH.hh_decay(t)["counts"].numpy(),
                                  [[50, 25, 3, 0]])


def test_an_evicting_sequence_with_decode_masses():
    """200 steps on a 24-slot cache: each step inserts, attends (masses
    from the reference's ``_gqa_attend`` over the cache, fed to both),
    adds the mass and decays every 16th step on row 0's position, as the
    decode step does. Every step bit for bit."""
    B, C, KV, G, hd, H = 3, 24, 2, 2, 8, 4
    j, t = _entry(B, C, KV, hd)
    rng = np.random.default_rng(1)
    attend = jax.jit(jgqa)
    for pos in range(200):
        kn, vn = (rng.standard_normal((B, KV, hd)).astype(np.float32)
                  for _ in range(2))
        q = rng.standard_normal((B, KV, G, hd)).astype(np.float32) * 2
        p = np.full((B,), pos, np.int32)
        j, _ = _jinsert(j, jnp.asarray(p), jnp.asarray(kn, jnp.bfloat16),
                        jnp.asarray(vn, jnp.bfloat16))
        t, _ = TH.hh_insert(t, torch.from_numpy(p),
                            torch.from_numpy(kn).bfloat16(),
                            torch.from_numpy(vn).bfloat16())
        _, mass = attend(jnp.asarray(q, jnp.bfloat16), j["k"], j["v"],
                         j["ids"] != -1)
        mass = np.asarray(mass) / H
        j = _jadd(j, jnp.asarray(mass))
        t = TH.hh_add_mass(t, torch.from_numpy(mass))
        if pos % 16 == 15:
            j, t = _jdecay(j), TH.hh_decay(t)
        _same(j, t)
    assert int(t["counts"].max()) > 0 and bool((t["ids"] >= 176).any())
    jh, jv = jax.jit(JH.hh_heavy_positions, static_argnums=1)(j, 5)
    th, tv = TH.hh_heavy_positions(t, 5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_mass_rounds_half_to_even():
    m = (np.array([0.5, 1.5, 2.5, -0.5, 3.49, 1023.5], np.float32)
         / JH.MASS_SCALE)
    np.testing.assert_array_equal(
        TH.quantize_mass(torch.from_numpy(m)).numpy(),
        np.asarray(JH.quantize_mass(jnp.asarray(m))))


def test_heavy_positions_ties_and_empty_slots():
    ids = np.array([[5, -1, 7, 9, 11], [-1, -1, 3, 4, 6]], np.int32)
    counts = np.array([[4, 99, 4, 4, 2], [7, 7, 1, 1, 1]], np.int32)
    j, t = _entry(2, 5, 1, 2, ids=ids, counts=counts)
    jh, jv = JH.hh_heavy_positions(j, 4)
    th, tv = TH.hh_heavy_positions(t, 4)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_insert_token_row():
    C, KV, hd = 6, 1, 2
    ids = np.array([3, 4, 5, 6, 7, 8], np.int32)
    counts = np.array([9, 2, 5, 2, 8, 7], np.int32)
    j, t = _entry(1, C, KV, hd, ids=ids[None], counts=counts[None])
    kn = np.ones((KV, hd), np.float32)
    want = JH._insert_token_row(j["ids"][0], j["counts"][0], j["errors"][0],
                                j["k"][0], j["v"][0], jnp.int32(40),
                                jnp.asarray(kn, jnp.bfloat16),
                                jnp.asarray(kn, jnp.bfloat16))
    got = TH._insert_token_row(t["ids"][0], t["counts"][0], t["errors"][0],
                               t["k"][0], t["v"][0], 40,
                               torch.from_numpy(kn).bfloat16(),
                               torch.from_numpy(kn).bfloat16())
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert int(got[-1]) == 1            # the first minimum count


def _layout(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _layout(t, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("engage", [65536, 32])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_cache_layouts(arch, engage, monkeypatch):
    monkeypatch.setattr(jkv, "HH_ENGAGE_CTX", engage)
    monkeypatch.setattr(tkv, "HH_ENGAGE_CTX", engage)
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for ctx in (32, 64, 128):
        want = _layout(jax.tree.map(np.asarray, jkv.build_cache(jcfg, 2, ctx)))
        got = _layout(tkv.build_cache(tcfg, 2, ctx, device="cpu"))
        assert set(got) == set(want)
        for path, w in want.items():
            g = got[path]
            assert (tuple(g.shape), str(g.dtype).removeprefix("torch.")) == \
                (w.shape, str(w.dtype)), path
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32), err_msg=path)
        spec, axes = tkv.cache_spec(tcfg, 2, ctx)
        jspec, jaxes = jkv.cache_spec(jcfg, 2, ctx)
        assert _layout(axes) == _layout(jaxes)
        assert {p: (s, str(d).removeprefix("torch."))
                for p, (s, d) in _layout(spec, "").items()} == \
            {p: (v.shape, str(v.dtype)) for p, v in want.items()}
        for kind in ("full", "swa", "local", "global", "mamba_attn"):
            assert tkv.cache_len_for(tcfg, kind, ctx) == \
                jkv.cache_len_for(jcfg, kind, ctx)




@pytest.mark.parametrize("arch", ["gemma3_27b", "zamba2_7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hh_decode_long_context(arch, dtype, monkeypatch):
    """The reference's test_hh_decode_runs_long_context on both packages,
    teacher-forced on the reference's greedy tokens."""
    monkeypatch.setattr(jkv, "HH_ENGAGE_CTX", 32)
    monkeypatch.setattr(tkv, "HH_ENGAGE_CTX", 32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), unroll_scan=True)
    tcfg = tconfigs.get_smoke(arch)
    jp, tp = reference_params(jcfg, tcfg, jdt, seed=7)
    ctx, steps = 128, 8
    js = jax.jit(jstep(jcfg, ctx, decay_period=16))
    ts = tstep(tcfg, ctx, decay_period=16, device="cpu")
    jc = jkv.build_cache(jcfg, 1, ctx)
    tc = tkv.build_cache(tcfg, 1, ctx, device="cpu")
    tok = np.zeros((1, 1), np.int32)
    for _ in range(steps):
        jl, jc, _ = js(jp, jc, jnp.asarray(tok))
        tl, tc, _ = ts(tp, tc, torch.from_numpy(tok))
        want, got = np.asarray(jl, np.float32), tl.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
        else:
            # f32 params over the bf16 cache: the reference's P goes to
            # bf16 before P·V (decode.py:53), the port's stays f32
            assert np.abs(got - want).max() <= 2**-8 * np.abs(want).max()
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for path, w in _layout(jax.tree.map(np.asarray, jc)).items():
        g = _layout(tc)[path]
        if path.endswith("/ids"):
            np.testing.assert_array_equal(g.numpy(), w)
            assert ((w >= 0).sum(-1) == steps).all()
        elif path.endswith(("/counts", "/errors")):
            assert np.abs(g.numpy().astype(np.int64) - w).max() <= steps
    assert bool(torch.isfinite(tl.float()).all())


# -- decode steps with f32 params -----------------------------------------

CTX, S = 64, 16


def _prompt(cfg, seed):
    """(B = 2 prompt tokens, the reference's stub inputs, the port's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, S - cfg.vision_tokens)
                        ).astype(np.int32)
    j, t = {}, {}
    if cfg.family == "encdec":
        a = rng.standard_normal((2, cfg.encoder_frames, cfg.d_model)
                                ).astype(np.float32)
        j["frames"], t["frames"] = jnp.asarray(a), torch.from_numpy(a)
    return toks, j, t


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", ["gemma3_27b", "zamba2_7b", "whisper_medium",
                                  "olmoe_1b_7b", "mamba2_780m"])
def test_serve_steps_f32(arch):
    """The prefill, then 3 ``serve_step``s of both packages from the
    reference's prefill cache (f32 K/V, carried over bit for bit by
    ``convert.cache_from_reference``; the port's own prefill cache is held
    to it leaf by leaf in test_torch_transformer.py), within 1e-4 of the
    largest logit, on one config of each layer family (local/global,
    hybrid, encoder-decoder, MoE, SSM)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), unroll_scan=True)
    tcfg = tconfigs.get_smoke(arch)
    jp, tp = reference_params(jcfg, tcfg, jnp.float32, seed=3)
    toks, jkw, tkw = _prompt(jcfg, seed=4)
    jkw = {k: v.astype(jnp.float32) for k, v in jkw.items()}
    tkw = {k: v.float() for k, v in tkw.items()}
    jl, jc = jax.jit(jprefill(jcfg, CTX))(jp, {"tokens": jnp.asarray(toks),
                                              **jkw})
    tl, tc = build_prefill_step(tcfg, CTX, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks), **tkw})
    js = jax.jit(jstep(jcfg, CTX))
    ts = tstep(tcfg, CTX, device="cpu")
    tc = cache_from_reference(jax.tree.map(np.asarray, jc), device="cpu")
    assert int(tc["pos"][0]) == S
    for t in range(4):
        want, got = _f32(jl), _f32(tl)
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), \
            f"{arch} step {t}"
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        if t < 3:
            jl, jc, _ = js(jp, jc, jnp.asarray(tok))
            tl, tc, _ = ts(tp, tc, torch.from_numpy(tok))
