"""``repro_torch.serve`` (prefill, decode, the engine) against
``repro.serve``, and the port's own serving checks.

bf16 params (the reference's default): all 10 smoke configs through
``ServeEngine.generate`` as ``tests/test_serve.py:120`` runs them (B = 2,
16-token prompts, context 64, 3 new tokens), and the prefill's and each
step's logits teacher-forced on the reference's greedy tokens within the
reference's own serving tolerance, rtol = atol = 0.05. f32 params, on
one config of each layer family (local/global with SS± layouts, hybrid,
encoder-decoder, MoE, SSM): the prefill, then 3 ``serve_step``s of both
packages from the reference's
prefill cache (f32 K/V, carried over by ``convert.cache_from_reference``)
within 1e-4 of the largest logit (the reference unrolls its scan, whose
carry turns f32). Port only: the prefill-vs-stepwise invariant of
``tests/test_serve.py:24``; ``attention="plain"`` and ``"kernel"`` give
the same result on CPU tensors; every entry point raises without a card
when called with its default device.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.serve import ServeEngine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models.transformer import init_params
from repro_torch.serve import (ServeEngine, build_cache, build_prefill_step,
                               build_serve_step)

from test_torch_transformer import reference_params

B, S, CTX, NEW = 2, 16, 64, 3


def _prompt(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S - cfg.vision_tokens)
                        ).astype(np.int32)
    j, t = {}, {}
    for name, n in (("vision", cfg.vision_tokens),
                    ("frames", cfg.encoder_frames
                     if cfg.family == "encdec" else 0)):
        if n:
            a = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
            j[name] = jnp.asarray(a).astype(jnp.bfloat16)
            t[name] = torch.from_numpy(a).bfloat16()
    return toks, j, t


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_engine_generate_teacher_forced(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, tp = reference_params(jcfg, tcfg, jnp.bfloat16, seed=2)
    toks, jkw, tkw = _prompt(jcfg)
    jeng = JEngine(cfg=jcfg, params=jp, context=CTX)
    ref = jeng.generate(jnp.asarray(toks), max_new_tokens=NEW, **jkw)
    teng = ServeEngine(cfg=tcfg, params=tp, context=CTX, device="cpu")
    out = teng.generate(torch.from_numpy(toks), max_new_tokens=NEW, **tkw)
    assert out["tokens"].shape == ref["tokens"].shape == (B, S - jcfg.
                                                          vision_tokens + NEW)
    assert out["steps"] == ref["steps"] == NEW
    np.testing.assert_array_equal(out["tokens"][:, :toks.shape[1]], toks)
    # teacher-forced on the reference's tokens, through both engines' steps
    gen = ref["tokens"][:, toks.shape[1]:]
    jl, jc = jeng._prefill(jp, {"tokens": jnp.asarray(toks), **jkw})
    tl, tc = teng._prefill(tp, {"tokens": torch.from_numpy(toks), **tkw})
    for t in range(NEW + 1):
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0.05, atol=0.05,
                                   err_msg=f"{arch} step {t}")
        if t < NEW:
            tok = gen[:, t:t + 1].astype(np.int32)
            jl, jc, jaux = jeng._step(jp, jc, jnp.asarray(tok))
            tl, tc, taux = teng._step(tp, tc, torch.from_numpy(tok))
            np.testing.assert_array_equal(
                taux["expert_counts"].numpy(),
                np.asarray(jaux["expert_counts"]))


def test_prefill_matches_stepwise_decode():
    """The reference's core serving invariant on the port: the prefill's
    cache and a token-by-token decode give the same next token, and the
    logits of the step after agree within rtol = atol = 0.05."""
    cfg = tconfigs.get_smoke("qwen3_0_6b")
    params, _ = build_model(cfg).init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    logits_a, cache_a = build_prefill_step(cfg, 64, device="cpu")(
        params, {"tokens": toks})
    step = build_serve_step(cfg, 64, device="cpu")
    nxt = torch.argmax(logits_a[:, -1], -1).to(torch.int32)[:, None]
    la, _, _ = step(params, cache_a, nxt)
    cache_b = build_cache(cfg, 2, 64, device="cpu")
    for t in range(16):
        logits_b, cache_b, _ = step(params, cache_b, toks[:, t:t + 1])
    nxt_b = torch.argmax(logits_b[:, -1], -1).to(torch.int32)[:, None]
    assert torch.equal(nxt, nxt_b)
    lb, _, _ = step(params, cache_b, nxt_b)
    np.testing.assert_allclose(_f32(la), _f32(lb), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("arch", ["gemma3_27b", "whisper_medium"])
def test_plain_and_kernel_agree_on_cpu_tensors(arch):
    cfg = tconfigs.get_smoke(arch)
    params, _ = build_model(cfg).init(1, device="cpu")
    toks, _, kw = _prompt(cfg, seed=5)
    outs = []
    for attention in ("kernel", "plain"):
        eng = ServeEngine(cfg, params, CTX, attention=attention,
                          device="cpu")
        outs.append(eng.generate(torch.from_numpy(toks), 3, keep_logits=True,
                                 **kw))
    np.testing.assert_array_equal(outs[0]["tokens"], outs[1]["tokens"])
    for a, b in zip(outs[0]["logits"], outs[1]["logits"]):
        assert torch.equal(a, b)
    logits = [build_model(cfg).forward(params, torch.from_numpy(toks),
                                       attention=a, **kw)[0]
              for a in ("kernel", "plain")]
    assert torch.equal(*logits)


def test_stop_token_ends_generation():
    """The step whose greedy token is the stop token is the last, as in
    the reference's loop."""
    cfg = tconfigs.get_smoke("qwen2_7b")
    params, _ = build_model(cfg).init(2, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    eng = ServeEngine(cfg, params, 32, device="cpu")
    second = int(eng.generate(toks, 2)["tokens"][0, -1])
    out = eng.generate(toks, 5, stop_token=second)
    assert out["steps"] == 1


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("qwen3_0_6b")
    params, _ = build_model(cfg).init(0, device="cpu")
    calls = [
        lambda: build_model(cfg).init(0),
        lambda: init_params(0, cfg),
        lambda: build_cache(cfg, 1, 32),
        lambda: build_prefill_step(cfg, 32),
        lambda: build_serve_step(cfg, 32),
        lambda: ServeEngine(cfg, params, 32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="attention must be one of"):
        build_serve_step(cfg, 32, attention="fast", device="cpu")
