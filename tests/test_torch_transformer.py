"""``repro_torch.models.transformer`` and ``model`` against the reference.

Params are numpy draws in the reference's tree (its init's paths, shapes
and dtypes, traced with ``jax.eval_shape``: running its init costs
seconds of compile a config), handed to the reference as they are and to
the port through ``convert.params_from_reference``, bit for bit (the
round trip of the reference's own init is checked, bf16 through its
16-bit pattern). With f32 params the
residual stream turns f32 after the first layer (an f32 matmul of the
bf16 embedding), which the reference's ``lax.scan`` refuses as a carry
of another dtype; it runs them with ``unroll_scan`` (its Python loop),
and the port's loop always holds the dtype. Held at rtol = atol = 1e-4:
``forward`` for all 10 smoke configs (logits, their dtype, expert
counts bit for bit), ``prefill_forward`` with its whole decode cache
(integer leaves bit for bit, the bf16 conv history within a flipped
rounding) and ``loss_fn``. ``_ring_from_prefill`` and
``_collect_attn_entry`` are bit for bit on the same K/V. The param and
axes trees of ``init_params`` have the reference's paths, shapes and
axis names.
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
from repro.models import build_model as jbuild
from repro.models import transformer as JT
import repro.serve.kv_cache as jkv
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer as TT
import repro_torch.serve.kv_cache as tkv

TOL = 1e-4
B, S = 2, 32


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), unroll_scan=True,
                                **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def reference_params(jcfg, tcfg, dtype=jnp.float32, seed=0):
    """(reference params, port params): standard normal draws x 0.02 in the
    reference's tree, norm scales and skips 1 + 0.1 x normal, A_log the
    reference's log(linspace(1, 16)); leaves in the init's dtypes."""
    shapes = jax.eval_shape(lambda k: jbuild(jcfg).init(k, dtype)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path.rsplit("/", 1)[-1]
        if name == "A_log":
            a = np.broadcast_to(np.log(np.linspace(1.0, 16.0, sd.shape[-1])),
                                sd.shape)
        elif name.startswith("ln") or name in ("norm", "final_norm",
                                               "q_norm", "k_norm", "skip"):
            a = 1 + 0.1 * rng.standard_normal(sd.shape)
        else:
            a = 0.02 * rng.standard_normal(sd.shape)
        return np.asarray(jnp.asarray(a, jnp.float32).astype(sd.dtype))

    flat = {p: leaf(p, sd) for p, sd in _flat(shapes).items()}

    def tree(t, prefix=""):
        if isinstance(t, dict):
            return {k: tree(v, f"{prefix}/{k}") for k, v in t.items()}
        return flat[prefix]

    np_params = tree(shapes)
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_reference(np_params, tcfg, device="cpu"))


_params = reference_params


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S - cfg.vision_tokens)
                        ).astype(np.int32)
    j, t = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    for name, n in (("vision", cfg.vision_tokens),
                    ("frames", cfg.encoder_frames
                     if cfg.family == "encdec" else 0)):
        if n:
            a = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
            j[name] = jnp.asarray(a).astype(jnp.bfloat16)
            t[name] = torch.from_numpy(a).bfloat16()
    return j, t


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_forward_f32(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _inputs(jcfg)
    want, wc = jax.jit(lambda p, b: JT.forward(
        p, jcfg, b["tokens"], vision=b.get("vision"),
        frames=b.get("frames"), remat=False))(jp, jb)
    got, gc = TT.forward(tp, tcfg, tb["tokens"], vision=tb.get("vision"),
                         frames=tb.get("frames"))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("arch,engage", [
    ("gemma3_27b", None), ("gemma3_27b", 32), ("zamba2_7b", 32),
    ("whisper_medium", None), ("llava_next_mistral_7b", None),
    ("olmoe_1b_7b", None), ("mamba2_780m", None)])
def test_prefill_forward_and_its_cache(arch, engage, monkeypatch):
    """The prefill's last logits and the whole decode cache, dense and
    (``HH_ENGAGE_CTX`` = 32 in both packages) with the SS± entries'
    cold start, at context 64."""
    if engage:
        monkeypatch.setattr(jkv, "HH_ENGAGE_CTX", engage)
        monkeypatch.setattr(tkv, "HH_ENGAGE_CTX", engage)
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _inputs(jcfg)
    wl, wcache = jax.jit(lambda p, b: JT.prefill_forward(
        p, jcfg, b["tokens"], 64, vision=b.get("vision"),
        frames=b.get("frames")))(jp, jb)
    gl, gcache = TT.prefill_forward(tp, tcfg, tb["tokens"], 64,
                                    vision=tb.get("vision"),
                                    frames=tb.get("frames"))
    np.testing.assert_allclose(_f32(gl), _f32(wl), rtol=TOL, atol=TOL)
    want, got = _flat(jax.tree.map(np.asarray, wcache)), _flat(gcache)
    assert set(got) == set(want)
    if engage and jcfg.hh_kv_budget:
        assert any(p.endswith("/ids") for p in got)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        if w.dtype in (np.int32, np.int64):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            tol = 2e-2 if path.endswith("/conv") else TOL
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=tol, atol=tol,
                                       err_msg=path)


def test_loss_fn_value():
    jcfg, tcfg = _cfgs("olmoe_1b_7b")
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _inputs(jcfg)
    labels = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    mask = (np.arange(S) < 20).astype(np.float32)[None].repeat(B, 0)
    jb.update(labels=jnp.asarray(labels, jnp.int32), mask=jnp.asarray(mask))
    tb.update(labels=torch.from_numpy(labels.astype(np.int32)),
              mask=torch.from_numpy(mask))
    (wl, waux) = jax.jit(lambda p, b: JT.loss_fn(p, jcfg, b))(jp, jb)
    gl, gaux = TT.loss_fn(tp, tcfg, tb)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-5)
    np.testing.assert_array_equal(gaux["expert_counts"].numpy(),
                                  np.asarray(waux["expert_counts"]))


@pytest.mark.parametrize("S_,C", [(12, 8), (8, 12), (16, 16)])
def test_ring_and_collect_are_bit_exact(S_, C, monkeypatch):
    monkeypatch.setattr(jkv, "HH_ENGAGE_CTX", 4)
    monkeypatch.setattr(tkv, "HH_ENGAGE_CTX", 4)
    rng = np.random.default_rng(3)
    k, v = (rng.standard_normal((2, S_, 2, 4)).astype(np.float32)
            for _ in range(2))
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    tk, tv = (torch.from_numpy(a).bfloat16() for a in (k, v))
    for want, got in zip(JT._ring_from_prefill(jk, jv, C),
                         TT._ring_from_prefill(tk, tv, C)):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    jcfg, tcfg = (dataclasses.replace(c, hh_kv_budget=C) for c in
                  (jconfigs.get_smoke("gemma3_27b"),
                   tconfigs.get_smoke("gemma3_27b")))
    for kind in ("global", "local"):
        want = JT._collect_attn_entry(jk, jv, kind, jcfg, 64)
        got = TT._collect_attn_entry(tk, tv, kind, tcfg, 64)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(_f32(got[name]), _f32(want[name]))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_params_trees_match_the_reference(arch):
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    axes = {}

    def init(key):
        p, axes["a"] = jbuild(jcfg).init(key)
        return p

    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    tp, ta = tbuild(tcfg).init(0, device="cpu")
    assert ta == axes["a"]
    assert {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for p, v in _flat(tp).items()} == \
        {p: (v.shape, str(v.dtype)) for p, v in _flat(shapes).items()}
    for p, v in _flat(tp).items():
        assert len(_flat(ta)[p].split(",")) == v.dim()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_reference_round_trips(dtype):
    """The reference's own init (``jax.random``) carried over bit for bit."""
    jcfg, tcfg = _cfgs("qwen3_0_6b")
    jp = jax.jit(lambda k: jbuild(jcfg).init(k, dtype)[0])(
        jax.random.PRNGKey(5))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    for path, w in _flat(jax.tree.map(np.asarray, jp)).items():
        g = _flat(tp)[path]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    wrong = jax.tree.map(np.asarray, jp)
    wrong["final_norm"] = wrong["final_norm"][:-1]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(wrong, tcfg, device="cpu")


def test_batch_spec():
    for arch in ("llava_next_mistral_7b", "whisper_medium", "qwen2_7b"):
        jm, tm = jbuild(jconfigs.get_smoke(arch)), tbuild(
            tconfigs.get_smoke(arch))
        want, got = jm.batch_spec(2, 40), tm.batch_spec(2, 40)
        assert {k: (v[0], str(v[1]).removeprefix("torch."))
                for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in want.items()}
