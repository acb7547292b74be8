"""``repro_torch.models.ssm`` (Mamba2, chunked SSD) against
``repro.models.ssm``.

The same inputs and params (numpy seeds) through both packages with f32
params: ``mamba_layer`` with and without its decode state within rtol =
atol = 1e-4 (f32 chunked sums in another order; softplus's threshold in
torch differs from ``jax.nn.softplus`` beyond 2e-9 relative), the conv
history bf16 bit for bit (both round the same pre-conv f32 values), and
``mamba_decode_step`` from that state. The recurrence over chunks is a
Python loop in the port (the reference's ``lax.scan``).
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
from repro.models import ssm as JS
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as TS

TOL = 1e-4


def _params(cfg, seed):
    """f32 params of the reference's layout, scaled as its init."""
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    Din, nh, N, conv_dim = JS.dims(cfg)
    n = lambda *s, scale=0.1: (rng.standard_normal(s) * scale).astype(  # noqa: E731
        np.float32)
    return dict(in_proj=n(D, 2 * Din + 2 * N + nh), conv_w=n(4, conv_dim,
                                                             scale=0.2),
                conv_b=n(conv_dim), A_log=np.log(np.linspace(
                    1.0, 16.0, nh)).astype(np.float32),
                dt_bias=n(nh), skip=1 + n(nh), norm=1 + n(Din),
                out_proj=n(Din, D))


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,S", [("mamba2_780m", 64), ("mamba2_780m", 2),
                                    ("zamba2_7b", 96)])
def test_mamba_layer_and_its_state(arch, S):
    """S = 64 and 96: two and three chunks of 32; S = 2: one chunk of 2,
    the conv history padded on the left."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jp, tp = _both(_params(jcfg, 1))
    u = np.random.default_rng(2).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda u, p: JS.mamba_layer(u, p, jcfg,
                                               return_state=True))(
        jnp.asarray(u), jp)
    got = TS.mamba_layer(torch.from_numpy(u), tp, tcfg, return_state=True)
    _close(got[0], want[0])
    _close(got[1]["state"], want[1]["state"])
    assert got[1]["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[1]["conv"].float().numpy(),
                                  np.asarray(want[1]["conv"], np.float32))
    _close(TS.mamba_layer(torch.from_numpy(u), tp, tcfg), want[0])


def test_mamba_decode_step_from_the_prefill_state():
    jcfg, tcfg = jconfigs.get_smoke("mamba2_780m"), \
        tconfigs.get_smoke("mamba2_780m")
    jp, tp = _both(_params(jcfg, 3))
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 32, 64)).astype(np.float32)
    u1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    _, jcache = jax.jit(lambda u, p: JS.mamba_layer(
        u, p, jcfg, return_state=True))(jnp.asarray(u), jp)
    _, tcache = TS.mamba_layer(torch.from_numpy(u), tp, tcfg,
                               return_state=True)
    step = jax.jit(lambda u, c, p: JS.mamba_decode_step(u, c, p, jcfg))
    tu, ju = torch.from_numpy(u1), jnp.asarray(u1)
    for _ in range(3):
        jout, jcache = step(ju, jcache, jp)
        tout, tcache = TS.mamba_decode_step(tu, tcache, tp, tcfg)
        _close(tout, jout)
        _close(tcache["state"], jcache["state"])
        # the bf16 history of values within 1e-4: a rounding may flip
        _close(tcache["conv"], jcache["conv"], 2e-2)
        ju, tu = jout, tout


def test_init_ssm_cache_layout():
    jcfg, tcfg = jconfigs.get_smoke("zamba2_7b"), tconfigs.get_smoke(
        "zamba2_7b")
    want = JS.init_ssm_cache(jcfg, 3)
    got = TS.init_ssm_cache(tcfg, 3, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(not v.any() for v in got.values())


def test_chunk_rule_refuses_as_the_reference():
    jcfg, tcfg = jconfigs.get_smoke("mamba2_780m"), \
        tconfigs.get_smoke("mamba2_780m")
    jp, tp = _both(_params(jcfg, 5))
    u = np.zeros((1, 48, 64), np.float32)      # 48 > chunk 32, no multiple
    with pytest.raises(AssertionError):
        jax.jit(lambda u, p: JS.mamba_layer(u, p, jcfg))(jnp.asarray(u), jp)
    with pytest.raises(ValueError, match="chunk"):
        TS.mamba_layer(torch.from_numpy(u), tp, tcfg)
