"""``repro_torch.models.moe`` against ``repro.models.moe``.

The same inputs and params (numpy seeds) through both packages: the
expert counts bit for bit, in f32 and bf16 (the router runs in f32 in
both); the output within rtol = atol = 1e-5 with f32 params, and within
a bf16 ulp or two (2e-2) with bf16 params, where the combine's bf16
scatter-add rounds in another order. Ties in the router keep the
reference's order: ``top_k`` to the lower expert, a stable expert sort.
Capacity overflow (tokens past an expert's C dropped through the
overflow row) is exercised with a small capacity factor.
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
from repro.models import moe as JM
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TM


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_smoke(arch), **kw),
            dataclasses.replace(tconfigs.get_smoke(arch), **kw))


def _params(cfg, seed):
    rng = np.random.default_rng(seed)
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes = dict(router=(D, E), wi0=(E, D, Fd), wi1=(E, D, Fd),
                  wo=(E, Fd, D))
    return {k: (rng.standard_normal(s) * (0.5 if k == "router" else 0.1))
            .astype(np.float32) for k, s in shapes.items()}


def _run(arch, dtype, seed, tokens=24, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    p = _params(jcfg, seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, tokens, jcfg.d_model)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jp = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    want, wc = jax.jit(lambda x, p: JM.moe_ffn(x, p, jcfg))(
        jnp.asarray(x).astype(jdt), jp)
    got, gc = TM.moe_ffn(torch.from_numpy(x).to(tdt), tp, tcfg)
    return want, wc, got, gc


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "olmoe_1b_7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn(arch, dtype):
    want, wc, got, gc = _run(arch, dtype, seed=1)
    assert gc.dtype == torch.int32
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_capacity_overflow_drops_as_the_reference():
    """capacity_factor 0.5: C = ceil(48 * 2 * 0.5 / 8) = 6 slots an expert
    for 96 assignments, so most are dropped through the overflow row."""
    want, wc, got, gc = _run("olmoe_1b_7b", "float32", seed=2,
                             capacity_factor=0.5)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # dropped tokens get no expert output: some rows are exactly zero
    assert (np.abs(np.asarray(want)).sum(-1) == 0).any()


def test_top_k_ties_go_to_the_lower_index():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.1],
                  [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 3)
    gv, gi = TM.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_router_ties_route_as_the_reference():
    """A zero router gives every expert the same probability: top-k takes
    experts 0..K-1 for every token, in both packages, and the expert
    counts and outputs agree."""
    jcfg, tcfg = _cfgs("mixtral_8x7b")
    p = _params(jcfg, 3)
    p["router"][:] = 0
    x = np.random.default_rng(4).standard_normal((1, 10, 64)).astype(
        np.float32)
    want, wc = jax.jit(lambda x, p: JM.moe_ffn(x, p, jcfg))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got, gc = TM.moe_ffn(torch.from_numpy(x),
                         {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert gc.tolist()[:2] == [10, 10] and sum(gc.tolist()[2:]) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
