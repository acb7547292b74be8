"""The fused update's plain PyTorch version against the Pallas kernel.

``repro_torch``'s ``ops.sketch_block_update_fused`` on CPU tensors runs
``kernels/sketch_update/ref.py``, the plain version the CUDA kernel is
held to on the card. Here it is held to the reference's
``ops.sketch_block_update_fused``, which runs the Pallas kernel in
interpret mode on the CPU (as tests/test_kernels_banked.py does), on
the same routed blocks: variant × {plain, sharded S=4} × k=200, cold
and warm, plus near-rail banks and all-padding blocks. Equality is
exact (int32 state).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from repro.kernels.sketch_update.ops import sketch_block_update_fused as jfused
from repro.sketch import bank as jbk
from repro.sketch import state as jst
from repro_torch.kernels.sketch_update import kernel as tkernel
from repro_torch.kernels.sketch_update.ops import sketch_block_update_fused as tfused
from repro_torch.kernels.sketch_update.ref import fused_update_ref
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import state as tst

K = 200  # not a LANES multiple: exercises the BLOCKED column padding
IMAX = 2**31 - 1
VARIANT = {"sspm": 2, "lazy": 1}


def _to_torch(bank):
    return tst.SketchState(*(torch.from_numpy(np.array(x)) for x in bank))


def _assert_equal(jb, tb, msg):
    for name, a, b in zip(("ids", "counts", "errors"), jb, tb):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _block(rng, n=512, universe=1 << 12, signed=True):
    items = rng.integers(0, universe, n).astype(np.int32)
    choices = [-2, -1, 1, 1, 1, 3] if signed else [1, 1, 2]
    return items, rng.choice(choices, n).astype(np.int32)


def _step(jb, tb, S, items, weights, v):
    ri, rw = jbk.HashShardRouter(S, 16).route_dense(jnp.asarray(items),
                                                    jnp.asarray(weights))
    jb = jfused(jb, ri, rw, v, True)
    ti, tw = tbk.HashShardRouter(S, 16).route_dense(torch.from_numpy(items),
                                                    torch.from_numpy(weights))
    return jb, tfused(tb, ti, tw, v)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_ref_matches_pallas_kernel_cold_and_warm(S, variant):
    rng = np.random.default_rng(S * 7 + VARIANT[variant])
    jb = jbk.init([K] * S)
    tb = tbk.init(K, S, device="cpu")
    for blk in range(3):   # cold (empty fill), then warm (residual loops)
        items, weights = _block(rng, signed=blk > 0)
        jb, tb = _step(jb, tb, S, items, weights, VARIANT[variant])
        _assert_equal(jb, tb, f"S={S}/{variant}/block{blk}")


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_ref_matches_pallas_kernel_near_rail(S, variant):
    """Warm banks lifted next to +INT_MAX (counts saturate, water-fill
    probes at the rail), then signed blocks."""
    rng = np.random.default_rng(40 + S + VARIANT[variant])
    jb = jbk.init([K] * S)
    tb = tbk.init(K, S, device="cpu")
    items, weights = _block(rng, universe=400, signed=False)
    jb, tb = _step(jb, tb, S, items, weights, VARIANT[variant])
    lift = jnp.asarray(IMAX - 8 - rng.integers(0, 4, (S, K)), jnp.int32)
    live = jb.ids >= 0
    jb = jst.SketchState(jb.ids, jnp.where(live, jst.sat_add(jb.counts, lift),
                                           jb.counts), jb.errors)
    tb = _to_torch(jb)
    for blk in range(2):
        items, weights = _block(rng, universe=400)
        jb, tb = _step(jb, tb, S, items, weights, VARIANT[variant])
        _assert_equal(jb, tb, f"rail S={S}/{variant}/block{blk}")


@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_all_padding_block_is_a_noop(variant):
    rng = np.random.default_rng(3)
    jb = jbk.init([K] * 4)
    items, weights = _block(rng)
    jb, tb = _step(jb, _to_torch(jb), 4, items, weights, VARIANT[variant])
    pad_w = np.zeros(512, np.int32)
    jb2, tb2 = _step(jb, tb, 4, items, pad_w, VARIANT[variant])
    _assert_equal(jb2, tb2, "padding")
    _assert_equal(jb, tb2, "padding changed the bank")


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    tb = tbk.init(K, 2, device="cpu")
    R, B = 2, 8
    z = torch.zeros((R,), dtype=torch.int32)
    stream = torch.zeros((R, B), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.sketch_update_kernel_fused(*tb, torch.zeros_like(tb.ids),
                                           stream, stream, z, z, z, z)
    before = dict(tkernel.sketch_update_kernel_fused.launches)
    out = tfused(tb, stream, stream, 2)
    assert tkernel.sketch_update_kernel_fused.launches == before
    _assert_equal(tb, out, "empty block")
    # the plain version leaves its inputs alone
    ids, counts, errors = fused_update_ref(*tb, torch.zeros_like(tb.ids),
                                           stream, stream, z, z, z, z)
    assert ids is not tb.ids and torch.equal(ids, tb.ids)
