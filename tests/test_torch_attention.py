"""The attention kernels' plain versions against the JAX package.

``repro_torch``'s ``flash_attention`` and ``decode_attention`` on CPU
tensors run ``kernels/*/ref.py``, the plain versions the CUDA kernels are
held to on the card. Here they are held to the reference's ``ops``
entry points, which run the Pallas kernels in interpret mode on the CPU
(as tests/test_kernel_flash_attention.py and
tests/test_kernel_decode_attention.py run them), and to the reference's
jnp oracles, on the same numpy inputs made from a seed, with the
tolerances of those tests: flash atol = rtol = 2e-5 (f32) / 2e-2
(bf16); decode ctx 3e-5 / 3e-2, mass atol 2e-5, rtol 2e-4. bf16 inputs
are the same f32 arrays cast in each framework.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jdecode_ref
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention.kernel import \
    decode_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CTX_TOL = {"float32": 3e-5, "bfloat16": 3e-2}

# B, S, T, H, KV, hd, causal, window, bq, bkv: the reference's grid
# (tests/test_kernel_flash_attention.py:10), then T > S (sequence ends
# aligned) with and without a window, a ragged S = 96 (legal for the
# reference with bq = min(128, S)), S = 192 in tiles of 64, and no mask
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 64, 64),
    (1, 256, 256, 4, 4, 32, True, 64, 64, 64),
    (2, 256, 256, 8, 2, 128, True, 0, 128, 128),
    (1, 128, 128, 2, 1, 80, True, 32, 64, 64),
    (1, 64, 64, 1, 1, 16, True, 0, 64, 64),
    (2, 128, 128, 6, 3, 48, True, 0, 32, 64),
    (2, 64, 128, 4, 2, 64, True, 0, 64, 64),
    (1, 64, 256, 4, 2, 32, True, 100, 64, 128),
    (1, 96, 96, 4, 2, 64, True, 0, 128, 128),
    (1, 192, 192, 2, 1, 32, True, 48, 64, 64),
    (1, 128, 128, 4, 2, 64, False, 0, 64, 64),
]
# B, KV, G, hd, C: the reference's grid
# (tests/test_kernel_decode_attention.py:10)
DECODE_CASES = [
    (2, 2, 4, 64, 256),
    (1, 4, 2, 128, 512),
    (2, 1, 8, 80, 128),
    (3, 2, 1, 64, 64),
]


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    """The same f32 arrays cast to ``dtype`` in each framework."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_bf16_casts_agree_bit_for_bit():
    """Both frameworks round f32 to bf16 alike (to nearest even), so the
    bf16 cases start from the same bits."""
    (x,) = _normal(0, (4096,))
    x = np.concatenate([x, x * 1e-3, x * 1e3, [0.0, -0.0, 1.0 + 2**-8]])
    j, t = _both([x.astype(np.float32)], "bfloat16")
    jbits = np.asarray(j[0]).view(np.uint16)
    tbits = t[0].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(jbits, tbits)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_the_pallas_kernel(case, dtype):
    B, S, T, H, KV, hd, causal, window, bq, bkv = case
    (jq, jk, jv), (tq, tk, tv) = _both(
        _normal(hash(case) % 2**31, (B, S, H, hd), (B, T, KV, hd),
                (B, T, KV, hd)), dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window, bq=bq,
                          bkv=bkv)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, hd)
    tol = FLASH_TOL[dtype]
    pallas = jflash(jq, jk, jv, causal=causal, window=window, bq=bq, bkv=bkv)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    oracle = jflash_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,T,bq,bkv", [(96, 96, 64, 64), (64, 96, 64, 64),
                                        (128, 128, 48, 128)])
def test_flash_attention_refuses_what_the_reference_refuses(S, T, bq, bkv):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _normal(1, (1, S, 2, 16), (1, T, 1, 16), (1, T, 1, 16)), "float32")
    with pytest.raises(AssertionError):
        jflash(jq, jk, jv, bq=bq, bkv=bkv)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(tq, tk, tv, bq=bq, bkv=bkv)


def _decode_inputs(case, dtype, seed, empty_row=False):
    B, KV, G, hd, C = case
    arrays = _normal(seed, (B, KV, G, hd), (B, C, KV, hd), (B, C, KV, hd))
    valid = np.random.default_rng(seed + 1).random((B, C)) < 0.7
    if empty_row:
        valid[0] = False
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    return (jq, jk, jv, jnp.asarray(valid)), (tq, tk, tv,
                                              torch.from_numpy(valid))


def _check_decode(got, want, dtype):
    (ctx, mass), (ctx_w, mass_w) = got, want
    tol = CTX_TOL[dtype]
    np.testing.assert_allclose(_f32(ctx), _f32(ctx_w), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(mass), _f32(mass_w), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_matches_the_pallas_kernel(case, dtype):
    B, KV, G, hd, C = case
    jargs, targs = _decode_inputs(case, dtype, seed=C + hd)
    ctx, mass = decode_attention(*targs)
    assert ctx.dtype == targs[2].dtype and ctx.shape == (B, KV, G, hd)
    assert mass.dtype == torch.float32 and mass.shape == (B, C)
    _check_decode((ctx, mass), jdecode(*jargs), dtype)
    _check_decode((ctx, mass), jdecode_ref(*jargs), dtype)
    # the mass sums to the number of q-heads on every row with a valid slot
    has_valid = targs[3].any(dim=1).numpy()
    np.testing.assert_allclose(mass.double().sum(dim=1).numpy()[has_valid],
                               KV * G, rtol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_rows_without_a_valid_slot(dtype):
    jargs, targs = _decode_inputs((2, 2, 2, 64, 128), dtype, seed=3,
                                  empty_row=True)
    ctx, mass = decode_attention(*targs)
    _check_decode((ctx, mass), jdecode(*jargs), dtype)
    assert bool(torch.isfinite(ctx.float()).all())
    assert not bool(ctx[0].any()) and not bool(mass[0].any())
    np.testing.assert_allclose(mass[1].double().sum().item(), 4, rtol=1e-4)


def test_cpu_tensors_take_the_plain_versions_not_the_kernels():
    """``ops`` sends CPU tensors to ``ref.py``; the kernel wrappers refuse
    them (a wrapper launches its kernel or raises, it never falls back)."""
    q, k, v = (torch.from_numpy(a) for a in _normal(
        2, (1, 64, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    valid = torch.ones((1, 64), dtype=torch.bool)
    dq = q[:, :1].reshape(1, 1, 2, 16).contiguous()
    before = (flash_attention_kernel.launches,
              decode_attention_kernel.launches)
    flash_attention(q, k, v)
    decode_attention(dq, k, v, valid)
    assert (flash_attention_kernel.launches,
            decode_attention_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(dq, k, v, valid)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_wrappers_check_cuda_operands(cuda):
    """CUDA tensors reach the wrappers' checks, which refuse what the
    kernels do not take before anything is built or launched."""
    bf16 = dict(dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((1, 64, 4, 64), **bf16)
    k = torch.zeros((1, 64, 2, 64), **bf16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_kernel(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_kernel(q, k.float(), k)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_kernel(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="256"):
        flash_attention_kernel(torch.zeros((1, 8, 1, 264), **bf16),
                               *[torch.zeros((1, 8, 1, 264), **bf16)] * 2)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(q, k.cpu(), k)
    dq = torch.zeros((1, 2, 2, 64), **bf16)
    valid = torch.ones((1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        decode_attention_kernel(dq, k, k, valid.int())
    with pytest.raises(ValueError, match="fit"):
        decode_attention_kernel(dq, k, k, valid[:, :32])
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel(dq, k, k, valid.cpu())
