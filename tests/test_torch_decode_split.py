"""A plain model of kernel 6's split and combine, held to the plain
version and to the reference's Pallas kernel.

``csrc/decode_attention.cu`` cuts the cache axis into chunks of
``decode_layout(B, C, KV, G, hd).chunk`` slots (the split), takes each
chunk's exact max m, p = exp(s - m), l = sum p and context sum p·V, then
combines the chunks (the combine): M = max m_j, L = sum l_j e^(m_j - M),
ctx = sum_j ctx_j e^(m_j - M) / max(L, 1e-30) over the chunks in order,
and the mass of a slot, sum over kv-heads in order 0..KV-1 of the sum
over q-heads of e^(s - M) / max(L, 1e-30). ``split_model`` is that
arithmetic in plain torch; here it is held, on the same numpy inputs, to
``decode_attention_ref`` (the plain version the kernel is held to on the
card) and to the reference's ``ops.decode_attention``, which runs the
Pallas kernel in interpret mode on the CPU, with the tolerances of the
decode tests: ctx 3e-5 (f32) / 3e-2 (bf16), mass atol 2e-5, rtol 2e-4.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from repro.kernels.decode_attention.ops import decode_attention as jdecode
from repro_torch.kernels.decode_attention.kernel import decode_layout
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CTX_TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def split_model(q, k_cache, v_cache, valid):
    """The kernel's split and combine in plain torch, f32 throughout:
    returns ``(ctx, mass)`` as ``decode_attention_ref`` does, and the
    layout it cut the cache by."""
    B, KV, G, hd = q.shape
    C = k_cache.shape[1]
    lay = decode_layout(B, C, KV, G, hd)
    v = v_cache.float()
    # the scores scratch, (B, C, KV, G)
    s = torch.einsum("bkgh,btkh->btkg", q.float(), k_cache.float()) * (
        1.0 / math.sqrt(hd))
    live = valid[:, :, None, None]
    m_j, l_j, ctx_j = [], [], []
    for j in range(lay.nchunks):   # the split: one chunk per CTA
        lo, hi = j * lay.chunk, min(C, (j + 1) * lay.chunk)
        sj, vj = s[:, lo:hi], live[:, lo:hi]
        m = torch.where(vj, sj, -math.inf).amax(dim=1)          # (B, KV, G)
        p = torch.where(vj & (m > -math.inf)[:, None],
                        torch.exp(sj - m[:, None]), 0.0)
        m_j.append(m)
        l_j.append(p.sum(dim=1))
        ctx_j.append(torch.einsum("btkg,btkh->bkgh", p, v[:, lo:hi]))
    # the combine
    m = torch.stack(m_j, dim=1)                                  # (B, J, KV, G)
    M = m.amax(dim=1)
    w = torch.where(m > -math.inf, torch.exp(m - M[:, None]), 0.0)
    den = (torch.stack(l_j, dim=1) * w).sum(dim=1).clamp_min(1e-30)
    ctx = torch.zeros_like(ctx_j[0])
    for j, part in enumerate(ctx_j):   # the chunks in order
        ctx = ctx + part * w[:, j, :, :, None]
    ctx = torch.where((M > -math.inf)[..., None], ctx / den[..., None], 0.0)
    p = torch.where(live, torch.exp(s - M[:, None]) / den[:, None], 0.0)
    per_head = p.sum(dim=3)                                      # (B, C, KV)
    mass = torch.zeros((B, C), dtype=torch.float32)
    for kv in range(KV):
        mass = mass + per_head[:, :, kv]
    return ctx.to(v_cache.dtype), mass, lay


# B, KV, G, hd, C, valid slots: the two serving shapes of Gemma3-27B
# (the ring cache at its full C = 1,024, the heavy-hitter cache cut from
# 8,192 to 2,048 slots), C not a multiple of the chunk, G = 7 (Qwen2),
# G = 6 (Nemotron), G = 1 at C = 1,500 (Whisper's cross-attention), hd
# 112 at KV = 32 (Zamba2), hd 256, rows with no valid slot, one valid
# slot a row, hd 20 (rows staged element by element), one chunk longer
# than the cache
CASES = [
    (2, 16, 2, 128, 1024, "full"),
    (2, 16, 2, 128, 2048, "full"),
    (2, 16, 2, 128, 1002, "70%"),
    (1, 4, 7, 128, 700, "70%"),
    (2, 8, 6, 128, 300, "70%"),
    (2, 16, 1, 64, 1500, "full"),
    (2, 32, 1, 112, 512, "70%"),
    (1, 4, 2, 256, 400, "70%"),
    (2, 2, 2, 64, 128, "row 0 empty"),
    (2, 2, 4, 64, 256, "one"),
    (2, 4, 2, 20, 300, "70%"),
    (3, 2, 1, 64, 24, "70%"),
]


def _inputs(case, dtype):
    B, KV, G, hd, C, kind = case
    rng = np.random.default_rng(B * 1000 + C + hd + G)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, KV, G, hd), (B, C, KV, hd), (B, C, KV, hd))]
    if kind == "full":
        valid = np.ones((B, C), bool)
    elif kind == "one":
        valid = np.zeros((B, C), bool)
        valid[np.arange(B), rng.integers(0, C, B)] = True
    else:
        valid = rng.random((B, C)) < 0.7
        if kind == "row 0 empty":
            valid[0] = False
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays] + [jnp.asarray(valid)],
            [torch.from_numpy(a).to(tdt) for a in arrays]
            + [torch.from_numpy(valid)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    (ctx, mass), (ctx_w, mass_w) = got, want
    tol = CTX_TOL[dtype]
    np.testing.assert_allclose(_f32(ctx), _f32(ctx_w), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(mass), _f32(mass_w), atol=2e-5,
                               rtol=2e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_split_model_matches_the_plain_version_and_the_pallas_kernel(
        case, dtype):
    B, KV, G, hd, C, kind = case
    jargs, targs = _inputs(case, dtype)
    ctx, mass, lay = split_model(*targs)
    assert ctx.dtype == targs[2].dtype and ctx.shape == (B, KV, G, hd)
    _close((ctx, mass), decode_attention_ref(*targs), dtype)
    _close((ctx, mass), jdecode(*jargs), dtype)
    valid = targs[3]
    has = valid.any(dim=1)
    np.testing.assert_allclose(mass.double().sum(dim=1)[has].numpy(),
                               KV * G, rtol=1e-4)
    assert not bool(mass[~has].any()) and not bool(ctx[~has].any())
    assert bool(torch.isfinite(ctx.float()).all())
    if (C, kind) == (1002, "70%"):
        assert C % lay.chunk != 0   # a last chunk shorter than the others
    if (C, kind) == (24, "70%"):
        assert lay.nchunks == 1


@pytest.mark.parametrize("case", CASES, ids=str)
def test_layout_covers_the_cache(case):
    """Every slot in one chunk, the chunk a multiple of the sub-chunk,
    the threads' cells cover each head group's rows, and the scores and
    the scratch sized as the source sizes them."""
    B, KV, G, hd, C, _ = case
    lay = decode_layout(B, C, KV, G, hd)
    assert lay.chunk % lay.sub == 0 and 1 <= lay.sub <= 32
    assert (lay.nchunks - 1) * lay.chunk < C <= lay.nchunks * lay.chunk
    assert lay.hdp >= hd and lay.hdp % 8 == 0 and lay.lanes >= lay.units
    assert lay.kvh * lay.kv_groups >= KV and lay.gh * lay.g_groups >= G
    assert lay.kvh * lay.lanes * lay.rep <= lay.threads <= 512
    assert lay.threads % 32 == 0 and lay.gmax in (1, 2, 4, 8)
    assert lay.chunk * lay.kvh * lay.gh <= 8192
    assert -(-C // lay.combine) <= 256 and lay.combine * B >= 132
    assert lay.scratch == (B * C * KV * G
                           + B * lay.nchunks * KV * G * (2 + lay.hdp))


def test_f32_query_over_a_bf16_cache_equals_the_upcast_cache():
    """``layers.decode_attend`` with an f32 q over a bf16 cache (no upcast
    copy) gives, bit for bit, what it gives over the cache upcast to
    f32: ctx (in bf16) and mass."""
    rng = np.random.default_rng(24)
    q = torch.from_numpy(rng.standard_normal((2, 4, 2, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 200, 4, 64))
                             .astype(np.float32)).bfloat16() for _ in range(2))
    valid = torch.from_numpy(rng.random((2, 200)) < 0.7)
    ctx, mass = L.decode_attend(q, k, v, valid)
    up_ctx, up_mass = L.decode_attend(q, k.float(), v.float(), valid)
    assert ctx.dtype == torch.bfloat16 and up_ctx.dtype == torch.float32
    assert torch.equal(ctx, up_ctx.to(torch.bfloat16))
    assert torch.equal(mass, up_mass)
