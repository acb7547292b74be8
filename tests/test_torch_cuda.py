"""Card-only checks of the CUDA kernels against their plain versions.

Marked ``cuda``: they skip on machines without a CUDA device (the CPU
tier-1 run) and run on the GPU with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` holds the kernels to the same contract at the main
paths' full sizes.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.streams import bounded_stream
from repro_torch.kernels.sketch_update.kernel import (
    sketch_residual_kernel, sketch_residual_kernel_banked,
    sketch_update_kernel_fused, sketch_update_kernel_serial)
from repro_torch.kernels.sketch_update.ops import _pad_bank
from repro_torch.kernels.sketch_update.ref import (
    fused_update_ref, residual_phase, residual_phase_banked, serial_update_ref)
from repro_torch.sketch import bank as bk
from repro_torch.sketch.blocks import _phase1
from repro_torch.sketch.phases import pad_rows
from repro_torch.sketch.api import SketchSpec
from repro_torch.sketch.session import StreamSession
from repro_torch.sketch.state import SketchState, sat_add

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _warm_bank(R, K, device, seed):
    """A bank after two blocks of a bounded-deletion stream."""
    s = bounded_stream(4 * R * K, 0.5, universe=1 << 16, seed=seed)
    bank = bk.init(K, R, device=device)
    router = bk.HashShardRouter(R, 16)
    for part in np.array_split(s, 2):
        it = torch.as_tensor(part[:, 0], dtype=torch.int32, device=device)
        w = torch.as_tensor(part[:, 1], dtype=torch.int32, device=device)
        ri, rw = router.route_dense(it, w)
        prep = bk.phase1_dense_prep(bank, ri, rw, 2)
        bank = SketchState(*fused_update_ref(*bank, *prep, variant=2))
    return bank


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(1, 77), (7, 200), (7, 3125)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_kernel_equals_plain_version(cuda, variant, R, K, state):
    seed = R * 1000 + K + variant
    bank = (bk.init(K, R, device=cuda) if state == "cold"
            else _warm_bank(R, K, cuda, seed))
    if state == "rail":
        live = bank.ids >= 0
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, 2**31 - 20), bank.counts))
    s = bounded_stream(2048, 0.5, universe=1 << 16, seed=seed + 1)
    it = torch.as_tensor(s[:2048, 0], dtype=torch.int32, device=cuda)
    w = torch.as_tensor(s[:2048, 1], dtype=torch.int32, device=cuda)
    ri, rw = bk.HashShardRouter(R, 16).route_dense(it, w)
    prep = bk.phase1_dense_prep(bank, ri, rw, variant)
    want = fused_update_ref(*bank, *prep, variant=variant)
    got = sketch_update_kernel_fused(*(t.clone() for t in bank), *prep,
                                     variant=variant)
    torch.cuda.synchronize()
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        assert torch.equal(a, b), name


def _case(R, K, variant, state, device, n=2048):
    """A bank (cold, warm or near the +rail) and a routed signed block."""
    seed = R * 1000 + K + variant
    bank = (bk.init(K, R, device=device) if state == "cold"
            else _warm_bank(R, K, device, seed))
    if state == "rail":
        live = bank.ids >= 0
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, 2**31 - 20), bank.counts))
    s = bounded_stream(n, 0.5, universe=1 << 16, seed=seed + 1)
    it = torch.as_tensor(s[:n, 0], dtype=torch.int32, device=device)
    w = torch.as_tensor(s[:n, 1], dtype=torch.int32, device=device)
    return bank, bk.HashShardRouter(R, 16).route_dense(it, w), (it, w)


def _assert_same(want, got):
    torch.cuda.synchronize()
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(1, 77), (7, 200), (7, 3125)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_banked_residual_kernel_equals_plain_version(cuda, variant, R, K,
                                                     state):
    bank, routed, _ = _case(R, K, variant, state, cuda)
    ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del = bk.phase1_dense(
        bank, *routed, variant)
    padded = _pad_bank(SketchState(ids1, cnt1, err1))
    args = (h_uids, h_net, uoff, mu, mu + nnu, w_del)
    want = residual_phase_banked(*padded, *args, variant)
    got = sketch_residual_kernel_banked(*(t.clone() for t in padded), *args,
                                        variant=variant)
    _assert_same(want, got)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("E,K", [(1, 77), (7, 200), (7, 3125), (1, 40000)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_residual_kernel_equals_plain_version(cuda, variant, E, K, state):
    """E sketches (the rows of a bank) with their routed, sorted views."""
    bank, routed, _ = _case(E, K, variant, state, cuda)
    ph = _phase1(bank, *routed, variant, assume_sorted=True)
    rows = pad_rows(*ph[:3])
    want = residual_phase(*rows, *ph[3:], variant)
    got = sketch_residual_kernel(*(t.clone() for t in rows), *ph[3:],
                                 variant=variant)
    _assert_same(want, got)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("K", [77, 200, 4000])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_serial_kernel_equals_plain_version(cuda, variant, K, state):
    bank, _, (it, w) = _case(1, K, variant, state, cuda, n=512)
    rows = pad_rows(*(t[0] for t in bank))
    want = serial_update_ref(*rows, it, w, variant)
    got = sketch_update_kernel_serial(*(t.clone() for t in rows), it, w,
                                      variant=variant)
    _assert_same(want, got)


def test_session_on_the_card_equals_the_cpu_session(cuda):
    _sharded_session_on_the_card_equals_the_cpu(cuda, "kernel")


def test_block_session_on_the_card_equals_the_cpu_session(cuda):
    _sharded_session_on_the_card_equals_the_cpu(cuda, "block")


def _sharded_session_on_the_card_equals_the_cpu(cuda, backend):
    spec = SketchSpec(k=3000, shards=8, bits=16, backend=backend)
    s = bounded_stream(30000, 0.5, universe=1 << 16, seed=9)
    gpu = StreamSession(spec, block=4096, device=cuda)
    cpu = StreamSession(spec, block=4096, device="cpu")
    gpu.ingest(s[:, 0], s[:, 1])
    cpu.ingest(s[:, 0], s[:, 1])
    for a, b in zip(gpu.state.bank, cpu.state.bank):
        assert torch.equal(a.cpu(), b)


def test_unsharded_block_backend_on_the_card_equals_the_cpu(cuda):
    spec = SketchSpec(k=5000, bits=16, backend="block")
    s = bounded_stream(30000, 0.5, universe=1 << 16, seed=10)
    gpu = StreamSession(spec, block=4096, device=cuda)
    cpu = StreamSession(spec, block=4096, device="cpu")
    gpu.ingest(s[:, 0], s[:, 1])
    cpu.ingest(s[:, 0], s[:, 1])
    for a, b in zip(gpu.state, cpu.state):
        assert torch.equal(a.cpu(), b)


def test_pad_bank_keeps_the_callers_bank(cuda):
    bank = bk.init(200, 2, device=cuda)
    padded = _pad_bank(bank)
    assert padded.ids.shape == (2, 256)
    assert padded.ids.data_ptr() != bank.ids.data_ptr()


# --- the attention kernels (5 and 6) against their plain versions ----------

# B, S, T, H, KV, hd, causal, window: the reference's flash grid, a ragged
# S (96, 100), T > S, hd = 80 and 200 (not multiples of 16 or 64), hd = 30
# (rows not 16-byte multiples: the scalar loads), no mask
FLASH_CARD_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 256, 256, 8, 2, 128, True, 0),
    (1, 128, 128, 2, 1, 80, True, 32),
    (1, 64, 64, 1, 1, 16, True, 0),
    (2, 128, 128, 6, 3, 48, True, 0),
    (1, 96, 96, 4, 2, 64, True, 0),
    (1, 100, 164, 4, 2, 80, True, 40),
    (2, 64, 128, 4, 2, 64, True, 0),
    (1, 192, 192, 4, 2, 128, False, 0),
    (1, 130, 130, 2, 2, 200, True, 0),
    (1, 80, 80, 2, 1, 30, True, 16),
]
# B, KV, G, hd, C, row 0 empty: the reference's decode grid, a C that is
# not a multiple of the kernel's chunk, hd = 80, 20 and 30 (rows not
# 16-byte multiples in bf16, and in f32 at 30), and rows with no valid slot
DECODE_CARD_CASES = [
    (2, 2, 4, 64, 256, False),
    (1, 4, 2, 128, 512, False),
    (2, 1, 8, 80, 128, False),
    (3, 2, 1, 64, 64, False),
    (2, 2, 2, 64, 1000, False),
    (2, 2, 3, 20, 300, False),
    (2, 2, 2, 30, 100, False),
    (2, 2, 2, 64, 128, True),
    (3, 1, 2, 80, 200, True),
]


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _assert_close(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES, ids=str)
def test_flash_attention_kernel_equals_plain_version(cuda, case, dtype):
    """Within the reference's tolerances: 2e-5 (f32), 2e-2 (bf16)."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, T, H, KV, hd, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = _rand(gen, (B, S, H, hd), dtype, cuda)
    k = _rand(gen, (B, T, KV, hd), dtype, cuda)
    v = _rand(gen, (B, T, KV, hd), dtype, cuda)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal,
                                           window=window), tol, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CARD_CASES, ids=str)
def test_decode_attention_kernel_equals_plain_version(cuda, case, dtype):
    """ctx within 3e-5 (f32) / 3e-2 (bf16), mass within atol 2e-5, rtol
    2e-4; the mass sums to KV·G on rows with a valid slot, 0 elsewhere."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    B, KV, G, hd, C, empty_row = case
    gen = torch.Generator(device=cuda).manual_seed(C + hd)
    q = _rand(gen, (B, KV, G, hd), dtype, cuda)
    k = _rand(gen, (B, C, KV, hd), dtype, cuda)
    v = _rand(gen, (B, C, KV, hd), dtype, cuda)
    valid = torch.rand((B, C), generator=gen, device=cuda) < 0.7
    if empty_row:
        valid[0] = False
    ctx, mass = decode_attention_kernel(q, k, v, valid)
    want_ctx, want_mass = decode_attention_ref(q, k, v, valid)
    tol = 3e-5 if dtype == torch.float32 else 3e-2
    _assert_close(ctx, want_ctx, tol, tol)
    _assert_close(mass, want_mass, 2e-5, 2e-4)
    has = valid.any(dim=1)
    sums = mass.double().sum(dim=1)
    torch.testing.assert_close(sums[has], torch.full_like(sums[has], KV * G),
                               atol=0.0, rtol=1e-4)
    assert not bool(mass[~has].any()) and not bool(ctx[~has].any())


def test_decode_attention_mass_is_the_same_from_launch_to_launch(cuda):
    """No float atomics: two launches on the same inputs agree bit for
    bit."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel

    gen = torch.Generator(device=cuda).manual_seed(14)
    q = _rand(gen, (4, 16, 2, 128), torch.bfloat16, cuda)
    k = _rand(gen, (4, 2048, 16, 128), torch.bfloat16, cuda)
    v = _rand(gen, (4, 2048, 16, 128), torch.bfloat16, cuda)
    valid = torch.rand((4, 2048), generator=gen, device=cuda) < 0.9
    first = decode_attention_kernel(q, k, v, valid)
    second = decode_attention_kernel(q, k, v, valid)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_attention_ops_launch_the_kernels_for_cuda_tensors(cuda):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel

    bf16 = dict(dtype=torch.bfloat16, device=cuda)
    q = torch.randn((1, 128, 4, 64), **bf16)
    k = torch.randn((1, 128, 2, 64), **bf16)
    before = (flash_attention_kernel.launches,
              decode_attention_kernel.launches)
    flash_attention(q, k, k, window=32, bq=64, bkv=64)
    decode_attention(q[:, :1].reshape(1, 2, 2, 64).contiguous(), k, k,
                     torch.ones((1, 128), dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches,
            decode_attention_kernel.launches) == (before[0] + 1,
                                                  before[1] + 1)


# A fault planted in a copy of a kernel's source, at the full-width shapes
# of chip_smoke.py: one 64-key tile's P·V dropped in one flash CTA (the
# last q tile of head 0), and one chunk dropped from decode's combine for
# (b 0, kv-head 0). chip_smoke.py's row check must pass the kernel as it is
# and reject the mutant.
MUTANTS = {
    "flash_attention": (
        "    // o += P · V: the score fragments",
        "    if (blockIdx.x == 0 && blockIdx.y == 0 && it == ntiles / 2) {\n"
        "      __syncthreads();\n      continue;\n    }\n"
        "    // o += P · V: the score fragments"),
    "decode_attention": (
        "        acc = fmaf(part[(size_t)j * G * p.hd], weight[j], acc);",
        "        if (!(b == 0 && kvh == 0 && j == nc / 2))\n"
        "          acc = fmaf(part[(size_t)j * G * p.hd], weight[j], acc);"),
}


def _chip_smoke():
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _full_width_shares(cuda, name, kernels) -> list:
    """chip_smoke's row share of each full-width run: flash global and
    local, or the decode context."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    chip_smoke = _chip_smoke()
    (q, k, v), (dq, dk, dv, valid) = chip_smoke.attention_inputs(cuda, 6)
    if name == "flash_attention":
        return [chip_smoke.row_share(
                    kernels.flash_attention_kernel(q, k, v, window=w),
                    flash_attention_ref(q, k, v, causal=True, window=w))[1]
                for w in (0, chip_smoke.GEMMA["window"])]
    return [chip_smoke.row_share(
        kernels.decode_attention_kernel(dq, dk, dv, valid)[0],
        decode_attention_ref(dq, dk, dv, valid)[0])[1]]


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_full_width_row_check_rejects_a_mutant_kernel(cuda, name, tmp_path,
                                                      monkeypatch):
    import importlib

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    kernels = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    good = _full_width_shares(cuda, name, kernels)
    old, new = MUTANTS[name]
    source = kernels.SOURCE.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / kernels.SOURCE.name
    mutant.write_text(source.replace(old, new))
    monkeypatch.setattr(kernels, "SOURCE", mutant)
    bad = _full_width_shares(cuda, name, kernels)
    limit = _chip_smoke().ROW_SHARE
    print(f"{name}: row share {good} as built, {bad} mutant (limit "
          f"{limit})")
    assert max(good) <= limit < min(bad)
