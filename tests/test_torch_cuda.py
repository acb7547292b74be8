"""Card-only checks of the CUDA kernels against their plain versions.

Marked ``cuda``: they skip on machines without a CUDA device (the CPU
tier-1 run) and run on the GPU with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` holds the kernels to the same contract at the main
paths' full sizes.
"""
from __future__ import annotations

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
