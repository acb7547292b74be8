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
    banked_layout, fused_layout, residual_layout, sketch_residual_kernel,
    sketch_residual_kernel_banked, sketch_update_kernel_fused,
    sketch_update_kernel_serial)
from repro_torch.kernels.sketch_update.ops import _pad_bank
from repro_torch.kernels.sketch_update.ref import (
    fused_update_ref, residual_phase, residual_phase_banked, serial_update_ref,
    unbiased_update_ref)
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
@pytest.mark.parametrize("R,K", [(1, 77), (7, 200), (7, 3125),
                                 # the last row staged in shared memory,
                                 # and the first left in device memory
                                 (1, 24576), (1, 24577)])
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
    got, ran = _run(sketch_update_kernel_fused,
                    *(t.clone() for t in bank), *prep, variant=variant)
    assert ran == [fused_layout(K)]
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


def _run(kernel, *args, **kw):
    """``kernel(*args, **kw)`` (kernel 1, 2 or 3) and the layouts it
    counted a launch on."""
    before = dict(kernel.launches)
    out = kernel(*args, **kw)
    return out, [p for p, n in kernel.launches.items() if n != before[p]]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(1, 77), (7, 200), (7, 3125),
                                 # the last row staged in shared memory,
                                 # and the first left in device memory
                                 (1, 24576), (1, 24577)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_banked_residual_kernel_equals_plain_version(cuda, variant, R, K,
                                                     state):
    bank, routed, _ = _case(R, K, variant, state, cuda)
    ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del = bk.phase1_dense(
        bank, *routed, variant)
    padded = _pad_bank(SketchState(ids1, cnt1, err1))
    args = (h_uids, h_net, uoff, mu, mu + nnu, w_del)
    want = residual_phase_banked(*padded, *args, variant)
    got, ran = _run(sketch_residual_kernel_banked,
                    *(t.clone() for t in padded), *args, variant=variant)
    _assert_same(want, got)
    assert ran == [banked_layout(padded[0].shape[1])]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("E,K", [(1, 77), (7, 200), (7, 3125), (1, 40000),
                                 # R = 128, staged in shared memory; R =
                                 # 129, summarised over the card
                                 (2, 16384), (2, 16385)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_residual_kernel_equals_plain_version(cuda, variant, E, K, state):
    """E sketches (the rows of a bank) with their routed, sorted views."""
    bank, routed, _ = _case(E, K, variant, state, cuda)
    ph = _phase1(bank, *routed, variant, assume_sorted=True)
    rows = pad_rows(*ph[:3])
    want = residual_phase(*rows, *ph[3:], variant)
    got, ran = _run(sketch_residual_kernel, *(t.clone() for t in rows),
                    *ph[3:], variant=variant)
    _assert_same(want, got)
    assert ran == [residual_layout(rows[0].shape[1])]


DRAIN_KINDS = ("ties", "prefix", "boundary", "over", "big", "signs", "empty")


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("E,k", [(3, 3000), (2, 20000)])   # both layouts
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_residual_kernel_on_the_drain_edge_cases(cuda, variant, E, k, kind):
    """Evictions, then the SS± drain as a selection, at its edges
    (``chip_smoke.drain_domains``), bit for bit against the plain
    version's greedy drain."""
    rows, args = _chip_smoke().drain_split(E, k, variant, kind, cuda,
                                           seed=k + E)
    want = residual_phase(*rows, *args, variant)
    got, ran = _run(sketch_residual_kernel, *(t.clone() for t in rows),
                    *args, variant=variant)
    _assert_same(want, got)
    assert ran == [residual_layout(rows[0].shape[1])]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(3, 3001), (2, 30000)])    # both layouts
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_banked_residual_kernel_on_the_drain_edge_cases(cuda, variant, R, K,
                                                        kind):
    """As above for kernel 2 (its sat_add drain), on unpadded rows."""
    rows, args = _chip_smoke().drain_banked(R, K, variant, kind, cuda,
                                            seed=K + R)
    want = residual_phase_banked(*rows, *args, variant)
    got, ran = _run(sketch_residual_kernel_banked,
                    *(t.clone() for t in rows), *args, variant=variant)
    _assert_same(want, got)
    assert ran == [banked_layout(K)]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(3, 3001), (2, 30000)])    # both layouts
@pytest.mark.parametrize("kind", DRAIN_KINDS)
def test_fused_kernel_on_the_drain_edge_cases(cuda, variant, R, K, kind):
    """As above for kernel 1 (a delta, evictions, its sat_add drain)."""
    rows, args = _chip_smoke().drain_fused(R, K, variant, kind, cuda,
                                           seed=K + R)
    want = fused_update_ref(*rows, *args, variant=variant)
    got, ran = _run(sketch_update_kernel_fused,
                    *(t.clone() for t in rows), *args, variant=variant)
    _assert_same(want, got)
    assert ran == [fused_layout(K)]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("K", [24576, 65536])               # both layouts
def test_fused_kernel_where_the_water_level_sums_wrap(cuda, variant, K):
    """Kernel 1's water level where the reference's int32 probe sums wrap
    past 2^31 (``chip_smoke.wrap_fused``), bit for bit."""
    rows, args = _chip_smoke().wrap_fused(1, K, cuda)
    want = fused_update_ref(*rows, *args, variant=variant)
    got, ran = _run(sketch_update_kernel_fused,
                    *(t.clone() for t in rows), *args, variant=variant)
    _assert_same(want, got)
    assert ran == [fused_layout(K)]


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


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("k,state,block", [
    (8000, "warm", "stream"),    # n = 8,064: the last all-shared layout
    (8100, "warm", "stream"),    # n = 8,192: structures in the scratch
    (16000, "warm", "drain"),
    (40000, "warm", "stream"),
    (40000, "cold", "minus1"),
    (1000, "dup", "stream"),     # one id in three slots, one in two
    (77, "cold", "minus1"),      # the item -1 into EMPTY slots, and evicting
    (200, "warm", "minus1"),
    (301, "warm", "drain"),      # deletions of 40 across max-error slots
    (3125, "warm", "drain"),
], ids=str)
def test_serial_kernel_on_the_structures_edge_cases(cuda, variant, k, state,
                                                    block):
    """The structures' rare paths (chip_smoke.serial_case builds each
    case), bit for bit against the plain version."""
    rows, (it, w) = _chip_smoke().serial_case(1, k, variant, state, block,
                                              cuda, seed=k + variant)
    want = serial_update_ref(*rows, it, w, variant)
    got = sketch_update_kernel_serial(*(t.clone() for t in rows), it, w,
                                      variant=variant)
    _assert_same(want, got)


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("S,K", [(1, 77), (1, 2000), (7, 200), (128, 3125),
                                 # past the staged layout: the row in
                                 # device memory
                                 (1, 24577)])
@pytest.mark.parametrize("state", ["cold", "warm", "rail"])
def test_kernel_on_the_partition_layout_equals_plain_version(cuda, variant,
                                                             S, K, state):
    """Kernel 1 reading each row's run of the partition prep's flat layout
    from ``uoff[r]`` (the ``"bank"`` backend), bit for bit against
    ``fused_update_ref`` on the same operands. At S = 128 rows get no
    work; a cold bank's fill consumes every insert of its rows."""
    from repro_torch.kernels.sketch_update.ops import prep_partition

    bank, _, (it, w) = _case(S, K, variant, state, cuda)
    padded, prep = prep_partition(bank, it, w, bk.HashShardRouter(S, 16),
                                  variant)
    assert prep[1].shape == (len(it),) and prep[-1].shape == (S,)
    want = fused_update_ref(*padded, *prep, variant=variant)
    got, ran = _run(sketch_update_kernel_fused,
                    *(t.clone() for t in padded), *prep, variant=variant)
    _assert_same(want, got)
    assert ran == [fused_layout(padded[0].shape[1])]


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("k", [77, 200, 4000])
def test_serial_scans_on_the_card_equal_the_cpu(cuda, variant, k):
    """``block_update_serial`` and ``process_stream`` on the card (kernel 4,
    its insert adds saturating) equal their CPU results (the plain scan),
    block after block, the last at the INT_MAX rail."""
    from repro_torch.sketch import blocks

    s = bounded_stream(1500, 0.5, universe=1 << 12, seed=k + variant)
    for scan in (blocks.block_update_serial, blocks.process_stream):
        cpu = SketchState(*(t[0] for t in bk.init(k, 1, device="cpu")))
        gpu = SketchState(*(t.to(cuda) for t in cpu))
        for i, part in enumerate(np.array_split(s, 3)):
            if i == 2:
                live = cpu.ids >= 0
                cpu = cpu._replace(counts=torch.where(
                    live, sat_add(cpu.counts, 2**31 - 3), cpu.counts))
                gpu = SketchState(*(t.to(cuda) for t in cpu))
            it = torch.as_tensor(part[:, 0], dtype=torch.int32)
            w = torch.as_tensor(part[:, 1] * 3, dtype=torch.int32)
            cpu = scan(cpu, it, w, variant)
            gpu = scan(gpu, it.to(cuda), w.to(cuda), variant)
            for a, b in zip(gpu, cpu):
                assert torch.equal(a.cpu(), b), (scan.__name__, i)


def test_session_on_the_card_equals_the_cpu_session(cuda):
    _sharded_session_on_the_card_equals_the_cpu(cuda, "kernel")


def test_serial_backend_through_the_captured_ingest(cuda):
    """``backend="serial"`` in a captured session: kernel 4 once a block,
    replayed, equal to the CPU session's plain scan."""
    from repro_torch.kernels.sketch_update import kernel

    spec = SketchSpec(k=1000, bits=16, backend="serial")
    s = bounded_stream(8000, 0.5, universe=1 << 16, seed=18)
    gpu = StreamSession(spec, block=2048, device=cuda)
    cpu = StreamSession(spec, block=2048, device="cpu")
    c0 = kernel.launch_counts()
    gpu.ingest(s[:, 0], s[:, 1])
    assert kernel.launch_delta(c0, kernel.launch_counts()) == {
        "sketch_update_kernel_serial": gpu.blocks_ingested}
    assert gpu._compiled.graph is not None
    cpu.ingest(s[:, 0], s[:, 1])
    for a, b in zip(gpu.state, cpu.state):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("shards", [8, None])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_bank_session_equals_the_kernel_session(cuda, shards, variant):
    """``backend="bank"`` (the partition core, kernel 1 on the flat
    layout) through captured sessions equals ``backend="kernel"``'s
    state and the CPU's, one kernel-1 launch a block."""
    from repro_torch.kernels.sketch_update import kernel

    s = bounded_stream(30000, 0.5, universe=1 << 16, seed=17)
    states = {}
    for backend, device in (("bank", cuda), ("kernel", cuda),
                            ("bank", "cpu")):
        spec = SketchSpec(k=3000, shards=shards, bits=16, variant=variant,
                          backend=backend)
        sess = StreamSession(spec, block=4096, device=device)
        c0 = kernel.launch_counts()
        sess.ingest(s[:, 0], s[:, 1])
        if device != "cpu":
            assert kernel.launch_delta(c0, kernel.launch_counts()) == {
                "sketch_update_kernel_fused": {"staged":
                                               sess.blocks_ingested}}
        state = sess.state.bank if shards else sess.state
        states[backend, str(device)] = [t.cpu() for t in state]
    want = states["kernel", str(cuda)]
    for got in states.values():
        for a, b in zip(got, want):
            assert torch.equal(a, b)


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


def test_session_and_update_take_cuda_tensors(cuda):
    """``StreamSession.ingest``, ``extend`` and ``push`` and ``api.update``
    take CUDA tensors (a host copy before validation), give the bank that
    host arrays give, and refuse a tensor that breaks the block
    conventions as they refuse a host array."""
    from repro_torch.sketch import api

    spec = SketchSpec(k=500, shards=4, bits=16)
    s = bounded_stream(6000, 0.5, universe=1 << 16, seed=11)
    items, weights = s[:, 0], s[:, 1]
    t = lambda a: torch.as_tensor(a, device=cuda)
    host = StreamSession(spec, block=1024, device=cuda)
    card = StreamSession(spec, block=1024, device=cuda)
    half = len(items) // 2
    host.ingest(items[:half], weights[:half])
    card.ingest(t(items[:half]), t(weights[:half]))
    host.extend(items[half:], weights[half:])
    card.extend(t(items[half:]), t(weights[half:]))
    host.push(items[:100], weights[:100])
    card.push(t(items[:100]), t(weights[:100]))
    host.flush()
    card.flush()
    for a, b in zip(host.state.bank, card.state.bank):
        assert torch.equal(a, b)
    want = api.update(spec, host.state, items[:512], weights[:512])
    got = api.update(spec, card.state, t(items[:512]), t(weights[:512]))
    for a, b in zip(want.bank, got.bank):
        assert torch.equal(a, b)
    bad = (np.array([3, -5, 4]), np.array([1, 1, 1]))
    for call in (lambda i, w: card.ingest(i, w), lambda i, w: card.extend(i, w),
                 lambda i, w: card.push(i, w),
                 lambda i, w: api.update(spec, card.state, i, w)):
        with pytest.raises(ValueError, match="negative item id"):
            call(*map(t, bad))


def test_pad_bank_keeps_the_callers_bank(cuda):
    bank = bk.init(200, 2, device=cuda)
    padded = _pad_bank(bank)
    assert padded.ids.shape == (2, 256)
    assert padded.ids.data_ptr() != bank.ids.data_ptr()


# --- the captured ingest, the feeder and the stream --------------------------

@pytest.mark.parametrize("shards,backend", [(8, "kernel"), (None, "kernel"),
                                            (8, "block"), (None, "block"),
                                            (8, "bank"), (None, "bank")])
def test_graph_replay_equals_the_eager_update(cuda, shards, backend):
    """Each block through the session's CUDA graph equals the adapter's
    eager update of the same state, and each block, the first (run
    eagerly before the capture) included, counts the launches the eager
    update makes: one of the path's kernel."""
    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.sketch import api

    spec = SketchSpec(k=3000, shards=shards, bits=16, backend=backend)
    s = bounded_stream(20000, 0.5, universe=1 << 16, seed=12)
    sess = StreamSession(spec, block=2048, device=cuda)
    eager = api.make(spec, cuda)
    name = ("sketch_residual_kernel" if backend == "block"
            else "sketch_update_kernel_fused")
    for lo in range(0, len(s) - 2048, 2048):
        it, w = s[lo:lo + 2048, 0], s[lo:lo + 2048, 1]
        c0 = kernel.launch_counts()
        sess.ingest_block(it, w)
        c1 = kernel.launch_counts()
        eager = api.adapter_for(spec).update(
            spec, eager, torch.as_tensor(it, device=cuda),
            torch.as_tensor(w, device=cuda))
        c2 = kernel.launch_counts()
        got = sess.state.bank if shards else sess.state
        want = eager.bank if shards else eager
        for a, b in zip(got, want):
            assert torch.equal(a, b), f"block at {lo}"
        replayed = kernel.launch_delta(c0, c1)
        assert replayed == kernel.launch_delta(c1, c2)
        assert list(replayed) == [name] and sum(replayed[name].values()) == 1


def test_capture_with_a_synchronising_op_raises(cuda, monkeypatch):
    """A synchronising op in the captured region fails the capture, and the
    failure reaches the caller: nothing falls back to the eager path."""
    from repro_torch.sketch import api

    spec = SketchSpec(k=1234, bits=16)
    real = api._FrequencyAdapter.update

    def planted(self, spec, state, items, weights):
        out = real(self, spec, state, items, weights)
        int(out.counts.sum())          # reads a value back to the host
        return out

    monkeypatch.setattr(api._FrequencyAdapter, "update", planted)
    sess = StreamSession(spec, block=512, device=cuda)
    with pytest.raises(RuntimeError):
        sess.ingest_block(np.arange(512, dtype=np.int32),
                          np.ones(512, np.int32))
    assert sess.blocks_ingested == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("donate", [True, False])
def test_donation_and_kept_states(cuda, donate):
    """donate=False: a state kept from the session stays as it was after
    the next ingest. donate=True: the next ingest overwrites it (the
    difference from JAX, whose donated buffer raises when read). Either
    way the session's own state is right, and two sessions sharing the
    cached graph never see each other's blocks."""
    spec = SketchSpec(k=777, shards=4, bits=16)
    s = bounded_stream(9000, 0.5, universe=1 << 16, seed=13)
    blocks = [(s[lo:lo + 1024, 0], s[lo:lo + 1024, 1])
              for lo in range(0, 6144, 1024)]
    a = StreamSession(spec, block=1024, donate=donate, device=cuda)
    b = StreamSession(spec, block=1024, donate=donate, device=cuda)
    ref_a = StreamSession(spec, block=1024, device="cpu")
    ref_b = StreamSession(spec, block=1024, device="cpu")

    def check():
        for sess, ref in ((a, ref_a), (b, ref_b)):
            for got, want in zip(sess.state.bank, ref.state.bank):
                assert torch.equal(got.cpu(), want)

    def ingest(sess, ref, i):
        sess.ingest_block(*blocks[i])
        ref.ingest_block(*blocks[i])

    ingest(a, ref_a, 0)
    kept = a.state.bank
    kept_copy = [t.clone() for t in kept]
    ingest(a, ref_a, 1)
    same = all(torch.equal(x, y) for x, y in zip(kept, kept_copy))
    assert same != donate
    if donate:
        assert all(torch.equal(x, y) for x, y in zip(kept, a.state.bank))
    # two sessions of one cell, in turns
    ingest(b, ref_b, 2)
    check()
    ingest(a, ref_a, 3)
    ingest(b, ref_b, 4)
    ingest(b, ref_b, 5)
    check()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_block_feeder_and_stream_on_the_card(cuda, depth):
    """The feeder's pinned slots and copy stream, and the device-resident
    stream entry, give the bank of sequential ``ingest_block``."""
    from repro_torch.kernels.sketch_update.ops import \
        sketch_block_update_stream
    from repro_torch.sketch.session import BlockFeeder

    spec = SketchSpec(k=3000, shards=8, bits=16)
    s = bounded_stream(30000, 0.5, universe=1 << 16, seed=14)
    n = len(s) // 2048
    items = s[:n * 2048, 0].reshape(n, 2048)
    weights = s[:n * 2048, 1].reshape(n, 2048)
    seq = StreamSession(spec, block=2048, device=cuda)
    fed = StreamSession(spec, block=2048, donate=False, device=cuda)
    feeder = BlockFeeder(fed, depth=depth)
    for i in range(n):
        seq.ingest_block(items[i], weights[i])
        feeder.feed(items[i], weights[i])
    state = feeder.flush()
    for a, b in zip(state.bank, seq.state.bank):
        assert torch.equal(a, b)
    bank = sketch_block_update_stream(
        bk.init(375, 8, device=cuda), torch.as_tensor(items),
        torch.as_tensor(weights), bk.HashShardRouter(8, 16), 2)
    for a, b in zip(bank, seq.state.bank):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shards,backend", [(None, "kernel"),
                                            (None, "bank"), (None, "block"),
                                            (3, "bank")])
@pytest.mark.parametrize("donate", [True, False])
def test_quantile_graph_carries_the_mass_leaf(cuda, shards, backend, donate):
    """A quantile session's CUDA graph updates the 0-d mass in place with
    the bank, block after block: its state equals the CPU session's (bank
    and mass) and each block counts one launch of the path's kernel. With
    donation a kept state's mass moves with the session's; without it, it
    stays. Ranks and quantiles on the card equal the CPU's."""
    from repro_torch.kernels.sketch_update import kernel

    spec = SketchSpec(kind="quantile", k=8 * 400, bits=12, shards=shards,
                      backend=backend)
    s = bounded_stream(12000, 0.5, universe=1 << 12, seed=15)
    sess = StreamSession(spec, block=2048, donate=donate, device=cuda)
    ref = StreamSession(spec, block=2048, device="cpu")
    name = {"kernel": "sketch_update_kernel_fused",
            "bank": "sketch_residual_kernel_banked",
            "block": "sketch_residual_kernel"}[backend]
    kept = None
    for lo in range(0, len(s) - 2048, 2048):
        it, w = s[lo:lo + 2048, 0], s[lo:lo + 2048, 1]
        c0 = kernel.launch_counts()
        sess.ingest_block(it, w)
        delta = kernel.launch_delta(c0, kernel.launch_counts())
        assert list(delta) == [name] and sum(delta[name].values()) == 1
        ref.ingest_block(it, w)
        for a, b in zip(sess.state.bank, ref.state.bank):
            assert torch.equal(a.cpu(), b), f"block at {lo}"
        assert sess.state.mass.shape == () and sess.state.mass.is_cuda
        assert int(sess.state.mass) == int(ref.state.mass)
        if kept is None:
            kept, kept_mass = sess.state, int(sess.state.mass)
    assert int(kept.mass) == (int(sess.state.mass) if donate else kept_mass)
    xs = np.arange(0, 1 << 12, 7)
    assert torch.equal(sess.rank_many(xs).cpu(), ref.rank_many(xs))
    qs = np.linspace(0, 1, 33)
    assert torch.equal(sess.quantile_many(qs).cpu(), ref.quantile_many(qs))


def test_dyadic_stream_entry_on_the_card(cuda):
    """``sketch_block_update_stream`` with a ``DyadicLevelRouter`` on a
    per-row-capacity bank equals the session's bank."""
    from repro_torch.kernels.sketch_update.ops import \
        sketch_block_update_stream

    spec = SketchSpec(kind="quantile", k=12 * 400, bits=12)
    s = bounded_stream(12000, 0.5, universe=1 << 12, seed=16)
    n = len(s) // 2048
    items = s[:n * 2048, 0].reshape(n, 2048)
    weights = s[:n * 2048, 1].reshape(n, 2048)
    sess = StreamSession(spec, block=2048, device=cuda)
    for i in range(n):
        sess.ingest_block(items[i], weights[i])
    from repro_torch.sketch import api

    bank = sketch_block_update_stream(
        api.make(spec, cuda).bank, torch.as_tensor(items),
        torch.as_tensor(weights), bk.DyadicLevelRouter(12), 2)
    for a, b in zip(bank, sess.state.bank):
        assert torch.equal(a, b)


# --- the multi-tenant layout on the card -------------------------------------

def _tenant_stream(T, bits, n, seed):
    """A bounded-deletion stream of composite keys over T tenants."""
    s = bounded_stream(n, 0.5, universe=T << bits, seed=seed)
    return s[:, 0], s[:, 1]


@pytest.mark.parametrize("shards", [None, 2])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_captured_tenant_ingest_equals_the_eager_update(cuda, shards,
                                                        variant):
    """A tenant session's captured ingest (the cell's ``tenants=1`` spec,
    the tenant count from the state's shape) equals the eager update and
    the CPU session, one kernel-1 launch a block."""
    from repro_torch.kernels.sketch_update import kernel
    from repro_torch.sketch import api

    spec = SketchSpec(k=64 * 12, bits=12, tenants=64, shards=shards,
                      variant=variant)
    items, weights = _tenant_stream(64, 12, 30000, seed=20)
    gpu = StreamSession(spec, block=2048, device=cuda)
    cpu = StreamSession(spec, block=2048, device="cpu")
    eager = api.make(spec, cuda)
    for lo in range(0, len(items) - 2048, 2048):
        it, w = items[lo:lo + 2048], weights[lo:lo + 2048]
        c0 = kernel.launch_counts()
        gpu.ingest_block(it, w)
        launched = kernel.launch_delta(c0, kernel.launch_counts())
        assert list(launched) == ["sketch_update_kernel_fused"]
        assert sum(launched["sketch_update_kernel_fused"].values()) == 1
        cpu.ingest_block(it, w)
        eager = api.adapter_for(spec).update(
            spec, eager, torch.as_tensor(it, device=cuda),
            torch.as_tensor(w, device=cuda))
        for a, b, c in zip(gpu.state.bank, eager.bank, cpu.state.bank):
            assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert gpu._compiled.graph is not None


def test_tenant_layouts_of_two_shapes_share_one_cell(cuda):
    """Tenant specs differing only in the tenant count or the caps share
    one cache cell: (2, 26) and (4, 13) states, one graph each. Sessions
    in turns each answer their own queries, equal to the CPU's."""
    from repro_torch.sketch import session as ses
    from repro_torch.sketch import tenant as tn

    specs = [SketchSpec(k=52, bits=8, tenants=2),
             SketchSpec(k=52, bits=8, tenants=4),
             SketchSpec(bits=8, tenants=4, tenant_caps=(13, 13, 13, 13))]
    before = ses.ingest_cache_stats()["entries"]
    gpu = [StreamSession(sp, block=64, device=cuda) for sp in specs]
    cpu = [StreamSession(sp, block=64, device="cpu") for sp in specs]
    assert ses.ingest_cache_stats()["entries"] - before <= 1
    cell = gpu[0]._compiled
    rng = np.random.default_rng(21)
    for step in range(6):
        for sp, g, c in zip(specs, gpu, cpu):
            t = rng.integers(0, sp.tenants, 40)
            keys = tn.pack_keys(t, rng.integers(0, 1 << 8, 40), 8)
            w = rng.choice([1, 1, 2], 40).astype(np.int32)
            g.ingest(keys, w)
            c.ingest(keys, w)
    assert sorted(tuple(k[0]) for k in cell.graphs) == [(2, 26), (4, 13)]
    for sp, g, c in zip(specs, gpu, cpu):
        probe = np.arange(sp.tenants << 8, dtype=np.int32)
        assert torch.equal(g.query_many(probe).cpu(), c.query_many(probe))
        for a, b in zip(g.state.bank, c.state.bank):
            assert torch.equal(a.cpu(), b)


def test_topk_tenants_on_the_card_equals_per_tenant_topk(cuda):
    from repro_torch.sketch import api
    from repro_torch.sketch import tenant as tn

    spec = SketchSpec(k=32 * 16, bits=10, tenants=32, shards=2)
    items, weights = _tenant_stream(32, 10, 20000, seed=22)
    sess = StreamSession(spec, block=4096, device=cuda)
    sess.ingest(items, weights)
    tenants = torch.tensor([5, 0, 31, 5, 17], dtype=torch.int32,
                           device=cuda)
    got_i, got_v = tn.topk_tenants(sess.state, tenants, 6, num_shards=2,
                                   item_bits=10)
    cpu_state = tn.TenantBank(bank=SketchState(
        *(t.cpu() for t in sess.state.bank)))
    want_i, want_v = tn.topk_tenants(cpu_state, tenants.cpu(), 6,
                                     num_shards=2, item_bits=10)
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_v.cpu(),
                                                            want_v)
    for i, t in enumerate(tenants.tolist()):
        one_i, one_v = api.tenant_topk(spec, sess.state, t, 6)
        assert torch.equal(got_i[i], one_i) and torch.equal(got_v[i], one_v)


@pytest.mark.parametrize("donate", [True, False])
def test_spill_and_admit_on_the_card_equal_the_cpu(cuda, donate):
    """Spill a tenant from a session whose state the captured ingest lent
    out, ingest more, re-admit: every step equals the CPU's, and the kept
    state is never written by the row functions."""
    from repro_torch.sketch import tenant as tn

    spec = SketchSpec(k=16 * 8, bits=8, tenants=16, shards=2)
    items, weights = _tenant_stream(16, 8, 12000, seed=23)
    gpu = StreamSession(spec, block=1024, donate=donate, device=cuda)
    cpu = StreamSession(spec, block=1024, device="cpu")
    half = len(items) // 2
    for sess in (gpu, cpu):
        sess.ingest(items[:half], weights[:half])
    lent = gpu.state.bank
    kept = [t.clone() for t in lent]
    spilled = {}
    for name, sess in (("gpu", gpu), ("cpu", cpu)):
        bank = sess.state.bank
        spilled[name] = tn.spill_rows(bank, 3, 2, 8)
        sess.state = tn.TenantBank(bank=tn.clear_rows(
            bank, tn.tenant_rows(3, 2)))
    assert all(torch.equal(a, b) for a, b in zip(lent, kept))
    for key in spilled["cpu"]:
        np.testing.assert_array_equal(spilled["gpu"][key],
                                      spilled["cpu"][key])
    # more traffic, none of it tenant 3's, then the exact re-admission
    rest_t, _ = tn.unpack_keys(items[half:].astype(np.int64), 8)
    keep = rest_t != 3
    for sess in (gpu, cpu):
        sess.ingest(items[half:][keep], weights[half:][keep])
    for name, sess in (("gpu", gpu), ("cpu", cpu)):
        sess.state = tn.TenantBank(bank=tn.admit_spill(sess.state.bank,
                                                       spilled[name]))
    for a, b in zip(gpu.state.bank, cpu.state.bank):
        assert torch.equal(a.cpu(), b)
    probe = np.arange(16 << 8, dtype=np.int32)
    assert torch.equal(gpu.query_many(probe).cpu(), cpu.query_many(probe))


# --- the attention kernels (5 and 6) against their plain versions ----------

# B, S, T, H, KV, hd, causal, window: the reference's flash grid, a ragged
# S (96, 100), T > S, hd = 80 and 200 (not multiples of 16 or 64), hd = 30
# (rows not 16-byte multiples: the scalar loads), no mask; then the wgmma
# path's shapes (bf16, hd 64, 128, 256) at S = 130, T = 300 (not multiples
# of its 128-row tiles), G = 1, 2 and 4, causal, windowed and unmasked
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
    (1, 130, 300, 4, 4, 64, True, 0),
    (2, 130, 300, 4, 2, 64, True, 40),
    (1, 130, 300, 4, 1, 64, False, 0),
    (1, 130, 300, 4, 4, 128, False, 0),
    (2, 130, 300, 8, 4, 128, True, 100),
    (1, 130, 300, 8, 2, 128, True, 0),
    (1, 300, 300, 8, 2, 128, True, 256),
    (1, 130, 300, 4, 1, 256, True, 0),
    (1, 130, 300, 4, 2, 256, True, 64),
    (1, 130, 300, 2, 2, 256, False, 0),
]
# B, KV, G, hd, C, row 0 empty: the reference's decode grid, a C that is
# not a multiple of the kernel's chunk, hd = 80, 20 and 30 (20 and 30 are
# not whole 8-element units: staged element by element), rows with no
# valid slot; then the two Gemma3-27B serving shapes (the SS± cache and a
# ring cache), C = 1,500 at G = 1 (Whisper's cross-attention), hd 112 at
# KV = 32 (Zamba2: 512 consumer threads), G = 7 (Qwen2: two lane groups
# a kv-head, merged in order), G = 16 at hd 256 (four head groups) and
# KV = 1,100 (three head groups; the combine's pairs in two tiles)
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
    (2, 16, 2, 128, 8192, False),
    (2, 16, 2, 128, 1024, False),
    (2, 16, 1, 64, 1500, False),
    (2, 32, 1, 112, 512, False),
    (2, 4, 7, 128, 700, True),
    (1, 16, 16, 256, 100, False),
    (1, 1100, 1, 8, 40, False),
]


def _rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _assert_close(got, want, atol, rtol):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _launched_paths(before):
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel

    return [p for p, n in flash_attention_kernel.launches.items()
            if n != before[p]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES, ids=str)
def test_flash_attention_kernel_equals_plain_version(cuda, case, dtype):
    """Within the reference's tolerances: 2e-5 (f32), 2e-2 (bf16), on the
    path ``flash_path`` names (wgmma for bf16 at hd 64, 128 and 256)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel, flash_path)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, T, H, KV, hd, causal, window = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = _rand(gen, (B, S, H, hd), dtype, cuda)
    k = _rand(gen, (B, T, KV, hd), dtype, cuda)
    v = _rand(gen, (B, T, KV, hd), dtype, cuda)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    before = dict(flash_attention_kernel.launches)
    got = flash_attention_kernel(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype
    _assert_close(got, flash_attention_ref(q, k, v, causal=causal,
                                           window=window), tol, tol)
    path = flash_path(dtype, hd, True)
    assert _launched_paths(before) == [path]
    assert path == ("f32" if dtype == torch.float32 else
                    "wgmma" if hd in (64, 128, 256) else "mma")


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_unaligned_operands_take_the_mma_path(cuda, hd):
    """bf16 at a wgmma width, but q starts 2 bytes past a 16-byte
    boundary: the TMA cannot read it, so the mma.sync kernel runs."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(hd)
    shape = (1, 130, 4, hd)
    buf = _rand(gen, (shape[1] * shape[2] * hd + 8,), torch.bfloat16, cuda)
    q = buf[1:1 + shape[1] * shape[2] * hd].view(shape)
    k = _rand(gen, (1, 200, 2, hd), torch.bfloat16, cuda)
    v = _rand(gen, (1, 200, 2, hd), torch.bfloat16, cuda)
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = dict(flash_attention_kernel.launches)
    got = flash_attention_kernel(q, k, v, causal=True, window=0)
    _assert_close(got, flash_attention_ref(q, k, v), 2e-2, 2e-2)
    assert _launched_paths(before) == ["mma"]


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


@pytest.mark.parametrize("case", [(2, 4, 2, 64, 300, False),
                                  (2, 16, 2, 128, 1024, False),
                                  (1, 2, 3, 20, 100, True)], ids=str)
def test_decode_attention_f32_query_over_a_bf16_cache(cuda, case):
    """An f32 q over a bf16 cache reads the bf16 rows as they are: ctx (in
    bf16) and mass equal, bit for bit, the call on the cache upcast to f32
    with ctx cast to bf16 (bf16 to f32 is exact, and the layout does not
    depend on the dtype)."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel

    B, KV, G, hd, C, empty_row = case
    gen = torch.Generator(device=cuda).manual_seed(C + hd + 24)
    q = _rand(gen, (B, KV, G, hd), torch.float32, cuda)
    k = _rand(gen, (B, C, KV, hd), torch.bfloat16, cuda)
    v = _rand(gen, (B, C, KV, hd), torch.bfloat16, cuda)
    valid = torch.rand((B, C), generator=gen, device=cuda) < 0.7
    if empty_row:
        valid[0] = False
    ctx, mass = decode_attention_kernel(q, k, v, valid)
    up_ctx, up_mass = decode_attention_kernel(q, k.float(), v.float(), valid)
    torch.cuda.synchronize()
    assert ctx.dtype == torch.bfloat16 and up_ctx.dtype == torch.float32
    assert torch.equal(ctx, up_ctx.to(torch.bfloat16))
    assert torch.equal(mass, up_mass)


def test_decode_layout_is_the_built_sources(cuda):
    """``decode_layout`` against the layout the built source computes, on
    every shape of the card cases, the serving shapes and the edges of
    the thread budget."""
    from repro_torch.kernels.decode_attention import kernel

    shapes = [(B, C, KV, G, hd) for B, KV, G, hd, C, _ in DECODE_CARD_CASES]
    shapes += [(8, 8192, 16, 2, 128), (1, 131072, 8, 4, 128),
               (1, 40, 64, 16, 256), (300, 10, 1, 1, 8), (2, 77, 3, 9, 250),
               (4, 5000, 1024, 1, 8), (1, 3, 2, 70, 30)]
    for shape in shapes:
        assert kernel.source_layout(*shape) == kernel.decode_layout(*shape), \
            shape


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
    before = (dict(flash_attention_kernel.launches),
              decode_attention_kernel.launches)
    flash_attention(q, k, k, window=32, bq=64, bkv=64)
    decode_attention(q[:, :1].reshape(1, 2, 2, 64).contiguous(), k, k,
                     torch.ones((1, 128), dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert _launched_paths(before[0]) == ["wgmma"]
    assert flash_attention_kernel.launches["wgmma"] == before[0]["wgmma"] + 1
    assert decode_attention_kernel.launches == before[1] + 1


# A fault planted in a copy of a kernel's source (the module attribute that
# names it, the text replaced, its replacement), at the full-width shapes
# of chip_smoke.py: in the wgmma flash kernel, the first of the eight
# wgmmas of one kv tile's P·V (16 keys) dropped in the heaviest work item
# (the last q tile of head 0); one chunk (the middle one) dropped from
# decode's combine for (b 0, kv-head 0), every q-head of it. chip_smoke.py's row check must pass the kernel as it
# is and reject the mutant, which the old tolerance alone lets through.
MUTANTS = {
    "flash_attention": (
        "WGMMA_SOURCE",
        "        issue_pv(n + i - 1);",
        "        if (w == 0 && i == nt / 2) {\n"
        "          const bf16* Vt = Vs + ((n + i - 1) % STAGES) * "
        "C::KV_ELEMS;\n"
        "#pragma unroll\n"
        "          for (int kk = 1; kk < BKV / 16; ++kk)\n"
        "            wgmma_rs<HD>(o, pa[kk], sw128_desc(Vt + kk * 16 * BOX,\n"
        "                                               BKV * BOX * 2, "
        "1024));\n"
        "          wgmma_commit();\n"
        "        } else {\n"
        "          issue_pv(n + i - 1);\n"
        "        }"),
    "decode_attention": (
        "SOURCE",
        "            acc = fmaf(cb[x], w, acc);",
        "            if (!(b == 0 && pair / G == 0 && j0 + x * JS == nc / 2))\n"
        "              acc = fmaf(cb[x], w, acc);"),
}


def _chip_smoke():
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def _full_width_checks(cuda, name, kernels) -> list:
    """(chip_smoke's row share, whether the old tolerance atol = rtol =
    2e-2 (flash) or 3e-2 (decode ctx) passes) of each full-width run:
    flash global and local, or the decode context."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    chip_smoke = _chip_smoke()
    (q, k, v), (dq, dk, dv, valid) = chip_smoke.attention_inputs(cuda, 6)
    if name == "flash_attention":
        pairs = [(kernels.flash_attention_kernel(q, k, v, window=w),
                  flash_attention_ref(q, k, v, causal=True, window=w))
                 for w in (0, chip_smoke.GEMMA["window"])]
        tol = 2e-2
    else:
        pairs = [(kernels.decode_attention_kernel(dq, dk, dv, valid)[0],
                  decode_attention_ref(dq, dk, dv, valid)[0])]
        tol = 3e-2
    out = []
    for got, want in pairs:
        err = (got.float() - want.float()).abs()
        out.append((chip_smoke.row_share(got, want)[1],
                    bool((err <= tol + tol * want.float().abs()).all())))
    return out


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_full_width_row_check_rejects_a_mutant_kernel(cuda, name, tmp_path,
                                                      monkeypatch):
    import importlib

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from repro_torch.kernels import _build

    kernels = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    good = _full_width_checks(cuda, name, kernels)
    attr, old, new = MUTANTS[name]
    path = getattr(kernels, attr)
    source = path.read_text()
    assert source.count(old) == 1
    mutant = tmp_path / path.name
    mutant.write_text(source.replace(old, new))
    for dep in _build.includes(path):  # the headers it includes, beside it
        (tmp_path / dep.name).write_bytes(dep.read_bytes())
    monkeypatch.setattr(kernels, attr, mutant)
    bad = _full_width_checks(cuda, name, kernels)
    limit = _chip_smoke().ROW_SHARE
    print(f"{name}: (row share, old tolerance passes) {good} as built, "
          f"{bad} mutant (limit {limit})")
    assert all(ok for _, ok in good)
    assert max(share for share, _ in good) <= limit
    assert min(share for share, _ in bad) > limit
    # the old tolerance alone would let the mutant through
    assert any(ok for _, ok in bad)


# ---------------------------------------------------------------------------
# The family (the unbiased kernel) and the fault layer
# ---------------------------------------------------------------------------

def _unbiased_operands(R, Ki, Kd, state, device, B=4096, seed=0):
    """Both banks (cold, or warm after two blocks of the plain version)
    and the flat layout of one signed block: the unbiased kernel's
    operands."""
    from repro_torch.sketch import family as fam

    router = bk.HashShardRouter(R, 16)
    ins = bk.init(Ki, R, device=device)
    dels = bk.init(Kd, R, device=device)
    s = bounded_stream(3 * B, 0.5, universe=1 << 16, seed=seed + R + Ki)
    key = torch.tensor([0, seed], dtype=torch.int64).to(torch.uint32)
    parts = np.array_split(s[:3 * B], 3)
    for i, part in enumerate(parts):
        it = torch.as_tensor(part[:, 0], dtype=torch.int32, device=device)
        w = torch.as_tensor(part[:, 1], dtype=torch.int32, device=device)
        u, key = fam.draw(key.to(device), len(it))
        s_items, s_w, perm, roff = fam.unbiased_prep(it, w, router)
        if i == 2 or state == "cold":
            return (*ins, *dels, s_items, s_w, u, perm, roff)
        out = unbiased_update_ref(*ins, *dels, s_items, s_w, u, perm, roff)
        ins, dels = SketchState(*out[:3]), SketchState(*out[3:])


@pytest.mark.parametrize("R,Ki,Kd", [(1, 6, 3), (7, 200, 100), (128, 21, 11),
                                     # the largest row staged in shared
                                     # memory, and past it
                                     (1, 16384, 16), (1, 16385, 8)])
@pytest.mark.parametrize("state", ["cold", "warm"])
def test_unbiased_kernel_equals_plain_version(cuda, R, Ki, Kd, state):
    from repro_torch.kernels.sketch_update.kernel import (
        sketch_unbiased_kernel, unbiased_layout)

    ops = _unbiased_operands(R, Ki, Kd, state, cuda)
    want = unbiased_update_ref(*ops)
    got, ran = _run(sketch_unbiased_kernel, *(t.clone() for t in ops[:6]),
                    *ops[6:])
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert ran == [unbiased_layout(max(Ki, Kd))]


def test_unbiased_kernel_on_a_heavy_hitter_run(cuda):
    """One id repeated through most of a block (its repeats skip the
    search once it sits in the row) and BLOCKED slots, against the plain
    version."""
    from repro_torch.kernels.sketch_update.kernel import sketch_unbiased_kernel
    from repro_torch.sketch import family as fam

    R, B = 3, 8192
    rng = np.random.default_rng(5)
    items = np.where(rng.random(B) < 0.7, 4242,
                     rng.integers(0, 1 << 12, B)).astype(np.int32)
    weights = rng.choice([-2, -1, 1, 1, 3], B).astype(np.int32)
    it, w = (torch.as_tensor(x, device=cuda) for x in (items, weights))
    router = bk.HashShardRouter(R, 16)
    ins, dels = bk.init([40, 13, 7], device=cuda), bk.init([5, 9, 2],
                                                           device=cuda)
    u = fam.uniforms(torch.tensor([0, 3], dtype=torch.int64)
                     .to(torch.uint32).to(cuda), B)
    ops = (*ins, *dels, *fam.unbiased_prep(it, w, router))
    ops = (*ops[:8], u, *ops[8:])
    want = unbiased_update_ref(*ops)
    got = sketch_unbiased_kernel(*(t.clone() for t in ops[:6]), *ops[6:])
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant,backend,shards", [
    ("unbiased", "bank", 8), ("unbiased", "bank", None),
    ("double", "bank", 8), ("sspm", "crprecis", None)])
def test_family_session_on_the_card_equals_the_cpu_session(cuda, variant,
                                                           backend, shards):
    """Captured family sessions on the card equal the CPU's, bit for bit
    (the unbiased uniforms are the same integer hash on both): one
    unbiased-kernel launch a block, two kernel-1 launches a block for
    double, no sketch kernel for CR-precis."""
    from repro_torch.kernels.sketch_update import kernel

    spec = SketchSpec(k=2000, bits=16, variant=variant, backend=backend,
                      shards=shards)
    s = bounded_stream(20000, 0.5, universe=1 << 16, seed=31)
    gpu = StreamSession(spec, block=4096, device=cuda)
    cpu = StreamSession(spec, block=4096, device="cpu")
    c0 = kernel.launch_counts()
    gpu.ingest(s[:, 0], s[:, 1])
    launched = kernel.launch_delta(c0, kernel.launch_counts())
    n = gpu.blocks_ingested
    want = {"unbiased": {"sketch_unbiased_kernel": {"staged": n}},
            "double": {"sketch_update_kernel_fused": {"staged": 2 * n}},
            "sspm": {}}[variant]
    assert launched == want
    assert gpu._compiled.graph is not None
    cpu.ingest(s[:, 0], s[:, 1])
    for a, b in zip(_state_leaves(gpu.state), _state_leaves(cpu.state)):
        assert torch.equal(a.cpu(), b)
    probe = np.arange(1 << 12)
    assert torch.equal(gpu.query_many(probe).cpu(), cpu.query_many(probe))


def _state_leaves(state):
    from repro_torch.sketch.session import _leaves

    return _leaves(state)


@pytest.mark.parametrize("donate", [True, False])
def test_recovery_on_the_card_keeps_the_rows_it_does_not_splice(cuda,
                                                               donate):
    """``recover_session`` replays the log through the session's captured
    ingest into a state of its own: the rows it splices equal a
    never-failed twin, the others keep their live (faulted) values, and
    the session keeps ingesting, equal to the CPU session that ran the
    same faults and recovery."""
    from repro_torch.sketch import elastic, faults

    spec = SketchSpec(k=4096, bits=16, shards=8)
    s = bounded_stream(40000, 0.5, universe=1 << 16, seed=33)
    plan = faults.FaultPlan(events=(
        faults.FaultEvent(step=3, row=2, kind="corrupt"),
        faults.FaultEvent(step=4, row=5, kind="drop")))
    sess = {d: StreamSession(spec, block=4096, replay=16, fault_plan=plan,
                             donate=donate, device=d)
            for d in (cuda, "cpu")}
    twin = StreamSession(spec, block=4096, device="cpu")
    ckpt = {d: x.save(include_schedule=True) for d, x in sess.items()}
    for x in (*sess.values(), twin):
        x.ingest(s[:24576, 0], s[:24576, 1])
    live = [t.clone() for t in sess[cuda].state.bank]
    for d, x in sess.items():
        rep = elastic.recover_session(x, ckpt[d], rows=[2])
        assert rep.rows == (2,) and rep.replayed_blocks == 6
    got = sess[cuda].state.bank
    for t, lv, tw in zip(got, live, twin.state.bank):
        assert torch.equal(t[2].cpu(), tw[2])
        keep = [r for r in range(8) if r != 2]
        assert torch.equal(t[keep], lv[keep])
    for x in (*sess.values(), twin):
        x.ingest(s[24576:, 0], s[24576:, 1])
    for a, b in zip(sess[cuda].state.bank, sess["cpu"].state.bank):
        assert torch.equal(a.cpu(), b)


# -- the model stack and model serving on kernels 5 and 6 (smoke width) ---

def test_model_layers_launch_the_kernels_for_cuda_tensors(cuda):
    """``attention`` and the decode step's attention launch kernels 5 and
    6 on CUDA tensors under ``attention="kernel"`` and neither under
    ``"plain"``, with the same result within bf16 rounding."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = configs.get_smoke("gemma3_27b")
    params, _ = build_model(cfg).init(0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                         dtype=torch.int32)
    out = {}
    for attention in ("kernel", "plain"):
        flash_attention_kernel.launches = dict.fromkeys(
            flash_attention_kernel.launches, 0)
        decode_attention_kernel.launches = 0
        eng = ServeEngine(cfg, params, 64, attention=attention, device=cuda)
        out[attention] = eng.generate(toks, 3, keep_logits=True)
        torch.cuda.synchronize()
        launched = (sum(flash_attention_kernel.launches.values()),
                    decode_attention_kernel.launches)
        assert launched == ((7, 21) if attention == "kernel" else (0, 0))
    for a, b in zip(out["kernel"]["logits"], out["plain"]["logits"]):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=0.05,
                                   atol=0.05)


def test_f32_params_over_a_bf16_cache_upcast_for_the_kernel(cuda):
    """f32 params over ``build_cache``'s bf16 cache: the decode kernel
    reads the bf16 cache with the f32 query (the same result as the cache
    upcast to f32, without the copy), the context comes back in bf16, as
    the plain version's does."""
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 2, 2, 16), generator=gen, device=cuda)
    k, v = (torch.randn((2, 40, 2, 16), generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    valid = torch.rand((2, 40), generator=gen, device=cuda) < 0.7
    ctx, mass = L.decode_attend(q, k, v, valid)
    pctx, pmass = L.decode_attend(q, k, v, valid, attention="plain")
    assert ctx.dtype == pctx.dtype == torch.bfloat16
    np.testing.assert_allclose(ctx.float().cpu().numpy(),
                               pctx.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(mass.cpu().numpy(), pmass.cpu().numpy(),
                               rtol=2e-4, atol=2e-5)


def test_model_phase_at_smoke_width(cuda, monkeypatch):
    """chip_smoke's model phase with the kernels at smoke width: launch
    counts, the plain twins, the SS± invariants of a full cache, the
    stepwise invariant and the nine other configs."""
    from repro_torch import configs
    from repro_torch.serve import kv_cache

    cs = _chip_smoke()
    monkeypatch.setattr(kv_cache, "HH_ENGAGE_CTX", 32)
    others = {arch: (32 - configs.get_smoke(arch).vision_tokens,
                     128 if arch == "zamba2_7b" else 64)
              for arch in configs.ARCH_IDS if arch != "gemma3_27b"}
    launches, summary = cs.model_phase(
        cuda, get=configs.get_smoke,
        main=dict(arch="gemma3_27b", batch=2, prompt=32, new_tokens=6,
                  context=128, decay_period=4, seed=3, heavy=4),
        stepwise=dict(batch=2, prompt=16, context=64, seed=4),
        others=others, other_tokens=2,
        planted=dict(batch=2, slots=256, kv=2, g=2, hd=16, steps=20,
                     decay_period=4, heavy=(3, 200), seed=5), timed=False)
    assert summary["main"]["hh"]["live"] == 64
    assert sum(launches["flash"].values()) > 0
    held = summary["kernels_vs_plain"]
    assert held["shapes"]["flash"] >= 4 and held["shapes"]["decode"] >= 4


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_attention_fn_gradients_are_the_plain_gradients(cuda, hd, G,
                                                              window):
    """``FlashAttentionFn`` at bf16, causal or windowed, GQA 2 and 4: its
    forward is kernel 5 (one launch, within the bf16 tolerance of the
    plain version), its input gradients are autograd's of the plain
    attention on the same operands and cotangent, bit for bit."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=cuda).manual_seed(hd + G + window)
    B, S, KV = 2, 160, 2
    q = torch.randn((B, S, KV * G, hd), generator=gen, device=cuda)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device=cuda)
            for _ in range(2))
    dout = torch.randn((B, S, KV * G, hd), generator=gen,
                       device=cuda).bfloat16()
    ops = [t.bfloat16() for t in (q, k, v)]
    before = sum(flash_attention_kernel.launches.values())
    outs, grads = [], []
    for fn in (lambda *t: FlashAttentionFn.apply(*t, True, window),
               lambda *t: flash_attention_ref(*t, causal=True,
                                              window=window)):
        leaves = [t.clone().requires_grad_(True) for t in ops]
        out = fn(*leaves)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, leaves, dout))
    torch.cuda.synchronize()
    assert sum(flash_attention_kernel.launches.values()) == before + 1
    np.testing.assert_allclose(outs[0].float().cpu().numpy(),
                               outs[1].float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_qwen3_smoke_train_step_on_the_card_equals_the_cpu(cuda):
    """One train step of smoke Qwen3 (f32 params, remat) on the card,
    kernel 5 under ``FlashAttentionFn``, against the same step on the
    CPU (the plain attention): loss and gradient norm at rtol 1e-4, each
    master leaf within 2 lr (+1 %) of the CPU's, at most 2^-5 of its
    weights more than lr / 2 apart (a gradient near 0 whose sign the two
    devices' roundings set differently moves its weight the other way;
    see chip_smoke's TWIN_FLIP_SHARE)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.models import build_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainState, build_train_step

    cfg = configs.get_smoke("qwen3_0_6b")
    params, _ = build_model(cfg).init(0, dtype=torch.float32, device="cpu")
    cpu_state = TrainState(params=params, opt=adamw_init(params))
    card_state = tree_map(lambda t: t.to(cuda), cpu_state)
    batch = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=4)).batch_at(0)
    step = build_train_step(cfg)
    before = sum(flash_attention_kernel.launches.values())
    got, gm = step(card_state, {k: torch.from_numpy(v).to(cuda)
                                for k, v in batch.items()})
    torch.cuda.synchronize()
    # two attention layers, each forward and remat's recompute
    assert sum(flash_attention_kernel.launches.values()) == before + 4
    want, wm = step(cpu_state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-4)
    lr = float(wm["lr"])

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, v in tree.items()
                    for p, v in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    got_m, want_m = flat(got.opt.master), flat(want.opt.master)
    for path, w in want_m.items():
        err = (got_m[path].cpu() - w).abs()
        assert float(err.max()) <= 2.02 * lr, path
        assert float((err > lr / 2).float().mean()) <= 2.0**-5, path


def test_grad_guard_of_kernels_5_and_6_on_the_card(cuda):
    """Kernels 5 and 6 refuse CUDA operands that require grad while grad
    mode is on; ``layers._attend`` takes such operands through
    ``FlashAttentionFn`` (a result in the graph, one launch)."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.models import layers as L

    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 64, 4, 64), generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn((1, 64, 2, 64), generator=gen,
                        device=cuda).bfloat16() for _ in range(2))
    qg = q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention_kernel(qg, k, v)
    cache = torch.randn((1, 32, 2, 64), generator=gen, device=cuda,
                        requires_grad=True)
    qd = torch.randn((1, 2, 2, 64), generator=gen, device=cuda)
    valid = torch.ones((1, 32), dtype=torch.bool, device=cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        decode_attention_kernel(qd, cache, cache, valid)
    before = sum(flash_attention_kernel.launches.values())
    out = L._attend(qg, k, v, True, 0, "kernel")
    assert out.grad_fn is not None
    assert sum(flash_attention_kernel.launches.values()) == before + 1
    (g,) = torch.autograd.grad(out.float().sum(), [qg])
    assert bool(torch.isfinite(g.float()).all())
