"""CPU checks of ``chip_smoke.py``'s helpers that the timing tools share.

``tools/fused_ab.py``, ``tools/fused_phases.py`` and
``tools/residual_ab.py`` capture a block's kernel operands with
``chip_smoke.run_plain`` driven by a kernel, which updates its operands
in place; the captured operands must still be the block's own, as they
were before its update.
"""
from __future__ import annotations

import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.streams import bounded_stream
from repro_torch.kernels.sketch_update.ref import fused_update_ref
from repro_torch.sketch.api import SketchSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_place(ids, counts, errors, *prep, variant):
    """``fused_update_ref`` written back into its operands, as kernel 1
    updates them."""
    for t, new in zip((ids, counts, errors),
                      fused_update_ref(ids, counts, errors, *prep,
                                       variant=variant)):
        t.copy_(new)
    return ids, counts, errors


@pytest.mark.parametrize("variant", ["sspm", "lazy"])
@pytest.mark.parametrize("at", [1, -1])
def test_run_plain_captures_the_operands_before_the_update(monkeypatch,
                                                           variant, at):
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    spec = SketchSpec(kind="frequency", eps=0.05, alpha=2.0, variant=variant,
                      shards=4, bits=12, backend="kernel")
    stream = bounded_stream(600, 0.5, universe=1 << 12, seed=3)
    cpu = torch.device("cpu")
    want_bank, (want_st, want_args), _ = cs.run_plain(
        spec, stream, 256, cpu, cs.fused_path, fused_update_ref, at)
    bank, (st, args), _ = cs.run_plain(spec, stream, 256, cpu, cs.fused_path,
                                       _in_place, at)
    assert all(torch.equal(a, b) for a, b in zip(want_bank, bank))
    assert all(torch.equal(a, b) for a, b in zip(want_st, st))
    assert all(torch.equal(a, b) for a, b in zip(want_args, args))
    # the captured state is the one the block's update starts from
    out = fused_update_ref(*st, *args, variant=spec.variant_id)
    assert not all(torch.equal(a, b) for a, b in zip(out, st))


# -- the ingest pipeline's phases, rehearsed on the CPU at a small size ---

BLOCK = 256


def _on_the_cpu(monkeypatch, cs):
    """chip_smoke's card-only calls made harmless on the CPU, and its
    launch check recorded instead of made (no kernel runs here)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    checked = []
    monkeypatch.setattr(cs, "check_launches",
                        lambda label, counts, name, blocks, layout=None:
                        checked.append((label, name, blocks, layout)) or
                        blocks)
    return checked


def _small_main():
    return SketchSpec(kind="frequency", eps=0.02, alpha=2.0, variant="sspm",
                      shards=4, bits=12, backend="kernel")


def test_run_path_rehearsal(monkeypatch):
    """The session run times its first block apart and returns the
    session; its bank is the plain run's."""
    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    stream = bounded_stream(1500, 0.5, universe=1 << 12, seed=4)
    out, _, sess = cs.run_path("main", _small_main(), stream, BLOCK,
                               torch.device("cpu"), 2.0,
                               "sketch_update_kernel_fused", cs.fused_path,
                               fused_update_ref, layout="staged")
    n = len(cs.padded_blocks(stream, BLOCK)[0])
    assert sess.blocks_ingested == n == out["blocks"]
    assert checked == [("main", "sketch_update_kernel_fused", n, "staged")]
    assert {"first_block_ms", "first_block_reserved_mb",
            "validate_ms_per_block"} <= set(out)


def test_feeder_phase_rehearsal(monkeypatch):
    """Feeder at depth 1 and 2 and the stream entry each give the main
    run's bank, with one staged kernel-1 launch a block checked; a bank
    that differs is fatal."""
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    spec, cpu = _small_main(), torch.device("cpu")
    stream = bounded_stream(1500, 0.5, universe=1 << 12, seed=5)
    main = StreamSession(spec, block=BLOCK, device=cpu)
    main.ingest(stream[:, 0], stream[:, 1])
    runs = cs.feeder_phase(spec, stream, BLOCK, cpu, main.state.bank)
    n = len(cs.padded_blocks(stream, BLOCK)[0])
    assert set(runs) == {"feeder depth=1", "feeder depth=2",
                         "sketch_block_update_stream"}
    assert [c[1:] for c in checked] == \
        [("sketch_update_kernel_fused", n, "staged")] * 3
    wrong = main.state.bank._replace(counts=main.state.bank.counts + 1)
    with pytest.raises(SystemExit, match="differs"):
        cs.feeder_phase(spec, stream, BLOCK, cpu, wrong)


def test_merge_phase_rehearsal(monkeypatch):
    """Merge on the device equals merge on the CPU copies, the merged bank
    holds the summed bound over both streams, and consolidated() equals
    the CPU consolidate."""
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    _on_the_cpu(monkeypatch, cs)
    spec, cpu = _small_main(), torch.device("cpu")
    main_stream = bounded_stream(1500, 0.5, universe=1 << 12, seed=6)
    other = bounded_stream(600, 0.5, universe=1 << 12, seed=7)
    main = StreamSession(spec, block=BLOCK, device=cpu)
    main.ingest(main_stream[:, 0], main_stream[:, 1])
    out = cs.merge_phase(spec, main, other, BLOCK, cpu, main_stream)
    assert out["merged_worst_err_over_bound"] <= 1.0
    assert out["consolidated_live"] > 0


def test_host_cuda_ms_sums_the_launch_calls():
    cs = _chip_smoke()

    class Event:
        def __init__(self, key, us):
            self.key, self.self_cpu_time_total = key, us

    events = [Event("cudaLaunchKernel", 800.0), Event("cudaGraphLaunch", 40.0),
              Event("cudaMemcpyAsync", 120.0), Event("aten::sort", 900.0),
              Event("cudaStreamSynchronize", 0.0)]
    got = cs.host_cuda_ms(events, 4)
    assert got["launch"] == pytest.approx((800 + 40) / 1e3 / 4)
    assert list(got["calls"]) == ["cudaLaunchKernel", "cudaMemcpyAsync",
                                  "cudaGraphLaunch"]
