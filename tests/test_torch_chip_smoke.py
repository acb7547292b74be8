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

from repro_torch.core.streams import zipf_interleaved_stream
from repro_torch.kernels.sketch_update.ref import fused_update_ref
from repro_torch.sketch.api import SketchSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _written_back(plain, wrapper):
    """``plain`` written back into its state operands, as the kernel
    ``wrapper`` updates them in place, with a counter like the wrapper's."""
    def run(ids, counts, errors, *args, variant, **kw):
        for t, out in zip((ids, counts, errors),
                          plain(ids, counts, errors, *args, variant=variant,
                                **kw)):
            t.copy_(out)
        return ids, counts, errors
    run.launches = (dict(wrapper.launches)
                    if isinstance(wrapper.launches, dict) else 0)
    return run


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
    stream = zipf_interleaved_stream(600, 0.5, universe=1 << 12, seed=3)
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
    stream = zipf_interleaved_stream(1500, 0.5, universe=1 << 12, seed=4)
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
    stream = zipf_interleaved_stream(1500, 0.5, universe=1 << 12, seed=5)
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
    main_stream = zipf_interleaved_stream(1500, 0.5, universe=1 << 12, seed=6)
    other = zipf_interleaved_stream(600, 0.5, universe=1 << 12, seed=7)
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


# -- the quantile phase's checks ------------------------------------------

def _small_quantile_specs():
    import dataclasses

    sspm = SketchSpec(kind="quantile", bits=10, eps=0.1, alpha=2.0,
                      variant="sspm", backend="kernel")
    return dict(sspm=sspm,
                lazy=dataclasses.replace(sspm, eps=0.2, variant="lazy"),
                block=dataclasses.replace(sspm, backend="block"),
                bank=dataclasses.replace(sspm, backend="bank"),
                sharded=dataclasses.replace(sspm, shards=3, backend="bank"))


def test_quantile_specs_are_the_papers_sizing():
    cs = _chip_smoke()
    specs = cs.quantile_specs()
    caps = specs["sspm"].layer_capacities()
    assert (len(caps), max(caps), sum(caps)) == (24, 96000, 899070)
    assert max(specs["lazy"].layer_capacities()) == 9600
    assert specs["sharded"].shards == 8
    assert {s.backend for s in specs.values()} == {"kernel", "block", "bank"}


def test_exact_ranks_and_the_rank_grid():
    import numpy as np

    cs = _chip_smoke()
    stream = np.array([[3, 1], [3, 1], [5, 1], [3, -1], [0, 1], [7, 1],
                       [5, -1]])
    cum = cs.exact_ranks(stream, 3)
    # final multiset {0, 3, 7}
    np.testing.assert_array_equal(cum, [1, 1, 1, 2, 2, 2, 2, 3])
    xs = cs.rank_grid(cum, n=7)
    assert len(xs) == 7 and xs[0] == 0 and xs[-1] == 7
    # the live values' quantiles: smallest x with rank(x) >= q·|F|
    np.testing.assert_array_equal(xs[1:-1], [0, 0, 3, 7, 7])


def test_rank_check_rejects_a_planted_fault():
    import numpy as np

    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    stream = np.stack([rng.integers(0, 256, 4000),
                       np.ones(4000, np.int64)], axis=1)
    cum = cs.exact_ranks(stream, 8)
    xs = cs.rank_grid(cum, n=101)
    eps = 0.01
    exact = cum[xs]
    assert cs.check_ranks("exact", exact, xs, cum, eps) == 0.0
    near = exact + int(eps * 4000)                        # at the bound
    assert cs.check_ranks("near", near, xs, cum, eps) == 1.0
    planted = exact.copy()
    planted[50] += int(eps * 4000) + 1
    with pytest.raises(SystemExit, match="off by 41"):
        cs.check_ranks("planted", planted, xs, cum, eps)
    planted = exact.copy()
    planted[0] -= 41
    with pytest.raises(SystemExit):
        cs.check_ranks("planted", planted, xs, cum, eps)


def test_quantile_check_holds_the_float32_target():
    import numpy as np

    cs = _chip_smoke()
    stream = np.stack([np.repeat(np.arange(100), 10),
                       np.ones(1000, np.int64)], axis=1)
    cum = cs.exact_ranks(stream, 7)
    qs = cs.QUANTILE_QS
    exact = [int(np.searchsorted(cum, q * 1000)) for q in qs]
    cs.check_quantiles("exact", exact, qs, cum, 0.01)
    wrong = list(exact)
    wrong[50] += 2                                         # 20 ranks off
    with pytest.raises(SystemExit, match=r"quantile\(0.5\)"):
        cs.check_quantiles("wrong", wrong, qs, cum, 0.01)


@pytest.mark.parametrize("variant", [2, 1])
def test_check_layers_uses_each_rows_capacity(variant):
    """The per-layer bound holds with each layer's own live capacity and
    fails when a bank is off by more than it; the sharded form reads
    owner rows."""
    import numpy as np

    from repro_torch.sketch import api

    cs = _chip_smoke()
    specs = _small_quantile_specs()
    cpu = torch.device("cpu")
    stream = zipf_interleaved_stream(3000, 0.5, universe=1 << 10, seed=9)
    for name in ("sspm", "sharded"):
        spec = specs[name]
        state = api.make(spec, cpu)
        for lo in range(0, len(stream), 512):
            part = stream[lo:lo + 512]
            state = api.update(spec, state, part[:, 0], part[:, 1])
        bank = cs._bank_of(state)
        factor = 2.0 if variant == 2 else 1.0
        ratio, n_hot = cs.check_layers(spec, bank, stream, cpu, factor)
        assert 0.0 <= ratio <= 1.0 and n_hot > 0
        # layer 0's capacity sets its bound: a count raised past it fails
        ins = int((stream[:, 1] > 0).sum())
        bound0 = factor * ins / spec.layer_capacities()[0]
        live = int(np.flatnonzero(bank.ids[0].numpy() >= 0)[0])
        off = bank.counts.clone()
        off[0, live] += int(bound0) + 2
        with pytest.raises(SystemExit, match="layer 0"):
            cs.check_layers(spec, bank._replace(counts=off), stream, cpu,
                            factor)
    # a node monitored twice in a row is refused
    dup = bank.ids.clone()
    dup[0, :2] = dup[0, 2]
    with pytest.raises(SystemExit, match="two slots"):
        cs.check_layers(spec, bank._replace(ids=dup), stream, cpu, 2.0)


def test_quantile_phase_rehearsal(monkeypatch):
    """The quantile runs at a small size: each launch check recorded on
    its layout, every run's bank checked against the plain versions and
    the others, the queries and the merge phase."""
    from repro_torch.kernels.sketch_update import kernel, ref

    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    # the block and bank runs drive their kernel over the first blocks:
    # here its plain version, written back in place as the kernel does
    for name, plain in (("sketch_residual_kernel", ref.residual_phase),
                        ("sketch_residual_kernel_banked",
                         ref.residual_phase_banked)):
        monkeypatch.setattr(kernel, name,
                            _written_back(plain, getattr(kernel, name)))
    monkeypatch.setattr(cs, "QUANTILE_BLOCKS", 6)
    monkeypatch.setattr(cs, "QUANTILE_LAZY_BLOCKS", 4)
    monkeypatch.setattr(cs, "QUANTILE_SHARDED_BLOCKS", 3)

    def stream(n, seed):
        return zipf_interleaved_stream(n * BLOCK * 2 // 3, 0.5,
                                       universe=1 << 10, skew=1.0, seed=seed)

    streams = dict(main=stream(7, 1), lazy=stream(5, 2))
    streams["sharded"] = streams["main"]
    runs, extra, finals = cs.quantile_phase(
        _small_quantile_specs(), streams, BLOCK, torch.device("cpu"), hold=3)
    assert [(c[1], c[2]) for c in checked] == [
        ("sketch_update_kernel_fused", 6), ("sketch_update_kernel_fused", 4),
        ("sketch_residual_kernel", 6), ("sketch_residual_kernel_banked", 6),
        ("sketch_residual_kernel_banked", 3),
        ("sketch_update_kernel_fused", 6)]
    assert [r["plain_blocks"] for r in runs.values()] == [6, 4, 3, 3, 3]
    assert {"queries sspm", "queries lazy", "queries sharded",
            "quantile stream", "quantile merge"} == set(extra)
    assert extra["queries sspm"]["points"] == cs.RANK_POINTS
    for name, (bank, (items, weights)) in finals.items():
        assert items.shape == (1, BLOCK), name


def test_bank_phase_rehearsal(monkeypatch):
    """The bank phase at a small size: the three bank runs (each equal to
    its twin's bank and held to the plain version, lazy and path A's
    over their first blocks), the serial api run, the sharded serial
    oracle against the bank path and the quantile serial path against
    the quantile bank path, each launch check recorded on its kernel,
    count and layout; a bank that differs from its twin is fatal."""
    import dataclasses

    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    for name, plain in (("sketch_update_kernel_fused", ref.fused_update_ref),
                        ("sketch_update_kernel_serial",
                         ref.serial_update_ref)):
        monkeypatch.setattr(kernel, name,
                            _written_back(plain, getattr(kernel, name)))
    monkeypatch.setattr(cs, "BANK_LAZY_PLAIN_BLOCKS", 2)
    monkeypatch.setattr(cs, "BANK_A_PLAIN_BLOCKS", 2)
    monkeypatch.setattr(cs, "SERIAL_API_PLAIN_BLOCKS", 1)
    cpu = torch.device("cpu")
    main = _small_main()
    specs = dict(main=main,
                 lazy=SketchSpec(eps=0.05, alpha=2.0, variant="lazy",
                                 bits=12, backend="kernel"),
                 a=dataclasses.replace(main, shards=None, backend="block"),
                 serial=dataclasses.replace(main, shards=None,
                                            backend="serial"))
    streams = {name: zipf_interleaved_stream(700, 0.5, universe=1 << 12,
                                             seed=seed)
               for seed, name in enumerate(("main", "lazy", "a", "serial"))}
    twins = {}
    for name in ("main", "lazy", "a"):
        sess = StreamSession(specs[name], block=BLOCK, device=cpu)
        sess.ingest(streams[name][:, 0], streams[name][:, 1])
        twins[name] = cs._bank_of(sess.state)
    runs, last = cs.bank_phase(specs, streams, twins, BLOCK, cpu)
    n = len(cs.padded_blocks(streams["main"], BLOCK)[0])
    q = SketchSpec(kind="quantile", bits=12, eps=1e-3, alpha=2.0)
    nq = len(cs.padded_blocks(zipf_interleaved_stream(
        cs.SERIAL_QUANTILE_BLOCKS * BLOCK * 2 // 3, 0.5, universe=1 << 12,
        skew=1.0, seed=9), BLOCK)[0])
    assert [c[1:] for c in checked] == [
        ("sketch_update_kernel_fused", n, "staged"),
        ("sketch_update_kernel_fused", n, "staged"),
        ("sketch_update_kernel_fused", n, "staged"),
        ("sketch_update_kernel_serial", n, None),
        ("sketch_residual_kernel", 8 * cs.SERIAL_SHARDED_BLOCKS, "staged"),
        ("sketch_update_kernel_fused", cs.SERIAL_SHARDED_BLOCKS, "staged"),
        ("sketch_update_kernel_serial", 12 * nq, None),
        ("sketch_residual_kernel_banked", nq, "staged")]
    assert [runs[k]["plain_blocks"] for k in ("bank main", "bank lazy",
                                               "bank a", "serial api")] \
        == [n, 2, 2, 1]
    assert set(last) == {"bank main", "bank lazy", "bank a"}
    assert len(last["bank main"][1]) == 8       # the partition prep
    assert max(q.layer_capacities()) == 4096
    twins["lazy"] = twins["lazy"]._replace(counts=twins["lazy"].counts + 1)
    with pytest.raises(SystemExit, match="twin"):
        cs.bank_phase(specs, streams, twins, BLOCK, cpu)


# -- the multi-tenant serving phase, rehearsed at a small size ------------

def test_tenant_phase_rehearsal(monkeypatch):
    """The tenant phase at a small size: the service bench at both delete
    ratios, the fleet (spill, save and load, subscriptions, the twin, the
    oracle rows), quantile mode, the shared cell and the trackers, each
    launch check recorded on its kernel and count; then the service
    profiles it leaves for later."""
    from repro_torch.kernels.sketch_update import kernel, ref

    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    monkeypatch.setattr(kernel, "sketch_update_kernel_fused",
                        _written_back(ref.fused_update_ref,
                                      kernel.sketch_update_kernel_fused))
    monkeypatch.setattr(cs, "batched_query_ms", lambda *a, **k: 1.0)
    monkeypatch.setattr(cs, "TENANT_BENCH", dict(
        tenants=16, k=8, bits=8, block=256, updates=3000, ratios=(0.0, 0.5),
        oracle_rows=4, twins=4, profile=dict(warm=2, ticks=3)))
    monkeypatch.setattr(cs, "TENANT_FLEET", dict(
        tenants=64, k=8, bits=8, block=256, updates=6000, ratio=0.5,
        window=3, spill_after=4, subscribers=8, m=4, point_queries=64,
        plain_blocks=2, oracle_rows=6, not_strict_rows=2,
        profile=dict(warm=4, ticks=4)))
    monkeypatch.setattr(cs, "TENANT_QUANTILE", dict(
        bits=12, tenant_bits=3, eps=0.02, block=256, updates=4000,
        subscribers=4, every=4, qs=(0.1, 0.5, 0.9)))
    monkeypatch.setattr(cs, "TENANT_STATS", dict(
        vocab=4096, capacity=256, window=4, steps=10, tokens=2048,
        experts=16, top=4, phi=0.125))
    runs, operands, later = cs.tenant_phase(torch.device("cpu"))
    assert [label for label, _ in later] == [
        "service bench delete=0.0", "service bench delete=0.5",
        "service fleet twin", "service fleet"]
    cs.service_profiles(later, runs)
    for label, _ in later:
        prof = runs[label]["profile"]
        assert prof["blocks"] > 0 and prof["wall_ms_per_block"] > 0
        assert prof["device_busy_ms_per_block"] is None   # no card here
    assert set(runs) == {
        "service bench delete=0.0", "service bench delete=0.5",
        "service fleet", "service fleet twin", "service quantile",
        "shared cell", "stats tokens", "stats experts",
        "stats experts capacity=64"}
    kernels = [c[1] for c in checked]
    assert kernels.count("sketch_residual_kernel_banked") == 1
    assert kernels.count("sketch_update_kernel_fused") == len(checked) - 1
    for rec in runs.values():
        assert rec["launches"] == rec["blocks"] > 0
    fleet = runs["service fleet"]
    assert fleet["spills"] > 0 and fleet["admits"] > 0
    assert fleet["never_spilled"] + fleet["spilled_untouched"] \
        + fleet["readmitted"] <= 64
    assert runs["service fleet twin"]["oracle_updates"] > 0
    assert runs["service bench delete=0.5"]["twins"]["tenants"] == 4
    st, args = operands["fleet"]
    assert st[0].shape == (64, 128) and len(args) == 8
    assert operands["bench"][0][0].shape == (16, 128)


def test_tenant_checks_reject_a_planted_fault(monkeypatch):
    """The service bench's plain-version check, the twins and the Thm 4
    check each refuse a bank with one count changed."""
    import numpy as np

    from repro_torch.kernels.sketch_update import ref
    from repro_torch.serve import SketchService
    from repro_torch.sketch import tenant as tn

    cs = _chip_smoke()
    _on_the_cpu(monkeypatch, cs)
    cpu = torch.device("cpu")
    spec = cs.tenant_spec(16, 8, 8)
    svc = SketchService(spec, block=256, device=cpu)
    svc.trace_blocks = []
    _, tickets, at = cs.replay(svc, cs.traffic(16, 3000, 0.5, 8, seed=2),
                               256)
    bank = svc.session.state.bank
    want, _ = cs.replay_blocks(spec, svc.trace_blocks, cpu,
                               ref.fused_update_ref)
    assert cs._same(want, bank)
    live = np.flatnonzero(bank.ids[0].numpy() >= 0)[0]
    counts = bank.counts.clone()
    counts[0, live] += 1000
    wrong = bank._replace(counts=counts)
    assert not cs._same(want, wrong)
    with pytest.raises(SystemExit, match="bound"):
        cs.check_tenant_truth("planted", spec, svc.trace_blocks, wrong, cpu)
    with pytest.raises(SystemExit, match="independent"):
        cs.check_twins("planted", spec, svc.trace_blocks,
                       tn.TenantBank(bank=wrong), [0], cpu)
    with pytest.raises(SystemExit, match="oracle"):
        cs.check_oracle_rows("planted", spec, svc.trace_blocks, wrong, [0],
                             cpu)
    held = np.ones(bank.ids.shape[0], bool)
    rec = cs.check_ticket_bounds("planted", spec, svc.trace_blocks, bank,
                                 tickets, at, held, cpu)
    assert rec["ticket_ids_held"] == sum(len(t.items) for t in tickets) > 0
    tickets[0]._value = tickets[0]._value + 1000
    with pytest.raises(SystemExit, match="bound"):
        cs.check_ticket_bounds("planted", spec, svc.trace_blocks, bank,
                               tickets, at, held, cpu)


def test_before_reads_each_groups_running_total():
    """``_before``: a group's total over the blocks before the asked one,
    0 for a group with no entry there."""
    import numpy as np

    cs = _chip_smoke()
    groups = np.array([7, 3, 7, 3, 7], np.int64)
    bidx = np.array([0, 0, 1, 2, 2])
    vals = np.array([5, 1, -2, 4, 10], np.int64)
    q_groups = np.array([7, 7, 7, 7, 3, 3, 3, 9])
    q_at = np.array([0, 1, 2, 3, 1, 2, 3, 3])
    np.testing.assert_array_equal(
        cs._before(groups, bidx, vals, 3, q_groups, q_at),
        [0, 5, 3, 13, 1, 1, 5, 0])


def test_strict_keys_follow_each_key_block_by_block():
    """A key's running count is taken block by block (a block's entries
    act aggregated): a deletion before its insertion inside one block is
    strict, a deletion in an earlier block than its insertion is not."""
    import numpy as np

    cs = _chip_smoke()
    blocks = [(np.array([5, 7, 9, 9, 3], np.int32),
               np.array([2, -1, -1, 1, 0], np.int32)),
              (np.array([5, 7, 3], np.int32),
               np.array([-1, 1, 4], np.int32))]
    keys, net, pos, strict = cs.strict_keys(blocks)
    np.testing.assert_array_equal(keys, [3, 5, 7, 9])
    np.testing.assert_array_equal(net, [4, 1, 0, 0])
    np.testing.assert_array_equal(pos, [4, 2, 1, 1])
    np.testing.assert_array_equal(strict, [True, True, False, True])


# -- the family and fault phases' checks ----------------------------------

def test_double_truth_and_the_sampled_rows(monkeypatch):
    """``check_double_truth`` holds a Double session to the family bound
    and rejects a bank with a count moved; the unbiased kernel's operands
    cut to sampled rows give, through the plain version, those rows of
    the whole bank's update."""
    from repro_torch.kernels.sketch_update.ref import unbiased_update_ref
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cpu = torch.device("cpu")
    spec = SketchSpec(eps=0.02, alpha=2.0, shards=4, bits=12,
                      variant="double")
    stream = zipf_interleaved_stream(1500, 0.5, universe=1 << 12, seed=8)
    sess = StreamSession(spec, block=BLOCK, device=cpu)
    sess.ingest(stream[:, 0], stream[:, 1])
    out = cs.check_double_truth("double", spec, sess.state, stream, cpu)
    assert out["worst_err_over_slack"] <= 1.0 and out["ids_above_slack"]
    live = sess.state.ins.ids >= 0
    bad = sess.state._replace(ins=sess.state.ins._replace(
        counts=torch.where(live, sess.state.ins.counts - 50,
                           sess.state.ins.counts)))
    with pytest.raises(SystemExit):
        cs.check_double_truth("double", spec, bad, stream, cpu)
    uspec = SketchSpec(eps=0.02, alpha=2.0, shards=5, bits=12,
                       variant="unbiased")
    blocks = cs._blocks(stream, BLOCK)
    _, kept = cs.unbiased_replay(uspec, blocks, cpu, unbiased_update_ref,
                                 keep={2})
    st, args = kept[2]
    whole = unbiased_update_ref(*st, *args)
    rows = [0, 3, 4]
    sub = unbiased_update_ref(*cs.sampled_rows(st, args, rows)[0],
                              *cs.sampled_rows(st, args, rows)[1])
    for a, b in zip(sub, whole):
        assert torch.equal(a, b[rows])


def test_row_alone_is_the_row_of_the_whole_bank():
    """Each row of a sharded bank, rebuilt on the CPU from the entries it
    owns alone (``row_fragments`` padded with no-ops, ``row_alone``),
    equals the row of the session that ingested the whole blocks."""
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    spec = SketchSpec(eps=0.05, alpha=2.0, shards=8, bits=12)
    stream = cs.make_stream(12, BLOCK, seed=3, bits=12)
    blocks = cs._blocks(stream, BLOCK)
    sess = StreamSession(spec, block=BLOCK, device="cpu")
    for items, weights in blocks:
        sess.ingest_block(items, weights)
    for r in range(spec.shards):
        alone = cs.row_alone(spec, cs.row_fragments(spec, blocks, r, BLOCK),
                             r)
        for t, a in zip(sess.state.bank, alone):
            assert torch.equal(t[r], a), r


def test_fault_phase_rehearsal(monkeypatch):
    """The fault phase at a small size: the plan's corrupted rows flagged,
    recovery equal to the never-failed twin, the straggler flagged, the
    resizes within their bounds; a recovery that restores nothing is
    fatal."""
    from repro_torch.sketch import elastic

    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(cs, "fault_spec", lambda: SketchSpec(
        eps=0.05, alpha=2.0, shards=8, bits=12))
    monkeypatch.setattr(cs, "FAULTS", dict(
        blocks=12, seed=7, n_faults=8, straggler_blocks=14,
        straggler_row=5, reshard=(6, 1), dyadic_shards=2, dyadic_blocks=2,
        row_pad=BLOCK))
    cpu = torch.device("cpu")
    q_spec = SketchSpec(kind="quantile", bits=12, eps=0.1, alpha=2.0,
                        shards=3)
    stream = cs.make_stream(16, BLOCK, seed=1, bits=12)
    out = cs.fault_phase(cpu, stream, BLOCK, q_spec)
    assert out["faults"]["replayed_blocks"] == 12
    assert set(out["faults"]["flagged_untouched"]) <= set(
        out["faults"]["twin_flagged"])
    assert 5 in out["straggler"]["flagged"]
    assert [r["new_shards"] for r in out["reshard"]] == [6, 1]
    assert out["reshard"][-1]["dropped"] == 0
    assert out["reshard_dyadic"]["new_shards"] == 2
    monkeypatch.setattr(elastic, "recover_session",
                        lambda sess, ckpt, rows=None: elastic.RecoveryReport(
                            rows=(), replayed_blocks=0, seconds=0.0))
    with pytest.raises(SystemExit, match="recovery"):
        cs.fault_phase(cpu, stream, BLOCK, q_spec)


# -- the model phase, rehearsed on the CPU at smoke width -----------------

# the smoke configs at sizes their layers take: Gemma3's smoke model (7
# layers: 5 local of window 16, 2 global, a 32-slot SS± budget) serves
# 32-token prompts, which fill its SS± cache; the others serve 32 tokens
# (multiples of their windows and SSD chunks)
SMOKE_MAIN = dict(arch="gemma3_27b", batch=2, prompt=32, new_tokens=6,
                  context=128, decay_period=4, seed=3, heavy=4)
SMOKE_STEPWISE = dict(batch=2, prompt=16, context=64, seed=4)
SMOKE_PLANTED = dict(batch=2, slots=256, kv=2, g=2, hd=16, steps=20,
                     decay_period=4, heavy=(3, 200), seed=5)


def _smoke_others():
    from repro_torch import configs

    return {arch: (32 - configs.get_smoke(arch).vision_tokens,
                   128 if arch == "zamba2_7b" else 64)
            for arch in configs.ARCH_IDS if arch != "gemma3_27b"}


def _kernels_as_plain(monkeypatch, flash_fault=None, decode_fault=None):
    """The model layers' attention dispatch on CPU tensors with the kernel
    wrappers' counters: under ``attention="kernel"`` each call counts one
    launch of its kernel (flash on the wgmma path) and runs the kernel's
    plain version, with ``flash_fault`` (``decode_fault``: on (ctx,
    mass)) applied to its output where given; ``"plain"`` calls the plain
    versions through the layers' names, as on the card."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models import layers as L

    def attend(q, k, v, causal, window, attention):
        if attention == "kernel":
            fa.flash_attention_kernel.launches["wgmma"] += 1
            out = fref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            return flash_fault(out) if flash_fault else out
        return L.flash_attention_ref(q, k, v, causal=causal, window=window)

    def decode_attend(q, k, v, valid, attention="kernel"):
        if attention == "kernel":
            da.decode_attention_kernel.launches += 1
            out = dref.decode_attention_ref(q, k, v, valid)
            return decode_fault(*out) if decode_fault else out
        return L.decode_attention_ref(q, k, v, valid)

    # the layers' local functions: what a mesh run calls on each rank's
    # shards, and every call without a mesh
    monkeypatch.setattr(L, "_attend_local", attend)
    monkeypatch.setattr(L, "_decode_attend_local", decode_attend)


def test_model_phase_rehearsal(monkeypatch):
    """The model phase end to end at smoke width: the main run's launch
    counts by mask (5 windowed, 2 causal prefill calls; 7 decode calls a
    step), its twin, the SS± invariants of a full cache, the stepwise
    invariant and the nine other configs with their twins."""
    from repro_torch import configs
    from repro_torch.serve import kv_cache

    cs = _chip_smoke()
    monkeypatch.setattr(kv_cache, "HH_ENGAGE_CTX", 32)  # SS± at smoke size
    _kernels_as_plain(monkeypatch)
    launches, summary = cs.model_phase(
        torch.device("cpu"), get=configs.get_smoke, main=SMOKE_MAIN,
        stepwise=SMOKE_STEPWISE, others=_smoke_others(), other_tokens=2,
        planted=SMOKE_PLANTED, timed=False)
    main = summary["main"]
    assert main["flash_by_mask"] == dict(windowed=5, causal=2, unmasked=0)
    assert main["decode_launches"] == 7 * SMOKE_MAIN["new_tokens"]
    assert main["logit_row_share"] == 0.0      # the same plain version
    assert main["hh"]["live"] == 2 * 32 and main["hh"]["overlap"] == [1.0, 1.0]
    assert main["hh"]["decode_positions_resident"] >= 1
    assert summary["stepwise"]["decode_launches"] == 7 * (16 + 2)
    assert summary["stepwise"]["plain"]["next_tokens"] == \
        summary["stepwise"]["kernel"]["next_tokens"]
    planted = main["hh_planted"]
    assert planted["launches"] == 20 and min(planted["heavy_count"]) > 0
    others = summary["others"]
    assert set(others) == set(_smoke_others())
    assert others["mamba2_780m"]["flash_launches"] == 0
    assert others["whisper_medium"]["flash_by_mask"] == dict(
        windowed=0, causal=2, unmasked=4)
    assert "hh" in others["zamba2_7b"]
    assert launches["flash"]["wgmma"] == sum(
        r["flash_launches"] for r in [main, *others.values()]) + 7
    assert launches["decode"]["hh planted"] == 20
    # kernels 5 and 6 held to the plain versions at every kept shape
    assert set(main["kernels_vs_plain"]) == {
        "windowed S=32 T=32", "causal S=32 T=32", "decode C=16",
        "decode C=32"}
    assert set(summary["stepwise"]["kernel"]["kernels_vs_plain"]) == {
        "windowed S=16 T=16", "causal S=16 T=16", "decode C=16",
        "decode C=32"}
    assert "unmasked S=32 T=32" in others["whisper_medium"]["kernels_vs_plain"]
    held = summary["kernels_vs_plain"]
    assert held["shapes"]["flash"] >= 4 and held["shapes"]["decode"] >= 4
    assert held["row_share"] == dict(flash=0.0, decode=0.0)


def test_model_phase_rejects_a_planted_fault(monkeypatch):
    """A kernel-5 stand-in whose output has two heads swapped fails the
    logit check against the plain twin."""
    from repro_torch import configs
    from repro_torch.serve import kv_cache

    cs = _chip_smoke()
    monkeypatch.setattr(kv_cache, "HH_ENGAGE_CTX", 32)
    _kernels_as_plain(monkeypatch,
                      flash_fault=lambda out: out[:, :, [1, 0, 2, 3]])
    with pytest.raises(SystemExit, match="logit"):
        cs.model_phase(torch.device("cpu"), get=configs.get_smoke,
                       main=SMOKE_MAIN, stepwise=SMOKE_STEPWISE, others={},
                       planted=SMOKE_PLANTED, timed=False)


def _one_row(t, b, row):
    """``t`` with request ``b``'s row ``row`` (a query or a cache slot)
    negated: a fault in one row, which a run's own logits need not see."""
    t = t.clone()
    t[b, row] = -t[b, row]
    return t


@pytest.mark.parametrize("fault", [None, "flash", "decode ctx",
                                   "decode mass"])
def test_hold_kept_rejects_a_fault_in_one_row(monkeypatch, fault):
    """``hold_kept`` holds each kept kernel-5 and kernel-6 operand set to
    the plain versions: a stand-in kernel right everywhere but in one row
    of request 1 (a query row of flash, a kv-head's ctx or one slot's
    mass of decode) is rejected, and the right one passes with every
    planted fault rejected."""
    cs = _chip_smoke()
    _kernels_as_plain(
        monkeypatch,
        flash_fault=(lambda out: _one_row(out, 1, 3)) if fault == "flash"
        else None,
        decode_fault={"decode ctx": lambda ctx, m: (_one_row(ctx, 1, 1), m),
                      "decode mass": lambda ctx, m: (ctx, _one_row(m, 1, 5)),
                      }.get(fault))
    gen = torch.Generator().manual_seed(9)
    bf16 = torch.bfloat16
    r = lambda *shape: torch.randn(shape, generator=gen).to(bf16)
    q, k, v = r(2, 32, 4, 16), r(2, 32, 2, 16), r(2, 32, 2, 16)
    valid = torch.rand((2, 64), generator=gen) < 0.8
    operands = {"causal S=32 T=32": (q, k, v, True, 0),
                "windowed S=32 T=32": (q, k, v, True, 8),
                "decode C=64": (r(2, 2, 2, 16), r(2, 64, 2, 16),
                                r(2, 64, 2, 16), valid)}
    if fault is None:
        held = cs.hold_kept("smoke", operands)
        assert set(held) == set(operands)
        for rec in held.values():
            assert rec["row_share"] == 0.0
            assert set(rec["planted_row_shares"]) >= {"wrong kv-head"}
            assert min(rec["planted_row_shares"].values()) > cs.ROW_SHARE
        return
    with pytest.raises(SystemExit, match="kernel vs plain"):
        cs.hold_kept("smoke", operands)


SMOKE_TRAIN = dict(arch="qwen3_0_6b", seq_len=32, batch=4, steps=8,
                   warmup=2, seed=25, loss_falls=True)
SMOKE_TRAIN_MOE = dict(arch="olmoe_1b_7b", layers=2, seq_len=32, batch=4,
                       steps=3, seed=26)


def _train_on_the_cpu(monkeypatch, cs, flash_fault=None):
    """The train phase's card-only parts on the CPU: kernel 5 as its plain
    version with the wrapper's counter (``_kernels_as_plain``; under
    ``FlashAttentionFn`` too), and the launch check recorded instead of
    made for kernel 1, whose plain version counts nothing here."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    _kernels_as_plain(monkeypatch, flash_fault=flash_fault)
    monkeypatch.setattr(fops, "flash_attention_kernel",
                        lambda q, k, v, causal, window:
                        fref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    checked = []

    def check(label, counts, flash, fused, spy):
        got = sum(n for k, n in counts.items()
                  if k.startswith(cs.FLASH + "["))
        checked.append((label, flash, fused, got, dict(spy.plain)))
        return {"wgmma": got}, {"staged": fused}

    monkeypatch.setattr(cs, "check_train_launches", check)
    return checked


def test_train_phase_rehearsal(monkeypatch):
    """The train phase end to end at smoke width on the CPU: the main run
    (the twin step, the counted run: two kernel-5 calls a layer a step
    with remat, the loss falling, the trackers against their CPU twins,
    kernel 5 and FlashAttentionFn held on the run's operands), the MoE
    run with its expert tracker, and the resume and preemption cases."""
    from repro_torch import configs

    cs = _chip_smoke()
    checked = _train_on_the_cpu(monkeypatch, cs)
    launches, summary = cs.train_phase(
        torch.device("cpu"), get=configs.get_smoke, main=SMOKE_TRAIN,
        moe=SMOKE_TRAIN_MOE, timed=False)
    main, moe = summary["main"], summary["moe"]
    assert [c[1:] for c in checked] == [
        (2 * 2 * 8, 8, 2 * 2 * 8, dict(flash=0, decode=0)),
        (2 * 2 * 3, 2 * 3, 2 * 2 * 3, dict(flash=0, decode=0))]
    assert launches == {"flash": {"wgmma": 32 + 12},
                        "fused": {"staged": 8 + 6}}
    assert main["twin"]["loss"] == main["twin"]["twin_loss"]
    assert main["twin"]["master_max_abs_err"] == 0.0
    assert set(main["kernels_vs_plain"]) == {"causal S=32 T=32"}
    assert main["flash_grads_vs_plain"]["causal S=32 T=32"][
        "max_abs_err"] == 0.0
    assert main["trackers_vs_cpu"] == ["token"]
    assert moe["trackers_vs_cpu"] == ["token", "expert"]
    assert moe["reduced"] == "depth 2 layers"
    assert summary["resume"]["bit_for_bit"]
    assert summary["resume"]["preempted_at"] == 3


def test_train_phase_rejects_a_dropped_attention_gradient(monkeypatch):
    """A kernel-5 stand-in cut from the graph (the fault a ctypes wrapper
    without FlashAttentionFn gave: no attention gradient) fails the twin
    check."""
    from repro_torch import configs

    cs = _chip_smoke()
    _train_on_the_cpu(monkeypatch, cs, flash_fault=lambda out: out.detach())
    with pytest.raises(SystemExit, match="plain twin"):
        cs.train_phase(torch.device("cpu"), get=configs.get_smoke,
                       main=SMOKE_TRAIN, moe=SMOKE_TRAIN_MOE, timed=False)


SMOKE_MESH_MODEL = dict(
    train=dict(arch="qwen3_0_6b", seq_len=32, batch=4, steps=2, seed=27),
    serve=dict(arch="gemma3_27b", batch=2, prompt=32, new_tokens=3,
               context=128, decay_period=4, seed=23))


def test_mesh_phase_rehearsal(monkeypatch):
    """The mesh phase at a small size on the CPU (gloo for the one-rank
    group too): (a)'s shard_map runs equal their twins and the CPU, the
    exchange equals its CPU twin (the smoke Qwen3's shapes), the model on
    the mesh (smoke Qwen3's Trainer on DTensor state against the one
    without a mesh, both checkpoint crossings bit for bit; smoke Gemma3's
    serving run on DTensor params, logits and SS± counts equal, kernels 5
    and 6 counted on the rank's shards), and (b)'s two child processes
    take the shard_map path and gather (a)'s bank, each run's launch
    check made once per run; a child that fails is fatal."""
    from repro_torch import configs
    from repro_torch.serve import kv_cache

    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    trained = _train_on_the_cpu(monkeypatch, cs)
    monkeypatch.setattr(kv_cache, "HH_ENGAGE_CTX", 32)  # SS± at smoke size
    monkeypatch.setattr(cs, "MESH_MODEL", SMOKE_MESH_MODEL)
    monkeypatch.setattr(cs, "MESH", dict(
        blocks=4, cpu_blocks=2, q_blocks=2, arch="qwen3_0_6b",
        smoke_arch=True, k_frac=0.01, steps=2, seed=31, ranks=2,
        child_timeout=300))
    spec = SketchSpec(eps=0.05, alpha=2.0, shards=8, bits=12)
    q_spec = SketchSpec(kind="quantile", bits=12, eps=0.1, alpha=2.0,
                        shards=4)
    stream = cs.make_stream(4, BLOCK, seed=1, bits=12)
    cpu = torch.device("cpu")
    out = cs.mesh_phase(cpu, stream, BLOCK, spec, q_spec, c=cs.MESH,
                        model=cs.MESH_MODEL, get=configs.get_smoke)
    model = out["model"]
    # 2 layers, 2 steps, remat: kernel 5 twice a layer a step, in the mesh
    # run and its twin; the token tracker's kernel 1 once a step
    assert [c[1:3] for c in trained] == [(8, 2), (8, 2)]
    assert model["launches"] == {
        "flash": {"wgmma": 8 + 7}, "decode": {"mesh (a) serve": 7 * 3},
        "fused": {"staged": 2}}
    train, serve = model["train"], model["serve"]
    assert train["runs"]["mesh"]["losses"] == train["runs"]["plain"]["losses"]
    assert train["restores"] == "bit for bit, both ways"
    assert set(train["kernels_vs_plain"]) == {"causal S=32 T=32"}
    assert serve["logits"] == serve["hh_counts"] == "equal"
    assert serve["mesh"]["decode_launches"] == 7 * 3
    assert {k.split()[0] for k in serve["kernels_vs_plain"]} == {
        "windowed", "causal", "decode"}
    assert set(model["max_abs_err"]) == {"flash", "decode"}
    assert set(out["runs"]) == {
        "mesh (a) sharded shard_map", "mesh (a) dyadic shard_map",
        "mesh (b) rank 0 session", "mesh (b) rank 1 session"}
    assert ("mesh (a) sharded shard_map", "sketch_residual_kernel", 4,
            "staged") in checked
    # at these sizes kernel 2's rows fit its staged layout
    assert ("mesh (a) dyadic shard_map", "sketch_residual_kernel_banked", 2,
            "staged") in checked
    assert out["times"]["b_rank1"]["local_rows"] == 4
    assert out["exchange"]["steps"] == 2 and out["exchange"]["leaves"] > 0
    monkeypatch.setattr(cs, "MESH", dict(cs.MESH, ranks=3))
    # (b)'s failure alone: (a)'s model ran above
    monkeypatch.setattr(cs, "mesh_model", lambda *a: {})
    with pytest.raises(SystemExit, match="rank"):
        cs.mesh_phase(cpu, stream, BLOCK, spec, q_spec, c=cs.MESH,
                      model=cs.MESH_MODEL, get=configs.get_smoke)


SMOKE_DRYRUN = dict(train=dict(arch="qwen3_0_6b", seq_len=32, batch=4),
                    decode=dict(arch="gemma3_27b", batch=2, context=64),
                    budget_s=300, flops_rtol=1e-3)


def test_dryrun_phase_rehearsal():
    """The dry-run phase at smoke size on the CPU: its child traces smoke
    Qwen3's train step (B = 4 x 32, remat) and smoke Gemma3's decode step
    (one period) on a one-rank fake group, and the three gates hold
    against a real CPU step of the same train step under
    ``FlopCounterMode``: kernel 5's op traced twice a layer (4), kernel
    6's once a layer of the period, the FLOPs equal, no device memory."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.train.step import build_train_step, init_state

    cs = _chip_smoke()
    cfg = configs.get_smoke("qwen3_0_6b")
    state, _ = init_state(cfg, 0, device="cpu")
    batch = {k: torch.zeros(4, 32, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        build_train_step(cfg)(state, batch)
    want = dict(total=fc.get_total_flops(), by_op={
        str(k): v for k, v in fc.get_flop_counts()["Global"].items()})
    decode = cs.attention_calls(cs.one_period(
        configs.get_smoke("gemma3_27b")))[1]
    out = cs.dryrun_phase(torch.device("cpu"), want, 2 * cfg.num_layers,
                          decode, None, c=SMOKE_DRYRUN, smoke=True)
    assert out["kernel_ops"] == dict(flash=4, decode=decode)
    assert out["flops_traced"] == want["total"] and out["flops_rel"] == 0.0
    assert out["device_bytes"]["max_allocated"] == 0
    mem = out["memory"]["train"]
    assert out["predicted_peak_gb"] == (mem["argument_size_in_bytes"]
                                        + mem["temp_size_in_bytes"]) / 1e9
    assert out["roofline"]["train"]["chips"] == 1


def test_analysis_phase_rehearsal():
    """The analysis phase on the CPU at a small main cell: the recompile
    and donation layers on the k = 64 grid (no graph, no donation on the
    CPU), the main cell's two sessions in one cell, the ast layer with
    ``--ci``; no finding."""
    cs = _chip_smoke()
    stream = zipf_interleaved_stream(4096, 0.5, universe=1 << 16, seed=1)
    spec = SketchSpec(kind="frequency", k=512, shards=4, bits=16)
    out = cs.analysis_phase(torch.device("cpu"), stream, 256, spec)
    assert out["findings"] == {"recompile": 0, "donation": 0,
                               "main cell": 0, "ast": 0}
    assert (out["main cell"]["cells"], out["main cell"]["graphs"]) == (1, 0)
    assert out["recompile"]["cells"] == 7 and out["recompile"]["grid"] == 9
    assert out["donation"]["donate=True"] is False
    assert out["launches"] == {}


# -- the paper phase and the examples phase -------------------------------

SMALL_PAPER = dict(n_insert=1000, bits=10, eps=0.02, eps_alpha16=0.16,
                   seed=1)
SMALL_PAPER_MAIN = dict(n_insert=1500, bits=12, eps=0.02, shards=4, seed=2)
PAPER_BLOCK = 512


def test_paper_cases_are_the_papers_grid():
    """40 paper-scale runs: 4 distributions x 2 patterns x 2 orders at
    ratio 0.5, Zipf at 0.9375 with both patterns, the serial backend on
    both Zipf inserts_first streams, each for SS± and Lazy SS±; 2,000
    SS± counters at alpha 2 and 16; the main run's 96 blocks, the last 32
    deletions only."""
    from repro_torch.core.streams import bounded_stream

    cs = _chip_smoke()
    cases = cs.paper_cases()
    assert len(cases) == len({c["label"] for c in cases}) == 40
    grid = {(c["stream"]["distribution"], c["stream"]["delete_pattern"],
             c["stream"]["order"], c["stream"]["delete_ratio"],
             c["spec"]["backend"], c["spec"]["variant"]) for c in cases}
    assert {(d, p, o) for d, p, o, r, b, v in grid if r == 0.5
            and b == "bank"} == {(d, p, o) for d in cs.PAPER_DISTS
                                 for p in cs.PAPER_PATTERNS
                                 for o in cs.PAPER_ORDERS}
    assert {(d, p, o, b) for d, p, o, r, b, v in grid if r == 0.9375} == {
        ("zipf", p, "inserts_first", "bank") for p in cs.PAPER_PATTERNS}
    assert {(d, p, o, r) for d, p, o, r, b, v in grid if b == "serial"} == {
        ("zipf", p, "inserts_first", 0.5) for p in cs.PAPER_PATTERNS}
    assert {v for *_, v in grid} == {"sspm", "lazy"}
    for c in cases:
        spec = SketchSpec(**c["spec"])
        assert spec.capacity == (2000 if spec.variant == "sspm" else 1000)
        assert c["stream"]["n_insert"] == 100_000
        assert c["stream"]["universe"] == 1 << 16 == 1 << spec.bits
    m = cs.PAPER_MAIN
    main = SketchSpec(kind="frequency", eps=m["eps"], alpha=2.0,
                      shards=m["shards"], bits=m["bits"])
    assert main.capacity == 400_000
    n = m["n_insert"] * 3 // 2
    assert (n % 65536, n // 65536, m["n_insert"] // 2 // 65536) == (0, 96, 32)
    # a small stream of the grid is the reference's order: inserts first
    s = bounded_stream("zipf", 500, 0.5, delete_pattern="targeted")
    assert (s[:500, 1] == 1).all() and (s[500:, 1] == -1).all()


def test_paper_phase_rehearsal(monkeypatch):
    """The paper phase on the CPU at a small size: every run equal to its
    plain twin and its eager twin, within Thm 4 / Thm 2 and eps·(I - D),
    kernel 1 once a block on the bank runs (session and eager), kernel 4
    on the serial runs, kernel 3 on the main spec's block run; the bank
    run equal to the kernel run."""
    cs = _chip_smoke()
    checked = _on_the_cpu(monkeypatch, cs)
    out = cs.paper_phase(torch.device("cpu"), c=SMALL_PAPER,
                         main=SMALL_PAPER_MAIN, block=PAPER_BLOCK, workers=0)
    runs = out["runs"]
    assert len(runs) == 43 and out["deletion_only_blocks"] == 1
    by_kernel = {}
    for label, name, blocks, layout in checked:
        by_kernel.setdefault(name, []).append(label)
        assert blocks == 2 * runs[label]["blocks"]
    assert len(by_kernel["sketch_update_kernel_serial"]) == 4
    assert by_kernel["sketch_residual_kernel"] == [
        "paper main adversarial block"]
    assert len(by_kernel["sketch_update_kernel_fused"]) == 38
    for r in runs.values():
        assert r["max_abs_err"] <= r["eps_mass"]
        assert r["worst_err_over_bound"] <= 1.0
        assert {"mse", "recall_phi=eps", "precision_phi=10eps",
                "eager_ms_per_block"} <= set(r)


def test_paper_checks_reject_a_corrupted_state(monkeypatch):
    """A bank whose counts are off fails the Thm 4 check; a bank that is
    not its twin's fails the twin check."""
    from repro_torch.core.streams import bounded_stream
    from repro_torch.sketch.session import StreamSession

    cs = _chip_smoke()
    _on_the_cpu(monkeypatch, cs)
    cpu = torch.device("cpu")
    case = cs.paper_cases(SMALL_PAPER)[0]
    spec = SketchSpec(**case["spec"])
    stream = bounded_stream(**case["stream"])
    sess = StreamSession(spec, block=PAPER_BLOCK, device=cpu)
    sess.ingest(stream[:, 0], stream[:, 1])
    bank = cs._bank_of(sess.state)
    cs.paper_truth("ok", spec, bank, stream, cpu, 2.0)
    top = int(torch.argmax(bank.counts))
    counts = bank.counts.clone().reshape(-1)
    counts[top] += 1000
    bad = bank._replace(counts=counts.reshape(bank.counts.shape))
    with pytest.raises(SystemExit, match="error .* > bound"):
        cs.paper_truth("corrupted", spec, bad, stream, cpu, 2.0)
    twin = [t.numpy() for t in bad]
    with pytest.raises(SystemExit, match="plain twin"):
        cs.paper_run("twin", spec, stream, PAPER_BLOCK, cpu,
                     "sketch_update_kernel_fused", "staged", lambda: twin,
                     2.0)


def test_the_examples_phase_runs_the_four_files():
    cs = _chip_smoke()
    cmds = cs.example_commands("ckpt")
    files = {pathlib.Path(argv[3]).name for _, argv in cmds}
    assert files == {"quickstart.py", "quantile_monitor.py", "serve_h2o.py",
                     "train_lm.py"}
    assert all(argv[1:3] == [str(ROOT / "chip_smoke.py"), "--example-child"]
               for _, argv in cmds)
    args = {label: argv[4:] for label, argv in cmds}
    assert args["quantile_monitor --shards 0"] == ["--shards", "0"]
    assert args["quantile_monitor --shards 4"] == ["--shards", "4"]
    assert args["quickstart"] == args["serve_h2o"] == []
    train = next(a for label, a in args.items() if label.startswith("train"))
    assert train == ["--steps", str(cs.TRAIN_LM_STEPS), "--ckpt-dir", "ckpt"]


def test_the_kernels_line_lists_all_seven_kernels():
    """The six ported kernels and the port's own unbiased kernel: the
    counted wrappers, and the entries main builds of them."""
    import inspect

    cs = _chip_smoke()
    assert set(cs.counted_kernels()) == {*cs.KERNELS, cs.UNBIASED, cs.FLASH,
                                         cs.DECODE}
    assert len(cs.counted_kernels()) == 7
    main = inspect.getsource(cs.main)
    assert "} for name in KERNELS]" in main
    assert '"name": UNBIASED' in main
    assert "kernels += attention_entries" in main
    phase = inspect.getsource(cs.attention_phase)
    assert "(FLASH, wgmma," in phase and "(DECODE, DECODE," in phase
