#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device: require CUDA; print the card's name and power limit;
2. build the CUDA kernel from ``src/repro_torch/kernels/**/csrc`` with
   nvcc (sm_90a);
3. hold every kernel against its plain PyTorch version on the card, with
   ``torch.equal`` (the sketch state is int32: tolerance 0), over cold,
   warm and near-rail banks, K values that are not multiples of 32 or
   128, R in {1, 7, 128} and all-padding blocks;
4. the main path at a real size: a flow-monitoring deployment of
   SpaceSaving± in the paper's alpha = 2 bounded-deletion regime,
   ``SketchSpec(eps=1e-5, alpha=2, shards=128, bits=24)`` = 400,000
   counters, fed through ``StreamSession(block=65536).ingest`` with 64
   blocks of a Zipf(1.0) stream over 2^24 ids at delete ratio 0.5; then a
   smaller unsharded Lazy SpaceSaving± run (eps=1e-3, k=2,000). Each run
   must launch the kernel once per block, equal the same blocks run
   through the plain version on the card, and hold the per-shard error
   bound of Thm 4 (SS±) / Thm 2 (Lazy) against the exact frequencies,
   with every item above the bound monitored;
5. times: per-block ms and updates/s of each run; the kernel's ms at the
   main path's shapes beside its bound and the plain version's ms; a
   ``torch.profiler`` window over main-path blocks (device busy share and
   the ops that take the device time).

The line before the last two is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A summary also goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

IMAX = 2**31 - 1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# int32 ALU rate: 64 INT32 lanes per SM (half the FP32 lanes behind the
# 67 TFLOP/s FP32 peak, which counts an FMA as 2) x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 16.7e12


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases():
    """(name, R, K, variant, bank state, block kind) grid of phase 3."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold R=1 K=77", 1, 77, v, "cold", "stream"),
            ("warm R=7 K=200", 7, 200, v, "warm", "stream"),
            ("warm R=128 K=3125", 128, 3125, v, "warm", "stream"),
            ("warm R=1 K=2000", 1, 2000, v, "warm", "stream"),
            ("rail+ R=7 K=1000", 7, 1000, v, "rail+", "stream"),
            # the water level's probe is false even at INT_MAX: the
            # bisection ends with lo past hi
            ("rail+ R=1 K=77", 1, 77, v, "rail+", "stream"),
            ("rail- R=7 K=301", 7, 301, v, "rail-", "stream"),
            ("warm R=128 K=3125 padding", 128, 3125, v, "warm", "padding"),
            ("cold R=1 K=40000", 1, 40000, v, "cold", "stream"),
        ]
    return cases


def _block(stream, lo, n, torch, device):
    part = stream[lo:lo + n]
    return (torch.as_tensor(part[:, 0], dtype=torch.int32, device=device),
            torch.as_tensor(part[:, 1], dtype=torch.int32, device=device))


def case_inputs(R, K, variant, state, block, device, seed, B=65536):
    """Bank + prepped block for one case, built with the plain version."""
    import torch
    from repro_torch.core.streams import bounded_stream
    from repro_torch.kernels.sketch_update.ops import block_update_with
    from repro_torch.kernels.sketch_update.ref import fused_update_ref
    from repro_torch.sketch import bank as bk
    from repro_torch.sketch.state import SketchState, sat_add

    n_warm = 0 if state == "cold" else 2
    stream = bounded_stream(math.ceil((n_warm + 1) * B / 1.5) + 1, 0.5,
                            universe=1 << 20, seed=seed)
    router = bk.HashShardRouter(R, 20)
    bank = bk.init(K, R, device=device)
    for i in range(n_warm):
        it, w = _block(stream, i * B, B, torch, device)
        bank = block_update_with(fused_update_ref, bank,
                                 *router.route_dense(it, w), variant)
    if n_warm:
        # warm rows are full and have forgotten items, so the block meets
        # the water-fill, the evictions and the spread: EMPTY slots and a
        # third of the rest take distinct ids outside the stream's universe
        # with small counts and errors
        g = torch.Generator(device=device).manual_seed(seed)
        empty = (bank.ids == -1) | (torch.rand(
            bank.ids.shape, generator=g, device=device) < 0.3)
        fresh = (1 << 21) + torch.arange(bank.ids.numel(), device=device,
                                         dtype=torch.int32).view_as(bank.ids)
        c = torch.randint(1, 6, bank.ids.shape, generator=g, device=device,
                          dtype=torch.int32)
        e = torch.remainder(torch.randint(0, 6, bank.ids.shape, generator=g,
                                          device=device, dtype=torch.int32), c)
        bank = SketchState(torch.where(empty, fresh, bank.ids),
                           torch.where(empty, c, bank.counts),
                           torch.where(empty, e, bank.errors))
    live = bank.ids >= 0
    if state == "rail+":
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, IMAX - 40), bank.counts))
    elif state == "rail-":
        bank = bank._replace(counts=torch.where(
            live, sat_add(bank.counts, -(IMAX - 40)), bank.counts))
    it, w = _block(stream, n_warm * B, B, torch, device)
    if block == "padding":
        w = torch.zeros_like(w)
    ri, rw = router.route_dense(it, w)
    prep = bk.phase1_dense_prep(bank, ri, rw, variant)
    return SketchState(*(t.contiguous() for t in bank)), prep


def max_abs_err(want, got) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(want, got))


def check_kernel_cases(device) -> int:
    import torch
    from repro_torch.kernels.sketch_update.kernel import sketch_update_kernel_fused
    from repro_torch.kernels.sketch_update.ref import fused_update_ref

    worst = 0
    for i, (name, R, K, v, state, block) in enumerate(kernel_cases()):
        bank, prep = case_inputs(R, K, v, state, block, device, seed=100 + i)
        want = fused_update_ref(*bank, *prep, variant=v)
        got = sketch_update_kernel_fused(*(t.clone() for t in bank), *prep,
                                         variant=v)
        torch.cuda.synchronize()
        err = max_abs_err(want, got)
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        log(f"kernel vs plain [{name} variant={v}]: "
            f"{'equal' if same else 'DIFFERENT'} (max_abs_err {err})")
        if not same:
            raise SystemExit(f"kernel disagrees with its plain version: {name}")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def make_stream(n_blocks, block, seed):
    """A Zipf(1.0) bounded-deletion stream over 2^24 ids, delete ratio 0.5,
    sized to fill ``n_blocks`` blocks (the last one partly)."""
    from repro_torch.core.streams import bounded_stream

    n_insert = (n_blocks * block) * 2 // 3
    return bounded_stream(n_insert, 0.5, universe=1 << 24, skew=1.0, seed=seed)


def run_session(spec, stream, block, device):
    """Drive StreamSession.ingest (the user's entry point); time it."""
    import torch
    from repro_torch.sketch.session import StreamSession

    sess = StreamSession(spec, block=block, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.ingest(stream[:, 0], stream[:, 1])
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0


def run_plain(spec, stream, block, device):
    """The same padded blocks through the same route and prep, with the
    plain version in place of the kernel. Returns the final bank, the
    last block's kernel inputs (bank before it, prep) and the time."""
    import numpy as np
    import torch
    from repro_torch.kernels.sketch_update.ops import block_update_with, prep_block
    from repro_torch.kernels.sketch_update.ref import fused_update_ref
    from repro_torch.sketch import api
    from repro_torch.sketch import bank as bk
    from repro_torch.sketch.state import SketchState

    S = spec.shards or 1
    router = bk.HashShardRouter(S, spec.bits)
    state = api.make(spec, device)
    bank = state.bank if spec.shards else SketchState(*(t[None] for t in state))
    n = len(stream)
    nb = -(-n // block)
    items = np.zeros(nb * block, np.int32)
    weights = np.zeros(nb * block, np.int32)
    items[:n], weights[:n] = stream[:, 0], stream[:, 1]
    t0 = time.perf_counter()
    for b in range(nb):
        it = torch.as_tensor(items[b * block:(b + 1) * block], device=device)
        w = torch.as_tensor(weights[b * block:(b + 1) * block], device=device)
        ri, rw = router.route_dense(it, w)
        if b == nb - 1:
            last = prep_block(bank, ri, rw, spec.variant_id)
        bank = block_update_with(fused_update_ref, bank, ri, rw,
                                 spec.variant_id)
    torch.cuda.synchronize()
    return bank, last, time.perf_counter() - t0


def check_truth(spec, bank, stream, device, factor):
    """Per-row error bound ``factor * I_row / k`` against the exact
    frequencies (factor 2: Thm 4, SS±; factor 1: Thm 2, Lazy); every item
    above its row's bound must be monitored. Returns (worst error over
    bound, number of items above their bound)."""
    import numpy as np
    import torch
    from repro_torch.sketch.bank import shard_of

    R, k = bank.ids.shape
    U = 1 << spec.bits
    items, signs = stream[:, 0], stream[:, 1]
    freq = np.bincount(items, weights=signs, minlength=U).astype(np.int64)
    ids = bank.ids.reshape(-1).cpu().numpy()
    counts = bank.counts.reshape(-1).cpu().numpy().astype(np.int64)
    live = ids >= 0
    if len(np.unique(ids[live])) != live.sum():
        raise SystemExit("an id is monitored by two slots")
    est = np.zeros(U, np.int64)
    est[ids[live]] = counts[live]
    owner = shard_of(torch.arange(U, device=device), R).long()
    ins_per_row = torch.zeros(R, dtype=torch.float64, device=device)
    ins_items = torch.as_tensor(items[signs > 0], device=device)
    ins_per_row.index_add_(0, owner[ins_items],
                           torch.ones(len(ins_items), dtype=torch.float64,
                                      device=device))
    # Thm 4 (SS±, k = 2 alpha / eps) and Thm 2 (Lazy, k = alpha / eps) with
    # each row's own alpha = I_row / |F_row|_1: eps * |F_row|_1 = factor *
    # I_row / k
    bound = factor * ins_per_row / k
    err = torch.as_tensor(np.abs(est - freq), device=device, dtype=torch.float64)
    worst = torch.zeros(R, dtype=torch.float64, device=device).scatter_reduce(
        0, owner, err, "amax")
    if bool((worst > bound).any()):
        r = int(torch.argmax(worst - bound))
        raise SystemExit(f"row {r}: error {float(worst[r])} > bound "
                         f"{float(bound[r])}")
    hot = torch.as_tensor(freq, device=device) > bound[owner]
    est_t = torch.as_tensor(est, device=device)
    if bool((hot & (est_t <= 0)).any()):
        raise SystemExit("an item above the error bound is not monitored")
    return float((worst / bound).max()), int(hot.sum())


def time_kernel(last, variant, reps=20, plain_reps=3):
    """Kernel and plain-version ms on the main path's last block, each
    launch on its own copy of the bank (the kernel updates in place)."""
    import torch
    from repro_torch.kernels.sketch_update.kernel import sketch_update_kernel_fused
    from repro_torch.kernels.sketch_update.ref import fused_update_ref

    bank, prep = last
    copies = [[t.clone() for t in bank] for _ in range(reps + 1)]
    sketch_update_kernel_fused(*copies[0], *prep, variant=variant)  # warm-up
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for c in copies[1:]:
        sketch_update_kernel_fused(*c, *prep, variant=variant)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    want = fused_update_ref(*bank, *prep, variant=variant)  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(plain_reps):
        fused_update_ref(*bank, *prep, variant=variant)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / plain_reps
    nbytes = least_bytes(bank, prep, want, variant)
    nops = least_ops(bank, prep)
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >=
                          nops / INT32_OPS_PER_S else "operations"),
                bytes=nbytes, ops=nops)


def least_bytes(bank, prep, out, variant) -> int:
    """Bytes this block's update must move at the least, from its own
    data: every delta; a row's counts in full where the water-fill or an
    eviction must see them all (mu + nnu > 0), else the counts it changes
    or adds delta to; a row's ids in full where the empty fill must find
    its EMPTY slots (i0 > 0); a row's errors in full where the SS± spread
    must find the largest (w_del > 0); each element of ids, counts and
    errors that the update changes, written once; the grouped (uid, net)
    entries the rows use and the four per-row scalars, read once."""
    delta, h_uids, h_net, i0, mu, nnu, w_del = prep
    R, K = bank.ids.shape
    changed = [a != b for a, b in zip(bank, out)]
    scans = (mu + nnu) > 0
    counts_read = (K * int(scans.sum())
                   + int(((changed[1] | (delta != 0)) & ~scans[:, None]).sum()))
    ids_read = K * int((i0 > 0).sum())
    errors_read = K * int((w_del > 0).sum()) if variant == 2 else 0
    writes = sum(int(c.sum()) for c in changed)
    used = int((i0.long() + mu.long() + nnu.long()).sum())
    return 4 * (R * K + counts_read + ids_read + errors_read + writes
                + 2 * used + 4 * R)


def least_ops(bank, prep) -> int:
    """int32 operations this block needs at the least: one per slot to add
    the delta, one per slot of the rows whose empty slots are scanned, one
    per slot per bisection probe of the water level (ceil(log2(mu + 1))
    of them) plus one placement pass, one per slot per non-unit
    eviction."""
    import torch

    delta, h_uids, h_net, i0, mu, nnu, w_del = prep
    R, K = bank.ids.shape
    fill = mu[mu > 0].double()
    probes = int((torch.ceil(torch.log2(fill + 1)) + 1).sum())
    passes = R + int((i0 > 0).sum()) + probes + int(nnu.long().sum())
    return K * passes


def run_path(label, spec, n_blocks, block, seed, device, factor):
    import torch
    from repro_torch.kernels.sketch_update import kernel

    stream = make_stream(n_blocks, block, seed)
    kernel.sketch_update_kernel_fused.launches = 0
    sess, secs = run_session(spec, stream, block, device)
    launches = kernel.sketch_update_kernel_fused.launches
    if launches != sess.blocks_ingested or launches == 0:
        raise SystemExit(f"{label}: {launches} kernel launches for "
                         f"{sess.blocks_ingested} blocks")
    bank, last, plain_secs = run_plain(spec, stream, block, device)
    live = sess.state.bank if spec.shards else type(bank)(
        *(t[None] for t in sess.state))
    if not all(torch.equal(a, b) for a, b in zip(live, bank)):
        raise SystemExit(f"{label}: the session's bank differs from the "
                         f"plain version's")
    ratio, n_hot = check_truth(spec, live, stream, device, factor)
    # the user's read path agrees with the bank
    hot_ids, hot_counts = sess.topk(16)
    if not torch.equal(sess.query_many(hot_ids.cpu().numpy()), hot_counts):
        raise SystemExit(f"{label}: query_many disagrees with topk")
    out = dict(label=label, blocks=sess.blocks_ingested, launches=launches,
               events=len(stream), rows=live.ids.shape[0],
               k_per_row=live.ids.shape[1],
               ms_per_block=secs * 1e3 / sess.blocks_ingested,
               updates_per_s=len(stream) / secs,
               plain_ms_per_block=plain_secs * 1e3 / sess.blocks_ingested,
               worst_err_over_bound=ratio, items_above_bound=n_hot)
    log(f"{label}: {json.dumps(out)}")
    return out, last


def profile_blocks(spec, block, n_blocks, seed, device):
    """Profile ``n_blocks`` main-path blocks (after one warm-up block):
    wall and device-busy ms per block and the ops by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sketch.session import StreamSession

    stream = make_stream(n_blocks + 1, block, seed)
    items = np.zeros((n_blocks + 1) * block, np.int32)
    weights = np.zeros_like(items)
    items[:len(stream)], weights[:len(stream)] = stream[:, 0], stream[:, 1]
    items, weights = items.reshape(-1, block), weights.reshape(-1, block)
    sess = StreamSession(spec, block=block, device=device)
    sess.ingest_block(items[0], weights[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in range(1, n_blocks + 1):
            sess.ingest_block(items[b], weights[b])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = prof.key_averages()
    # device work = the kernels and copies themselves (an aten op's own
    # device time repeats its kernels')
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_device)

    def top(evts, key):
        return [(e.key[:80], key(e) / 1e3 / n_blocks)
                for e in sorted(evts, key=key, reverse=True)[:8]]

    return dict(
        blocks=n_blocks, wall_ms_per_block=wall * 1e3 / n_blocks,
        device_busy_ms_per_block=busy_us / 1e3 / n_blocks,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        top_device_ms_per_block=top(on_device, dev_us),
        top_host_ms_per_block=top(events, lambda e: e.self_cpu_time_total))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.sketch_update.kernel import entry_point
    from repro_torch.sketch.api import SketchSpec

    device = torch.device("cuda")
    card = gpu_line()
    log(f"device: {card}")
    t0 = time.perf_counter()
    entry_point()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    worst = check_kernel_cases(device)
    log(f"kernel vs plain: {len(kernel_cases())} cases equal "
        f"({time.perf_counter() - t0:.1f} s)")

    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="kernel")
    main_run, last = run_path("main sspm shards=128", main_spec, 64, 65536,
                              seed=1, device=device, factor=2.0)
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="kernel")
    lazy_run, _ = run_path("lazy k=2000", lazy_spec, 16, 65536, seed=2,
                           device=device, factor=1.0)

    times = time_kernel(last, main_spec.variant_id)
    log(f"sketch_update_kernel_fused at the main path's shapes: "
        f"{json.dumps(times)}")
    prof = {label: profile_blocks(spec, 65536, 8, seed=3, device=device)
            for label, spec in (("main", main_spec), ("lazy", lazy_spec))}
    log(f"profile of the main path: {json.dumps(prof)}")
    kernels = [{
        "name": "sketch_update_kernel_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sketch_update/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/sketch_update/kernel.py:144",
        "launches": main_run["launches"] + lazy_run["launches"],
        "max_abs_err": worst,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, runs=[main_run, lazy_run], kernel_times=times,
        profile=prof, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
