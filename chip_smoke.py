#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. device: require CUDA; print the card's name and power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/**/csrc`` with
   nvcc (sm_90a), one nvcc per source, all started together;
3. hold every kernel against its plain PyTorch version on the card, with
   ``torch.equal`` (the sketch state is int32: tolerance 0), over cold,
   warm and near-rail (+ and -) states, K values that are not multiples
   of 32 or 128, R and E in {1, 7, 128}, k = 400,000 for the
   single-sketch residual kernel, and all-padding blocks: the fused
   update (kernel 1), the banked residual (kernel 2), the stacked
   single-sketch residual (kernel 3) and the serial baseline (kernel 4,
   on the first 4,096 items of each case);
4. runs at a real size, each on a Zipf(1.0) stream over 2^24 ids at
   delete ratio 0.5, interleaved, in blocks of 65,536:
   - main: a flow-monitoring deployment of SpaceSaving± in the paper's
     alpha = 2 bounded-deletion regime, ``SketchSpec(eps=1e-5, alpha=2,
     shards=128, bits=24)`` = 400,000 counters, through
     ``StreamSession.ingest``, 64 blocks, kernel 1;
   - lazy: unsharded Lazy SpaceSaving±, eps=1e-3 (k = 2,000), 16 blocks,
     kernel 1;
   - block sspm k=400000: the main spec unsharded on
     ``backend="block"`` (path A), 32 blocks, kernel 3;
   - block lazy k=2000: the lazy run on ``backend="block"``, kernel 3;
     its bank must equal the lazy run's;
   - block sspm shards=128: the main run on ``backend="block"`` (path B,
     the masked-row vmap path), kernel 3; its bank must equal the main
     run's;
   - banked sspm shards=128: ``ops.sketch_block_update_banked`` over the
     main run's blocks, kernel 2; its bank must equal the main run's;
   - serial sspm k=4000: ``ops.sketch_block_update_serial`` on one
     sketch of ``capacity_for(1e-3, 2)`` counters, 8 blocks, kernel 4.
   Every counter is set to 0 before a run and read after it: each run
   must launch its kernel once per block and no other kernel. Each run
   but the serial one must equal the same blocks run through the plain
   versions on the card; each must hold the error bound of Thm 4 (SS±)
   or Thm 2 (Lazy) against the exact frequencies, with every item above
   the bound monitored;
5. times: per-block ms and updates/s of each run; each kernel's ms at
   its run's shapes beside its bound and the plain version's ms; a
   ``torch.profiler`` window over blocks of the main, lazy, path A and
   path B sessions (device busy share and the ops that take the device
   time);
6. the attention kernels (flash attention, kernel 5; decode attention
   with per-slot mass, kernel 6), with TF32 off so the plain versions run
   in true f32:
   - each against its plain version on the card, f32 and bf16, on the
     reference's test grids plus a ragged S, T > S, no mask and a row with
     no valid slot: flash within atol = rtol = 2e-5 (f32) / 2e-2 (bf16),
     decode ctx within 3e-5 / 3e-2 and mass within atol 2e-5, rtol 2e-4,
     the mass summing to KV·G on every row with a valid slot, flash and
     ctx also row by row as below;
   - the path at Gemma3-27B's widths (H = 32, KV = 16, hd = 128, bf16)
     through the entry points, every counter reset before and read after
     (flash twice, decode once, no other kernel): flash global (B = 1,
     S = T = 4,096, causal), flash local (the same, window 1,024), decode
     hh (B = 8 over the 8,192-slot heavy-hitter cache, 90 % valid); each
     held to its plain version row by row, |got - want| <= 2^-7·|want| +
     2^-6·RMS(row) (a row: one query's hd values of one q-head; the limit
     scales with the output), the decode launch repeated bit for bit; the
     same check must reject the plain version with a fault planted (one
     64-key tile or chunk dropped from P·V; two kv-heads swapped);
   - times with CUDA events: kernel, plain version, and one
     ``F.scaled_dot_product_attention`` call as the library yardstick
     (the backend it took is printed; for decode it gives the context
     only, not the mass), beside each run's bound.

The line before the last two is ``{"kernels": [...]}`` (all six kernels);
the last line is ``{"ok": true, "device": {...}}``. A summary also goes to
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



KERNELS = ("sketch_update_kernel_fused", "sketch_residual_kernel_banked",
           "sketch_residual_kernel", "sketch_update_kernel_serial")
FLASH, DECODE = "flash_attention_kernel", "decode_attention_kernel"


def counted_kernels() -> dict:
    """Every kernel wrapper of the port by name; each counts its launches."""
    from repro_torch.kernels.decode_attention import kernel as da
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.sketch_update import kernel

    wrappers = {name: getattr(kernel, name) for name in KERNELS}
    wrappers[FLASH] = fa.flash_attention_kernel
    wrappers[DECODE] = da.decode_attention_kernel
    return wrappers


def reset_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted_kernels().items()}


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases():
    """(name, R, K, variant, bank state, block kind) grid of kernel 1."""
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


def banked_cases():
    """(name, R, K, variant, bank state, block kind) grid of kernel 2."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold R=1 K=77", 1, 77, v, "cold", "stream"),
            ("warm R=7 K=200", 7, 200, v, "warm", "stream"),
            ("warm R=128 K=3125", 128, 3125, v, "warm", "stream"),
            ("rail+ R=7 K=1000", 7, 1000, v, "rail+", "stream"),
            ("rail- R=7 K=301", 7, 301, v, "rail-", "stream"),
            ("warm R=128 K=3125 padding", 128, 3125, v, "warm", "padding"),
        ]
    return cases


def split_cases():
    """(name, E, k, variant, state, block kind) grid of kernel 3: E > 1
    sketches take the rows' routed (sorted) views, E = 1 the raw block."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold E=1 k=77", 1, 77, v, "cold", "stream"),
            ("warm E=7 k=200", 7, 200, v, "warm", "stream"),
            ("warm E=128 k=3125", 128, 3125, v, "warm", "stream"),
            ("rail+ E=7 k=1000", 7, 1000, v, "rail+", "stream"),
            ("rail- E=7 k=301", 7, 301, v, "rail-", "stream"),
            ("warm E=128 k=3125 padding", 128, 3125, v, "warm", "padding"),
            ("warm E=1 k=3125", 1, 3125, v, "warm", "stream"),
            ("warm E=1 k=400000", 1, 400000, v, "warm", "stream"),
        ]
    return cases


SERIAL_ITEMS = 4096   # the plain serial version is a Python loop per item


def serial_cases():
    """(name, 1, k, variant, state, block kind) grid of kernel 4, each on
    the first SERIAL_ITEMS items of its block."""
    cases = []
    for v in (2, 1):
        cases += [
            ("cold k=77", 1, 77, v, "cold", "stream"),
            ("warm k=200", 1, 200, v, "warm", "stream"),
            ("rail+ k=1000", 1, 1000, v, "rail+", "stream"),
            ("rail- k=301", 1, 301, v, "rail-", "stream"),
            ("warm k=3125", 1, 3125, v, "warm", "stream"),
            ("warm k=4000", 1, 4000, v, "warm", "stream"),
            ("warm k=200 padding", 1, 200, v, "warm", "padding"),
        ]
    return cases


def _block(stream, lo, n, torch, device):
    part = stream[lo:lo + n]
    return (torch.as_tensor(part[:, 0], dtype=torch.int32, device=device),
            torch.as_tensor(part[:, 1], dtype=torch.int32, device=device))


def case_block(R, K, variant, state, block, device, seed, B=65536):
    """An (R, K) bank and a raw block for one case, built with the plain
    version. Returns ``(bank, items, weights, router)``."""
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
    return SketchState(*(t.contiguous() for t in bank)), it, w, router


def fused_case(R, K, variant, state, block, device, seed):
    """Kernel 1's operands: the bank and its prep."""
    from repro_torch.sketch import bank as bk

    bank, it, w, router = case_block(R, K, variant, state, block, device,
                                     seed)
    ri, rw = router.route_dense(it, w)
    return list(bank), list(bk.phase1_dense_prep(bank, ri, rw, variant))


def banked_case(R, K, variant, state, block, device, seed):
    """Kernel 2's operands: the padded bank after ``bank.phase1_dense``."""
    bank, it, w, router = case_block(R, K, variant, state, block, device,
                                     seed)
    return banked_operands(bank, *router.route_dense(it, w), variant)


def split_case(E, k, variant, state, block, device, seed):
    """Kernel 3's operands: E sketches' row view after ``_phase1``."""
    bank, it, w, router = case_block(E, k, variant, state, block, device,
                                     seed)
    if E == 1:
        return split_operands(bank, it[None], w[None], variant, False)
    return split_operands(bank, *router.route_dense(it, w), variant, True)


def serial_case(_, k, variant, state, block, device, seed):
    """Kernel 4's operands: one sketch's row view and the block's first
    SERIAL_ITEMS items."""
    bank, it, w, _ = case_block(1, k, variant, state, block, device, seed)
    return serial_operands(bank, it[:SERIAL_ITEMS], w[:SERIAL_ITEMS])


def banked_operands(bank, row_items, row_weights, variant):
    from repro_torch.kernels.sketch_update.ops import _pad_bank
    from repro_torch.sketch.bank import phase1_dense
    from repro_torch.sketch.state import SketchState

    ids1, cnt1, err1, h_uids, h_net, uoff, mu, nnu, w_del = phase1_dense(
        bank, row_items, row_weights, variant)
    return (list(_pad_bank(SketchState(ids1, cnt1, err1))),
            [h_uids, h_net, uoff, mu, mu + nnu, w_del])


def split_operands(bank, items, weights, variant, assume_sorted):
    from repro_torch.sketch.blocks import _phase1
    from repro_torch.sketch.phases import pad_rows

    ph = _phase1(bank, items, weights, variant, assume_sorted)
    return list(pad_rows(*ph[:3])), list(ph[3:])


def serial_operands(bank, items, weights):
    from repro_torch.sketch.phases import pad_rows

    return list(pad_rows(*(t[0] for t in bank))), [items, weights]


def max_abs_err(want, got) -> int:
    return max(int((a.long() - b.long()).abs().max()) for a, b in zip(want, got))


def check_cases(label, kernel, plain, cases, operands, device, seed0) -> int:
    """Each case's operands through the kernel (on copies, as it updates
    in place) and through its plain version; equal or fatal."""
    import torch

    worst = 0
    for i, (name, R, K, v, state, block) in enumerate(cases):
        st, args = operands(R, K, v, state, block, device, seed0 + i)
        want = plain(*st, *args, variant=v)
        got = kernel(*(t.clone() for t in st), *args, variant=v)
        torch.cuda.synchronize()
        err = max_abs_err(want, got)
        same = all(torch.equal(a, b) for a, b in zip(want, got))
        log(f"{label} vs plain [{name} variant={v}]: "
            f"{'equal' if same else 'DIFFERENT'} (max_abs_err {err})")
        if not same:
            raise SystemExit(f"{label} disagrees with its plain version: "
                             f"{name}")
        worst = max(worst, err)
    return worst


def check_all_cases(device) -> dict:
    from repro_torch.kernels.sketch_update import kernel, ref

    grid = (
        ("sketch_update_kernel_fused", ref.fused_update_ref, kernel_cases(),
         fused_case, 100),
        ("sketch_residual_kernel_banked", ref.residual_phase_banked,
         banked_cases(), banked_case, 200),
        ("sketch_residual_kernel", ref.residual_phase, split_cases(),
         split_case, 300),
        ("sketch_update_kernel_serial", ref.serial_update_ref,
         serial_cases(), serial_case, 400),
    )
    worst = {}
    for name, plain, cases, operands, seed0 in grid:
        t0 = time.perf_counter()
        worst[name] = check_cases(name, getattr(kernel, name), plain, cases,
                                  operands, device, seed0)
        log(f"{name} vs plain: {len(cases)} cases equal "
            f"({time.perf_counter() - t0:.1f} s)")
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the runs
# ---------------------------------------------------------------------------

def make_stream(n_blocks, block, seed):
    """A Zipf(1.0) bounded-deletion stream over 2^24 ids, delete ratio 0.5,
    sized to fill ``n_blocks`` blocks (the last one partly)."""
    from repro_torch.core.streams import bounded_stream

    n_insert = (n_blocks * block) * 2 // 3
    return bounded_stream(n_insert, 0.5, universe=1 << 24, skew=1.0, seed=seed)


def padded_blocks(stream, block):
    """The stream as (NB, block) int32 items and weights, the last block
    padded with weight 0, as ``StreamSession.ingest`` pads it."""
    import numpy as np

    n = len(stream)
    nb = -(-n // block)
    items = np.zeros(nb * block, np.int32)
    weights = np.zeros(nb * block, np.int32)
    items[:n], weights[:n] = stream[:, 0], stream[:, 1]
    return items.reshape(nb, block), weights.reshape(nb, block)


def initial_bank(spec, device):
    """The spec's empty state as an (R, k) bank (R = 1 when unsharded)."""
    from repro_torch.sketch import api
    from repro_torch.sketch.state import SketchState

    state = api.make(spec, device)
    return state.bank if spec.shards else SketchState(*(t[None] for t in state))


def _router(spec, bank):
    from repro_torch.sketch.bank import HashShardRouter

    return HashShardRouter(bank.ids.shape[0], spec.bits)


# Each path's kernel operands for one raw block (it, w) on the (R, k) bank.

def fused_path(spec, bank, it, w):
    from repro_torch.kernels.sketch_update.ops import prep_block

    padded, prep = prep_block(bank, *_router(spec, bank).route_dense(it, w),
                              spec.variant_id)
    return list(padded), list(prep)


def banked_path(spec, bank, it, w):
    return banked_operands(bank, *_router(spec, bank).route_dense(it, w),
                           spec.variant_id)


def split_path(spec, bank, it, w):
    if spec.shards:
        return split_operands(bank, *_router(spec, bank).route_dense(it, w),
                              spec.variant_id, True)
    return split_operands(bank, it[None], w[None], spec.variant_id, False)


def serial_path(spec, bank, it, w):
    return serial_operands(bank, it, w)


def _unpad(out, bank):
    from repro_torch.sketch.state import SketchState

    R, k = bank.ids.shape
    return SketchState(*(t.reshape(R, -1)[:, :k] for t in out))


def run_plain(spec, stream, block, device, path, plain):
    """The same padded blocks through the path's framework side and the
    kernel's plain version in place of the kernel. Returns the final
    bank, the last block's kernel operands and the time."""
    import torch

    bank = initial_bank(spec, device)
    items, weights = padded_blocks(stream, block)
    t0 = time.perf_counter()
    for b in range(len(items)):
        it = torch.as_tensor(items[b], device=device)
        w = torch.as_tensor(weights[b], device=device)
        st, args = path(spec, bank, it, w)
        if b == len(items) - 1:
            last = (st, args)
        bank = _unpad(plain(*st, *args, variant=spec.variant_id), bank)
    torch.cuda.synchronize()
    return bank, last, time.perf_counter() - t0


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


def check_launches(label, counts, name, blocks) -> int:
    others = {k: v for k, v in counts.items() if k != name and v}
    if counts[name] != blocks or blocks == 0 or others:
        raise SystemExit(f"{label}: {counts[name]} launches of {name} for "
                         f"{blocks} blocks; other kernels launched: {others}")
    return counts[name]


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


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_path(label, spec, stream, block, device, factor, kernel, path, plain):
    """One session run: ``StreamSession.ingest`` of the stream, its
    launches of ``kernel`` (one per block, no other kernel), equality with
    the plain version's run, the error bound, and the read path."""
    import torch

    reset_counts()
    sess, secs = run_session(spec, stream, block, device)
    launches = check_launches(label, read_counts(), kernel,
                              sess.blocks_ingested)
    bank, last, plain_secs = run_plain(spec, stream, block, device, path,
                                       plain)
    live = sess.state.bank if spec.shards else type(bank)(
        *(t[None] for t in sess.state))
    if not _same(live, bank):
        raise SystemExit(f"{label}: the session's bank differs from the "
                         f"plain version's")
    ratio, n_hot = check_truth(spec, live, stream, device, factor)
    # the user's read path agrees with the bank
    hot_ids, hot_counts = sess.topk(16)
    if not torch.equal(sess.query_many(hot_ids.cpu().numpy()), hot_counts):
        raise SystemExit(f"{label}: query_many disagrees with topk")
    out = dict(label=label, kernel=kernel, blocks=sess.blocks_ingested,
               launches=launches, events=len(stream), rows=live.ids.shape[0],
               k_per_row=live.ids.shape[1],
               ms_per_block=secs * 1e3 / sess.blocks_ingested,
               updates_per_s=len(stream) / secs,
               plain_ms_per_block=plain_secs * 1e3 / sess.blocks_ingested,
               worst_err_over_bound=ratio, items_above_bound=n_hot)
    log(f"{label}: {json.dumps(out)}")
    return out, last, live


def run_ops_path(label, spec, stream, block, device, factor, kernel, path,
                 update, plain=None):
    """One run of an ``ops`` entry point, ``update(bank, it, w)``, over
    the padded blocks, staged on the card before the timed loop; checked
    as ``run_path`` checks a session run (the plain run only where
    ``plain`` is given)."""
    import torch

    bank = initial_bank(spec, device)
    items, weights = padded_blocks(stream, block)
    blocks = [(torch.as_tensor(i, device=device),
               torch.as_tensor(w, device=device))
              for i, w in zip(items, weights)]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it, w in blocks:
        before_last = bank
        bank = update(bank, it, w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    last = path(spec, before_last, *blocks[-1])
    launches = check_launches(label, read_counts(), kernel, len(blocks))
    out = dict(label=label, kernel=kernel, blocks=len(blocks),
               launches=launches, events=len(stream), rows=bank.ids.shape[0],
               k_per_row=bank.ids.shape[1],
               ms_per_block=secs * 1e3 / len(blocks),
               updates_per_s=len(stream) / secs)
    if plain is not None:
        want, _, plain_secs = run_plain(spec, stream, block, device, path,
                                        plain)
        if not _same(bank, want):
            raise SystemExit(f"{label}: the bank differs from the plain "
                             f"version's")
        out["plain_ms_per_block"] = plain_secs * 1e3 / len(blocks)
    out["worst_err_over_bound"], out["items_above_bound"] = check_truth(
        spec, bank, stream, device, factor)
    log(f"{label}: {json.dumps(out)}")
    return out, last, bank


# ---------------------------------------------------------------------------
# Phase 5: kernel times and their bounds
# ---------------------------------------------------------------------------

def time_kernel(kernel, plain, last, variant, bound, reps, plain_reps):
    """Kernel and plain-version ms on a run's last block, each launch on
    its own copy of the state (the kernel updates in place), beside the
    bound ``bound(state, args, out, variant) -> (bytes, ops)`` gives."""
    import torch

    st, args = last
    copies = [[t.clone() for t in st] for _ in range(reps + 1)]
    first = kernel(*copies[0], *args, variant=variant)  # warm-up
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for c in copies[1:]:
        kernel(*c, *args, variant=variant)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    if plain_reps > 1:
        plain(*st, *args, variant=variant)  # warm-up
    torch.cuda.synchronize()
    start.record()
    for _ in range(plain_reps):
        want = plain(*st, *args, variant=variant)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) / plain_reps
    if not _same(want, first):
        raise SystemExit("a timed kernel launch differs from its plain version")
    nbytes, nops = bound(st, args, want, variant)
    by_bytes = nbytes / HBM_BYTES_PER_S >= nops / INT32_OPS_PER_S
    bound_s = max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by="bytes" if by_bytes else "operations",
                bytes=nbytes, ops=nops)


def fused_bound(bank, prep, out, variant):
    return least_bytes(bank, prep, out, variant), least_ops(bank, prep)


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
    R, K = bank[0].shape
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
    R, K = bank[0].shape
    fill = mu[mu > 0].double()
    probes = int((torch.ceil(torch.log2(fill + 1)) + 1).sum())
    passes = R + int((i0 > 0).sum()) + probes + int(nnu.long().sum())
    return K * passes


def _spread_slots(st, out, variant):
    """Per row: the slots the SS± spread drained (same id, smaller error)."""
    if variant != 2:
        return st[0].new_zeros(st[0].shape[0]).long()
    hit = (out[0] == st[0]) & (out[2] < st[2])
    return hit.reshape(hit.shape[0], -1).sum(dim=1)


def banked_bound(st, args, out, variant):
    """Kernel 2 at the least: a row's counts in full where it evicts, its
    errors in full where it spreads; each changed element written once;
    the (uid, net) entries used and four scalars per row read once. One
    operation per slot per eviction and per drained slot (each finds a
    row minimum or maximum)."""
    h_uids, h_net, uoff, start, n_ins, w_del = args
    R, K = st[0].shape
    ev = (n_ins - start).clamp(min=0).long()
    spread = _spread_slots(st, out, variant)
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    reads = K * int((ev > 0).sum()) + K * int((spread > 0).sum())
    nbytes = 4 * (reads + writes + 2 * int(ev.sum()) + 4 * R)
    return nbytes, K * int((ev + spread).sum())


def split_bound(st, args, out, variant):
    """Kernel 3 at the least: a sketch's ids and counts in full where it
    evicts (the tournament needs its EMPTY slots and minima), its errors
    in full where it spreads; each changed element written once; the
    (uid, net) entries used and three scalars per sketch read once. One
    operation per slot of each sketch with work, then R + 128 per
    eviction and per drained slot (a row pick and a column pick)."""
    r_uids, r_net, start, n_ins, w_del = args
    E, R, lanes = st[0].shape
    n = R * lanes
    ev = (n_ins - start).clamp(min=0).long()
    spread = _spread_slots(st, out, variant)
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    reads = 2 * n * int((ev > 0).sum()) + n * int((spread > 0).sum())
    nbytes = 4 * (reads + writes + 2 * int(ev.sum()) + 3 * E)
    nops = n * int(((ev > 0) | (spread > 0)).sum()) \
        + (R + lanes) * int((ev + spread).sum())
    return nbytes, nops


def serial_bound(st, args, out, variant):
    """Kernel 4 at the least: the sketch read once, each changed element
    written once, the items and weights read once; every update of
    nonzero weight looks at every slot once."""
    items, weights = args
    n = st[0].numel()
    writes = sum(int((a != b).sum()) for a, b in zip(st, out))
    nbytes = 4 * (3 * n + writes + 2 * items.numel())
    return nbytes, n * int((weights != 0).sum())


def profile_blocks(spec, block, n_blocks, seed, device):
    """Profile ``n_blocks`` session blocks (after one warm-up block):
    wall and device-busy ms per block and the ops by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sketch.session import StreamSession

    stream = make_stream(n_blocks + 1, block, seed)
    items, weights = padded_blocks(stream, block)
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


# ---------------------------------------------------------------------------
# The attention kernels (5 and 6): cases, the full-width runs, times
# ---------------------------------------------------------------------------

BF16_FLOPS_PER_S = 989.4e12   # H100 SXM, dense bf16 on the tensor cores
# Gemma3-27B (src/repro/configs/gemma3_27b.py:8): 32 q-heads on 16 kv-heads,
# hd 128, local layers of window 1,024, a heavy-hitter cache of 8,192 slots
# per global layer; bf16
GEMMA = dict(H=32, KV=16, hd=128, window=1024, budget=8192)
PREFILL = 4096          # one 4k prefill chunk
DECODE_BATCH = 8
VALID_SHARE = 0.9       # share of the decode cache's slots that are valid
# Attention outputs are also held row by row (a row: the hd values of one
# query and q-head): |got - want| <= ROUNDING·|want| + ROW_SHARE·RMS(row),
# so the limit scales with the output, which at Gemma3-27B's widths is
# ~0.02-0.05 per element. ROUNDING is one bf16 ulp (both sides round to
# bf16); ROW_SHARE allows the kernel's bf16 P in P·V (relative error
# 2^-9 per p: ~2^-10 of the row's RMS per element, ~2^-7.3 at the worst
# of 16 M elements) and stays below what one dropped 64-key tile or chunk
# changes (~0.1-0.2 of the row's RMS at 4,096 or 7,373 keys).
ROUNDING = 2.0**-7
ROW_SHARE = 2.0**-6

# B, S, T, H, KV, hd, causal, window: the reference's grid
# (tests/test_kernel_flash_attention.py:10), a ragged S = 96 (the
# kernel's tiles are 64 and 128 rows), T > S (sequence ends aligned), no
# mask, and hd = 30 (rows not 16-byte multiples: the scalar loads)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 4, 4, 32, True, 64),
    (2, 256, 256, 8, 2, 128, True, 0),
    (1, 128, 128, 2, 1, 80, True, 32),
    (1, 64, 64, 1, 1, 16, True, 0),
    (2, 128, 128, 6, 3, 48, True, 0),
    (1, 96, 96, 4, 2, 64, True, 0),
    (2, 64, 128, 4, 2, 64, True, 0),
    (1, 192, 192, 4, 2, 128, False, 0),
    (1, 80, 80, 2, 1, 30, True, 16),
]
# B, KV, G, hd, C, row 0 empty: the reference's grid
# (tests/test_kernel_decode_attention.py:10) at 70 % valid slots, hd = 30
# (the scalar loads), then a row with no valid slot
DECODE_CASES = [
    (2, 2, 4, 64, 256, False),
    (1, 4, 2, 128, 512, False),
    (2, 1, 8, 80, 128, False),
    (3, 2, 1, 64, 64, False),
    (2, 2, 2, 30, 100, False),
    (2, 2, 2, 64, 128, True),
]


def _tol(dtype, f32, bf16):
    import torch

    return f32 if dtype == torch.float32 else bf16


def randn(shape, dtype, gen, device):
    """Standard normal values drawn in f32 from ``gen``, cast to dtype."""
    import torch

    return torch.randn(shape, generator=gen, device=device).to(dtype)


def close(label, got, want, atol, rtol) -> float:
    """Max abs error of ``got`` against ``want``; fatal beyond
    ``atol + rtol * |want|`` anywhere, or on a value that is not finite."""
    import torch

    err = (got.float() - want.float()).abs()
    worst = float(err.max())
    if bool((err > atol + rtol * want.float().abs()).any()) \
            or not bool(torch.isfinite(got.float()).all()):
        raise SystemExit(f"{label}: max_abs_err {worst} beyond atol {atol}, "
                         f"rtol {rtol}")
    return worst


def row_share(got, want) -> tuple:
    """(max abs error, the largest share of its row's RMS that an
    element's error takes beyond ROUNDING·|want|), over the last axis; an
    element of a zero row must be exact (share inf otherwise)."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - ROUNDING * want.abs()).clamp_min(0)
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt().expand_as(excess)
    share = torch.where(rms > 0, excess / rms,
                        torch.where(excess > 0, math.inf, 0.0))
    if not bool(torch.isfinite(got).all()):
        return math.inf, math.inf
    return float(err.max()), float(share.max())


def check_rows(label, got, want) -> tuple:
    """``row_share``, fatal above ROW_SHARE or on a value that is not
    finite."""
    err, share = row_share(got, want)
    if not share <= ROW_SHARE:
        raise SystemExit(f"{label}: an error takes {share} of its row's RMS "
                         f"beyond {ROUNDING}·|want| (limit {ROW_SHARE}); "
                         f"max_abs_err {err}")
    return err, share


def must_reject(label, wrong, want) -> float:
    """A planted wrong result must fail ``check_rows``: shows the row
    limit is tight enough to see that fault. Returns its share."""
    share = row_share(wrong, want)[1]
    if share <= ROW_SHARE:
        raise SystemExit(f"{label}: the row check passes a planted fault "
                         f"(share {share} <= {ROW_SHARE})")
    return share


def check_mass(label, mass, valid, heads) -> None:
    """The mass sums to KV·G on every row with a valid slot and is 0 on
    every other row."""
    import torch

    has = valid.any(dim=1)
    sums = mass.double().sum(dim=1)
    if not torch.allclose(sums[has], torch.full_like(sums[has], heads),
                          rtol=1e-4, atol=0.0) or bool((mass[~has] != 0).any()):
        raise SystemExit(f"{label}: the mass does not sum to {heads} per "
                         f"row: {sums.tolist()[:8]}")


def check_attention_cases(device) -> tuple:
    """Kernels 5 and 6 against their plain versions on the cases above,
    f32 and bf16: flash at atol = rtol = 2e-5 (f32) / 2e-2 (bf16); decode
    ctx at 3e-5 / 3e-2, mass at atol 2e-5, rtol 2e-4, and its sums; flash
    and ctx also row by row (``check_rows``). Returns the worst max abs
    error and the worst row share of each kernel."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(500)
    worst = {FLASH: 0.0, DECODE: 0.0}
    shares = {FLASH: 0.0, DECODE: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol = _tol(dtype, 2e-5, 2e-2)
        for B, S, T, H, KV, hd, causal, window in FLASH_CASES:
            q = randn((B, S, H, hd), dtype, gen, device)
            k = randn((B, T, KV, hd), dtype, gen, device)
            v = randn((B, T, KV, hd), dtype, gen, device)
            label = (f"{FLASH} vs plain [{name} B={B} S={S} T={T} H={H} "
                     f"KV={KV} hd={hd} causal={causal} window={window}]")
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            got = flash_attention_kernel(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = close(label, got, want, tol, tol)
            share = check_rows(label, got, want)[1]
            log(f"{label}: within {tol} (max_abs_err {err:.3g}, row share "
                f"{share:.3g})")
            worst[FLASH] = max(worst[FLASH], err)
            shares[FLASH] = max(shares[FLASH], share)
        tol = _tol(dtype, 3e-5, 3e-2)
        for B, KV, G, hd, C, empty_row in DECODE_CASES:
            q = randn((B, KV, G, hd), dtype, gen, device)
            k = randn((B, C, KV, hd), dtype, gen, device)
            v = randn((B, C, KV, hd), dtype, gen, device)
            valid = torch.rand((B, C), generator=gen, device=device) < 0.7
            if empty_row:
                valid[0] = False
            label = (f"{DECODE} vs plain [{name} B={B} KV={KV} G={G} hd={hd} "
                     f"C={C}{' row 0 empty' if empty_row else ''}]")
            want_ctx, want_mass = decode_attention_ref(q, k, v, valid)
            ctx, mass = decode_attention_kernel(q, k, v, valid)
            torch.cuda.synchronize()
            err = close(label + " ctx", ctx, want_ctx, tol, tol)
            share = check_rows(label + " ctx", ctx, want_ctx)[1]
            err_m = close(label + " mass", mass, want_mass, 2e-5, 2e-4)
            check_mass(label, mass, valid, KV * G)
            log(f"{label}: ctx within {tol} (max_abs_err {err:.3g}, row "
                f"share {share:.3g}), mass within 2e-5 + 2e-4 (max_abs_err "
                f"{err_m:.3g})")
            worst[DECODE] = max(worst[DECODE], err, err_m)
            shares[DECODE] = max(shares[DECODE], share)
    return worst, shares


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls after ``warmup``,
    with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, calls: int = 4) -> list:
    """The device kernels ``calls`` calls of ``fn`` run, longest first:
    (name cut to 100 characters, ms per launch, launches seen; the
    profiler may miss a window's first launch). Which backend a library
    call took, and where a kernel's passes spend their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(e.key[:100], dev_us(e) / 1e3 / max(e.count, 1), e.count)
            for e in sorted(events, key=dev_us, reverse=True)[:4]]


def sdpa(q, k, v, **kw):
    """``F.scaled_dot_product_attention`` with kv-heads shared by G
    q-heads: ``enable_gqa`` where the installed torch has it, else K and
    V expanded first (outside any timed region: returns the call)."""
    import torch.nn.functional as F

    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                      **kw)
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def bound(nbytes: int, flops: int) -> dict:
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(nbytes / HBM_BYTES_PER_S,
                             flops / BF16_FLOPS_PER_S) * 1e3,
                bound_by="bytes" if by_bytes else "operations")


def flash_bound(q, k, causal, window) -> dict:
    """Least work: q, k, v read once and out written once; 4·hd FLOPs per
    allowed (q, k) pair per q-head (q·k and p·v, a multiply-add each)."""
    from repro_torch.kernels.flash_attention.ref import allowed_pairs

    B, S, H, hd = q.shape
    T = k.shape[1]
    pairs = int(allowed_pairs(S, T, causal, window).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return dict(pairs=pairs, **bound(nbytes, 4 * B * H * hd * pairs))


def decode_bound(q, k, valid) -> dict:
    """Least work, from this run's mask: q, valid and the K and V rows of
    the valid slots read once, ctx and the f32 mass written once; 4·hd
    FLOPs per valid slot per q-head."""
    B, KV, G, hd = q.shape
    n_valid = int(valid.sum())
    esize = q.element_size()
    nbytes = (esize * (2 * q.numel() + 2 * n_valid * KV * hd)
              + valid.numel() + 4 * valid.numel())
    return dict(valid_slots=n_valid,
                **bound(nbytes, 4 * n_valid * KV * G * hd))


def attention_inputs(device, seed):
    """The full-width operands at Gemma3-27B's widths, bf16, from ``seed``:
    one 4k prefill chunk (B = 1, S = T = 4,096) and a decode step of B = 8
    over the 8,192-slot heavy-hitter cache, 90 % of its slots valid."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    H, KV, hd = GEMMA["H"], GEMMA["KV"], GEMMA["hd"]
    bf16 = torch.bfloat16
    flash = (randn((1, PREFILL, H, hd), bf16, gen, device),
             randn((1, PREFILL, KV, hd), bf16, gen, device),
             randn((1, PREFILL, KV, hd), bf16, gen, device))
    C, B = GEMMA["budget"], DECODE_BATCH
    decode = (randn((B, KV, H // KV, hd), bf16, gen, device),
              randn((B, C, KV, hd), bf16, gen, device),
              randn((B, C, KV, hd), bf16, gen, device),
              torch.rand((B, C), generator=gen, device=device) < VALID_SHARE)
    return flash, decode


def _swap_heads(t, dim):
    """``t`` with kv-heads 0 and 1 swapped along ``dim``."""
    import torch

    perm = list(range(t.shape[dim]))
    perm[0], perm[1] = 1, 0
    return t.index_select(dim, torch.tensor(perm, device=t.device))


def planted_flash(label, q, k, v, window, want) -> dict:
    """The plain version with one fault planted, each of which the row
    check must reject: the P·V of keys 64-127 (one of the kernel's kv
    tiles) dropped, and q-heads 0-3 reading the wrong kv-head."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    v_tile = v.clone()
    v_tile[:, 64:128] = 0
    wrong = {"kv tile dropped": (k, v_tile),
             "wrong kv-head": (_swap_heads(k, 2), _swap_heads(v, 2))}
    return {name: must_reject(f"{label} planted {name}", flash_attention_ref(
                q, kk, vv, causal=True, window=window), want)
            for name, (kk, vv) in wrong.items()}


def planted_decode(label, q, k, v, valid, want_ctx) -> dict:
    """As ``planted_flash`` for the decode context: cache slots 64-127
    (one of the kernel's chunks) dropped from P·V, and q-heads of
    kv-heads 0 and 1 reading each other's caches."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    v_chunk = v.clone()
    v_chunk[:, 64:128] = 0
    wrong = {"chunk dropped": (k, v_chunk),
             "wrong kv-head": (_swap_heads(k, 2), _swap_heads(v, 2))}
    return {name: must_reject(f"{label} planted {name}", decode_attention_ref(
                q, kk, vv, valid)[0], want_ctx)
            for name, (kk, vv) in wrong.items()}


def attention_phase(device, seed=6) -> tuple:
    """The attention path at Gemma3-27B's widths through the entry points
    ``flash_attention`` (global: causal; local: window 1,024) and
    ``decode_attention`` (the heavy-hitter cache), with every launch
    counter reset before and read after: each kernel launched once per
    call, no other kernel. Then each result against its plain version,
    two decode launches bit-equal, and the times: kernel, plain, bound,
    and one SDPA call. Returns (the kernels line's entries, a summary)."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.flash_attention.ref import (allowed_pairs,
                                                         flash_attention_ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    torch.backends.cudnn.allow_tf32 = False         # run in true f32
    t0 = time.perf_counter()
    worst, case_shares = check_attention_cases(device)
    log(f"attention kernels vs plain: {2 * len(FLASH_CASES)} flash and "
        f"{2 * len(DECODE_CASES)} decode cases within tolerance "
        f"({time.perf_counter() - t0:.1f} s)")

    (q, k, v), (dq, dk, dv, valid) = attention_inputs(device, seed)
    window = GEMMA["window"]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_global = flash_attention(q, k, v, causal=True, window=0)
    out_local = flash_attention(q, k, v, causal=True, window=window)
    ctx, mass = decode_attention(dq, dk, dv, valid)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    want = {FLASH: 2, DECODE: 1}
    if any(n != want.get(name, 0) for name, n in counts.items()):
        raise SystemExit(f"attention path: launches {counts}, expected {want}")
    log(f"attention path (flash global, flash local, decode hh): {path_ms:.3f}"
        f" ms wall, launches {want}")

    runs = {}
    specs = (("flash global", 0, out_global), ("flash local", window,
                                               out_local))
    for label, win, out in specs:
        plain = lambda: flash_attention_ref(q, k, v, causal=True, window=win)
        want = plain()
        err, share = check_rows(label, out, want)
        planted = planted_flash(label, q, k, v, win, want)
        del want
        kern = lambda: flash_attention_kernel(q, k, v, causal=True, window=win)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if win:
            mask = allowed_pairs(PREFILL, PREFILL, True, win, device)
            lib = sdpa(qh, kh, vh, attn_mask=mask)
        else:
            lib = sdpa(qh, kh, vh, is_causal=True)
        lib_err = float((lib().transpose(1, 2).float() - out.float())
                        .abs().max())
        runs[label] = dict(
            shape=dict(B=1, S=PREFILL, T=PREFILL, H=GEMMA["H"],
                       KV=GEMMA["KV"], hd=GEMMA["hd"], window=win,
                       dtype="bfloat16"),
            max_abs_err=err, row_share=share, row_share_limit=ROW_SHARE,
            planted_row_shares=planted, ms=time_ms(kern, 20),
            kernel_device_ms=device_kernels(kern), plain_ms=time_ms(plain, 3),
            library_ms=time_ms(lib, 20), library_kernels=device_kernels(lib),
            library_max_abs_diff=lib_err,
            **flash_bound(q, k, True, win))
        del qh, kh, vh, lib
        log(f"{label}: {json.dumps(runs[label])}")
        torch.cuda.empty_cache()

    label = "decode hh"
    want_ctx, want_mass = decode_attention_ref(dq, dk, dv, valid)
    err, share = check_rows(label + " ctx", ctx, want_ctx)
    err = max(err, close(label + " mass", mass, want_mass, 2e-5, 2e-4))
    check_mass(label, mass, valid, GEMMA["H"])
    planted = planted_decode(label, dq, dk, dv, valid, want_ctx)
    again = decode_attention_kernel(dq, dk, dv, valid)
    if not (torch.equal(again[0], ctx) and torch.equal(again[1], mass)):
        raise SystemExit("decode hh: two launches on the same inputs differ")
    B, KV, G, hd = dq.shape
    qh = dq.reshape(B, KV * G, 1, hd)
    kh, vh = (t.transpose(1, 2).contiguous() for t in (dk, dv))
    lib = sdpa(qh, kh, vh, attn_mask=valid[:, None, None, :])
    lib_err = float((lib().reshape(ctx.shape).float() - ctx.float())
                    .abs().max())
    runs[label] = dict(
        shape=dict(B=B, C=GEMMA["budget"], KV=KV, G=G, hd=hd,
                   valid_share=VALID_SHARE, dtype="bfloat16"),
        max_abs_err=err, row_share=share, row_share_limit=ROW_SHARE,
        planted_row_shares=planted, mass_bit_equal_across_launches=True,
        ms=time_ms(lambda: decode_attention_kernel(dq, dk, dv, valid), 20),
        kernel_device_ms=device_kernels(
            lambda: decode_attention_kernel(dq, dk, dv, valid)),
        plain_ms=time_ms(lambda: decode_attention_ref(dq, dk, dv, valid), 3),
        library_ms=time_ms(lib, 20), library_kernels=device_kernels(lib),
        library_max_abs_diff=lib_err, library_computes="ctx only, no mass",
        **decode_bound(dq, dk, valid))
    log(f"{label}: {json.dumps(runs[label])}")

    root = "src/repro_torch/kernels"
    entries = []
    for name, run, src, ref in (
            (FLASH, runs["flash global"], "flash_attention/csrc/"
             "flash_attention.cu", "flash_attention/kernel.py:82"),
            (DECODE, runs["decode hh"], "decode_attention/csrc/"
             "decode_attention.cu", "decode_attention/kernel.py:61")):
        entries.append({
            "name": name, "route": "cuda", "source": f"{root}/{src}",
            "replaces": f"src/repro/kernels/{ref}",
            "max_abs_err": max(worst[name], run["max_abs_err"]),
            "ms": run["ms"], "plain_ms": run["plain_ms"],
            "bound_ms": run["bound_ms"], "bound_by": run["bound_by"],
            "library_ms": run["library_ms"]})
    for entry in entries:
        entry["launches"] = counts[entry["name"]]
    return entries, dict(case_max_abs_err=worst, case_row_share=case_shares,
                         path_wall_ms=path_ms, runs=runs)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention.kernel import \
        SOURCE as DECODE_SOURCE
    from repro_torch.kernels.flash_attention.kernel import \
        SOURCE as FLASH_SOURCE
    from repro_torch.kernels.sketch_update import kernel, ops, ref
    from repro_torch.sketch.api import SketchSpec
    from repro_torch.sketch.state import SketchState

    device = torch.device("cuda")
    card = gpu_line()
    log(f"device: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = (*kernel.SOURCES, FLASH_SOURCE, DECODE_SOURCE)
    t0 = time.perf_counter()
    _build.build(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({len(sources)} sources in parallel)")

    worst = check_all_cases(device)

    B = 65536
    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="kernel")
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="kernel")
    a_spec = dataclasses.replace(main_spec, shards=None, backend="block")
    b_spec = dataclasses.replace(main_spec, backend="block")
    lazy_block_spec = dataclasses.replace(lazy_spec, backend="block")
    serial_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                             variant="sspm", bits=24)
    main_stream = make_stream(64, B, seed=1)
    lazy_stream = make_stream(16, B, seed=2)

    runs, last = {}, {}
    fused, split = "sketch_update_kernel_fused", "sketch_residual_kernel"
    runs["main"], last["main"], main_bank = run_path(
        "main sspm shards=128", main_spec, main_stream, B, device, 2.0,
        fused, fused_path, ref.fused_update_ref)
    runs["lazy"], _, lazy_bank = run_path(
        "lazy k=2000", lazy_spec, lazy_stream, B, device, 1.0, fused,
        fused_path, ref.fused_update_ref)
    runs["path_a"], last["path_a"], _ = run_path(
        "block sspm k=400000", a_spec, make_stream(32, B, seed=4), B, device,
        2.0, split, split_path, ref.residual_phase)
    runs["lazy_block"], _, bank = run_path(
        "block lazy k=2000", lazy_block_spec, lazy_stream, B, device, 1.0,
        split, split_path, ref.residual_phase)
    if not _same(bank, lazy_bank):
        raise SystemExit("the block backend's lazy bank differs from the "
                         "kernel backend's")
    runs["path_b"], last["path_b"], bank = run_path(
        "block sspm shards=128", b_spec, main_stream, B, device, 2.0, split,
        split_path, ref.residual_phase)
    if not _same(bank, main_bank):
        raise SystemExit("path B's bank differs from the kernel backend's")

    def banked(bank, it, w):
        return ops.sketch_block_update_banked(
            bank, *_router(main_spec, bank).route_dense(it, w), 2)

    runs["banked"], last["banked"], bank = run_ops_path(
        "banked sspm shards=128", main_spec, main_stream, B, device, 2.0,
        "sketch_residual_kernel_banked", banked_path, banked,
        ref.residual_phase_banked)
    if not _same(bank, main_bank):
        raise SystemExit("the banked split path's bank differs from the "
                         "fused path's")

    def serial(bank, it, w):
        out = ops.sketch_block_update_serial(
            SketchState(*(t[0] for t in bank)), it, w, 2)
        return SketchState(*(t[None] for t in out))

    runs["serial"], last["serial"], _ = run_ops_path(
        "serial sspm k=4000", serial_spec, make_stream(8, B, seed=5), B,
        device, 2.0, "sketch_update_kernel_serial", serial_path, serial)

    times = {
        fused: time_kernel(kernel.sketch_update_kernel_fused,
                           ref.fused_update_ref, last["main"], 2,
                           fused_bound, 20, 3),
        "sketch_residual_kernel_banked": time_kernel(
            kernel.sketch_residual_kernel_banked, ref.residual_phase_banked,
            last["banked"], 2, banked_bound, 20, 3),
        split: time_kernel(kernel.sketch_residual_kernel,
                           ref.residual_phase, last["path_a"], 2,
                           split_bound, 10, 1),
        "sketch_update_kernel_serial": time_kernel(
            kernel.sketch_update_kernel_serial, ref.serial_update_ref,
            last["serial"], 2, serial_bound, 3, 1),
    }
    times_b = time_kernel(kernel.sketch_residual_kernel, ref.residual_phase,
                          last["path_b"], 2, split_bound, 10, 1)
    for name, t in times.items():
        log(f"{name} at its run's shapes: {json.dumps(t)}")
    log(f"sketch_residual_kernel at path B's shapes: {json.dumps(times_b)}")
    prof = {label: profile_blocks(spec, B, 8, seed=3, device=device)
            for label, spec in (("main", main_spec), ("lazy", lazy_spec),
                                ("path_a", a_spec), ("path_b", b_spec))}
    log(f"profile of the sessions: {json.dumps(prof)}")
    attention_entries, attention = attention_phase(device)

    replaces = {fused: 144, "sketch_residual_kernel_banked": 278,
                split: 220, "sketch_update_kernel_serial": 396}
    source = {fused: "fused_update.cu",
              "sketch_residual_kernel_banked": "fused_update.cu",
              split: "residual.cu",
              "sketch_update_kernel_serial": "serial_update.cu"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/sketch_update/csrc/{source[name]}",
        "replaces": f"src/repro/kernels/sketch_update/kernel.py:{replaces[name]}",
        "launches": sum(r["launches"] for r in runs.values()
                        if r["kernel"] == name),
        "max_abs_err": worst[name],
        "ms": times[name]["ms"],
        "plain_ms": times[name]["plain_ms"],
        "bound_ms": times[name]["bound_ms"],
        "bound_by": times[name]["bound_by"],
        "library_ms": None,   # no PyTorch call computes these chains
    } for name in KERNELS] + attention_entries
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, runs=runs, kernel_times=times,
        residual_times_path_b=times_b, profile=prof, attention=attention,
        kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
