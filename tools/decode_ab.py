#!/usr/bin/env python3
"""Time kernel 6 (decode attention with per-slot mass) of this checkout
against another's.

    python3 tools/decode_ab.py OTHER_CHECKOUT [--calls N] [--rounds M]

OTHER_CHECKOUT holds another version of the repo (for example the parent
commit, unpacked with ``git archive``); its ``repro_torch`` is loaded
beside this one under another name (``residual_ab.other_kernels``), so
each side runs its own full wrapper (``decode_attention_kernel``:
checks, allocations, launches) and its own CUDA source, built with nvcc
into its checkout's ``build/``. Both run on the same operands:

- ``serving hh``: Gemma3-27B's SS± heavy-hitter cache in a decode step
  of ``chip_smoke.py``'s model run (B = 2, C = 8,192, KV = 16, G = 2,
  hd = 128, bf16), full, as the serving path gives it;
- ``serving ring``: a sliding-window ring cache of the same run (C =
  1,024), full;
- ``decode hh``: the attention phase's case (``chip_smoke.
  attention_inputs``: B = 8, C = 8,192, 90 % of the slots valid).

A round times each side in the order other, this, this, other: device ms
per call and per launch from the profiler over N calls
(``chip_smoke.decode_device_ms``), with the L2 evicted before each call
(a decode step reads each layer's cache once) and warm from the call
before, each the median span of a call (``chip_smoke.device_span_ms``)
beside the profiler's ms per launch; the host's ms per call
(``chip_smoke.host_ms``); and CUDA events
around 20 calls in a row (``chip_smoke.time_ms``, which runs at the
slower of host and device). Every output is held to the plain version
(``ref.py``): ctx row by row (``chip_smoke.check_rows``), the mass within
atol 2e-5, rtol 2e-4 and its sums. Prints one JSON line per case (every
sample, each side's medians, the bound, and the time a torch reduction
takes to read the same caches, L2 cold, where every slot is valid) and
the card's name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

KEYS = ("device_ms_cold", "device_ms_warm", "host_ms", "event_ms")


def serving_case(C, device, seed):
    """The serve layout at Gemma3-27B's widths, bf16, every slot valid."""
    import torch

    import chip_smoke as cs

    gen = torch.Generator(device=device).manual_seed(seed)
    KV, hd, H = cs.GEMMA["KV"], cs.GEMMA["hd"], cs.GEMMA["H"]
    bf16 = torch.bfloat16
    return (cs.randn((2, KV, H // KV, hd), bf16, gen, device),
            cs.randn((2, C, KV, hd), bf16, gen, device),
            cs.randn((2, C, KV, hd), bf16, gen, device),
            torch.ones((2, C), dtype=torch.bool, device=device))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from residual_ab import other_kernels

    device = torch.device("cuda")
    other_kernels(opts.other.resolve())   # registers other_repro_torch
    theirs = importlib.import_module(
        "other_repro_torch.kernels.decode_attention.kernel")
    sides = {"other": theirs.decode_attention_kernel,
             "this": kernel.decode_attention_kernel}
    cases = (("serving hh", serving_case(cs.GEMMA["budget"], device, 24)),
             ("serving ring", serving_case(cs.GEMMA["window"], device, 25)),
             ("decode hh", cs.attention_inputs(device, 6)[1]))
    for label, ops in cases:
        q, k, v, valid = ops
        want_ctx, want_mass = decode_attention_ref(*ops)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other") * opts.rounds:
            fn = lambda: sides[who](*ops)
            ctx, mass = fn()
            torch.cuda.synchronize()
            name = f"{label} ({who})"
            cs.check_rows(name + " ctx", ctx, want_ctx)
            cs.close(name + " mass", mass, want_mass, 2e-5, 2e-4)
            cs.check_mass(name, mass, valid, q.shape[1] * q.shape[2])
            cold = cs.decode_device_ms(fn, opts.calls, cold=True)
            warm = cs.decode_device_ms(fn, opts.calls)
            times[who].append(dict(
                device_ms_cold=cold["per_call_ms"],
                device_ms_warm=warm["per_call_ms"],
                per_launch_cold=cold["per_launch"],
                per_launch_warm=warm["per_launch"],
                host_ms=cs.host_ms(fn), event_ms=cs.time_ms(fn, 20)))
        median = {who: {key: statistics.median(t[key] for t in ts)
                        for key in KEYS} for who, ts in times.items()}
        # the same bytes read by a torch reduction, L2 cold: what a
        # streaming read reaches on this card
        live = valid.all()
        read = (lambda: (k.sum(dtype=torch.float32),
                         v.sum(dtype=torch.float32)))
        B, KV, G, hd = q.shape
        print(json.dumps(dict(
            case=label, shape=dict(B=B, C=k.shape[1], KV=KV, G=G, hd=hd,
                                   valid_slots=int(valid.sum())),
            median=median, samples=times, held_to_plain=True,
            torch_read_ms_cold=statistics.median(
                cs.device_span_ms(read, opts.calls, cold=True))
            if bool(live) else None,
            this_layout=kernel.decode_layout(B, k.shape[1], KV, G,
                                             hd)._asdict(),
            **cs.decode_bound(q, k, valid))), flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
