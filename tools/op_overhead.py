#!/usr/bin/env python3
"""Host time of kernels 5 and 6's torch ops against their wrappers.

    python3 tools/op_overhead.py [--rounds R]

On one CUDA card: the host microseconds a call of kernel 6's op
(``ops.op``) and of its wrapper (``decode_attention_kernel``) at the
serving shape of Gemma3-27B's SS± cache (q (2, 16, 2, 128) bf16 over
1,024 slots), in turns; then the serving decode step (Gemma3-27B at full
width cut to one period, B = 2 prompts of 8,192 tokens at a 131,072-token
context, ``chip_smoke.MODEL_MAIN``'s shape) with kernel 6 reached
through the op or straight through the wrapper, in one process, in the
order op, wrapper, wrapper, op per round (median ms of 32 timed steps
after 8). Prints one JSON line of each and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def host_us(fn, n=2000) -> float:
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.kernel import (
        SOURCE, decode_attention_kernel)
    from repro_torch.kernels.flash_attention.kernel import SOURCES
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serve import ServeEngine

    _build.build((SOURCE, *SOURCES))
    dev = torch.device("cuda")
    q = torch.randn((2, 16, 2, 128), device=dev, dtype=torch.bfloat16)
    k = torch.randn((2, 1024, 16, 128), device=dev, dtype=torch.bfloat16)
    valid = torch.ones((2, 1024), dtype=torch.bool, device=dev)
    calls = {"wrapper_us": [], "op_us": []}
    for _ in range(args.rounds):
        calls["op_us"].append(host_us(lambda: dops.op(q, k, k, valid)))
        calls["wrapper_us"].append(host_us(
            lambda: decode_attention_kernel(q, k, k, valid)))
    print(json.dumps(calls), flush=True)

    cfg = configs.get("gemma3_27b")
    cfg = dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern()[0]))
    params, _ = build_model(cfg).init(23, device="cuda")
    engine = ServeEngine(cfg, params, 131_072, 16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (2, 8192), generator=gen,
                         device="cuda", dtype=torch.int32)
    logits, cache = engine._prefill(params, {"tokens": toks})
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    class Wrapper:
        op = staticmethod(decode_attention_kernel)

    def steps(n=40):
        nonlocal cache, cur
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            logits, cache, _ = engine._step(params, cache, cur)
            cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out[8:])

    step = {"op": [], "wrapper": []}
    try:
        for _ in range(args.rounds):
            for side in ("op", "wrapper", "wrapper", "op"):
                L.decode_ops = dops if side == "op" else Wrapper
                step[side].append(steps())
    finally:
        L.decode_ops = dops
    print(json.dumps({"decode_step_ms_median": step}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
