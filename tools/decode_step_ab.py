#!/usr/bin/env python3
"""Time the serving decode step of this checkout against another's.

    python3 tools/decode_step_ab.py OTHER_CHECKOUT [--rounds M] [--steps N]

Each side runs in a process of its own with its own ``repro_torch`` on
``PYTHONPATH`` (OTHER_CHECKOUT holds another version of the repo, for
example the parent commit unpacked with ``git archive``), in the order
other, this, this, other per round: Gemma3-27B at full width cut to one
period of its layers (6: 5 sliding-window, 1 global with the SS±
heavy-hitter cache), random bf16 weights from seed 23, B = 2 prompts of
8,192 tokens at a 131,072-token context (``chip_smoke.MODEL_MAIN``), one
prefill, then N + 16 greedy decode steps, each timed from the host with a
synchronise; the first 16 are dropped. The step is host-bound (some 700
launches from eager PyTorch), so steps move with the host's load: compare
the sides only within one call. Prints one JSON line per process (median,
mean, min and every step in ms) and the card's name and power limit;
needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WARM = 16


def one_side(steps: int) -> dict:
    """The timed steps, in this process, with the repro_torch it imports."""
    import dataclasses

    import torch
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = configs.get("gemma3_27b")
    pattern, _, _ = cfg.layer_pattern()
    cfg = dataclasses.replace(cfg, num_layers=len(pattern))
    params, _ = build_model(cfg).init(23, device="cuda")
    engine = ServeEngine(cfg, params, 131_072, 16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (2, 8192), generator=gen,
                         device="cuda", dtype=torch.int32)
    logits, cache = engine._prefill(params, {"tokens": toks})
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    times = []
    for _ in range(WARM + steps):
        t0 = time.perf_counter()
        logits, cache, _ = engine._step(params, cache, cur)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[WARM:]
    return dict(package=str(pathlib.Path(repro_torch.__file__).parent),
                median_ms=statistics.median(times),
                mean_ms=statistics.mean(times), min_ms=min(times),
                steps_ms=times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=pathlib.Path, nargs="?")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--steps", type=int, default=32)
    parser.add_argument("--side", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.side:   # a child: time this process's repro_torch
        print(json.dumps(dict(side=opts.side, **one_side(opts.steps))))
        return 0
    import torch

    if not torch.cuda.is_available() or opts.other is None:
        print("decode_step_ab: needs OTHER_CHECKOUT and a CUDA device",
              file=sys.stderr)
        return 1
    src = {"other": opts.other.resolve() / "src", "this": ROOT / "src"}
    for who in ("other", "this", "this", "other") * opts.rounds:
        env = dict(os.environ, PYTHONPATH=str(src[who]))
        out = subprocess.run(
            [sys.executable, __file__, "--side", who, "--steps",
             str(opts.steps)], env=env, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
