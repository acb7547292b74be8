"""Serving launcher (counterpart of ``repro/launch/serve.py``): batched
greedy generation with the SS± KV cache through ``ServeEngine``.

    python -m repro_torch.launch.serve --arch gemma3_27b --smoke \
        --prompt-len 64 --max-new 32 --batch 4 --device cpu

Weights are random, from seed 0; prompts (and LLaVA's patch embeddings,
Whisper's frames) from seed 1. ``--device`` defaults to ``cuda`` and
raises without a card.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--context", type=int, default=0)
    ap.add_argument("--decay-period", type=int, default=8192)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.platform import resolve_device
    from repro_torch.serve import ServeEngine

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    ctx = args.context or (args.prompt_len + args.max_new)
    params, _ = build_model(cfg).init(0, device=device)
    engine = ServeEngine(cfg=cfg, params=params, context=ctx,
                         decay_period=args.decay_period, device=device)

    B = args.batch
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size,
                         (B, args.prompt_len - cfg.vision_tokens),
                         generator=gen, device=device, dtype=torch.int32)
    kw = {}
    if cfg.vision_tokens:
        kw["vision"] = torch.randn((B, cfg.vision_tokens, cfg.d_model),
                                   generator=gen, device=device
                                   ).to(torch.bfloat16)
    if cfg.family == "encdec":
        kw["frames"] = torch.randn((B, cfg.encoder_frames, cfg.d_model),
                                   generator=gen, device=device
                                   ).to(torch.bfloat16)
    t0 = time.time()
    out = engine.generate(toks, max_new_tokens=args.max_new, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"generated {out['tokens'].shape} in {dt:.2f}s "
          f"({B * out['steps'] / dt:.1f} tok/s)")
    print("sample:", out["tokens"][0, -16:].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
