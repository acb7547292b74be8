"""Long-context serving with the SS± heavy-hitter KV cache, on the
PyTorch port.

The counterpart of ``examples/serve_h2o.py`` on ``repro_torch``, with
the same steps, sizes and prints: a gemma3-style model (5:1 local:global
attention) decodes far past the dense-cache budget; global layers keep
only the SS± heavy-hitter set. The generated tokens are compared with a
dense-cache reference to show that the heavy-hitter cache tracks it.
Prefill runs kernel 5 (flash attention), decode kernel 6 (decode
attention over the cache) on the card. ``--device`` (default ``cuda``)
is where the model runs; without a card, ``cuda`` raises.

    PYTHONPATH=src python examples_torch/serve_h2o.py [--device cpu]
"""
import argparse

import torch

import repro_torch.serve.kv_cache as kvc
from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda or cpu)")
    device = ap.parse_args().device

    cfg = configs.get_smoke("gemma3_27b")
    model = build_model(cfg)
    params, _ = model.init(0, device=device)

    B, prompt_len, new_tokens = 2, 48, 24
    ctx = prompt_len + new_tokens
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, prompt_len), generator=gen,
                           device=device, dtype=torch.int32)

    # reference: dense caches everywhere
    eng_dense = ServeEngine(cfg=cfg, params=params, context=ctx,
                            device=device)
    out_dense = eng_dense.generate(prompt, max_new_tokens=new_tokens)

    # SS± eviction: force the hh path at smoke scale (production trigger
    # is context > 64k; here we lower it to exercise the machinery)
    old = kvc.HH_ENGAGE_CTX
    kvc.HH_ENGAGE_CTX = 16
    try:
        eng_hh = ServeEngine(cfg=cfg, params=params, context=ctx,
                             decay_period=32, device=device)
        out_hh = eng_hh.generate(prompt, max_new_tokens=new_tokens)
    finally:
        kvc.HH_ENGAGE_CTX = old

    dense_toks = out_dense["tokens"][:, prompt_len:]
    hh_toks = out_hh["tokens"][:, prompt_len:]
    agree = (dense_toks == hh_toks).mean()
    budget = cfg.hh_kv_budget
    print(f"context {ctx}, global-layer budget {budget} slots "
          f"(vs dense {ctx})")
    print(f"dense  : {dense_toks[0][:12].tolist()}")
    print(f"ss±-hh : {hh_toks[0][:12].tolist()}")
    print(f"agreement with dense reference: {agree*100:.0f}% "
          f"(greedy decode, random weights — divergence compounds)")
    print("ok: long-context decode ran with bounded global-layer KV.")


if __name__ == "__main__":
    main()
