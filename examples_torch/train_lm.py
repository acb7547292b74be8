"""End-to-end run on the PyTorch port: train a ~100M-param qwen3-style
LM for a few hundred steps with the full production stack — data
pipeline, AdamW, checkpointing, SS± token statistics, straggler monitor.

The counterpart of ``examples/train_lm.py`` on ``repro_torch``, with the
same steps, sizes and prints. On the card the forward's attention is
kernel 5 (its backward the plain VJP) and the token statistics run on
kernel 1. ``--device`` (default ``cuda``) is where the model trains;
without a card, ``cuda`` raises.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 300]

(~100M params: d_model 512, 8 layers, vocab 32000 — a real, if small,
language model; the same Trainer drives the 27B configs on a mesh.)

One departure from the reference: the loss check needs two logged
records. The reference asserts that the last logged loss is below the
first, which fails for any run of 20 steps or fewer, where the two are
one record.
"""
import argparse
import os
import tempfile
import time

from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args()

    cfg = ModelConfig(
        name="lm_100m", family="dense",
        num_layers=8, d_model=512, num_heads=8, num_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32000, qk_norm=True, tie_embeddings=True,
    )
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, zipf_s=1.1)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=100, ckpt_dir=args.ckpt_dir,
        log_every=20, token_stats_capacity=2048, token_stats_window=64,
    )
    opt = AdamWConfig(lr=cosine_schedule(3e-4, warmup=30, total=args.steps))

    trainer = Trainer(cfg, data_cfg, tcfg, opt, device=args.device)
    trainer.install_signal_handlers()
    if trainer.try_resume():
        print(f"resumed from step {trainer.step_num}")

    n_params = sum(x.numel() for x in tree_leaves(trainer.state.params))
    print(f"model: {n_params/1e6:.1f}M params | {args.steps} steps "
          f"| batch {args.batch}x{args.seq}")
    t0 = time.time()
    out = trainer.run()
    dt = time.time() - t0

    for rec in trainer.metrics_log:
        print(f"  step {rec['step']:4d}  loss {rec['loss']:.4f}  "
              f"gnorm {rec['grad_norm']:.2f}  {rec['step_time_s']*1e3:.0f}ms")
    first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} "
          f"in {out['final_step']} steps ({dt:.0f}s)")
    hot = trainer.token_stats.topk(8)
    print(f"SS± hot tokens (window stats): {hot.items.tolist()}")
    print(f"   insertions={hot.insertions} deletions={hot.deletions} "
          f"(empirical alpha={hot.alpha_bound:.2f})")
    # a run of at most log_every (20) steps logs one record, and a loss is
    # never below itself: the trend needs two records
    if len(trainer.metrics_log) > 1:
        assert last["loss"] < first["loss"], "training must reduce loss"
    print("ok.")


if __name__ == "__main__":
    main()
