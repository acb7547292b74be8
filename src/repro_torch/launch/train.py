"""Training launcher (counterpart of ``repro/launch/train.py``).

Smoke scale on the CPU:
    python -m repro_torch.launch.train --arch qwen3_0_6b --smoke \
        --steps 50 --device cpu

On a mesh of N ranks on this host (a gloo process group over a
``FileStore``, one process per rank, no network device), the data axis
of D and the model axis of M ranks (D x M = N; by default N // 2 x 2):
    python -m repro_torch.launch.train --arch qwen3_0_6b --smoke \
        --emulate-mesh 4 --data-axis 2 --model-axis 2 --steps 2 --device cpu

``--device`` defaults to ``cuda`` and raises without a card. On the card
a rank of the emulated mesh takes ``cuda:<rank % cards>`` and the group
is NCCL's; gloo serves the CPU ranks. Rank 0 prints the log.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--emulate-mesh", type=int, default=0,
                    help="run N ranks of a process group on this host")
    ap.add_argument("--data-axis", type=int, default=0)
    ap.add_argument("--model-axis", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # one rank of --emulate-mesh: RANK STORE_DIR (set by the launcher)
    ap.add_argument("--rank-of", nargs=2, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def mesh_shape(args):
    d = args.data_axis or args.emulate_mesh // 2
    m = args.model_axis or 2
    if d * m != args.emulate_mesh:
        raise SystemExit(f"--data-axis {d} x --model-axis {m} is not "
                         f"--emulate-mesh {args.emulate_mesh}")
    return d, m


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    if args.emulate_mesh and args.rank_of is None:
        from repro_torch.platform import resolve_device

        resolve_device(args.device)
        mesh_shape(args)
        return _spawn(argv, args.emulate_mesh)
    return _train(args)


def _spawn(argv, n: int) -> int:
    """Start ``n`` ranks of this launcher, each joining one group over a
    FileStore in a fresh directory; wait for all. Rank 0's output is
    this process's; the others' is shown only if they fail."""
    with tempfile.TemporaryDirectory() as store:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--rank-of", str(r), store],
            stdout=None if r == 0 else subprocess.PIPE,
            stderr=None if r == 0 else subprocess.STDOUT, text=True)
            for r in range(n)]
        logs = [p.communicate()[0] for p in procs]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in bad:
        if logs[r]:
            sys.stderr.write(f"rank {r} exited {procs[r].returncode}:\n"
                             f"{logs[r][-4000:]}\n")
    return 1 if bad else 0


def _train(args) -> int:
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.parallel.sharding import default_rules
    from repro_torch.platform import resolve_device
    from repro_torch.train import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    mesh = rules = None
    rank = 0
    if args.rank_of is not None:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        rank, store = int(args.rank_of[0]), args.rank_of[1]
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(
            "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(store, "store"),
                                 args.emulate_mesh),
            rank=rank, world_size=args.emulate_mesh)
        mesh = init_device_mesh(device.type, mesh_shape(args),
                                mesh_dim_names=("data", "model"))
        rules = default_rules()
    try:
        data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                              seq_len=args.seq_len,
                              global_batch=args.global_batch)
        tcfg = TrainerConfig(total_steps=args.steps,
                             ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir,
                             log_every=args.log_every)
        opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, args.warmup,
                                                 args.steps))
        trainer = Trainer(cfg, data_cfg, tcfg, opt_cfg, mesh=mesh,
                          rules=rules, device=device)
        trainer.install_signal_handlers()
        if args.resume and trainer.try_resume() and rank == 0:
            print(f"resumed from step {trainer.step_num}")
        out = trainer.run()
        if rank == 0:
            for rec in trainer.metrics_log:
                print(rec)
            print("done:", out)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
