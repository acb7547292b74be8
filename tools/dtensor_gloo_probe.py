"""Probe: DTensor's collectives on a gloo group whose tensors are on the
card. Starts 2 ranks of a gloo group over a FileStore (no network), both
on cuda:0, lays an (8, 12) f32 tensor out on a (1, 2) ("data",
"model") mesh and tries, one at a time: a redistribute of Shard(0) to
Replicate and to Shard(1), a matmul of two DTensors, a Partial to
Replicate and to Shard, and ``full_tensor()``. Each rank prints a JSON
line of the outcomes; a rank that crashes (a segfault inside a
collective) shows as its exit code.

    python3 tools/dtensor_gloo_probe.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile


def child(rank: int, world: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cuda", (1, world),
                            mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(8, 12, generator=gen).cuda()
    b = torch.randn(12, 6, generator=gen).cuda()
    da = DTensor.from_local(a.chunk(world, 0)[rank], mesh,
                            [Replicate(), Shard(0)], run_check=False)
    db = DTensor.from_local(b.chunk(world, 0)[rank], mesh,
                            [Replicate(), Shard(0)], run_check=False)
    pa = DTensor.from_local(torch.full((4,), float(rank + 1)).cuda(), mesh,
                            [Replicate(), Partial()], run_check=False)
    whole = [Replicate(), Replicate()]
    cases = {
        "shard0_to_replicate": lambda: float(
            (da.redistribute(mesh, whole).to_local() - a).abs().max()),
        "shard0_to_shard1": lambda: float(
            (da.redistribute(mesh, [Replicate(), Shard(1)]).to_local()
             - a.chunk(world, 1)[rank]).abs().max()),
        "matmul": lambda: float(
            ((da.redistribute(mesh, [Replicate(), Shard(1)]) @ db)
             .redistribute(mesh, whole).to_local() - a @ b).abs().max()),
        "partial_to_replicate": lambda: pa.redistribute(
            mesh, whole).to_local().tolist(),
        "partial_to_shard": lambda: pa.redistribute(
            mesh, [Replicate(), Shard(0)]).to_local().tolist(),
        "full_tensor": lambda: float((da.full_tensor() - a).abs().max()),
    }
    out = {}
    for name, fn in cases.items():
        print(f"rank {rank}: {name} ...", flush=True)
        try:
            out[name] = fn()
        except Exception as e:           # report, and go on to the next
            out[name] = f"raised {type(e).__name__}: {e}"[:300]
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, **out}), flush=True)


def main() -> int:
    import torch

    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-X", "faulthandler", __file__, "--rank",
             str(r), "2", f"{tmp}/store"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        for r, p in enumerate(procs):
            log = p.communicate(timeout=300)[0]
            print(f"--- rank {r} exit {p.returncode}\n{log[-3000:]}",
                  flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
