"""Multi-pod dry-run: trace one step of every (arch x input-shape x mesh)
cell on a fake process group and count what one rank does.

Counterpart of ``repro/launch/dryrun.py``. The reference lowers and
compiles each cell for 256 or 512 placeholder host devices and reads
XLA's cost and memory analyses and the collectives of its HLO. The port
has no compiler to ask. A cell here starts a fake process group
(``torch.distributed``'s ``"fake"`` backend: every collective returns at
once, nothing leaves the process) of 256 or 512 ranks, builds the
production mesh on it (``launch/mesh.make_production_mesh``), lays the
state out under ``FakeTensorMode`` exactly as on the card (params,
optimizer state, caches and batch as DTensors by their logical axes,
with the reference's rules: ``seq_shard`` for long_500k, ``fsdp=False``
for serving, ``--zero1``), and runs one step of ``train.step``,
``serve.prefill`` or ``serve.decode`` under ``roofline.trace.StepTrace``.
No tensor holds data and nothing is allocated, on the CPU or the card.

Per cell this writes ``<out>/<arch>__<shape>__<mesh>.json``:

- ``memory``: per device, as one rank runs the step, the reference's
  keys: ``argument_size_in_bytes`` (the rank's state and batch shards),
  ``output_size_in_bytes``, ``temp_size_in_bytes`` (the peak of live
  bytes less the arguments') and ``alias_size_in_bytes`` (the donated
  state: the train state, or the decode cache);
- ``cost_raw``: the step's FLOPs (``torch.utils.flop_counter``'s
  formulas; kernels 5 and 6 are ops with formulas of their own) and
  bytes (each op's operands and results), per device;
- ``collectives``: result bytes per kind, per device
  (``roofline.collectives``);
- ``cost_corrected``: the same counts, ``correction_source: "traced
  every layer"``. The reference's P=1/P=2 depth probes correct XLA's
  count of a scan body once; the port's layers run in a Python loop and
  each is traced, so there is nothing to correct (``--no-probe`` is
  taken and changes nothing);
- ``roofline``: ``roofline_terms`` on the per-device counts times
  ``chips``, against the ``gpu_h100`` preset;
- ``kernel_ops``: how many times the step called kernels 5 and 6's ops;

and gzips the op-by-op trace (op, local shapes, the placements of each
DTensor op, FLOPs and bytes) beside it as ``<name>.trace.jsonl.gz``, in
place of the reference's HLO. Counts are a trace's, against the
preset's rates: no time here is measured.

On ``--device cpu`` DTensor runs an all-to-all as an all-gather and a
chunk (a CPU group has no all-to-all), so such a cell counts all-gather
bytes where the card would move all-to-all bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k --mesh single --device cpu
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu --cell-timeout 900

The fake group lives in this process only: run the module as a process
of its own (with ``--cell-timeout`` every cell is one).
"""
from __future__ import annotations

import argparse
import gzip
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, supported_cells
from repro_torch.models import build_model
from repro_torch.models.transformer import tree_map
from repro_torch.parallel import sharding as psh
from repro_torch.roofline.model import roofline_terms
from repro_torch.roofline.trace import StepTrace, tree_bytes

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
KERNEL_OPS = {"flash": "repro_torch::flash_attention",
              "decode": "repro_torch::decode_attention"}


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def input_specs(cfg, shape):
    """(shape, dtype) stand-ins for every model input of this cell."""
    model = build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return model.batch_spec(B, S)
    if shape.kind == "prefill":
        spec = model.batch_spec(B, S)
        spec.pop("labels", None)
        return spec
    return {"tokens": ((B, 1), torch.int32)}


def batch_axes(spec):
    """Logical axes for a batch spec dict."""
    table = {
        "tokens": "batch,seq",
        "labels": "batch,seq",
        "mask": "batch,seq",
        "vision": "batch,seq,embed",
        "frames": "batch,seq,embed",
    }
    return {k: table[k] for k in spec}


def _zeros(spec, device):
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in spec.items()}


# ---------------------------------------------------------------------------
# The fake group
# ---------------------------------------------------------------------------

def fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0 (an earlier group of another size is taken down first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


# ---------------------------------------------------------------------------
# Trace one cell
# ---------------------------------------------------------------------------

def trace_cell(cfg, shape, mesh, rules, train_kw=None, device="cuda",
               keep=True):
    """One step of the cell on ``mesh`` under ``FakeTensorMode``, counted
    by a ``StepTrace``. Returns (trace, memory dict)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serve.decode import build_serve_step
    from repro_torch.serve.kv_cache import build_cache, cache_axes
    from repro_torch.serve.prefill import build_prefill_step
    from repro_torch.train.step import (TrainState, build_train_step,
                                        state_axes)

    train_kw = dict(train_kw or {})
    zero1 = train_kw.pop("zero1", False)
    model = build_model(cfg)
    # the shapes on "meta", then empty fake tensors of them on ``device``:
    # no generator is made (a CUDA generator allocates on the card)
    shapes, axes = model.init(None, device="meta")
    with FakeTensorMode() as fake, psh.use_mesh(mesh, rules):
        params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device=device), shapes)
        if shape.kind == "train":
            state = TrainState(params=params, opt=adamw_init(params))
            s_axes = state_axes(axes)
            if zero1:
                # ZeRO-1: params TP-only, the optimizer state over data
                multi = "pod" in psh.axis_names(mesh)
                with psh.use_mesh(mesh, psh.default_rules(multi_pod=multi,
                                                          fsdp=False)):
                    p = psh.distribute(params, axes)
                state = TrainState(params=p,
                                   opt=psh.distribute(state.opt, s_axes.opt))
            else:
                state = psh.distribute(state, s_axes)
            spec = input_specs(cfg, shape)
            batch = psh.distribute(_zeros(spec, device), batch_axes(spec),
                                   "act")
            step = build_train_step(cfg, **train_kw)
            args, donated = (state, batch), state
        elif shape.kind == "prefill":
            params = psh.distribute(params, axes)
            spec = input_specs(cfg, shape)
            batch = psh.distribute(_zeros(spec, device), batch_axes(spec),
                                   "act")
            step = build_prefill_step(cfg, context=shape.seq_len,
                                      with_cache=True, device=device)
            args, donated = (params, batch), None
        else:
            params = psh.distribute(params, axes)
            B = shape.global_batch
            cache = psh.distribute(build_cache(cfg, B, shape.seq_len, device),
                                   cache_axes(cfg, B, shape.seq_len), "act")
            tokens = psh.lay_out(torch.zeros((B, 1), dtype=torch.int32,
                                             device=device),
                                 psh.lead_spec((B, 1), "batch"))
            step = build_serve_step(cfg, context=shape.seq_len,
                                    device=device)
            args, donated = (params, cache, tokens), cache
        trace = StepTrace(fake_mode=fake, keep=keep)
        trace.hold_arguments(args)
        with trace:
            out = step(*args)
        memory = {
            "argument_size_in_bytes": trace.arguments,
            "output_size_in_bytes": tree_bytes(out),
            "temp_size_in_bytes": trace.temp_bytes(),
            "alias_size_in_bytes": tree_bytes(donated) if donated else 0,
        }
        del out, args, donated
    return trace, memory


def kernel_op_calls(trace) -> dict:
    """How many times the step called kernels 5 and 6's ops."""
    names = {v.replace("::", "."): k for k, v in KERNEL_OPS.items()}
    return {k: trace.calls.get(n, 0) for n, k in names.items()}


def cell_rules(shape, multi: bool):
    """The reference's rules for a cell: ``seq_shard`` for long_500k,
    and params TP-only (``fsdp=False``) for serving."""
    return psh.default_rules(multi_pod=multi,
                             seq_shard=(shape.name == "long_500k"),
                             fsdp=shape.kind == "train")


def record(cfg, shape, trace, memory, chips, train_kw=None) -> dict:
    """The counts of one traced cell as the reference's record fields."""
    coll = trace.collectives()
    cost = {"flops": float(trace.flops), "bytes": float(trace.bytes)}
    corrected = dict(cost, collective=float(coll["total"]))
    terms = roofline_terms(
        hlo_flops_global=corrected["flops"] * chips,
        hlo_bytes_global=corrected["bytes"] * chips,
        collective_bytes_global=corrected["collective"] * chips,
        chips=chips, cfg=cfg, shape=shape,
        microbatches=(train_kw or {}).get("microbatches", 1),
        remat=(train_kw or {}).get("remat", True))
    return {
        "memory": memory,
        "cost_raw": cost,
        "collectives": coll,
        "cost_corrected": corrected,
        "correction_source": "traced every layer",
        "roofline": terms.to_dict(),
        "kernel_ops": kernel_op_calls(trace),
    }


def write_trace(path: Path, trace) -> None:
    with gzip.open(path, "wt") as f:
        for row in trace.rows:
            f.write(json.dumps(row) + "\n")


def run_cell(arch: str, shape_name: str, mesh_kind: str, do_probe: bool = True,
             train_kw=None, suffix: str = "", device: str = "cuda",
             out_dir: Path = OUT_DIR):
    """One production cell on a fake group of 256 (single) or 512 (multi)
    ranks. ``do_probe`` is the reference's and changes nothing here."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "chips": 512 if multi else 256, "device": device, "ok": False,
           "train_kw": train_kw or {}}
    t0 = time.time()
    try:
        fake_group(rec["chips"])
        mesh = make_production_mesh(multi_pod=multi, device=device)
        trace, memory = trace_cell(cfg, shape, mesh, cell_rules(shape, multi),
                                   train_kw, device)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
        return rec
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["ok"] = True
    rec.update(record(cfg, shape, trace, memory, rec["chips"], train_kw))
    name = f"{arch}__{shape_name}__{mesh_kind}{suffix}.trace.jsonl.gz"
    out_dir.mkdir(parents=True, exist_ok=True)
    write_trace(out_dir / name, trace)
    rec["trace"] = name
    return rec


def _child_cell(args, arch, shape_name, mk, out_dir) -> dict:
    """One cell in a process of its own, cut at ``--cell-timeout``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape_name, "--mesh", mk, "--out", str(out_dir),
           "--device", args.device, "--suffix", args.suffix,
           "--microbatches", str(args.microbatches)]
    cmd += ["--no-remat"] * args.no_remat + ["--zero1"] * args.zero1
    name = f"{arch}__{shape_name}__{mk}{args.suffix}"
    try:
        subprocess.run(cmd, timeout=args.cell_timeout, capture_output=True,
                       text=True)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape_name, "mesh": mk, "ok": False,
                "device": args.device,
                "error": f"cut by its time limit ({args.cell_timeout} s)"}
    path = out_dir / f"{name}.json"
    if not path.exists():
        return {"arch": arch, "shape": shape_name, "mesh": mk, "ok": False,
                "device": args.device, "error": "the cell's process wrote "
                "no record"}
    return json.loads(path.read_text())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--zero1", action="store_true",
                    help="params TP-only; optimizer state FSDP (ZeRO-1)")
    ap.add_argument("--suffix", default="", help="artifact name suffix")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the fake tensors and the mesh name")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="run each cell in a process of its own, cut after "
                         "this many seconds")
    args = ap.parse_args(argv)
    train_kw = {}
    if args.microbatches != 1:
        train_kw["microbatches"] = args.microbatches
    if args.no_remat:
        train_kw["remat"] = False
    if args.zero1:
        train_kw["zero1"] = True

    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = 0
    for arch in archs:
        shapes = [SHAPES[args.shape]] if args.shape else supported_cells(arch)
        for shape in shapes:
            for mk in meshes:
                name = f"{arch}__{shape.name}__{mk}{args.suffix}"
                t0 = time.time()
                if args.cell_timeout:
                    rec = _child_cell(args, arch, shape.name, mk, out_dir)
                else:
                    rec = run_cell(arch, shape.name, mk,
                                   do_probe=not args.no_probe,
                                   train_kw=train_kw or None,
                                   suffix=args.suffix, device=args.device,
                                   out_dir=out_dir)
                (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
                status = "OK " if rec["ok"] else "FAIL"
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                dom = rec.get("roofline", {}).get("dominant", "-")
                mfu = rec.get("roofline", {}).get("mfu", 0.0)
                print(f"[{status}] {name:55s} {time.time()-t0:7.1f}s "
                      f"dom={dom:10s} mfu={mfu:.3f}", flush=True)
                if not rec["ok"]:
                    print("       " + rec.get("error", ""), flush=True)
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
