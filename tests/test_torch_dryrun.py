"""The port's dry-run (``repro_torch.launch.dryrun``), its counting mode
(``roofline.trace.StepTrace``), its collectives (``roofline.collectives``)
and its report (``roofline.report``), on the CPU.

One module fixture starts four processes at once and every test reads
what they wrote (a fake process group must never start in the test
process):

- the CLI on the reference test's cell (``tests/test_dryrun.py``):
  ``qwen3_0_6b`` ``train_4k`` on the single-pod mesh of 256 fake ranks,
  ``--device cpu``, held to that test's contract, with ``cost_corrected``
  equal to ``cost_raw`` (every layer is traced; nothing to correct);
- the CLI on ``qwen3_0_6b`` ``decode_32k``: its trace reaches kernel 6's
  op once a layer;
- a port script (``_PORT``) on fake groups: smoke Qwen3's train cell on a
  (2, 2) mesh (its per-device argument and alias bytes), smoke Qwen3's
  forward and train step on a (2, 4) mesh (where DTensor raised before
  ``layers.project``), a redistribute of known size, a
  ``local_map`` call and a sharded matmul, each counted per device;
- the reference's ``lower_cell`` on the smoke train cell on a (2, 2)
  mesh of 4 host devices with ``AxisType.Auto`` axes: its
  ``memory_analysis``, which the port's (2, 2) cell equals exactly.
"""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import report as jreport  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_flops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    allowed_count, allowed_pairs, flash_attention_ref, flash_flops)
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.collectives import (COLLECTIVES,  # noqa: E402
                                              collective_bytes, kind_of)
from repro_torch.roofline.model import HW  # noqa: E402
from repro_torch.roofline.trace import StepTrace  # noqa: E402

from test_torch_ranks import ROOT  # noqa: E402

SMOKE_B, SMOKE_S = 32, 64     # the (2, 2) and (2, 4) cells' batch
QWEN3_LAYERS = 28

_PORT = r'''
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch import configs
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as psh
from repro_torch.roofline.trace import StepTrace

out = {}
B, S = int(sys.argv[2]), int(sys.argv[3])
cfg = configs.get_smoke("qwen3_0_6b")
shape = InputShape("smoke", S, B, "train")
dryrun.fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
trace, mem = dryrun.trace_cell(cfg, shape, mesh, psh.default_rules(), {},
                               "cpu", keep=False)
out["smoke22"] = dict(memory=mem, kernel_ops=dryrun.kernel_op_calls(trace),
                      collectives=trace.collectives())

with FakeTensorMode() as fake, psh.use_mesh(mesh):
    # all-gather over "data" of an (8, 16) f32 Shard(0), then an
    # all-reduce over "model" of a Partial
    x = psh.lay_out(torch.zeros(8, 16), psh.PartitionSpec("data", None))
    part = DTensor.from_local(torch.zeros(8, 16), mesh,
                              (Replicate(), Partial()), run_check=False)
    t = StepTrace(fake_mode=fake)
    with t:
        x.redistribute(mesh, (Replicate(), Replicate()))
        part.redistribute(mesh, (Replicate(), Replicate()))
    out["redistribute"] = t.collectives()
    # a local_map matmul (each rank: (4, 16) @ (16, 32)) and a sharded
    # matmul (each rank: (4, 16) @ (16, 16), no communication)
    w = psh.lay_out(torch.zeros(16, 32), psh.PartitionSpec(None, None))
    ws = psh.lay_out(torch.zeros(16, 32), psh.PartitionSpec(None, "model"))
    t = StepTrace(fake_mode=fake)
    with t:
        psh.local_map(lambda a, b: a @ b, (x, w),
                      (psh.PartitionSpec("data", None),
                       psh.PartitionSpec(None, None)),
                      psh.PartitionSpec("data", None))
    out["local_map"] = dict(flops=t.flops, coll=t.collectives()["total"])
    t = StepTrace(fake_mode=fake)
    with t:
        y = x @ ws
    out["sharded_mm"] = dict(flops=t.flops, coll=t.collectives()["total"],
                             placements=str(tuple(y.placements)),
                             local=list(y.to_local().shape))

# smoke Qwen3 on (2, 4): the forward and a train step
dryrun.fake_group(8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
trace, mem = dryrun.trace_cell(cfg, shape, mesh, psh.default_rules(), {},
                               "cpu", keep=False)
out["smoke24"] = dict(flops=trace.flops,
                      kernel_ops=dryrun.kernel_op_calls(trace))
with FakeTensorMode(), psh.use_mesh(mesh):
    params, axes = T.init_params(0, cfg, device="cpu")
    p = psh.distribute(params, axes)
    logits, _ = T.forward(p, cfg, torch.zeros(B, S, dtype=torch.int32))
    out["smoke24"]["logits"] = [list(logits.shape),
                                str(tuple(logits.placements))]
json.dump(out, open(sys.argv[1], "w"))
'''

_REFERENCE = r'''
import json, sys
import jax
# the backend starts here, on 4 host devices: repro.launch.dryrun sets
# XLA_FLAGS for 512 when it is imported, which a started backend ignores
assert len(jax.devices()) == 4
from repro import configs
from repro.configs.base import InputShape
from repro.launch.dryrun import _memory_analysis_dict, lower_cell
from repro.parallel.sharding import default_rules
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
cfg = configs.get_smoke("qwen3_0_6b")
shape = InputShape("smoke", int(sys.argv[3]), int(sys.argv[2]), "train")
_, compiled = lower_cell(cfg, shape, mesh, default_rules())
json.dump(_memory_analysis_dict(compiled), open(sys.argv[1], "w"))
'''


def _cli(out_dir, shape):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            "qwen3_0_6b", "--shape", shape, "--mesh", "single", "--device",
            "cpu", "--out", str(out_dir)]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    size = [str(SMOKE_B), str(SMOKE_S)]
    cmds = {
        "train": (_cli(d / "train", "train_4k"), env),
        "decode": (_cli(d / "decode", "decode_32k"), env),
        "port": ([sys.executable, "-c", _PORT, str(d / "port.json"), *size],
                 env),
        "reference": ([sys.executable, "-c", _REFERENCE,
                       str(d / "reference.json"), *size], jenv),
    }
    procs = {k: subprocess.Popen(c, env=e, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (c, e) in cmds.items()}
    logs = {}
    try:
        for k, p in procs.items():
            logs[k] = p.communicate(timeout=600)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][-4000:])

    def rec(sub, shape):
        return json.loads((d / sub / f"qwen3_0_6b__{shape}__single.json")
                          .read_text())

    return dict(dir=d, train=rec("train", "train_4k"),
                decode=rec("decode", "decode_32k"),
                port=json.loads((d / "port.json").read_text()),
                reference=json.loads((d / "reference.json").read_text()))


def test_single_cell_contract(cells):
    """The reference test's contract (tests/test_dryrun.py:30-43), with
    ``cost_corrected`` equal to ``cost_raw`` in place of exceeding it."""
    rec = cells["train"]
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == 256 and rec["device"] == "cpu"
    t = rec["roofline"]
    for k in ("compute_s", "memory_s", "collective_s"):
        assert t[k] > 0, (k, t)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["useful_ratio"] < 2.0
    assert rec["collectives"]["total"] > 0
    assert rec["correction_source"] == "traced every layer"
    assert rec["cost_corrected"]["flops"] == rec["cost_raw"]["flops"]
    assert rec["cost_corrected"]["bytes"] == rec["cost_raw"]["bytes"]
    assert rec["cost_corrected"]["collective"] == \
        rec["collectives"]["total"]
    assert rec["memory"].get("temp_size_in_bytes", 0) > 0
    # per device: the roofline took the counts times the chips
    assert t["hlo_flops"] == rec["cost_raw"]["flops"] * 256


def test_single_cell_per_device_state(cells):
    """Qwen3-0.6B's train state on 256 ranks, per device: the arguments
    are the state and the rank's tokens and labels, the donated alias the
    state alone."""
    mem = cells["train"]["memory"]
    tokens = 2 * (256 // 16) * 4096 * 4      # tokens and labels, int32
    assert mem["argument_size_in_bytes"] == \
        mem["alias_size_in_bytes"] + tokens


@pytest.mark.parametrize("cell,kind,calls", [
    ("train", "flash", 2 * QWEN3_LAYERS),    # a forward and remat's recompute
    ("decode", "decode", QWEN3_LAYERS),
    ("decode", "flash", 0),
    ("train", "decode", 0),
])
def test_kernel_ops_in_the_trace(cells, cell, kind, calls):
    assert cells[cell]["kernel_ops"][kind] == calls


def test_the_trace_is_written(cells):
    rec = cells["decode"]
    rows = [json.loads(line) for line in gzip.open(
        cells["dir"] / "decode" / rec["trace"], "rt")]
    ops = {r["op"] for r in rows}
    assert "repro_torch.decode_attention.default" in ops
    assert any("dtensor" in r for r in rows)
    assert sum(r.get("flops", 0) for r in rows) == \
        cells["decode"]["cost_raw"]["flops"]


def test_smoke_cell_memory_is_the_references(cells):
    """Per device on a (2, 2) mesh, exactly the reference's
    ``lower_cell`` on a (2, 2) ``Auto`` mesh of 4 host devices: the
    arguments (the state and the rank's 8,192 bytes of tokens and
    labels) and the donated state."""
    got, want = cells["port"]["smoke22"]["memory"], cells["reference"]
    for k in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["argument_size_in_bytes"] - got["alias_size_in_bytes"] == \
        2 * (SMOKE_B // 2) * SMOKE_S * 4


def test_smoke_qwen3_on_a_2x4_mesh(cells):
    """Smoke Qwen3 (2 kv-heads) on (2, 4): the train step and the forward
    trace where DTensor raised "Cannot unflatten unevenly sharded
    tensor" before; the logits split over "data" and vocab over
    "model"."""
    c = cells["port"]["smoke24"]
    assert c["flops"] > 0 and c["kernel_ops"]["flash"] == 2 * 2
    assert c["logits"] == [[SMOKE_B, SMOKE_S, 256],
                           "(Shard(dim=0), Shard(dim=2))"]


def test_redistribute_bytes_per_device(cells):
    """An (8, 16) f32 Shard(0) over a data axis of 2 gathered: 512 bytes
    of all-gather result a device; a Partial over "model" reduced: 512
    bytes of all-reduce."""
    got = cells["port"]["redistribute"]
    assert got == {"all-gather": 512, "all-reduce": 512, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0, "total": 1024}


def test_local_map_and_sharded_matmul_per_device(cells):
    p = cells["port"]
    assert p["local_map"] == dict(flops=2 * 4 * 16 * 32, coll=0)
    assert p["sharded_mm"] == dict(flops=2 * 4 * 16 * 16, coll=0,
                                   placements="(Shard(dim=0), Shard(dim=1))",
                                   local=[4, 16])


def test_no_group_in_the_test_process():
    import torch.distributed as dist

    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The collectives' kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,kind", [
    ("_c10d_functional::all_gather_into_tensor.default", "all-gather"),
    ("_c10d_functional::all_reduce", "all-reduce"),
    ("_c10d_functional::reduce_scatter_tensor.default", "reduce-scatter"),
    ("_c10d_functional::all_to_all_single.default", "all-to-all"),
    ("_dtensor::shard_dim_alltoall.default", "all-to-all"),
    ("c10d::allreduce_.default", "all-reduce"),
    ("aten::mm.default", None),
    ("_c10d_functional::wait_tensor.default", None),
])
def test_kind_of(op, kind):
    assert kind_of(op) == kind


def test_collective_bytes_sums_per_kind():
    got = collective_bytes([("all-gather", 10), ("all-reduce", 5),
                            ("all-gather", 1)])
    assert set(got) == set(COLLECTIVES) | {"total"}
    assert (got["all-gather"], got["all-reduce"], got["total"]) == (11, 5,
                                                                    16)


# ---------------------------------------------------------------------------
# Kernels 5 and 6 as ops: fake rules and FLOP formulas
# ---------------------------------------------------------------------------

MASKS = [(64, 64, True, 0), (64, 64, True, 16), (32, 96, True, 0),
         (48, 48, False, 0), (16, 40, True, 8), (8, 4, True, 0)]


@pytest.mark.parametrize("S,T,causal,window", MASKS)
def test_allowed_count_is_the_mask(S, T, causal, window):
    assert allowed_count(S, T, causal, window) == int(
        allowed_pairs(S, T, causal, window).sum())


@pytest.mark.parametrize("S,T,causal,window", MASKS)
def test_flash_op_counted_once(S, T, causal, window):
    """One call counts its formula, under ``FlopCounterMode`` and under
    ``StepTrace``: the plain version's products inside the op are not
    counted again. Its fake rule gives q's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, H, KV, hd = 2, 4, 2, 16
    gen = torch.Generator().manual_seed(S + T)
    q = torch.randn(B, S, H, hd, generator=gen)
    k, v = (torch.randn(B, T, KV, hd, generator=gen) for _ in range(2))
    want = flash_flops(B, S, T, H, hd, causal, window)
    assert want == 4 * B * H * hd * int(allowed_pairs(S, T, causal,
                                                      window).sum())
    with FlopCounterMode(display=False) as fc:
        out = fops.op(q, k, v, causal, window)
    assert fc.get_total_flops() == want
    with StepTrace() as t:
        fops.op(q, k, v, causal, window)
    assert t.flops == want
    assert t.calls["repro_torch.flash_attention"] == 1
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=causal,
                                                window=window))
    with FakeTensorMode():
        fq = torch.empty(B, S, H, hd, dtype=torch.bfloat16, device="cuda")
        fk = torch.empty(B, T, KV, hd, dtype=torch.bfloat16, device="cuda")
        got = fops.op(fq, fk, fk, causal, window)
        assert (got.shape, got.dtype, got.device.type) == (
            fq.shape, torch.bfloat16, "cuda")


@pytest.mark.parametrize("share", [1.0, 0.5, 0.0])
def test_decode_op_formula_and_fake_rule(share):
    """4·hd FLOPs per valid slot per q-head on real data, every slot on
    fake data; the fake rule's ctx in the caches' dtype and the f32
    mass."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    B, KV, G, hd, C = 2, 2, 3, 16, 40
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(B, KV, G, hd, generator=gen)
    kc, vc = (torch.randn(B, C, KV, hd, generator=gen) for _ in range(2))
    valid = torch.rand(B, C, generator=gen) < share
    with FlopCounterMode(display=False) as fc:
        dops.op(q, kc, vc, valid)
    assert fc.get_total_flops() == decode_flops(int(valid.sum()), KV, G, hd)
    with FakeTensorMode() as fake:
        fq = torch.empty(B, KV, G, hd, dtype=torch.float32, device="cuda")
        fc_ = torch.empty(B, C, KV, hd, dtype=torch.bfloat16, device="cuda")
        fv = torch.empty(B, C, dtype=torch.bool, device="cuda")
        with StepTrace(fake_mode=fake) as t:
            ctx, mass = dops.op(fq, fc_, fc_, fv)
    assert (ctx.shape, ctx.dtype) == ((B, KV, G, hd), torch.bfloat16)
    assert (mass.shape, mass.dtype) == ((B, C), torch.float32)
    assert t.flops == decode_flops(B * C, KV, G, hd)


def test_decode_op_refuses_a_gradient():
    q = torch.randn(1, 1, 1, 8, requires_grad=True)
    c = torch.randn(1, 4, 1, 8)
    with pytest.raises(RuntimeError, match="no gradient"):
        dops.decode_attention(q, c, c, torch.ones(1, 4, dtype=torch.bool))


def test_flash_attention_fn_gradients_unchanged():
    """``FlashAttentionFn`` (the op) on CPU tensors: its input gradients
    equal autograd's of the plain version, bit for bit."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 16, 4, 8, generator=gen, requires_grad=True)
    k, v = (torch.randn(2, 16, 2, 8, generator=gen, requires_grad=True)
            for _ in range(2))
    dout = torch.randn(2, 16, 4, 8, generator=gen)
    got = torch.autograd.grad(fops.FlashAttentionFn.apply(q, k, v, True, 4),
                              (q, k, v), dout)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=True,
                                                   window=4), (q, k, v), dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def test_report_tables_are_the_references(cells):
    """The same records through the reference's and the port's
    ``markdown_table`` and ``interesting_cells``: identical text."""
    recs = [cells["train"], cells["decode"]]
    assert report.markdown_table(recs) == jreport.markdown_table(recs)
    got, want = report.interesting_cells(recs), jreport.interesting_cells(
        recs)
    assert {k: (r["arch"], r["shape"]) for k, r in got.items()} == \
        {k: (r["arch"], r["shape"]) for k, r in want.items()}


def test_memory_table_against_the_80gb_preset(cells):
    recs = [cells["train"], cells["decode"]]
    text = report.memory_table(recs)
    assert HW.hbm_bytes == 80e9 and "fits 80G HBM?" in text
    for r, line in zip(recs, text.splitlines()[2:]):
        m = r["memory"]
        live = (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
                + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])
        assert ("| yes |" in line) == (live < 80e9), (line, live)


def test_load_records_reads_the_cli_output(cells):
    got = report.load_records(cells["dir"] / "train", "single")
    assert [r["shape"] for r in got] == ["train_4k"]
    assert np.isclose(got[0]["roofline"]["mfu"],
                      cells["train"]["roofline"]["mfu"])
