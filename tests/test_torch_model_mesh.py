"""The model on a mesh: ``repro_torch``'s model stack, serving and
training on DTensors over a (2, 2) ("data", "model") mesh of one spawned
gloo group of 4 ranks (``test_torch_ranks.suite_model``), against the
port without a mesh and against the reference on a (2, 2) mesh of 4 host
devices with ``AxisType.Auto`` axes (two subprocesses beside the ranks,
the forwards and the training, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; jax 0.9's
``jax.make_mesh`` gives Explicit axes by default, which the reference's
``shard`` refuses).

Params are the reference's tree drawn in numpy (f32,
``test_torch_transformer.reference_params``), so both packages and both
layouts start from the same weights; tokens B = 4 x S = 16.

- Forward logits, expert counts and loss of smoke Qwen3-0.6B, OLMoE
  (dispatch groups = 2 on the mesh), Zamba2 (SSM and the shared block)
  and Whisper (encoder frames), at rtol = atol = TOL: the port on the
  mesh against the port without one and against the reference on its
  mesh (expert counts exact). The reference's own mesh-against-no-mesh
  gap is about 1e-5 relative in f32 (its bf16 Trainer: 1.3e-5), except
  for MoE, whose capacity binds per dispatch group: one group (no mesh)
  and two (the mesh) drop different tokens, 2e-3 apart in the
  reference's logits. So OLMoE's port twin without a mesh runs two
  dispatch groups too.
- OLMoE at a capacity factor where per-group capacity binds: expert
  counts exact and logits at TOL against the reference's mesh run, and
  not the one-group run's logits (the groups matter).
- Qwen3 on a (1, 4) mesh: its 2 kv-heads do not split 4 ways, so each
  rank's q-head reads its kv-head from the replicated k, v.
- ``layers._attend`` on GQA shapes whose q-heads split and kv-heads do
  (8 x 2) or do not (4 x 1, 6 x 3), against the call without a mesh.
- Gemma3's prefill and decode steps with the SS± cache engaged and its
  "cache" dim over "model": logits at TOL and the SS± ids, counts and
  errors exact against the run without a mesh.
- The Trainer (bf16) resumed from a reference checkpoint onto the mesh
  for 2 steps against the reference's Trainer on its mesh, and the port
  without one: losses at rtol 1e-4 (the reference keeps a bf16 model's
  scores in bf16, ``test_torch_trainer.py``), gradient norms at 2^-8
  (one bf16 ulp).
- One OLMoE ``build_train_step`` against the reference's, jitted
  without donation (the reference's Trainer fails on OLMoE donating a
  buffer twice): loss, gradient norm, expert counts, and the new params
  within 2.1 lr (a weight moves by about lr at step 1 whatever its
  gradient's size, so a tiny gradient whose sign differs moves 2 lr).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401,E402
import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig, TrainState,  # noqa: E402
                               build_train_step)

from test_torch_ranks import ROOT, run_ranks  # noqa: E402
from test_torch_transformer import _flat, reference_params  # noqa: E402

TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 2.0**-8
B, S = 4, 16
ARCHS = ("qwen3_0_6b", "olmoe_1b_7b", "zamba2_7b", "whisper_medium")
MOE_BIND_CF = 0.5
# Gemma3's prompt fills its 32 SS± slots, so every decode step evicts;
# a multiple of its window (16)
GEMMA_PROMPT, GEMMA_CONTEXT, GEMMA_STEPS, GEMMA_DECAY = 48, 64, 6, 4
HH_ENGAGE = 8
LR = 3e-4      # AdamWConfig's default

_REFERENCE = r'''
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.data import DataConfig
from repro.models import transformer as JT
from repro.optim.adamw import adamw_init
from repro.parallel.sharding import default_rules, use_mesh
from repro.train import Trainer, TrainerConfig
from repro.train.step import TrainState, build_train_step

d, part = sys.argv[1], sys.argv[2]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
assert len(jax.devices()) == 4
out = {}


def tree(prefix):
    t = {}
    for key, a in inp.items():
        if key.startswith(prefix + "/"):
            node, parts = t, key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(a)
    return t


def batch(arch):
    b = {"tokens": jnp.asarray(inp[arch + "/tokens"]),
         "labels": jnp.asarray(inp[arch + "/labels"])}
    if arch + "/frames" in inp:
        b["frames"] = jnp.asarray(inp[arch + "/frames"]).astype(jnp.bfloat16)
    return b


def forward(key, arch, **kw):
    cfg = dataclasses.replace(configs.get_smoke(arch), unroll_scan=True, **kw)
    p, b = tree(arch + "/params"), batch(arch)
    with use_mesh(mesh, default_rules()):
        logits, counts = jax.jit(lambda p, b: JT.forward(
            p, cfg, b["tokens"], frames=b.get("frames"), remat=False))(p, b)
        loss, _ = jax.jit(lambda p, b: JT.loss_fn(p, cfg, b))(p, b)
    out[key + "/logits"] = np.asarray(logits, np.float32)
    out[key + "/counts"] = np.asarray(counts)
    out[key + "/loss"] = np.asarray(loss)


if part == "forward":
    for arch in inp["archs"]:
        forward(str(arch), str(arch))
    forward("moe_bind", "olmoe_1b_7b",
            capacity_factor=float(inp["moe_bind_cf"]))
    np.savez(os.path.join(d, "reference_forward.npz"), **out)
    sys.exit(0)

cfg = configs.get_smoke("qwen3_0_6b")
tr = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=4),
             TrainerConfig(total_steps=2, ckpt_every=0, log_every=1,
                           ckpt_dir=str(inp["trainer/ckpt_dir"]),
                           track_tokens=False),
             mesh=mesh, rules=default_rules())
assert tr.try_resume()
tr.run(2)
out["trainer/losses"] = np.asarray([r["loss"] for r in tr.metrics_log])
out["trainer/grad_norms"] = np.asarray([r["grad_norm"]
                                        for r in tr.metrics_log])

cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"), unroll_scan=True)
p = tree("olmoe_1b_7b/params")
with use_mesh(mesh, default_rules()):
    new, m = jax.jit(build_train_step(cfg))(TrainState(p, adamw_init(p)),
                                             batch("olmoe_1b_7b"))
for k in ("loss", "grad_norm", "expert_counts"):
    out["olmoe_step/" + k] = np.asarray(m[k])


def flat(t, prefix):
    if isinstance(t, dict):
        for k, v in t.items():
            flat(v, prefix + "/" + k)
    else:
        out[prefix] = np.asarray(t, np.float32)


flat(new.params, "olmoe_step/params")
np.savez(os.path.join(d, "reference_train.npz"), **out)
'''


def _params(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), unroll_scan=True)
    jp, tp = reference_params(jcfg, configs.get_smoke(arch))
    return {k: np.asarray(v) for k, v in _flat(jax.device_get(jp)).items()}, tp


def _batch(cfg, seed, S=S):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def _port_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items() if k != "frames"}
    if "frames" in b:
        out["frames"] = torch.from_numpy(b["frames"]).bfloat16()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port ranks' outputs, the reference's mesh outputs, the port's
    params and batches without a mesh)."""
    d = tmp_path_factory.mktemp("model_mesh")
    inputs = {"archs": np.asarray(ARCHS), "moe_bind_cf": np.asarray(
        MOE_BIND_CF), "hh_engage": np.asarray(HH_ENGAGE),
        "gemma/context": np.asarray(GEMMA_CONTEXT),
        "gemma/steps": np.asarray(GEMMA_STEPS),
        "gemma/decay": np.asarray(GEMMA_DECAY)}
    port = {}
    for i, arch in enumerate(ARCHS + ("gemma3_27b",)):
        flat, port[arch] = _params(arch)
        inputs.update({f"{arch}/params{k}": v for k, v in flat.items()})
        b = _batch(configs.get_smoke(arch), 10 + i,
                   GEMMA_PROMPT if arch == "gemma3_27b" else S)
        port[f"{arch}/batch"] = b
        inputs.update({f"{arch}/{k}": v for k, v in b.items()})
    # the Trainers' common start: the reference's init, saved at step 0
    kw = dict(total_steps=2, ckpt_every=0, log_every=1,
              ckpt_dir=str(d / "trainer"), track_tokens=False)
    JTrainer(jconfigs.get_smoke("qwen3_0_6b"),
             JDataConfig(vocab_size=256, seq_len=32, global_batch=4),
             JTrainerConfig(**kw)).save()
    inputs["trainer/ckpt_dir"] = np.asarray(str(d / "trainer"))
    (d / "ranks").mkdir()
    (d / "ref").mkdir()      # the reference's own copy of its inputs
    np.savez(d / "ref" / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    # the reference in two processes beside the ranks: the forwards, and
    # the Trainer with the OLMoE step
    refs = [subprocess.Popen([sys.executable, "-c", _REFERENCE,
                              str(d / "ref"), part], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for part in ("forward", "train")]
    try:
        outs = run_ranks("model", 4, d / "ranks", inputs, timeout=600)
        logs = [ref.communicate(timeout=600)[0] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    for ref, log in zip(refs, logs):
        assert ref.returncode == 0, log[-4000:]
    want = {}
    for part in ("forward", "train"):
        want.update(np.load(d / "ref" / f"reference_{part}.npz"))
    return outs, want, port, kw


def _plain_forward(port, arch, groups=1, **kw):
    """The port without a mesh, with ``groups`` dispatch groups."""
    cfg = dataclasses.replace(configs.get_smoke(arch), **kw)
    b = _port_batch(port[f"{arch}/batch"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_num_dispatch_groups", lambda T: groups)
        logits, counts = T.forward(port[arch], cfg, b["tokens"],
                                   frames=b.get("frames"))
        loss, _ = T.loss_fn(port[arch], cfg, b)
    return logits.float().numpy(), counts.numpy(), float(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_the_mesh(runs, arch):
    outs, ref, port, _ = runs
    logits, counts, loss = _plain_forward(
        port, arch, groups=2 if arch == "olmoe_1b_7b" else 1)
    for out in outs:
        np.testing.assert_allclose(out[f"{arch}/logits"], logits, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out[f"{arch}/logits"],
                                   ref[f"{arch}/logits"], rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(out[f"{arch}/counts"],
                                      ref[f"{arch}/counts"])
        np.testing.assert_array_equal(out[f"{arch}/counts"], counts)
        np.testing.assert_allclose(out[f"{arch}/loss"], loss, rtol=TOL)
        np.testing.assert_allclose(out[f"{arch}/loss"], ref[f"{arch}/loss"],
                                   rtol=TOL)
        # the logits' shard call: batch over "data", vocab over "model"
        assert str(out[f"{arch}/placements"]) == \
            "(Shard(dim=0), Shard(dim=2))"


def test_dispatch_groups_follow_the_data_axis(runs):
    outs, ref, port, _ = runs
    logits, _, _ = _plain_forward(port, "olmoe_1b_7b",
                                  capacity_factor=MOE_BIND_CF)
    for out in outs:
        assert int(out["olmoe_1b_7b/groups"]) == 2
        assert int(out["qwen3_0_6b/groups"]) == 2
        np.testing.assert_array_equal(out["moe_bind/counts"],
                                      ref["moe_bind/counts"])
        np.testing.assert_allclose(out["moe_bind/logits"],
                                   ref["moe_bind/logits"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out["moe_bind/loss"],
                                   ref["moe_bind/loss"], rtol=TOL)
        # per-group capacity binds: one group over all tokens drops others
        assert not np.allclose(out["moe_bind/logits"], logits, rtol=TOL,
                               atol=TOL)


def test_replicated_kv_heads_on_a_model_axis_of_four(runs):
    outs, _, port, _ = runs
    logits, _, loss = _plain_forward(port, "qwen3_0_6b")
    for out in outs:
        assert int(out["line/groups"]) == 1      # a data axis of 1
        np.testing.assert_allclose(out["line/logits"], logits, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(out["line/loss"], loss, rtol=TOL)


@pytest.mark.parametrize("H,KV,split", [(8, 2, [True, True]),
                                        (4, 1, [True, False]),
                                        (6, 3, [True, False])])
def test_attend_on_split_heads(runs, H, KV, split):
    outs, _, _, _ = runs
    for out in outs:
        np.testing.assert_array_equal(out[f"gqa/{H}x{KV}/split"], split)
        np.testing.assert_allclose(out[f"gqa/{H}x{KV}/got"],
                                   out[f"gqa/{H}x{KV}/want"], rtol=1e-6,
                                   atol=1e-6)


def test_gemma3_decode_on_the_mesh(runs):
    """The SS± cache's slots split over "model" (the stacked counts:
    periods, batch over "data", cache over "model")."""
    outs, _, _, _ = runs
    for out in outs:
        assert str(out["gemma/cache_placements"]) == \
            "(Shard(dim=1), Shard(dim=2))"
        assert out["gemma/mesh/logits"].shape[0] == GEMMA_STEPS + 1
        np.testing.assert_allclose(out["gemma/mesh/logits"],
                                   out["gemma/plain/logits"], rtol=TOL,
                                   atol=TOL)
        for f in ("ids", "counts", "errors"):
            np.testing.assert_array_equal(out[f"gemma/mesh/{f}"],
                                          out[f"gemma/plain/{f}"])
        assert (out["gemma/mesh/ids"] >= 0).all()    # the cache is full


def test_trainer_on_the_mesh(runs):
    outs, ref, _, kw = runs
    cfg = configs.get_smoke("qwen3_0_6b")
    plain = Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=4),
                    TrainerConfig(**kw), device="cpu")
    assert plain.try_resume()
    plain.run(2)
    losses = [r["loss"] for r in plain.metrics_log]
    norms = [r["grad_norm"] for r in plain.metrics_log]
    for out in outs:
        assert bool(out["trainer/resumed"])
        assert str(out["trainer/state_placements"]) == \
            "(Shard(dim=1), Shard(dim=0))"
        for want in (ref["trainer/losses"], losses):
            np.testing.assert_allclose(out["trainer/losses"], want,
                                       rtol=LOSS_RTOL)
        for want in (ref["trainer/grad_norms"], norms):
            np.testing.assert_allclose(out["trainer/grad_norms"], want,
                                       rtol=GRAD_NORM_RTOL)


def test_olmoe_train_step_on_the_mesh(runs):
    outs, ref, port, _ = runs
    cfg = configs.get_smoke("olmoe_1b_7b")
    p = port["olmoe_1b_7b"]
    _, metrics = build_train_step(cfg)(TrainState(p, adamw_init(p)),
                                       _port_batch(port["olmoe_1b_7b/batch"]))
    for out in outs:
        np.testing.assert_allclose(out["olmoe_step/loss"],
                                   ref["olmoe_step/loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["olmoe_step/loss"],
                                   float(metrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["olmoe_step/grad_norm"],
                                   ref["olmoe_step/grad_norm"],
                                   rtol=GRAD_NORM_RTOL)
        np.testing.assert_array_equal(out["olmoe_step/expert_counts"],
                                      ref["olmoe_step/expert_counts"])
        keys = [k for k in ref if k.startswith("olmoe_step/params/")]
        assert sorted(keys) == sorted(
            k for k in out if k.startswith("olmoe_step/params/"))
        for k in keys:
            np.testing.assert_allclose(out[k], ref[k], rtol=0,
                                       atol=2.1 * LR)
