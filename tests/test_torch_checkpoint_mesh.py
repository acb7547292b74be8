"""Checkpoints across meshes: ``repro_torch.train.checkpoint`` on DTensor
state, on one spawned gloo group of 8 ranks (``test_torch_ranks.
suite_checkpoint``), against the reference's format and its own test.

- The reference's grid (``tests/test_checkpoint.py:154``,
  ``test_elastic_reshard_across_meshes``): an (8, 8) f32 leaf on
  "embed,ff" saved from a (4, 2) ("data", "model") mesh and restored
  onto a (2, 4) mesh, bit for bit, each rank holding its (4, 2) slice.
- A port checkpoint saved on the (4, 2) mesh (bf16, f32 and a 0-d int32
  leaf) restores in the JAX package, bit for bit; a JAX-package
  checkpoint restores onto the port's (2, 4) mesh, bit for bit, laid
  out by the axes.
- Without a group: ``restore(axes=)`` with no mesh active changes
  nothing, as the reference's (its docstring: "replicates when absent or
  when no mesh is active").

The same 8 ranks then run smoke Qwen3 (4 q-heads, 2 kv-heads) on a (2, 4)
("data", "model") mesh (``test_torch_ranks.suite_mesh24``), a mesh whose
model axis does not divide the kv-heads and whose data axis is above 1:
DTensor's own einsum of the k and v projections flattened (kv, hd),
split it over "model" and could not unflatten it into 2 kv-heads on 4
ranks ("Cannot unflatten unevenly sharded tensor");
``layers.project`` now lays the projection out by the reference's
``shard`` names, the kv-heads replicated where "model" does not divide
them. Held against the reference on a (2, 4) mesh of 8 host devices
with ``AxisType.Auto`` axes (one JAX subprocess, run beside the ranks)
and against the port without a mesh: forward logits and loss at rtol =
atol = TOL, one train step's loss at LOSS_RTOL, gradient norm at
GRAD_NORM_RTOL and new params within 2.1 lr (``test_torch_model_mesh.
py``'s limits and their reasons).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401,E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.parallel import sharding as psh  # noqa: E402
from repro_torch.train import TrainState, build_train_step  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

from test_torch_model_mesh import GRAD_NORM_RTOL, LOSS_RTOL, LR, TOL  # noqa: E402
from test_torch_ranks import ROOT, run_ranks  # noqa: E402
from test_torch_transformer import _flat, reference_params  # noqa: E402

B, S = 4, 16    # the (2, 4) model cases' batch

_REFERENCE = r'''
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.models import transformer as JT
from repro.optim.adamw import adamw_init
from repro.parallel.sharding import default_rules, use_mesh
from repro.train.step import TrainState, build_train_step

d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
p = {}
for key, a in inp.items():
    if key.startswith("params/"):
        node, parts = p, key[len("params/"):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(a)
b = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
cfg = dataclasses.replace(configs.get_smoke("qwen3_0_6b"), unroll_scan=True)
out = {}
with use_mesh(mesh, default_rules()):
    logits, _ = jax.jit(lambda p, b: JT.forward(p, cfg, b["tokens"],
                                                 remat=False))(p, b)
    loss, _ = jax.jit(lambda p, b: JT.loss_fn(p, cfg, b))(p, b)
    new, m = jax.jit(build_train_step(cfg))(TrainState(p, adamw_init(p)), b)
out["logits"] = np.asarray(logits, np.float32)
out["loss"] = np.asarray(loss)
out["step/loss"] = np.asarray(m["loss"])
out["step/grad_norm"] = np.asarray(m["grad_norm"])


def flat(t, prefix):
    if isinstance(t, dict):
        for k, v in t.items():
            flat(v, prefix + "/" + k)
    else:
        out[prefix] = np.asarray(t, np.float32)


flat(new.params, "step/params")
np.savez(os.path.join(d, "reference.npz"), **out)
'''


def _state(seed):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((8, 8)), jnp.bfloat16)
    return {"params": {"w": w,
                       "b": jnp.asarray(rng.standard_normal(8), jnp.float32)},
            "step": jnp.asarray(seed, jnp.int32)}


def _mesh24_inputs():
    """(inputs of the (2, 4) model cases: the reference's params tree
    drawn in numpy and a batch, the port's params, the port's batch)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("qwen3_0_6b"),
                               unroll_scan=True)
    jp, tp = reference_params(jcfg, configs.get_smoke("qwen3_0_6b"))
    rng = np.random.default_rng(40)
    batch = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    inputs = {f"params{k}": np.asarray(v)
              for k, v in _flat(jax.device_get(jp)).items()}
    inputs.update(batch)
    return inputs, tp, batch


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """The 8 ranks' outputs (``suite_eight``: the checkpoint grid, then
    the (2, 4) model cases), with the reference's (2, 4) run computed in a
    subprocess beside them."""
    d = tmp_path_factory.mktemp("ckpt8")
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    port_state, jax_state = _state(3), _state(5)
    jckpt.save(d / "jax", 5, jax_state, extra={"step": 5})
    model_inputs, tp, batch = _mesh24_inputs()
    inputs = {"dir": np.asarray(str(d)), "w": x,
              "state/w": np.asarray(port_state["params"]["w"], np.float32),
              "state/b": np.asarray(port_state["params"]["b"]),
              "state/step": np.asarray(3), **model_inputs}
    (d / "ref").mkdir()      # the reference's own copy of its inputs
    np.savez(d / "ref" / "inputs.npz", **model_inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                            str(d / "ref")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        outs = run_ranks("eight", 8, d / "ranks", inputs, timeout=600)
        log = ref.communicate(timeout=600)[0]
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, log[-4000:]
    model = dict(reference=dict(np.load(d / "ref" / "reference.npz")),
                 plain=_plain_mesh24(tp, batch))
    return d, x, port_state, jax_state, outs, model


def _plain_mesh24(tp, batch):
    """Smoke Qwen3 without a mesh on the (2, 4) cases' params and batch."""
    cfg = configs.get_smoke("qwen3_0_6b")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = T.forward(tp, cfg, tb["tokens"])
    loss, _ = T.loss_fn(tp, cfg, tb)
    _, metrics = build_train_step(cfg)(TrainState(tp, adamw_init(tp)), tb)
    return dict(logits=logits.float().numpy(), loss=float(loss),
                step_loss=float(metrics["loss"]),
                grad_norm=float(metrics["grad_norm"]))


def test_elastic_reshard_across_meshes(eight_ranks):
    """The reference's case: saved on (4, 2), restored on (2, 4)."""
    _, x, _, _, outs, _ = eight_ranks
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["grid/saved_local"], [2, 4])
        np.testing.assert_array_equal(out["grid/mesh"], [2, 4])
        assert str(out["grid/placements"]) == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(out["grid/full"], x)
        i, j = divmod(r, 4)
        np.testing.assert_array_equal(out["grid/local"],
                                      x[4 * i:4 * i + 4, 2 * j:2 * j + 2])


def test_port_mesh_checkpoint_restores_in_the_jax_package(eight_ranks):
    d, _, port_state, _, _, _ = eight_ranks
    got, extra = jckpt.restore(d / "port", jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), port_state))
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(port_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_jax_checkpoint_restores_onto_the_port_mesh(eight_ranks):
    _, _, _, jax_state, outs, _ = eight_ranks
    want = {"params/w": np.asarray(jax_state["params"]["w"], np.float32),
            "params/b": np.asarray(jax_state["params"]["b"]),
            "step": np.asarray(jax_state["step"])}
    for out in outs:
        assert int(out["jax/extra_step"]) == 5
        assert bool(out["jax/dtensor"])
        assert str(out["jax/w_placements"]) == \
            "(Shard(dim=0), Shard(dim=1))"
        for k, v in want.items():
            np.testing.assert_array_equal(out[f"jax/state/{k}"], v)


def test_restore_axes_without_a_mesh_is_plain(tmp_path):
    """No mesh active: ``axes`` lays out nothing (plain tensors, the
    values as saved)."""
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ckpt.save(tmp_path, 1, {"w": x})
    got, _ = ckpt.restore(tmp_path, {"w": x}, axes={"w": "embed,ff"},
                          device="cpu")
    assert not psh.is_dtensor(got["w"])
    assert torch.equal(got["w"], x)


# -- the model on a (2, 4) mesh ---------------------------------------------

def test_forward_on_a_2x4_mesh(eight_ranks):
    outs, model = eight_ranks[4], eight_ranks[5]
    ref, plain = model["reference"], model["plain"]
    for out in outs:
        for want in (ref["logits"], plain["logits"]):
            np.testing.assert_allclose(out["logits"], want, rtol=TOL,
                                       atol=TOL)
        for want in (ref["loss"], plain["loss"]):
            np.testing.assert_allclose(out["loss"], want, rtol=TOL)


def test_kv_projection_is_replicated_over_model(eight_ranks):
    """2 kv-heads on a model axis of 4: the rules replicate them, batch
    rows split over "data"."""
    for out in eight_ranks[4]:
        assert str(out["k_placements"]) == "(Shard(dim=0), Replicate())"


def test_train_step_on_a_2x4_mesh(eight_ranks):
    outs, model = eight_ranks[4], eight_ranks[5]
    ref, plain = model["reference"], model["plain"]
    for out in outs:
        for want in (ref["step/loss"], plain["step_loss"]):
            np.testing.assert_allclose(out["step/loss"], want,
                                       rtol=LOSS_RTOL)
        for want in (ref["step/grad_norm"], plain["grad_norm"]):
            np.testing.assert_allclose(out["step/grad_norm"], want,
                                       rtol=GRAD_NORM_RTOL)
        keys = [k for k in ref if k.startswith("step/params/")]
        assert sorted(keys) == sorted(k for k in out
                                      if k.startswith("step/params/"))
        for k in keys:
            np.testing.assert_allclose(out[k], ref[k], rtol=0,
                                       atol=2.1 * LR)
