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
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401,E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.parallel import sharding as psh  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

from test_torch_ranks import run_ranks  # noqa: E402


def _state(seed):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((8, 8)), jnp.bfloat16)
    return {"params": {"w": w,
                       "b": jnp.asarray(rng.standard_normal(8), jnp.float32)},
            "step": jnp.asarray(seed, jnp.int32)}


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt8")
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    port_state, jax_state = _state(3), _state(5)
    jckpt.save(d / "jax", 5, jax_state, extra={"step": 5})
    inputs = {"dir": np.asarray(str(d)), "w": x,
              "state/w": np.asarray(port_state["params"]["w"], np.float32),
              "state/b": np.asarray(port_state["params"]["b"]),
              "state/step": np.asarray(3)}
    outs = run_ranks("checkpoint", 8, d / "ranks", inputs)
    return d, x, port_state, jax_state, outs


def test_elastic_reshard_across_meshes(eight_ranks):
    """The reference's case: saved on (4, 2), restored on (2, 4)."""
    _, x, _, _, outs = eight_ranks
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["grid/saved_local"], [2, 4])
        np.testing.assert_array_equal(out["grid/mesh"], [2, 4])
        assert str(out["grid/placements"]) == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(out["grid/full"], x)
        i, j = divmod(r, 4)
        np.testing.assert_array_equal(out["grid/local"],
                                      x[4 * i:4 * i + 4, 2 * j:2 * j + 2])


def test_port_mesh_checkpoint_restores_in_the_jax_package(eight_ranks):
    d, _, port_state, _, _ = eight_ranks
    got, extra = jckpt.restore(d / "port", jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), port_state))
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(port_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_jax_checkpoint_restores_onto_the_port_mesh(eight_ranks):
    _, _, _, jax_state, outs = eight_ranks
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
