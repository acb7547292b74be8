"""The port's checkpoints (``repro_torch/train/checkpoint.py``) against
the reference's (``repro/train/checkpoint.py``): the reference's own
cases (round trip, keep-N and milestones, no ``tmp`` left, no
checkpoint, a missing key, a shape mismatch) on the port, and the
on-disk format shared both ways: a checkpoint written by either
package's ``save`` restores in the other's ``restore``, bf16 leaves and
NamedTuple train states included, with the same manifest (keys, dtypes,
extra)."""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.train import checkpoint as jckpt
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import step as TS


def _state():
    return {
        "w": torch.arange(12, dtype=torch.bfloat16).reshape(3, 4),
        "nested": {"m": torch.ones((2, 2)),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _values(tree):
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else
                       np.asarray(x, np.float32), np.float32)
            for x in jax.tree.leaves(tree)]


def _like(tree):
    return {k: _like(v) if isinstance(v, dict) else torch.empty_like(
        v, device="meta") for k, v in tree.items()}


def _manifest(path):
    return json.loads((path / "manifest.json").read_text())


def test_roundtrip(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 5, s, extra={"cursor": 42})
    restored, extra = ckpt.restore(tmp_path, _like(s), device="cpu")
    assert extra["cursor"] == 42
    for k, a in (("w", s["w"]), ("m", s["nested"]["m"])):
        b = restored[k] if k == "w" else restored["nested"][k]
        assert b.dtype == a.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    assert restored["nested"]["step"].dtype == torch.int32
    assert int(restored["nested"]["step"]) == 7


def test_keep_n_and_milestones(tmp_path):
    s = _state()
    for step in range(1, 11):
        ckpt.save(tmp_path, step, s, keep=2, milestone_every=5)
    steps = [int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")]
    assert 9 in steps and 10 in steps
    assert 5 in steps
    assert 1 not in steps and 2 not in steps


def test_atomic_no_tmp_left(tmp_path):
    ckpt.save(tmp_path, 1, _state())
    assert not list(tmp_path.glob("tmp.*"))
    assert ckpt.latest_step(tmp_path) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, _state(), device="cpu")


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, {"w": torch.ones((3, 3))}, device="cpu")


def test_missing_key_raises(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.restore(tmp_path, {"w": torch.ones((2, 2)),
                                "u": torch.ones(1)}, device="cpu")


def _pair():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    j = {"w": jnp.asarray(w).astype(jnp.bfloat16),
         "nested": {"m": jnp.asarray(w[0]), "step": jnp.asarray(7, jnp.int32),
                    "ids": jnp.arange(4, dtype=jnp.int32)}}
    t = {"w": torch.from_numpy(w).bfloat16(),
         "nested": {"m": torch.from_numpy(w[0].copy()),
                    "step": torch.tensor(7, dtype=torch.int32),
                    "ids": torch.arange(4, dtype=torch.int32)}}
    return j, t


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    j, t = _pair()
    jckpt.save(tmp_path, 3, j, extra={"pipeline": {"cursor": 3, "seed": 0}})
    restored, extra = ckpt.restore(tmp_path, _like(t), device="cpu")
    assert extra == {"pipeline": {"cursor": 3, "seed": 0}}
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       t["w"].view(torch.int16))
    for k in ("m", "step", "ids"):
        assert torch.equal(restored["nested"][k], t["nested"][k]), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    j, t = _pair()
    ckpt.save(tmp_path / "port", 3, t, extra={"step": 3})
    jckpt.save(tmp_path / "ref", 3, j, extra={"step": 3})
    got, want = (_manifest(tmp_path / d / "step_0000000003")
                 for d in ("port", "ref"))
    assert got == want
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), j)
    restored, extra = jckpt.restore(tmp_path / "port", like)
    assert extra == {"step": 3}
    assert restored["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(restored["w"]).view(np.int16),
        t["w"].view(torch.int16).numpy())
    for a, b in zip(_values(restored), _values(j)):
        np.testing.assert_array_equal(a, b)


def test_train_state_keys_match_the_reference(tmp_path):
    """A smoke TrainState saved by each package: the same keys, shapes
    and dtypes in the manifest, and each restores the other's."""
    jcfg, tcfg = jconfigs.get_smoke("qwen3_0_6b"), tconfigs.get_smoke(
        "qwen3_0_6b")
    jstate, _ = JS.init_state(jcfg, jax.random.PRNGKey(0))
    tstate, _ = TS.init_state(tcfg, 0, device="cpu")
    jckpt.save(tmp_path / "ref", 1, {"train": jstate})
    ckpt.save(tmp_path / "port", 1, {"train": tstate})
    got, want = (_manifest(tmp_path / d / "step_0000000001")
                 for d in ("port", "ref"))
    assert got["keys"] == want["keys"]
    assert got["dtypes"] == want["dtypes"]
    assert "train/opt/master/periods/pos0/attn/wq" in got["keys"]
    # the reference's state restores in the port, bit for bit
    restored, _ = ckpt.restore(tmp_path / "ref", {"train": tstate},
                               device="cpu")
    assert isinstance(restored["train"], TS.TrainState)
    wq = restored["train"].params["periods"]["pos0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy(),
        np.asarray(jstate.params["periods"]["pos0"]["attn"]["wq"]).view(
            np.int16))
    # and the port's in the reference
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"train": jstate})
    back, _ = jckpt.restore(tmp_path / "port", like)
    np.testing.assert_array_equal(
        np.asarray(back["train"].opt.master["embed"]),
        tstate.opt.master["embed"].numpy())
