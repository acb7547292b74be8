"""The port's Trainer (``repro_torch/train/trainer.py``) on the
reference's three trainer cases (``tests/test_fault_tolerance.py``:
exact resume, preemption save, the token sketch surviving a resume) at
the reference's shape (smoke Qwen3-0.6B, ``seq_len=32``,
``global_batch=4``), on the CPU, plus a port Trainer resumed from a
checkpoint the reference's Trainer wrote.

The cross-package run: both trainers start from the reference's init
(bf16), the port's by resuming the reference's checkpoint of step 4 (the
same file format; the param tree is the same), and both take steps 5-8
on the same batches. The losses are held at rtol 1e-4: the reference
keeps a bf16 model's attention scores and probabilities in bf16 where
the port's plain attention keeps them in f32 (``models/layers.py``), a
difference of bf16 rounding, not of the algorithm. The token sketch the
port resumed answers its top-k as the reference's checkpointed sketch.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import configs
from repro_torch.data import DataConfig
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt

CROSS_RTOL = 1e-4


def _mk_trainer(tmpdir, steps=10, ckpt_every=100):
    cfg = configs.get_smoke("qwen3_0_6b")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(tmpdir),
        log_every=1, token_stats_capacity=64, token_stats_window=4,
    )
    return Trainer(cfg, dc, tc, device="cpu")


def test_exact_resume_equivalence(tmp_path):
    tr = _mk_trainer(tmp_path / "a", steps=8)
    tr.run()
    loss_straight = tr.metrics_log[-1]["loss"]

    tr1 = _mk_trainer(tmp_path / "b", steps=4)
    tr1.run()
    tr1.save()
    tr2 = _mk_trainer(tmp_path / "b", steps=8)
    assert tr2.try_resume()
    assert tr2.step_num == 4
    assert tr2.pipeline.cursor == 4
    tr2.run(4)
    np.testing.assert_allclose(tr2.metrics_log[-1]["loss"], loss_straight,
                               rtol=1e-5)


def test_preemption_saves_on_stop(tmp_path):
    tr = _mk_trainer(tmp_path, steps=100, ckpt_every=1000)
    orig_observe = tr.monitor.observe
    count = {"n": 0}

    def observe(host, t):
        count["n"] += 1
        if count["n"] == 3:
            tr._stop = True  # what the signal handler does
        return orig_observe(host, t)

    tr.monitor.observe = observe
    out = tr.run()
    assert out["preempted"] and out["final_step"] == 3
    assert ckpt.latest_step(tmp_path) == out["final_step"]


def test_sketch_state_survives_resume(tmp_path):
    tr = _mk_trainer(tmp_path, steps=6, ckpt_every=3)
    tr.run()
    before = tr.token_stats.topk(8)
    tr2 = _mk_trainer(tmp_path, steps=6)
    assert tr2.try_resume()
    after = tr2.token_stats.topk(8)
    np.testing.assert_array_equal(before.items, after.items)
    np.testing.assert_array_equal(before.counts, after.counts)
    assert tr2.token_stats.insertions == tr.token_stats.insertions
    assert tr2.token_stats.deletions == tr.token_stats.deletions


def test_port_resumes_a_reference_checkpoint(tmp_path):
    kw = dict(total_steps=8, ckpt_every=100, ckpt_dir=str(tmp_path),
              log_every=1, token_stats_capacity=64, token_stats_window=4)
    ref = JTrainer(jconfigs.get_smoke("qwen3_0_6b"),
                   JDataConfig(vocab_size=256, seq_len=32, global_batch=4),
                   JTrainerConfig(**kw))
    ref.run(4)
    ref.save()
    sketch_at_4 = ref.token_stats.topk(8)
    ref.run(4)
    port = Trainer(configs.get_smoke("qwen3_0_6b"),
                   DataConfig(vocab_size=256, seq_len=32, global_batch=4),
                   TrainerConfig(**kw), device="cpu")
    assert port.try_resume()
    assert (port.step_num, port.pipeline.cursor) == (4, 4)
    got = port.token_stats.topk(8)
    np.testing.assert_array_equal(got.items, np.asarray(sketch_at_4.items))
    np.testing.assert_array_equal(got.counts, np.asarray(sketch_at_4.counts))
    port.run(4)
    want = [r["loss"] for r in ref.metrics_log[4:]]
    got = [r["loss"] for r in port.metrics_log]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)
