"""Trainer loop: step, log, checkpoint, resume, preemption, stragglers
(counterpart of ``repro/train/trainer.py``).

One controller on one device. Everything that must survive a restart,
the TrainState, the data cursor and the SS± token sketch with its
insertion and deletion counts, goes through ``train.checkpoint`` under
the reference's payload (``train``, ``sketch``) and extra (``pipeline``,
``step``, ``sketch_meta``) keys, so a checkpoint of either package's
trainer resumes in the other's.

Fault tolerance:
  - save every ``ckpt_every`` steps (atomic, keep-N);
  - SIGTERM/SIGINT: finish the in-flight step, save, stop;
  - ``try_resume`` restores the latest checkpoint if there is one.

The SS± trackers run on the card beside the step: ``TokenStats`` takes
each batch's tokens and, for a MoE model, ``ExpertLoadStats`` each
step's ``expert_counts`` (kernel 1, one launch a push). Per-step wall
time feeds ``StragglerMonitor``.

On a mesh (``Trainer(mesh=, rules=)``, as the reference's): init, ``run``
and ``try_resume`` run under ``use_mesh(mesh, rules)``; the state is laid
out as DTensors by its logical axes, every rank drawing the same batches
and holding them whole (the reference's unsharded batch), and a resume
restores the checkpoint onto this mesh whatever mesh wrote it. The mesh
is one rank per device of ``device``'s type; the trackers run on each
rank's device, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..data import DataConfig, TokenPipeline
from ..optim.adamw import AdamWConfig
from ..parallel import sharding as psh
from ..platform import DEFAULT_DEVICE, resolve_device
from ..sketch.state import SketchState
from ..sketch.stats import ExpertLoadStats, TokenStats
from . import checkpoint as ckpt
from .step import build_train_step, init_state
from .straggler import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    milestone_every: int = 0
    log_every: int = 10
    seed: int = 0
    # sketch integration
    token_stats_capacity: int = 1024
    token_stats_window: int = 32
    track_tokens: bool = True


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        tcfg: TrainerConfig = TrainerConfig(),
        opt_cfg: AdamWConfig = AdamWConfig(),
        mesh=None,
        rules=None,
        device=DEFAULT_DEVICE,
    ):
        self.cfg, self.data_cfg, self.tcfg = cfg, data_cfg, tcfg
        self.mesh, self.rules = mesh, rules
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                             f"{self.device.type}")
        self.pipeline = TokenPipeline(data_cfg)
        self.monitor = StragglerMonitor()
        self.token_stats = TokenStats(
            capacity=tcfg.token_stats_capacity,
            window=tcfg.token_stats_window, device=self.device,
        ) if tcfg.track_tokens else None
        self.expert_stats = (
            ExpertLoadStats(cfg.num_experts, device=self.device)
            if cfg.num_experts else None)
        self._stop = False
        self.metrics_log: list = []
        with psh.use_mesh(mesh, rules):
            self.state, self.axes = init_state(cfg, tcfg.seed,
                                               device=self.device)
        self._step = build_train_step(cfg, opt_cfg)
        self.step_num = 0

    # -- preemption ---------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._stop = True  # finish the in-flight step, then save+exit
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- checkpoint glue ------------------------------------------------------
    def _payload(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"train": self.state}
        if self.token_stats is not None:
            sd = self.token_stats.state_dict()
            payload["sketch"] = {k: sd[k] for k in ("ids", "counts",
                                                    "errors")}
        return payload

    def save(self) -> Path:
        return ckpt.save(
            self.tcfg.ckpt_dir, self.step_num, self._payload(),
            extra={
                "pipeline": self.pipeline.state(),
                "step": self.step_num,
                "sketch_meta": {
                    "insertions": self.token_stats.insertions,
                    "deletions": self.token_stats.deletions,
                } if self.token_stats is not None else {},
            },
            keep=self.tcfg.keep, milestone_every=self.tcfg.milestone_every,
        )

    def try_resume(self) -> bool:
        if ckpt.latest_step(self.tcfg.ckpt_dir) is None:
            return False
        axes = {"train": self.axes}
        if self.token_stats is not None:
            axes["sketch"] = {"ids": "", "counts": "", "errors": ""}
        with psh.use_mesh(self.mesh, self.rules):
            restored, extra = ckpt.restore(self.tcfg.ckpt_dir,
                                           self._payload(), axes=axes,
                                           device=self.device)
        self.state = restored["train"]
        if self.token_stats is not None and "sketch" in restored:
            s = restored["sketch"]
            self.token_stats.state = SketchState(s["ids"], s["counts"],
                                                 s["errors"])
            meta = extra.get("sketch_meta", {})
            self.token_stats.insertions = int(meta.get("insertions", 0))
            self.token_stats.deletions = int(meta.get("deletions", 0))
        self.pipeline.restore(extra["pipeline"])
        self.step_num = int(extra["step"])
        return True

    # -- the loop -------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict:
        steps = steps if steps is not None else self.tcfg.total_steps
        target = self.step_num + steps
        with psh.use_mesh(self.mesh, self.rules):
            self._run(target)
        if self._stop:  # preempted: final save
            self.save()
        return {
            "final_step": self.step_num,
            "final_loss": (self.metrics_log[-1]["loss"] if self.metrics_log
                           else None),
            "preempted": self._stop,
        }

    def _run(self, target: int) -> None:
        while self.step_num < target and not self._stop:
            batch_np = self.pipeline.next_batch()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch_np.items()}
            t0 = time.time()
            self.state, metrics = self._step(self.state, batch)
            # to the host: waits for the step, as the reference's
            # np.asarray of its metrics does
            metrics = {k: psh.full(v).cpu().numpy()
                       for k, v in metrics.items()}
            dt = time.time() - t0
            self.monitor.observe(0, dt)
            self.step_num += 1

            if self.token_stats is not None:
                self.token_stats.update(batch_np["tokens"])
            if self.expert_stats is not None:
                self.expert_stats.update(metrics["expert_counts"])

            if self.step_num % self.tcfg.log_every == 0 \
                    or self.step_num == target:
                self.metrics_log.append({
                    "step": self.step_num,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "step_time_s": dt,
                })
            if self.tcfg.ckpt_every and \
                    self.step_num % self.tcfg.ckpt_every == 0:
                self.save()


__all__ = ["Trainer", "TrainerConfig"]
