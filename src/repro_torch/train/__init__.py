"""The port's training runtime (counterpart of ``repro.train``): the
train step (loss, gradients through kernel 5, AdamW), the trainer loop
with its SS± token and expert trackers, checkpoints in the reference's
format, and the straggler monitor. One device: the DP gradient exchange
(``dp_exchange.py``, ``shard_map`` over a mesh) and the mesh-aware
restore come with the mesh, ROADMAP item 19."""
from .step import (TrainState, abstract_state, build_train_step, init_state,
                   state_axes)
from .straggler import StragglerConfig, StragglerMonitor
from .trainer import Trainer, TrainerConfig

__all__ = [
    "TrainState",
    "build_train_step",
    "abstract_state",
    "state_axes",
    "init_state",
    "Trainer",
    "TrainerConfig",
    "StragglerMonitor",
    "StragglerConfig",
]
