"""The port's training runtime (counterpart of ``repro.train``): the
train step (loss, gradients through kernel 5, AdamW), the trainer loop
with its SS± token and expert trackers, checkpoints in the reference's
format, the straggler monitor, and the compressed data-parallel gradient
exchange over a mesh axis (``dp_exchange``). The step, the trainer and
the restore run on one device or on a mesh (``Trainer(mesh=, rules=)``,
``checkpoint.restore(axes=)``)."""
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
