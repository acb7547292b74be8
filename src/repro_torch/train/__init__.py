"""The port's training package (counterpart of ``repro.train``): so far
the straggler monitor; the trainer, its steps and checkpoints are
ROADMAP.md Queue 1 item 18."""
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor"]
