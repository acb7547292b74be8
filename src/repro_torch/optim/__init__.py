"""Optimizer of the port (counterpart of ``repro.optim``), in plain
PyTorch with the reference's math and order of operations:

  adamw      -- AdamW with f32 master state over bf16 params, decoupled
                weight decay, global-norm clipping
  schedules  -- warmup + cosine / linear decay
  compress   -- top-k gradient compression with error feedback (the DP
                exchange that uses it: ``train/dp_exchange.py``)
"""
from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm, global_norm)
from .compress import (TopK, error_feedback_update, topk_compress,
                       topk_decompress)
from .schedules import constant_schedule, cosine_schedule, linear_schedule

__all__ = [
    "AdamWState",
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "clip_by_global_norm",
    "cosine_schedule",
    "linear_schedule",
    "constant_schedule",
    "TopK",
    "topk_compress",
    "topk_decompress",
    "error_feedback_update",
]
