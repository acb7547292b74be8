"""Learning-rate schedules: pure functions of the int step (counterpart
of ``repro/optim/schedules.py``). ``step`` is a 0-d integer tensor (or a
Python int); the result is a 0-d f32 tensor on the step's device,
computed in f32 in the reference's order."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(F32)


def constant_schedule(lr: float):
    def f(step):
        return torch.full((), lr, dtype=F32,
                          device=torch.as_tensor(step).device)
    return f


def linear_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    """Linear warmup to ``peak`` over ``warmup`` steps, linear decay to
    ``floor`` at ``total``."""
    def f(step):
        s = _f32(step)
        wu = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        dec = peak + (floor - peak) * frac
        return torch.where(s < warmup, wu, dec).to(F32)
    return f


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup then cosine decay to ``floor_frac * peak``."""
    floor = peak * floor_frac

    def f(step):
        s = _f32(step)
        wu = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        dec = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, wu, dec).to(F32)
    return f


__all__ = ["constant_schedule", "linear_schedule", "cosine_schedule"]
