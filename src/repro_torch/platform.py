"""Device resolution and the kernel build directory.

Counterpart of ``repro/platform.py``: there, ``resolve_interpret``
decides whether a Pallas kernel runs compiled; here the tensor's device
decides. Every entry point takes ``device="cuda"`` by default and
raises when no card is present, so a run without a GPU never drifts
onto the CPU unnoticed. The CPU runs the plain PyTorch versions of the
kernels only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import pathlib

import torch

DEFAULT_DEVICE = "cuda"

# the checkout root: src/repro_torch/platform.py -> parents[2]
_ROOT = pathlib.Path(__file__).resolve().parents[2]


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA device by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    return dev


def build_dir() -> pathlib.Path:
    """Where the CUDA sources are compiled (listed in .gitignore)."""
    return _ROOT / "build" / "repro_torch"


__all__ = ["DEFAULT_DEVICE", "resolve_device", "build_dir"]
