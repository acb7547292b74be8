"""Device resolution, donation policy, the hardware preset and the kernel
build directory.

Counterpart of ``repro/platform.py``: there, ``resolve_interpret``
decides whether a Pallas kernel runs compiled; here the tensor's device
decides. Every entry point takes ``device="cuda"`` by default and
raises when no card is present, so a run without a GPU never drifts
onto the CPU unnoticed. The CPU runs the plain PyTorch versions of the
kernels only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import pathlib
from typing import Optional

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


def has_accelerator() -> bool:
    """Whether a CUDA card is attached."""
    return torch.cuda.is_available()


def donate_state_buffers() -> bool:
    """Whether the compiled ingest may update a session's state buffers in
    place (``session._ingest_fn``): on the card, where the bank is large
    and a copy costs device bandwidth; never on the CPU, where the eager
    update returns fresh tensors (the reference's policy,
    ``repro/platform.py:105``)."""
    return has_accelerator()


def hw_config(name: Optional[str] = None):
    """The roofline ``HWConfig`` for ``name``, or for the card in use:
    ``gpu_h100`` for a card whose name holds "H100", ``cpu`` without a
    card. Any other card raises: its rates are not in a preset, and a
    roofline against another card's would be wrong."""
    from .roofline.model import hw_for

    if name is not None:
        return hw_for(name)
    if not has_accelerator():
        return hw_for("cpu")
    card = torch.cuda.get_device_name(torch.cuda.current_device())
    if "H100" in card:
        return hw_for("gpu_h100")
    raise RuntimeError(
        f"no roofline preset for the card {card!r}; add one to "
        f"repro_torch/roofline/model.py or pass hw_config(name)")


def build_dir() -> pathlib.Path:
    """Where the CUDA sources are compiled (listed in .gitignore)."""
    return _ROOT / "build" / "repro_torch"


__all__ = ["DEFAULT_DEVICE", "resolve_device", "has_accelerator",
           "donate_state_buffers", "hw_config", "build_dir"]
