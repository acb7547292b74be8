"""Model facade: an (init / forward / loss) bundle from a ModelConfig.

Counterpart of ``repro/models/model.py``. ``batch_spec`` gives
``(shape, dtype)`` pairs where the reference gives ShapeDtypeStructs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.platform import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (gen, dtype=, device=) -> (params, axes)
    forward: Callable       # (params, tokens, vision=, frames=) -> (logits, aux)
    loss: Callable          # (params, batch) -> (loss, aux)

    def batch_spec(self, batch_size: int, seq_len: int):
        """The input batch of this model and shape, as (shape, dtype)
        pairs. The modality frontends are stubs, as in the reference:
        llava gets precomputed patch embeddings, whisper precomputed
        frame embeddings."""
        cfg = self.cfg
        text = seq_len - cfg.vision_tokens
        spec = {
            "tokens": ((batch_size, text), torch.int32),
            "labels": ((batch_size, text), torch.int32),
        }
        if cfg.vision_tokens:
            spec["vision"] = ((batch_size, cfg.vision_tokens, cfg.d_model),
                              torch.bfloat16)
        if cfg.family == "encdec":
            spec["frames"] = ((batch_size, cfg.encoder_frames, cfg.d_model),
                              torch.bfloat16)
        return spec


def build_model(cfg: ModelConfig) -> Model:
    def init(gen, dtype=torch.bfloat16, device=DEFAULT_DEVICE):
        return transformer.init_params(gen, cfg, dtype, device)

    def forward(params, tokens, vision=None, frames=None, remat=False,
                attention="kernel"):
        return transformer.forward(params, cfg, tokens, vision=vision,
                                   frames=frames, remat=remat,
                                   attention=attention)

    def loss(params, batch, remat=True, attention="kernel"):
        return transformer.loss_fn(params, cfg, batch, remat=remat,
                                   attention=attention)

    return Model(cfg=cfg, init=init, forward=forward, loss=loss)
