"""Batched serving engine: prefill, then greedy decode.

Counterpart of ``repro/serve/engine.py``. The reference jits its two
step functions; here they run eagerly (capturing a CUDA graph of the
decode step is later work). Greedy picks the first maximum, as
``jnp.argmax`` does. On a mesh (called under ``use_mesh`` with params
laid out by ``sharding.distribute``) the steps run on DTensors and each
step's logits are gathered whole for the pick; ``keep_logits`` keeps
them gathered.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import sharding as psh
from repro_torch.platform import DEFAULT_DEVICE
from repro_torch.serve.decode import build_serve_step
from repro_torch.serve.prefill import build_prefill_step


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    params: dict
    context: int
    decay_period: int = 8192
    attention: str = "kernel"
    device: str = DEFAULT_DEVICE

    def __post_init__(self):
        self._prefill = build_prefill_step(self.cfg, self.context,
                                           attention=self.attention,
                                           device=self.device)
        self._step = build_serve_step(self.cfg, self.context,
                                      self.decay_period,
                                      attention=self.attention,
                                      device=self.device)

    def generate(
        self,
        tokens: torch.Tensor,              # (B, S) prompt
        max_new_tokens: int,
        vision: Optional[torch.Tensor] = None,
        frames: Optional[torch.Tensor] = None,
        stop_token: Optional[int] = None,
        keep_logits: bool = False,
    ) -> Dict[str, object]:
        """Greedy decode. Returns {'tokens': (B, S+T) numpy, 'steps': int};
        with ``keep_logits`` also 'logits', the prefill's last-token logits
        and each step's, (B, V) tensors on the device, and 'cache', the
        cache after the last step."""
        batch = {"tokens": tokens}
        if vision is not None:
            batch["vision"] = vision
        if frames is not None:
            batch["frames"] = frames
        logits, cache = self._prefill(self.params, batch)
        logits = psh.full(logits)
        kept = [logits[:, -1]]
        out = [tokens.cpu().numpy()]
        cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        done = torch.zeros((tokens.shape[0],), dtype=torch.bool,
                           device=tokens.device)
        steps = 0
        for _ in range(max_new_tokens):
            out.append(cur.cpu().numpy())
            logits, cache, _aux = self._step(self.params, cache, cur)
            logits = psh.full(logits)
            kept.append(logits[:, -1])
            cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            steps += 1
            if stop_token is not None:
                done = done | (cur[:, 0] == stop_token)
                if bool(done.all()):
                    break
        result = {"tokens": np.concatenate(out, axis=1), "steps": steps}
        if keep_logits:
            result.update(logits=kept, cache=cache)
        return result
