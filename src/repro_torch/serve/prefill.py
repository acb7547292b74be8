"""prefill_step builder: a thin wrapper over transformer.prefill_forward.

Counterpart of ``repro/serve/prefill.py``. The prefill pass is the same
stack walk as the forward pass (``transformer._run_stack``); with
``collect_ctx`` set it also emits the decode cache: ring K/V tails in
slot order, SSD final states, Whisper's cross K/V and cold-started SS±
entries for hh layers. Its attention is kernel 5.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.platform import DEFAULT_DEVICE, resolve_device
from repro_torch.serve.decode import check_on


def build_prefill_step(cfg: ModelConfig, context: int, with_cache: bool = True,
                       attention: str = "kernel", device=DEFAULT_DEVICE):
    """Returns prefill_step(params, batch) -> (logits (B, 1, V), cache|None).

    ``batch``: {'tokens': (B, S)} plus optional 'vision'/'frames' stubs.
    ``context`` is the decode context the cache is sized for (>= S).
    ``device`` and ``attention`` as in ``decode.build_serve_step``.
    """
    dev = resolve_device(device)
    L.check_attention(attention)

    def prefill_step(params, batch):
        check_on(dev, "prefill_step", batch["tokens"])
        if with_cache:
            return transformer.prefill_forward(
                params, cfg, batch["tokens"], context,
                vision=batch.get("vision"), frames=batch.get("frames"),
                attention=attention)
        logits, _ = transformer.forward(
            params, cfg, batch["tokens"], vision=batch.get("vision"),
            frames=batch.get("frames"), remat=False, attention=attention)
        return logits[:, -1:], None

    return prefill_step
