"""Model/config system: architecture configs, input shapes, registry.

The port's own copy of ``repro/configs/base.py`` (the port imports
nothing from ``repro``), field for field, so a config of either package
describes the same model. Every architecture has a module in this
package exposing ``FULL`` (the published config) and ``SMOKE`` (a
reduced same-family config for CPU tests).
``repro_torch.configs.get(name)`` returns the full config,
``get_smoke(name)`` the reduced one.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int = 0             # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 32000
    # attention flavor
    attn_type: str = "full"        # full | swa | local_global
    window: int = 4096             # SWA / local window
    local_global_period: int = 0   # gemma3: 6 (5 local : 1 global)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # mlp flavor
    act: str = "silu"              # silu | gelu | relu2
    mlp_gated: bool = True         # SwiGLU-style vs plain 2-matrix MLP
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid (zamba2): one *shared* attention block applied every N layers
    hybrid_attn_period: int = 0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500     # stubbed conv frontend output length
    # VLM (llava): stubbed vision tokens prepended to the text sequence
    vision_tokens: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # serving: SS±-driven heavy-hitter KV eviction budget for global layers
    # (0 = disabled). Enables long_500k on local_global archs.
    hh_kv_budget: int = 0
    # lower the layer stack as an unrolled python loop instead of lax.scan.
    # Used by the dry-run's P=1/P=2 depth probes: XLA's cost analysis
    # counts while bodies once, so scan'd programs under-report FLOPs;
    # unrolled probes make F(2)-F(1) an exact per-period cost.
    unroll_scan: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    def layer_pattern(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        """(period_pattern, num_periods, remainder_pattern).

        The model scans over ``num_periods`` repetitions of
        ``period_pattern`` and unrolls the remainder. Layer kinds:
        'full' | 'swa' | 'global' | 'local' | 'mamba' | 'mamba_attn'.
        """
        if self.family == "ssm":
            return ("mamba",), self.num_layers, ()
        if self.family == "hybrid":
            p = self.hybrid_attn_period
            pat = tuple(["mamba"] * (p - 1) + ["mamba_attn"])
            return pat, self.num_layers // p, tuple(["mamba"] * (self.num_layers % p))
        if self.attn_type == "local_global":
            p = self.local_global_period
            pat = tuple(["local"] * (p - 1) + ["global"])
            return pat, self.num_layers // p, tuple(["local"] * (self.num_layers % p))
        kind = "swa" if self.attn_type == "swa" else "full"
        return (kind,), self.num_layers, ()


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "mixtral_8x7b",
    "olmoe_1b_7b",
    "zamba2_7b",
    "whisper_medium",
    "mamba2_780m",
    "llava_next_mistral_7b",
    "gemma3_27b",
    "nemotron_4_15b",
    "qwen2_7b",
    "qwen3_0_6b",
]

# long_500k requires sub-quadratic attention; pure full-attention archs are
# skipped (as in the reference, repro/configs/base.py).
LONG_CONTEXT_ARCHS = {
    "mixtral_8x7b",          # SWA
    "zamba2_7b",             # hybrid SSM (+ SS±-evicted shared attention)
    "mamba2_780m",           # SSM, constant state
    "llava_next_mistral_7b", # SWA backbone
    "gemma3_27b",            # 5:1 local + SS±-evicted global layers
}


def supported_cells(arch: str):
    """The (arch, shape) cells exercised by the dry-run."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue
        out.append(s)
    return out


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.FULL


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.SMOKE
