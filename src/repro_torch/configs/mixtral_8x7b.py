"""Mixtral 8x7B [arXiv:2401.04088]: 8-expert top-2 MoE, GQA, SWA(4096)."""
from .base import ModelConfig

FULL = ModelConfig(
    name="mixtral_8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    attn_type="swa", window=4096, rope_theta=1e6,
    num_experts=8, experts_per_token=2,
)

SMOKE = ModelConfig(
    name="mixtral_8x7b_smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    attn_type="swa", window=16,
    num_experts=4, experts_per_token=2,
)
