"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention block
applied periodically (hybrid). The attention block's weights are *shared*
across all applications (the Zamba family's signature trick)."""
from .base import ModelConfig

FULL = ModelConfig(
    name="zamba2_7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    hybrid_attn_period=6,
    hh_kv_budget=8192,  # SS± heavy-hitter KV eviction for long_500k
)

SMOKE = ModelConfig(
    name="zamba2_7b_smoke", family="hybrid",
    num_layers=7, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32,
    hybrid_attn_period=3,
    hh_kv_budget=64,
)
