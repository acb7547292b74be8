"""Gemma3-27B [hf:google/gemma-3 family]: 5:1 local:global attention,
128k context, qk-norm, head_dim 128 (independent of d_model/num_heads —
see DESIGN.md §Arch-applicability). SS± heavy-hitter KV eviction caps the
global-layer cache for long_500k."""
from .base import ModelConfig

FULL = ModelConfig(
    name="gemma3_27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    attn_type="local_global", window=1024, local_global_period=6,
    qk_norm=True, act="gelu", rope_theta=1e6, tie_embeddings=True,
    hh_kv_budget=8192,
)

SMOKE = ModelConfig(
    name="gemma3_27b_smoke", family="dense",
    num_layers=7, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    attn_type="local_global", window=16, local_global_period=3,
    qk_norm=True, act="gelu", tie_embeddings=True,
    hh_kv_budget=32,
)
