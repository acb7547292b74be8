"""Qwen3-0.6B [hf:Qwen/Qwen3 family]: qk-norm, GQA, head_dim 128."""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3_0_6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936,
    attn_type="full", qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3_0_6b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    attn_type="full", qk_norm=True, tie_embeddings=True,
)
