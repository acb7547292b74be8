"""Qwen2-7B [arXiv:2407.10671]: GQA (kv=4), QKV bias."""
from .base import ModelConfig

FULL = ModelConfig(
    name="qwen2_7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    attn_type="full", qkv_bias=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2_7b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    attn_type="full", qkv_bias=True,
)
