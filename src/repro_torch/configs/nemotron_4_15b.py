"""Nemotron-4-15B [arXiv:2402.16819]: GQA, squared-ReLU plain MLP."""
from .base import ModelConfig

FULL = ModelConfig(
    name="nemotron_4_15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    attn_type="full", act="relu2", mlp_gated=False,
)

SMOKE = ModelConfig(
    name="nemotron_4_15b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256,
    attn_type="full", act="relu2", mlp_gated=False,
)
