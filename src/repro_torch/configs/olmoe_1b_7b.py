"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE, full attention."""
from .base import ModelConfig

FULL = ModelConfig(
    name="olmoe_1b_7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    attn_type="full", qk_norm=True,
    num_experts=64, experts_per_token=8,
)

SMOKE = ModelConfig(
    name="olmoe_1b_7b_smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=32, vocab_size=256,
    attn_type="full", qk_norm=True,
    num_experts=8, experts_per_token=2,
)
