"""Mamba2-780m [arXiv:2405.21060]: attention-free SSD (state-space duality)."""
from .base import ModelConfig

FULL = ModelConfig(
    name="mamba2_780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2_780m_smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32,
)
