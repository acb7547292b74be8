"""Whisper-medium [arXiv:2212.04356]: encoder-decoder; the conv/log-mel
frontend is a stub — input_specs() provides precomputed frame embeddings."""
from .base import ModelConfig

FULL = ModelConfig(
    name="whisper_medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    attn_type="full", act="gelu", mlp_gated=False,
    encoder_layers=24, encoder_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper_medium_smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256,
    attn_type="full", act="gelu", mlp_gated=False,
    encoder_layers=2, encoder_frames=32,
)
