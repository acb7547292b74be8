"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]:
anyres vision tiling is a stub — input_specs() provides precomputed patch
embeddings prepended to the text sequence. Backbone = Mistral-7B (SWA)."""
from .base import ModelConfig

FULL = ModelConfig(
    name="llava_next_mistral_7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    attn_type="swa", window=4096, rope_theta=1e6,
    vision_tokens=2880,  # anyres: base 576 + 4 tiles x 576
)

SMOKE = ModelConfig(
    name="llava_next_mistral_7b_smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    attn_type="swa", window=16,
    vision_tokens=8,
)
