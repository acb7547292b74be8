"""Flash attention (GQA, causal and sliding window): CUDA kernel, plain
version, ops."""
from .ops import flash_attention

__all__ = ["flash_attention"]
