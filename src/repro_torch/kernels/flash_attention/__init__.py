"""Flash attention (GQA, causal and sliding window): CUDA kernel, plain
version, ops, and ``FlashAttentionFn``: the kernel under autograd."""
from .ops import FlashAttentionFn, flash_attention

__all__ = ["FlashAttentionFn", "flash_attention"]
