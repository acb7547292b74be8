"""Decode attention with per-slot attention mass: CUDA kernel, plain
version, ops."""
from .ops import decode_attention

__all__ = ["decode_attention"]
