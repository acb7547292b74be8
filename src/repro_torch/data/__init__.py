"""Data pipeline of the port (counterpart of ``repro.data``): the
deterministic host-sharded synthetic token stream with its
checkpointable cursor, the SS± token statistics it feeds, and the
CAIDA-like surrogate stream. numpy, so a batch is bit for bit the
reference's for the same (seed, cursor, host)."""
from .caida_like import caida_like_tokens
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline", "caida_like_tokens"]
