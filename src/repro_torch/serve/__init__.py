"""Serving runtime of the port: KV caches, prefill/decode step builders,
the engine, and the multi-tenant sketch service.

  kv_cache -- cache tree builders + shape/dtype specs
  h2o      -- the SS±-driven heavy-hitter KV cache (the paper's algorithm
              as an eviction policy for global-attention layers)
  decode   -- serve_step builder: one token for the whole stack (kernel 6)
  prefill  -- prefill_step builder: full-sequence forward + cache fill
              (kernel 5)
  engine   -- batched serving loop (greedy sampling)
  sketch_service -- coalesced per-tenant ingest on one tenant bank,
              batched point queries, top-k and quantile subscriptions,
              cold-row spill
"""
from .kv_cache import build_cache, cache_len_for, cache_spec
from .decode import build_serve_step
from .prefill import build_prefill_step
from .engine import ServeEngine
from .sketch_service import QueryTicket, SketchService

__all__ = [
    "build_cache",
    "cache_spec",
    "cache_len_for",
    "build_serve_step",
    "build_prefill_step",
    "ServeEngine",
    "QueryTicket",
    "SketchService",
]
