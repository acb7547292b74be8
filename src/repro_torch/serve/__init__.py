"""Serving runtime of the port: the multi-tenant sketch service.

  sketch_service -- coalesced per-tenant ingest on one tenant bank,
                    batched point queries, top-k and quantile
                    subscriptions, cold-row spill

The model-serving modules of ``repro.serve`` (KV caches, prefill,
decode, the engine) are ROADMAP.md Queue 1 item 17.
"""
from .sketch_service import QueryTicket, SketchService

__all__ = ["QueryTicket", "SketchService"]
