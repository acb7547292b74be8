"""Deterministic, host-sharded synthetic token pipeline (counterpart of
``repro/data/pipeline.py``: the same numpy draws, so batch ``i`` of host
``h`` is bit for bit the reference's).

- **Stateless addressing**: batch ``i`` for host ``h`` is a pure function
  of (seed, i, h): any host can reproduce any batch, so restarts and
  resharding (another host count) never lose or repeat data. The only
  pipeline state is the integer cursor.
- **Zipfian token model** with document structure: tokens drawn from a
  Zipf(s) marginal over the vocab (the paper's synthetic setup, §5.2),
  BOS-delimited documents of geometric length; labels are the next
  token.
- **Bounded-deletion accounting**: ``token_stats`` feeds a windowed
  ``TokenStats``; a batch that leaves the window of the last ``window``
  batches is deleted from the token sketch, so D <= (1 - 1/alpha) I.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..platform import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_s: float = 1.2
    mean_doc_len: int = 512
    bos_token: int = 0
    seed: int = 0


class TokenPipeline:
    """Per-host view of the global batch stream."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_hosts {num_hosts}")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.cursor = 0
        # Zipf inverse-CDF table over the vocab (token 0 reserved for BOS)
        ranks = np.arange(1, cfg.vocab_size, dtype=np.float64)
        w = ranks ** (-cfg.zipf_s)
        self._cdf = np.cumsum(w) / w.sum()

    # -- stateless batch addressing ----------------------------------------
    def _rng_for(self, cursor: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, cursor, self.host_id]))

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng_for(cursor)
        n = self.local_batch * (cfg.seq_len + 1)
        u = rng.random(n)
        toks = np.searchsorted(self._cdf, u).astype(np.int32) + 1  # 1..V-1
        # document boundaries: geometric(1/mean_doc_len) -> BOS
        bos = rng.random(n) < (1.0 / cfg.mean_doc_len)
        toks[bos] = cfg.bos_token
        toks = toks.reshape(self.local_batch, cfg.seq_len + 1)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.cursor)
        self.cursor += 1
        return b

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- sketch integration -------------------------------------------------
    def token_stats(
        self,
        steps: int,
        *,
        capacity: int = 4096,
        window: int = 64,
        shards: Optional[int] = None,
        block: int = 8192,
        device=DEFAULT_DEVICE,
    ):
        """Feed ``steps`` host-local batches into a windowed TokenStats on
        ``device``: each batch is ingested as one block, and batches
        older than ``window`` are deleted. With ``shards=S`` the tracker
        runs on the hash-partitioned bank at the same total counter
        budget; the vocab bound gives the router its universe."""
        from ..sketch.stats import TokenStats

        ts = TokenStats(
            capacity=capacity, window=window, shards=shards, block=block,
            universe_bits=max(int(self.cfg.vocab_size - 1).bit_length(), 1),
            device=device)
        for _ in range(steps):
            ts.update(self.next_batch()["tokens"])
        return ts

    # -- checkpointable state ----------------------------------------------
    def state(self) -> Dict:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    def restore(self, state: Dict) -> None:
        if state["seed"] != self.cfg.seed:
            raise ValueError(f"seed mismatch on restore: the state's "
                             f"{state['seed']}, the pipeline's "
                             f"{self.cfg.seed}")
        self.cursor = int(state["cursor"])


__all__ = ["DataConfig", "TokenPipeline"]
