"""CAIDA-2015-like surrogate stream (counterpart of
``repro/data/caida_like.py``, the same numpy draws).

The paper's real-world dataset (Anonymized Internet Traces 2015,
'equinixchicago') is not redistributable. This generates a
statistically matched surrogate: destination-IP-like identifiers from a
heavy-tailed mixture whose rank-frequency curve follows the published
Zipf fits for CAIDA 2015 (s ~ 1.0-1.2 head with an exponential tail cut),
plus a uniform background: many medium-weight flows, which makes CAIDA
harder than pure Zipf for counter-based sketches.
"""
from __future__ import annotations

import numpy as np


def caida_like_tokens(
    n: int,
    universe: int = 1 << 16,
    seed: int = 0,
    head_s: float = 1.05,
    background_frac: float = 0.2,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_bg = int(n * background_frac)
    n_head = n - n_bg
    ranks = np.arange(1, universe + 1, dtype=np.float64)
    w = ranks ** (-head_s) * np.exp(-ranks / (universe / 4))
    cdf = np.cumsum(w) / w.sum()
    head = np.searchsorted(cdf, rng.random(n_head)).astype(np.int64)
    bg = rng.integers(0, universe, size=n_bg)
    out = np.concatenate([head, bg])
    rng.shuffle(out)
    # a fixed random permutation, so that "rank" != "id" (like IPs)
    perm = np.random.default_rng(12345).permutation(universe)
    return perm[np.clip(out, 0, universe - 1)].astype(np.int64)


__all__ = ["caida_like_tokens"]
