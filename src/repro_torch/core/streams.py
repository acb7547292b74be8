"""Bounded-deletion streams and their exact accounting, vectorised.

The port's own counterpart of ``repro/core/streams.py`` and of the
benchmarks' multi-tenant traffic generator (``mixed_traffic``,
``benchmarks/common.py:56``). The paper's generators (section 5.2:
Zipf, Binomial, Uniform and CAIDA-like insertions, random and targeted
deletions, the ``inserts_first`` and ``interleaved`` orders, and
``bounded_stream`` over them) give the reference's arrays bit for bit
from the same arguments: the same numpy draws in the same order, with
the reference's Python loops over events replaced by array work (they
take minutes at millions of events). ``zipf_interleaved_stream`` and
``mixed_traffic`` are the port's own streams, with draws of their own.

A stream is an (N, 2) int64 array of (item_id, sign) rows, sign in
{+1, -1}. Every deletion follows an insertion of the same item, so
frequencies never go negative (the strict turnstile), and
``D <= delete_ratio * I`` (the bounded-deletion model with
``alpha = 1 / (1 - delete_ratio)``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

Update = Tuple[int, int]  # (item_id, +1 | -1): one row of a stream


def _zipf_ranks(n: int, universe: int, skew: float, seed: int) -> np.ndarray:
    """n ids, id r - 1 drawn with p ~ r^-skew: a uniform scaled by the
    unnormalised cdf. The draw of ``zipf_interleaved_stream`` and
    ``mixed_traffic``, kept as it was: it can differ from
    ``zipf_insertions`` in the last bits of the cdf."""
    rng = np.random.default_rng(seed)
    cdf = np.cumsum(np.arange(1, universe + 1, dtype=np.float64) ** (-skew))
    u = rng.random(n) * cdf[-1]
    return np.minimum(np.searchsorted(cdf, u, side="right"),
                      universe - 1).astype(np.int64)


def zipf_interleaved_stream(n_insert: int, delete_ratio: float,
                            universe: int = 1 << 16, skew: float = 1.0,
                            seed: int = 0) -> np.ndarray:
    """Zipf insertions with ``floor(delete_ratio * n_insert)`` deletions
    interleaved: each deletion removes a distinct earlier insertion,
    chosen uniformly, at a uniform time after it. The port's own stream
    (not the reference's draws: ``bounded_stream`` gives those)."""
    rng = np.random.default_rng(seed + 1)
    ins = _zipf_ranks(n_insert, universe, skew, seed)
    n_del = int(delete_ratio * n_insert)
    victim = rng.choice(n_insert, size=n_del, replace=False)
    t_del = rng.uniform(victim + 0.5, n_insert + 0.5)
    times = np.concatenate([np.arange(n_insert, dtype=np.float64), t_del])
    order = np.argsort(times, kind="stable")
    items = np.concatenate([ins, ins[victim]])[order]
    signs = np.concatenate([np.ones(n_insert, np.int64),
                            -np.ones(n_del, np.int64)])[order]
    return np.stack([items, signs], axis=1)


# ---------------------------------------------------------------------------
# The paper's generators (section 5.2), the reference's draws
# ---------------------------------------------------------------------------

def zipf_insertions(n: int, universe: int, skew: float = 1.0,
                    seed: int = 0) -> np.ndarray:
    """n insertions, the item of rank r (id r - 1) drawn with p ~ r^-skew
    over ``universe`` ranks (the truncated Zipf law). The draw of
    ``Generator.choice(universe, size=n, p=pmf)``: the normalised pmf's
    cumsum over its last entry, one ``random(n)``, ``searchsorted``."""
    rng = np.random.default_rng(seed)
    pmf = np.arange(1, universe + 1, dtype=np.float64) ** (-skew)
    pmf /= pmf.sum()
    cdf = pmf.cumsum()
    cdf /= cdf[-1]
    return cdf.searchsorted(rng.random(n), side="right").astype(np.int64)


def binomial_insertions(n: int, universe: int, p: float = 0.5,
                        seed: int = 0) -> np.ndarray:
    """n insertions drawn Binomial(universe - 1, p): mild skew around the
    mode."""
    rng = np.random.default_rng(seed)
    return rng.binomial(universe - 1, p, size=n).astype(np.int64)


def uniform_insertions(n: int, universe: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, universe, size=n, dtype=np.int64)


def caida_like_insertions(n: int, universe: int = 1 << 16,
                          seed: int = 0) -> np.ndarray:
    """Surrogate for the CAIDA 2015 destination-IP trace (not
    redistributable): a shuffled 90/10 mixture of Zipf(1.2) and uniform
    ids over the same universe."""
    rng = np.random.default_rng(seed)
    n_zipf = int(n * 0.9)
    body = zipf_insertions(n_zipf, universe, skew=1.2, seed=seed)
    tail = rng.integers(0, universe, size=n - n_zipf, dtype=np.int64)
    out = np.concatenate([body, tail])
    rng.shuffle(out)
    return out


def deletions_random(insertions: np.ndarray, num_deletions: int,
                     seed: int = 0) -> np.ndarray:
    """Deletions chosen uniformly from the insertions (the paper's
    'shuffled')."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(insertions), size=num_deletions, replace=False)
    return insertions[idx]


def deletions_targeted(insertions: np.ndarray,
                       num_deletions: int) -> np.ndarray:
    """Delete the least frequent items first (the paper's 'targeted'):
    items by ascending frequency, ties by first occurrence, each item's
    occurrences until ``num_deletions`` are taken."""
    ins = np.asarray(insertions)
    uniq, first, counts = np.unique(ins, return_index=True,
                                    return_counts=True)
    order = np.lexsort((first, counts))
    out = np.repeat(uniq[order], counts[order])
    return out[:max(num_deletions, 0)].astype(np.int64)


def make_stream(insertions: np.ndarray, deletions: np.ndarray,
                pattern: str = "inserts_first", seed: int = 0) -> np.ndarray:
    """An (N, 2) array of (item, sign) updates.

    pattern:
      - 'inserts_first': all insertions, then all deletions (the paper's
        adversarial, locality-minimising default);
      - 'interleaved': each deletion matched to the first unmatched
        occurrence of its item, in insertion order, and placed at a
        uniform time after it, so every deletion is strict.
    """
    ins = np.stack([insertions, np.ones_like(insertions)], axis=1)
    dls = np.stack([deletions, -np.ones_like(deletions)], axis=1)
    if pattern == "inserts_first":
        return np.concatenate([ins, dls], axis=0)
    if pattern != "interleaved":
        raise ValueError(f"unknown pattern {pattern!r}")
    items = np.asarray(insertions)
    n = len(items)
    uniq, inv, cnt = np.unique(items, return_inverse=True, return_counts=True)
    d_uniq, d_cnt = np.unique(np.asarray(deletions), return_counts=True)
    at = np.minimum(np.searchsorted(uniq, d_uniq), max(len(uniq) - 1, 0))
    have = np.zeros(len(d_uniq), np.int64)
    if len(uniq):
        hit = uniq[at] == d_uniq
        have[hit] = cnt[at[hit]]
    if (d_cnt > have).any():
        raise ValueError("deletions not a sub-multiset of insertions")
    wanted = np.zeros(len(uniq), np.int64)
    wanted[at] = d_cnt
    # each insertion's occurrence rank within its item, in position order;
    # an item's first wanted[item] occurrences are matched
    by_item = np.argsort(inv, kind="stable")
    occ = np.empty(n, np.int64)
    occ[by_item] = np.arange(n) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    matched = np.flatnonzero(occ < wanted[inv.reshape(-1)])
    # one uniform a matched position, in position order: the reference's
    # draws, one by one
    rng = np.random.default_rng(seed)
    t_del = rng.uniform(matched + 0.5, n + 0.5)
    times = np.concatenate([np.arange(n, dtype=np.float64), t_del])
    order = np.argsort(times, kind="stable")   # insertions first on ties
    out_items = np.concatenate([items, items[matched]])[order]
    signs = np.concatenate([np.ones(n, np.int64),
                            -np.ones(len(matched), np.int64)])[order]
    return np.stack([out_items, signs], axis=1).astype(np.int64)


def bounded_stream(distribution: str, n_insert: int, delete_ratio: float,
                   universe: int = 1 << 16, skew: float = 1.0,
                   delete_pattern: str = "random",
                   order: str = "inserts_first",
                   seed: int = 0) -> np.ndarray:
    """The paper's streams: ``n_insert`` insertions of ``distribution``
    ('zipf', 'binomial', 'uniform' or 'caida') drawn from ``seed``, then
    ``floor(delete_ratio * n_insert)`` deletions ('random', from ``seed +
    1``, or 'targeted'), put in ``order`` ('inserts_first' or
    'interleaved', from ``seed + 2``). Bit for bit the reference's
    ``repro.core.streams.bounded_stream``."""
    if distribution == "zipf":
        ins = zipf_insertions(n_insert, universe, skew=skew, seed=seed)
    elif distribution == "binomial":
        ins = binomial_insertions(n_insert, universe, seed=seed)
    elif distribution == "uniform":
        ins = uniform_insertions(n_insert, universe, seed=seed)
    elif distribution == "caida":
        ins = caida_like_insertions(n_insert, universe, seed=seed)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    n_del = int(delete_ratio * n_insert)  # floor: D <= (1 - 1/alpha) I
    if delete_pattern == "random":
        dels = deletions_random(ins, n_del, seed=seed + 1)
    elif delete_pattern == "targeted":
        dels = deletions_targeted(ins, n_del)
    else:
        raise ValueError(f"unknown delete_pattern {delete_pattern!r}")
    return make_stream(ins, dels, pattern=order, seed=seed + 2)


@dataclasses.dataclass(frozen=True)
class StreamStats:
    """Exact accounting: ``items`` ascending with their net ``freqs``
    (items whose net frequency is 0 are left out)."""

    insertions: int
    deletions: int
    items: np.ndarray
    freqs: np.ndarray

    @property
    def residual_mass(self) -> int:
        """|F|_1 = I - D."""
        return self.insertions - self.deletions

    @property
    def alpha(self) -> float:
        """Smallest alpha with D <= (1 - 1/alpha) I."""
        if self.deletions == 0:
            return 1.0
        if self.deletions >= self.insertions:
            return float("inf")
        return self.insertions / (self.insertions - self.deletions)


def exact_stats(stream: np.ndarray) -> StreamStats:
    """Net frequencies of an (N, 2) stream; raises if any prefix drives an
    item's frequency below 0 (not strict turnstile)."""
    items = np.asarray(stream[:, 0], np.int64)
    signs = np.asarray(stream[:, 1], np.int64)
    order = np.argsort(items, kind="stable")      # per item, in time order
    s_items, s_signs = items[order], signs[order]
    run = np.cumsum(s_signs)
    head = np.ones(len(s_items), bool)
    head[1:] = s_items[1:] != s_items[:-1]
    start = np.flatnonzero(head)
    before = np.concatenate([[0], run])[start]    # running sum before item
    prefix = run - np.repeat(before, np.diff(np.append(start, len(run))))
    if len(prefix) and prefix.min() < 0:
        bad = int(s_items[np.argmin(prefix)])
        raise ValueError(
            f"stream is not strict-turnstile: item {bad} deleted below 0")
    uniq = s_items[start]
    net = np.add.reduceat(s_signs, start) if len(start) else s_signs[:0]
    keep = net != 0
    return StreamStats(int((signs > 0).sum()), int((signs < 0).sum()),
                       uniq[keep], net[keep])


def heavy_hitters(stats: StreamStats, phi: float) -> np.ndarray:
    """Ground-truth phi-frequent items: f(x) >= phi * |F|_1 and f(x) > 0."""
    thr = phi * stats.residual_mass
    return stats.items[(stats.freqs >= thr) & (stats.freqs > 0)]



def mixed_traffic(num_tenants: int, n_updates: int, *,
                  delete_ratio: float = 0.5, skew: float = 1.2,
                  item_skew: float = 1.0, query_frac: float = 0.1,
                  query_size: int = 8, burst: int = 64,
                  universe: int = 1 << 16, seed: int = 0) -> List[tuple]:
    """A seeded day of multi-tenant traffic as a list of interleaved ops,

        ("update", tenant, items, weights)   signed int32 fragments
        ("query",  tenant, items)            point-query probes

    Tenant sizes are Zipf-skewed (rank r weighted ``r^-skew``, drawn
    multinomially to sum to ``n_updates`` insertions): a few whales and a
    long tail. Each tenant's stream is a bounded-deletion stream of its
    own (Zipf(``item_skew``) insertions over ``universe`` ids; a fraction
    ``delete_ratio`` of them deleted again, each at a uniform time after
    its insertion), cut into ``burst``-sized update ops; after each burst,
    with probability ``query_frac``, a query probes ``query_size`` ids
    drawn from it. The ops of all tenants are shuffled together, each
    tenant's own order kept, so every deletion still follows its
    insertion. The same shape as the reference's generator, drawn with
    numpy arrays over all tenants at once (not its draws).
    """
    rng = np.random.default_rng(seed)
    T = int(num_tenants)
    p = np.arange(1, T + 1, dtype=np.float64) ** -float(skew)
    sizes = rng.multinomial(int(n_updates), p / p.sum())
    n = int(sizes.sum())
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    tenant = np.repeat(np.arange(T), sizes)
    local = np.arange(n) - first[tenant]
    items = _zipf_ranks(n, universe, item_skew,
                            seed=int(rng.integers(2**31)))
    # victims: the n_del[t] insertions of tenant t first in a random order
    n_del = (delete_ratio * sizes).astype(np.int64)
    shuffled = np.lexsort((rng.random(n), tenant))
    victim = shuffled[(np.arange(n) - first[tenant[shuffled]])
                      < n_del[tenant[shuffled]]]
    t_del = rng.uniform(local[victim] + 0.5, sizes[tenant[victim]] + 0.5)
    ev_tenant = np.concatenate([tenant, tenant[victim]])
    ev_time = np.concatenate([local.astype(np.float64), t_del])
    order = np.lexsort((ev_time, ev_tenant))
    ev_tenant = ev_tenant[order]
    ev_items = np.concatenate([items, items[victim]])[order].astype(np.int32)
    ev_signs = np.concatenate([np.ones(n, np.int32),
                               -np.ones(len(victim), np.int32)])[order]
    # bursts: per tenant, consecutive runs of `burst` events
    lens = sizes + n_del
    ev_first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nb = -(-lens // burst)
    b_tenant = np.repeat(np.arange(T), nb)
    b_index = np.arange(int(nb.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(nb)[:-1]]), nb)
    b_start = ev_first[b_tenant] + b_index * burst
    b_len = np.minimum(burst, ev_first[b_tenant] + lens[b_tenant] - b_start)
    asks = rng.random(len(b_start)) < query_frac
    probe = (b_start[:, None] + (rng.random((len(b_start), query_size))
                                 * b_len[:, None]).astype(np.int64))
    # each tenant's ops in order: burst, its query if any, next burst...
    ops_t: List[list] = [[] for _ in range(T)]
    for b in range(len(b_start)):
        t, s0 = int(b_tenant[b]), int(b_start[b])
        ops_t[t].append(("update", t, ev_items[s0:s0 + b_len[b]],
                         ev_signs[s0:s0 + b_len[b]]))
        if asks[b]:
            ops_t[t].append(("query", t, ev_items[probe[b, :min(
                query_size, int(b_len[b]))]]))
    labels = np.repeat(np.arange(T), [len(o) for o in ops_t])
    rng.shuffle(labels)
    cursors = [0] * T
    out: List[tuple] = []
    for t in labels.tolist():
        out.append(ops_t[t][cursors[t]])
        cursors[t] += 1
    return out

__all__ = ["Update", "zipf_insertions", "binomial_insertions",
           "uniform_insertions", "caida_like_insertions", "deletions_random",
           "deletions_targeted", "make_stream", "bounded_stream",
           "zipf_interleaved_stream", "StreamStats", "exact_stats",
           "heavy_hitters", "mixed_traffic"]
