"""The port's windowed trackers (``sketch/stats.py``: ``TokenStats``,
``ExpertLoadStats``) against the reference's, on
``tests/test_sketch_stats.py``'s grid.

Each test feeds both packages' trackers the same numpy batches and holds
every answer equal, bit for bit (queries, top-k and hot-expert reports,
the insertion/deletion accounting, the state), besides the reference
test's own checks against exact windowed counts: exactness under
capacity, the alpha accounting, the Thm 4 bound, the hot experts, the
window forgetting, merges across hosts, and ``state_dict`` carried
across packages both ways, sharded too.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
from repro.sketch import stats as jstats
from repro_torch.sketch import stats as tstats


def _pair(cls_name, **kw):
    return (getattr(jstats, cls_name)(**kw),
            getattr(tstats, cls_name)(device="cpu", **kw))


def _same(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _same_report(a, b):
    _same(a.items, b.items, "items")
    _same(a.counts, b.counts, "counts")
    assert (a.insertions, a.deletions) == (b.insertions, b.deletions)
    assert a.alpha_bound == b.alpha_bound


def _same_state(pair):
    jd, td = (t.state_dict() for t in pair)
    for key in ("ids", "counts", "errors"):
        _same(jd[key], td[key], key)


def test_token_stats_exact_on_small_universe():
    """With capacity >= universe the sketch is exact."""
    pair = _pair("TokenStats", capacity=64, window=4, block=256)
    rng = np.random.default_rng(0)
    window_batches = []
    for _ in range(10):
        batch = rng.integers(0, 32, size=(2, 50)).astype(np.int32)
        for ts in pair:
            ts.update(batch)
        window_batches = (window_batches + [batch])[-4:]
    exact = collections.Counter(
        np.concatenate([b.ravel() for b in window_batches]).tolist())
    got = pair[1].query(np.arange(32))
    _same(got, [exact.get(i, 0) for i in range(32)])
    _same(got, pair[0].query(np.arange(32)))
    _same_state(pair)


def test_token_stats_alpha_accounting():
    pair = _pair("TokenStats", capacity=128, window=4, block=256)
    rng = np.random.default_rng(1)
    for _ in range(12):
        batch = rng.integers(0, 1000, size=100).astype(np.int32)
        for ts in pair:
            ts.update(batch)
    # 12 batches inserted, 8 expired: I = 1200, D = 800
    assert (pair[1].insertions, pair[1].deletions) == (1200, 800)
    rep = pair[1].topk(4)
    assert rep.alpha_bound == pytest.approx(1200 / 400)
    _same_report(pair[0].topk(4), rep)


def test_token_stats_error_bound_thm4():
    """SS±: |f - f_hat| <= eps (I - D) with eps = 2 alpha / k."""
    k, window = 256, 2
    pair = _pair("TokenStats", capacity=k, window=window, block=512)
    rng = np.random.default_rng(2)
    live = []
    for _ in range(6):
        batch = (rng.zipf(1.5, size=400) % 5000).astype(np.int32)
        for ts in pair:
            ts.update(batch)
        live = (live + [batch])[-window:]
    exact = collections.Counter(np.concatenate(live).tolist())
    ts = pair[1]
    I, D = ts.insertions, ts.deletions
    bound = 2 * (I / (I - D)) / k * (I - D)
    queries = np.arange(5000)
    got = ts.query(queries)
    _same(got, pair[0].query(queries))
    err = np.abs(got.astype(np.int64)
                 - np.asarray([exact.get(i, 0) for i in queries]))
    assert err.max() <= bound + 1e-9
    _same_report(pair[0].topk(16), ts.topk(16))


@pytest.mark.parametrize("shards", [None, 2])
def test_expert_load_stats_hot_experts(shards):
    pair = _pair("ExpertLoadStats", num_experts=16, capacity=16, window=8,
                 shards=shards)
    rng = np.random.default_rng(0)
    for _ in range(20):
        counts = rng.poisson(5, size=16)
        counts[3] += 200  # expert 3 is persistently hot
        for es in pair:
            es.update(counts)
    hot = pair[1].hot_experts(phi=0.25)
    assert 3 in hot.items.tolist()
    assert pair[1].deletions > 0  # the window expired
    _same_report(pair[0].hot_experts(phi=0.25), hot)
    _same_state(pair)


def test_expert_load_stats_window_forgets():
    pair = _pair("ExpertLoadStats", num_experts=8, capacity=8, window=2)
    for es in pair:
        es.update(np.array([100, 0, 0, 0, 0, 0, 0, 0]))
        for _ in range(4):
            es.update(np.array([0, 10, 0, 0, 0, 0, 0, 0]))
    rep = pair[1].hot_experts(phi=0.5)
    assert 0 not in rep.items.tolist()   # the burst left the window
    _same_report(pair[0].hot_experts(phi=0.5), rep)


@pytest.mark.parametrize("shards", [None, 4])
def test_merge_across_hosts(shards):
    a = _pair("TokenStats", capacity=64, window=100, block=128,
              shards=shards)
    b = _pair("TokenStats", capacity=64, window=100, block=128,
              shards=shards)
    for x, y in zip(a, b):
        x.update(np.array([1] * 50 + [2] * 10, dtype=np.int32))
        y.update(np.array([1] * 30 + [3] * 20, dtype=np.int32))
        x.merge_from(y)
    assert a[1].insertions == 110
    q = a[1].query(np.array([1, 2, 3]))
    _same(q, [80, 10, 20])   # exact: both sketches under capacity
    _same(q, a[0].query(np.array([1, 2, 3])))
    assert len(a[1].bank.batch_fifo) == 2
    with pytest.raises(ValueError, match="sharded and unsharded"):
        a[1].merge_from(tstats.TokenStats(capacity=64, window=100, block=128,
                                          shards=None if shards else 2,
                                          device="cpu"))


@pytest.mark.parametrize("shards", [None, 2])
def test_state_dict_carries_across_packages(shards):
    """A tracker resumed from the other package's ``state_dict`` goes on
    exactly as the uninterrupted one, window expiries included."""
    pair = _pair("TokenStats", capacity=96, window=3, block=128,
                 shards=shards)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 300, 150).astype(np.int32) for _ in range(9)]
    for batch in batches[:5]:
        for ts in pair:
            ts.update(batch)
    jd, td = (t.state_dict() for t in pair)
    assert set(jd) == set(td)
    for a, b in zip(jd["fifo_u"] + jd["fifo_c"], td["fifo_u"] + td["fifo_c"]):
        _same(a, b)
    port = tstats.TokenStats(capacity=96, window=3, block=128,
                             shards=shards, device="cpu")
    port.load_state_dict(jd)
    ref = jstats.TokenStats(capacity=96, window=3, block=128, shards=shards)
    ref.load_state_dict(td)
    for batch in batches[5:]:
        for ts in (*pair, port, ref):
            ts.update(batch)
    want = pair[0].query(np.arange(300))
    for ts in (pair[1], port, ref):
        _same(ts.query(np.arange(300)), want)
        assert (ts.insertions, ts.deletions) == (pair[0].insertions,
                                                 pair[0].deletions)
    _same_report(pair[0].topk(8), port.topk(8))
    with pytest.raises(KeyError):
        port.load_state_dict({k: v for k, v in td.items()
                              if k != "fifo_u"})


def test_state_attribute_surface():
    ts = tstats.TokenStats(capacity=32, window=2, block=64, device="cpu")
    ts.update(np.array([5, 5, 6], np.int32))
    kept = ts.state
    ts.insertions, ts.deletions = 10, 4
    assert ts.bank.insertions == 10 and ts.topk(2).alpha_bound == 10 / 6
    ts.update(np.array([7], np.int32))
    # donate=False: a state taken earlier is unchanged by later updates
    assert int((kept.ids == 7).sum()) == 0
    ts.state = kept
    _same(ts.query([5, 7]), [2, 0])
    sharded = tstats.TokenStats(capacity=32, window=2, block=64, shards=2,
                                device="cpu")
    assert sharded.state is None
    with pytest.raises(ValueError, match="shards"):
        sharded.state = kept
