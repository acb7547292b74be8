"""The port's data pipeline (``repro_torch/data``) against the
reference's (``repro/data``): batches bit for bit over cursors, hosts
and seeds, cursor state and restore, ``caida_like_tokens`` equal, and
``token_stats`` feeding the port's ``TokenStats`` to the reference's
tracker's state, bit for bit. Plus the reference's own
``tests/test_data.py`` cases on the port."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JPipeline
from repro.data import caida_like_tokens as j_caida
from repro_torch.data import DataConfig, TokenPipeline, caida_like_tokens


def _cfgs(**kw):
    d = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    d.update(kw)
    return JDataConfig(**d), DataConfig(**d)


def _same_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_batches_bit_for_bit_over_cursors_and_hosts(seed, hosts):
    jc, tc = _cfgs(seed=seed, mean_doc_len=16)
    for host in range(hosts):
        jp, tp = (JPipeline(jc, host, hosts), TokenPipeline(tc, host, hosts))
        assert tp.local_batch == jp.local_batch
        for cursor in (0, 1, 7, 50):
            _same_batch(jp.batch_at(cursor), tp.batch_at(cursor))
        for _ in range(3):
            _same_batch(jp.next_batch(), tp.next_batch())
        assert tp.cursor == jp.cursor == 3


@pytest.mark.parametrize("kw", [dict(vocab_size=151_936, seq_len=16),
                                dict(zipf_s=1.05, bos_token=5),
                                dict(global_batch=3, seq_len=1)])
def test_batches_bit_for_bit_over_configs(kw):
    jc, tc = _cfgs(**kw)
    jp, tp = JPipeline(jc), TokenPipeline(tc)
    for cursor in (0, 5):
        _same_batch(jp.batch_at(cursor), tp.batch_at(cursor))


def test_state_and_restore_as_the_reference():
    jc, tc = _cfgs()
    jp, tp = JPipeline(jc), TokenPipeline(tc)
    for _ in range(5):
        jp.next_batch()
        tp.next_batch()
    assert tp.state() == jp.state() == {"cursor": 5, "seed": 3}
    # a state saved by either restores in the other
    jp2, tp2 = JPipeline(jc), TokenPipeline(tc)
    jp2.restore(tp.state())
    tp2.restore(jp.state())
    _same_batch(jp2.next_batch(), tp2.next_batch())
    with pytest.raises(ValueError, match="seed mismatch"):
        tp2.restore({"cursor": 1, "seed": 4})


@pytest.mark.parametrize("n,universe,seed,kw", [
    (10_000, 1 << 12, 1, {}), (4096, 1 << 16, 0, {}),
    (5000, 1 << 10, 9, dict(head_s=1.2, background_frac=0.5))])
def test_caida_like_tokens_equal(n, universe, seed, kw):
    want = j_caida(n, universe=universe, seed=seed, **kw)
    got = caida_like_tokens(n, universe=universe, seed=seed, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shards", [None, 4])
def test_token_stats_feed_the_port_tracker_as_the_reference(shards):
    jc, tc = _cfgs(vocab_size=512, seq_len=32, global_batch=4, seed=1)
    kw = dict(capacity=64, window=3, shards=shards, block=1024)
    want = JPipeline(jc).token_stats(6, **kw)
    got = TokenPipeline(tc).token_stats(6, device="cpu", **kw)
    assert (got.insertions, got.deletions) == (want.insertions,
                                               want.deletions)
    ws, gs = want.state_dict(), got.state_dict()
    for k in ("ids", "counts", "errors"):
        np.testing.assert_array_equal(np.asarray(gs[k]), np.asarray(ws[k]))
    probe = np.arange(512, dtype=np.int32)
    np.testing.assert_array_equal(got.query(probe), np.asarray(
        want.query(probe)))


# --- the reference's own cases (tests/test_data.py) on the port -----------

def test_batch_shapes_and_dtypes():
    p = TokenPipeline(_cfgs()[1])
    b = p.next_batch()
    assert b["tokens"].shape == (8, 64) and b["labels"].shape == (8, 64)
    assert b["tokens"].dtype == np.int32
    assert (b["tokens"] >= 0).all() and (b["tokens"] < 1000).all()


def test_labels_are_shifted_tokens():
    b = TokenPipeline(_cfgs()[1]).batch_at(0)
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()


def test_host_sharding_disjoint_and_deterministic():
    tc = _cfgs()[1]
    h0, h1 = TokenPipeline(tc, 0, 2), TokenPipeline(tc, 1, 2)
    b0, b1 = h0.next_batch(), h1.next_batch()
    assert b0["tokens"].shape == (4, 64)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(
        TokenPipeline(tc, 0, 2).next_batch()["tokens"], b0["tokens"])
    with pytest.raises(ValueError, match="num_hosts"):
        TokenPipeline(tc, 0, 3)


def test_zipf_marginal_is_heavy_tailed():
    p = TokenPipeline(_cfgs(global_batch=64, seq_len=256,
                            mean_doc_len=10**9)[1])
    toks = np.concatenate([p.next_batch()["tokens"].ravel()
                           for _ in range(4)])
    _, counts = np.unique(toks, return_counts=True)
    counts = np.sort(counts)[::-1]
    assert counts[0] > 10 * np.median(counts)
