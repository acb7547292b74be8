"""The paper's streams through the port's session against the reference's.

``repro_torch``'s ``StreamSession`` on the CPU (``backend="bank"``, the
partition core through kernel 1's plain version) against ``repro``'s
``StreamSession`` (``backend="bank"``), both fed the reference's
``bounded_stream``: Zipf(1.0) and CAIDA-like insertions, 4,000 over 2^12
ids, random and targeted deletions, ``inserts_first`` (every deletion
after every insertion, so the last blocks hold deletions only) at ratio
0.5 (alpha = 2) and 0.9375 (alpha = 16), SS± and Lazy SS± sized by Thm 4
/ Thm 2 for that alpha. Held equal, bit for bit: ids, counts, errors,
``query_many`` over the universe and ``topk``. Each reference run is made
once, in a module-scoped fixture, and shared by the assertions on it.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
from repro.core.streams import bounded_stream as ref_stream
from repro.sketch import api as japi
from repro.sketch.session import StreamSession as JSession
from repro_torch.core.streams import bounded_stream
from repro_torch.sketch import api as tapi
from repro_torch.sketch.session import StreamSession as TSession

BITS = 12
BLOCK = 1024
N_INSERT = 4000
EPS = {0.5: (0.02, 2.0), 0.9375: (0.16, 16.0)}   # ratio -> (eps, alpha)
CASES = [(dist, pattern, ratio, variant)
         for dist in ("zipf", "caida") for pattern in ("random", "targeted")
         for ratio in EPS for variant in ("sspm", "lazy")]


def _stream(dist, pattern, ratio):
    kw = dict(universe=1 << BITS, delete_pattern=pattern,
              order="inserts_first", seed=11)
    s = bounded_stream(dist, N_INSERT, ratio, **kw)
    assert np.array_equal(s, ref_stream(dist, N_INSERT, ratio, **kw))
    return s


def _spec(api, ratio, variant):
    eps, alpha = EPS[ratio]
    return api.SketchSpec(kind="frequency", eps=eps, alpha=alpha,
                          variant=variant, bits=BITS, backend="bank")


def _result(sess):
    d = (japi if isinstance(sess, JSession) else tapi).save(sess.spec,
                                                            sess.state)
    ids, counts = sess.topk(32)
    return dict(**{k: np.asarray(d[k]) for k in ("ids", "counts", "errors")},
                query=np.asarray(sess.query_many(np.arange(1 << BITS))),
                top_ids=np.asarray(ids), top_counts=np.asarray(counts))


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's run of each case, made on first use."""
    runs = {}

    def run(case):
        if case not in runs:
            dist, pattern, ratio, variant = case
            s = _stream(dist, pattern, ratio)
            sess = JSession(_spec(japi, ratio, variant), block=BLOCK)
            sess.ingest(s[:, 0], s[:, 1])
            runs[case] = _result(sess)
        return runs[case]
    return run


@pytest.mark.parametrize("dist,pattern,ratio,variant", CASES)
def test_session_on_the_papers_streams_is_the_references(
        reference_runs, dist, pattern, ratio, variant):
    s = _stream(dist, pattern, ratio)
    n_del = int(ratio * N_INSERT)
    assert len(s) == N_INSERT + n_del and (s[N_INSERT:, 1] == -1).all()
    sess = TSession(_spec(tapi, ratio, variant), block=BLOCK, device="cpu")
    sess.ingest(s[:, 0], s[:, 1])
    got = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in _result(sess).items()}
    want = reference_runs((dist, pattern, ratio, variant))
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    # the run reached deletion-only blocks
    assert sess.blocks_ingested == -(-len(s) // BLOCK)
    assert sess.blocks_ingested * BLOCK - N_INSERT >= 2 * BLOCK
