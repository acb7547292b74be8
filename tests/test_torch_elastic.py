"""The port's elastic layer (``sketch/elastic.py``) against the reference
package, on ``tests/test_elastic.py``'s grid.

Resizes (``reshard`` S -> 1, S/2, 2S over zipf, uniform and adversarial
streams at alpha 1.25, 2 and 4; ``reshard_dyadic``) give the reference's
banks and ``ResizeReport`` fields and keep its bounds; the merge-spelled
oracle is the reference's; ``scan_rows``, ``dead_shards``, ``mask_rows``
and the degraded queries answer as there (on the main stream too: the
healthy rows the fault phase's twin flags are flagged by the reference's
engine, fed each row's own entries); checkpoint + replay recovery
equals the reference's recovery and a never-failed twin; the session's
resize, schedule round trip and window check behave as the reference's.
Streams come from the reference's generator as numpy arrays, fed to
both packages; the state is int32, so every comparison is exact.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax

from repro.core.streams import bounded_stream, exact_stats
from repro.sketch import api as japi
from repro.sketch import elastic as jel
from repro.sketch import faults as jfl
from repro.sketch.session import StreamSession as JSession
from repro_torch.sketch import api as tapi
from repro_torch.sketch import elastic as tel
from repro_torch.sketch import faults as tfl
from repro_torch.sketch import session as tses
from repro_torch.sketch import sharded as tshd

S = 4
KTOT = 512
N_INSERT = 4000
ALPHAS = (1.25, 2.0, 4.0)
CPU = "cpu"
DIST_CASES = {
    "zipf": dict(distribution="zipf", delete_pattern="random",
                 order="interleaved"),
    "uniform": dict(distribution="uniform", delete_pattern="random",
                    order="interleaved"),
    "adversarial": dict(distribution="zipf", delete_pattern="targeted",
                        order="inserts_first"),
}


def _stream(case, alpha, seed):
    return bounded_stream(n_insert=N_INSERT, delete_ratio=1.0 - 1.0 / alpha,
                          seed=seed, **DIST_CASES[case])


def _fed(stream, ktot=KTOT, s=S):
    """(reference spec, reference state, port spec, port state) after one
    ingest of the whole stream, the banks equal."""
    jspec = japi.SketchSpec(kind="frequency", k=ktot, shards=s)
    tspec = tapi.SketchSpec(kind="frequency", k=ktot, shards=s)
    js = japi.update(jspec, japi.make(jspec), stream[:, 0], stream[:, 1])
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), stream[:, 0],
                     stream[:, 1])
    _same_bank(js.bank, ts.bank)
    return jspec, js, tspec, ts


def _same_bank(jbank, tbank, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), jbank, tbank):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _same_report(want, got):
    assert (got.old_rows, got.new_rows, got.moved, got.dropped,
            got.dropped_mass, got.error_slack) == \
        (want.old_rows, want.new_rows, want.moved, want.dropped,
         want.dropped_mass, want.error_slack)
    np.testing.assert_array_equal(got.row_slack, want.row_slack)


def _same_leaves(jstate, tstate, msg=""):
    want, got = jax.tree.leaves(jstate), tses._leaves(tstate)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


def _live_map(bank):
    ids, cnt, err = (t.reshape(-1).numpy() for t in bank)
    live = ids >= 0
    return {int(i): (int(c), int(e))
            for i, c, e in zip(ids[live], cnt[live], err[live])}


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(DIST_CASES))
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("new_s", [1, S // 2, 2 * S])
def test_estimates_within_summed_bound(case, alpha, new_s):
    stream = _stream(case, alpha, seed=int(alpha * 10) + new_s)
    stats = exact_stats(stream)
    _, js, _, ts = _fed(stream)
    jnew, jrep = jel.reshard(js, new_s)
    tnew, trep = tel.reshard(ts, new_s)
    _same_report(jrep, trep)
    _same_bank(jnew.bank, tnew.bank)
    items = np.asarray(sorted(stats.frequencies), np.int32)
    freqs = np.asarray([stats.frequencies[int(i)] for i in items], np.int64)
    est = tshd.query_many(tnew, torch.from_numpy(items)).numpy()
    bound = (2 * alpha / (KTOT // S)) * stats.residual_mass \
        + trep.error_slack + 1e-9
    assert np.abs(est - freqs).max() <= bound


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_resize_to_one_is_lossless_consolidate(case):
    _, _, _, ts = _fed(_stream(case, 2.0, seed=3))
    new, report = tel.reshard(ts, 1)
    assert report.dropped == 0 and report.error_slack == 0
    assert _live_map(new.bank) == _live_map(ts.bank)


@pytest.mark.parametrize("new_s", [1, 2, 8])
def test_monitored_counters_move_verbatim_or_drop_below_slack(new_s):
    _, _, _, ts = _fed(_stream("zipf", 2.0, seed=11))
    new, report = tel.reshard(ts, new_s, per_shard_capacity=100)
    before, after = _live_map(ts.bank), _live_map(new.bank)
    ids = np.asarray(sorted(before), np.int32)
    owner = tel._owners(ids, new_s)
    for i, o in zip(ids, owner):
        if int(i) in after:
            assert after[int(i)] == before[int(i)]
        else:
            assert before[int(i)][0] <= report.row_slack[o]
    jnew, jrep = jel.reshard(_ref_sharded(ts), new_s,
                             per_shard_capacity=100)
    _same_report(jrep, report)
    _same_bank(jnew.bank, new.bank)


def _ref_sharded(ts):
    """The port's sharded state as the reference's."""
    import jax.numpy as jnp

    from repro.sketch import sharded as jshd
    from repro.sketch.state import SketchState as JState

    return jshd.ShardedSketch(bank=JState(*(jnp.asarray(t.numpy())
                                            for t in ts.bank)))


def test_fast_path_matches_merge_reference():
    _, js, _, ts = _fed(_stream("zipf", 2.0, seed=5), ktot=256, s=4)
    for new_s in (1, 2, 8):
        fast, report = tel.reshard(ts, new_s, per_shard_capacity=256)
        assert report.dropped == 0
        ref = tel._reshard_merge_reference(ts, new_s)
        jref = jel._reshard_merge_reference(js, new_s)
        _same_bank(jref, ref, f"S'={new_s}")
        for r in range(new_s):
            got = _live_map(tuple(t[r] for t in fast.bank))
            want = _live_map(tuple(t[r] for t in ref))
            assert got == want, (new_s, r)


@pytest.mark.parametrize("new_s", [1, 2, 4, 8])
def test_dyadic_resize_preserves_ranks(new_s):
    bits = 8
    jspec = japi.SketchSpec(kind="quantile", k=2048, bits=bits, shards=S)
    tspec = tapi.SketchSpec(kind="quantile", k=2048, bits=bits, shards=S)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 1 << bits, 3000)
    js = japi.update(jspec, japi.make(jspec), xs, np.ones(len(xs), np.int64))
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), xs,
                     np.ones(len(xs), np.int64))
    want = tapi.rank_many(tspec, ts, np.arange(1 << bits))
    jnew, jrep = jel.reshard_dyadic(js, new_s)
    tnew, trep = tel.reshard_dyadic(ts, new_s)
    _same_report(jrep, trep)
    _same_leaves(jnew, tnew)
    spec2 = dataclasses.replace(tspec, shards=new_s)
    got = tapi.rank_many(spec2, tnew, np.arange(1 << bits))
    assert int(tnew.mass) == int(ts.mass)
    assert torch.equal(got, want)


def test_dyadic_shrink_that_drops_matches_the_reference():
    """A shrink whose co-landing nodes pass a level's capacity drops
    counters with the reference's slack."""
    bits = 8
    kw = dict(kind="quantile", k=128, bits=bits, shards=S)
    jspec, tspec = japi.SketchSpec(**kw), tapi.SketchSpec(**kw)
    rng = np.random.default_rng(4)
    xs = rng.integers(0, 1 << bits, 4000)
    js = japi.update(jspec, japi.make(jspec), xs, np.ones(len(xs), np.int64))
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), xs,
                     np.ones(len(xs), np.int64))
    jnew, jrep = jel.reshard_dyadic(js, 1)
    tnew, trep = tel.reshard_dyadic(ts, 1)
    assert trep.dropped > 0
    _same_report(jrep, trep)
    _same_leaves(jnew, tnew)


def test_reshard_rejects_bad_counts():
    _, _, _, ts = _fed(_stream("zipf", 2.0, seed=1))
    with pytest.raises(ValueError, match="new_shards"):
        tel.reshard(ts, 0)
    with pytest.raises(ValueError, match="new_shards"):
        tel.reshard_dyadic(tapi.make(tapi.SketchSpec(
            kind="quantile", k=256, bits=6, shards=2), device=CPU), 0)


@pytest.mark.parametrize("seed,case,alpha,new_s", [
    (0, "zipf", 1.25, 3), (77, "uniform", 4.0, 8), (1234, "adversarial",
                                                      2.0, 1),
    (65535, "zipf", 4.0, 2)])
def test_resize_bound_fuzz(seed, case, alpha, new_s):
    """The reference's hypothesis fuzz at fixed draws."""
    stream = _stream(case, alpha, seed=seed)
    stats = exact_stats(stream)
    _, js, _, ts = _fed(stream)
    new, report = tel.reshard(ts, new_s)
    jnew, jrep = jel.reshard(js, new_s)
    _same_report(jrep, report)
    _same_bank(jnew.bank, new.bank)
    items = np.asarray(sorted(stats.frequencies), np.int32)
    freqs = np.asarray([stats.frequencies[int(i)] for i in items], np.int64)
    est = tshd.query_many(new, torch.from_numpy(items)).numpy()
    bound = (2 * alpha / (KTOT // S)) * stats.residual_mass \
        + report.error_slack + 1e-9
    assert np.abs(est - freqs).max() <= bound


# ---------------------------------------------------------------------------
# Detection and degraded serving
# ---------------------------------------------------------------------------

def _state(seed=0):
    return _fed(_stream("zipf", 2.0, seed=seed))[3]


def test_healthy_bank_scans_clean():
    assert not tel.scan_rows(_state().bank).any()


# The rows of the main spec's bank (eps 1e-5, alpha 2, 128 shards, "bank")
# that the never-failed twin of chip_smoke.py's fault phase flags after
# the 64 blocks of its main stream: healthy rows, each rebuilt there, bit
# for bit, from its own entries alone. Rows 3 and 7 it leaves clean.
TWIN_FLAGGED = (25, 41, 49, 84, 94, 96, 104, 105, 115, 126)


@functools.lru_cache(maxsize=1)
def _main_stream_blocks():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n, block = cs.FAULTS["blocks"], 65536
    stream = cs.make_stream(n, block, seed=1)[:n * block]
    return cs, cs._blocks(stream, block)


@pytest.mark.parametrize("row", TWIN_FLAGGED + (3, 7))
def test_main_stream_row_scans_as_the_reference(row):
    """SS± on a healthy stream flags rows: the reference's engine, fed the
    entries a flagged row owns in the main stream, takes an error below
    0, and its ``scan_rows`` flags the row, as the port's does on the
    same row bit for bit. A row the twin leaves clean scans clean in
    both."""
    cs, blocks = _main_stream_blocks()
    spec = cs.fault_spec()
    fragments = cs.row_fragments(spec, blocks, row, cs.FAULTS["row_pad"])
    tstate = cs.row_alone(spec, fragments, row)
    jspec = japi.SketchSpec(k=tstate.ids.shape[0], alpha=spec.alpha,
                            variant=spec.variant, bits=spec.bits)
    jstate = japi.make(jspec)
    for items, weights in fragments:
        jstate = japi.update(jspec, jstate, items, weights)
    for name, jt, tt in zip(jstate._fields, jstate, tstate):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt),
                                      err_msg=f"row {row} {name}")
    flagged = row in TWIN_FLAGGED
    jbank = type(jstate)(*(t[None] for t in jstate))
    assert bool(np.asarray(jel.scan_rows(jbank))[0]) is flagged
    assert bool(tel.scan_rows(tuple(t[None] for t in tstate))[0]) is flagged
    assert (int(tstate.errors.min()) < 0 or int(tstate.counts.min()) < 0) \
        is flagged


def test_poisoned_rows_detected():
    ts = _state()
    poisoned = tfl.poison_rows(ts, [1, 3])
    np.testing.assert_array_equal(tel.scan_rows(poisoned.bank),
                                  [False, True, False, True])
    assert not tel.scan_rows(ts.bank).any()     # the given state kept
    np.testing.assert_array_equal(
        jel.scan_rows(jfl.poison_rows(_ref_sharded(ts), [1, 3]).bank),
        tel.scan_rows(poisoned.bank))
    _same_bank(jfl.poison_rows(_ref_sharded(ts), [1, 3]).bank, poisoned.bank)


def test_negative_count_detected():
    ts = _state()
    counts = ts.bank.counts.clone()
    counts[2, 0] = -5
    assert tel.scan_rows(ts.bank._replace(counts=counts))[2]


def test_duplicate_live_ids_detected():
    ts = _state()
    ids = ts.bank.ids.clone()
    live = np.flatnonzero(ids[0].numpy() >= 0)
    ids[0, live[1]] = ids[0, live[0]]
    assert tel.scan_rows(ts.bank._replace(ids=ids))[0]
    # one row (1-D) scans as a bank of one
    assert tel.scan_rows(tuple(t[0] for t in ts.bank._replace(ids=ids))) \
        .tolist() == [True]


def test_degraded_queries_mask_dead_owner():
    ts = _state()
    healthy = tshd.query_many(ts, torch.arange(64)).numpy()
    poisoned = tfl.poison_rows(ts, [2])
    dead = tel.scan_rows(poisoned.bank)
    est, reliable = tel.query_many_degraded(poisoned, np.arange(64), dead)
    jest, jrel = jel.query_many_degraded(
        jfl.poison_rows(_ref_sharded(ts), [2]), np.arange(64), dead)
    np.testing.assert_array_equal(est.numpy(), np.asarray(jest))
    np.testing.assert_array_equal(reliable, jrel)
    owner = tel._owners(np.arange(64), S)
    np.testing.assert_array_equal(reliable, owner != 2)
    np.testing.assert_array_equal(est.numpy()[reliable], healthy[reliable])
    assert (est.numpy()[~reliable] == 0).all()
    masked = tel.mask_rows(poisoned.bank, dead)
    _same_bank(jel.mask_rows(jfl.poison_rows(_ref_sharded(ts), [2]).bank,
                             dead), masked)
    with pytest.raises(ValueError, match="width"):
        tel.mask_rows(poisoned.bank, dead, caps=[7] * S)


def test_dead_shards_of_a_dyadic_bank():
    kw = dict(kind="quantile", k=1024, bits=8, shards=S)
    jspec, tspec = japi.SketchSpec(**kw), tapi.SketchSpec(**kw)
    xs = np.random.default_rng(1).integers(0, 256, 800)
    ts = tapi.update(tspec, tapi.make(tspec, device=CPU), xs,
                     np.ones(800, np.int64))
    js = japi.update(jspec, japi.make(jspec), xs, np.ones(800, np.int64))
    for rows in ([], [0], [1, 3]):
        tp, jp = tfl.poison_rows(ts, rows), jfl.poison_rows(js, rows)
        np.testing.assert_array_equal(tel.dead_shards(tspec, tp),
                                      jel.dead_shards(jspec, jp))
        assert set(np.flatnonzero(tel.dead_shards(tspec, tp))) == set(rows)


# ---------------------------------------------------------------------------
# Recovery: checkpoint + replay == never-failed (exactly once)
# ---------------------------------------------------------------------------

def _sessions(tspec, jspec, block=64, replay=128, window=None):
    return (tses.StreamSession(tspec, block=block, window=window,
                               replay=replay, device=CPU),
            tses.StreamSession(tspec, block=block, window=window,
                               device=CPU),
            JSession(jspec, block=block, window=window, replay=replay))


@pytest.mark.parametrize("kind_kw", [dict(kind="frequency", k=KTOT),
                                     dict(kind="quantile", k=2048, bits=8)])
def test_recovery_is_bit_exact_and_restores_recall(kind_kw):
    tspec = tapi.SketchSpec(shards=S, **kind_kw)
    jspec = japi.SketchSpec(shards=S, **kind_kw)
    sess, ref, jsess = _sessions(tspec, jspec)
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 640)
    for s in (sess, ref, jsess):
        s.extend(a)
        s.flush()
    ckpt, jckpt = sess.save(include_schedule=True), \
        jsess.save(include_schedule=True)
    b = rng.integers(0, 256, 320)
    sess.fault_plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=sess._seq + 2, row=1, kind="corrupt"),))
    jsess.fault_plan = jfl.FaultPlan(events=(
        jfl.FaultEvent(step=jsess._seq + 2, row=1, kind="corrupt"),))
    for s in (sess, ref, jsess):
        s.extend(b)
        s.flush()
    dead = tel.dead_shards(tspec, sess.state)
    assert dead[1] and dead.sum() == 1
    report = tel.recover_session(sess, ckpt)
    jreport = jel.recover_session(jsess, jckpt)
    assert report.rows == jreport.rows == (1,)
    assert report.replayed_blocks == jreport.replayed_blocks > 0
    for x, y in zip(tses._leaves(sess.state), tses._leaves(ref.state)):
        assert torch.equal(x, y)
    _same_leaves(jsess.state, sess.state)
    want = {int(i) for i in tapi.topk(tspec, ref.state, 32)[0] if i >= 0}
    got = {int(i) for i in tapi.topk(tspec, sess.state, 32)[0] if i >= 0}
    assert want and want <= got


def test_drop_fault_recovery_restores_exact_counts():
    tspec = tapi.SketchSpec(kind="frequency", k=KTOT, shards=S)
    jspec = japi.SketchSpec(kind="frequency", k=KTOT, shards=S)
    sess, ref, jsess = _sessions(tspec, jspec)
    rng = np.random.default_rng(13)
    a = rng.integers(0, 256, 320)
    for s in (sess, ref, jsess):
        s.extend(a)
        s.flush()
    ckpt, jckpt = sess.save(include_schedule=True), \
        jsess.save(include_schedule=True)
    sess.fault_plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=sess._seq + 1, row=0, kind="drop"),))
    jsess.fault_plan = jfl.FaultPlan(events=(
        jfl.FaultEvent(step=jsess._seq + 1, row=0, kind="drop"),))
    b = rng.integers(0, 256, 64)
    for s in (sess, ref, jsess):
        s.extend(b)
        s.flush()
    _same_leaves(jsess.state, sess.state, "dropped")
    # a drop leaves the rows structurally healthy: recover explicit rows
    tel.recover_session(sess, ckpt, rows=[0])
    jel.recover_session(jsess, jckpt, rows=[0])
    assert torch.equal(sess.state.bank.counts, ref.state.bank.counts)
    _same_leaves(jsess.state, sess.state, "recovered")


def test_unsharded_recovery_replaces_the_whole_state():
    tspec = tapi.SketchSpec(kind="frequency", k=64)
    sess = tses.StreamSession(tspec, block=32, replay=8, device=CPU)
    ref = tses.StreamSession(tspec, block=32, device=CPU)
    ckpt = sess.save(include_schedule=True)
    for s in (sess, ref):
        s.extend(np.arange(96, dtype=np.int32) % 40)
        s.flush()
    sess.state = tapi.make(tspec, device=CPU)
    report = tel.recover_session(sess, ckpt)
    assert report.rows == () and report.replayed_blocks == 3
    for x, y in zip(sess.state, ref.state):
        assert torch.equal(x, y)


def test_recover_requires_schedule_checkpoint():
    spec = tapi.SketchSpec(kind="frequency", k=64, shards=2)
    sess = tses.StreamSession(spec, block=32, replay=8, device=CPU)
    with pytest.raises(ValueError, match="include_schedule"):
        tel.recover_session(sess, sess.save())
    other = tses.StreamSession(dataclasses.replace(spec, shards=4), block=32,
                               device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        tel.recover_session(sess, other.save(include_schedule=True))


def test_recover_detects_replay_log_gap():
    spec = tapi.SketchSpec(kind="frequency", k=64, shards=2)
    sess = tses.StreamSession(spec, block=32, replay=2, device=CPU)
    ckpt = sess.save(include_schedule=True)
    sess.extend(np.arange(32 * 5, dtype=np.int32))
    sess.flush()
    with pytest.raises(ValueError, match="replay log"):
        tel.recover_session(sess, ckpt, rows=[0])


def test_replay_log_holds_copies_of_reused_buffers():
    """The log keeps its own copy of each block: a caller that refills
    one buffer block after block (as the pinned slot and the feeder's
    slots are refilled) leaves the logged blocks as they were."""
    spec = tapi.SketchSpec(kind="frequency", k=64, shards=2)
    sess = tses.StreamSession(spec, block=16, replay=4, device=CPU)
    buf_i = torch.zeros(16, dtype=torch.int32)
    buf_w = torch.ones(16, dtype=torch.int32)
    for b in range(3):
        buf_i.fill_(b + 1)
        sess.ingest_block(buf_i, buf_w)
    assert [int(i[0]) for _, i, _ in sess.replay_log] == [1, 2, 3]
    assert all(isinstance(i, np.ndarray) for _, i, _ in sess.replay_log)


# ---------------------------------------------------------------------------
# Session-level resize and the schedule round trip
# ---------------------------------------------------------------------------

def test_reshard_session_in_place():
    tspec = tapi.SketchSpec(kind="frequency", k=KTOT, shards=S)
    jspec = japi.SketchSpec(kind="frequency", k=KTOT, shards=S)
    sess = tses.StreamSession(tspec, block=64, device=CPU)
    jsess = JSession(jspec, block=64)
    rng = np.random.default_rng(2)
    xs = rng.integers(0, 1024, 640)
    sess.extend(xs)
    jsess.extend(xs)
    before = sess.query_many(xs[:32]).numpy()
    for new_s in (2 * S, 3, 1):
        report = tel.reshard_session(sess, new_s)
        jrep = jel.reshard_session(jsess, new_s)
        _same_report(jrep, report)
        assert sess.spec.shards == new_s
        assert sess.error_slack == jsess.error_slack
        _same_leaves(jsess.state, sess.state, f"S'={new_s}")
    assert np.abs(sess.query_many(xs[:32]).numpy() - before).max() \
        <= sess.error_slack
    sess.extend(xs)
    jsess.extend(xs)
    _same_leaves(jsess.state, sess.state, "after")
    assert int(sess.query(int(xs[0]))) >= int(before[0])
    d = sess.save(include_schedule=True)
    assert int(d["sched_error_slack"]) == sess.error_slack
    back = JSession(jspec, block=64)
    back.load(d)
    assert back.error_slack == sess.error_slack


def test_reshard_session_of_a_dyadic_session():
    kw = dict(kind="quantile", k=512, bits=8, shards=2)
    tspec, jspec = tapi.SketchSpec(**kw), japi.SketchSpec(**kw)
    sess, jsess = (tses.StreamSession(tspec, block=64, device=CPU),
                   JSession(jspec, block=64))
    xs = np.random.default_rng(8).integers(0, 256, 500)
    sess.extend(xs)
    jsess.extend(xs)
    _same_report(jel.reshard_session(jsess, 4), tel.reshard_session(sess, 4))
    _same_leaves(jsess.state, sess.state)
    sess.extend(xs[:100])
    jsess.extend(xs[:100])
    np.testing.assert_array_equal(
        sess.rank_many(np.arange(256)).numpy(),
        np.asarray(jsess.rank_many(np.arange(256))))


def test_reshard_session_rejects_unsharded():
    sess = tses.StreamSession(tapi.SketchSpec(kind="frequency", k=64),
                              block=32, device=CPU)
    with pytest.raises(ValueError, match="sharded"):
        tel.reshard_session(sess, 2)


def test_save_schedule_roundtrip_loses_nothing():
    spec = tapi.SketchSpec(kind="quantile", k=512, bits=8, shards=2)
    a = tses.StreamSession(spec, block=32, window=3, device=CPU)
    rng = np.random.default_rng(4)
    for _ in range(7):
        a.push(rng.integers(0, 256, 16), np.ones(16, np.int64))
    for v in rng.integers(0, 256, 5):
        a.observe(int(v))
    d = a.save(include_schedule=True)
    b = tses.StreamSession(spec, block=32, window=3, device=CPU)
    b.load(d)
    assert (b.insertions, b.deletions) == (a.insertions, a.deletions)
    assert b._buf_n == a._buf_n and b._seq == a._seq
    assert len(b.batch_fifo) == len(a.batch_fifo)
    assert len(b._item_fifo) == len(a._item_fifo)
    nxt = rng.integers(0, 256, 16)
    a.push(nxt, np.ones(16, np.int64))
    b.push(nxt, np.ones(16, np.int64))
    a.flush()
    b.flush()
    for x, y in zip(tses._leaves(a.state), tses._leaves(b.state)):
        assert torch.equal(x, y)


def test_save_schedule_does_not_flush():
    sess = tses.StreamSession(tapi.SketchSpec(kind="frequency", k=64),
                              block=32, device=CPU)
    sess.extend(np.full(3, 9, np.int32))
    sess.save(include_schedule=True)
    assert sess._buf_n == 3
    sess.save()
    assert sess._buf_n == 0


def test_load_rejects_window_mismatch():
    spec = tapi.SketchSpec(kind="frequency", k=64)
    a = tses.StreamSession(spec, block=32, window=5, device=CPU)
    a.push(np.arange(8, dtype=np.int32), np.ones(8, np.int32))
    d = a.save(include_schedule=True)
    b = tses.StreamSession(spec, block=32, window=2, device=CPU)
    with pytest.raises(ValueError, match="window"):
        b.load(d)
