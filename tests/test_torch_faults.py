"""The port's fault-injection harness (``sketch/faults.py``) and the
session's fault half against the reference package, on
``tests/test_faults.py``'s grid.

Plans drawn from one seed are the reference's, event for event; the
shard slices, drops and ``inject`` outcomes are the reference's; the
engine-level wrapper equals the healthy update on pre-dropped weights
and the reference's wrapper; sessions under each fault kind (drop,
duplicate, corrupt, delay) hold banks equal to the reference's sessions
under the same plan, delayed slices land at their due block, at a flush
and across checkpoints of either package; a delay walks the port's
straggler monitor to a flag. The three ``chaos`` cases drive seeded
random plans and hold recovery to a never-failed twin and to the
reference. Inputs come from numpy seeds; the state is int32, so every
comparison is exact.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import elastic as jel
from repro.sketch import faults as jfl
from repro.sketch.session import StreamSession as JSession
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import elastic as tel
from repro_torch.sketch import faults as tfl
from repro_torch.sketch import session as tses
from repro_torch.sketch import sharded as tshd
from repro_torch.train.straggler import StragglerConfig, StragglerMonitor

S = 4
CPU = "cpu"
CHAOS_SEEDS = ([int(os.environ["CHAOS_SEED"])]
               if os.environ.get("CHAOS_SEED") else [0, 1, 2])


def _specs(**kw):
    return japi.SketchSpec(**kw), tapi.SketchSpec(**kw)


def _pair(jspec, tspec, **kw):
    return JSession(jspec, block=64, **kw), tses.StreamSession(
        tspec, block=64, device=CPU, **kw)


def _leaves(state):
    return tses._leaves(state)


def _same_state(jstate, tstate, msg=""):
    import jax

    want = jax.tree.leaves(jstate)
    got = _leaves(tstate)
    assert len(want) == len(got), msg
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=msg)


def _same_outcome(want, got):
    assert len(want.blocks) == len(got.blocks)
    for (wi, ww), (gi, gw) in zip(want.blocks, got.blocks):
        np.testing.assert_array_equal(wi, gi)
        np.testing.assert_array_equal(ww, gw)
        assert ww.dtype == gw.dtype
    assert [d for d, _, _ in want.deferred] == [d for d, _, _ in got.deferred]
    for (_, wi, ww), (_, gi, gw) in zip(want.deferred, got.deferred):
        np.testing.assert_array_equal(wi, gi)
        np.testing.assert_array_equal(ww, gw)
    assert want.poison_rows == got.poison_rows
    assert want.delay_s == got.delay_s


# ---------------------------------------------------------------------------
# Harness mechanics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_steps,rows,n_faults,kinds", [
    (7, 50, S, 4, tfl.KINDS), (8, 50, S, 4, tfl.KINDS),
    (0, 64, 128, 8, tfl.KINDS), (3, 16, S, 5, ("corrupt", "drop")),
    (11, 1, 1, 3, ("delay",)), (2, 24, S, 6, tfl.KINDS)])
def test_plan_is_deterministic_per_seed(seed, n_steps, rows, n_faults, kinds):
    """One seed, one plan, the reference's event for event."""
    a = tfl.FaultPlan.random(seed=seed, n_steps=n_steps, rows=rows,
                             n_faults=n_faults, kinds=kinds)
    b = tfl.FaultPlan.random(seed=seed, n_steps=n_steps, rows=rows,
                             n_faults=n_faults, kinds=kinds)
    want = jfl.FaultPlan.random(seed=seed, n_steps=n_steps, rows=rows,
                                n_faults=n_faults, kinds=kinds)
    assert a == b
    assert [tuple(vars(e).values()) for e in a.events] \
        == [tuple(vars(e).values()) for e in want.events]
    assert a.max_step == want.max_step
    for step in range(n_steps + 2):
        assert len(a.events_at(step)) == len(want.events_at(step))
    assert all(1 <= e.step <= n_steps and 0 <= e.row < rows
               for e in a.events)
    assert a != tfl.FaultPlan.random(seed=seed + 1, n_steps=n_steps,
                                     rows=rows, n_faults=n_faults,
                                     kinds=kinds) or n_faults == 0


def test_event_validation():
    with pytest.raises(ValueError, match="kind"):
        tfl.FaultEvent(step=1, row=0, kind="explode")
    with pytest.raises(ValueError, match="delay_steps"):
        tfl.FaultEvent(step=1, row=0, kind="delay", delay_steps=0)
    assert tfl.FaultPlan().max_step == jfl.FaultPlan().max_step == -1


@pytest.mark.parametrize("num_shards", [1, S, 7])
def test_shard_slices_partition_the_block(num_shards):
    rng = np.random.default_rng(0)
    items = rng.integers(0, 1000, 256).astype(np.int32)
    weights = rng.integers(-3, 7, 256).astype(np.int32)
    total = np.zeros_like(weights)
    for r in range(num_shards):
        ti, tw = tfl.shard_slice(items, weights, r, num_shards)
        ji, jw = jfl.shard_slice(items, weights, r, num_shards)
        np.testing.assert_array_equal(tw, jw)
        assert tw.dtype == jw.dtype and ti is items
        total += tw
    np.testing.assert_array_equal(total, weights)


def test_drop_removes_exactly_the_owned_slice():
    rng = np.random.default_rng(1)
    items = rng.integers(0, 1000, 128)             # int64, cut to int32
    weights = np.ones(128, np.int32)
    w = tfl.drop_shard(items, weights, 2, S)
    np.testing.assert_array_equal(w, jfl.drop_shard(items, weights, 2, S))
    owner = tbk.shard_of(torch.from_numpy(items.astype(np.int32)), S).numpy()
    assert (w[owner == 2] == 0).all() and (w[owner != 2] == 1).all()


def test_inject_no_plan_is_identity():
    items = np.arange(64, dtype=np.int32)
    weights = np.ones(64, np.int32)
    out = tfl.inject(None, 3, S, items, weights)
    assert len(out.blocks) == 1
    np.testing.assert_array_equal(out.blocks[0][1], weights)
    assert not out.deferred and not out.poison_rows and not out.delay_s


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_inject_outcomes_match_the_reference(seed):
    """Every step of a dense random plan (several events a step, rows past
    the shard count included) gives the reference's outcome."""
    plan_kw = dict(seed=seed, n_steps=6, rows=S + 2, n_faults=12)
    tplan, jplan = (tfl.FaultPlan.random(**plan_kw),
                    jfl.FaultPlan.random(**plan_kw))
    rng = np.random.default_rng(seed)
    for step in range(1, 7):
        items = rng.integers(0, 512, 96).astype(np.int32)
        weights = rng.integers(-2, 4, 96).astype(np.int32)
        _same_outcome(jfl.inject(jplan, step, S, items, weights),
                      tfl.inject(tplan, step, S, items, weights))


def test_faulty_engine_wrapper_matches_predropped_ingest():
    rng = np.random.default_rng(2)
    items = rng.integers(0, 500, 256).astype(np.int32)
    weights = np.ones(256, np.int32)
    router = tbk.HashShardRouter(S)
    b0 = tshd.init(256, S, device=CPU).bank
    for kind in ("drop", "duplicate", "corrupt", "delay"):
        tplan = tfl.FaultPlan(events=(tfl.FaultEvent(step=1, row=1,
                                                     kind=kind),))
        jplan = jfl.FaultPlan(events=(jfl.FaultEvent(step=1, row=1,
                                                     kind=kind),))
        got, deferred = tfl.faulty_update_block_fused(
            tplan, 1, b0, torch.from_numpy(items), torch.from_numpy(weights),
            router)
        want, jdeferred = jfl.faulty_update_block_fused(
            jplan, 1, jbk.init(64, S), jnp.asarray(items),
            jnp.asarray(weights), jbk.HashShardRouter(S))
        _same_state(want, got, kind)
        assert [d for d, _, _ in deferred] == [d for d, _, _ in jdeferred]
        if kind == "drop":
            w_ref = torch.from_numpy(tfl.drop_shard(items, weights, 1, S))
            healthy = tbk.update_block_fused(b0, torch.from_numpy(items),
                                             w_ref, router, 2)
            for a, b in zip(healthy, got):
                assert torch.equal(a, b)
    # the given bank is not written
    assert torch.equal(b0.ids, tshd.init(256, S, device=CPU).bank.ids)


# ---------------------------------------------------------------------------
# Sessions under faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["drop", "duplicate", "corrupt", "delay"])
@pytest.mark.parametrize("kind_kw", [dict(kind="frequency", k=96),
                                     dict(kind="quantile", k=1024, bits=8)])
def test_session_under_each_fault_kind_equals_the_reference(kind, kind_kw):
    """A session under a plan of one kind holds the reference session's
    state after every block (the replay log the intended blocks)."""
    jspec, tspec = _specs(shards=S, **kind_kw)
    events = (dict(step=2, row=1, kind=kind, delay_steps=2),
              dict(step=3, row=3, kind=kind, delay_steps=1),
              dict(step=3, row=S + 1, kind=kind))
    js, ts = _pair(jspec, tspec, replay=8,
                   fault_plan=None)
    js.fault_plan = jfl.FaultPlan(events=tuple(jfl.FaultEvent(**e)
                                               for e in events))
    ts.fault_plan = tfl.FaultPlan(events=tuple(tfl.FaultEvent(**e)
                                               for e in events))
    rng = np.random.default_rng(3)
    for b in range(5):
        blk = rng.integers(0, 200, 64)
        js.ingest(blk, np.ones(64, np.int64))
        ts.ingest(blk, np.ones(64, np.int64))
        _same_state(js.state, ts.state, f"block {b}")
        assert sorted(js._deferred) == sorted(ts._deferred)
    assert [s for s, _, _ in ts.replay_log] == [1, 2, 3, 4, 5]
    for (_, ji, jw), (_, ti, tw) in zip(js.replay_log, ts.replay_log):
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jw, tw)
    js.flush()
    ts.flush()
    _same_state(js.state, ts.state, "flushed")
    if kind == "corrupt":
        np.testing.assert_array_equal(tel.dead_shards(tspec, ts.state),
                                      jel.dead_shards(jspec, js.state))


def test_delay_defers_and_redelivers_exactly_once():
    jspec, tspec = _specs(kind="frequency", k=512, shards=S)
    plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=2, row=0, kind="delay", delay_steps=2),))
    sess = tses.StreamSession(tspec, block=64, fault_plan=plan, device=CPU)
    ref = tses.StreamSession(tspec, block=64, device=CPU)
    rng = np.random.default_rng(3)
    for _ in range(6):
        blk = rng.integers(0, 128, 64)
        sess.ingest(blk, np.ones(64, np.int64))
        ref.ingest(blk, np.ones(64, np.int64))
    probe = np.arange(128)
    assert torch.equal(sess.query_many(probe), ref.query_many(probe))


def test_end_of_stream_delay_drained_by_flush():
    _, tspec = _specs(kind="frequency", k=512, shards=S)
    plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=5, row=0, kind="delay", delay_steps=3),))
    sess = tses.StreamSession(tspec, block=64, fault_plan=plan, device=CPU)
    ref = tses.StreamSession(tspec, block=64, device=CPU)
    rng = np.random.default_rng(5)
    for _ in range(6):
        blk = rng.integers(0, 128, 64)
        sess.ingest(blk, np.ones(64, np.int64))
        ref.ingest(blk, np.ones(64, np.int64))
    assert sess._deferred
    probe = np.arange(128)
    assert torch.equal(sess.query_many(probe), ref.query_many(probe))
    assert not sess._deferred


@pytest.mark.parametrize("resume_in", ["port", "reference"])
def test_deferred_slices_survive_save_load(resume_in):
    """A schedule checkpoint taken mid-delay carries the pending slice in
    the reference's key names: a session of either package resumes it
    and redelivers it."""
    jspec, tspec = _specs(kind="frequency", k=512, shards=S)
    plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=5, row=1, kind="delay", delay_steps=4),))
    jplan = jfl.FaultPlan(events=(
        jfl.FaultEvent(step=5, row=1, kind="delay", delay_steps=4),))
    sess = tses.StreamSession(tspec, block=64, fault_plan=plan, device=CPU)
    jsess = JSession(jspec, block=64, fault_plan=jplan)
    ref = tses.StreamSession(tspec, block=64, device=CPU)
    rng = np.random.default_rng(6)
    for _ in range(6):
        blk = rng.integers(0, 128, 64)
        for s in (sess, jsess, ref):
            s.ingest(blk, np.ones(64, np.int64))
    d, jd = sess.save(include_schedule=True), jsess.save(include_schedule=True)
    assert set(d) == set(jd)
    for key in jd:
        np.testing.assert_array_equal(np.asarray(d[key]), np.asarray(jd[key]),
                                      err_msg=key)
    if resume_in == "port":
        back = tses.StreamSession(tspec, block=64, device=CPU)
        back.load(jd)
    else:
        back = JSession(jspec, block=64)
        back.load(d)
    assert back._deferred and back._seq == 6
    probe = np.arange(128)
    np.testing.assert_array_equal(np.asarray(back.query_many(probe)),
                                  ref.query_many(probe).numpy())


class _Clock:
    """A deterministic ``time.perf_counter``: each call advances 1 ms and
    a little more or less (the block times a monitor sees then vary by
    1 %, with no scheduler noise)."""

    def __init__(self):
        self.t, self.calls = 0.0, 0

    def perf_counter(self):
        self.calls += 1
        self.t += 1e-3 * (1.0 + 0.01 * (self.calls % 3))
        return self.t


def test_delay_fault_walks_the_straggler_path(monkeypatch):
    """Two sustained delays on one shard flag that shard's host, and only
    it, on the session's monitor (the port's own copy). The session's
    block times come from a deterministic clock: the wall clock of a busy
    test machine could flag every host at once."""
    import types

    monkeypatch.setattr(tses, "time", types.SimpleNamespace(
        perf_counter=_Clock().perf_counter))
    _, tspec = _specs(kind="frequency", k=512, shards=S)
    flagged = []
    mon = StragglerMonitor(
        StragglerConfig(min_steps=4, sustained=2, z_threshold=3.0),
        on_straggler=lambda h, t, z: flagged.append(h))
    plan = tfl.FaultPlan(events=(
        tfl.FaultEvent(step=10, row=1, kind="delay", delay_s=5.0),
        tfl.FaultEvent(step=11, row=1, kind="delay", delay_s=5.0)))
    sess = tses.StreamSession(tspec, block=64, fault_plan=plan, device=CPU)
    rng = np.random.default_rng(4)
    sess.ingest(rng.integers(0, 128, 64), np.ones(64, np.int64))
    sess.monitor = mon
    for _ in range(13):
        sess.ingest(rng.integers(0, 128, 64), np.ones(64, np.int64))
    assert 1 in mon.flagged
    assert all(h == 1 for h in flagged)


def test_fault_plan_needs_a_sharded_spec():
    with pytest.raises(ValueError, match="sharded"):
        tses.StreamSession(tapi.SketchSpec(k=64), block=32,
                           fault_plan=tfl.FaultPlan(), device=CPU)


# ---------------------------------------------------------------------------
# Chaos: seeded random plans; recovery reproduces the never-failed twin
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
@pytest.mark.parametrize("kind_kw", [dict(kind="frequency", k=512),
                                     dict(kind="quantile", k=2048, bits=8)])
def test_chaos_recovery_reproduces_never_failed_twin(seed, kind_kw):
    universe = 1 << 8
    n_blocks = 24
    jspec, tspec = _specs(shards=S, **kind_kw)
    plan_kw = dict(seed=seed, n_steps=n_blocks, rows=S, n_faults=6)
    sess = tses.StreamSession(tspec, block=64, replay=2 * n_blocks,
                              fault_plan=tfl.FaultPlan.random(**plan_kw),
                              device=CPU)
    jsess = JSession(jspec, block=64, replay=2 * n_blocks,
                     fault_plan=jfl.FaultPlan.random(**plan_kw))
    ref = tses.StreamSession(tspec, block=64, device=CPU)
    rng = np.random.default_rng(seed + 100)
    ckpt = sess.save(include_schedule=True)
    jckpt = jsess.save(include_schedule=True)
    for _ in range(n_blocks):
        blk = rng.integers(0, universe, 64)
        for s in (sess, jsess, ref):
            s.ingest(blk, np.ones(64, np.int64))
    _same_state(jsess.state, sess.state, "faulted")
    report = tel.recover_session(sess, ckpt, rows=range(S))
    jreport = jel.recover_session(jsess, jckpt, rows=range(S))
    assert (report.rows, report.replayed_blocks) \
        == (jreport.rows, jreport.replayed_blocks)
    assert report.replayed_blocks >= n_blocks
    for a, b in zip(_leaves(sess.state), _leaves(ref.state)):
        assert torch.equal(a, b)
    _same_state(jsess.state, sess.state, "recovered")
    want = {int(i) for i in tapi.topk(tspec, ref.state, 16)[0] if i >= 0}
    got = {int(i) for i in tapi.topk(tspec, sess.state, 16)[0] if i >= 0}
    assert want <= got


@pytest.mark.chaos
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_end_of_stream_delay_never_drops(seed):
    universe = 1 << 7
    n_blocks = 8
    jspec, tspec = _specs(kind="frequency", k=512, shards=S)
    ev = dict(step=n_blocks, row=seed % S, kind="delay", delay_steps=2 + seed)
    sess = tses.StreamSession(tspec, block=64, device=CPU,
                              fault_plan=tfl.FaultPlan(
                                  events=(tfl.FaultEvent(**ev),)))
    jsess = JSession(jspec, block=64,
                     fault_plan=jfl.FaultPlan(events=(jfl.FaultEvent(**ev),)))
    ref = tses.StreamSession(tspec, block=64, device=CPU)
    rng = np.random.default_rng(seed + 200)
    for _ in range(n_blocks):
        blk = rng.integers(0, universe, 64)
        for s in (sess, jsess, ref):
            s.ingest(blk, np.ones(64, np.int64))
    for s in (sess, jsess, ref):
        s.flush()
    for a, b in zip(_leaves(sess.state), _leaves(ref.state)):
        assert torch.equal(a, b)
    _same_state(jsess.state, sess.state)


@pytest.mark.chaos
@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_chaos_corruption_always_detected(seed):
    jspec, tspec = _specs(kind="frequency", k=512, shards=S)
    plan_kw = dict(seed=seed, n_steps=16, rows=S, n_faults=5,
                   kinds=("corrupt", "drop"))
    plan = tfl.FaultPlan.random(**plan_kw)
    sess = tses.StreamSession(tspec, block=64, fault_plan=plan, device=CPU)
    jsess = JSession(jspec, block=64,
                     fault_plan=jfl.FaultPlan.random(**plan_kw))
    rng = np.random.default_rng(seed)
    for _ in range(16):
        blk = rng.integers(0, 256, 64)
        for s in (sess, jsess):
            s.ingest(blk, np.ones(64, np.int64))
    corrupted = {e.row for e in plan.events if e.kind == "corrupt"}
    dead = tel.dead_shards(tspec, sess.state)
    assert set(np.flatnonzero(dead)) == corrupted
    np.testing.assert_array_equal(dead, jel.dead_shards(jspec, jsess.state))
    _same_state(jsess.state, sess.state)
