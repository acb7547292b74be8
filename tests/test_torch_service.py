"""The port's multi-tenant sketch service (``repro_torch.serve``) against the
reference's, on ``tests/test_sketch_service.py``'s grid.

Each test drives the reference's ``SketchService`` and the port's (on the
CPU) with the same traffic and holds every answer equal, bit for bit
(tickets, top-k and quantile subscriptions, the bank after each tick),
besides the reference test's own checks: exact counts, per-tenant window
isolation, spill and exact re-admission against a twin that never
spills, a crashed-and-resumed service against an uninterrupted twin
(checkpoints of either package), the validation errors and the block
accounting, and the family's ``double`` and ``unbiased`` tenant specs.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
from repro.serve.sketch_service import SketchService as JService
from repro.sketch import api as japi
from repro_torch.core.streams import mixed_traffic
from repro_torch.serve import QueryTicket, SketchService as TService
from repro_torch.sketch import api as tapi
from repro_torch.sketch import tenant as ttn

BITS = 8


def _fields(T=8, k_t=16, **kw):
    return dict(kind="frequency", k=T * k_t, bits=BITS, tenants=T, **kw)


def _pair(fields, **kw):
    """(reference service, port service) of one spec."""
    return (JService(japi.SketchSpec(**fields), **kw),
            TService(tapi.SketchSpec(**fields), device="cpu", **kw))


def _both(pair, fn):
    return [fn(s) for s in pair]


def _same(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _same_state(pair):
    j, t = pair
    for x, y in zip(j.session.state.bank, t.session.state.bank):
        _same(x, y.numpy(), "bank")


def test_submit_query_tick_exact_counts():
    pair = _pair(_fields(), block=64)
    for s in pair:
        s.submit(0, [1, 2, 1, 3], [5, 2, 3, 1])
        s.submit(1, [1, 9], [7, 4])
        s.submit(0, [2], [-1])          # bounded deletion, same tick
    t0 = _both(pair, lambda s: s.query(0, [1, 2, 3, 4]))
    t1 = _both(pair, lambda s: s.query(1, [1, 9]))
    _both(pair, lambda s: s.tick())
    for tickets, want in ((t0, [8, 1, 1, 0]), (t1, [7, 4])):
        for ticket in tickets:
            _same(ticket.result(), want)
    _same_state(pair)
    port = pair[1]
    assert isinstance(t0[1], QueryTicket)
    assert t0[1].resolved and t0[1].latency_s >= 0
    assert port.stats == pair[0].stats
    assert port.stats["ticks"] == 1 and port.stats["updates"] == 7


def test_ticket_result_forces_tick():
    pair = _pair(_fields(), block=64)
    _both(pair, lambda s: s.submit(3, [5, 5, 5]))
    tickets = _both(pair, lambda s: s.query(3, [5]))
    assert not tickets[1].resolved
    for ticket in tickets:
        _same(ticket.result(), [3])     # the implicit tick
    assert pair[1].stats["ticks"] == 1


def test_tenants_share_item_ids_without_crosstalk():
    pair = _pair(_fields(), block=64)
    for t in range(8):
        _both(pair, lambda s: s.submit(t, np.full(t + 1, 42)))
    _both(pair, lambda s: s.tick())
    for t in range(8):
        for s in pair:
            _same(s.query(t, [42]).result(), [t + 1])
    _same_state(pair)


def test_topk_subscription_matches_direct_topk():
    pair = _pair(_fields(), block=64)
    for s in pair:
        s.subscribe_topk(2, 3)
        s.subscribe_topk(5, 3)
    rng = np.random.default_rng(1)
    for _ in range(3):
        for t in (2, 5):
            items = rng.integers(0, 16, 20)
            _both(pair, lambda s: s.submit(t, items))
        _both(pair, lambda s: s.tick())
    port = pair[1]
    for t in (2, 5):
        items, vals = port.topk_result(t)
        ji, jv = pair[0].topk_result(t)
        _same(items, ji)
        _same(vals, jv)
        di, dv = tapi.tenant_topk(port.spec, port.session.state, t, 3)
        _same(items, di.numpy())
        _same(vals, dv.numpy())
        _same(port.topk(t, 3)[0], di.numpy())
    port.unsubscribe(2)
    assert 2 not in port._topk_subs


def test_mixed_subscription_sizes_answer_per_tenant():
    """Due subscriptions of different m take the per-tenant path."""
    pair = _pair(_fields(), block=64)
    for s in pair:
        s.subscribe_topk(1, 2)
        s.subscribe_topk(4, 5, every=2)
    rng = np.random.default_rng(7)
    for _ in range(4):
        for t in (1, 4, 6):
            items = rng.integers(0, 32, 15)
            _both(pair, lambda s: s.submit(t, items))
        _both(pair, lambda s: s.tick())
        for t in (1, 4):
            got, want = pair[1].topk_result(t), pair[0].topk_result(t)
            _same(got[0], want[0])
            _same(got[1], want[1])


def test_per_tenant_window_isolation():
    """Hot-tenant traffic does not expire a cold tenant's batches: each
    tenant expires on its own tick schedule."""
    pair = _pair(_fields(), block=64, window=2)
    _both(pair, lambda s: s.submit(1, [7, 7, 7]))   # cold: one batch
    _both(pair, lambda s: s.tick())
    for _ in range(5):                               # hot: five ticks
        _both(pair, lambda s: s.submit(0, [3, 3, 3, 3]))
        _both(pair, lambda s: s.tick())
    for s in pair:
        _same(s.query(1, [7]).result(), [3])
        _same(s.query(0, [3]).result(), [8])
    _both(pair, lambda s: s.submit(1, [7]))
    _both(pair, lambda s: s.tick())
    for s in pair:
        _same(s.query(1, [7]).result(), [4])
    _both(pair, lambda s: s.submit(1, [7]))
    _both(pair, lambda s: s.tick())                  # the first expires
    for s in pair:
        _same(s.query(1, [7]).result(), [2])
    _same_state(pair)


def test_window_drives_a_key_below_zero_in_both_packages():
    """A window over strict traffic need not be strict turnstile: tick 1
    deletes what tick 0 inserted, then tick 0's batch expires while the
    deletion is still live, so the key's windowed count goes below 0.
    Its counter is then the row's minimum, and a new item takes it over
    with the negative count: the reference's service answers both keys
    outside the Thm 4 bound 2 I / k (the theorem assumes no count below
    0), and the port answers bit for bit the same, tickets, blocks and
    bank."""
    k_t = 4
    pair = _pair(_fields(k_t=k_t), block=64, window=2)
    ticks = [([0], [10]), ([0], [-10]), ([1, 2, 3, 4], [1, 1, 1, 1])]
    for s in pair:
        s.trace_blocks = []
        for items, weights in ticks:
            s.submit(2, items, weights)
            s.tick()
    got = _both(pair, lambda s: s.query(2, [0, 1, 2, 3, 4]).result())
    # the live window: ticks 1 and 2 (tick 0's batch expired at tick 2)
    exact = np.array([-10, 1, 1, 1, 1])
    # I: every positive weight the row took (no deletion has expired yet)
    inserted = sum(int(w[w > 0].sum()) for _, w in pair[0].trace_blocks)
    assert inserted == 10 + 4
    bound = 2 * inserted / k_t
    _same(got[0], got[1])
    _same_state(pair)
    for (ji, jw), (ti, tw) in zip(*(s.trace_blocks for s in pair)):
        _same(ji, ti)
        _same(jw, tw)
    err = np.abs(got[0].astype(np.int64) - exact)
    np.testing.assert_array_equal(err > bound, [True, False, False, False,
                                                True])


@pytest.mark.parametrize("shards", [None, 2])
def test_spill_readmit_matches_never_spilled_twin(shards):
    fields = _fields(shards=shards)
    svc = _pair(fields, block=64, spill_after=2)
    twin = _pair(fields, block=64)
    every = (*svc, *twin)
    rng = np.random.default_rng(2)
    for t in range(4):
        items = rng.integers(0, 16, 30)
        for s in every:
            s.submit(t, items)
    for s in every:
        s.tick()
    for _ in range(4):                 # tenants 1-3 idle past spill_after
        for s in every:
            s.submit(0, [1, 2])
            s.tick()
    port = svc[1]
    assert port.stats["spills"] >= 1
    assert set(port._spilled) == set(svc[0]._spilled)
    assert port._spilled and 0 not in port._spilled
    for t, d in port._spilled.items():
        for key, v in d.items():
            _same(v, svc[0]._spilled[t][key], f"spill of tenant {t}: {key}")
    _same_state(svc)
    probe = np.arange(16)
    for t in range(4):
        want = twin[1].query(t, probe).result()
        for s in (*svc, twin[0]):
            _same(s.query(t, probe).result(), want)
    assert port.stats["admits"] >= 1
    for s in every:
        s.submit(2, [9, 9])
        s.tick()
    for s in every:
        _same(s.query(2, probe).result(), twin[1].query(2, probe).result())
    _same_state(svc)
    # re-admission may reorder equal counts: the top-m counts agree
    for t in range(4):
        _same(port.topk(t, 4)[1], twin[1].topk(t, 4)[1])


@pytest.mark.parametrize("resume_in", ["port", "reference"])
def test_save_load_resume_matches_uninterrupted(resume_in):
    """A service checkpointed and resumed (in either package) equals an
    uninterrupted twin."""
    fields = _fields()
    kw = dict(block=64, window=3)
    a = TService(tapi.SketchSpec(**fields), device="cpu", **kw)
    b = TService(tapi.SketchSpec(**fields), device="cpu", **kw)
    jb = JService(japi.SketchSpec(**fields), **kw)
    rng_a, rng_b, rng_j = (np.random.default_rng(3) for _ in range(3))

    def phase(svc, rng, lo, hi):
        for i in range(lo, hi):
            svc.submit(i % 5, rng.integers(0, 16, 10))
            svc.tick()

    phase(a, rng_a, 0, 4)
    phase(b, rng_b, 0, 4)
    phase(jb, rng_j, 0, 4)
    if resume_in == "port":
        c = TService(tapi.SketchSpec(**fields), device="cpu", **kw)
        c.load(jb.save())
        rng_c = rng_j
    else:
        c = JService(japi.SketchSpec(**fields), **kw)
        c.load(b.save())
        rng_c = rng_b
    assert c.tick_count == b.tick_count == 4
    phase(a, rng_a, 4, 9)
    phase(c, rng_c, 4, 9)
    probe = np.arange(16)
    for t in range(5):
        _same(a.query(t, probe).result(), c.query(t, probe).result())


def test_save_load_roundtrips_spilled_tenants():
    pair = _pair(_fields(), block=64, spill_after=1)
    _both(pair, lambda s: s.submit(3, [4, 4, 5]))
    _both(pair, lambda s: s.tick())
    for _ in range(3):
        _both(pair, lambda s: s.submit(0, [1]))
        _both(pair, lambda s: s.tick())
    assert 3 in pair[1]._spilled
    for d, svc2 in ((pair[1].save(), TService(tapi.SketchSpec(**_fields()),
                                              block=64, spill_after=1,
                                              device="cpu")),
                    (pair[1].save(), JService(japi.SketchSpec(**_fields()),
                                              block=64, spill_after=1)),
                    (pair[0].save(), TService(tapi.SketchSpec(**_fields()),
                                              block=64, spill_after=1,
                                              device="cpu"))):
        svc2.load(d)
        assert 3 in svc2._spilled
        _same(svc2.query(3, [4, 5]).result(), [2, 1])


def test_quantile_mode_subscription():
    fields = dict(kind="quantile", eps=0.02, bits=10)
    pair = _pair(fields, block=128, tenant_bits=2)
    port = pair[1]
    assert port.num_tenants == 4 and port.item_bits == 8
    rng = np.random.default_rng(4)
    data = {t: rng.integers(0, 256, 400) for t in range(4)}
    _both(pair, lambda s: s.subscribe_quantile(1, [0.5]))
    for t, vals in data.items():
        _both(pair, lambda s: s.submit(t, vals))
    _both(pair, lambda s: s.tick())
    _same(port.quantile_result(1), pair[0].quantile_result(1))
    med = float(port.quantile_result(1)[0])
    assert abs(med - np.quantile(data[1], 0.5)) <= 0.02 * 4 * 400 * 2 + 8
    direct = port.quantile(2, [0.25, 0.75])
    _same(direct, pair[0].quantile(2, [0.25, 0.75]))
    for q, g in zip((0.25, 0.75), direct):
        rank = np.searchsorted(np.sort(data[2]), g, side="right")
        assert abs(rank - q * 400) <= 2 * 0.02 * 1600 + 1
    for x, y in zip(pair[0].session.state.bank, port.session.state.bank):
        _same(x, y.numpy(), "dyadic bank")


def test_validation_errors():
    pair = _pair(_fields(T=4), block=64)
    for s in pair:
        with pytest.raises(ValueError, match="out of range"):
            s.submit(4, [1])
        with pytest.raises(ValueError, match="alias"):
            s.submit(0, [1 << BITS])
        with pytest.raises(ValueError, match="quantile"):
            s.subscribe_quantile(0, [0.5])
        with pytest.raises(ValueError, match="not resolved"):
            _ = s.query(0, [1]).latency_s
    for Service, api, kw in ((JService, japi, {}),
                             (TService, tapi, {"device": "cpu"})):
        with pytest.raises(ValueError, match="frequency-mode"):
            Service(api.SketchSpec(kind="frequency", k=8, bits=BITS),
                    block=64, **kw)
        with pytest.raises(ValueError, match="tenant_bits"):
            Service(api.SketchSpec(kind="quantile", eps=0.1, bits=10),
                    block=64, **kw)
        with pytest.raises(ValueError, match="tenant_bits"):
            Service(api.SketchSpec(kind="frequency", k=8, bits=BITS,
                                   tenants=2), block=64, tenant_bits=1, **kw)
        with pytest.raises(ValueError, match="spill"):
            Service(api.SketchSpec(kind="quantile", eps=0.1, bits=10),
                    block=64, tenant_bits=2, spill_after=1, **kw)
        with pytest.raises(ValueError, match="unsharded"):
            Service(api.SketchSpec(kind="quantile", eps=0.1, bits=10,
                                   shards=2), block=64, tenant_bits=2, **kw)
        qsvc = Service(api.SketchSpec(kind="quantile", eps=0.1, bits=10),
                       block=64, tenant_bits=2, **kw)
        with pytest.raises(ValueError, match="frequency"):
            qsvc.subscribe_topk(0, 3)
    # the family keeps every row resident: spill is refused, in both
    for Service, api, kw in ((JService, japi, {}),
                             (TService, tapi, {"device": "cpu"})):
        with pytest.raises(ValueError, match="spill"):
            Service(api.SketchSpec(**_fields(T=4, variant="double",
                                             alpha=2.0)), block=64,
                    spill_after=1, **kw)


def test_double_variant_service():
    """The double service answers as the reference's, bit for bit (both
    banks after every tick, tickets, top-k subscriptions) and exactly in
    the large-capacity regime; the unbiased service serves the same
    traffic with exact per-bank mass."""
    fields = _fields(T=4, k_t=12, variant="double", alpha=2.0)
    pair = _pair(fields, block=64)
    for s in pair:
        s.submit(1, [3, 3, 3, 3, 5])
        s.subscribe_topk(1, 2)
    _both(pair, lambda s: s.tick())
    for s in pair:
        s.submit(1, [3], [-2])
        s.submit(2, [7, 7, 9])
    _both(pair, lambda s: s.tick())
    tickets = _both(pair, lambda s: s.query(1, [3, 5]))
    for t in tickets:
        np.testing.assert_array_equal(t.result(), [2, 1])
    j, t = pair
    for side in ("ins", "dels"):
        for x, y in zip(getattr(j.session.state, side),
                        getattr(t.session.state, side)):
            _same(x, y.numpy(), side)
    for want, got in zip(j.topk_result(1), t.topk_result(1)):
        _same(want, got)
    for want, got in zip(j.topk(2, 2), t.topk(2, 2)):
        _same(want, got)
    unb = TService(tapi.SketchSpec(**_fields(T=4, k_t=12, variant="unbiased",
                                             alpha=2.0)), block=64,
                   device="cpu")
    unb.submit(1, [3, 3, 3, 3, 5])
    unb.submit(1, [3], [-2])
    unb.tick()
    np.testing.assert_array_equal(unb.query(1, [3, 5]).result(), [2, 1])
    assert int(unb.session.state.ins.counts.sum()) == 5
    assert int(unb.session.state.dels.counts.sum()) == 2


def test_service_stats_and_blocks():
    pair = _pair(_fields(), block=32)
    for s in pair:
        s.trace_blocks = []
        s.submit(0, np.arange(16) % 16)
        s.submit(7, np.arange(16) % 16)
        s.tick()
        assert s.stats["blocks"] == len(s.trace_blocks) == 1
    big = np.random.default_rng(5).integers(0, 16, 100)
    for s in pair:
        s.submit(3, big)
        s.tick()
        assert s.stats["blocks"] >= 4
        assert all(len(i) == 32 for i, _ in s.trace_blocks)
    for (ji, jw), (ti, tw) in zip(pair[0].trace_blocks, pair[1].trace_blocks):
        _same(ji, ti)
        _same(jw, tw)
    _same_state(pair)


def test_mixed_traffic_replay_matches_the_reference():
    """A day of ``mixed_traffic`` (Zipf tenant sizes, bounded deletions,
    probes) replayed as the reference's service bench replays it, with a
    window: every ticket, subscription and block and the bank agree, and
    sampled rows equal the per-row oracle over the traced blocks.
    """
    fields = _fields(T=16, k_t=8)
    ops = mixed_traffic(16, 3000, delete_ratio=0.5, query_frac=0.2,
                        burst=32, universe=1 << BITS, seed=3)
    assert any(o[0] == "query" for o in ops)
    pair = _pair(fields, block=128, window=3)
    for s in pair:
        s.trace_blocks = []
        s.subscribe_topk(0, 4)
    tickets = ([], [])
    pending = 0
    for op in ops:
        for s, got in zip(pair, tickets):
            if op[0] == "update":
                s.submit(op[1], op[2], op[3])
            else:
                got.append(s.query(op[1], op[2]))
        if op[0] == "update":
            pending += len(op[2])
            if pending >= 128:
                _both(pair, lambda s: s.tick())
                _same_state(pair)
                pending = 0
    _both(pair, lambda s: s.tick())
    assert len(tickets[1]) and all(t.resolved for t in tickets[1])
    for a, b in zip(*tickets):
        _same(a.result(), b.result())
    _same(pair[0].topk_result(0)[1], pair[1].topk_result(0)[1])
    assert pair[0].stats == pair[1].stats
    # the per-row oracle over the traced blocks, on sampled rows
    port = pair[1]
    spec = port.spec
    router = ttn.router_for(spec.tenants, spec.bits)
    fresh = tapi.make(spec, "cpu").bank
    for r in (0, 5, 15):
        row = type(fresh)(*(t[r] for t in fresh))
        for ci, cw in port.trace_blocks:
            row = ttn.reference_row_update(row, ci, cw, router, r)
        for x, y in zip(row, port.session.state.bank):
            _same(x.numpy(), y[r].numpy(), f"row {r}")
