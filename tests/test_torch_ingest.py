"""The port's ingest pipeline on the host side, and its roofline preset,
against the reference package.

The compiled-ingest cache and donation, ``BlockFeeder`` and
``ops.sketch_block_update_stream`` of ``repro_torch`` on the CPU (where
the compiled ingest is the eager update), held to ``repro``'s on the
same numpy inputs, int32, tolerance 0, on the grids of the reference's
``tests/test_platform.py:43-145`` and ``tests/test_kernels_banked.py:111``;
the roofline presets and cost model against ``repro.roofline.model``.

On the card the compiled ingest is a CUDA graph, which cannot be
captured here: what can be checked here is that the update it captures
holds no operation that synchronises the host (a capture would fail on
one), with the kernels' plain versions, which loop on the host, replaced
by stand-ins. ``tests/test_torch_cuda.py`` replays the graph on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.sketch_update.ops import \
    sketch_block_update_stream as jstream
from repro.roofline import model as jroof
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch.session import BlockFeeder as JFeeder
from repro.sketch.session import StreamSession as JSession
from repro.sketch.session import ingest_cache_spec as jses_cache_spec
from repro_torch import platform
from repro_torch.kernels.sketch_update import kernel as tkernel
from repro_torch.kernels.sketch_update import ops as tops
from repro_torch.roofline import model as troof
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import session as tsession
from repro_torch.sketch.session import BlockFeeder as TFeeder
from repro_torch.sketch.session import StreamSession as TSession
from repro_torch.sketch.state import SketchState

BITS = 12


def _leaves(state):
    return tuple(state.bank if hasattr(state, "bank") else state)


def _assert_same(want, got, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), _leaves(want),
                          _leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{msg}: {name}")


# -- platform and the roofline preset -------------------------------------

def test_platform_on_the_cpu():
    assert not platform.has_accelerator()
    # the CPU keeps donation off (the eager update returns fresh tensors)
    assert platform.donate_state_buffers() is False
    assert platform.hw_config() is troof.HW_PRESETS["cpu"]
    assert platform.hw_config("gpu_h100") is troof.HW_PRESETS["gpu_h100"]
    with pytest.raises(KeyError, match="cpu"):
        platform.hw_config("not_a_preset")


@pytest.mark.parametrize("name", ["cpu", "gpu_a100", "tpu_v5e"])
def test_reference_presets_are_copied_as_they_are(name):
    assert dataclasses.asdict(troof.hw_for(name)) == \
        dataclasses.asdict(jroof.hw_for(name))
    assert troof.hw_for(name).peak_int_ops == jroof.hw_for(name).peak_int_ops


def test_h100_preset():
    hw = troof.hw_for("gpu_h100")
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == \
        (989.4e12, 3.35e12, 900e9, 80e9)
    # 64 int32 lanes per SM per clock x 132 SMs x 1.98 GHz
    assert hw.int_flops == pytest.approx(64 * 132 * 1.98e9)
    assert hw.peak_int_ops == hw.int_flops
    for preset in troof.HW_PRESETS.values():
        assert preset.peak_flops > 0 and preset.hbm_bw > 0
        assert preset.peak_int_ops > 0
    with pytest.raises(KeyError, match="gpu_h100"):
        troof.hw_for("h100")


@pytest.mark.parametrize("kw", [
    dict(num_rows=4, k=200, block=512),
    dict(num_rows=4, k=256, block=512),
    dict(num_rows=4, k=200, block=512, residual_trips=7),
    dict(num_rows=128, k=3125, block=65536, residual_trips=1.5),
    dict(num_rows=1, k=2000, block=65536, lanes=64, dtype_bytes=8),
])
def test_sketch_ingest_cost_matches_reference(kw):
    assert troof.sketch_ingest_cost(**kw) == jroof.sketch_ingest_cost(**kw)


@pytest.mark.parametrize("preset", ["cpu", "gpu_a100", "tpu_v5e"])
@pytest.mark.parametrize("wall_s", [1e-3, 2.5e-6, 0.0])
def test_sketch_roofline_matches_reference(preset, wall_s):
    cost = troof.sketch_ingest_cost(num_rows=1, k=4096, block=4096)
    got = troof.sketch_roofline(cost, wall_s, troof.hw_for(preset))
    assert got == jroof.sketch_roofline(cost, wall_s, jroof.hw_for(preset))


def test_sketch_roofline_columns():
    """``test_platform.py:100``, against the port's default (H100)."""
    cost = troof.sketch_ingest_cost(num_rows=1, k=4096, block=4096)
    roof = troof.sketch_roofline(cost, wall_s=1e-3)
    for col in ("achieved_bytes_per_s", "peak_fraction", "arith_intensity",
                "bound_s", "bound"):
        assert col in roof, col
    assert roof["achieved_bytes_per_s"] == pytest.approx(cost["bytes"] / 1e-3)
    assert roof["peak_fraction"] == pytest.approx(
        cost["bytes"] / 1e-3 / 3.35e12)
    assert 0 < roof["arith_intensity"] < 10
    assert roof["bound"] in ("memory", "compute")


# -- the compiled-ingest cache and donation -------------------------------

def test_donation_flag_does_not_change_results():
    """``test_platform.py:47``; the donate flag is part of the cache key."""
    jspec = japi.SketchSpec(k=64, backend="kernel")
    tspec = tapi.SketchSpec(k=64, backend="kernel")
    rng = np.random.default_rng(0)
    items = rng.integers(0, 1000, 256).astype(np.int32)
    got = []
    for donate in (True, False):
        s = TSession(tspec, block=128, donate=donate, device="cpu")
        s.ingest(items, np.ones(256, np.int32))
        got.append(s.query_many(items[:32]).numpy())
    js = JSession(jspec, block=128)
    js.ingest(items, np.ones(256, np.int32))
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], np.asarray(
        js.query_many(jnp.asarray(items[:32]))))
    assert tsession._ingest_fn(tspec, 128, True) is not \
        tsession._ingest_fn(tspec, 128, False)
    # on the CPU the compiled ingest never donates
    assert not tsession._ingest_fn(tspec, 128, True).donate


def test_ingest_cache_is_keyed_by_spec_block_and_donate():
    spec = tapi.SketchSpec(k=77, shards=3, bits=BITS)
    before = tsession.ingest_cache_stats()
    a = tsession._ingest_fn(spec, 96)
    assert tsession._ingest_fn(spec, 96) is a
    assert tsession._ingest_fn(dataclasses.replace(spec), 96.0) is a
    assert tsession._ingest_fn(spec, 97) is not a
    assert tsession._ingest_fn(
        dataclasses.replace(spec, backend="block"), 96) is not a
    after = tsession.ingest_cache_stats()
    assert after["entries"] - before["entries"] == 3
    assert after["hits"] - before["hits"] == 2
    assert tsession.ingest_cache_spec(spec) is spec


@pytest.mark.parametrize("shards", [None, 2])
def test_tenant_specs_share_a_cache_cell_and_run_as_the_reference(shards):
    """Tenant specs normalise onto one ``tenants=1`` cell, as the
    reference's do (its ``ingest_cache_spec``); the cell's ingest of a
    tenant state is the eager update and equals the reference's."""
    fields = dict(k=64, bits=BITS - 2, shards=shards)
    specs = [tapi.SketchSpec(tenants=3, **fields),
             tapi.SketchSpec(tenants=4, **fields)]
    norm = tsession.ingest_cache_spec(specs[0])
    assert norm == tsession.ingest_cache_spec(specs[1])
    assert (norm.tenants, norm.tenant_caps, norm.k) == (1, None, 64)
    jnorm = jses_cache_spec(japi.SketchSpec(tenants=3, **fields))
    assert (jnorm.tenants, jnorm.k, jnorm.shards) == (1, 64, shards)
    assert tsession._ingest_fn(specs[0], 256) is \
        tsession._ingest_fn(specs[1], 256)
    rng = np.random.default_rng(6)
    items = rng.integers(0, 3 << (BITS - 2), 256).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], 256).astype(np.int32)
    for spec in specs:
        got = tsession._ingest_fn(spec, 256)(tapi.make(spec, "cpu"), items,
                                             weights)
        want = tapi.adapter_for(spec).update(
            spec, tapi.make(spec, "cpu"), torch.from_numpy(items),
            torch.from_numpy(weights))
        _assert_same(want, got)
        jspec = japi.SketchSpec(tenants=spec.tenants, **fields)
        _assert_same(japi.update(jspec, japi.make(jspec), jnp.asarray(items),
                                 jnp.asarray(weights)), got)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("backend", ["kernel", "block", "bank"])
def test_compiled_ingest_on_the_cpu_is_the_eager_update(shards, backend):
    _compiled_ingest_is_the_eager_update(
        tapi.SketchSpec(k=96, shards=shards, bits=BITS, backend=backend))


QUANTILE_LAYOUTS = [(None, "kernel"), (None, "bank"), (None, "block"),
                    (3, "bank")]


@pytest.mark.parametrize("shards,backend", QUANTILE_LAYOUTS)
def test_compiled_quantile_ingest_on_the_cpu_is_the_eager_update(shards,
                                                                 backend):
    _compiled_ingest_is_the_eager_update(
        tapi.SketchSpec(kind="quantile", k=96, shards=shards, bits=BITS,
                        backend=backend))


def _compiled_ingest_is_the_eager_update(spec):
    rng = np.random.default_rng(1)
    items = rng.integers(0, 1 << BITS, 256).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], 256).astype(np.int32)
    state = tapi.make(spec, "cpu")
    want = tapi.adapter_for(spec).update(
        spec, state, torch.from_numpy(items), torch.from_numpy(weights))
    got = tsession._ingest_fn(spec, 256)(state, items, weights)
    _assert_same(want, got)
    if spec.kind == "quantile":
        assert int(got.mass) == int(want.mass) == int(weights.sum())
        # the state's leaves, the 0-d mass last, rebuild the state
        leaves = tsession._leaves(got)
        assert len(leaves) == 4 and leaves[3].shape == ()
        back = tsession._like(got, leaves)
        assert type(back) is type(got) and back.mass is got.mass
    with pytest.raises(ValueError, match="blocks of 256"):
        tsession._ingest_fn(spec, 256)(state, items[:10], weights)


# -- what the CUDA graph captures holds no host synchronisation ----------

_SYNCING = {"_local_scalar_dense", "nonzero", "lift_fresh", "is_nonzero",
            "item", "equal", "unique", "_unique2", "masked_select",
            "repeat_interleave"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def _kernel_stand_in(*args, variant):
    # what the CUDA kernel does to the host: nothing (it runs in place)
    return tuple(t.clone() for t in args[:3])


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("backend", ["kernel", "block", "bank"])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_captured_update_holds_no_host_synchronisation(monkeypatch, shards,
                                                       backend, variant):
    """Every aten op of ``adapter.update`` outside the kernels: none reads
    a value back to the host or copies host data to the device, so the
    CUDA graph capture of the update can succeed. (``sat_add`` with a
    Python number once made a tensor of it: a host-to-device copy.) On
    ``"bank"``: the partition core's prep with the hash router's one-hot
    ranks (its monotone branch: the test below)."""
    monkeypatch.setattr(tops, "fused_update_ref", _kernel_stand_in)
    monkeypatch.setattr(tops, "residual_phase", _kernel_stand_in)
    spec = tapi.SketchSpec(k=96, shards=shards, bits=BITS, variant=variant,
                           backend=backend)
    _audit_update(spec)


@pytest.mark.parametrize("shards,backend", QUANTILE_LAYOUTS)
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_captured_quantile_update_holds_no_host_synchronisation(
        monkeypatch, shards, backend, variant):
    """The quantile adapters' update, the mass included: kernel 1, the
    dense core (kernel 2) and the stacked layers (kernel 3)."""
    monkeypatch.setattr(tops, "fused_update_ref", _kernel_stand_in)
    monkeypatch.setattr(tops, "residual_phase", _kernel_stand_in)
    monkeypatch.setattr(tops, "residual_phase_banked", _kernel_stand_in)
    _audit_update(tapi.SketchSpec(
        kind="quantile", k=96, shards=shards, bits=BITS, variant=variant,
        backend=backend))


@pytest.mark.parametrize("router", [tbk.TenantRouter(4, BITS - 2),
                                    tbk.TenantRouter(2, BITS - 1, 3)])
def test_partition_core_holds_no_host_synchronisation(monkeypatch, router):
    """The partition core under a ``TenantRouter``: one row per tenant
    (the monotone branch, ranks by prefix-sum differences) and per-tenant
    shards (the one-hot branch)."""
    monkeypatch.setattr(tops, "fused_update_ref", _kernel_stand_in)
    rng = np.random.default_rng(4)
    items = torch.from_numpy(rng.integers(0, 1 << BITS, 256).astype(np.int32))
    weights = torch.from_numpy(rng.choice([-1, 1, 2], 256).astype(np.int32))
    bank = tbk.init(24, router.num_rows, device="cpu")
    with _Ops() as ops:
        tbk.update_block_fused(bank, items, weights, router, 2)
    assert ops.names and not set(ops.names) & _SYNCING, \
        sorted(set(ops.names) & _SYNCING)


@pytest.mark.parametrize("shards", [None, 2])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_captured_tenant_update_holds_no_host_synchronisation(
        monkeypatch, shards, variant):
    """The tenant adapter's update as the compiled ingest captures it:
    the cell's normalised spec (``tenants=1``) on a 4-tenant state, the
    tenant count read from the state's shape."""
    monkeypatch.setattr(tops, "fused_update_ref", _kernel_stand_in)
    spec = tapi.SketchSpec(k=96, bits=BITS - 2, tenants=4, shards=shards,
                           variant=variant)
    _audit_update(tsession.ingest_cache_spec(spec), tapi.make(spec, "cpu"))


def _audit_update(spec, state=None):
    rng = np.random.default_rng(2)
    items = torch.from_numpy(rng.integers(0, 1 << BITS, 256).astype(np.int32))
    weights = torch.from_numpy(rng.choice([-1, 1, 2], 256).astype(np.int32))
    state = tapi.make(spec, "cpu") if state is None else state
    with _Ops() as ops:
        tapi.adapter_for(spec).update(spec, state, items, weights)
    assert ops.names and not set(ops.names) & _SYNCING, \
        sorted(set(ops.names) & _SYNCING)
    # the audit sees a synchronising op where there is one
    with _Ops() as ops:
        bool(items.any())
        torch.as_tensor(1, dtype=torch.int32)
    assert {"_local_scalar_dense", "lift_fresh"} <= set(ops.names)


# -- launch counts of a replay --------------------------------------------

def test_launch_delta_and_add_counts():
    before = {"a": {"staged": 3, "unstaged": 0}, "b": 5, "c": {"x": 1}}
    after = {"a": {"staged": 4, "unstaged": 0}, "b": 7, "c": {"x": 1}}
    delta = tkernel.launch_delta(before, after)
    assert delta == {"a": {"staged": 1}, "b": 2}
    assert tkernel.add_counts(before, delta) == after
    assert before["a"]["staged"] == 3          # inputs are not changed
    assert tkernel.launch_delta(after, after) == {}


def test_set_launch_counts_restores_a_snapshot():
    snap = tkernel.launch_counts()
    try:
        tkernel.sketch_update_kernel_fused.launches["staged"] += 5
        tkernel.sketch_update_kernel_serial.launches += 2
        delta = tkernel.launch_delta(snap, tkernel.launch_counts())
        assert delta == {"sketch_update_kernel_fused": {"staged": 5},
                         "sketch_update_kernel_serial": 2}
    finally:
        tkernel.set_launch_counts(snap)
    assert tkernel.launch_counts() == snap


# -- BlockFeeder (test_platform.py:114-145) ------------------------------

def _blocks(n_blocks, block, seed=5):
    rng = np.random.default_rng(seed)
    items = rng.integers(0, 4096, (n_blocks, block)).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], (n_blocks, block)).astype(np.int32)
    return items, weights


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("shards", [None, 4])
def test_block_feeder_bit_identical(depth, shards):
    """Feeding is sequential ``ingest_block``, in the port and against the
    reference's feeder."""
    tspec = tapi.SketchSpec(k=128, shards=shards, backend="kernel")
    jspec = japi.SketchSpec(k=128, shards=shards, backend="kernel")
    items, weights = _blocks(5, 256)
    seq = TSession(tspec, block=256, device="cpu")
    for i in range(5):
        seq.ingest_block(items[i], weights[i])
    fed = TSession(tspec, block=256, device="cpu")
    feeder = TFeeder(fed, depth=depth)
    jfeeder = JFeeder(JSession(jspec, block=256), depth=depth)
    for i in range(5):
        feeder.feed(items[i], weights[i])
        jfeeder.feed(items[i], weights[i])
    state = feeder.flush()
    _assert_same(seq.state, state)
    _assert_same(jfeeder.flush(), state)
    assert fed.blocks_ingested == 5


def test_block_feeder_flush_idempotent():
    spec = tapi.SketchSpec(k=64)
    feeder = TFeeder(TSession(spec, block=128, device="cpu"))
    items, weights = _blocks(1, 128)
    feeder.feed(items[0], weights[0])
    s1 = feeder.flush()
    s2 = feeder.flush()  # nothing staged: no double ingest
    _assert_same(s1, s2)
    assert feeder.session.blocks_ingested == 1


def test_block_feeder_does_not_alias_the_callers_arrays():
    spec = tapi.SketchSpec(k=64)
    items, weights = _blocks(2, 128)
    seq = TSession(spec, block=128, device="cpu")
    for i in range(2):
        seq.ingest_block(items[i], weights[i])
    feeder = TFeeder(TSession(spec, block=128, device="cpu"))
    buf_i, buf_w = items[0].copy(), weights[0].copy()
    feeder.feed(buf_i, buf_w)
    buf_i[:], buf_w[:] = items[1], weights[1]   # the caller reuses its buffer
    feeder.feed(buf_i, buf_w)
    _assert_same(seq.state, feeder.flush())


# -- sketch_block_update_stream (test_kernels_banked.py:111) --------------

@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("R,K", [(4, 200), (1, 200), (3, 128)])
def test_stream_entry_matches_sequential(variant, R, K):
    """The multi-block stream == folding ``sketch_block_update_fused``
    over the routed blocks, and == the reference's scanned stream (Pallas
    in interpret mode). The dyadic layout: the test below."""
    rng = np.random.default_rng(11)
    nb, n = 3, 256
    items = rng.integers(0, 1 << 16, (nb, n)).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], (nb, n)).astype(np.int32)
    router = tbk.HashShardRouter(R, 16)
    bank = tbk.init(K, R, device="cpu")
    seq = bank
    for b in range(nb):
        seq = tops.sketch_block_update_fused(
            seq, *router.route_dense(torch.from_numpy(items[b]),
                                     torch.from_numpy(weights[b])), variant)
    got = tops.sketch_block_update_stream(
        bank, torch.from_numpy(items), torch.from_numpy(weights), router,
        variant)
    _assert_same(seq, got, "fold")
    want = jstream(jbk.init([K] * R), jnp.asarray(items), jnp.asarray(weights),
                   jbk.HashShardRouter(R, 16), variant, True)
    _assert_same(want, got, "reference")
    assert torch.equal(bank.ids, torch.full((R, K), -1, dtype=torch.int32))


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("bits,per_layer", [(8, 40), (10, 300)])
def test_stream_entry_dyadic_matches_sequential(variant, bits, per_layer):
    """``test_kernels_banked.py:111``'s dyadic case: a per-row-capacity
    bank (BLOCKED tails) and the router's (1, B) weight row, against the
    fold of ``bank.update_block_fused`` and the reference's stream."""
    from repro_torch.core.quantiles import dyadic_layer_capacities

    rng = np.random.default_rng(11 + bits)
    nb, n = 3, 256
    items = rng.integers(0, 1 << bits, (nb, n)).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], (nb, n)).astype(np.int32)
    caps = dyadic_layer_capacities(bits, total_counters=bits * per_layer)
    router = tbk.DyadicLevelRouter(bits)
    bank = tbk.init(caps, device="cpu")
    seq = bank
    for b in range(nb):
        seq = tbk.update_block_fused(seq, torch.from_numpy(items[b]),
                                     torch.from_numpy(weights[b]), router,
                                     variant)
    got = tops.sketch_block_update_stream(
        bank, torch.from_numpy(items), torch.from_numpy(weights), router,
        variant)
    _assert_same(seq, got, "fold")
    want = jstream(jbk.init(caps), jnp.asarray(items), jnp.asarray(weights),
                   jbk.DyadicLevelRouter(bits), variant, True)
    _assert_same(want, got, "reference")
    assert tbk.row_capacities(got) == caps


@pytest.mark.parametrize("router", ["hash", "tenant"])
def test_update_block_fused_takes_a_partition_router(router):
    """The partition core (it raised until it was ported): a
    ``HashShardRouter`` and a monotone ``TenantRouter``, bit for bit
    against the reference's ``update_block_fused``, and the stream entry
    of the same blocks equal to the fold."""
    rng = np.random.default_rng(3)
    routers = ((tbk.HashShardRouter(3, 10), jbk.HashShardRouter(3, 10))
               if router == "hash" else
               (tbk.TenantRouter(3, 8), jbk.TenantRouter(3, 8)))
    items = rng.integers(0, 3 << 8, (3, 200)).astype(np.int32)
    weights = rng.choice([-1, 1, 1, 2], (3, 200)).astype(np.int32)
    bank, jb = tbk.init(40, 3, device="cpu"), jbk.init(40, 3)
    seq = bank
    for it, w in zip(items, weights):
        seq = tbk.update_block_fused(seq, torch.from_numpy(it),
                                     torch.from_numpy(w), routers[0], 2)
        jb = jbk.update_block_fused(jb, jnp.asarray(it), jnp.asarray(w),
                                    routers[1], 2)
        _assert_same(jb, seq, "reference")
    got = tops.sketch_block_update_stream(bank, torch.from_numpy(items),
                                          torch.from_numpy(weights),
                                          routers[0], 2)
    _assert_same(seq, got, "stream")


def test_stream_entry_of_no_blocks_is_the_bank():
    bank = tbk.init(50, 2, device="cpu")
    empty = torch.zeros((0, 64), dtype=torch.int32)
    got = tops.sketch_block_update_stream(bank, empty, empty,
                                          tbk.HashShardRouter(2), 2)
    _assert_same(bank, got)
    assert isinstance(got, SketchState)


# -- the ingest's host validation -----------------------------------------

@pytest.mark.parametrize("item_dtype", [np.int32, np.int64, np.uint32,
                                        np.uint64, np.int16])
@pytest.mark.parametrize("weight_dtype", [np.int32, np.int64, np.int8])
def test_validate_block_returns_and_raises_as_the_reference(item_dtype,
                                                            weight_dtype):
    """``api.validate_block`` (one pass per check) against the reference's
    on random blocks of every size up to 6: the same positive mass, or
    the same error, with and without a prior mass near the rail."""
    rng = np.random.default_rng(np.dtype(item_dtype).num * 100
                                + np.dtype(weight_dtype).num)
    jspec, tspec = japi.SketchSpec(k=64), tapi.SketchSpec(k=64)
    i_info, w_info = np.iinfo(item_dtype), np.iinfo(weight_dtype)
    for trial in range(60):
        n = int(rng.integers(0, 7))
        wide = rng.random() < 0.5
        items = rng.integers(max(i_info.min, -5) if wide else 0,
                             min(i_info.max, 2**40) if wide else 50,
                             n).astype(item_dtype)
        weights = (rng.integers(max(w_info.min, -2**31 - 5),
                                min(w_info.max, 2**31 + 5), n)
                   if rng.random() < 0.3 else
                   rng.integers(-2, 3, n)).astype(weight_dtype)
        for prior in (0, 2**31 - 10):
            got = []
            for api, spec in ((japi, jspec), (tapi, tspec)):
                try:
                    got.append(api.validate_block(spec, items, weights,
                                                  prior_mass=prior))
                except ValueError as e:
                    got.append(str(e).split(";")[0].split(":")[0])
            assert got[0] == got[1], (items, weights, prior, got)
