"""The port's block backend and split/serial kernels' plain versions
against the reference package.

Each case makes its inputs with a numpy seed and hands the same arrays
to ``repro`` (JAX; the Pallas kernels in interpret mode) and
``repro_torch`` (torch on the CPU, where ``ops.py`` runs each kernel's
plain version). The sketch state is int32, so equality is exact:
``pad_rows``, ``select_insert_slot``, ``residual_phase``,
``blocks.block_update`` and ``block_update_batched`` (sorted and
unsorted), the ``ops`` entry points of the split, banked and serial
kernels on cold, warm, near-rail and empty sketches and all-padding
blocks, and ``StreamSession(backend="block")`` for shards None and 4.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro.kernels.sketch_update import ops as jops
from repro.sketch import api as japi
from repro.sketch import bank as jbk
from repro.sketch import blocks as jbl
from repro.sketch import phases as jph
from repro.sketch import sharded as jshd
from repro.sketch import state as jst
from repro.sketch.session import StreamSession as JSession
from repro_torch.kernels import _build
from repro_torch.kernels.sketch_update import kernel as tkernel
from repro_torch.kernels.sketch_update import ops as tops
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import blocks as tbl
from repro_torch.sketch import phases as tph
from repro_torch.sketch import sharded as tshd
from repro_torch.sketch import state as tst
from repro_torch.sketch.session import StreamSession as TSession

IMAX = 2**31 - 1
UNIVERSE = 600
VARIANTS = (1, 2)
# the reference's phase functions are not jitted themselves; jit them once
_jphase1 = jax.jit(jbl._phase1, static_argnums=3)
_jresidual = jax.jit(jph.residual_phase, static_argnums=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_torch(state):
    return tst.SketchState(*(_t(x) for x in state))


def _eq(want, got, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _block(rng, n=256, signed=True, universe=UNIVERSE):
    items = rng.integers(0, universe, n).astype(np.int32)
    choices = [-2, -1, 1, 1, 1, 3] if signed else [1, 1, 2]
    return items, rng.choice(choices, n).astype(np.int32)


def _sketch(rng, k, state, variant=2):
    """A (k,) reference sketch: "empty", "cold" (one block in), "warm"
    (full, after three blocks over 3k ids), "rail+"/"rail-" (warm, live
    counts lifted next to +-INT_MAX)."""
    js = jst.init(k)
    n_blocks = {"empty": 0, "cold": 1}.get(state, 3)
    for b in range(n_blocks):
        items, w = _block(rng, n=1024, signed=b > 0, universe=3 * k)
        js = jbl.block_update(js, jnp.asarray(items), jnp.asarray(w), variant)
    if state in ("rail+", "rail-"):
        sign = 1 if state == "rail+" else -1
        lift = jnp.asarray(sign * (IMAX - 8 - rng.integers(0, 4, k)), jnp.int32)
        js = jst.SketchState(js.ids, jnp.where(
            js.ids >= 0, jst.sat_add(js.counts, lift), js.counts), js.errors)
    return js


# ---------------------------------------------------------------------------
# phases: the (E, R, LANES) row view and phase 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [77, 200, 1000])
def test_pad_rows_and_select_insert_slot_match_reference(k):
    rng = np.random.default_rng(k)
    for state in ("empty", "cold", "warm"):
        js = _sketch(rng, k, state)
        ts = _to_torch(js)
        got = tph.pad_rows(*(t[None] for t in ts))
        _eq(jph.pad_rows(*js), (t[0] for t in got), f"pad_rows {state}")
        assert got[0].data_ptr() != ts.ids.data_ptr()
        want = jph.select_insert_slot(js.ids, js.counts)
        slot, mc, he = tph.select_insert_slot(ts.ids[None], ts.counts[None])
        assert (int(want[0]), int(want[1]), bool(want[2])) == \
            (int(slot[0]), int(mc[0]), bool(he[0])), state


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k", [77, 200, 1000])
def test_residual_phase_matches_reference_batched(variant, k):
    """Phase 2 of three stacked sketches in lockstep equals three
    reference calls, on the inputs the reference's phase 1 makes."""
    rng = np.random.default_rng(10 * k + variant)
    t_in, want = [], []
    for state in ("cold", "warm", "rail+"):
        js = _sketch(rng, k, state, variant)
        items, w = _block(rng)
        ph = _jphase1(js, jnp.asarray(items), jnp.asarray(w), variant)
        rows = jph.pad_rows(*ph[:3])
        want.append(_jresidual(*rows, *ph[3:], variant))
        t_in.append(rows + tuple(ph[3:]))
    stacked = [_t(np.stack([np.asarray(x[i]) for x in t_in]))
               for i in range(8)]
    got = tph.residual_phase(*stacked, variant)
    for e, w_e in enumerate(want):
        _eq(w_e, (t[e] for t in got), f"sketch {e}")
    # the plain version leaves its inputs alone
    assert torch.equal(stacked[0], _t(np.stack([np.asarray(x[0])
                                                for x in t_in])))


# ---------------------------------------------------------------------------
# blocks: the block backend's update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("k", [77, 200, 1000])
@pytest.mark.parametrize("sort", [False, True])
def test_block_update_matches_reference(variant, k, sort):
    rng = np.random.default_rng(100 * k + 10 * variant + sort)
    js = jst.init(k)
    ts = tst.init(k, device="cpu")
    for b in range(4):
        items, w = _block(rng, n=512, signed=b > 0)
        if sort:
            order = np.argsort(items, kind="stable")
            items, w = items[order], w[order]
        js = jbl.block_update(js, jnp.asarray(items), jnp.asarray(w), variant,
                              assume_sorted=sort)
        ts = tbl.block_update(ts, _t(items), _t(w), variant,
                              assume_sorted=sort)
        _eq(js, ts, f"block {b}")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("sort", [False, True])
def test_block_update_batched_matches_reference(variant, sort):
    rng = np.random.default_rng(7 + variant + 2 * sort)
    E, k = 4, 200
    js = jst.SketchState(*(jnp.stack([x] * E) for x in jst.init(k)))
    ts = _to_torch(js)
    for b in range(3):
        items, w = zip(*(_block(rng, signed=b > 0) for _ in range(E)))
        items, w = np.stack(items), np.stack(w)
        if sort:
            order = np.argsort(items, axis=1, kind="stable")
            items = np.take_along_axis(items, order, 1)
            w = np.take_along_axis(w, order, 1)
        js = jbl.block_update_batched(js, jnp.asarray(items), jnp.asarray(w),
                                      variant, assume_sorted=sort)
        ts = tbl.block_update_batched(ts, _t(items), _t(w), variant,
                                      assume_sorted=sort)
        _eq(js, ts, f"block {b}")


# ---------------------------------------------------------------------------
# ops: the split, banked and serial entry points against the Pallas kernels
# ---------------------------------------------------------------------------

STATES = ["empty", "cold", "warm", "rail+", "rail-"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("state", STATES + ["padding"])
def test_ops_block_update_matches_pallas_kernel(variant, state):
    rng = np.random.default_rng(STATES.index(state.replace("padding", "warm"))
                                + 10 * variant)
    k = 200
    js = _sketch(rng, k, state.replace("padding", "warm"), variant)
    items, w = _block(rng)
    if state == "padding":
        w = np.zeros_like(w)
    want = jops.sketch_block_update(js, jnp.asarray(items), jnp.asarray(w),
                                    variant, True)
    got = tops.sketch_block_update(_to_torch(js), _t(items), _t(w), variant)
    _eq(want, got, state)
    if state == "padding":
        _eq(js, got, "an all-padding block changed the sketch")


@pytest.mark.parametrize("variant", VARIANTS)
def test_ops_block_update_batched_matches_pallas_kernel(variant):
    rng = np.random.default_rng(20 + variant)
    k = 77
    sk = [_sketch(rng, k, s, variant) for s in ("empty", "warm", "rail+")]
    js = jst.SketchState(*(jnp.stack(x) for x in zip(*sk)))
    items, w = zip(*(_block(rng) for _ in sk))
    items, w = np.stack(items), np.stack(w)
    want = jops.sketch_block_update_batched(js, jnp.asarray(items),
                                            jnp.asarray(w), variant, True)
    got = tops.sketch_block_update_batched(_to_torch(js), _t(items), _t(w),
                                           variant)
    _eq(want, got, "batched")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("state", ["cold", "warm", "rail+", "padding"])
def test_ops_banked_matches_pallas_kernel(variant, S, state):
    rng = np.random.default_rng(30 + 10 * variant + S)
    k = 200
    jb = jbk.init([k] * S)
    router_j = jbk.HashShardRouter(S, 16)
    router_t = tbk.HashShardRouter(S, 16)
    for b in range({"cold": 0}.get(state, 3)):
        items, w = _block(rng, n=4 * k, signed=b > 0)
        jb = jbk.update_rows(jb, *router_j.route_dense(jnp.asarray(items),
                                                       jnp.asarray(w)),
                             variant)
    if state == "rail+":
        lift = jnp.asarray(IMAX - 8 - rng.integers(0, 4, (S, k)), jnp.int32)
        jb = jst.SketchState(jb.ids, jnp.where(
            jb.ids >= 0, jst.sat_add(jb.counts, lift), jb.counts), jb.errors)
    items, w = _block(rng, n=512)
    if state == "padding":
        w = np.zeros_like(w)
    want = jops.sketch_block_update_banked(
        jb, *router_j.route_dense(jnp.asarray(items), jnp.asarray(w)),
        variant, True)
    tb = _to_torch(jb)
    got = tops.sketch_block_update_banked(
        tb, *router_t.route_dense(_t(items), _t(w)), variant)
    _eq(want, got, state)
    # the banked split path equals the fused path, bit for bit
    fused = tops.sketch_block_update_fused(
        tb, *router_t.route_dense(_t(items), _t(w)), variant)
    for a, b in zip(got, fused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("state", STATES + ["padding"])
def test_ops_serial_matches_pallas_kernel(variant, state):
    rng = np.random.default_rng(40 + STATES.index(
        state.replace("padding", "warm")) + 10 * variant)
    k = 200
    js = _sketch(rng, k, state.replace("padding", "warm"), variant)
    items, w = _block(rng, n=192)
    w[::7] = 0                                   # padding inside the block
    if state == "padding":
        w = np.zeros_like(w)
    want = jops.sketch_block_update_serial(js, jnp.asarray(items),
                                           jnp.asarray(w), variant, True)
    got = tops.sketch_block_update_serial(_to_torch(js), _t(items), _t(w),
                                          variant)
    _eq(want, got, state)


def test_kernel_wrappers_refuse_cpu_tensors_and_ops_take_the_plain_versions():
    ts = tst.init(200, device="cpu")
    z = torch.zeros((1,), dtype=torch.int32)
    rows = tph.pad_rows(*(t[None] for t in ts))
    blk = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.sketch_residual_kernel(*rows, blk, blk, z, z, z)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.sketch_residual_kernel_banked(*(t[0] for t in rows), blk[0],
                                              blk[0], z, z, z, z)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.sketch_update_kernel_serial(*(t[0] for t in rows), blk[0],
                                            blk[0])
    counts = (dict(tkernel.sketch_residual_kernel.launches),
              dict(tkernel.sketch_residual_kernel_banked.launches),
              tkernel.sketch_update_kernel_serial.launches)
    items = torch.arange(8, dtype=torch.int32)
    ones = torch.ones(8, dtype=torch.int32)
    out = tops.sketch_block_update(ts, items, ones)
    tops.sketch_block_update_serial(ts, items, ones)
    tops.sketch_block_update_banked(
        tst.SketchState(*(t[None] for t in ts)), items[None], ones[None])
    assert counts == (tkernel.sketch_residual_kernel.launches,
                      tkernel.sketch_residual_kernel_banked.launches,
                      tkernel.sketch_update_kernel_serial.launches)
    assert torch.equal(ts.ids, tst.init(200, device="cpu").ids)
    assert sorted(out.ids[:8].tolist()) == list(range(8))


# ---------------------------------------------------------------------------
# the block backend end to end
# ---------------------------------------------------------------------------

def _stream(seed):
    rng = np.random.default_rng(seed)
    items = rng.zipf(1.3, 4000) % (1 << 12)
    signs = np.where(rng.random(4000) < 0.3, -1, 1)
    # a deletion only after its item was inserted (the strict turnstile)
    seen = np.zeros(1 << 12, np.int64)
    for i, (x, s) in enumerate(zip(items, signs)):
        if s < 0 and seen[x] == 0:
            signs[i] = 1
        seen[x] += signs[i]
    return items.astype(np.int32), signs.astype(np.int32)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_block_backend_session_matches_reference(shards, variant):
    items, signs = _stream(1 if shards else 2)
    jspec = japi.SketchSpec(k=96, variant=variant, shards=shards, bits=12,
                            backend="block")
    tspec = tapi.SketchSpec(k=96, variant=variant, shards=shards, bits=12,
                            backend="block")
    js = JSession(jspec, block=256)
    ts = TSession(tspec, block=256, device="cpu")
    for lo in range(0, len(items), 700):
        js.extend(items[lo:lo + 700], signs[lo:lo + 700])
        ts.extend(items[lo:lo + 700], signs[lo:lo + 700])
    js.flush()
    ts.flush()
    jd, td = japi.save(jspec, js.state), tapi.save(tspec, ts.state)
    for key in ("ids", "counts", "errors"):
        np.testing.assert_array_equal(np.asarray(jd[key]), td[key], key)
    probe = np.arange(1 << 12)
    np.testing.assert_array_equal(np.asarray(js.query_many(probe)),
                                  ts.query_many(probe).numpy())
    # a state saved under one backend restores and runs under the other
    kspec = tapi.SketchSpec(k=96, variant=variant, shards=shards, bits=12,
                            backend="kernel")
    other = TSession(kspec, block=256, device="cpu",
                     state=tapi.restore(kspec, td, device="cpu"))
    other.ingest(items[:512], signs[:512])
    ts.ingest(items[:512], signs[:512])
    for key, a in tapi.save(kspec, other.state).items():
        np.testing.assert_array_equal(a, tapi.save(tspec, ts.state)[key])


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_block_and_kernel_backends_agree(shards, variant):
    items, signs = _stream(3)
    states = []
    for backend in ("block", "kernel"):
        spec = tapi.SketchSpec(k=150, variant=variant, shards=shards, bits=12,
                               backend=backend)
        sess = TSession(spec, block=512, device="cpu")
        sess.ingest(items, signs)
        states.append(tapi.save(spec, sess.state))
    for key in ("ids", "counts", "errors"):
        np.testing.assert_array_equal(states[0][key], states[1][key], key)


def test_sharded_paths_not_ported_name_their_roadmap_item():
    """``path="shard_map"`` with no mesh raises the reference's
    ``ValueError`` (its message naming the port's module where the
    reference's names its own); an unknown path raises too."""
    st = tshd.init(64, 4, device="cpu")
    it = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError) as want:
        jshd.update_block(jshd.init(64, 4), jnp.zeros(8, jnp.int32),
                          jnp.zeros(8, jnp.int32), path="shard_map")
    with pytest.raises(ValueError) as got:
        tshd.update_block(st, it, it, path="shard_map")
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)
    with pytest.raises(ValueError, match="unknown path"):
        tshd.update_block(st, it, it, path="fast")


@pytest.mark.parametrize("path", ["auto", "block"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_auto_and_block_paths_match_reference(path, variant):
    """The paths that raised until the partition core was ported: the
    reference's ``update_block`` on the same path (its ``"auto"`` is
    ``"block"`` without a mesh), two blocks, and the port's own
    ``"kernel"`` path."""
    rng = np.random.default_rng(40 + variant)
    js, ts = jshd.init(96, 4), tshd.init(96, 4, device="cpu")
    for _ in range(2):
        items, w = _block(rng, n=300)
        js = jshd.update_block(js, jnp.asarray(items), jnp.asarray(w),
                               variant, universe_bits=12, path=path)
        want = tshd.update_block(ts, _t(items), _t(w), variant,
                                 universe_bits=12, path="kernel")
        ts = tshd.update_block(ts, _t(items), _t(w), variant,
                               universe_bits=12, path=path)
        _eq(js.bank, ts.bank, path)
        _eq(want.bank, ts.bank, "kernel path")


# ---------------------------------------------------------------------------
# the build: a library is named by its source and everything it includes
# ---------------------------------------------------------------------------

def test_library_name_follows_included_headers(tmp_path):
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "outer.cuh").write_text('#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "outer.cuh"\n#include <cuda_runtime.h>\n')
    assert _build.includes(src) == [(tmp_path / "outer.cuh").resolve(),
                                    (tmp_path / "inner.cuh").resolve()]
    before = _build.library_path(src)
    assert _build.library_path(src) == before
    (tmp_path / "inner.cuh").write_text("// v2\n")
    assert _build.library_path(src) != before
    # every source of the port names the shared header, the two residual
    # kernels' sources through the header they share
    want = {"fused_update.cu": ["residual_common.cuh", "common.cuh"],
            "residual.cu": ["residual_common.cuh", "common.cuh"],
            "serial_update.cu": ["common.cuh"],
            "unbiased_update.cu": ["common.cuh"]}
    for source in tkernel.SOURCES:
        assert [p.name for p in _build.includes(source)] == want[source.name]
