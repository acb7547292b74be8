"""The port's serial side against the reference package.

``blocks.apply_update`` (one signed weighted update), ``process_stream``
(the raw items scanned in order, the oracle), ``block_update_serial``
(the scan over a block's aggregated uniques: the ``"serial"`` backend)
and ``block_partition_stats`` on the CPU, where the scans are
``apply_update`` item by item; kernel 4's plain version
(``serial_update_ref``) over the aggregated uniques with its insert adds
saturating, which is what the card runs for ``block_update_serial``, and
wrapping, which is the reference's serial Pallas kernel; the
``"serial"`` backend through ``api`` for the plain and sharded frequency
kinds and the quantile kind. Inputs come from numpy seeds and cover the
verify notes' edge cases: k = 1, 3 and 200, B = 1, all-padding blocks,
net-zero cancellation, deletes on an empty sketch, counts at INT_MAX and
BLOCKED padding past a k that is not a multiple of 128.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax.numpy as jnp

from helpers import random_strict_stream
from repro.kernels.sketch_update import ops as jops
from repro.sketch import api as japi
from repro.sketch import blocks as jbl
from repro.sketch import sharded as jshd
from repro.sketch import state as jst
from repro_torch.kernels.sketch_update import ops as tops
from repro_torch.kernels.sketch_update.ref import serial_update_ref
from repro_torch.sketch import api as tapi
from repro_torch.sketch import blocks as tbl
from repro_torch.sketch import sharded as tshd
from repro_torch.sketch import state as tst

IMAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(want, got, msg=""):
    for name, a, b in zip(("ids", "counts", "errors"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{msg}: {name}")


def _to_torch(js):
    return tst.SketchState(*(_t(np.asarray(x)) for x in js))


def _rail(js, at=IMAX):
    """The sketch's live counts set to ``at``."""
    ids = np.asarray(js.ids)
    c = np.where(ids >= 0, at, np.asarray(js.counts)).astype(np.int32)
    return jst.SketchState(js.ids, jnp.asarray(c), js.errors)


def _blocks(rng, k):
    """The edge-case blocks, in order, on one sketch of k slots: a delete
    on the empty sketch, B = 1, all padding (ids of every sign), net-zero
    pairs, a warm signed block, unmonitored deletions of weight 40 (the
    SS± spread over several slots), then (on a state at the INT_MAX rail)
    inserts of new and monitored ids."""
    warm_i, warm_w = random_strict_stream(rng, 300, 3 * k + 7, 0.3)
    fresh = (np.arange(2 * k + 40) + 10 * k + 100).astype(np.int32)
    return [
        ("delete on empty", [5], [-3]),
        ("B = 1", [5], [2]),
        ("all padding", [7, 7, -1, 3], [0, 0, 0, 0]),
        ("net zero", [9, 9, 4, 4, 9], [2, -2, 1, -1, 0]),
        ("warm", warm_i, warm_w),
        ("drain", (np.arange(5) + 50 * k + 999).astype(np.int32),
         np.full(5, -40, np.int32)),
        ("rail", np.concatenate([fresh, warm_i[:20]]),
         np.ones(len(fresh) + 20, np.int32)),
    ]


@pytest.mark.parametrize("k", [1, 3, 200])
@pytest.mark.parametrize("variant", [1, 2])
def test_block_update_serial_matches_reference(k, variant):
    """``block_update_serial`` block after block, and kernel 4's plain
    version over the same aggregated uniques (EMPTY entries at weight
    0) with its adds saturating: both equal the reference's."""
    rng = np.random.default_rng(k + 10 * variant)
    js, ts = jst.init(k), tst.init(k, device="cpu")
    for name, items, w in _blocks(rng, k):
        items, w = np.asarray(items, np.int32), np.asarray(w, np.int32)
        if name == "rail":
            js = _rail(js)
            ts = _to_torch(js)
        want = jbl.block_update_serial(js, jnp.asarray(items),
                                       jnp.asarray(w), variant)
        got = tbl.block_update_serial(ts, _t(items), _t(w), variant)
        _eq(want, got, name)
        uids, net = tbl._aggregate_block(_t(items)[None], _t(w)[None])
        net = torch.where(uids == -1, 0, net)
        plain = tops.serial_update_with(serial_update_ref, ts, uids[0],
                                        net[0], variant, saturate=True)
        _eq(want, plain, f"{name}, kernel 4's plain version")
        js, ts = want, got


@pytest.mark.parametrize("variant", [1, 2])
def test_saturating_and_wrapping_adds_at_the_rail(variant):
    """At the INT_MAX rail the two insert adds differ: saturating, kernel
    4's plain version is ``block_update_serial`` (``apply_update``'s
    sat_add); wrapping, it is the reference's serial Pallas kernel
    (interpret mode) on the same uniques. The padded (R, 128) view of k =
    200 holds 56 BLOCKED slots past k."""
    rng = np.random.default_rng(variant)
    items, w = random_strict_stream(rng, 600, 400, 0.2)
    js = jbl.block_update(jst.init(200), jnp.asarray(items), jnp.asarray(w),
                          variant)
    js = _rail(js, IMAX - 3)
    ts = _to_torch(js)
    items = np.concatenate([items[:50], np.arange(300) + 5000]).astype(np.int32)
    w = np.full(len(items), 5, np.int32)
    uids, net = tbl._aggregate_block(_t(items)[None], _t(w)[None])
    sat = tops.serial_update_with(serial_update_ref, ts, uids[0], net[0],
                                  variant, saturate=True)
    wrap = tops.serial_update_with(serial_update_ref, ts, uids[0], net[0],
                                   variant)
    _eq(jbl.block_update_serial(js, jnp.asarray(items), jnp.asarray(w),
                                variant), sat, "saturating")
    _eq(jops.sketch_block_update_serial(js, jnp.asarray(np.asarray(uids[0])),
                                        jnp.asarray(np.asarray(net[0])),
                                        variant), wrap, "wrapping")
    assert int(sat.counts.max()) == IMAX and int(wrap.counts.min()) < 0


@pytest.mark.parametrize("k", [1, 3, 200])
@pytest.mark.parametrize("variant", [1, 2])
def test_process_stream_matches_reference(k, variant):
    """The oracle over the raw items, the same edge-case blocks (the raw
    scan applies every entry, an item -1 of nonzero weight included)."""
    rng = np.random.default_rng(100 + k + variant)
    js, ts = jst.init(k), tst.init(k, device="cpu")
    for name, items, w in _blocks(rng, k):
        items, w = np.asarray(items, np.int32), np.asarray(w, np.int32)
        if name == "rail":
            js = _rail(js)
            ts = _to_torch(js)
        if name == "warm":
            items[::11] = -1
        js = jbl.process_stream(js, jnp.asarray(items), jnp.asarray(w),
                                variant)
        ts = tbl.process_stream(ts, _t(items), _t(w), variant)
        _eq(js, ts, name)


def test_apply_update_matches_reference():
    """Single updates on a warm sketch: monitored inserts and deletes, an
    EMPTY fill, an eviction, an unmonitored SS± and Lazy delete, weight 0
    and INT_MIN (a no-op), each against the reference's."""
    rng = np.random.default_rng(5)
    items, w = random_strict_stream(rng, 200, 60, 0.3)
    js = jbl.process_stream(jst.init(30), jnp.asarray(items), jnp.asarray(w))
    ts = _to_torch(js)
    held = int(np.asarray(js.ids)[0])
    for item, weight in ((held, 3), (held, -2), (999, 4), (998, 1),
                         (997, -5), (held, 0), (held, -2**31),
                         (996, -2**31), (held, IMAX)):
        for variant in (1, 2):
            want = jbl.apply_update(js, jnp.int32(item), jnp.int32(weight),
                                    variant)
            got = tbl.apply_update(ts, item, weight, variant)
            _eq(want, got, f"{item} {weight} variant {variant}")
        js, ts = want, got


@pytest.mark.parametrize("variant", [1, 2])
def test_block_partition_stats_match_reference(variant):
    rng = np.random.default_rng(variant)
    js, ts = jst.init(64), tst.init(64, device="cpu")
    for _ in range(3):
        items, w = random_strict_stream(rng, 400, 200, 0.3)
        assert tbl.block_partition_stats(ts, _t(items), _t(w), variant) == \
            jbl.block_partition_stats(js, jnp.asarray(items), jnp.asarray(w),
                                      variant)
        js = jbl.block_update(js, jnp.asarray(items), jnp.asarray(w), variant)
        ts = _to_torch(js)


# -- the serial backend through api ----------------------------------------

@pytest.mark.parametrize("fields,as_bank", [
    (dict(k=150, bits=12), False),
    (dict(k=150, bits=12, variant="lazy"), False),
    (dict(k=160, bits=12, shards=4), True),
    (dict(kind="quantile", k=400, bits=8), False),
    (dict(kind="quantile", k=400, bits=8, variant="lazy"), False),
    (dict(kind="quantile", k=8 * 256, bits=8), True),
])
def test_serial_backend_matches_reference(fields, as_bank):
    """``api.update`` on ``backend="serial"``: the plain scan, the sharded
    per-shard oracle and the quantile layers, each equal to the
    reference's. ``as_bank``: equal to the ``"bank"`` backend too, as the
    sharded oracle (two-phase per shard) is, and as the scan is where no
    eviction happens (every layer holds its whole node universe); the
    two-phase update reorders a block's evictions (monitored first), so
    elsewhere the serial baseline differs."""
    jspec = japi.SketchSpec(backend="serial", **fields)
    tspec = tapi.SketchSpec(backend="serial", **fields)
    bspec = tapi.SketchSpec(backend="bank", **fields)
    bits = fields["bits"]
    rng = np.random.default_rng(len(fields) + fields["k"])
    js, ts = japi.make(jspec), tapi.make(tspec, "cpu")
    bs = tapi.make(bspec, "cpu")
    for _ in range(3):
        items, w = random_strict_stream(rng, 256, 1 << bits, 0.3)
        js = japi.update(jspec, js, items, w)
        ts = tapi.update(tspec, ts, items, w)
        bs = tapi.update(bspec, bs, items, w)
    jd, td, bd = (japi.save(jspec, js), tapi.save(tspec, ts),
                  tapi.save(bspec, bs))
    for key in jd:
        np.testing.assert_array_equal(np.asarray(jd[key]), td[key], key)
    assert as_bank == all(np.array_equal(bd[key], td[key]) for key in jd)


@pytest.mark.parametrize("variant", [1, 2])
def test_sharded_serial_reference_matches_reference(variant):
    """``sharded.update_block_serial_reference``: block_update shard by
    shard on the routed views, without and with the packed sort."""
    rng = np.random.default_rng(variant)
    for bits in (None, 12):
        js, ts = jshd.init(90, 3), tshd.init(90, 3, device="cpu")
        for _ in range(2):
            items, w = random_strict_stream(rng, 300, 1 << 12, 0.3)
            js = jshd.update_block_serial_reference(
                js, jnp.asarray(items), jnp.asarray(w), variant, bits)
            ts = tshd.update_block_serial_reference(
                ts, _t(items), _t(w), variant, bits)
            _eq(js.bank, ts.bank, f"bits={bits}")
