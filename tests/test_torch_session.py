"""The port's slice end to end against the reference package.

``repro_torch``'s ``StreamSession`` (spec -> session -> adapter -> fused
update, run on the CPU through the kernel's plain version) against
``repro``'s ``StreamSession`` with ``backend='kernel'`` (the Pallas
kernel in interpret mode) on bounded-deletion streams made with numpy,
for the frequency and the quantile kinds, plus checkpoints carried
across in both directions, the spec's scope, block validation, the
default device and the stream helpers.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax_executables import free_jax_executables  # noqa: F401
from repro.core import streams as jstreams
from repro.core.spacesaving import capacity_for as jcapacity_for
from repro.sketch import api as japi
from repro.sketch.session import StreamSession as JSession
from repro_torch import convert
from repro_torch.core import streams as tstreams
from repro_torch.core.spacesaving import capacity_for
from repro_torch.sketch import api as tapi
from repro_torch.sketch import bank as tbk
from repro_torch.sketch import dyadic as tdy
from repro_torch.sketch import dyadic_sharded as tdysh
from repro_torch.sketch import sharded as tshd
from repro_torch.sketch import state as tst
from repro_torch.sketch.session import StreamSession as TSession

BITS = 12
BLOCK = 256


def _stream(seed=0, n_insert=1500, ratio=0.5):
    s = tstreams.bounded_stream(n_insert, ratio, universe=1 << BITS,
                                skew=1.1, seed=seed)
    return s[:, 0], s[:, 1]


def _specs(shards, variant, **size):
    size = size or {"k": 96}
    return (japi.SketchSpec(variant=variant, shards=shards, bits=BITS,
                            backend="kernel", **size),
            tapi.SketchSpec(variant=variant, shards=shards, bits=BITS,
                            backend="kernel", **size))


def _assert_same(jd, td, msg=""):
    for key in ("ids", "counts", "errors"):
        np.testing.assert_array_equal(np.asarray(jd[key]), td[key],
                                      err_msg=f"{msg}: {key}")


def _state_dicts(js, ts):
    return japi.save(js.spec, js.state), tapi.save(ts.spec, ts.state)


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_session_extend_matches_reference(shards, variant):
    jspec, tspec = _specs(shards, variant)
    js, ts = JSession(jspec, block=BLOCK), TSession(tspec, block=BLOCK,
                                                    device="cpu")
    items, weights = _stream(seed=1 if shards else 2)
    cuts = np.sort(np.random.default_rng(0).integers(0, len(items), 9))
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(items)]):
        js.extend(items[lo:hi], weights[lo:hi])
        ts.extend(items[lo:hi], weights[lo:hi])
    probe = np.arange(1 << BITS)
    np.testing.assert_array_equal(np.asarray(js.query_many(probe)),
                                  ts.query_many(probe).numpy())
    for a, b in zip(js.topk(20), ts.topk(20)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_same(*_state_dicts(js, ts), f"{shards}/{variant}")
    assert ts.ingested_mass == js.ingested_mass


@pytest.mark.parametrize("shards", [None, 4])
def test_windowed_observe_and_push_match_reference(shards):
    jspec, tspec = _specs(shards, "sspm")
    rng = np.random.default_rng(5)
    js = JSession(jspec, block=64, window=40)
    ts = TSession(tspec, block=64, window=40, device="cpu")
    for x in rng.zipf(1.3, 300) % (1 << BITS):
        js.observe(int(x))
        ts.observe(int(x))
    _assert_same(*_state_dicts(js, ts), "observe")
    jp = JSession(jspec, block=64, window=3)
    tp = TSession(tspec, block=64, window=3, device="cpu")
    for _ in range(8):
        batch = rng.integers(0, 1 << BITS, 50)
        w = rng.integers(1, 4, 50)
        jp.push(batch, w)
        tp.push(batch, w)
    _assert_same(*_state_dicts(jp, tp), "push")
    assert (tp.insertions, tp.deletions) == (jp.insertions, jp.deletions)
    assert tp.alpha_bound == jp.alpha_bound


@pytest.mark.parametrize("shards", [None, 4])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_api_update_and_queries_match_reference(shards, variant):
    """The functional surface: update (host arrays, unit weights when
    omitted), query, query_many, topk."""
    jspec, tspec = _specs(shards, variant)
    js, ts = japi.make(jspec), tapi.make(tspec, device="cpu")
    items, weights = _stream(seed=11)
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        w = None if b == 0 else weights[sl]
        js = japi.update(jspec, js, items[sl], w)
        ts = tapi.update(tspec, ts, items[sl], w)
    _assert_same(japi.save(jspec, js), tapi.save(tspec, ts), "update")
    probe = np.arange(0, 1 << BITS, 7)
    np.testing.assert_array_equal(np.asarray(japi.query_many(jspec, js, probe)),
                                  tapi.query_many(tspec, ts, probe).numpy())
    assert int(japi.query(jspec, js, int(items[0]))) == \
        int(tapi.query(tspec, ts, int(items[0])))
    for a, b in zip(japi.topk(jspec, js, 10), tapi.topk(tspec, ts, 10)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("shards", [None, 4])
def test_checkpoint_cross_load(direction, shards):
    """Save mid-stream (scheduling snapshot included) in one package,
    load in the other, finish the stream in both: same state."""
    jspec, tspec = _specs(shards, "sspm")
    items, weights = _stream(seed=7)
    half = len(items) // 2 + 13   # leaves a partial block buffered
    js = JSession(jspec, block=BLOCK)
    ts = TSession(tspec, block=BLOCK, device="cpu")
    if direction == "jax_to_torch":
        js.extend(items[:half], weights[:half])
        d = js.save(include_schedule=True)
        ts.load(d)
    else:
        ts.extend(items[:half], weights[:half])
        d = ts.save(include_schedule=True)
        js.load(d)
    js.extend(items[half:], weights[half:])
    ts.extend(items[half:], weights[half:])
    _assert_same(*_state_dicts(js, ts), direction)
    # plain state dicts carry across through convert as well
    spec, state = convert.to_port(japi.save(js.spec, js.state), device="cpu")
    assert spec.shards == shards
    _assert_same(japi.save(js.spec, js.state), tapi.save(spec, state),
                 "to_port")
    back = japi.restore(js.spec, convert.to_reference(spec, state))
    _assert_same(japi.save(js.spec, back), tapi.save(spec, state),
                 "to_reference")


@pytest.mark.parametrize("eps,alpha,variant",
                         [(1e-3, 2.0, "lazy"), (1e-3, 2.0, "sspm"),
                          (0.01, 4.0, "sspm")])
def test_eps_sizing_matches_reference(eps, alpha, variant):
    jspec, tspec = _specs(8, variant, eps=eps)
    assert tspec.capacity == jspec.capacity
    assert tapi.SketchSpec(eps=eps, alpha=alpha, variant=variant).capacity \
        == japi.SketchSpec(eps=eps, alpha=alpha, variant=variant).capacity
    for name in ("lazy", "ss_pm"):
        assert capacity_for(eps, alpha, name) == jcapacity_for(eps, alpha, name)


@pytest.mark.parametrize("fields,item", [
    (dict(k=64, variant="double"), "double"),
    (dict(k=64, variant="unbiased"), "unbiased"),
    (dict(k=64, backend="crprecis"), "crprecis"),
])
def test_unported_spec_values_name_their_roadmap_item(fields, item):
    """The family's spec values, which raised until the family was
    ported (the name is the placeholder's, kept so the test's id carries
    over), build as the reference's (capacity, registry axis), and a
    session on each answers as the reference's session. Double and
    CR-precis: ingest parity, bit for bit. Unbiased: the uniforms differ
    by design, so the port's session loads the reference's ``save()`` and
    this checks that restore and the queries on the reference's state;
    ingest parity of the unbiased row update is held by
    test_torch_family.py::test_unbiased_row_update_fed_the_reference_uniforms."""
    jspec, tspec = japi.SketchSpec(**fields), tapi.SketchSpec(**fields)
    assert tspec.capacity == jspec.capacity
    assert tapi.spec_axis(tspec) == japi.spec_axis(jspec) == item
    js, ts = JSession(jspec, block=128), TSession(tspec, block=128,
                                                  device="cpu")
    s = tstreams.bounded_stream(600, 0.4, universe=512, skew=1.1, seed=3)
    js.extend(s[:, 0], s[:, 1])
    ts.extend(s[:, 0], s[:, 1])
    if item == "unbiased":     # restore and queries, not ingest parity
        ts.load(js.save())
    probe = np.arange(512)
    np.testing.assert_array_equal(ts.query_many(probe).numpy(),
                                  np.asarray(js.query_many(probe)))
    for key, want in js.save().items():
        np.testing.assert_array_equal(np.asarray(ts.save()[key]),
                                      np.asarray(want), err_msg=key)


@pytest.mark.parametrize("fields", [
    dict(k=64, bits=8, tenants=2),
    dict(k=64, bits=8, tenants=2, variant="lazy"),
    dict(k=64, bits=8, tenants=3, shards=2),
    dict(bits=8, tenants=3, tenant_caps=(10, 30, 24)),
])
def test_tenant_spec_values_run_as_the_reference(fields):
    """The spec values that raised until the tenant layout was ported: a
    session on each, fed composite keys, equals the reference's, bit for
    bit, and the spec's capacity is the reference's."""
    jspec, tspec = japi.SketchSpec(**fields), tapi.SketchSpec(**fields)
    assert tspec.capacity == jspec.capacity
    js, ts = JSession(jspec, block=128), TSession(tspec, block=128,
                                                  device="cpu")
    s = tstreams.bounded_stream(500, 0.5, universe=tspec.tenants << 8,
                                skew=1.1, seed=tspec.tenants)
    js.extend(s[:, 0], s[:, 1])
    ts.extend(s[:, 0], s[:, 1])
    _assert_same(*_state_dicts(js, ts), str(fields))
    probe = np.arange(tspec.tenants << 8)
    np.testing.assert_array_equal(np.asarray(js.query_many(probe)),
                                  ts.query_many(probe).numpy())


@pytest.mark.parametrize("fields", [
    dict(kind="quantile", k=64, bits=8, backend="serial"),
    dict(kind="frequency", k=64, bits=8, backend="bank"),
    dict(k=64, backend="bank"),
    dict(k=64, shards=4, backend="serial"),
    dict(k=64, backend="serial"),
])
def test_bank_and_serial_specs_run_as_the_reference(fields):
    """The spec values that raised until the partition core and the
    serial backend were ported: a session on each equals the reference's,
    bit for bit (the quantile one with its mass)."""
    bits = fields.get("bits", BITS)
    jspec, tspec = japi.SketchSpec(**fields), tapi.SketchSpec(**fields)
    js, ts = JSession(jspec, block=128), TSession(tspec, block=128,
                                                  device="cpu")
    s = tstreams.bounded_stream(400, 0.5, universe=1 << bits, skew=1.1,
                                seed=len(fields))
    js.extend(s[:, 0], s[:, 1])
    ts.extend(s[:, 0], s[:, 1])
    _assert_same(*_state_dicts(js, ts), str(fields))
    if tspec.kind == "quantile":
        assert int(js.state.mass) == int(ts.state.mass)


def test_spec_defaults_are_the_reference_defaults():
    """Every field's default, ``backend="bank"`` among them."""
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(japi.SketchSpec)}
    got = {f.name: f.default for f in dataclasses.fields(tapi.SketchSpec)}
    assert got == want and got["backend"] == "bank"


@pytest.mark.parametrize("fields", [
    dict(kind="cardinality", k=8), dict(k=8, variant="fast"),
    dict(k=8, eps=0.1), dict(), dict(k=8, shards=0)])
def test_bad_spec_values_raise_like_the_reference(fields):
    with pytest.raises(ValueError):
        japi.SketchSpec(**fields)
    with pytest.raises(ValueError):
        tapi.SketchSpec(**fields)


@pytest.mark.parametrize("items,weights", [
    (np.array([1, -1]), np.array([1, 1])),                 # negative id
    (np.array([1, 2]), np.array([1])),                     # length mismatch
    (np.array([1.0, 2.0]), np.array([1, 1])),              # float ids
    (np.array([2**31]), np.array([1])),                    # id past int32
    (np.array([1, 2]), np.array([2**31 - 1, 2])),          # weight sum
    (np.array([[1, 2]]), np.array([[1, 1]])),              # not 1-D
])
def test_validate_block_rejects_what_the_reference_rejects(items, weights):
    jspec, tspec = _specs(None, "sspm")
    with pytest.raises(ValueError):
        japi.validate_block(jspec, items, weights)
    with pytest.raises(ValueError):
        tapi.validate_block(tspec, items, weights)


@pytest.mark.parametrize("items,weights", [
    (np.array([1, 1]), np.array([2**31 - 1, 2**31 - 1])),  # net weight wraps
    (np.array([3, -5, 4]), np.array([1, 1, 1])),           # negative id
    (np.array([2**32 + 7]), np.array([1])),                # id past int32
])
def test_update_validates_tensor_inputs_as_the_reference_does(items, weights):
    """``api.update`` holds tensors to the block conventions too: the
    reference raises on these values, so the port raises on them as
    tensors (CPU here; a CUDA tensor takes the same host copy)."""
    jspec, tspec = _specs(None, "sspm", k=8)
    with pytest.raises(ValueError):
        japi.update(jspec, japi.make(jspec), items, weights)
    tstate = tapi.make(tspec, device="cpu")
    with pytest.raises(ValueError):
        tapi.update(tspec, tstate, torch.as_tensor(items),
                    torch.as_tensor(weights))
    with pytest.raises(ValueError):
        tapi.update(tspec, tstate, items, weights)


_QUERY_ENTRIES = {
    "api.query_many": lambda api, spec, st, sess, x: api.query_many(
        spec, st, [x]),
    "api.query": lambda api, spec, st, sess, x: api.query(spec, st, x),
    "api.rank_many": lambda api, spec, st, sess, x: api.rank_many(
        spec, st, [x]),
    "api.rank": lambda api, spec, st, sess, x: api.rank(spec, st, x),
    "session.query_many": lambda api, spec, st, sess, x: sess.query_many(
        [x]),
    "session.rank_many": lambda api, spec, st, sess, x: sess.rank_many([x]),
    "session.rank": lambda api, spec, st, sess, x: sess.rank(x),
}


@pytest.mark.parametrize("item", [2**32 + 5, 2**31, -2**31 - 1])
@pytest.mark.parametrize("entry", list(_QUERY_ENTRIES))
def test_query_ids_past_int32_raise_as_the_reference(entry, item):
    """Every entry that takes query ids refuses a Python int outside int32
    with ``OverflowError``, as the reference's ``jnp.asarray(x,
    jnp.int32)`` does (the port used to keep the low 32 bits); an int64
    numpy array keeps its low 32 bits in both packages."""
    call = _QUERY_ENTRIES[entry]
    kind = "quantile" if "rank" in entry else "frequency"
    fields = dict(kind=kind, k=64, bits=8)
    jspec, tspec = japi.SketchSpec(**fields), tapi.SketchSpec(**fields)
    items = np.asarray([5, 5, 7, 200], np.int32)
    js = japi.update(jspec, japi.make(jspec), items, None)
    ts = tapi.update(tspec, tapi.make(tspec, device="cpu"), items, None)
    jsess, tsess = JSession(jspec, block=8), TSession(tspec, block=8,
                                                      device="cpu")
    jsess.extend(items)
    tsess.extend(items)
    with pytest.raises(OverflowError):
        call(japi, jspec, js, jsess, item)
    with pytest.raises(OverflowError):
        call(tapi, tspec, ts, tsess, item)
    if entry.endswith("_many"):
        name = entry.split(".")[1]
        wide = np.asarray([item], np.int64)
        if entry.startswith("api"):
            got = getattr(tapi, name)(tspec, ts, wide)
            want = getattr(japi, name)(jspec, js, wide)
        else:
            got = getattr(tsess, name)(wide)
            want = getattr(jsess, name)(wide)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("item", [2**32 + 3, -2**31 - 1])
def test_query_refuses_an_id_past_int32(item):
    jspec, tspec = _specs(None, "sspm", k=8)
    with pytest.raises(OverflowError):
        japi.query(jspec, japi.make(jspec), item)
    with pytest.raises(OverflowError):
        tapi.query(tspec, tapi.make(tspec, device="cpu"), item)


@pytest.mark.parametrize("shards,m", [(None, 10), (None, -1), (4, 97)])
def test_topk_refuses_m_past_capacity(shards, m):
    """top-m past the slots there are (or below 0) raises in both
    packages: ``jax.lax.top_k`` in the reference, ``state.top_m`` (under
    ``topk`` and ``bank.topk_bank``) in the port; m at the capacity does
    not."""
    jspec, tspec = _specs(shards, "sspm", k=8 if shards is None else 96)
    js, ts = japi.make(jspec), tapi.make(tspec, device="cpu")
    with pytest.raises(ValueError):
        japi.topk(jspec, js, m)
    with pytest.raises(ValueError):
        tapi.topk(tspec, ts, m)
    full = tspec.capacity if shards is None else 96
    for a, b in zip(japi.topk(jspec, js, full), tapi.topk(tspec, ts, full)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_validate_block_prior_mass_bound():
    jspec, tspec = _specs(None, "sspm")
    items, weights = np.array([3, 3]), np.array([5, 6])
    for api, spec in ((japi, jspec), (tapi, tspec)):
        assert api.validate_block(spec, items, weights) == 11
        with pytest.raises(ValueError):
            api.validate_block(spec, items, weights, prior_mass=2**31 - 5)


def test_entry_points_default_to_cuda():
    """Without device=, entry points ask for the card and raise without one
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    spec = tapi.SketchSpec(k=64)
    for call in (lambda: tapi.make(spec), lambda: TSession(spec),
                 lambda: tshd.init(64, 4), lambda: tbk.init(64, 4),
                 lambda: tst.init(64),
                 lambda: tapi.restore(spec, tapi.save(
                     spec, tapi.make(spec, device="cpu")))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_streams_are_valid_and_counted_like_the_reference():
    s = tstreams.bounded_stream(3000, 0.5, universe=1 << 10, seed=4)
    got = tstreams.exact_stats(s)           # raises if not strict turnstile
    want = jstreams.exact_stats(s)
    assert (got.insertions, got.deletions) == (3000, 1500)
    assert got.alpha == want.alpha == 2.0
    ref = {k: v for k, v in want.frequencies.items() if v}
    assert dict(zip(got.items.tolist(), got.freqs.tolist())) == ref
    assert set(tstreams.heavy_hitters(got, 0.01).tolist()) == \
        jstreams.heavy_hitters(want, 0.01)
    bad = np.array([[1, 1], [2, -1]])
    with pytest.raises(ValueError):
        tstreams.exact_stats(bad)


# -- the quantile kind through the spec and the session ------------------

QBITS = 10


def _qspecs(shards=None, variant="sspm", backend="kernel", **size):
    size = size or {"k": 512}
    jb = "bank" if shards else backend
    return (japi.SketchSpec(kind="quantile", variant=variant, shards=shards,
                            bits=QBITS, backend=jb, **size),
            tapi.SketchSpec(kind="quantile", variant=variant, shards=shards,
                            bits=QBITS, backend=jb, **size))


def _qstream(seed=0, n_insert=1500):
    s = tstreams.bounded_stream(n_insert, 0.5, universe=1 << QBITS, skew=1.1,
                                seed=seed)
    return s[:, 0], s[:, 1]


def _assert_qstate(js, ts, msg=""):
    _assert_same(japi.save(js.spec, js.state), tapi.save(ts.spec, ts.state),
                 msg)
    assert int(js.state.mass) == int(ts.state.mass), msg


@pytest.mark.parametrize("fields", [
    dict(kind="quantile", k=64),                           # no bits
    dict(kind="quantile", k=64, bits=8, shards=2, backend="kernel"),
    dict(kind="quantile", k=64, bits=8, shards=2, backend="block"),
    dict(kind="quantile", k=64, bits=8, shards=2, backend="serial"),
    dict(kind="quantile", k=64, bits=8, variant="double"),
])
def test_quantile_spec_errors_match_the_reference(fields):
    with pytest.raises(ValueError) as want:
        japi.SketchSpec(**fields)
    with pytest.raises(ValueError) as got:
        tapi.SketchSpec(**fields)
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


@pytest.mark.parametrize("shards", [None, 3])
@pytest.mark.parametrize("size", [dict(k=512), dict(eps=0.01, alpha=3.0)])
def test_quantile_sizing_matches_the_reference(shards, size):
    jspec, tspec = _qspecs(shards, **size)
    assert tspec.layer_capacities() == jspec.layer_capacities()
    for spec in (jspec, tspec):
        with pytest.raises(ValueError, match="layer_capacities"):
            spec.capacity
    freq = _specs(None, "sspm")
    for spec in freq:
        with pytest.raises(ValueError, match="quantile kinds"):
            spec.layer_capacities()
    state = tapi.make(tspec, device="cpu")
    assert state.bank.ids.shape[-2:] == (QBITS, max(
        tspec.layer_capacities()))


def test_backends_the_port_runs():
    """``backends_for`` and ``variants_for`` answer as the reference's, and
    every base backend they list builds a spec on the base adapter."""
    for kind in ("frequency", "quantile"):
        assert tapi.variants_for(kind) == japi.variants_for(kind)
        for shards in (None, 4):
            for variant in japi.variants_for(kind):
                for tenants in (None, 2):
                    assert tapi.backends_for(kind, shards, variant, tenants) \
                        == japi.backends_for(kind, shards, variant, tenants)
            for variant in ("sspm", "lazy"):
                for backend in tapi.backends_for(kind, shards, variant):
                    if backend == "crprecis":
                        continue
                    spec = tapi.SketchSpec(kind=kind, k=64, bits=8,
                                           shards=shards, variant=variant,
                                           backend=backend)
                    assert tapi.spec_axis(spec) == "base"
                    assert tapi.adapter_for(spec) is tapi.adapter_for(
                        tapi.SketchSpec(kind=kind, k=64, bits=8,
                                        shards=shards))
    assert tapi.backends_for("quantile", 4) == ("bank",)


@pytest.mark.parametrize("items,weights", [
    (np.array([5, 1 << QBITS]), np.array([1, 1])),         # past the universe
    (np.array([5, (1 << QBITS) + 9, 2**31 - 1]), np.array([1, -1, 1])),
    (np.array([-1, 1 << QBITS]), np.array([1, 1])),        # negative first
])
def test_validate_block_universe_message_matches_the_reference(items,
                                                               weights):
    jspec, tspec = _qspecs()
    with pytest.raises(ValueError) as want:
        japi.validate_block(jspec, items, weights)
    with pytest.raises(ValueError) as got:
        tapi.validate_block(tspec, items, weights)
    assert str(got.value) == str(want.value)
    # a padding entry outside the universe is fine
    ok = np.array([1 << QBITS, 3])
    assert tapi.validate_block(tspec, ok, np.array([0, 2])) == \
        japi.validate_block(jspec, ok, np.array([0, 2])) == 2


@pytest.mark.parametrize("shards,backend", [(None, "kernel"), (None, "bank"),
                                            (None, "block"), (3, "bank")])
@pytest.mark.parametrize("variant", ["sspm", "lazy"])
def test_quantile_session_matches_reference(shards, backend, variant):
    """``extend`` in uneven pieces, then the queries: frequency reads of
    the leaf layer, top-k, ranks and quantiles; the checkpoint dicts."""
    jspec, tspec = _qspecs(shards, variant, backend)
    js, ts = JSession(jspec, block=BLOCK), TSession(tspec, block=BLOCK,
                                                    device="cpu")
    items, weights = _qstream(seed=3 if shards else 4)
    cuts = np.sort(np.random.default_rng(1).integers(0, len(items), 7))
    for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(items)]):
        js.extend(items[lo:hi], weights[lo:hi])
        ts.extend(items[lo:hi], weights[lo:hi])
    probe = np.arange(0, 1 << QBITS, 5)
    np.testing.assert_array_equal(np.asarray(js.rank_many(probe)),
                                  ts.rank_many(probe).numpy())
    qs = np.linspace(0, 1, 21)
    np.testing.assert_array_equal(np.asarray(js.quantile_many(qs)),
                                  ts.quantile_many(qs).numpy())
    assert (js.rank(77), js.quantile(0.9)) == (ts.rank(77), ts.quantile(0.9))
    np.testing.assert_array_equal(np.asarray(js.query_many(probe)),
                                  ts.query_many(probe).numpy())
    for a, b in zip(js.topk(8), ts.topk(8)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _assert_qstate(js, ts, f"{shards}/{backend}/{variant}")
    assert js.state.bank.ids.shape == tuple(ts.state.bank.ids.shape)


@pytest.mark.parametrize("shards", [None, 3])
def test_quantile_observe_and_push_match_reference(shards):
    jspec, tspec = _qspecs(shards)
    rng = np.random.default_rng(7)
    js = JSession(jspec, block=64, window=40)
    ts = TSession(tspec, block=64, window=40, device="cpu")
    for x in rng.zipf(1.3, 300) % (1 << QBITS):
        js.observe(int(x))
        ts.observe(int(x))
    _assert_qstate(js, ts, "observe")
    for s in (js, ts):
        with pytest.raises(ValueError, match="outside the dyadic universe"):
            s.observe(1 << QBITS)
    jp = JSession(jspec, block=64, window=3)
    tp = TSession(tspec, block=64, window=3, device="cpu")
    for _ in range(8):
        batch = rng.integers(0, 1 << QBITS, 50)
        w = rng.integers(1, 4, 50)
        jp.push(batch, w)
        tp.push(batch, w)
    _assert_qstate(jp, tp, "push")
    np.testing.assert_array_equal(np.asarray(jp.quantile_many([0.25, 0.75])),
                                  tp.quantile_many([0.25, 0.75]).numpy())


@pytest.mark.parametrize("shards", [None, 3])
def test_quantile_merge_from_and_checkpoints_match_reference(shards):
    jspec, tspec = _qspecs(shards, backend="bank")
    a_items, a_w = _qstream(seed=11)
    b_items, b_w = _qstream(seed=12, n_insert=700)
    sessions = []
    for spec, cls, kw in ((jspec, JSession, {}),
                          (tspec, TSession, {"device": "cpu"})):
        a, b = cls(spec, block=BLOCK, **kw), cls(spec, block=BLOCK, **kw)
        a.ingest(a_items, a_w)
        b.ingest(b_items, b_w)
        a.merge_from(b)
        sessions.append(a)
    _assert_qstate(*sessions, "merge_from")
    js, ts = sessions
    d = ts.save(include_schedule=True)
    jback = JSession(japi.SketchSpec(k=64, bits=QBITS), block=BLOCK)
    jback.load(d)
    assert jback.spec.kind == "quantile" and jback.spec.shards == shards
    tback = TSession(tapi.SketchSpec(k=64, bits=QBITS), block=BLOCK,
                     device="cpu")
    tback.load(japi.save(js.spec, js.state))
    assert (tback.spec.kind, tback.spec.shards) == ("quantile", shards)
    _assert_qstate(jback, tback, "load")
    probe = np.arange(0, 1 << QBITS, 9)
    np.testing.assert_array_equal(np.asarray(jback.rank_many(probe)),
                                  tback.rank_many(probe).numpy())
    # converted both ways through repro_torch.convert
    spec, state = convert.to_port(japi.save(js.spec, js.state), device="cpu")
    assert (spec.kind, spec.bits, spec.shards) == ("quantile", QBITS, shards)
    _assert_same(japi.save(js.spec, js.state), convert.to_reference(spec,
                                                                     state))


def test_rank_queries_need_a_quantile_spec():
    for api, spec in zip((japi, tapi), _specs(None, "sspm")):
        state = api.make(spec) if api is japi else api.make(spec, "cpu")
        for call in (api.rank_many, api.quantile_many):
            with pytest.raises(ValueError, match="kind='quantile'"):
                call(spec, state, [1])


def test_quantile_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from repro_torch.sketch import dyadic, dyadic_sharded

    _, spec = _qspecs()
    for call in (lambda: tapi.make(spec), lambda: TSession(spec),
                 lambda: dyadic.init(8, eps=0.5),
                 lambda: dyadic_sharded.init(8, 2, eps=0.5),
                 lambda: tbk.init([4, 2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- the reference's deprecated spellings (its tests/test_api.py:241-280) --

@pytest.mark.parametrize("mod", [tshd, tdy, tdysh],
                         ids=["sharded", "dyadic", "dyadic_sharded"])
def test_client_ingest_alias_warns_once_and_is_same_object(mod):
    fn = mod.ingest
    assert fn.__wrapped__ is mod.update_block
    assert mod.ingest is fn
    if mod is tshd:
        state = tshd.init(16, 2, device="cpu")
    elif mod is tdy:
        state = tdy.init(8, total_counters=64, device="cpu")
    else:
        state = tdysh.init(8, 2, total_counters=64, device="cpu")
    i = torch.arange(8, dtype=torch.int32)
    w = torch.ones(8, dtype=torch.int32)
    want = fn.__wrapped__(state, i, w)     # a direct call never warns
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = fn(state, i, w)
        fn(state, i, w)
    dep = [x for x in rec if issubclass(x.category, DeprecationWarning)]
    # at most once per process (the first call may predate this test)
    assert len(dep) <= 1
    for x in dep:
        assert "api.update" in str(x.message)
    for a, b in zip(tapi.save(*_spec_of(mod), got).values(),
                    tapi.save(*_spec_of(mod), want).values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(AttributeError, match="no attribute"):
        mod.not_a_name


def _spec_of(mod):
    if mod is tshd:
        return (tapi.SketchSpec(k=16, shards=2),)
    if mod is tdy:
        return (tapi.SketchSpec(kind="quantile", k=64, bits=8),)
    return (tapi.SketchSpec(kind="quantile", k=64, bits=8, shards=2),)


def test_deprecated_alias_warns_once_per_alias():
    calls = []
    alias = tapi.deprecated_alias("old.name", "new.name",
                                  lambda *a, **k: calls.append((a, k)) or 7)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert alias(1, x=2) == 7 and alias(3) == 7
    dep = [x for x in rec if issubclass(x.category, DeprecationWarning)]
    assert len(dep) == 1 and "old.name" in str(dep[0].message) \
        and "new.name" in str(dep[0].message)
    assert calls == [((1,), {"x": 2}), ((3,), {})]


@pytest.mark.parametrize("path", ["block", "serial", "kernel"])
def test_api_update_path_kwarg_warns_and_maps_to_backend(path):
    jspec, tspec = _specs(None, "sspm", k=16)
    items = np.arange(8, dtype=np.int32)
    w = np.ones(8, np.int32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = tapi.update(tspec, tapi.make(tspec, device="cpu"), items, w,
                          path=path)
        jgot = japi.update(jspec, japi.make(jspec), items, w, path=path)
    assert sum(issubclass(x.category, DeprecationWarning) for x in rec) == 2
    want = tapi.update(dataclasses.replace(tspec, backend=path),
                       tapi.make(tspec, device="cpu"), items, w)
    for a, b, c in zip(got, want, jgot):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
