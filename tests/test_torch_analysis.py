"""The port's analyzer (``repro_torch.analysis``) against the reference's
(``repro.analysis``) and against its own seeded cases.

- Lint parity: every fixture source of the reference's ``TestSK101*`` to
  ``TestSK104*`` classes (``tests/test_analysis.py``) and every
  BEFORE/AFTER pair of ``tests/test_analysis_findings.py``, read from
  those files, goes through both packages' ``lint_source`` with its path
  moved from ``src/repro/`` to ``src/repro_torch/``: the rule lists are
  equal. Torch-spelled fixtures cover what the reference's do not reach.
- The whole port tree holds SK101 and SK102 at 0, with no baselined key.
- SK201 and SK202 run over eager aten traces of the CPU path: the seeded
  cases (a wrap, both ``sat_add`` spellings, a loop accumulation, a host
  read, an unguarded and a guarded equality, a sentinel constant), the
  ingest grid (every loop on each cell's path driven at least twice, by
  source site) and merge wrap-free, the query grid clean. The
  reference's own range and sentinel tests fail on this tree (jax 0.9
  has no ``jax.core.Literal``), so the port's are held to these cases.
- SK203: the port's cell count on the CPU equals the reference's
  ``audit_recompiles`` on the same grid; the tenant-collapse and
  distinct-layout pins.
- SK204: the static half on the real wrappers and on seeded wrappers,
  the CPU behavioral half.
- The CLI's exit codes, JSON report and baseline refusal, and ``python
  -m repro_torch.analysis --device cpu``.
"""
from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from repro.analysis.astlint import lint_source as ref_lint
from repro_torch.analysis import ZERO_BASELINE_RULES, load_baseline
from repro_torch.analysis.astlint import lint_source, lint_tree
from repro_torch.analysis.recorder import loops_in

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SKETCH_REL = "src/repro_torch/sketch/fixture.py"
KERNEL_REL = "src/repro_torch/kernels/fixture/kernel.py"
I32 = torch.int32


def rules_of(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# Lint parity on the reference's fixtures
# ---------------------------------------------------------------------------

def _string(node, consts):
    """The text of a fixture expression: a literal, ``textwrap.dedent`` of
    one, or a module constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == \
            "dedent":
        return textwrap.dedent(_string(node.args[0], consts))
    if isinstance(node, ast.Name):
        return consts[node.id]
    raise ValueError(ast.unparse(node))


def reference_fixtures():
    """(id, source, reference path) of every ``lint_source`` call in the
    reference's SK101-SK104 classes and findings regression classes."""
    out = []
    for name, prefix in (("test_analysis.py", "TestSK10"),
                         ("test_analysis_findings.py", "Test")):
        tree = ast.parse((ROOT / "tests" / name).read_text())
        consts = {t.id: n.value.value for n in tree.body
                  if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Constant)
                  for t in n.targets if isinstance(t, ast.Name)}
        for cls in tree.body:
            if not (isinstance(cls, ast.ClassDef)
                    and cls.name.startswith(prefix)):
                continue
            attrs = {t.id: _string(n.value, consts) for n in cls.body
                     if isinstance(n, ast.Assign) for t in n.targets
                     if isinstance(t, ast.Name)
                     and isinstance(n.value, (ast.Call, ast.Constant))}
            for fn in cls.body:
                if not isinstance(fn, ast.FunctionDef):
                    continue
                local = {}
                for node in ast.walk(fn):
                    if isinstance(node, ast.Assign) and len(
                            node.targets) == 1 and isinstance(
                            node.targets[0], ast.Name):
                        try:
                            local[node.targets[0].id] = _string(
                                node.value, consts)
                        except (ValueError, KeyError, AttributeError):
                            pass
                calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                         and getattr(n.func, "id", "") == "lint_source"]
                for i, call in enumerate(calls):
                    src, rel = call.args
                    if isinstance(src, ast.Attribute):
                        text = attrs[src.attr]
                    else:
                        text = local[src.id] if isinstance(
                            src, ast.Name) else _string(src, consts)
                    out.append((f"{name}::{cls.name}::{fn.name}[{i}]", text,
                                _string(rel, consts)))
    return out


FIXTURES = reference_fixtures()


def test_every_reference_fixture_was_read():
    classes = {case[0].split("::")[1] for case in FIXTURES}
    assert {c for c in classes if c.startswith("TestSK10")} == {
        "TestSK101SentinelEquality", "TestSK102KernelLiteral",
        "TestSK103JitStatic", "TestSK104DeprecatedShim"}
    assert {"TestApplyOneRegression", "TestReferenceInsertDeleteRegression",
            "TestPartitionBlockRegression",
            "TestRankManyRegression"} <= classes
    assert len(FIXTURES) >= 28


@pytest.mark.parametrize("case", FIXTURES, ids=lambda c: c[0])
def test_lint_parity_on_reference_fixtures(case):
    _, src, rel = case
    assert rel.startswith("src/repro/")
    moved = "src/repro_torch/" + rel[len("src/repro/"):]
    assert rules_of(lint_source(src, moved)) == rules_of(ref_lint(src, rel))


# ---------------------------------------------------------------------------
# Torch-spelled fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", [
    "ids.to(I32) == x", "ids.long() == x", "ids.int() == x",
    "bank.ids.view(-1) == x", "ids.flatten() == x", "ids[..., None] == x",
    "x == state.ids.reshape(-1)"])
def test_sk101_sees_through_casts_and_views(expr):
    bad = f"def q(ids, x, bank, state):\n    return {expr}\n"
    assert rules_of(lint_source(bad, SKETCH_REL)) == ["SK101"]
    good = (f"def q(ids, x, bank, state):\n    return ({expr}) & "
            f"(ids.to(I32) >= 0)\n")
    assert lint_source(good, SKETCH_REL) == []


@pytest.mark.parametrize("const", [
    "torch.tensor(-1)", "torch.full((k,), EMPTY)", "-2**31",
    "torch.full_like(ids, BLOCKED)", "torch.tensor(POISON, dtype=I32)"])
def test_sk101_sentinel_constants_are_exempt(const):
    src = f"def count(ids, k):\n    return (ids.to(I32) == {const}).sum()\n"
    assert lint_source(src, SKETCH_REL) == []


@pytest.mark.parametrize("name", ["kernel.py", "ops.py", "ref.py"])
def test_sk102_module_tensor_constant_in_a_wrapper(name):
    src = textwrap.dedent("""
        import torch
        ZEROS = torch.zeros(8, dtype=torch.int32)

        def wrapper(ids):
            return ids + ZEROS
    """)
    rel = f"src/repro_torch/kernels/fixture/{name}"
    fs = lint_source(src, rel)
    assert rules_of(fs) == ["SK102"] and "ZEROS" in fs[0].message
    # out of scope: the build helpers, the sketch layers
    assert lint_source(src, "src/repro_torch/kernels/_build.py") == []
    assert lint_source(src, SKETCH_REL) == []


@pytest.mark.parametrize("factory", [
    "torch.tensor([1, 2])", "torch.as_tensor(3)", "torch.arange(4)",
    "torch.full((2,), -1)", "torch.ones(3)", "torch.empty(2)",
    "np.array([1])", "np.asarray([1])", "np.arange(3)"])
def test_sk102_every_factory(factory):
    src = f"C = {factory}\n\ndef launch(x):\n    return x + C\n"
    assert rules_of(lint_source(src, KERNEL_REL)) == ["SK102"]


def test_sk102_exemptions_and_int_literals():
    ok = textwrap.dedent("""
        import ctypes
        import torch
        I32 = torch.int32
        _LIB = torch.library.Library("repro_torch", "FRAGMENT")
        _INT31 = 2**31

        def launch(ids):
            _LIB.impl
            return ids.to(I32), ctypes.c_uint32(-1).value
    """)
    assert lint_source(ok, KERNEL_REL) == []
    bad = "def launch(ids):\n    return ids & 0xffffffff\n"
    assert rules_of(lint_source(bad, KERNEL_REL)) == ["SK102"]


def test_decode_layout_readback_keeps_its_value():
    """The decode kernel's layout readback joins two C ints into the
    scratch size; its low word is read as unsigned through ``c_uint32``
    (an int literal past int32 there is an SK102 site)."""
    import ctypes

    for lo in (-2**31, -1, 0, 5, 2**31 - 1):
        for hi in (0, 1, 7):
            assert (hi << 32) | ctypes.c_uint32(lo).value == \
                (hi << 32) | (lo % 2**32)


def test_sk103_value_keyed_caches():
    src = textwrap.dedent("""
        import functools

        @functools.lru_cache(maxsize=None)
        def cell(spec, shape=[8]):
            return spec

        @functools.cache
        def other(spec, shape=(8,)):
            return spec

        def caller(spec):
            other(spec, [1, 2])
            return other(spec, shape=(1, 2))
    """)
    fs = lint_source(src, SKETCH_REL)
    assert rules_of(fs) == ["SK103", "SK103"]
    assert {f.symbol for f in fs} == {"cell", "other"}


def test_sk104_any_jax_sketch_import():
    src = "from repro_torch.sketch import jax_sketch\n"
    assert rules_of(lint_source(src, SKETCH_REL)) == ["SK104"]


# ---------------------------------------------------------------------------
# The whole tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_findings():
    return lint_tree(str(ROOT / "src" / "repro_torch"))


@pytest.mark.parametrize("rule", ["SK101", "SK102"])
def test_tree_holds_zero_tolerance_rules_at_zero(tree_findings, rule):
    fs = [f for f in tree_findings if f.rule == rule]
    assert fs == [], [f.render() for f in fs]


def test_tree_is_clean_and_baseline_empty(tree_findings):
    assert tree_findings == [], [f.render() for f in tree_findings]
    base = load_baseline()
    assert [k for k in base if k.split(":", 1)[0] in ZERO_BASELINE_RULES] \
        == []
    assert base == set()


# ---------------------------------------------------------------------------
# SK201: the range pass
# ---------------------------------------------------------------------------

def _z(n=8, dtype=I32):
    return torch.zeros(n, dtype=dtype)


def _range(fn, args, ivals, more=()):
    from repro_torch.analysis.range_interp import analyze_callable

    return analyze_callable(fn, args, "fixture", in_ivals=ivals,
                            more_args=more)


def test_seeded_overflow_flagged():
    from repro_torch.analysis.range_interp import INT32_MAX, Ival

    fs = _range(lambda c, w: c + w, (_z(), _z()),
                [Ival(0, INT32_MAX), Ival(0, INT32_MAX)])
    assert rules_of(fs) == ["SK201"]


@pytest.mark.parametrize("spelling", ["tensor", "number"])
def test_saturating_add_not_flagged(spelling):
    from repro_torch.analysis.range_interp import IMAX, Ival
    from repro_torch.sketch.state import sat_add

    if spelling == "tensor":
        fs = _range(lambda c, w: sat_add(c, w), (_z(), _z()),
                    [Ival(-IMAX, IMAX)] * 2)
    else:
        fs = _range(lambda c: sat_add(c, -7), (_z(),), [Ival(-IMAX, IMAX)])
    assert fs == []


def test_bounded_add_not_flagged():
    from repro_torch.analysis.range_interp import Ival

    assert _range(lambda a, b: a + b, (_z(4), _z(4)),
                  [Ival(0, 100), Ival(0, 100)]) == []


def _accumulate(c, w):
    n = 0
    while n < 2:        # unrolled twice in the trace
        c = c + w
        n += 1
    return c


def _accumulate_sat(c, w):
    from repro_torch.sketch.state import sat_add

    for _ in range(2):
        c = sat_add(c, w)
    return c


def _count_guarded(i, n):
    while bool(i < n):
        i = i + 1
    return i


def _count_blind(i, n):
    for _ in range(3):
        i = i + 1
    return i


@pytest.mark.parametrize("fn,flagged", [
    (_accumulate, True), (_accumulate_sat, False)])
def test_loop_accumulation(fn, flagged):
    """Each add is in range for the two iterations the trace saw; the
    carried value grows between them, so it is widened and a plain add
    on it can wrap."""
    from repro_torch.analysis.range_interp import Ival

    fs = _range(fn, (_z(), torch.ones(8, dtype=I32)),
                [Ival(0, 0), Ival(0, 100)])
    assert rules_of(fs) == (["SK201"] if flagged else [])
    if flagged:
        assert "loop" in fs[0].message


@pytest.mark.parametrize("fn,flagged", [
    (_count_guarded, False), (_count_blind, True)])
def test_loop_counter_bounded_by_its_host_guard(fn, flagged):
    from repro_torch.analysis.range_interp import Ival

    fs = _range(fn, (torch.zeros((), dtype=I32), torch.tensor(3, dtype=I32)),
                [Ival(0, 0), Ival(0, 100)])
    assert rules_of(fs) == (["SK201"] if flagged else [])


def test_host_read_scalar_is_not_a_literal():
    """A number read from the card enters the add; on two data sets it
    differs, so it takes its dtype's range."""
    from repro_torch.analysis.range_interp import IMAX, Ival

    def fn(c, w):
        return c + int(w.max())

    fs = _range(fn, (_z(), torch.full((8,), 5, dtype=I32)),
                [Ival(0, IMAX - 100), Ival(0, IMAX)],
                more=[(_z(), torch.full((8,), 9, dtype=I32))])
    assert rules_of(fs) == ["SK201"]


@pytest.mark.parametrize("hi,flagged", [(2**31 - 1, True), (1000, False)])
def test_wrap_add_is_read_as_an_int32_add(hi, flagged):
    from repro_torch.analysis.range_interp import Ival
    from repro_torch.sketch.state import wrap_add

    fs = _range(lambda a, b: wrap_add(a, b), (_z(), _z()),
                [Ival(0, hi)] * 2)
    assert rules_of(fs) == (["SK201"] if flagged else [])


RANGE_GRID = [
    dict(variant="sspm", backend="bank", shards=None),
    dict(variant="lazy", backend="bank", shards=None),
    dict(variant="double", backend="bank", shards=None),
    dict(variant="unbiased", backend="bank", shards=None),
    dict(variant="sspm", backend="crprecis", shards=None),
    dict(variant="sspm", backend="bank", shards=4),
    dict(variant="lazy", backend="bank", shards=4),
    dict(variant="double", backend="bank", shards=4),
]


def _cell_id(c):
    return f"{c['variant']}-{c['backend']}-s{c['shards']}"


@pytest.fixture(scope="module")
def ingest_grid():
    """Every cell's range analysis (two recorded runs each), once."""
    from repro_torch.analysis.range_interp import analyze_update
    from repro_torch.sketch.api import SketchSpec

    out = {}
    for cell in RANGE_GRID:
        spec = SketchSpec(kind="frequency", k=32, **cell)
        out[_cell_id(cell)] = analyze_update(spec, block=32)
    return out


@pytest.mark.parametrize("cell", RANGE_GRID, ids=_cell_id)
def test_ingest_grid_wrap_free(ingest_grid, cell):
    findings, an = ingest_grid[_cell_id(cell)]
    assert findings == [], [f.render() for f in findings]
    assert an.unknown_ops == set()


def _expected_loops(variant, backend):
    from repro_torch.kernels.sketch_update import ref
    from repro_torch.sketch import bank, phases

    if backend == "crprecis":
        return []
    if variant == "unbiased":
        return loops_in(ref.unbiased_update_ref)
    evict, drain = loops_in(bank.residual_phase_banked)
    waterfill = loops_in(phases.waterfill_unit_inserts)
    return [evict, *waterfill] + ([drain] if variant == "sspm" else [])


@pytest.mark.parametrize("cell", RANGE_GRID, ids=_cell_id)
def test_ingest_grid_drives_every_loop_twice(ingest_grid, cell):
    """Each loop on the cell's path ran at least twice in the recorded
    data, by source site. The double variant's two banks take insert-only
    weights, so its drain loop only tests its condition (0 trips)."""
    _, an = ingest_grid[_cell_id(cell)]
    want = _expected_loops(cell["variant"], cell["backend"])
    for site in want:
        assert an.loops.get(site, 0) >= 2, (site, an.loops)
    drain = loops_in(__import__(
        "repro_torch.sketch.bank", fromlist=["x"]).residual_phase_banked)[1]
    for site, trips in an.loops.items():
        if site not in want:
            assert cell["variant"] == "double" and site == drain \
                and trips == 0, (site, trips)


def test_merge_wrap_free():
    from repro_torch.analysis.range_interp import analyze_merge

    fs = analyze_merge(k=32)
    assert fs == [], [f.render() for f in fs]


def test_crprecis_sharded_unregistered():
    from repro_torch.sketch.api import SketchSpec

    with pytest.raises(ValueError, match="not supported"):
        SketchSpec(kind="frequency", k=32, variant="sspm",
                   backend="crprecis", shards=4)


# ---------------------------------------------------------------------------
# SK202: sentinel flow
# ---------------------------------------------------------------------------

def _taint(fn, args, tainted):
    from repro_torch.analysis.sentinel_flow import taint_callable

    return taint_callable(fn, args, tainted)


def test_query_grid_clean():
    from repro_torch.analysis.sentinel_flow import analyze_query_grid

    fs = analyze_query_grid(k=32)
    assert fs == [], [f.render() for f in fs]


def test_seeded_unguarded_eq_flagged():
    def bad_query(ids, counts, items):
        hit = ids[None, :] == items[:, None]      # no ids >= 0 guard
        return torch.where(hit, counts[None, :], 0).sum(dim=1)

    fs = _taint(bad_query, (_z(16), _z(16), _z(4)), [True, False, True])
    assert rules_of(fs) == ["SK202"]


@pytest.mark.parametrize("spelling", ["ge", "gt", "flipped"])
def test_guarded_eq_clean(spelling):
    def good_query(ids, counts, items):
        guard = {"ge": ids >= 0, "gt": ids > -1,
                 "flipped": torch.le(torch.zeros((), dtype=I32), ids)}
        hit = (ids.to(I32)[None, :] == items[:, None]) \
            & guard[spelling][None, :]
        return torch.where(hit, counts[None, :], 0).sum(dim=1)

    assert _taint(good_query, (_z(16), _z(16), _z(4)),
                  [True, False, True]) == []


@pytest.mark.parametrize("const", ["number", "tensor"])
def test_sentinel_constant_compare_exempt(const):
    def count_empty(ids):
        c = -1 if const == "number" else torch.tensor(-1, dtype=I32)
        return (ids == c).sum()

    assert _taint(count_empty, (_z(16),), [True]) == []


# ---------------------------------------------------------------------------
# SK203: the recompile audit
# ---------------------------------------------------------------------------

def test_recompile_audit_matches_the_reference():
    from repro.analysis.recompile_audit import \
        audit_recompiles as ref_audit
    from repro_torch.analysis.recompile_audit import audit_recompiles

    findings, report = audit_recompiles(block=32, k=32, device="cpu")
    assert findings == [], [f.render() for f in findings]
    ref_findings, ref_report = ref_audit(block=32, k=32)
    assert ref_findings == []
    assert report["cells"] == ref_report["cells"] == report["entries"]
    assert report["grid"] == ref_report["grid"]
    assert report["cells"] < report["grid"]      # tenant cells collapsed
    assert report["graphs"] == 0                 # no CUDA graph on the CPU


def test_tenant_populations_share_one_cell():
    from repro_torch.sketch import session as sess
    from repro_torch.sketch.api import SketchSpec

    specs = [SketchSpec(kind="frequency", k=32, bits=8, variant="sspm",
                        backend="bank", tenants=t) for t in (1, 3, 5)]
    assert len({(sess.ingest_cache_spec(s), 32, True,
                 sess.mesh_layout(s)) for s in specs}) == 1


def test_distinct_layouts_do_not_collapse():
    from repro_torch.sketch import session as sess
    from repro_torch.sketch.api import SketchSpec

    a = SketchSpec(kind="frequency", k=32, variant="sspm", backend="bank")
    b = SketchSpec(kind="frequency", k=32, variant="lazy", backend="bank")
    assert sess.ingest_cache_spec(a) != sess.ingest_cache_spec(b)


def test_recompile_audit_flags_a_normalization_gap(monkeypatch):
    """Sessions whose compiled ingest skipped the normalization would give
    each tenant population a cell of its own: the audit says so."""
    from repro_torch.analysis.recompile_audit import audit_recompiles
    from repro_torch.sketch import session as sess

    monkeypatch.setattr(sess, "_ingest_fn", lambda spec, block, donate=True:
                        sess._ingest_fn_cached(spec, int(block),
                                               bool(donate),
                                               sess.mesh_layout(spec)))
    findings, report = audit_recompiles(block=32, k=32, device="cpu")
    assert rules_of(findings) == ["SK203"]
    assert report["entries"] == report["cells"] + 2   # T = 3, 5 apart
    assert "ingest_cache_spec" == findings[0].symbol


# ---------------------------------------------------------------------------
# SK204: the donation audit
# ---------------------------------------------------------------------------

def test_real_kernel_wrappers_clean():
    from repro_torch.analysis.donation_audit import audit_kernel_aliasing

    fs = audit_kernel_aliasing()
    assert fs == [], [f.render() for f in fs]


WRAPPER = textwrap.dedent("""
    def sketch_update_kernel_fused(ids, counts, errors, delta):
        named = dict(ids=ids, counts=counts, errors=errors, delta=delta)
        _launch(entry_point("f.cu", "f", 4, 0), {launch}, (), ids.device,
                "f")
        return {ret}
""")


@pytest.mark.parametrize("launch,ret,why", [
    ("[ids, counts, errors, delta]", "ids, counts, errors", None),
    ("[*named.values()]", "ids, counts, errors", None),
    ("[delta]", "ids, counts, errors", "drifted"),
    ("[counts, ids, errors, delta]", "ids, counts, errors", "drifted"),
    ("[torch.empty_like(ids), counts, errors, delta]", "ids, counts, errors",
     "drifted"),
    ("[ids, counts, errors, delta]", "counts, ids, errors", "not its"),
    ("[ids, counts, errors, delta]", "None", "does not return"),
])
def test_seeded_wrappers(tmp_path, launch, ret, why):
    from repro_torch.analysis.donation_audit import audit_kernel_aliasing

    p = tmp_path / "kernel.py"
    p.write_text(WRAPPER.format(launch=launch, ret=ret))
    fs = audit_kernel_aliasing(str(p))
    if why is None:
        assert fs == [], [f.render() for f in fs]
    else:
        assert rules_of(fs) == ["SK204"] and why in fs[0].message


def test_rebound_state_flagged(tmp_path):
    from repro_torch.analysis.donation_audit import audit_kernel_aliasing

    p = tmp_path / "kernel.py"
    p.write_text(textwrap.dedent("""
        def wrapper(ids, counts, errors):
            ids = ids.clone()
            _launch(fn, [ids, counts, errors], (), ids.device, "f")
            return ids, counts, errors
    """))
    fs = audit_kernel_aliasing(str(p))
    assert rules_of(fs) == ["SK204"] and "rebinds" in fs[0].message


def test_session_donation_matches_policy_on_the_cpu():
    from repro_torch.analysis.donation_audit import audit_session_donation
    from repro_torch.platform import donate_state_buffers

    findings, report = audit_session_donation(k=32, block=32, device="cpu")
    assert findings == [], [f.render() for f in findings]
    assert report["policy"] == donate_state_buffers()
    assert report["donate=True"] is False and report["donate=False"] is False
    assert not report["donate=True given state touched"]


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

BAD = "def q(ids, items):\n    return ids == items\n"


def _seeded_root(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "sketch"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(BAD)
    return tmp_path


def test_ast_layer_exits_zero_on_clean_tree():
    from repro_torch.analysis.__main__ import main

    assert main(["--layers", "ast", "--ci"]) == 0


def test_seeded_violation_exits_one(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    root = _seeded_root(tmp_path)
    rc = main(["--layers", "ast", "--root", str(root), "--ci",
               "--baseline", str(tmp_path / "baseline.json")])
    assert rc == 1
    assert "SK101" in capsys.readouterr().out


def test_json_report_shape(capsys):
    from repro_torch.analysis.__main__ import main

    rc = main(["--layers", "ast", "--json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == data["exit"] == 0
    assert set(data["counts"]) == {
        "SK101", "SK102", "SK103", "SK104",
        "SK201", "SK202", "SK203", "SK204"}


def test_unknown_layer_is_an_error():
    from repro_torch.analysis.__main__ import main

    with pytest.raises(SystemExit):
        main(["--layers", "nope"])


def test_write_baseline_refuses_zero_tolerance_rules(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    root = _seeded_root(tmp_path)
    base = tmp_path / "baseline.json"
    rc = main(["--layers", "ast", "--root", str(root),
               "--write-baseline", "--baseline", str(base)])
    assert rc == 1
    assert "REFUSED" in capsys.readouterr().out
    assert json.loads(base.read_text())["suppressed"] == []


def test_device_layers_raise_without_a_card():
    from repro_torch.analysis.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--layers", "recompile"])


def test_module_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--ci", "--json"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["layers"] == ["ast", "range", "sentinel", "recompile",
                              "donation"]
    assert data["new"] == [] and data["exit"] == 0
