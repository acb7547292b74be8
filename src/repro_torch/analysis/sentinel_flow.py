"""Layer 2b: sentinel-flow taint analysis over the query paths (SK202).

Counterpart of ``repro/analysis/sentinel_flow.py``, over the eager aten
trace of a query (``recorder``) instead of a jaxpr. It proves, for every
registered variant's ``query_many`` and for ``bank.query_rows``, that
values derived from stored slot ids (which may hold the EMPTY(-1) /
BLOCKED(-2) / POISON(-3) sentinels) never decide an equality whose
result escapes unguarded. An ``eq`` between an id-tainted value and a
probe item matches a sentinel slot whenever a deleted or padded probe id
(-1) meets an EMPTY slot, resurrecting that slot's garbage count into the
estimate; the port's idiom is ``(ids == item) & (ids >= 0)``.

The pass is a forward taint and a local consumer check:

* taint: the state's ``ids`` leaves and the probe items (and anything
  computed from them) are *sentinel-possible*. Positions and counts
  (``arange``, ``argmin``/``argmax``, ``cumsum``, ``searchsorted``, a
  sort's or reduction's indices) drop the taint.
* guards: ``ge(t, 0)``, ``gt(t, -1)`` and ``le(0, t)`` of a tainted
  ``t`` are *guard* booleans; guard-ness is closed under
  ``bitwise_and``, views, ``to`` and ``all``.
* check: every ``eq`` with a tainted operand must reach only ``and``
  chains that also hold a guard (through views, ``to`` and ``not``). An
  ``eq`` against a *negative literal* (``ids == EMPTY``) is deliberate
  sentinel arithmetic and exempt.

Everything else propagates taint conservatively; the pass errs toward
flagging.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .findings import Finding
from .range_interp import entry_name, named_leaves
from .recorder import VIEWS, Op, Ref, Trace, literal, record, site

# positions and counts: never a sentinel, whatever they were made from
_NONNEG = frozenset({"arange", "argmax", "argmin", "cumsum", "searchsorted",
                     "argsort", "bincount", "numel"})
# (values, indices) results: the indices are positions
_WITH_INDICES = frozenset({"sort", "topk", "min", "max", "cummin", "cummax",
                           "kthvalue", "mode", "median"})
_AND = frozenset({"bitwise_and", "logical_and", "__and__"})
_NOT = frozenset({"bitwise_not", "logical_not"})
_COMPARE = frozenset({"ge", "gt", "le", "lt"})


class _Taint:
    """Sentinel taint over one trace."""

    def __init__(self, entry: str):
        self.entry = entry
        self.findings: List[Finding] = []
        self._seen = set()

    def flag(self, op: Op, why: str):
        path, line = site(op, self.entry)
        if (path, line) in self._seen:
            return
        self._seen.add((path, line))
        self.findings.append(Finding(
            rule="SK202", path=path, line=line, symbol="eq",
            message=f"sentinel-possible equality escapes unguarded: {why}; "
                    f"conjoin an `(ids >= 0)` guard on the id operand"))

    def run(self, trace: Trace, in_tainted: Dict[str, bool]) -> set:
        """Taint the trace from its inputs, record findings; returns the
        tainted nodes."""
        tainted, guards = set(), set()
        uses: Dict[int, List[Op]] = {}
        for name, n in trace.inputs.items():
            if in_tainted.get(name):
                tainted.add(n)
        for op in trace.ops:
            for n in set(op.inputs):
                uses.setdefault(n, []).append(op)

        def arg(op, k):
            return op.args.get(k)

        def is_t(v) -> bool:
            return isinstance(v, Ref) and v.node in tainted

        def is_g(v) -> bool:
            return isinstance(v, Ref) and v.node in guards

        # pass 1: taint and guards
        for op in trace.ops:
            p = op.packet
            if not op.outs or p == "eq":
                continue
            if p in _COMPARE:
                a, b = arg(op, "self"), arg(op, "other")
                lb, la = literal(trace, b), literal(trace, a)
                if is_t(a) and lb is not None and (
                        p == "ge" and lb[0] >= 0 or p == "gt" and lb[0] >= -1):
                    guards.add(op.outs[0])       # ids >= 0, ids > -1
                if is_t(b) and la is not None and (
                        p == "le" and la[0] >= 0 or p == "lt" and la[0] >= -1):
                    guards.add(op.outs[0])       # 0 <= ids, -1 < ids
                continue
            if p in _AND:
                if any(is_g(v) for v in (arg(op, "self"), arg(op, "other"))):
                    guards.add(op.outs[0])
                continue
            if p == "all" or p in VIEWS:
                if is_g(arg(op, "self")):
                    guards.update(op.outs)
                if p != "all" and is_t(arg(op, "self")):
                    tainted.update(op.outs)
                continue
            if p in _NONNEG:
                continue
            if any(n in tainted for n in op.inputs):
                outs = op.outs[:1] if p in _WITH_INDICES else op.outs
                tainted.update(outs)

        def guarded_use(n: int, depth: int = 0) -> bool:
            """True if EVERY consumer path of n conjoins a guard."""
            if depth > 12:
                return False
            consumers = uses.get(n, [])
            if not consumers:
                return False  # escapes as an output unguarded
            for c in consumers:
                if c.packet in _AND:
                    other = [v for k, v in c.args.items()
                             if k in ("self", "other")
                             and not (isinstance(v, Ref) and v.node == n)]
                    if any(is_g(o) for o in other):
                        continue
                    if c.outs and guarded_use(c.outs[0], depth + 1):
                        continue
                    return False
                if c.packet in VIEWS or c.packet in _NOT:
                    if c.outs and guarded_use(c.outs[0], depth + 1):
                        continue
                    return False
                return False
            return True

        # pass 2: with taint and guards complete, audit every equality
        for op in trace.ops:
            if op.packet != "eq" or not op.outs:
                continue
            a, b = arg(op, "self"), arg(op, "other")
            for tside, other in ((a, b), (b, a)):
                if not is_t(tside):
                    continue
                lv = literal(trace, other)
                if lv is not None and lv[1] < 0:
                    break   # deliberate sentinel test (ids == EMPTY)
                if not guarded_use(op.outs[0]):
                    self.flag(op, "`eq` over an id-derived operand reaches "
                                  "a consumer with no `and`-conjoined "
                                  "non-negative guard")
                break
        return tainted


def taint_callable(fn, args: Sequence[torch.Tensor],
                   in_tainted: Sequence[bool],
                   entry: str = "fixture") -> List[Finding]:
    """Taint-check a call of ``fn`` on tensor arguments, the arguments
    marked tainted as ``in_tainted`` says (the test hook)."""
    names = {f"arg{i}": t for i, t in enumerate(args)}
    trace, _ = record(fn, names, *args)
    t = _Taint(entry)
    t.run(trace, {f"arg{i}": bool(x) for i, x in enumerate(in_tainted)})
    return t.findings


def _probe_items(n_items: int, rng) -> torch.Tensor:
    """Probe ids: live ids, unseen ids and the sentinels."""
    items = rng.integers(0, 400, n_items)
    items[: min(3, n_items)] = [-1, -2, -3][: min(3, n_items)]
    return torch.as_tensor(items.astype(np.int32))


def analyze_query(spec, n_items: int = 8, seed: int = 0) -> List[Finding]:
    """Taint-check one spec's ``query_many`` on a state that has taken a
    few blocks (on the CPU)."""
    from ..sketch import api

    ad = api.adapter_for(spec)
    state = ad.make(spec, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    for _ in range(2):
        items = torch.as_tensor(rng.integers(0, 400, 64).astype(np.int32))
        weights = torch.as_tensor(rng.integers(-2, 5, 64).astype(np.int32))
        state = ad.update(spec, state, items, weights)
    items = _probe_items(n_items, rng)
    inputs = dict(named_leaves(state))
    inputs["items"] = items
    trace, _ = record(ad.query_many, inputs, spec, state, items)
    tainted = {name: "ids" in name.lower() for name in inputs}
    tainted["items"] = True   # probe items may be negative
    t = _Taint(entry_name("query", spec))
    t.run(trace, tainted)
    return t.findings


def analyze_query_rows(k: int = 64, rows: int = 4, n_items: int = 8,
                       seed: int = 0) -> List[Finding]:
    """Taint-check the bank row-query surface (``bank.query_rows``)."""
    from ..sketch import bank as bank_mod

    rng = np.random.default_rng(seed)
    state = bank_mod.init(k, rows, device="cpu")
    ids = state.ids.clone()
    ids[:, : k // 2] = torch.as_tensor(
        rng.integers(0, 400, (rows, k // 2)).astype(np.int32))
    state = bank_mod.SketchState(ids, state.counts, state.errors)
    row_ix = torch.as_tensor(rng.integers(0, rows, n_items).astype(np.int32))
    items = _probe_items(n_items, rng)
    inputs = dict(ids=state.ids, counts=state.counts, errors=state.errors,
                  rows=row_ix, items=items)
    trace, _ = record(bank_mod.query_rows, inputs, state, row_ix, items)
    t = _Taint("query_rows[bank]")
    t.run(trace, dict(ids=True, items=True))
    return t.findings


DEFAULT_GRID = (
    dict(variant="sspm", backend="bank"),
    dict(variant="lazy", backend="bank"),
    dict(variant="double", backend="bank"),
    dict(variant="unbiased", backend="bank"),
    dict(variant="sspm", backend="crprecis"),
)


def analyze_query_grid(k: int = 64, grid=DEFAULT_GRID) -> List[Finding]:
    from ..sketch import api

    out: List[Finding] = []
    for cell in grid:
        spec = api.SketchSpec(kind="frequency", k=k, **cell)
        out.extend(analyze_query(spec))
    out.extend(analyze_query_rows(k=k))
    seen, uniq = set(), []
    for f in out:
        key = (f.rule, f.path, f.line)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


__all__ = ["taint_callable", "analyze_query", "analyze_query_rows",
           "DEFAULT_GRID", "analyze_query_grid"]
