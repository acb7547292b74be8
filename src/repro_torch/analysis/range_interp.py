"""Layer 2a: an int32 value-range abstract interpreter over eager aten
traces (SK201).

Counterpart of ``repro/analysis/range_interp.py``. The reference traces
the ingest entry points to jaxprs; the port's ingest runs its loops on the
host, which no graph tracer gets past, so this pass reads the trace of
one eager CPU run (``recorder.Recorder``: every aten op with its inputs,
outputs and Python source site) of the adapter's ``update``. It
propagates the ``validate_block`` preconditions through the trace as
intervals and flags any signed add/sub/mul (and the reductions that add)
whose result interval can leave its dtype. The invariant under proof is
the reference's: *counters never wrap*: every count/error accumulation
either stays bounded by plain interval arithmetic or goes through the
saturating ``sat_add``.

The CUDA kernels are ctypes launches that no dispatch mode sees, so the
pass always traces the CPU path: the kernels' plain versions
(``kernels/sketch_update/ref.py``), which the port holds equal to the
kernels on the card. The reference's CPU jaxprs likewise hold no
``pallas_call``: both packages analyze the plain path.

Abstract domain: the reference's :class:`Ival`, an integer interval plus
three relational refinements (``wtag``: elements are signed sums of
disjoint subsets of the block's weights, so within [-W, W] however they
are segment-summed or permuted; ``psrc``: prefix sums of one cumsum, whose
differences are range sums; ``rsum``: each element a contiguous-range
weight sum), with the reference's transfer rules, written for aten ops
(a gather, an ``index`` or an ``expand`` may duplicate elements and drops
``wtag``; a view keeps every tag).

Scope: results of dtype int8, int16 and int32 are checked. int64 results
are propagated but never flagged: the port computes in int64 only where
the reference computes in uint32 (the lowbias32 hashes, which wrap past
2**63 by design and are masked to 32 bits) or indexes, and the reference,
with x64 off, has no int64 to check. ``state.wrap_add`` is the port's
spelling of a wrapping int32 add; the pass reads it as that add
(``remainder(x + 2**31, 2**32)`` of an int64 ``x``) and flags it where
``x`` can leave int32.

Relational patterns recognized on top of intervals:

* **sat_add**, in both of ``state.sat_add``'s spellings: the tensor
  branch ``a + minimum(maximum(b, lo), hi)`` and the Python-number branch
  ``a + minimum(clamp(lo, min=b), hi)``, with ``lo = -IMAX - clamp(a,
  max=0)`` and ``hi = IMAX - clamp(a, min=0)``. The matcher proves the
  result lies in [-IMAX, IMAX].
* **guarded increment**: ``i + (i < n).to(...)`` (``& ...``) stays in
  [i.lo, max(i.hi, n.hi)] (the lockstep loops' ``i + active``).
* **host guards**: a host read of a one-element comparison (``while
  bool(i < n)``) bounds that operand for every later op that reads it.

Loops: the trace holds each loop body once per iteration, and an
unrolled trace proves only the iterations it saw. An op that recurs at
the same key (``recorder``: the same op at the same place of the same
loop body) and whose result at iteration t+1 is not inside its result at
iteration t, while depending on it, belongs to a value carried round the
loop that grows. The carried operands are then widened to their dtype's
range (narrowed by any host guard on them), as the reference's ``_while``
fixpoint widens an unstable carry, and the op is checked again on them: a
``sat_add``-shaped add or a guarded increment stays in range, any other
add is flagged. So every loop must run at least twice in the traced data
(``loop_trips`` says how often each ran).

Host reads: a Python number that enters an op after a host read
(``int(n.max())``, a loop counter) cannot be told from a literal by a
dispatch mode. The entry points record the call twice, on different
data, and a scalar argument is taken as a literal only where it had one
value at its op's key over both runs (and over every iteration of a
loop); any other scalar gets its dtype's range. A constant lifted into
the call (``torch.tensor(data)``) is treated the same way by its values.
What the recorded runs did not execute (a branch neither took) is not
analyzed.

Everything else is sound-but-conservative: unknown ops return the full
range of their dtype and are never flagged themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .findings import Finding
from .recorder import Op, Ref, Trace, literal, loop_trips, record, site

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
IMAX = 2**31 - 1
# "infinite" bounds for unknown values (finite, so interval arithmetic
# stays in Python ints)
BIG = 2**127

_CHECKED = (torch.int8, torch.int16, torch.int32)


@dataclasses.dataclass(frozen=True)
class Ival:
    """Interval plus three relational refinements (the reference's):

    * ``wtag``: elements are signed sums of MUTUALLY DISJOINT subsets of
      the validated block's weights (|block weight sum| <= W), so any
      further disjoint aggregation stays in [-W, W]. Dropped where
      elements may be duplicated and by adding two wtag values.
    * ``psrc``: the id of the cumsum this value's elements are prefix
      sums of (or 0); ``sub`` of two same-psrc values is a
      contiguous-range weight sum, bounded [-W, W].
    * ``rsum``: each element is a signed contiguous-range sum of one
      ordering of the block weights (each in [-W, W]); summing range
      sums back up uses the reference's assumption D1 (the sketch sums
      range sums only at segment-head positions, which are disjoint).
    """
    lo: int
    hi: int
    wtag: bool = False
    psrc: int = 0
    rsum: bool = False

    def join(self, other: "Ival") -> "Ival":
        return Ival(min(self.lo, other.lo), max(self.hi, other.hi),
                    self.wtag and other.wtag,
                    self.psrc if self.psrc == other.psrc else 0,
                    self.rsum and other.rsum)

    def contains(self, other: "Ival") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    @property
    def is_zero(self) -> bool:
        return self.lo == 0 and self.hi == 0

    def untagged(self) -> "Ival":
        return Ival(self.lo, self.hi)


def dtype_ival(dtype: torch.dtype) -> Ival:
    if dtype == torch.bool:
        return Ival(0, 1)
    if dtype.is_floating_point or dtype.is_complex:
        return Ival(-BIG, BIG)
    info = torch.iinfo(dtype)
    return Ival(int(info.min), int(info.max))


def _tdiv(x: int, y: int) -> int:
    """Truncate-toward-zero integer division."""
    q = abs(x) // abs(y)
    return q if (x >= 0) == (y >= 0) else -q


_SHAPE = frozenset({
    "unsqueeze", "squeeze", "view", "_unsafe_view", "alias", "detach",
    "clone", "slice", "select", "flip", "permute", "transpose", "t",
    "contiguous", "narrow", "reshape", "_reshape_alias", "split", "unbind",
    "chunk", "split_with_sizes", "unfold", "movedim", "diagonal",
})
_DUPLICATING = frozenset({"expand", "repeat", "as_strided", "index",
                          "gather", "index_select", "take",
                          "repeat_interleave", "broadcast_to",
                          "expand_copy"})
_BOOL_OUT = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "any", "all", "logical_and",
    "logical_or", "logical_xor", "logical_not", "isnan", "isinf",
    "isfinite", "isin", "equal",
})
# ops whose result is an accumulation: the overflow sites
_ARITH = frozenset({"add", "sub", "rsub", "mul", "cumsum", "sum",
                    "index_add", "index_add_", "scatter_add",
                    "scatter_add_", "__lshift__", "bitwise_left_shift",
                    "pow", "index_put", "index_put_", "prod"})
# ops whose result equals their input (the matchers see through them)
_SKIP = frozenset({"unsqueeze", "squeeze", "view", "_unsafe_view", "alias",
                   "detach", "expand", "_to_copy", "clone", "contiguous"})


def _out_dtype(trace: Trace, op: Op) -> Optional[torch.dtype]:
    return trace.nodes[op.outs[0]].dtype if op.outs else None


def _scalar_table(traces: Iterable[Trace]) -> Dict[Tuple, set]:
    """Every scalar argument's values at its op's key, over all traces."""
    table: Dict[Tuple, set] = {}

    def walk(key, v):
        if isinstance(v, list):
            for i, x in enumerate(v):
                walk(key + (i,), x)
        elif isinstance(v, (bool, int, float)):
            table.setdefault(key, set()).add(v)

    for trace in traces:
        for op in trace.ops:
            for name, v in op.args.items():
                walk((_scalar_key(op), name), v)
            if op.packet in ("lift_fresh", "lift_fresh_copy"):
                ref = op.args.get("self")
                const = (trace.nodes[ref.node].const
                         if isinstance(ref, Ref) else None)
                table.setdefault((_scalar_key(op), "const"), set()).add(
                    const)
    return table


# ops that wrap a Python number into a tensor: one call may make several
# (``where(c, 1, 2)``), told apart by their order
_WRAPS = frozenset({"scalar_tensor", "full", "lift_fresh", "lift_fresh_copy"})


def _scalar_key(op: Op) -> Tuple:
    return (op.key, op.ordinal) if op.packet in _WRAPS else op.key


class _Analyzer:
    """One abstract interpretation of one trace."""

    def __init__(self, entry: str, wsum: int = IMAX,
                 scalars: Optional[Dict[Tuple, set]] = None):
        self.entry = entry
        self.wsum = min(int(wsum), IMAX)
        self.scalars = scalars or {}
        self.findings: List[Finding] = []
        self._seen_sites = set()
        self.unknown_ops = set()
        self.loops: Dict[Tuple[str, int], int] = {}

    # -- findings ---------------------------------------------------------
    def flag(self, op: Op, res: Ival, lo: int, hi: int, carried: bool):
        path, line = site(op, self.entry)
        key = (path, line, op.packet)
        if key in self._seen_sites:
            return
        self._seen_sites.add(key)
        how = ("with the value it carries round a loop widened to its "
               "dtype's range (it grows from one iteration to the next)"
               if carried else "under the validate_block preconditions")
        self.findings.append(Finding(
            rule="SK201", path=path, line=line, symbol=op.packet,
            message=f"`{op.packet}` on signed int can reach "
                    f"[{res.lo}, {res.hi}] outside [{lo}, {hi}] {how}; "
                    f"route it through sat_add or bound the operands"))

    def _check(self, op: Op, res: Ival, dtype=None) -> Ival:
        """Flag a result leaving its signed-int dtype (int8-int32); clamp
        so the analysis continues from the concrete envelope."""
        dtype = dtype or _out_dtype(self.trace, op)
        if dtype is None or dtype.is_floating_point or dtype == torch.bool:
            return res
        lim = dtype_ival(dtype)
        if res.lo < lim.lo or res.hi > lim.hi:
            if self._report and dtype in _CHECKED:
                self.flag(op, res, lim.lo, lim.hi, self._carried)
            return lim
        return res

    # -- reading arguments ------------------------------------------------
    def _scalar(self, op: Op, key: Tuple, v, dtype) -> Ival:
        if isinstance(v, float) and not float(v).is_integer():
            return Ival(-BIG, BIG)
        seen = self.scalars.get((_scalar_key(op),) + key, {v})
        if len(seen) == 1:
            return Ival(int(v), int(v))
        # a host read or a loop counter: any value of the op's dtype
        return dtype_ival(dtype) if dtype is not None else Ival(-BIG, BIG)

    def _node_ival(self, n: int) -> Ival:
        iv = self.env.get(n)
        if iv is None:
            iv = dtype_ival(self.trace.nodes[n].dtype)
        return iv

    def iv(self, op: Op, name: str):
        v = op.args.get(name)
        dtype = _out_dtype(self.trace, op)
        if isinstance(v, Ref):
            return self._node_ival(v.node)
        if isinstance(v, list):
            return [self._node_ival(x.node) if isinstance(x, Ref)
                    else None if x is None
                    else self._scalar(op, (name, i), x, dtype)
                    for i, x in enumerate(v)]
        if v is None:
            return None
        if isinstance(v, (bool, int, float)):
            return self._scalar(op, (name,), v, dtype)
        return None

    def _producer(self, v) -> Optional[Op]:
        if not isinstance(v, Ref):
            return None
        return self.trace.producer(v.node)

    def _skip(self, v):
        """The value ``v`` was made from, through ops that keep it."""
        while isinstance(v, Ref):
            d = self.trace.producer(v.node)
            if d is None or d.packet not in _SKIP or "self" not in d.args:
                return v
            v = d.args["self"]
        return v

    def _same(self, x, a) -> bool:
        x, a = self._skip(x), self._skip(a)
        return isinstance(x, Ref) and isinstance(a, Ref) and x.node == a.node

    # -- pattern: sat_add -------------------------------------------------
    def _headroom(self, v, a, kind: str, const: int) -> bool:
        """Is ``v`` = const - (clamp(a, max=0) | clamp(a, min=0))?"""
        d = self._producer(self._skip(v))
        if d is None or d.args.get("alpha", 1) != 1:
            return False
        if d.packet == "rsub":
            m, c = d.args.get("self"), d.args.get("other")
        elif d.packet == "sub":
            c, m = d.args.get("self"), d.args.get("other")
        else:
            return False
        if self._literal(c) != const:
            return False
        dm = self._producer(self._skip(m))
        if dm is None:
            return False
        # min(a, 0) for the low headroom, max(a, 0) for the high one
        bound, free = ("max", "min") if kind == "min" else ("min", "max")
        if dm.packet in ("clamp", "clamp_" + bound):
            return (dm.args.get(free) is None
                    and self._literal(dm.args.get(bound)) == 0
                    and self._same(dm.args.get("self"), a))
        if dm.packet == ("minimum" if kind == "min" else "maximum"):
            x, z = dm.args.get("self"), dm.args.get("other")
            return any(self._literal(z_) == 0 and self._same(x_, a)
                       for x_, z_ in ((x, z), (z, x)))
        return False

    def _literal(self, v) -> Optional[int]:
        """The value of an integer literal operand (``recorder.literal``)."""
        lit = literal(self.trace, v)
        if lit is None or lit[0] != lit[1] or isinstance(lit[0], float):
            return None
        return lit[0]

    def _matches_sat_add(self, op: Op) -> bool:
        """add(a, g), g = minimum(maximum(b, lo) | clamp(lo, min=b), hi),
        lo = -IMAX - clamp(a, max=0), hi = IMAX - clamp(a, min=0)."""
        x, y = op.args.get("self"), op.args.get("other")
        if op.args.get("alpha", 1) != 1:
            return False
        for a, g in ((x, y), (y, x)):
            d = self._producer(g)
            if d is None or d.packet != "minimum":
                continue
            for inner, hi_v in ((d.args["self"], d.args["other"]),
                                (d.args["other"], d.args["self"])):
                di = self._producer(inner)
                if di is None:
                    continue
                if di.packet == "maximum":
                    cands = (di.args["self"], di.args["other"])
                elif di.packet in ("clamp", "clamp_min") \
                        and di.args.get("max") is None:
                    cands = (di.args["self"],)
                else:
                    continue
                if self._headroom(hi_v, a, "max", IMAX) and any(
                        self._headroom(lo_v, a, "min", -IMAX)
                        for lo_v in cands):
                    return True
        return False

    def _matches_guarded_inc(self, op: Op) -> Optional[Ival]:
        """add(i, cast(i < n [& ...])): a counter that freezes at its
        bound stays in [i.lo, max(i.hi, n.hi)]."""
        x, y = op.args.get("self"), op.args.get("other")
        for a, g in ((x, y), (y, x)):
            d = self._producer(self._skip(g))
            if d is None:
                continue
            if d.packet in ("bitwise_and", "logical_and", "mul"):
                ds = [self._producer(self._skip(d.args.get(k)))
                      for k in ("self", "other")]
                d = next((e for e in ds
                          if e is not None and e.packet == "lt"), None)
                if d is None:
                    continue
            if d.packet != "lt" or not self._same(d.args.get("self"), a):
                continue
            n = d.args.get("other")
            n_iv = (self._node_ival(self._skip(n).node) if isinstance(n, Ref)
                    else self._scalar(d, ("other",), n, None)
                    if n is not None else None)
            if n_iv is None:
                continue
            a_iv = self._node_ival(a.node) if isinstance(a, Ref) else None
            if a_iv is None:
                continue
            return Ival(a_iv.lo, max(a_iv.hi, n_iv.hi))
        return None

    @staticmethod
    def _join_inert(cases: Sequence[Ival]) -> Ival:
        """Join where a literally-zero case is inert for every tag."""
        cases = [c for c in cases if c is not None]
        res = cases[0]
        for c in cases[1:]:
            res = Ival(min(res.lo, c.lo), max(res.hi, c.hi))
        live = [c for c in cases if not c.is_zero]
        if not live:
            return Ival(res.lo, res.hi)
        psrcs = {c.psrc for c in live}
        return dataclasses.replace(
            res, wtag=all(c.wtag for c in live),
            psrc=psrcs.pop() if len(psrcs) == 1 else 0,
            rsum=all(c.rsum for c in live))

    # -- host guards --------------------------------------------------------
    def _refine(self, n: int, truth: bool, depth: int = 0) -> None:
        """Record what a host read's answer says about the values that
        made a one-element boolean."""
        d = self.trace.producer(n)
        if d is None or depth > 8 or self.trace.nodes[n].numel != 1:
            return
        p = d.packet
        if p in ("lt", "le", "gt", "ge"):
            a, b = d.args.get("self"), d.args.get("other")
            if not truth:
                p = {"lt": "ge", "le": "gt", "gt": "le", "ge": "lt"}[p]
            b_iv = (self._node_ival(b.node) if isinstance(b, Ref)
                    else self._scalar(d, ("other",), b, None))
            if isinstance(a, Ref):
                self._fact(a.node, p, b_iv)
            if isinstance(b, Ref):
                a_iv = self._node_ival(a.node)
                flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}[p]
                self._fact(b.node, flip, a_iv)
        elif p in ("bitwise_and", "logical_and") and truth or \
                p in ("bitwise_or", "logical_or") and not truth:
            for k in ("self", "other"):
                v = d.args.get(k)
                if isinstance(v, Ref):
                    self._refine(v.node, truth, depth + 1)
        elif p in ("bitwise_not", "logical_not"):
            self._refine(d.args["self"].node, not truth, depth + 1)
        elif p in ("any", "all", "_to_copy") or p in _SHAPE:
            v = d.args.get("self")
            if isinstance(v, Ref):
                self._refine(v.node, truth, depth + 1)

    def _fact(self, n: int, rel: str, bound: Ival) -> None:
        self.facts.setdefault(n, []).append((rel, bound))
        self.env[n] = self._apply_facts(self._node_ival(n), n)

    def _apply_facts(self, iv: Ival, n: int) -> Ival:
        for rel, b in self.facts.get(n, ()):
            lo, hi = iv.lo, iv.hi
            if rel == "lt":
                hi = min(hi, b.hi - 1)
            elif rel == "le":
                hi = min(hi, b.hi)
            elif rel == "gt":
                lo = max(lo, b.lo + 1)
            elif rel == "ge":
                lo = max(lo, b.lo)
            if lo <= hi:
                iv = dataclasses.replace(iv, lo=lo, hi=hi)
        return iv

    # -- loops ----------------------------------------------------------------
    def _depends(self, start: List[int], target: int, after: int) -> set:
        """The nodes of ``start`` whose value was made from ``target``
        (through ops after op ``after``)."""
        memo: Dict[int, bool] = {}

        def reaches(n: int) -> bool:
            stack, seen = [n], set()
            while stack:
                m = stack.pop()
                if m == target:
                    return True
                if m in seen:
                    continue
                seen.add(m)
                d = self.trace.defs.get(m)
                if d is None or d <= after:
                    continue
                stack.extend(self.trace.ops[d].inputs)
            return False

        out = set()
        for n in start:
            if n not in memo:
                memo[n] = reaches(n)
            if memo[n]:
                out.add(n)
        return out

    # -- the walk -------------------------------------------------------------
    def run(self, trace: Trace, in_ivals: Dict[str, Ival],
            report: bool = True) -> Dict[int, Ival]:
        self.trace = trace
        self.env: Dict[int, Ival] = {}
        self.facts: Dict[int, list] = {}
        self._report = report
        self._carried = False
        for name, n in trace.inputs.items():
            self.env[n] = in_ivals.get(name, dtype_ival(trace.nodes[n].dtype))
        last: Dict[Tuple, Tuple[int, int, Ival]] = {}
        for op in trace.ops:
            outs = self._op(op)
            for n, iv in zip(op.outs, outs):
                self.env[n] = iv
            if op.packet in _ARITH and op.outs and outs:
                prev = last.get(op.key)
                if prev is not None and not prev[2].contains(outs[0]) \
                        and self._depends(op.inputs, prev[1], prev[0]):
                    self._widen(prev[0], prev[1], op.index)
                last[op.key] = (op.index, op.outs[0], self.env[op.outs[0]])
        return self.env

    def _widen(self, first: int, carry: int, last: int) -> None:
        """A value carried round a loop grows: give ``carry`` (the op's
        result one iteration back) its dtype's range, narrowed by the host
        guards on it, and evaluate again every op after it up to ``last``
        that it reaches, reporting what leaves its range then."""
        self.env[carry] = self._apply_facts(
            dtype_ival(self.trace.nodes[carry].dtype), carry)
        cone = {carry}
        self._carried = True
        try:
            for op in self.trace.ops[first + 1:last + 1]:
                if not cone.intersection(op.inputs):
                    continue
                for n, iv in zip(op.outs, self._op(op)):
                    self.env[n] = iv
                    cone.add(n)
        finally:
            self._carried = False

    # -- the transfer functions ---------------------------------------------
    def _op(self, op: Op) -> List[Ival]:
        p, W = op.packet, self.wsum
        dtype = _out_dtype(self.trace, op)

        def outs_range():
            return [dtype_ival(self.trace.nodes[n].dtype) for n in op.outs]

        if p in ("_local_scalar_dense", "is_nonzero"):
            v = op.args.get("self")
            if isinstance(v, Ref) and isinstance(op.value, (bool, int)):
                self._refine(v.node, bool(op.value))
            return []
        if not op.outs:
            return []
        if dtype is not None and (dtype.is_floating_point or dtype.is_complex):
            return outs_range()
        if p in _BOOL_OUT:
            return [Ival(0, 1)] * len(op.outs)

        if p == "add":
            a, b = self.iv(op, "self"), self.iv(op, "other")
            alpha = op.args.get("alpha", 1)
            if alpha != 1:
                b = self._mul(b, Ival(alpha, alpha))
            if self._matches_sat_add(op):
                return [Ival(max(-IMAX, a.lo + b.lo), min(IMAX, a.hi + b.hi))]
            inc = self._matches_guarded_inc(op)
            if inc is not None:
                # i < n <= the dtype's max: i + 1 never passes it
                return [Ival(inc.lo, min(inc.hi, dtype_ival(dtype).hi))]
            return [self._check(op, Ival(a.lo + b.lo, a.hi + b.hi))]
        if p in ("sub", "rsub"):
            a, b = self.iv(op, "self"), self.iv(op, "other")
            if p == "rsub":
                a, b = b, a
            alpha = op.args.get("alpha", 1)
            if alpha != 1:
                b = self._mul(b, Ival(alpha, alpha))
            if a.psrc and a.psrc == b.psrc:
                return [Ival(-W, W, rsum=True)]
            return [self._check(op, Ival(a.lo - b.hi, a.hi - b.lo))]
        if p == "mul":
            a, b = self.iv(op, "self"), self.iv(op, "other")
            res = self._check(op, self._mul(a, b))
            if a.wtag or a.rsum or a.psrc:
                a, b = b, a
            if 0 <= a.lo and a.hi <= 1:
                return [dataclasses.replace(res, wtag=b.wtag, psrc=b.psrc,
                                            rsum=b.rsum)]
            return [res]
        if p == "neg":
            a = self.iv(op, "self")
            return [Ival(-a.hi, -a.lo, a.wtag, 0, a.rsum)]
        if p in ("maximum", "minimum", "max", "min", "fmax", "fmin") \
                and isinstance(op.args.get("other"), Ref):
            a, b = self.iv(op, "self"), self.iv(op, "other")
            f = max if p in ("maximum", "max", "fmax") else min
            res = Ival(f(a.lo, b.lo), f(a.hi, b.hi))
            if b.is_zero or a.is_zero:
                keep = a if b.is_zero else b
                return [dataclasses.replace(res, wtag=keep.wtag,
                                            psrc=keep.psrc, rsum=keep.rsum)]
            return [dataclasses.replace(
                res, wtag=a.wtag and b.wtag,
                psrc=a.psrc if a.psrc == b.psrc else 0,
                rsum=a.rsum and b.rsum)]
        if p in ("clamp", "clamp_min", "clamp_max"):
            x = self.iv(op, "self")
            lo_i = self.iv(op, "min") if p != "clamp_max" else None
            hi_i = self.iv(op, "max") if p != "clamp_min" else None
            lo, hi = x.lo, x.hi
            if lo_i is not None:
                lo, hi = max(lo, lo_i.lo), max(hi, lo_i.hi)
            if hi_i is not None:
                lo, hi = min(lo, hi_i.lo), min(hi, hi_i.hi)
            return [Ival(lo, hi, x.wtag, x.psrc, x.rsum)]
        if p in ("sign", "sgn"):
            return [Ival(-1, 1)]
        if p == "abs":
            a = self.iv(op, "self")
            lo = 0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
            return [self._check(op, Ival(lo, max(abs(a.lo), abs(a.hi)),
                                         a.wtag, 0, a.rsum))]
        if p in ("div", "floor_divide"):
            mode = op.args.get("rounding_mode") if p == "div" else "floor"
            a, b = self.iv(op, "self"), self.iv(op, "other")
            if b.lo > 0 or b.hi < 0:
                fn = _tdiv if mode == "trunc" else (lambda x, y: x // y)
                cands = [fn(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
                return [self._check(op, Ival(min(cands), max(cands)))]
            m = max(abs(a.lo), abs(a.hi))
            return [self._check(op, Ival(-m, m))]
        if p in ("remainder", "fmod"):
            a, b = self.iv(op, "self"), self.iv(op, "other")
            if p == "remainder":
                wrapped = self._wrap_add_operand(op, b)
                if wrapped is not None:
                    self._check(op, wrapped, torch.int32)
            if p == "remainder" and b.lo > 0:
                return [Ival(0, b.hi - 1)]
            if p == "remainder" and b.hi < 0:
                return [Ival(b.lo + 1, 0)]
            m = max(abs(b.lo), abs(b.hi), 1) - 1
            m = min(m, max(abs(a.lo), abs(a.hi)))
            return [Ival(-m, m)]
        if p in ("bitwise_and", "bitwise_or", "bitwise_xor", "__and__",
                 "__or__", "__xor__"):
            if dtype == torch.bool:
                return [Ival(0, 1)]
            a, b = self.iv(op, "self"), self.iv(op, "other")
            if p in ("bitwise_and", "__and__"):
                nonneg = [x.hi for x in (a, b) if x.lo >= 0]
                if nonneg:
                    return [Ival(0, min(nonneg))]
            return outs_range()
        if p == "bitwise_not":
            if dtype == torch.bool:
                return [Ival(0, 1)]
            a = self.iv(op, "self")
            return [Ival(-a.hi - 1, -a.lo - 1)]
        if p in ("__lshift__", "bitwise_left_shift"):
            a, b = self.iv(op, "self"), self.iv(op, "other")
            s_lo, s_hi = min(max(b.lo, 0), 63), min(max(b.hi, 0), 63)
            cands = [a.lo << s_lo, a.lo << s_hi, a.hi << s_lo, a.hi << s_hi]
            return [self._check(op, Ival(min(cands), max(cands)))]
        if p in ("__rshift__", "bitwise_right_shift"):
            a, b = self.iv(op, "self"), self.iv(op, "other")
            cands = [x >> s for x in (a.lo, a.hi)
                     for s in (max(b.lo, 0), min(max(b.hi, 0), 63))]
            return [Ival(min(cands), max(cands))]
        if p == "pow":
            a, y = self.iv(op, "self"), op.args.get("exponent")
            if not isinstance(y, int) or y < 0:
                return outs_range()
            cands = [a.lo ** y, a.hi ** y] + ([0] if a.lo <= 0 <= a.hi
                                              else [])
            return [self._check(op, Ival(min(cands), max(cands)))]
        if p == "cumsum":
            a = self.iv(op, "self")
            if a.wtag:
                return [Ival(-W, W, False, id(op), True)]
            if a.rsum:
                return [Ival(-W, W, False, id(op), False)]
            n = self._dim_size(op)
            return [self._check(op, Ival(min(a.lo * n, 0) if a.lo < 0
                                         else a.lo,
                                         max(a.hi * n, 0) if a.hi > 0
                                         else a.hi))]
        if p in ("sum", "prod"):
            a = self.iv(op, "self")
            if p == "sum" and (a.wtag or a.rsum):
                return [Ival(-W, W, True)]
            n = self._reduction_size(op)
            if p == "prod":
                m = max(abs(a.lo), abs(a.hi)) ** max(n, 1)
                return [self._check(op, Ival(-m, m))]
            return [self._check(op, Ival(min(a.lo * n, 0) if a.lo < 0
                                         else a.lo,
                                         max(a.hi * n, 0) if a.hi > 0
                                         else a.hi))]
        if p in ("min", "max", "amin", "amax", "cummin", "cummax"):
            a = self.iv(op, "self")
            vals = Ival(a.lo, a.hi, a.wtag, a.psrc, a.rsum)
            if len(op.outs) == 2:
                return [vals, Ival(0, max(self._dim_size(op) - 1, 0))]
            return [vals]
        if p in ("argmin", "argmax"):
            return [Ival(0, max(self._dim_size(op) - 1, 0))]
        if p in ("sort", "topk", "kthvalue", "msort"):
            a = self.iv(op, "self")
            return [a, Ival(0, max(self._dim_size(op) - 1, 0))][:len(op.outs)]
        if p == "searchsorted":
            seq = op.args.get("sorted_sequence")
            n = self.trace.nodes[seq.node].shape[-1] if isinstance(
                seq, Ref) else 0
            return [Ival(0, n)]
        if p == "arange":
            start = op.args.get("start", 0)
            end = op.args.get("end")
            step = op.args.get("step", 1)
            if end is None:
                start, end = 0, start
            ivs = [self._scalar(op, (k,), v, dtype)
                   for k, v in (("start", start), ("end", end))]
            lo, hi = ivs[0].lo, ivs[1].hi - 1 if (step or 1) > 0 else ivs[1].lo
            return [Ival(min(lo, hi), max(lo, hi))]
        if p == "scalar_tensor":
            return [self.iv(op, "s")]
        if p in ("full", "full_like", "new_full", "fill"):
            v = self.iv(op, "fill_value" if "fill_value" in op.args
                        else "value")
            return [v if isinstance(v, Ival) else outs_range()[0]]
        if p in ("zeros", "zeros_like", "new_zeros", "zero"):
            return [Ival(0, 0)]
        if p in ("ones", "ones_like", "new_ones"):
            return [Ival(1, 1)]
        if p in ("empty", "empty_like", "new_empty", "empty_strided"):
            return outs_range()
        if p in ("lift_fresh", "lift_fresh_copy"):
            ref = op.args.get("self")
            const = self.trace.nodes[ref.node].const
            if const is not None and len(self.scalars.get(
                    (_scalar_key(op), "const"), {const})) == 1:
                return [Ival(int(const[0]), int(const[1]))]
            return outs_range()
        if p in _SHAPE:
            a = self.iv(op, "self")
            return [a] * len(op.outs)
        if p in _DUPLICATING:
            a = self.iv(op, "self")
            return [dataclasses.replace(a, wtag=False)] * len(op.outs)
        if p == "_to_copy":
            a = self.iv(op, "self")
            tgt = dtype_ival(dtype)
            return [a if tgt.contains(a) else tgt]
        if p in ("copy", "copy_"):
            src = self.iv(op, "src")
            tgt = dtype_ival(dtype)
            return [src if tgt.contains(src) else tgt]
        if p in ("where",):
            return [self._join_inert([self.iv(op, "self"),
                                      self.iv(op, "other")])]
        if p in ("masked_fill", "masked_fill_"):
            return [self._join_inert([self.iv(op, "self"),
                                      self.iv(op, "value")])]
        if p in ("cat", "stack", "hstack", "vstack"):
            return [self._join_inert(self.iv(op, "tensors"))]
        if p == "alias_write":
            a, b = self.iv(op, "self"), self.iv(op, "src")
            return [a.join(b).untagged()]
        if p in ("scatter", "scatter_"):
            a = self.iv(op, "self")
            src = self.iv(op, "src") if "src" in op.args else self.iv(
                op, "value")
            return [self._join_inert([a, src])]
        if p in ("index_put", "index_put_"):
            a, upd = self.iv(op, "self"), self.iv(op, "values")
            if op.args.get("accumulate"):
                return [self._scatter_add(op, a, upd, self._numel("values",
                                                                  op))]
            res = a.join(upd)
            return [dataclasses.replace(res, wtag=a.wtag and upd.wtag)]
        if p in ("index_add", "index_add_", "scatter_add", "scatter_add_"):
            a = self.iv(op, "self")
            key = "source" if "source" in op.args else "src"
            upd = self.iv(op, key)
            alpha = op.args.get("alpha", 1)
            if alpha != 1:
                upd = self._mul(upd, Ival(alpha, alpha))
            return [self._scatter_add(op, a, upd, self._numel(key, op))]
        self.unknown_ops.add(p)
        return outs_range()

    # -- helpers --------------------------------------------------------------
    @staticmethod
    def _mul(a: Ival, b: Ival) -> Ival:
        cands = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
        return Ival(min(cands), max(cands))

    def _scatter_add(self, op: Op, base: Ival, upd: Ival, n: int) -> Ival:
        if (upd.wtag or upd.rsum) and base.is_zero:
            # segment sums onto a zero base: bounded by the block
            return Ival(-self.wsum, self.wsum, True)
        return self._check(op, Ival(base.lo + min(n * upd.lo, 0),
                                    base.hi + max(n * upd.hi, 0)))

    def _wrap_add_operand(self, op: Op, mod: Ival) -> Optional[Ival]:
        """``state.wrap_add``: remainder(x + 2**31, 2**32) of an int64
        ``x``; the int32 add it stands for is ``x`` itself."""
        if not (mod.lo == mod.hi == 2**32):
            return None
        d = self._producer(op.args.get("self"))
        if d is None or d.packet != "add" or d.args.get("other") != 2**31:
            return None
        x = d.args.get("self")
        if not isinstance(x, Ref) or self.trace.nodes[x.node].dtype != \
                torch.int64:
            return None
        return self._node_ival(x.node)

    def _numel(self, name: str, op: Op) -> int:
        v = op.args.get(name)
        return max(self.trace.nodes[v.node].numel, 1) if isinstance(
            v, Ref) else 1

    def _dim_size(self, op: Op) -> int:
        v = op.args.get("self")
        if not isinstance(v, Ref):
            return 1 << 20
        shape = self.trace.nodes[v.node].shape
        dim = op.args.get("dim")
        if isinstance(dim, list):
            dim = dim[0] if len(dim) == 1 else None
        if dim is None or not shape:
            return max(int(np.prod(shape)) if shape else 1, 1)
        return max(shape[dim], 1)

    def _reduction_size(self, op: Op) -> int:
        v = op.args.get("self")
        if not isinstance(v, Ref):
            return 1 << 20
        ins = self.trace.nodes[v.node].numel
        out = max(self.trace.nodes[op.outs[0]].numel, 1)
        return max(ins // out, 1)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """The tensors of a state, each with its path of field names
    (``ins/ids``, ``bank/counts``, ``key``)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += named_leaves(getattr(tree, f),
                                f"{prefix}/{f}" if prefix else f)
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += named_leaves(x, f"{prefix}/{i}" if prefix else str(i))
        return out
    return []


def precondition_ivals(state, hints: Optional[Dict[str, Ival]] = None
                       ) -> Dict[str, Ival]:
    """The ``validate_block`` preconditions as input intervals, by leaf
    name (the reference's): ids hold non-negative real ids or the
    sentinels (>= -3); counts and errors are int32-safe by the sat_add
    induction; items may be any int32 (padding ids are unchecked);
    weights carry the wtag, since ``validate_block`` bounds their block
    |sum| by int32 max. ``hints`` maps a leaf-name substring to an
    interval for invariants the names alone cannot carry (CR-precis
    ``primes`` are bounded by the counter budget)."""
    out: Dict[str, Ival] = {}
    for name, leaf in named_leaves(state):
        low = name.lower()
        hinted = next((iv for sub, iv in (hints or {}).items()
                       if sub in low), None)
        if hinted is not None:
            out[name] = hinted
        elif "ids" in low:
            out[name] = Ival(-3, INT32_MAX)
        elif "count" in low:
            out[name] = Ival(-IMAX, IMAX)
        elif "error" in low:
            out[name] = Ival(0, IMAX)
        elif "mass" in low or "total" in low:
            out[name] = Ival(-IMAX, IMAX)
        else:
            out[name] = dtype_ival(leaf.dtype)
    out["items"] = Ival(INT32_MIN, INT32_MAX)
    # each weight is a singleton disjoint subset (wtag) and a
    # one-element range (rsum)
    out["weights"] = Ival(-IMAX, IMAX, wtag=True, rsum=True)
    return out


def analyze_traces(traces: Sequence[Trace], entry: str,
                   in_ivals: Dict[str, Ival], wsum: int = IMAX
                   ) -> Tuple[List[Finding], "_Analyzer"]:
    """Interpret every trace under ``in_ivals`` (by input name), the
    scalars classified over all of them; findings de-duplicated by site."""
    scalars = _scalar_table(traces)
    an = _Analyzer(entry, wsum=wsum, scalars=scalars)
    for trace in traces:
        an.run(trace, in_ivals)
    an.loops = loop_trips(traces)
    return an.findings, an


def analyze_callable(fn, args: Sequence[torch.Tensor], entry: str,
                     in_ivals: Optional[Sequence[Ival]] = None,
                     more_args: Sequence[Sequence[torch.Tensor]] = (),
                     wsum: int = IMAX) -> List[Finding]:
    """Range-analyze a call of ``fn`` on tensor arguments (the test hook,
    counterpart of the reference's ``analyze_jaxable``): ``in_ivals`` per
    argument (default: each dtype's range); ``more_args``, other data for
    the same call, recorded too (what differs between the runs is read
    as a host value, not a literal)."""
    traces = []
    for a in (args, *more_args):
        names = {f"arg{i}": t for i, t in enumerate(a)}
        trace, _ = record(fn, names, *a)
        traces.append(trace)
    if in_ivals is None:
        in_ivals = [dtype_ival(t.dtype) for t in args]
    ivals = {f"arg{i}": iv for i, iv in enumerate(in_ivals)}
    return analyze_traces(traces, entry, ivals, wsum)[0]


def _stream(spec, block: int, seed: int):
    """Blocks that drive every loop of the update at least twice: two
    warm-up blocks that fill the state (the second evicts the first's
    ids), then the recorded block: new ids at weights >= 2 (the
    eviction loop), unit inserts (the water-fill), deletions of evicted
    ids (the drain), of monitored ids and padding."""
    rng = np.random.default_rng(seed)
    base = 1000 * (seed % 7 + 1)
    n_new, n_del, n_unit = block // 2, block // 4, block // 8
    warm = []
    for j in range(2):
        ids = base + j * 4 * block + rng.permutation(4 * block)[:block]
        w = rng.integers(1, 4, block) if j == 0 else rng.integers(2, 6, block)
        warm.append((ids, w))
    evicted = warm[0][0]
    new = base + 20 * block + rng.permutation(8 * block)[:n_new]
    items = np.concatenate([
        new, rng.choice(evicted, n_del, replace=False),
        base + 40 * block + np.arange(n_unit),
        rng.choice(warm[1][0], block - n_new - n_del - n_unit - 1,
                   replace=False), [0]])
    weights = np.concatenate([
        rng.integers(2, 9, n_new), -rng.integers(3, 12, n_del),
        np.ones(n_unit, np.int64),
        -rng.integers(1, 3, block - n_new - n_del - n_unit - 1), [0]])
    order = rng.permutation(block)
    rec = (items[order], weights[order])
    if spec.bits is not None:
        mask = (1 << spec.bits) - 1
        warm = [(i & mask, w) for i, w in warm]
        rec = (rec[0] & mask, rec[1])
    return warm, rec


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32))


def entry_name(kind: str, spec) -> str:
    """An entry point's id: ``ingest[frequency/sspm/bank/s4]``."""
    return (f"{kind}[{spec.kind}/{spec.variant}/{spec.backend}"
            f"{'/s' + str(spec.shards) if spec.shards else ''}"
            f"{'/t' + str(spec.tenants) if spec.tenants else ''}]")


def trace_update(spec, block: int = 64, seed: int = 0) -> Trace:
    """One recorded CPU ``adapter.update`` of ``spec`` on a block of
    ``_stream``'s after its warm-up blocks."""
    from ..sketch import api

    ad = api.adapter_for(spec)
    state = ad.make(spec, torch.device("cpu"))
    warm, (items, weights) = _stream(spec, block, seed)
    for i, w in warm:
        state = ad.update(spec, state, _t(i), _t(w))
    items, weights = _t(items), _t(weights)
    inputs = dict(named_leaves(state))
    inputs.update(items=items, weights=weights)
    trace, _ = record(ad.update, inputs, spec, state, items, weights)
    return trace


def analyze_update(spec, block: int = 64, wsum: int = IMAX,
                   seeds: Sequence[int] = (0, 1)
                   ) -> Tuple[List[Finding], "_Analyzer"]:
    """Range-analyze one spec's ingest (``adapter.update`` on the CPU),
    recorded once per seed. The analyzer's ``loops`` gives each loop's
    trips."""
    from ..sketch import api

    traces = [trace_update(spec, block, s) for s in seeds]
    state = api.adapter_for(spec).make(spec, torch.device("cpu"))
    # CR-precis moduli are primes <= total_budget // t, which the leaf
    # name alone cannot say
    hints = {"prime": Ival(1, max(2, int(spec.capacity)))}
    return analyze_traces(traces, entry_name("ingest", spec),
                          precondition_ivals(state, hints), wsum)


def analyze_merge(k: int = 64, wsum: int = IMAX,
                  seeds: Sequence[int] = (0, 1)) -> List[Finding]:
    """Range-analyze the summary merge (``state.merge``) of two summaries
    that may each hold counts up to the saturation rail: counts in
    [-IMAX, IMAX], errors in [0, IMAX], ids sentinel-or-data. Every fold
    in merge must stay int32 under those."""
    from ..sketch import state as st

    traces = []
    for s in seeds:
        rng = np.random.default_rng(s)
        pair = []
        for _ in range(2):
            ids = rng.choice(4 * k, k, replace=False)
            ids[rng.random(k) < 0.2] = st.EMPTY
            pair.append(st.SketchState(_t(ids), _t(rng.integers(1, 50, k)),
                                       _t(rng.integers(0, 5, k))))
        inputs = {f"{side}/{f}": getattr(s_, f) for side, s_ in
                  zip("ab", pair) for f in ("ids", "counts", "errors")}
        trace, _ = record(st.merge, inputs, *pair)
        traces.append(trace)
    ivals = {}
    for side in "ab":
        ivals.update({f"{side}/ids": Ival(-3, INT32_MAX),
                      f"{side}/counts": Ival(-IMAX, IMAX),
                      f"{side}/errors": Ival(0, IMAX)})
    return analyze_traces(traces, f"merge[k={k}]", ivals, wsum)[0]


DEFAULT_GRID = (
    dict(variant="sspm", backend="bank"),
    dict(variant="lazy", backend="bank"),
    dict(variant="double", backend="bank"),
    dict(variant="unbiased", backend="bank"),
    dict(variant="sspm", backend="crprecis"),
)
# the reference test grid's sharded cells
SHARDED_GRID = (
    dict(variant="sspm", backend="bank", shards=4),
    dict(variant="lazy", backend="bank", shards=4),
    dict(variant="double", backend="bank", shards=4),
)


def analyze_ingest_grid(k: int = 64, block: int = 64,
                        grid=DEFAULT_GRID + SHARDED_GRID) -> List[Finding]:
    """The acceptance surface: every registered variant's ingest must be
    provably wrap-free under the validate_block preconditions, and so
    must merge."""
    from ..sketch import api

    out: List[Finding] = []
    for cell in grid:
        spec = api.SketchSpec(kind="frequency", k=k, **cell)
        fs, _ = analyze_update(spec, block=block)
        out.extend(fs)
    out.extend(analyze_merge(k=k))
    seen, uniq = set(), []
    for f in out:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


__all__ = ["INT32_MIN", "INT32_MAX", "IMAX", "Ival",
           "dtype_ival", "named_leaves", "precondition_ivals",
           "analyze_traces", "analyze_callable", "trace_update",
           "analyze_update", "analyze_merge", "DEFAULT_GRID",
           "SHARDED_GRID", "analyze_ingest_grid", "entry_name"]
