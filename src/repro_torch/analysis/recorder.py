"""The analyzer's trace: every aten op an eager call dispatches, in order.

The reference analyzes jaxprs, which JAX traces with the loops folded into
``while``/``scan`` equations. The port's sketch paths run their loops on
the host (``while bool(...)``, ``for step in range(int(...))``), and a
graph tracer stops at the first host read. So the analyzer records one
eager run instead: ``Recorder`` is a ``TorchDispatchMode`` that keeps, for
every op the call dispatches,

- the op and its arguments, each tensor argument as the node that holds
  its current value (a node is one value of one tensor: an op that writes
  a tensor in place gives it a new node, and the other tensors that share
  its storage get one too, through an ``alias_write`` record);
- the node of each tensor it returns, with dtype and shape;
- what a host read (``_local_scalar_dense``) returned;
- the Python frames of the call's own code (``src/repro_torch`` and any
  caller above it inside the recorded call; torch's, the standard
  library's, installed packages' and this package's frames are left
  out), innermost first;
- a key that is the same for the same op at the same place of the same
  loop body from one iteration to the next: each frame's bytecode offset
  (the call being made there) and the op's name. Ops of one name that a
  single Python call dispatches share their key, which can only make the
  passes more cautious.

The loops are unrolled for the run's data: a loop body appears once per
iteration. ``loop_trips`` counts, for every ``for`` or ``while``
statement the run passed through, how many times its body ran (the most
in one pass). The passes built on the trace (``range_interp``,
``sentinel_flow``) read only what this module records.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import os
import sys
import sysconfig
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .findings import relpath, repo_root

# (file, line, function, the function's first line, bytecode offset)
Frame = Tuple[str, int, str, int, int]

_HERE = os.path.dirname(os.path.abspath(__file__))
_PORT = os.path.dirname(_HERE) + os.sep
_SKIP = tuple(sorted({
    os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
    _HERE + os.sep,
    *(os.path.abspath(sysconfig.get_paths()[k]) + os.sep
      for k in ("stdlib", "platstdlib", "purelib", "platlib")),
}))
_HOST_READS = ("_local_scalar_dense", "is_nonzero", "equal")


@dataclasses.dataclass(frozen=True)
class Ref:
    """A tensor argument: the node holding its value when the op ran."""
    node: int


@dataclasses.dataclass
class Node:
    dtype: torch.dtype
    shape: Tuple[int, ...]
    name: Optional[str] = None      # a registered input's name
    # a constant lifted into the call (``torch.tensor(data)``): its
    # (min, max), read by the op that lifted it
    const: Optional[Tuple[Any, Any]] = None

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class Op:
    index: int
    name: str                       # "aten.add.Tensor"
    packet: str                     # "add"
    args: Dict[str, Any]            # schema name -> Ref, scalar, list, ...
    outs: List[int]                 # nodes of the tensor results, in order
    inputs: List[int]               # every node the op read
    frames: Tuple[Frame, ...]
    key: Tuple
    value: Any = None               # what a host read returned
    # 1 + how many ops at the same key came just before this one (the
    # scalars one call wraps into tensors: ``where(c, 1, 2)``)
    ordinal: int = 1


@dataclasses.dataclass
class Trace:
    nodes: List[Node] = dataclasses.field(default_factory=list)
    ops: List[Op] = dataclasses.field(default_factory=list)
    inputs: Dict[str, int] = dataclasses.field(default_factory=dict)
    defs: Dict[int, int] = dataclasses.field(default_factory=dict)

    def producer(self, node: int) -> Optional[Op]:
        i = self.defs.get(node)
        return None if i is None else self.ops[i]


def _user(filename: str) -> bool:
    return not filename.startswith(_SKIP) and not filename.startswith("<")


def _storage_key(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


class Recorder(TorchDispatchMode):
    """While open: the trace of what the code inside the ``with`` block
    dispatches (the module docstring). Register the call's inputs with
    ``add_input`` first: any other tensor from outside becomes a node of
    unknown value."""

    def __init__(self):
        super().__init__()
        self.trace = Trace()
        self._node_of: Dict[int, int] = {}
        self._keep: List[torch.Tensor] = []
        self._by_storage: Dict[Any, Dict[int, torch.Tensor]] = {}
        self._base: frozenset = frozenset()
        self._run: Tuple[Optional[Tuple], int] = (None, 0)

    # -- nodes -----------------------------------------------------------
    def _new_node(self, t: torch.Tensor, **kw) -> int:
        self.trace.nodes.append(Node(t.dtype, tuple(t.shape), **kw))
        n = len(self.trace.nodes) - 1
        self._node_of[id(t)] = n
        self._keep.append(t)
        key = _storage_key(t)
        if key is not None:
            self._by_storage.setdefault(key, {})[id(t)] = t
        return n

    def add_input(self, t: torch.Tensor, name: str) -> int:
        n = self._new_node(t, name=name)
        self.trace.inputs[name] = n
        return n

    def node(self, t: torch.Tensor) -> int:
        n = self._node_of.get(id(t))
        return self._new_node(t) if n is None else n

    # -- frames ----------------------------------------------------------
    def __enter__(self):
        f, base = sys._getframe(1), set()
        while f is not None:
            base.add(id(f))
            f = f.f_back
        self._base = frozenset(base)
        return super().__enter__()

    def _frames(self) -> Tuple[Frame, ...]:
        out = []
        f = sys._getframe(2)
        while f is not None and id(f) not in self._base:
            code = f.f_code
            if _user(code.co_filename):
                out.append((code.co_filename, f.f_lineno, code.co_name,
                            code.co_firstlineno, f.f_lasti))
            f = f.f_back
        return tuple(out)

    def _key(self, frames, packet: str) -> Tuple[Tuple, int]:
        key = (tuple((f[0], f[4]) for f in frames), packet)
        n = self._run[1] + 1 if self._run[0] == key else 1
        self._run = (key, n)
        return key, n

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _arg(self, v, inputs: List[int]):
        if isinstance(v, torch.Tensor):
            n = self.node(v)
            inputs.append(n)
            return Ref(n)
        if isinstance(v, (list, tuple)):
            return [self._arg(x, inputs) for x in v]
        return v

    def _record(self, func, args, kwargs, out) -> None:
        schema = func._schema
        named, inputs = {}, []
        for i, a in enumerate(schema.arguments):
            if i < len(args):
                v = args[i]
            elif a.name in kwargs:
                v = kwargs[a.name]
            else:
                v = a.default_value if a.has_default_value() else None
            named[a.name] = self._arg(v, inputs)
        packet = func._overloadpacket.__name__
        frames = self._frames()
        writes = tuple(a.name for a in schema.arguments
                       if a.alias_info is not None and a.alias_info.is_write)
        if packet in ("lift_fresh", "lift_fresh_copy"):
            src = args[0]
            if src.numel() and not src.is_floating_point():
                n = named["self"].node
                self.trace.nodes[n].const = (src.min().item(),
                                             src.max().item())
        key, ordinal = self._key(frames, packet)
        op = Op(index=len(self.trace.ops), name=str(func), packet=packet,
                args=named, outs=[], inputs=inputs, frames=frames,
                key=key, ordinal=ordinal)
        if packet in _HOST_READS:
            op.value = out
        self.trace.ops.append(op)
        written = {id(args[i]) if i < len(args) else id(kwargs.get(a.name))
                   for i, a in enumerate(schema.arguments)
                   if a.name in writes}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                fresh = id(t) in written or id(t) not in self._node_of
                n = self._new_node(t) if fresh else self._node_of[id(t)]
                op.outs.append(n)
                self.trace.defs.setdefault(n, op.index)
                if id(t) in written:
                    self._alias_writes(t, n, frames)

    def _alias_writes(self, t: torch.Tensor, n: int, frames) -> None:
        """Every other tensor on ``t``'s storage may have changed too: each
        gets a new node whose value joins its old one and the write's."""
        for other in list(self._by_storage.get(_storage_key(t), {}).values()):
            if other is t or id(other) not in self._node_of:
                continue
            old = self._node_of[id(other)]
            key, ordinal = self._key(frames, "alias_write")
            op = Op(index=len(self.trace.ops), name="alias_write",
                    packet="alias_write", args={"self": Ref(old),
                                                "src": Ref(n)},
                    outs=[], inputs=[old, n], frames=frames, key=key,
                    ordinal=ordinal)
            self.trace.ops.append(op)
            new = self._new_node(other)
            op.outs.append(new)
            self.trace.defs[new] = op.index


def record(fn, inputs: Dict[str, torch.Tensor], *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``Recorder`` with ``inputs``
    (name -> tensor, the tensors of the arguments) registered; returns
    (trace, result)."""
    rec = Recorder()
    for name, t in inputs.items():
        rec.add_input(t, name)
    with rec:
        result = fn(*args, **kwargs)
    return rec.trace, result


# ops whose result holds their input's values
VIEWS = frozenset({
    "unsqueeze", "squeeze", "view", "_unsafe_view", "alias", "detach",
    "clone", "slice", "select", "flip", "permute", "transpose", "t",
    "expand", "_to_copy", "contiguous", "reshape", "broadcast_to",
})


def literal(trace: Trace, v) -> Optional[Tuple[Any, Any]]:
    """``(lo, hi)`` of a literal operand: a Python number, or a tensor
    made of one (``scalar_tensor``, ``full``, ``zeros``, ``ones``, a
    lifted constant), seen through views; None for anything else."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v, v
    while isinstance(v, Ref):
        d = trace.producer(v.node)
        if d is None:
            return None
        if d.packet not in VIEWS:
            break
        v = d.args.get("self")
    else:
        return None
    s = {"scalar_tensor": d.args.get("s"),
         "full": d.args.get("fill_value"),
         "full_like": d.args.get("fill_value"),
         "new_full": d.args.get("fill_value"),
         "zeros": 0, "zeros_like": 0, "new_zeros": 0,
         "ones": 1, "ones_like": 1, "new_ones": 1}.get(d.packet)
    if isinstance(s, (int, float)) and not isinstance(s, bool):
        return s, s
    if d.packet in ("lift_fresh", "lift_fresh_copy"):
        return trace.nodes[d.args["self"].node].const
    return None


# ---------------------------------------------------------------------------
# Where an op comes from
# ---------------------------------------------------------------------------

def site(op: Op, entry: str) -> Tuple[str, int]:
    """``(path, line)`` of an op: its innermost frame in the port, else its
    innermost frame (a caller's own code), else the entry point."""
    for f in op.frames:
        if f[0].startswith(_PORT):
            return relpath(f[0]), f[1]
    if op.frames:
        f = op.frames[0]
        path = f[0]
        if path.startswith(repo_root() + os.sep):
            path = relpath(path)
        return path, f[1]
    return entry, 0


# ---------------------------------------------------------------------------
# Loop trips
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Loop:
    line: int                       # the for/while statement's line
    end: int                        # its last line
    body: Tuple[int, int]           # first and last line of its body
    inner: Tuple[Tuple[int, int], ...]   # (line, end) of loops inside it


@functools.lru_cache(maxsize=None)
def _parsed(path: str):
    with open(path, encoding="utf-8") as fh:
        return ast.parse(fh.read(), filename=path)


def _loops_of(fn_node) -> List[Loop]:
    """The for/while statements of one function, nested functions and
    classes left out."""
    found = []

    def visit(node, depth):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, (ast.For, ast.While, ast.AsyncFor)):
                found.append(child)
            visit(child, depth + 1)

    visit(fn_node, 0)
    out = []
    for lp in found:
        inner = tuple((o.lineno, o.end_lineno) for o in found
                      if o is not lp and lp.lineno < o.lineno
                      and o.end_lineno <= lp.end_lineno)
        out.append(Loop(lp.lineno, lp.end_lineno,
                        (lp.body[0].lineno, lp.body[-1].end_lineno), inner))
    return out


@functools.lru_cache(maxsize=None)
def _function_loops(path: str, first: int, name: str) -> Tuple[Loop, ...]:
    """The loops of the function whose code starts at ``first`` (its
    ``def`` line, or its first decorator's)."""
    try:
        tree = _parsed(path)
    except (OSError, SyntaxError):
        return ()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            starts = {node.lineno} | {d.lineno for d in node.decorator_list}
            if first in starts:
                return tuple(_loops_of(node))
    return ()


def loops_in(fn) -> List[Tuple[str, int]]:
    """``(path, line)`` of each for/while statement of a Python function
    (nested functions left out)."""
    code = fn.__code__
    return [(relpath(code.co_filename), lp.line) for lp in
            _function_loops(code.co_filename, code.co_firstlineno,
                            code.co_name)]


def loop_trips(traces: Sequence[Trace]) -> Dict[Tuple[str, int], int]:
    """For every loop statement of the port's code that the traces passed
    through: the most times its body ran in one pass through it (0 where
    only a while loop's test ran). A pass ends where an op runs outside
    the loop's lines or outside its function; a trip starts where the ops
    enter the body from outside it, or jump back within it (a jump back
    inside an inner loop is that loop's)."""
    best: Dict[Tuple[str, int], int] = {}
    for trace in traces:
        funcs = {(f[0], f[3], f[2]) for op in trace.ops for f in op.frames
                 if f[0].startswith(_PORT)}
        for path, first, name in funcs:
            for lp in _function_loops(path, first, name):
                n = _trips(trace, path, first, name, lp)
                if n is not None:
                    site_key = (relpath(path), lp.line)
                    best[site_key] = max(best.get(site_key, 0), n)
    return best


def _trips(trace: Trace, path, first, name, lp: Loop) -> Optional[int]:
    """The most trips of one pass through ``lp``; None if no op ran
    inside its lines."""
    most = trips = 0
    passed = False
    prev = None       # the previous op's line in the loop, None: outside
    lo, hi = lp.body
    for op in trace.ops:
        line = next((f[1] for f in op.frames
                     if f[0] == path and f[3] == first and f[2] == name),
                    None)
        if line is None or not lp.line <= line <= lp.end:
            if prev is not None:
                most, trips, prev = max(most, trips), 0, None
            continue
        passed = True
        if lo <= line <= hi:
            entered = prev is None or not lo <= prev <= hi
            back = (prev is not None and lo <= prev <= hi and line < prev
                    and not any(a <= line and prev <= b
                                for a, b in lp.inner))
            if entered or back:
                trips += 1
        prev = line
    return max(most, trips) if passed else None


__all__ = ["Ref", "Node", "Op", "Trace", "Recorder", "record", "VIEWS",
           "literal", "site", "Loop", "loops_in", "loop_trips"]
