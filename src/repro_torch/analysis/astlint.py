"""Layer 1: repo-specific AST lint over ``src/repro_torch``.

Counterpart of ``repro/analysis/astlint.py``: the same four rules, each a
convention the sketch core depends on, spelled for the port. The linter
is pure ``ast`` (no import of the linted code), so it runs in
milliseconds.

SK101 sentinel-equality
    Negative ids are reserved sentinels (EMPTY=-1, BLOCKED=-2,
    POISON=-3), so any equality between an ids tensor and *data* (query
    items, stream uids, another ids tensor) can match a sentinel slot and
    read its garbage count unless the enclosing function also masks with
    ``ids >= 0``. An ids expression is seen through the casts and views
    the port writes (``ids.to(I32)``, ``.long()``, ``.int()``,
    ``.view(...)``, ``.reshape(...)``, ``.flatten()``, ``[..., None]``).
    Comparisons against a recognized sentinel constant (``EMPTY``,
    ``-1``, ``-2**31``, ``torch.tensor(-1)``, ``torch.full(..., EMPTY)``)
    are masking, not queries, and are exempt. Scoped to ``sketch/`` and
    ``kernels/`` files, where the ids convention lives.

SK102 kernel-literal
    The port has no Pallas kernel bodies; its kernels are CUDA launches
    behind Python wrappers (``kernels/*/kernel.py``), their dispatch
    (``ops.py``) and their plain versions (``ref.py``). No function there
    may load a module-level name bound to a tensor factory call
    (``torch.tensor``, ``torch.as_tensor``, ``torch.arange``,
    ``torch.full``, ``torch.zeros``, ``torch.ones``, ``torch.empty``,
    ``np.array``, ``np.asarray``, ``np.arange``, or any ``jnp``/``jax``/
    ``lax`` call, the reference's array constants): such a constant pins
    a device at import, and on the card it costs a host-to-device copy on
    each call, which a captured CUDA graph cannot hold. Integer literals
    outside int32 also flag: a launch passes its ints as ``ctypes.c_int``.
    Dtype aliases (``I32 = torch.int32``) are attribute references, not
    calls, and ``torch.library.Library`` objects are no tensors: both are
    exempt.

SK103 cache-key
    A cache keyed by argument value (``functools.lru_cache``,
    ``functools.cache``: every parameter; a jit's ``static_argnums``/
    ``static_argnames``: those parameters) needs hashable arguments: a
    mutable default (list/dict/set) or a mutable call-site literal is a
    TypeError at the call or a fresh cache entry per call.

SK104 deprecated-shim
    ``jax_sketch`` is the reference's deprecated re-export shim; the port
    has none, and no module may import one.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set

from .findings import Finding, relpath

INT32_MAX = 2**31 - 1
SENTINEL_NAMES = {"EMPTY", "BLOCKED", "POISON", "_INT_MAX", "INT_MAX"}
# methods that keep an expression's ids: casts, views and copies
_SEE_THROUGH = {"to", "long", "int", "view", "reshape", "flatten", "astype",
                "contiguous", "clone", "squeeze", "unsqueeze", "expand",
                "expand_as", "view_as"}
# calls whose first argument is the value they hold
_VALUE_FIRST = {"int32", "int", "asarray", "tensor", "as_tensor",
                "scalar_tensor"}
# calls whose second argument (or ``fill_value``) is the value they hold
_FILL_SECOND = {"full", "full_like", "new_full"}
_MUTABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
            ast.SetComp)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _const_int(node: ast.AST) -> Optional[int]:
    """Constant-fold an int expression (+,-,*,** over int literals)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub, ast.Mult, ast.Pow)):
        l, r = _const_int(node.left), _const_int(node.right)
        if l is None or r is None:
            return None
        if isinstance(node.op, ast.Add):
            return l + r
        if isinstance(node.op, ast.Sub):
            return l - r
        if isinstance(node.op, ast.Mult):
            return l * r
        return l ** r if abs(r) < 64 else None
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """The terminal identifier of an expression: ``state.ids`` -> 'ids',
    ``ids_r[owner]`` -> 'ids_r', ``bank.ids[:, None]`` -> 'ids',
    ``ids.to(I32)`` / ``ids.long()`` / ``ids.view(-1)`` -> 'ids'."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Subscript):
        return _base_name(node.value)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _SEE_THROUGH:
            return _base_name(f.value)
        return _base_name(f)
    return None


def _is_ids_like(node: ast.AST) -> bool:
    name = _base_name(node)
    if name is None:
        return False
    # the state-ids naming family: ids, ids_r, ids_s, flat_ids, ins_ids...
    return name == "ids" or name.endswith("_ids") or name.startswith("ids_")


def _call_name(node: ast.AST) -> Optional[str]:
    return node.func.attr if isinstance(node.func, ast.Attribute) else (
        node.func.id if isinstance(node.func, ast.Name) else None)


def _is_sentinel_const(node: ast.AST) -> bool:
    """EMPTY / BLOCKED / POISON / negative int literal / ``-2**31`` /
    ``torch.tensor(-1)`` / ``torch.full(shape, EMPTY)`` / ``int(EMPTY)``:
    masking comparisons, not data queries."""
    v = _const_int(node)
    if v is not None:
        return v < 0
    name = _base_name(node)
    if name in SENTINEL_NAMES:
        return True
    if isinstance(node, ast.Call):
        fname = _call_name(node)
        if fname in _VALUE_FIRST and node.args:
            return _is_sentinel_const(node.args[0])
        if fname in _FILL_SECOND:
            fill = next((kw.value for kw in node.keywords
                         if kw.arg == "fill_value"),
                        node.args[1] if len(node.args) > 1 else None)
            return fill is not None and _is_sentinel_const(fill)
    return False


class _FuncIndex(ast.NodeVisitor):
    """Collect every function of a module."""

    def __init__(self):
        self.funcs: List[ast.FunctionDef] = []

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self.funcs.append(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef


def _functions(tree: ast.Module) -> List[ast.FunctionDef]:
    idx = _FuncIndex()
    idx.visit(tree)
    return idx.funcs


# ---------------------------------------------------------------------------
# SK101: sentinel equality
# ---------------------------------------------------------------------------

def _func_has_guard(func: ast.FunctionDef) -> bool:
    """Does the function compare an ids-like expression >= 0 (or > -1)?"""
    for node in ast.walk(func):
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            lhs, rhs = node.left, node.comparators[0]
            if isinstance(node.ops[0], ast.GtE) and _is_ids_like(lhs) \
                    and _const_int(rhs) == 0:
                return True
            if isinstance(node.ops[0], ast.Gt) and _is_ids_like(lhs) \
                    and _const_int(rhs) == -1:
                return True
            # flipped spelling: 0 <= ids
            if isinstance(node.ops[0], ast.LtE) and _is_ids_like(rhs) \
                    and _const_int(lhs) == 0:
                return True
    return False


def _sentinel_rule(path: str, tree: ast.Module, rel: str) -> List[Finding]:
    if "/sketch/" not in rel and "/kernels/" not in rel:
        return []
    if rel.endswith("/jax_sketch.py"):
        return []  # a shim re-exports, defines nothing
    out = []
    for func in _functions(tree):
        if _func_has_guard(func):
            continue
        for node in ast.walk(func):
            if not (isinstance(node, ast.Compare) and len(node.ops) == 1
                    and isinstance(node.ops[0], ast.Eq)):
                continue
            lhs, rhs = node.left, node.comparators[0]
            if not (_is_ids_like(lhs) or _is_ids_like(rhs)):
                continue
            other = rhs if _is_ids_like(lhs) else lhs
            if _is_sentinel_const(other):
                continue  # masking against a sentinel constant
            out.append(Finding(
                rule="SK101", path=rel, line=node.lineno,
                symbol=func.name,
                message=f"ids equality `{ast.unparse(node)}` has no "
                        f"`ids >= 0` guard in the enclosing function; "
                        f"sentinel slots (EMPTY/BLOCKED/POISON) can "
                        f"match and leak padding counts"))
    return out


# ---------------------------------------------------------------------------
# SK102: tensor constants and int literals in the kernels' Python
# ---------------------------------------------------------------------------

_FACTORIES = {
    "torch": {"tensor", "as_tensor", "arange", "full", "zeros", "ones",
              "empty"},
    "np": {"array", "asarray", "arange"},
    "numpy": {"array", "asarray", "arange"},
}
_ARRAY_ROOTS = ("jnp", "jax", "lax")


def _is_factory(call: ast.Call) -> bool:
    """A call that makes a tensor or an array: a torch or numpy factory,
    or any call into the reference's array namespaces."""
    parts, f = [], call.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if not isinstance(f, ast.Name):
        return False
    if f.id in _ARRAY_ROOTS:
        return True
    return len(parts) == 1 and parts[0] in _FACTORIES.get(f.id, ())


def _in_kernel_scope(rel: str) -> bool:
    if not ("/kernels/" in rel or rel.startswith("kernels/")):
        return False
    return os.path.basename(rel) in ("kernel.py", "ops.py", "ref.py")


def _kernel_literal_rule(path: str, tree: ast.Module,
                         rel: str) -> List[Finding]:
    if not _in_kernel_scope(rel):
        return []
    consts: Dict[str, int] = {}
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                and isinstance(node.value, ast.Call) \
                and _is_factory(node.value):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    consts[tgt.id] = node.lineno
    out = []
    for f in _functions(tree):
        local = {a.arg for a in (*f.args.posonlyargs, *f.args.args,
                                 *f.args.kwonlyargs)}
        for node in ast.walk(f):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in consts and node.id not in local:
                out.append(Finding(
                    rule="SK102", path=rel, line=node.lineno, symbol=f.name,
                    message=f"`{f.name}` loads the module-level tensor "
                            f"constant `{node.id}`: it pins a device at "
                            f"import and costs a host-to-device copy per "
                            f"call, which a captured CUDA graph cannot "
                            f"hold; use a Python number"))
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, int) and not isinstance(node.value, bool) \
                    and abs(node.value) > INT32_MAX:
                out.append(Finding(
                    rule="SK102", path=rel, line=node.lineno, symbol=f.name,
                    message=f"int literal {node.value} exceeds int32 in a "
                            f"kernel's Python; the device int dtype and a "
                            f"launch's ints are int32"))
    return out


# ---------------------------------------------------------------------------
# SK103: value-keyed cache arguments
# ---------------------------------------------------------------------------

def _literal_elts(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return list(node.elts)
    return [node]


def _cache_keys(dec: ast.AST):
    """What a decorator keys by value: ``"all"`` for ``lru_cache``/
    ``cache``, ``(positions, names)`` for a jit with static arguments,
    else None."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _base_name(target) if not isinstance(target, ast.Call) else None
    if name in ("lru_cache", "cache"):
        return "all"
    if not isinstance(dec, ast.Call):
        return None
    fname = _base_name(dec.func)
    if fname == "partial":
        if not (dec.args and _base_name(dec.args[0]) == "jit"):
            return None
    elif fname != "jit":
        return None
    nums, names = None, None
    for kw in dec.keywords:
        if kw.arg == "static_argnums":
            nums = kw.value
        elif kw.arg == "static_argnames":
            names = kw.value
    if nums is None and names is None:
        return None
    pos = {v for v in map(_const_int, _literal_elts(nums))
           if v is not None} if nums is not None else set()
    keyed = {e.value for e in _literal_elts(names)
             if isinstance(e, ast.Constant) and isinstance(e.value, str)
             } if names is not None else set()
    return pos, keyed


def _cache_key_rule(path: str, tree: ast.Module, rel: str) -> List[Finding]:
    out = []
    keyed_pos: Dict[str, Optional[Set[int]]] = {}   # None: every position
    keyed_names: Dict[str, Optional[Set[str]]] = {}
    for func in _functions(tree):
        for dec in func.decorator_list:
            keys = _cache_keys(dec)
            if keys is None:
                continue
            params = [*func.args.posonlyargs, *func.args.args]
            if keys == "all":
                pos, names = None, None
            else:
                pos, names = keys
            keyed_pos[func.name], keyed_names[func.name] = pos, names

            def keyed(i, p):
                return pos is None or p.arg in names or i in pos

            off = len(params) - len(func.args.defaults)
            for i, d in enumerate(func.args.defaults):
                p = params[off + i]
                if keyed(off + i, p) and isinstance(d, _MUTABLE):
                    out.append(Finding(
                        rule="SK103", path=rel, line=p.lineno,
                        symbol=func.name,
                        message=f"cache-keyed parameter `{p.arg}` has a "
                                f"mutable default ({type(d).__name__}); "
                                f"cache keys must be hashable"))
            for p, d in zip(func.args.kwonlyargs, func.args.kw_defaults):
                if d is not None and (names is None or p.arg in names) \
                        and isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    out.append(Finding(
                        rule="SK103", path=rel, line=func.lineno,
                        symbol=func.name,
                        message=f"cache-keyed parameter `{p.arg}` has a "
                                f"mutable default ({type(d).__name__}); "
                                f"cache keys must be hashable"))

    # same-module call sites passing mutable literals to keyed slots
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _base_name(node.func)
        if fname not in keyed_pos:
            continue
        pos, names = keyed_pos[fname], keyed_names[fname]
        for kw in node.keywords:
            if (names is None or kw.arg in names) and isinstance(
                    kw.value, _MUTABLE):
                out.append(Finding(
                    rule="SK103", path=rel, line=node.lineno, symbol=fname,
                    message=f"call passes a mutable "
                            f"{type(kw.value).__name__} as cache-keyed "
                            f"argument `{kw.arg}`; cache keys must be "
                            f"hashable"))
        for i, arg in enumerate(node.args):
            if (pos is None or i in pos) and isinstance(arg, _MUTABLE):
                out.append(Finding(
                    rule="SK103", path=rel, line=node.lineno, symbol=fname,
                    message=f"call passes a mutable "
                            f"{type(arg).__name__} as cache-keyed "
                            f"positional argument {i}; cache keys must "
                            f"be hashable"))
    return out


# ---------------------------------------------------------------------------
# SK104: deprecated shim imports
# ---------------------------------------------------------------------------

def _shim_rule(path: str, tree: ast.Module, rel: str) -> List[Finding]:
    if rel.endswith("sketch/jax_sketch.py"):
        return []  # a shim itself
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("jax_sketch"):
                    out.append(Finding(
                        rule="SK104", path=rel, line=node.lineno,
                        symbol="<module>",
                        message=f"import of deprecated shim "
                                f"`{alias.name}`; import the real homes "
                                f"(sketch.state/phases/blocks)"))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            from_shim = mod.endswith("jax_sketch")
            imports_shim = any(a.name == "jax_sketch" for a in node.names)
            if from_shim or imports_shim:
                out.append(Finding(
                    rule="SK104", path=rel, line=node.lineno,
                    symbol="<module>",
                    message="import of deprecated shim `jax_sketch`; "
                            "import the real homes "
                            "(sketch.state/phases/blocks)"))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

_RULES = (_sentinel_rule, _kernel_literal_rule, _cache_key_rule, _shim_rule)


def lint_source(src: str, rel: str) -> List[Finding]:
    """Lint one source string as if it lived at repo-relative ``rel``
    (the unit-test entry point: fixtures pick their rule scope by path)."""
    tree = ast.parse(src)
    out: List[Finding] = []
    for rule in _RULES:
        out.extend(rule(rel, tree, rel))
    return out


def lint_file(path: str) -> List[Finding]:
    rel = relpath(path)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding(rule="SK101", path=rel, line=e.lineno or 0,
                        symbol="<module>",
                        message=f"syntax error prevents linting: {e.msg}")]
    out: List[Finding] = []
    for rule in _RULES:
        out.extend(rule(path, tree, rel))
    return out


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (skipping caches)."""
    out: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.extend(lint_file(os.path.join(dirpath, fn)))
    return out


__all__ = ["lint_source", "lint_file", "lint_tree"]
