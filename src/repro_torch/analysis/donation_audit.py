"""Layer 2d: donation / in-place-aliasing audit (SK204).

Counterpart of ``repro/analysis/donation_audit.py``. Two halves, one
invariant: state buffers move through the ingest path in place, and only
when the platform policy says they may.

**Static half.** The reference checks each ``pallas_call``'s
``input_output_aliases``. The port's sketch kernels are CUDA launches
that update the state they are given in place: each wrapper in
``kernels/sketch_update/kernel.py`` that launches (``_launch``) takes its
state operands (ids, counts, errors; the unbiased kernel's two banks)
first, must hand those same tensors (not a fresh ``empty_like``, not a
copy, not a rebinding) to ``_launch`` as the first entries of its
pointer list, in order, and must return them. A wrapper that drops the
state from the launch or reorders it updates memory the caller never
sees again, or writes counts into ids: nothing fails at once. The audit
parses the wrappers, so a refactor that reorders operands is caught
before any card sees it.

**Behavioral half.** The policy (``session.py``'s module docstring,
``platform.donate_state_buffers``): on the card with ``donate=True`` the
compiled ingest updates its state buffers in place, and a state the
caller kept from one ingest shares them, so the next ingest overwrites
it; with ``donate=False`` a kept state never changes; on the CPU nothing
is ever updated in place. The audit drives a compiled ingest in both
modes on ``device`` and checks the caller's kept state; a finding names
the mode that disagrees.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from ..platform import DEFAULT_DEVICE, resolve_device
from .findings import Finding, relpath

_KERNEL_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "sketch_update", "kernel.py")
_SESSION_PATH = "src/repro_torch/sketch/session.py"


# ---------------------------------------------------------------------------
# static half: the wrappers' state operands
# ---------------------------------------------------------------------------

def _is_launch(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and (
        isinstance(node.func, ast.Name) and node.func.id == "_launch"
        or isinstance(node.func, ast.Attribute)
        and node.func.attr == "_launch")


def _dict_values(func: ast.FunctionDef, name: str, before: int
                 ) -> Optional[List[ast.expr]]:
    """The values of the last ``name = dict(...)`` before line ``before``
    (what ``*name.values()`` spreads)."""
    found = None
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and node.lineno < before \
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets) \
                and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Name) \
                and node.value.func.id == "dict" and not node.value.args:
            if found is None or node.lineno > found.lineno:
                found = node
    return None if found is None else [kw.value for kw in
                                       found.value.keywords]


def _pointers(func: ast.FunctionDef, call: ast.Call
              ) -> Optional[List[ast.expr]]:
    """The launch's pointer list, ``*named.values()`` spread."""
    if len(call.args) < 2 or not isinstance(call.args[1], ast.List):
        return None
    out = []
    for e in call.args[1].elts:
        if isinstance(e, ast.Starred):
            v = e.value
            if not (isinstance(v, ast.Call) and isinstance(v.func,
                                                           ast.Attribute)
                    and v.func.attr == "values"
                    and isinstance(v.func.value, ast.Name)):
                return None
            spread = _dict_values(func, v.func.value.id, call.lineno)
            if spread is None:
                return None
            out.extend(spread)
        else:
            out.append(e)
    return out


def _names(nodes) -> List[Optional[str]]:
    return [n.id if isinstance(n, ast.Name) else None for n in nodes]


def _rebound(func: ast.FunctionDef, names) -> List[str]:
    """Which of ``names`` the function assigns to."""
    out = set()
    for node in ast.walk(func):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name) and n.id in names and \
                        isinstance(n.ctx, ast.Store):
                    out.add(n.id)
    return sorted(out)


def _audit_wrapper(func: ast.FunctionDef, call: ast.Call,
                   rel: str) -> List[Finding]:
    def finding(msg: str) -> Finding:
        return Finding(rule="SK204", path=rel, line=call.lineno,
                       symbol=func.name, message=msg)

    rets = [n for n in ast.walk(func) if isinstance(n, ast.Return)]
    ret = rets[-1].value if rets else None
    state = _names(ret.elts) if isinstance(ret, ast.Tuple) else [None]
    if not state or None in state:
        return [finding("the wrapper does not return a tuple of its state "
                        "operands, so the in-place update has no owner "
                        "the caller can see")]
    params = [a.arg for a in (*func.args.posonlyargs, *func.args.args)]
    if params[:len(state)] != state:
        return [finding(f"the wrapper returns {tuple(state)}, not its "
                        f"leading operands {tuple(params[:len(state)])}: "
                        f"the state it updates in place is not the state "
                        f"it was given")]
    rebound = _rebound(func, state)
    if rebound:
        return [finding(f"the wrapper rebinds its state operands "
                        f"{tuple(rebound)}: the kernel would update a "
                        f"fresh tensor, not the caller's state")]
    ptrs = _pointers(func, call)
    if ptrs is None:
        return [finding("the `_launch` pointer list is not a literal list "
                        "(with `*named.values()` of a literal dict) - keep "
                        "it literal so the aliasing audit can verify it")]
    got = [ast.unparse(p) for p in ptrs[:len(state)]]
    if got != state:
        return [finding(f"`_launch` takes {tuple(got)} as its first "
                        f"pointers, not the state operands {tuple(state)} "
                        f"in order: operand order and the in-place update "
                        f"have drifted apart")]
    return []


def audit_kernel_aliasing(path: Optional[str] = None) -> List[Finding]:
    """Check that every launching wrapper of the sketch-update kernels
    passes its state operands, in order, as the first pointers of its
    launch, and returns them."""
    path = path or _KERNEL_PATH
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    rel = relpath(path)
    findings: List[Finding] = []
    n_sites = 0
    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [n for n in ast.walk(func) if _is_launch(n)]
        if func.name == "_launch" or not calls:
            continue
        for call in calls:
            n_sites += 1
            findings.extend(_audit_wrapper(func, call, rel))
    if n_sites == 0:
        findings.append(Finding(
            rule="SK204", path=rel, line=1, symbol="_launch",
            message="no `_launch` sites found in the sketch-update kernel "
                    "wrappers: the aliasing audit has lost its target"))
    return findings


# ---------------------------------------------------------------------------
# behavioral half: session donation vs platform policy
# ---------------------------------------------------------------------------

def audit_session_donation(k: int = 64, block: int = 64,
                           device=DEFAULT_DEVICE
                           ) -> Tuple[List[Finding], Dict]:
    """Drive a compiled ingest in both donate modes on ``device``; check
    that a state the caller kept from one ingest is overwritten by the
    next exactly when the policy says the buffers are donated, and that
    the state given to the first ingest is never touched."""
    import numpy as np
    import torch

    from ..platform import donate_state_buffers
    from ..sketch import api
    from ..sketch import session as sess

    dev = resolve_device(device)
    spec = api.SketchSpec(kind="frequency", k=k, variant="sspm",
                          backend="bank")
    ad = api.adapter_for(spec)
    first = (np.arange(block, dtype=np.int32) % 17,
             np.ones(block, dtype=np.int32))
    second = (100 + np.arange(block, dtype=np.int32) % 23,
              np.full(block, 2, dtype=np.int32))

    def leaves(state):
        return sess._leaves(state)

    def changed(ts, copies) -> bool:
        return any(not torch.equal(t, c) for t, c in zip(ts, copies))

    findings: List[Finding] = []
    report: Dict = {"policy": bool(donate_state_buffers()),
                    "device": dev.type}
    for donate in (True, False):
        fn = sess._ingest_fn(spec, block, donate)
        state = ad.make(spec, dev)
        given = [t.clone() for t in leaves(state)]
        kept = fn(state, *first)
        kept_copy = [t.clone() for t in leaves(kept)]
        fn(kept, *second)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        overwritten = changed(leaves(kept), kept_copy)
        expected = bool(donate and dev.type == "cuda"
                        and donate_state_buffers())
        report[f"donate={donate}"] = overwritten
        report[f"donate={donate} given state touched"] = changed(
            leaves(state), given)
        if overwritten != expected:
            if expected:
                msg = (f"donate={donate} on {dev.type}: a state kept from "
                       f"one ingest was not overwritten by the next: the "
                       f"compiled ingest did not update its buffers in "
                       f"place although the policy donates them")
            else:
                msg = (f"donate={donate} on {dev.type}: a state kept from "
                       f"one ingest was overwritten by the next although "
                       f"the policy keeps it: live references (replay "
                       f"logs, trackers' states) would change under their "
                       f"holders")
            findings.append(Finding(
                rule="SK204", path=_SESSION_PATH, line=0,
                symbol="CompiledIngest", message=msg))
        if report[f"donate={donate} given state touched"]:
            findings.append(Finding(
                rule="SK204", path=_SESSION_PATH, line=0,
                symbol="CompiledIngest",
                message=f"donate={donate} on {dev.type}: the state given "
                        f"to the first ingest was updated in place"))
    return findings, report


def audit_donation(kernel_path: Optional[str] = None, k: int = 64,
                   block: int = 64, device=DEFAULT_DEVICE
                   ) -> Tuple[List[Finding], Dict]:
    findings = audit_kernel_aliasing(kernel_path)
    report: Dict = {"alias_sites_clean": not findings}
    behavioral, session = audit_session_donation(k=k, block=block,
                                                 device=device)
    findings.extend(behavioral)
    report.update(session)
    return findings, report


__all__ = ["audit_kernel_aliasing", "audit_session_donation",
           "audit_donation"]
