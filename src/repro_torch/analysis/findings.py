"""Finding model + the baseline (accepted-debt) workflow.

Counterpart of ``repro/analysis/findings.py``, kept as a copy of its own:
every analyzer in ``repro_torch.analysis`` reports :class:`Finding`
records, one per rule violation, carrying the rule id, a repo-relative
``file:line`` location, the enclosing symbol and a one-line message.
Findings are identified for suppression by a line-free
:attr:`Finding.key` (rule + path + symbol + a hash of the message), so a
committed baseline survives unrelated edits that shift line numbers.

The baseline file (``src/repro_torch/analysis/baseline.json``) is the list
of accepted-debt keys. The CI gate (``python -m repro_torch.analysis
--ci``) exits 1 on any finding whose key is not baselined; stale baseline
entries (keys that no longer match a finding) are reported so the debt
list only ever shrinks deliberately.

Rule catalog:

Layer 1 — AST lint over ``src/repro_torch``:
  SK101 sentinel-equality   ids compared against data without an
                            ``ids >= 0`` guard in the enclosing function
  SK102 kernel-literal      a function of ``kernels/*/{kernel,ops,ref}.py``
                            loads a module-level tensor constant, or
                            uses an int literal outside int32
  SK103 cache-key           mutable default / mutable call-site literal
                            on a parameter that keys a cache by value
                            (``functools.lru_cache``/``cache``, a jit's
                            static arguments)
  SK104 deprecated-shim     import of a ``jax_sketch`` shim module

Layer 2 — passes over eager aten traces (``recorder``) and audits of the
real entry points:
  SK201 int32-range         an add/sub/mul on signed int32 whose
                            abstract interval can leave int32 under the
                            ``validate_block`` preconditions
  SK202 sentinel-flow       an ids x query equality reachable without
                            an ``ids >= 0`` guard in a query entry point
  SK203 recompile           compiled-ingest count != distinct normalized
                            cache cells over the spec grid, or CUDA
                            graphs per cell != state shapes driven
  SK204 donation            the kernels' in-place state operands, or a
                            session's donation, disagree with the
                            ``repro_torch.platform.donate_state_buffers``
                            policy
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterable, List, Set, Tuple

RULES: Dict[str, str] = {
    "SK101": "sentinel-equality: unguarded ids == data comparison",
    "SK102": "kernel-literal: tensor constant / int32-unsafe literal in a "
             "kernel wrapper, its ops or its plain version",
    "SK103": "cache-key: mutable value bound to a parameter that keys a "
             "cache by value",
    "SK104": "deprecated-shim: import of a jax_sketch shim module",
    "SK201": "int32-range: add/sub/mul can leave int32 under the "
             "validate_block preconditions",
    "SK202": "sentinel-flow: sentinel ids can reach an unguarded query "
             "equality",
    "SK203": "recompile: compiled ingests != distinct normalized cache "
             "cells, or CUDA graphs != state shapes",
    "SK204": "donation: in-place state operands / donation policy "
             "mismatch",
}

# the two rules held at zero accepted debt: the CI gate refuses baseline
# entries for them so new violations can only be fixed, never suppressed.
ZERO_BASELINE_RULES = ("SK101", "SK102")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str      # "SK101" ... "SK204"
    path: str      # repo-relative file (or entry-point id for trace rules)
    line: int      # 1-based line; 0 when the finding has no source anchor
    symbol: str    # enclosing function/class or traced entry point
    message: str   # one line, no line numbers (keys must survive drift)

    @property
    def key(self) -> str:
        slug = hashlib.sha1(self.message.encode()).hexdigest()[:10]
        return f"{self.rule}:{self.path}:{self.symbol}:{slug}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} [{self.symbol}] {self.message}"


def repo_root() -> str:
    """The repository root (three levels above this package)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def relpath(path: str) -> str:
    """``path`` relative to the repo root, POSIX-separated (stable keys)."""
    return os.path.relpath(os.path.abspath(path),
                           repo_root()).replace(os.sep, "/")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def load_baseline(path: str | None = None) -> Set[str]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return set(data.get("suppressed", []))


def write_baseline(findings: Iterable[Finding],
                   path: str | None = None) -> str:
    """Accept the current findings as debt (minus the zero-baseline
    rules, which must be fixed, not suppressed)."""
    path = path or default_baseline_path()
    keys = sorted({f.key for f in findings
                   if f.rule not in ZERO_BASELINE_RULES})
    with open(path, "w") as f:
        json.dump({"comment": "accepted-debt keys for repro_torch.analysis; "
                              "regenerate with python -m repro_torch.analysis "
                              "--write-baseline (SK101/SK102 refuse "
                              "suppression)",
                   "suppressed": keys}, f, indent=2)
        f.write("\n")
    return path


def diff_baseline(findings: List[Finding], baseline: Set[str],
                  ) -> Tuple[List[Finding], List[Finding], Set[str]]:
    """Split findings into (new, suppressed) and return stale keys.

    Zero-baseline rules (SK101/SK102) are never suppressed even if a
    stale baseline mentions them.
    """
    new, suppressed = [], []
    seen_keys = set()
    for f in findings:
        seen_keys.add(f.key)
        if f.key in baseline and f.rule not in ZERO_BASELINE_RULES:
            suppressed.append(f)
        else:
            new.append(f)
    stale = baseline - seen_keys
    return new, suppressed, stale


def rule_counts(findings: Iterable[Finding]) -> Dict[str, int]:
    counts = {r: 0 for r in RULES}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {r: n for r, n in counts.items()}
