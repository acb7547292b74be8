"""CLI for the port's sketch-aware analyzer: ``python -m repro_torch.analysis``.

Layers (``--layers``, comma-separated, default all):

  ast        SK101-SK104 lint over ``src/repro_torch``
  range      SK201 int32 value-range pass over the ingest grid
  sentinel   SK202 sentinel-flow pass over the query entry points
  recompile  SK203 StreamSession compiled-ingest and CUDA-graph audit
  donation   SK204 in-place state operands + session donation audit

The recompile and donation layers drive real sessions on ``--device``
(default ``cuda``: CUDA graphs and in-place donation exist only there)
and raise without a card unless ``--device cpu`` is given. The range
and sentinel layers always trace the CPU path: the sketch kernels are
ctypes launches that no dispatch mode sees, so they read the kernels'
plain versions.

Exit status: 0 when every finding is baselined, 1 otherwise.  ``--ci``
additionally fails on stale baseline keys and on any baseline entry for
a zero-baseline rule (SK101/SK102 must be fixed, not suppressed).
``--write-baseline`` accepts the current non-zero-baseline findings as
debt.  ``--json`` emits a machine-readable report to stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

from ..platform import resolve_device
from .findings import (Finding, ZERO_BASELINE_RULES, default_baseline_path,
                       diff_baseline, load_baseline, repo_root, rule_counts,
                       write_baseline)

ALL_LAYERS = ("ast", "range", "sentinel", "recompile", "donation")


def run_layers(layers, root: str, k: int = 64, block: int = 64,
               device: str = "cuda") -> Dict[str, List[Finding]]:
    if "recompile" in layers or "donation" in layers:
        resolve_device(device)    # raises without a card
    out: Dict[str, List[Finding]] = {}
    if "ast" in layers:
        from .astlint import lint_tree
        out["ast"] = lint_tree(os.path.join(root, "src", "repro_torch"))
    if "range" in layers:
        from .range_interp import analyze_ingest_grid
        out["range"] = analyze_ingest_grid(k=k, block=block)
    if "sentinel" in layers:
        from .sentinel_flow import analyze_query_grid
        out["sentinel"] = analyze_query_grid(k=k)
    if "recompile" in layers:
        from .recompile_audit import audit_recompiles
        out["recompile"] = audit_recompiles(block=block, k=k,
                                            device=device)[0]
    if "donation" in layers:
        from .donation_audit import audit_donation
        out["donation"] = audit_donation(k=k, block=block,
                                         device=device)[0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's sketch-aware analyzer: an AST lint, "
                    "passes over eager aten traces of the CPU path, and "
                    "audits of real sessions on a device",
        epilog="The recompile and donation layers run on --device and "
               "raise without a card unless --device cpu is given; the "
               "range and sentinel layers always trace the CPU path (the "
               "sketch kernels are ctypes launches that no dispatch mode "
               "can see).")
    p.add_argument("--layers", default=",".join(ALL_LAYERS),
                   help=f"comma-separated subset of {ALL_LAYERS}")
    p.add_argument("--ci", action="store_true",
                   help="gate mode: also fail on stale baseline keys and "
                        "baselined zero-tolerance rules")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept current findings (minus SK101/SK102) as "
                        "debt and exit 0")
    p.add_argument("--baseline", default=None,
                   help=f"baseline path (default {default_baseline_path()})")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit a JSON report instead of text")
    p.add_argument("--root", default=None,
                   help="repo root override (default: auto-detected)")
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--block", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="where the recompile and donation layers drive "
                        "sessions (default cuda; raises without a card "
                        "unless cpu)")
    args = p.parse_args(argv)

    layers = [l.strip() for l in args.layers.split(",") if l.strip()]
    bad = [l for l in layers if l not in ALL_LAYERS]
    if bad:
        p.error(f"unknown layers {bad}; choose from {ALL_LAYERS}")
    root = args.root or repo_root()

    t0 = time.perf_counter()
    per_layer = run_layers(layers, root, k=args.k, block=args.block,
                           device=args.device)
    wall = time.perf_counter() - t0
    findings = [f for fs in per_layer.values() for f in fs]

    if args.write_baseline:
        path = write_baseline(findings, args.baseline)
        zero = [f for f in findings if f.rule in ZERO_BASELINE_RULES]
        print(f"baseline written: {path} "
              f"({len(findings) - len(zero)} keys accepted)")
        for f in zero:
            print(f"REFUSED (fix, don't suppress): {f.render()}")
        return 1 if zero else 0

    baseline = load_baseline(args.baseline)
    new, suppressed, stale = diff_baseline(findings, baseline)
    zero_in_baseline = sorted(
        key for key in baseline
        if key.split(":", 1)[0] in ZERO_BASELINE_RULES)

    fail = bool(new)
    if args.ci and (stale or zero_in_baseline):
        fail = True

    if args.as_json:
        print(json.dumps({
            "layers": layers,
            "wall_s": round(wall, 3),
            "counts": rule_counts(findings),
            "new": [f.render() for f in new],
            "suppressed": [f.render() for f in suppressed],
            "stale_baseline_keys": sorted(stale),
            "zero_baseline_violations": zero_in_baseline,
            "exit": 1 if fail else 0,
        }, indent=2))
    else:
        for f in new:
            print(f"NEW  {f.render()}")
        for f in suppressed:
            print(f"SUPP {f.render()}")
        for key in sorted(stale):
            print(f"STALE baseline key (debt paid — remove it): {key}")
        for key in zero_in_baseline:
            print(f"ILLEGAL baseline key (zero-tolerance rule): {key}")
        counts = {r: n for r, n in rule_counts(findings).items() if n}
        print(f"{len(findings)} finding(s) ({counts or 'clean'}), "
              f"{len(new)} new, {len(suppressed)} suppressed, "
              f"{len(stale)} stale baseline key(s); layers={layers}; "
              f"{wall:.1f}s")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
