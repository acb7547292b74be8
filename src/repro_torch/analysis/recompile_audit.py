"""Layer 2c: recompile auditor over the StreamSession spec grid (SK203).

Counterpart of ``repro/analysis/recompile_audit.py``. The session layer
keys its compiled ingest (``session._ingest_fn``: a ``CompiledIngest``,
on the card a CUDA graph of the adapter's update per state shape) on the
*normalized* spec (``session.ingest_cache_spec``): tenant populations
collapse onto a ``tenants=1`` layout so a thousand tenants share one
cell. A regression here is silent: everything still computes, the
process just captures per tenant and the multi-tenant service falls off a
cliff.

This audit DRIVES real sessions over a spec grid and asserts, from the
cache's counters (``ingest_cache_stats``):

* one cache entry per distinct ``(normalized spec, block, donate, mesh
  layout)`` cell: no more (a normalization gap), no fewer (an
  over-eager collapse that would share an ingest across layouts);
* re-driving the same grid adds ZERO entries (steady-state sessions
  never capture again);
* on the card, each cell's ``CompiledIngest`` holds exactly one captured
  CUDA graph per state shape driven through it (tenant populations that
  share a cell differ in rows), and the re-drive adds none; on the CPU,
  where the ingest is the eager update, no cell holds a graph.

Findings carry the grid cell that broke, anchored at the session cache
plumbing. The audit runs on ``device`` (the card unless asked).
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..platform import DEFAULT_DEVICE, resolve_device
from .findings import Finding, relpath


def default_grid(k: int = 64) -> List:
    """Spec cells exercising every normalization axis: plain, sharded,
    family variants, crprecis, and tenant populations that MUST collapse
    (T = 3, 5 and 1 with one layout share one cell)."""
    from ..sketch.api import SketchSpec

    return [
        SketchSpec(kind="frequency", k=k, variant="sspm", backend="bank"),
        SketchSpec(kind="frequency", k=k, variant="lazy", backend="bank"),
        SketchSpec(kind="frequency", k=k, variant="double", backend="bank"),
        SketchSpec(kind="frequency", k=k, variant="unbiased",
                   backend="bank"),
        SketchSpec(kind="frequency", k=k, variant="sspm",
                   backend="crprecis"),
        SketchSpec(kind="frequency", k=k, variant="sspm", backend="bank",
                   shards=4),
        # distinct tenant populations, same layout: ONE normalized cell
        SketchSpec(kind="frequency", k=k, bits=8, variant="sspm",
                   backend="bank", tenants=3),
        SketchSpec(kind="frequency", k=k, bits=8, variant="sspm",
                   backend="bank", tenants=5),
        SketchSpec(kind="frequency", k=k, bits=8, variant="sspm",
                   backend="bank", tenants=1),
    ]


def _where(fn) -> Tuple[str, int]:
    """``(path, line)`` of a function's ``def``."""
    return relpath(inspect.getsourcefile(fn)), inspect.getsourcelines(fn)[1]


def _block_of(spec, block: int, rng, stream) -> Tuple[np.ndarray, np.ndarray]:
    if stream is not None:
        return stream[:block, 0], stream[:block, 1]
    items = rng.integers(0, 50, size=block).astype(np.int32)
    if spec.tenants:
        # composite keys: (tenant << bits) | item, item < 2**bits
        t = rng.integers(0, int(spec.tenants), size=block)
        items = ((t << int(spec.bits)) | (items % (1 << int(spec.bits))))
        items = items.astype(np.int32)
    return items, np.ones(block, dtype=np.int32)


def _drive(spec, block: int, rng, device, stream=None):
    from ..sketch.session import StreamSession

    s = StreamSession(spec, block=block, device=device)
    s.ingest(*_block_of(spec, block, rng, stream))
    s.flush()
    return s


def audit_recompiles(grid: Optional[Sequence] = None, block: int = 64,
                     k: int = 64, device=DEFAULT_DEVICE,
                     stream: Optional[np.ndarray] = None
                     ) -> Tuple[List[Finding], Dict]:
    """Run the grid through real sessions on ``device``; return (findings,
    report). ``stream``: an (n, 2) array of (item, weight) rows whose
    first ``block`` rows every session ingests (default: a small random
    block per spec)."""
    from ..sketch import session as sess

    dev = resolve_device(device)
    if grid is None:
        grid = default_grid(k=k)
    findings: List[Finding] = []
    rng = np.random.default_rng(0)

    def cell_of(spec):
        return (sess.ingest_cache_spec(spec), int(block), True,
                sess.mesh_layout(spec))

    def graphs(cell) -> int:
        return len(sess._ingest_fn_cached(*cell).graphs)

    sess._ingest_fn_cached.cache_clear()
    shapes: Dict[Tuple, set] = {}
    for spec in grid:
        s = _drive(spec, block, rng, dev, stream)
        shapes.setdefault(cell_of(spec), set()).add(
            tuple(tuple(t.shape) for t in sess._leaves(s.state)))
    stats1 = sess.ingest_cache_stats()
    cells = set(shapes)
    graphs1 = {c: graphs(c) for c in cells}
    path, line = _where(sess.ingest_cache_spec)
    if stats1["entries"] != len(cells):
        findings.append(Finding(
            rule="SK203", path=path, line=line, symbol="ingest_cache_spec",
            message=f"compiled-ingest cache holds {stats1['entries']} "
                    f"entries for {len(cells)} distinct normalized "
                    f"(spec, block, donate, mesh layout) cells over the "
                    f"audit grid: cache identity and layout identity "
                    f"disagree"))

    # steady state: the same grid again must be all hits
    for spec in grid:
        _drive(spec, block, rng, dev, stream)
    stats2 = sess.ingest_cache_stats()
    if stats2["entries"] != stats1["entries"]:
        path, line = _where(sess._ingest_fn_cached)
        findings.append(Finding(
            rule="SK203", path=path, line=line, symbol="_ingest_fn_cached",
            message=f"re-driving the identical session grid grew the "
                    f"ingest cache from {stats1['entries']} to "
                    f"{stats2['entries']} entries: live sessions capture "
                    f"again"))

    # per cell: one CUDA graph per state shape on the card, none on the
    # CPU, and none added by the re-drive
    want = {c: len(s) if dev.type == "cuda" else 0
            for c, s in shapes.items()}
    bad = []
    for c in sorted(cells, key=repr):
        n = graphs(c)
        if n != want[c] or n != graphs1[c]:
            spec = c[0]
            bad.append((spec.variant, spec.backend, spec.shards,
                        spec.tenants, len(shapes[c]), graphs1[c], n))
    if bad:
        path, line = _where(sess.CompiledIngest)
        findings.append(Finding(
            rule="SK203", path=path, line=line, symbol="CompiledIngest",
            message=f"cells with (variant, backend, shards, tenants, "
                    f"state_shapes, graphs_after_pass1, graphs_after_"
                    f"pass2)={bad!r} on {dev.type} hold another number of "
                    f"CUDA graphs than one per state shape on the card "
                    f"and none on the CPU, or grew on an identical "
                    f"re-drive"))

    report = dict(stats2)
    report["cells"] = len(cells)
    report["grid"] = len(list(grid))
    report["device"] = dev.type
    report["graphs"] = sum(graphs(c) for c in cells)
    return findings, report


__all__ = ["default_grid", "audit_recompiles"]
