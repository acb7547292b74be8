"""repro_torch.analysis: the sketch-aware analyzer of the port.

Counterpart of ``repro.analysis``, two layers over one
:class:`repro_torch.analysis.findings.Finding` model:

* **Layer 1** (:mod:`repro_torch.analysis.astlint`): a pure-AST lint of
  ``src/repro_torch`` with four repo-specific rules: unguarded sentinel
  equality (SK101), tensor constants and int32-unsafe literals in the
  kernels' Python (SK102), mutable values on cache-keyed arguments
  (SK103) and ``jax_sketch`` shim imports (SK104). Milliseconds.

* **Layer 2**: analyses of the real entry points. The range and
  sentinel passes read eager aten traces of the CPU path
  (:mod:`recorder`; the CUDA kernels are ctypes launches no dispatch
  mode sees, so these two always trace the kernels' plain versions): an
  int32 value-range abstract interpreter propagating the
  ``validate_block`` preconditions through the ingest
  (:mod:`range_interp`, SK201) and a sentinel-flow taint pass over the
  query paths (:mod:`sentinel_flow`, SK202). The recompile auditor over
  the spec grid (:mod:`recompile_audit`, SK203) and the donation audit
  (:mod:`donation_audit`, SK204) drive real sessions on a device: the
  card unless asked, where CUDA graphs and in-place donation exist.

``python -m repro_torch.analysis --ci`` runs everything, diffs against
the committed ``baseline.json`` and exits 1 on any new finding.
"""
from .findings import (  # noqa: F401
    Finding,
    RULES,
    ZERO_BASELINE_RULES,
    diff_baseline,
    load_baseline,
    rule_counts,
    write_baseline,
)

__all__ = [
    "Finding",
    "RULES",
    "ZERO_BASELINE_RULES",
    "diff_baseline",
    "load_baseline",
    "rule_counts",
    "write_baseline",
]
