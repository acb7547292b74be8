"""Host-side code the port keeps its own copies of (plain Python and
numpy): the streams, the capacity sizing, and the oracles the benchmarks
hold the port to (``heaps``, ``spacesaving``, ``baselines``,
``quantiles``; counterparts of ``repro/core``). The package exports the
names ``repro.core`` exports."""
from .spacesaving import (
    LazySpaceSavingPM,
    SpaceSaving,
    SpaceSavingPM,
    capacity_for,
    make_sketch,
)
from .streams import (
    StreamStats,
    bounded_stream,
    exact_stats,
    heavy_hitters,
)

__all__ = [
    "SpaceSaving",
    "LazySpaceSavingPM",
    "SpaceSavingPM",
    "make_sketch",
    "capacity_for",
    "StreamStats",
    "bounded_stream",
    "exact_stats",
    "heavy_hitters",
]
