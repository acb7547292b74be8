"""Host-side code the port keeps its own copies of (plain Python and
numpy): the streams, the capacity sizing, and the oracles the benchmarks
hold the port to (``heaps``, ``spacesaving``, ``baselines``,
``quantiles``; counterparts of ``repro/core``)."""
