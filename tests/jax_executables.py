"""A module fixture for the port's parity tests: JAX's compiled
executables freed when a test module ends.

Each XLA executable maps its code into the process. A test worker that
runs many parity modules, each compiling the reference at shapes of its
own, gathers tens of thousands of memory maps and can pass the kernel's
limit (``vm.max_map_count``, 65,530 by default), at which XLA's
compiler aborts. Clearing JAX's caches when a module ends frees its
executables and their maps."""
import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def free_jax_executables():
    yield
    import jax

    jax.clear_caches()
    gc.collect()
