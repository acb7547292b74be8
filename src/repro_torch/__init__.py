"""PyTorch/CUDA port of the SpaceSaving± sketch package ``repro``.

The port mirrors ``repro``'s module paths (``repro_torch.sketch.bank``
is the counterpart of ``repro.sketch.bank``, and so on) and imports
nothing from it: the JAX package is the reference the port is held
against, bit for bit, by the ``tests/test_torch_*.py`` suites.

Entry points run on the CUDA device by default and raise when there is
none; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels (what the CPU tests do).
"""
