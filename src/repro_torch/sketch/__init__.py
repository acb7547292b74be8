"""The port's sketch package: counterpart of ``repro.sketch``.

It exports the names of ``repro.sketch.__all__`` but the deprecated
``jax_sketch`` shim: the layer modules (``state``, ``phases``,
``blocks``, ``bank``, ``dyadic``, ``sharded``, ``dyadic_sharded``,
``tenant``, ``family``, ``api``, ``session``, ``elastic``, ``faults``)
and the names the reference lifts from them. They resolve at first
access: the kernels' ``ops`` module imports the layer modules, and the
api imports ``ops``, so importing them all here would be circular.
"""
from __future__ import annotations

import importlib

_MODULES = ("api", "session", "elastic", "family", "faults", "tenant",
            "bank", "blocks", "dyadic", "dyadic_sharded", "phases",
            "sharded", "state")
_NAMES = {
    "SketchSpec": "api",
    "StreamSession": "session",
    "FaultEvent": "faults",
    "FaultPlan": "faults",
    **dict.fromkeys(("EMPTY", "BLOCKED", "LANES", "VARIANT_LAZY",
                     "VARIANT_SSPM", "SketchState", "init", "query",
                     "query_many", "topk", "merge", "to_dict"), "state"),
    **dict.fromkeys(("pad_rows", "segment_nets", "row_structures",
                     "select_insert_slot", "fill_empty_slots",
                     "waterfill_unit_inserts", "residual_phase"), "phases"),
    **dict.fromkeys(("apply_update", "process_stream", "block_update",
                     "block_update_serial", "block_update_batched",
                     "block_partition_stats"), "blocks"),
}


def __getattr__(name):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name in _NAMES:
        module = importlib.import_module(f"{__name__}.{_NAMES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_MODULES, *_NAMES]
