"""Collective bytes of a traced step.

Counterpart of ``repro/roofline/hlo.py``. The reference sums the result
sizes of every all-gather, all-reduce, reduce-scatter, all-to-all and
collective-permute in the compiled HLO text, weighting those inside a
while body by its trip count. The port has no HLO: a step runs op by op,
and DTensor dispatches its communication as ``torch.distributed``'s
functional collectives (``_c10d_functional.*``, ``_dtensor.*``) or, in
eager code, c10d's own ops. ``roofline.trace.StepTrace`` sees each one
on one rank's local tensors and hands it here (``kind_of``), and
``collective_bytes`` sums what it saw into the reference's dict.

Bytes are per device: the bytes of the result one rank's op produces,
the reference's convention. There is no trip-count weighting: the
port's ``maybe_scan`` (``models/transformer.py``) is a Python loop, so
every layer's collectives are dispatched, and counted, one by one.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# op name (namespace::name, without the overload) -> the reference's kind
_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_reduce_coalesced_": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_c10d_functional::broadcast_": "collective-permute",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "collective-permute",
}


def kind_of(op_name: str) -> Optional[str]:
    """The reference's collective kind of an op (``namespace::name``, an
    overload suffix such as ``.default`` ignored), or None for an op that
    communicates nothing."""
    return _KINDS.get(op_name.split(".")[0])


def collective_bytes(seen: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum (kind, result bytes) pairs per kind, as the reference's
    ``collective_bytes`` returns them: one entry per kind of
    ``COLLECTIVES`` and ``total``."""
    out = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in seen:
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


__all__ = ["COLLECTIVES", "kind_of", "collective_bytes"]
