"""Wrappers of the CUDA sketch_update kernels (``csrc/*.cu``).

Each replaces one Pallas TPU kernel of
``repro/kernels/sketch_update/kernel.py``:

- ``sketch_update_kernel_fused`` (``fused_update.cu``): the whole
  per-cell bank update, one CTA per bank row (reference :144);
- ``sketch_residual_kernel_banked`` (``fused_update.cu``): phase 2 only,
  one CTA per bank row (reference :278);
- ``sketch_residual_kernel`` (``residual.cu``): phase 2 of E stacked
  single sketches on their (R, 128) row view, one CTA per sketch
  (reference :220, vmapped by its ``_batched`` caller);
- ``sketch_update_kernel_serial`` (``serial_update.cu``): one update per
  raw item, one CTA (reference :396).

A wrapper checks its operands, launches on the current stream, raises on
a refused launch and counts its launches. The kernels update the state
in place. Wrappers take CUDA tensors only: ``ops.py`` sends CPU tensors
to the plain versions in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_update.cu", CSRC / "residual.cu",
           CSRC / "serial_update.cu")
_P = ctypes.c_void_p
_I = ctypes.c_int
_INT31 = 2**31


def entry_point(source: str, name: str, n_ptr: int, n_int: int):
    """A kernel's C entry point, building its library first if needed:
    ``n_ptr`` pointers, then ``n_int`` ints, then the stream."""
    return _build.entry_point(CSRC / source, name,
                              (_P,) * n_ptr + (_I,) * n_int)


def _check(what, named, shapes, device) -> None:
    _build.check_operands(what, named, device)
    for name, t in named.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")


def _check_sizes(what: str, *sizes: int) -> None:
    """Every extent >= 1 and every flat size below 2**31 (the kernels
    index with int)."""
    if min(sizes) < 1 or max(sizes) >= _INT31:
        raise ValueError(f"{what}: unsupported shape {sizes}")


def _launch(fn, tensors, ints, device, what: str) -> None:
    _build.launch(fn, [*(t.data_ptr() for t in tensors), *ints], device, what)


def _check_variant(variant: int) -> None:
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 (lazy) or 2 (SS±), got {variant}")


def sketch_update_kernel_fused(ids, counts, errors, delta, h_uids, h_net,
                               i0, mu, nnu, w_del, *, variant: int = 2):
    """Apply one block's per-cell update to the (R, K) bank in place.

    ``ids, counts, errors, delta``: (R, K) int32; ``h_uids, h_net``:
    (R, B) int32 grouped residual layout per row; ``i0, mu, nnu,
    w_del``: (R,) int32 per-row scalars (``bank.phase1_dense_prep``).
    Returns ``(ids, counts, errors)``, the same tensors, updated.
    """
    R, K = ids.shape
    B = h_uids.shape[1]
    named = dict(ids=ids, counts=counts, errors=errors, delta=delta,
                 h_uids=h_uids, h_net=h_net, i0=i0, mu=mu, nnu=nnu,
                 w_del=w_del)
    shapes = dict(ids=(R, K), counts=(R, K), errors=(R, K), delta=(R, K),
                  h_uids=(R, B), h_net=(R, B), i0=(R,), mu=(R,), nnu=(R,),
                  w_del=(R,))
    _check("sketch_update_kernel_fused", named, shapes, ids.device)
    _check_variant(variant)
    _check_sizes("sketch_update_kernel_fused", R, K, B, R * B, R * K)
    _launch(entry_point("fused_update.cu", "sketch_fused_update", 10, 4),
            named.values(), (R, K, B, variant), ids.device, "fused_update")
    sketch_update_kernel_fused.launches += 1
    return ids, counts, errors


def sketch_residual_kernel_banked(ids, counts, errors, h_uids, h_net, uoff,
                                  start, n_ins, w_del, *, variant: int = 2):
    """Phase 2 of the (R, K) bank in place (the split path).

    ``ids, counts, errors``: (R, K) int32 after phases 1-1.75; ``h_uids,
    h_net``: (G,) int32 flat grouped layout; ``uoff, start, n_ins,
    w_del``: (R,) int32 (``bank.phase1_dense``). Row r evicts for the
    entries ``uoff[r] + i``, i in [start[r], n_ins[r]), then drains
    ``w_del[r]`` (SS±). Returns ``(ids, counts, errors)``, updated.
    """
    R, K = ids.shape
    G = h_uids.shape[0]
    named = dict(ids=ids, counts=counts, errors=errors, h_uids=h_uids,
                 h_net=h_net, uoff=uoff, start=start, n_ins=n_ins,
                 w_del=w_del)
    shapes = dict(ids=(R, K), counts=(R, K), errors=(R, K), h_uids=(G,),
                  h_net=(G,), uoff=(R,), start=(R,), n_ins=(R,), w_del=(R,))
    _check("sketch_residual_kernel_banked", named, shapes, ids.device)
    _check_variant(variant)
    _check_sizes("sketch_residual_kernel_banked", R, K, G, R * K)
    _launch(entry_point("fused_update.cu", "sketch_residual_banked", 9, 4),
            named.values(), (R, K, G, variant), ids.device, "residual_banked")
    sketch_residual_kernel_banked.launches += 1
    return ids, counts, errors


def sketch_residual_kernel(ids2, cnt2, err2, r_uids, r_net, start, n_ins,
                           w_del, *, variant: int = 2):
    """Phase 2 of E stacked sketches in place.

    ``ids2, cnt2, err2``: (E, R, 128) int32 row views after phases
    1-1.75 (``phases.pad_rows``); ``r_uids, r_net``: (E, B) int32 grouped
    residual layout; ``start, n_ins, w_del``: (E,) int32
    (``blocks._phase1``). Returns ``(ids2, cnt2, err2)``, updated.
    """
    E, R, lanes = ids2.shape
    B = r_uids.shape[1]
    named = dict(ids2=ids2, cnt2=cnt2, err2=err2, r_uids=r_uids,
                 r_net=r_net, start=start, n_ins=n_ins, w_del=w_del)
    shapes = dict(ids2=(E, R, 128), cnt2=(E, R, 128), err2=(E, R, 128),
                  r_uids=(E, B), r_net=(E, B), start=(E,), n_ins=(E,),
                  w_del=(E,))
    _check("sketch_residual_kernel", named, shapes, ids2.device)
    _check_variant(variant)
    _check_sizes("sketch_residual_kernel", E, R, B, E * R * lanes, E * B)
    # per-row summaries (has_empty, min count, max error) of every sketch
    summary = torch.empty((3, E, R), dtype=torch.int32, device=ids2.device)
    _launch(entry_point("residual.cu", "sketch_residual", 9, 4),
            [*named.values(), summary], (E, R, B, variant), ids2.device,
            "residual")
    sketch_residual_kernel.launches += 1
    return ids2, cnt2, err2


def sketch_update_kernel_serial(ids2, cnt2, err2, items, weights, *,
                                variant: int = 2):
    """One update per raw item, in order, on one sketch in place.

    ``ids2, cnt2, err2``: (R, 128) int32 row view (``phases.pad_rows``);
    ``items, weights``: (B,) int32, weights signed (0 = padding).
    Returns ``(ids2, cnt2, err2)``, updated.
    """
    R, lanes = ids2.shape
    B = items.shape[0]
    named = dict(ids2=ids2, cnt2=cnt2, err2=err2, items=items,
                 weights=weights)
    shapes = dict(ids2=(R, 128), cnt2=(R, 128), err2=(R, 128), items=(B,),
                  weights=(B,))
    _check("sketch_update_kernel_serial", named, shapes, ids2.device)
    _check_variant(variant)
    _check_sizes("sketch_update_kernel_serial", R, B, R * lanes)
    _launch(entry_point("serial_update.cu", "sketch_serial_update", 5, 3),
            named.values(), (R * lanes, B, variant), ids2.device,
            "serial_update")
    sketch_update_kernel_serial.launches += 1
    return ids2, cnt2, err2


# launches since the last reset (chip_smoke.py reads them around each path)
sketch_update_kernel_fused.launches = 0
sketch_residual_kernel_banked.launches = 0
sketch_residual_kernel.launches = 0
sketch_update_kernel_serial.launches = 0

__all__ = ["SOURCES", "entry_point", "sketch_update_kernel_fused",
           "sketch_residual_kernel_banked", "sketch_residual_kernel",
           "sketch_update_kernel_serial"]
