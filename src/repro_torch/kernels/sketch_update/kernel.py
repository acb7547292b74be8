"""Wrappers of the CUDA sketch_update kernels (``csrc/*.cu``).

Each replaces one Pallas TPU kernel of
``repro/kernels/sketch_update/kernel.py``:

- ``sketch_update_kernel_fused`` (``fused_update.cu``): the whole
  per-cell bank update, one CTA per bank row, the row staged in shared
  memory up to ``FUSED_STAGE_SLOTS`` slots (reference :144);
- ``sketch_residual_kernel_banked`` (``fused_update.cu``): phase 2 only,
  one CTA per bank row (reference :278);
- ``sketch_residual_kernel`` (``residual.cu``): phase 2 of E stacked
  single sketches on their (R, 128) row view, one CTA per sketch, after a
  summary pass over the card where R > 128 (reference :220, vmapped by
  its ``_batched`` caller);
- ``sketch_update_kernel_serial`` (``serial_update.cu``): one update per
  raw item, one CTA (reference :396);
- ``sketch_unbiased_kernel`` (``unbiased_update.cu``): the unbiased
  variant's randomized eviction on both banks of the family, one CTA
  per bank row. It replaces no Pallas kernel: the reference runs that
  update as a plain-JAX scan (``repro/sketch/family.py:123``).

A wrapper checks its operands, launches on the current stream, raises on
a refused launch and counts its launches (a call of kernel 3 on its
unstaged layouts makes two device launches and counts one). Kernels 1,
2 and 3 and the unbiased kernel count per layout, in a dict by the
layout's name (``FUSED_LAYOUTS``, ``BANKED_LAYOUTS``,
``RESIDUAL_LAYOUTS``, ``UNBIASED_LAYOUTS``): ``fused_layout``,
``banked_layout``, ``residual_layout`` and ``unbiased_layout`` choose it by
size, and the C entry point refuses a launch whose layout or scratch
disagrees with its own rule. The kernels
update the state in place. Wrappers take CUDA tensors only: ``ops.py``
sends CPU tensors to the plain versions in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "fused_update.cu", CSRC / "residual.cu",
           CSRC / "serial_update.cu", CSRC / "unbiased_update.cu")
_P = ctypes.c_void_p
_I = ctypes.c_int
_INT31 = 2**31

# Kernel 3's layouts by rows per sketch, and kernels 1 and 2's and the
# unbiased kernel's by slots per row, as residual.cu (kStageRows,
# kSumRows), fused_update.cu (kFusedStageSlots, kStageSlots) and
# unbiased_update.cu (kStageSlots) choose them.
RESIDUAL_STAGE_ROWS, RESIDUAL_SUM_ROWS = 128, 8192
FUSED_STAGE_SLOTS = 24576
BANKED_STAGE_SLOTS = 24576
UNBIASED_STAGE_SLOTS = 16384
RESIDUAL_LAYOUTS = ("staged", "summary+chain", "summary+chain/scratch")
FUSED_LAYOUTS = ("staged", "unstaged")
BANKED_LAYOUTS = ("staged", "unstaged")
UNBIASED_LAYOUTS = ("staged", "global")


def residual_layout(R: int) -> str:
    """Kernel 3's layout for sketches of R rows of 128 slots: the whole
    sketch in shared memory (R <= 128); else a summary pass over the card
    and a chain launch, the row summaries in shared memory (R <= 8,192) or
    in the scratch."""
    return RESIDUAL_LAYOUTS[0 if R <= RESIDUAL_STAGE_ROWS
                            else 1 if R <= RESIDUAL_SUM_ROWS else 2]


def fused_layout(K: int) -> str:
    """Kernel 1's layout for rows of K slots: the row's counts (and
    errors where it drains) in shared memory (K <= 24,576), else in
    device memory with the chunk minima in the scratch."""
    return FUSED_LAYOUTS[0 if K <= FUSED_STAGE_SLOTS else 1]


def banked_layout(K: int) -> str:
    """Kernel 2's layout for rows of K slots: the row's counts and errors
    in shared memory (K <= 24,576), else in device memory with the chunk
    minima in the scratch."""
    return BANKED_LAYOUTS[0 if K <= BANKED_STAGE_SLOTS else 1]


def unbiased_layout(K: int) -> str:
    """The unbiased kernel's layout for banks whose larger row holds K
    slots: the row in shared memory (K <= 16,384), else in device
    memory."""
    return UNBIASED_LAYOUTS[0 if K <= UNBIASED_STAGE_SLOTS else 1]


def entry_point(source: str, name: str, n_ptr: int, n_int: int):
    """A kernel's C entry point, building its library first if needed:
    ``n_ptr`` pointers, then ``n_int`` ints, then the stream."""
    return _build.entry_point(CSRC / source, name,
                              (_P,) * n_ptr + (_I,) * n_int)


def _serial_scratch_ints():
    """``sketch_serial_scratch_ints(n)`` of ``serial_update.cu``: the ints
    of global scratch a serial launch over n slots needs."""
    fn = _build.load(CSRC / "serial_update.cu").sketch_serial_scratch_ints
    fn.argtypes = [_I]
    fn.restype = ctypes.c_longlong
    return fn


def _scratch(n: int, device):
    """(pointer, ints) of an n-int device scratch: NULL where n = 0."""
    if n == 0:
        return 0, 0
    return torch.empty(n, dtype=torch.int32, device=device), n


def _check(what, named, shapes, device) -> None:
    _build.refuse_grad(what, named)
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
    """``fn`` on the tensors' pointers (an int: a pointer as it is), then
    the ints."""
    ptrs = [t if isinstance(t, int) else t.data_ptr() for t in tensors]
    _build.launch(fn, [*ptrs, *ints], device, what)


def _check_variant(variant: int) -> None:
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 (lazy) or 2 (SS±), got {variant}")


def sketch_update_kernel_fused(ids, counts, errors, delta, h_uids, h_net,
                               i0, mu, nnu, w_del, uoff=None, *,
                               variant: int = 2):
    """Apply one block's per-cell update to the (R, K) bank in place.

    ``ids, counts, errors, delta``: (R, K) int32; ``i0, mu, nnu, w_del``:
    (R,) int32 per-row scalars. The grouped residual layout ``h_uids,
    h_net``: (R, B) int32, row r's run at ``r * B``
    (``bank.phase1_dense_prep``; ``uoff`` None), or flat (G,) int32 with
    ``uoff`` (R,) int32 the start of each row's run
    (``bank.phase1_partition_prep``). Returns ``(ids, counts, errors)``,
    the same tensors, updated.
    """
    R, K = ids.shape
    flat = uoff is not None
    B = h_uids.shape[-1]
    G = B if flat else R * B
    named = dict(ids=ids, counts=counts, errors=errors, delta=delta,
                 h_uids=h_uids, h_net=h_net, i0=i0, mu=mu, nnu=nnu,
                 w_del=w_del)
    if flat:
        named["uoff"] = uoff
    run = (B,) if flat else (R, B)
    shapes = dict(ids=(R, K), counts=(R, K), errors=(R, K), delta=(R, K),
                  h_uids=run, h_net=run, i0=(R,), mu=(R,), nnu=(R,),
                  w_del=(R,), uoff=(R,))
    _check("sketch_update_kernel_fused", named, shapes, ids.device)
    _check_variant(variant)
    _check_sizes("sketch_update_kernel_fused", R, K, B, G, R * K)
    layout = fused_layout(K)
    # the unstaged rows' chunk minima
    scratch, n = _scratch(R * -(-K // 32) if layout == "unstaged" else 0,
                          ids.device)
    _launch(entry_point("fused_update.cu", "sketch_fused_update", 12, 6),
            # NULL uoff: the (R, B) rows back to back, row r's run at r * B
            [ids, counts, errors, delta, h_uids, h_net, i0, mu, nnu, w_del,
             uoff if flat else 0, scratch],
            (R, K, G, variant, FUSED_LAYOUTS.index(layout), n), ids.device,
            "fused_update")
    sketch_update_kernel_fused.launches[layout] += 1
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
    layout = banked_layout(K)
    # the unstaged rows' chunk minima
    scratch, n = _scratch(R * -(-K // 32) if layout == "unstaged" else 0,
                          ids.device)
    _launch(entry_point("fused_update.cu", "sketch_residual_banked", 10, 6),
            [*named.values(), scratch],
            (R, K, G, variant, BANKED_LAYOUTS.index(layout), n), ids.device,
            "residual_banked")
    sketch_residual_kernel_banked.launches[layout] += 1
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
    if not _build.aligned16(ids2, cnt2, err2):
        raise ValueError("sketch_residual_kernel: the state must start on a "
                         "16-byte boundary (rows are read 16 bytes a lane)")
    layout = residual_layout(R)
    # the unstaged layouts' row and group summaries
    scratch, n = _scratch(0 if layout == "staged"
                          else E * (2 * R + 2 * -(-R // 32)), ids2.device)
    _launch(entry_point("residual.cu", "sketch_residual", 9, 6),
            [*named.values(), scratch],
            (E, R, B, variant, RESIDUAL_LAYOUTS.index(layout), n),
            ids2.device, "residual")
    sketch_residual_kernel.launches[layout] += 1
    return ids2, cnt2, err2


def sketch_update_kernel_serial(ids2, cnt2, err2, items, weights, *,
                                variant: int = 2, saturate: bool = False):
    """One update per raw item, in order, on one sketch in place.

    ``ids2, cnt2, err2``: (R, 128) int32 row view (``phases.pad_rows``);
    ``items, weights``: (B,) int32, weights signed (0 = padding).
    ``saturate``: the insert adds saturate, as ``blocks.apply_update``'s
    (the serial backend), instead of wrapping as the reference's serial
    Pallas kernel's. Returns ``(ids2, cnt2, err2)``, updated.
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
    n = R * lanes
    # where the slots and the structures do not fit in shared memory
    # together, the structures live in a scratch
    with torch.cuda.device(ids2.device):
        n_scratch = _serial_scratch_ints()(n)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.int32,
                          device=ids2.device)
    _launch(entry_point("serial_update.cu", "sketch_serial_update", 6, 4),
            [*named.values(), scratch], (n, B, variant, int(saturate)),
            ids2.device, "serial_update")
    sketch_update_kernel_serial.launches += 1
    return ids2, cnt2, err2


def sketch_unbiased_kernel(ids_i, cnt_i, err_i, ids_d, cnt_d, err_d, items,
                           weights, u, perm, roff):
    """The unbiased variant's update of both banks in place.

    ``ids_i, cnt_i, err_i``: the (R, Ki) insert bank, ``ids_d, cnt_d,
    err_d`` the (R, Kd) delete bank, int32; the flat layout of
    ``family.unbiased_prep``: ``items, weights`` (B,) int32 (id-sorted,
    weights signed), ``perm`` (B,) int32 positions by class, ``roff``
    (2R+1,) int32 class starts; ``u`` (2, B) float32, one uniform per
    bank and position. Returns the six tensors, updated.
    """
    R, Ki = ids_i.shape
    Kd = ids_d.shape[1]
    B = items.shape[0]
    named = dict(ids_i=ids_i, cnt_i=cnt_i, err_i=err_i, ids_d=ids_d,
                 cnt_d=cnt_d, err_d=err_d, items=items, weights=weights,
                 perm=perm, roff=roff)
    shapes = dict(ids_i=(R, Ki), cnt_i=(R, Ki), err_i=(R, Ki),
                  ids_d=(R, Kd), cnt_d=(R, Kd), err_d=(R, Kd), items=(B,),
                  weights=(B,), perm=(B,), roff=(2 * R + 1,))
    _build.refuse_grad("sketch_unbiased_kernel", dict(u=u))
    _check("sketch_unbiased_kernel", named, shapes, ids_i.device)
    _build.check_operands("sketch_unbiased_kernel", dict(u=u), ids_i.device)
    if u.dtype != torch.float32 or tuple(u.shape) != (2, B):
        raise ValueError(f"sketch_unbiased_kernel: u must be float32 of "
                         f"shape {(2, B)}, got {u.dtype} {tuple(u.shape)}")
    _check_sizes("sketch_unbiased_kernel", R, Ki, Kd, B, 2 * R + 1, R * Ki,
                 R * Kd)
    layout = unbiased_layout(max(Ki, Kd))
    _launch(entry_point("unbiased_update.cu", "sketch_unbiased_update", 11,
                        5),
            [ids_i, cnt_i, err_i, ids_d, cnt_d, err_d, items, weights, u,
             perm, roff], (R, Ki, Kd, B, UNBIASED_LAYOUTS.index(layout)),
            ids_i.device, "unbiased_update")
    sketch_unbiased_kernel.launches[layout] += 1
    return ids_i, cnt_i, err_i, ids_d, cnt_d, err_d


# launches since the last reset (chip_smoke.py reads them around each path);
# kernels 1, 2 and 3 and the unbiased kernel per layout
sketch_update_kernel_fused.launches = dict.fromkeys(FUSED_LAYOUTS, 0)
sketch_residual_kernel_banked.launches = dict.fromkeys(BANKED_LAYOUTS, 0)
sketch_residual_kernel.launches = dict.fromkeys(RESIDUAL_LAYOUTS, 0)
sketch_update_kernel_serial.launches = 0
sketch_unbiased_kernel.launches = dict.fromkeys(UNBIASED_LAYOUTS, 0)
WRAPPERS = (sketch_update_kernel_fused, sketch_residual_kernel_banked,
            sketch_residual_kernel, sketch_update_kernel_serial,
            sketch_unbiased_kernel)


# A CUDA graph launches its kernels at every replay, but a wrapper counts
# only when it runs, which is once, at capture. The capture's counts are
# therefore taken back, kept as the graph's delta and added at each
# replay (``session._CapturedIngest``).

def launch_counts() -> dict:
    """A snapshot of every sketch wrapper's counter, by wrapper name (a
    dict per layout, or an int)."""
    return {fn.__name__: (dict(fn.launches) if isinstance(fn.launches, dict)
                          else fn.launches) for fn in WRAPPERS}


def launch_delta(before: dict, after: dict) -> dict:
    """What ran between two snapshots: ``after - before`` per wrapper and
    layout, the entries that did not move left out."""
    delta = {}
    for name, now in after.items():
        if isinstance(now, dict):
            moved = {key: n - before[name][key] for key, n in now.items()
                     if n != before[name][key]}
        else:
            moved = now - before[name]
        if moved:
            delta[name] = moved
    return delta


def add_counts(counts: dict, delta: dict) -> dict:
    """``counts`` plus ``delta`` (``launch_delta``'s form), a new dict."""
    out = {name: (dict(n) if isinstance(n, dict) else n)
           for name, n in counts.items()}
    for name, moved in delta.items():
        if isinstance(moved, dict):
            for key, n in moved.items():
                out[name][key] += n
        else:
            out[name] += moved
    return out


def set_launch_counts(counts: dict) -> None:
    """Set every sketch wrapper's counter from a ``launch_counts``
    snapshot."""
    for fn in WRAPPERS:
        n = counts[fn.__name__]
        fn.launches = dict(n) if isinstance(n, dict) else n


__all__ = ["SOURCES", "RESIDUAL_LAYOUTS", "FUSED_LAYOUTS", "BANKED_LAYOUTS",
           "UNBIASED_LAYOUTS", "residual_layout", "fused_layout",
           "banked_layout", "unbiased_layout", "entry_point",
           "WRAPPERS", "launch_counts", "launch_delta", "add_counts",
           "set_launch_counts",
           "sketch_update_kernel_fused",
           "sketch_residual_kernel_banked", "sketch_residual_kernel",
           "sketch_update_kernel_serial", "sketch_unbiased_kernel"]
