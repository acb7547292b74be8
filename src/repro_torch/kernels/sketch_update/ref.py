"""Plain PyTorch versions of the sketch_update kernels.

Each computes what its CUDA kernel computes, and what the reference's
Pallas kernel body computes, in eager PyTorch. ``ops.py`` runs them for
CPU tensors; ``chip_smoke.py`` holds each kernel against its plain
version on the card.

- ``fused_update_ref``: the fused bank update (``csrc/fused_update.cu``,
  reference ``_fused_kernel_tile``, ``kernel.py:75``), on the dense
  prep's (R, B) layout or the partition prep's flat one with per-row
  offsets;
- ``residual_phase_banked`` (``sketch/bank.py``): the banked phase 2
  (kernel 2 of ``fused_update.cu``, reference ``_residual_kernel_banked``);
- ``residual_phase`` (``sketch/phases.py``): phase 2 of stacked single
  sketches (``csrc/residual.cu``, reference ``_residual_kernel``);
- ``serial_update_ref``: one update per raw item
  (``csrc/serial_update.cu``, reference ``_serial_kernel`` and
  ``_apply_one``, ``kernel.py:317``);
- ``unbiased_update_ref``: the unbiased variant's randomized eviction on
  both banks (``csrc/unbiased_update.cu``; the reference's plain-JAX
  ``_unbiased_rows``, ``repro/sketch/family.py:123``).
"""
from __future__ import annotations

import torch

from ...sketch.bank import phase1_apply, residual_phase_banked
from ...sketch.phases import residual_phase
from ...sketch.state import EMPTY, I32, INT_MAX, VARIANT_LAZY, SketchState, \
    sat_add


def fused_update_ref(ids, counts, errors, delta, h_uids, h_net, i0, mu, nnu,
                     w_del, uoff=None, variant: int = 2):
    """One block's per-cell update of the (R, K) bank.

    ``h_uids``/``h_net``: the grouped residual layout, (R, B) with row r's
    run at ``r * B`` (the dense prep, ``bank.phase1_dense_prep``), or flat
    (G,) with row r's run at ``uoff[r]`` (the partition prep,
    ``bank.phase1_partition_prep``); ``i0, mu, nnu, w_del``: (R,) per-row
    scalars. Returns new ``(ids, counts, errors)``; the inputs are not
    modified.
    """
    if uoff is None:
        R, B = h_uids.shape
        uoff = torch.arange(R, dtype=I32, device=ids.device) * B
        h_uids, h_net = h_uids.reshape(-1), h_net.reshape(-1)
    ids, counts, errors = phase1_apply(SketchState(ids, counts, errors),
                                       delta, h_uids, h_net, i0, mu, nnu,
                                       uoff)
    return residual_phase_banked(ids, counts, errors, h_uids, h_net, uoff,
                                 mu, mu + nnu, w_del, variant)


def _wrap32(x: int) -> int:
    """Python int folded into int32, as an int32 add wraps."""
    return (x + 2**31) % 2**32 - 2**31


def _sat32(x: int) -> int:
    """Python int clamped to +-(2**31 - 1), as ``state.sat_add`` clamps."""
    return max(-INT_MAX, min(INT_MAX, x))


def serial_update_ref(ids2, cnt2, err2, items, weights, variant: int = 2,
                      saturate: bool = False):
    """The raw items applied one at a time, in order, to one (R, 128)
    sketch: the reference's ``_apply_one`` per item, its ``jnp.where``
    selects written as branches. Its int32 adds wrap; with ``saturate``
    the two insert adds saturate, as ``blocks.apply_update``'s. Returns
    new tensors; the inputs are not modified."""
    add = _sat32 if saturate else _wrap32
    shape = ids2.shape
    ids, counts, errors = (t.reshape(-1).clone() for t in (ids2, cnt2, err2))
    for item, w in zip(items.tolist(), weights.tolist()):
        if w == 0:
            continue
        # jnp.maximum(-w, 0) in int32: -INT_MIN wraps to INT_MIN, hence 0
        wd = max(_wrap32(-w), 0)
        eq = (ids == item) & (ids >= 0)
        if bool(eq.any()):                       # monitored: add w
            j = int(torch.argmax(eq.to(I32)))
            counts[j] = (add(int(counts[j]) + w) if w > 0
                         else _wrap32(int(counts[j]) - wd))
        elif w > 0:
            empty = ids == -1
            if bool(empty.any()):                # the first EMPTY slot
                j = int(torch.argmax(empty.to(I32)))
                ids[j], counts[j], errors[j] = item, w, 0
            else:                                # evict the minimum count
                j = int(torch.argmin(counts))
                mc = int(counts[j])
                ids[j], counts[j], errors[j] = item, add(mc + w), mc
        elif variant != VARIANT_LAZY:            # SS±: spread the deletion
            rem = wd
            while rem > 0:
                j = int(torch.argmax(errors))
                d = min(rem, int(errors[j]))
                if d <= 0:
                    break
                counts[j] = _wrap32(int(counts[j]) - d)
                errors[j] = _wrap32(int(errors[j]) - d)
                rem -= d
    return ids.reshape(shape), counts.reshape(shape), errors.reshape(shape)


def _unbiased_step(ids, cnt, err, uid, w, u, active):
    """One lockstep step of the reference's ``_unbiased_rows`` scan: each
    row applies its entry ``(uid, w, u)`` where ``active``."""
    lane = torch.arange(ids.shape[1], device=ids.device)[None, :]
    eq = (ids == uid[:, None]) & (ids >= 0)
    monitored = eq.any(dim=1)
    slot_mon = torch.argmax(eq.to(I32), dim=1)      # the first, as jnp's
    empty = ids == EMPTY
    has_empty = empty.any(dim=1)
    slot_empty = torch.argmax(empty.to(I32), dim=1)
    cnt_min = torch.where(empty, INT_MAX, cnt)
    jmin = torch.argmin(cnt_min, dim=1)
    mc = cnt_min.gather(1, jmin[:, None])[:, 0]
    sel = torch.where(monitored, slot_mon, torch.where(has_empty, slot_empty,
                                                       jmin))
    old_cnt = cnt.gather(1, sel[:, None])[:, 0]
    old_err = err.gather(1, sel[:, None])[:, 0]
    new_cnt = torch.where(monitored, sat_add(old_cnt, w),
                          torch.where(has_empty, w, sat_add(mc, w)))
    # float32, each operation rounded on its own, as the reference
    take = u * (mc.to(torch.float32) + w.to(torch.float32)) \
        < w.to(torch.float32)
    evicted = ids.gather(1, jmin[:, None])[:, 0]
    new_id = torch.where(monitored | has_empty, uid,
                         torch.where(take, uid, evicted))
    new_err = torch.where(monitored, old_err, torch.where(has_empty, 0, mc))
    hot = (lane == sel[:, None]) & active[:, None]
    return (torch.where(hot, new_id[:, None], ids),
            torch.where(hot, new_cnt[:, None], cnt),
            torch.where(hot, new_err[:, None], err))


def unbiased_update_ref(ids_i, cnt_i, err_i, ids_d, cnt_d, err_d, items,
                        weights, u, perm, roff):
    """Both banks' randomized-eviction update from the flat layout of
    ``family.unbiased_prep`` (the unbiased kernel's operands). Per bank,
    the rows step through their entries in lockstep, the reference's
    step on each: a row's entries are the positions it owns in block
    order, and zero-weight positions, which the reference also visits,
    are no-ops. ``perm`` and ``roff`` may list a subset of the rows'
    positions (a sample of rows: ``roff`` then has 2R + 1 entries for
    the R rows given). Returns six new tensors; the inputs are not
    modified."""
    R = ids_i.shape[0]
    last = max(perm.shape[0] - 1, 0)
    out = []
    for side, bank in enumerate(((ids_i, cnt_i, err_i),
                                 (ids_d, cnt_d, err_d))):
        ids, cnt, err = bank
        lo = roff[side * R:side * R + R].long()
        n = roff[side * R + 1:side * R + R + 1].long() - lo
        for step in range(int(n.max()) if R else 0):
            p = perm[torch.clamp(lo + step, max=last)].long()
            uid = items[p]
            w = weights[p] if side == 0 else -weights[p]
            w = torch.clamp(w, min=0)
            active = (step < n) & (w > 0) & (uid >= 0)
            ids, cnt, err = _unbiased_step(ids, cnt, err, uid, w,
                                           u[side, p], active)
        out += [ids, cnt, err]
    return tuple(out)


__all__ = ["fused_update_ref", "residual_phase_banked", "residual_phase",
           "serial_update_ref", "unbiased_update_ref"]
