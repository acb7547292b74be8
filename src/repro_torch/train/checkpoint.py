"""Atomic checkpoints in the reference's on-disk format (counterpart of
``repro/train/checkpoint.py``), so a checkpoint written by either
package restores in the other.

  - **Format**: ``<dir>/step_%010d/`` holds ``arrays.npz`` (one array per
    leaf) and ``manifest.json`` (``step``, the sorted ``keys``, each
    leaf's ``dtypes``, the caller's ``extra``, ``format`` 1). A leaf's
    key joins its path's NamedTuple field names, dict keys and sequence
    indices with ``/``. bf16 is stored as its ``uint16`` view (npz has no
    bf16) with ``"bfloat16"`` in ``dtypes``.
  - **Atomic**: written to ``<dir>/tmp.<step>`` and renamed: a crash
    mid-save never corrupts the latest checkpoint.
  - **Keep-N + milestones**: the last ``keep`` checkpoints survive, and
    every ``milestone_every``-th step for good.
  - **Restore**: each leaf cast to the dtype of the ``like`` tree's
    leaf after its keys and shapes are checked, onto ``device``; with
    ``axes`` under an active mesh, laid out on it by them (the elastic
    reshard: a checkpoint saved on any mesh, or none, restores onto the
    current one).
  - **Save on a mesh**: DTensor leaves are gathered whole first (every
    rank takes part) and rank 0 alone writes, the others waiting for it,
    so the files are the single-device ones.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import sharding as psh
from ..platform import DEFAULT_DEVICE, resolve_device

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(name, child) pairs of an inner node, or None for a leaf (None
    itself is an empty node, as in JAX's trees)."""
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for name, child in kids:
        flat.update(_flatten(child, f"{prefix}{_SEP}{name}" if prefix
                             else str(name)))
    return flat


def _rebuild(tree, fn: Callable, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [_rebuild(child, fn, f"{prefix}{_SEP}{name}" if prefix
                    else str(name)) for name, child in kids]
    if _is_namedtuple(tree):
        return type(tree)(*out)
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), out))
    return type(tree)(out)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name): bf16 as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(
    ckpt_dir: str | Path,
    step: int,
    state,
    *,
    extra: Optional[Dict] = None,
    keep: int = 3,
    milestone_every: int = 0,
) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:010d}"
    on_mesh = any(psh.is_dtensor(v) for v in _flatten(state).values())
    flat = _flatten(psh.gather(state))
    if on_mesh and dist.get_rank() != 0:
        dist.barrier()
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays, dtypes = {}, {}
    for k, v in flat.items():
        arrays[k], dtypes[k] = _to_numpy(v)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "dtypes": dtypes,
        "extra": extra or {},
        "format": 1,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1,
                                                  default=str))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish

    _gc(ckpt_dir, keep=keep, milestone_every=milestone_every)
    if on_mesh:
        dist.barrier()
    return final


def _gc(ckpt_dir: Path, keep: int, milestone_every: int) -> None:
    ckpts = sorted(ckpt_dir.glob("step_*"))
    if len(ckpts) <= keep:
        return
    for c in ckpts[:-keep]:
        step = int(c.name.split("_")[1])
        if milestone_every and step % milestone_every == 0:
            continue
        shutil.rmtree(c)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpts = sorted(Path(ckpt_dir).glob("step_*"))
    return int(ckpts[-1].name.split("_")[1]) if ckpts else None


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.asarray(leaf).dtype)).dtype


def restore(
    ckpt_dir: str | Path,
    like,
    *,
    step: Optional[int] = None,
    axes=None,
    table: str = "param",
    device=DEFAULT_DEVICE,
) -> Tuple[Any, Dict]:
    """(state, extra): the checkpoint at ``step`` (the latest by default)
    as a tree like ``like`` (tensors of any device, ``meta`` and DTensors
    included, or numpy arrays: their shapes and dtypes), each leaf a
    tensor on ``device`` in the like leaf's dtype. With ``axes`` (a
    logical-axes tree like ``like``) under an active mesh, each leaf is
    laid out on that mesh by ``param_specs`` (or ``act_specs`` with
    ``table="act"``), whatever mesh it was saved from; without a mesh
    ``axes`` changes nothing, as in the reference. Raises
    FileNotFoundError with no checkpoint, ValueError for a missing key
    or another shape."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    dev = resolve_device(device)
    d = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    dtypes = manifest.get("dtypes", {})

    missing = set(_flatten(like)) - set(manifest["keys"])
    if missing:
        raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    with np.load(d / "arrays.npz") as data:
        def leaf(key, want):
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(want)):
                raise ValueError(f"{key}: shape {arr.shape} != expected "
                                 f"{tuple(np.shape(want))}")
            if dtypes.get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, order="C"))
            return t.to(device=dev, dtype=_torch_dtype(want))

        state = _rebuild(like, leaf)
    if axes is not None:
        state = psh.distribute(state, axes, table)
    return state, manifest.get("extra", {})


__all__ = ["save", "latest_step", "restore"]
