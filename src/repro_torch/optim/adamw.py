"""AdamW (counterpart of ``repro/optim/adamw.py``), the reference's math
in its order of operations, not ``torch.optim.AdamW`` (which adds the
decay before the step and eps elsewhere):

- params stay in their dtype (bf16 at scale); the optimizer keeps f32
  master copies and f32 moments (m, v). The update is computed in f32
  against the master weights and cast back to each param's dtype: the
  mixed-precision recipe, no loss scaling under bf16;
- gradients are clipped by their global norm (a 1e-12 floor on the
  norm), with the bias corrections ``1 - b ** step`` in f32;
- ``delta = mh / (sqrt(vh) + eps)``, plus the decoupled decay ``wd * w``
  only on leaves with ``ndim >= decay_min_ndim`` (a stacked (periods,
  D) norm scale counts 2 dims, as in the reference);
- metrics ``grad_norm`` and ``lr``, 0-d f32 tensors.

Trees are nested dicts (and tuples) of tensors, as the model's params;
``step`` is a 0-d int32 tensor on the params' device, so an update
never waits on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..models.transformer import tree_leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    master: Any              # f32 param copies (a tree like params)
    m: Any                   # first moment (f32)
    v: Any                   # second moment (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    decay_min_ndim: int = 2   # skip decay for params with ndim < this


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_device(params)),
        master=tree_map(lambda p: p.to(F32, copy=True), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                         device=p.device), params),
    )


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


def adamw_update(grads, state: AdamWState, params,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[Any, AdamWState,
                                                            dict]:
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        grads = tree_map(lambda g: g.to(F32), grads)
        gnorm = global_norm(grads)

    lr = (cfg.lr(step) if callable(cfg.lr)
          else torch.full((), cfg.lr, dtype=F32, device=step.device))
    b1, b2 = cfg.b1, cfg.b2
    # bias correction, in f32
    sf = step.to(F32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)

    def upd(g, m, v, w):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay and w.dim() >= cfg.decay_min_ndim:
            delta = delta + cfg.weight_decay * w
        return m, v, w - lr * delta

    out = tree_map(upd, grads, state.m, state.v, state.master)
    pick = lambda i: tree_map(lambda _, o: o[i], grads, out)  # noqa: E731
    master = pick(2)
    new_params = tree_map(lambda w, p: w.to(p.dtype), master, params)
    new_state = AdamWState(step=step, master=master, m=pick(0), v=pick(1))
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWState", "AdamWConfig", "adamw_init", "global_norm",
           "clip_by_global_norm", "adamw_update"]
