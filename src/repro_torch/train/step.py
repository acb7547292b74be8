"""The train step (counterpart of ``repro/train/step.py``): loss ->
gradients -> clip -> AdamW, one call.

State contracts, as in the reference:
  - params: bf16 at scale (or the dtype the caller's init chose);
  - optimizer state: f32 master weights and moments, a tree like the
    params (``state_axes`` gives the logical axes of both);
  - on a mesh (``parallel.sharding.use_mesh``) ``init_state`` lays the
    whole state out as DTensors by ``state_axes`` (``param_specs``), the
    gradients come back laid out as their params, and AdamW, the clip
    and the global norm run on DTensors, so the new state keeps the
    layout (the reference's jit in_shardings);
  - batch: a dict of tensors on the params' device (``tokens``,
    ``labels``, and ``vision``, ``frames``, ``mask`` where the model
    takes them);
  - ``expert_counts`` in the metrics feeds the SS± expert-load sketch
    (``sketch.stats.ExpertLoadStats``) outside the step.

The gradient is autograd's through the port's model: kernel 5's op runs
the forward of every attention layer and gives its backward (the plain
attention's gradient, the reference's ``jax.grad`` of its plain-JAX
attention). ``abstract_state`` builds the state on the
``meta`` device: shapes and dtypes, no allocation, at any model size.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from ..models import build_model
from ..models.transformer import tree_leaves, tree_map
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update
from ..parallel import sharding as psh
from ..platform import DEFAULT_DEVICE

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def state_axes(param_axes) -> TrainState:
    """Logical-axes tree mirroring TrainState (for sharding specs)."""
    return TrainState(
        params=param_axes,
        opt=AdamWState(
            step="",                     # scalar, replicated
            master=param_axes,
            m=param_axes,
            v=param_axes,
        ),
    )


def abstract_state(cfg: ModelConfig, key=None) -> Tuple[TrainState,
                                                       TrainState]:
    """(TrainState of ``meta`` tensors, TrainState of logical axes): the
    shapes and dtypes of ``init_state``'s, with no allocation at any
    model size. ``key`` is taken for the reference's signature; the
    shapes do not depend on it."""
    params, axes = build_model(cfg).init(key, device="meta")
    return TrainState(params=params, opt=adamw_init(params)), \
        state_axes(axes)


def init_state(cfg: ModelConfig, key,
               device=DEFAULT_DEVICE) -> Tuple[TrainState, TrainState]:
    """Concrete (state, axes): bf16 params from ``key`` (an int seed or a
    ``torch.Generator`` on ``device``), the optimizer state from them;
    under a mesh, laid out on it by the axes (every rank draws the same
    whole state and keeps its slice)."""
    params, axes = build_model(cfg).init(key, device=device)
    state, axes = TrainState(params=params, opt=adamw_init(params)), \
        state_axes(axes)
    return psh.distribute(state, axes), axes


def loss_and_grads(model, params, batch, remat: bool, attention: str):
    """(loss, aux, grads): the loss and its gradient in every param leaf
    (zeros for a leaf the loss does not reach, as ``jax.grad`` gives),
    each in its param's dtype and, on a mesh, its param's layout."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = model.loss(live, batch, remat=remat, attention=attention)
    leaves = tree_leaves(live)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else _like(g, p)
                  for p, g in zip(leaves, got)])
    return loss.detach(), aux, tree_map(lambda _: next(grads), live)


def _like(g, p):
    """A DTensor gradient redistributed to its param's placements (a
    reduction's gradient may come back ``Partial``)."""
    if psh.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig = AdamWConfig(),
    remat: bool = True,
    microbatches: int = 1,
    attention: str = "kernel",
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 runs gradient accumulation: the batch is split
    into M slices run in turn, their gradients summed in f32 (each / M),
    the losses averaged and the expert counts summed, as the reference's
    scan does. ``attention="plain"`` runs the model on the plain
    attention (the twin a kernel run is held to)."""
    model = build_model(cfg)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        if microbatches == 1:
            loss, aux, grads = loss_and_grads(model, state.params, batch,
                                              remat, attention)
            expert_counts = aux["expert_counts"]
        else:
            M = microbatches
            for k, v in batch.items():
                if v.shape[0] % M:
                    raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows "
                                     f"does not split into {M} microbatches")
            slices = {k: v.reshape((M, v.shape[0] // M) + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            dev = tree_leaves(state.params)[0].device
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                   device=dev), state.params)
            loss = torch.zeros((), dtype=F32, device=dev)
            expert_counts = torch.zeros((max(cfg.num_experts, 1),),
                                        dtype=torch.int32, device=dev)
            for i in range(M):
                mb = {k: s[i] for k, s in slices.items()}
                l, aux, g = loss_and_grads(model, state.params, mb, remat,
                                           attention)
                grads = tree_map(lambda a, b: a + b.to(F32) / M, grads, g)
                loss = loss + l / M
                expert_counts = expert_counts + aux["expert_counts"]
        params, opt, metrics = adamw_update(grads, state.opt, state.params,
                                            opt_cfg)
        metrics = {
            "loss": loss.to(F32),
            "expert_counts": expert_counts,
            **metrics,
        }
        return TrainState(params=params, opt=opt), metrics

    return train_step


__all__ = ["TrainState", "state_axes", "abstract_state", "init_state",
           "build_train_step", "loss_and_grads"]
