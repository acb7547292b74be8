"""Count what one rank does in a step, op by op.

``StepTrace`` is a ``TorchDispatchMode`` that sees every op a step
dispatches on one rank's tensors and keeps, per device:

- FLOPs, by the formulas of ``torch.utils.flop_counter`` (the ones
  ``FlopCounterMode`` uses, the port's kernel ops' included: kernels 5
  and 6 register theirs), an op without a formula first decomposed as
  ``FlopCounterMode`` decomposes it;
- bytes: the operand and result bytes of each op that computes (a view
  moves nothing);
- collectives: each communicating op's kind and result bytes
  (``roofline.collectives``);
- memory: the bytes of the storages alive, their peak, against the
  arguments registered before the step (``arguments``);
- with ``keep=True``, a row per op: its name, local shapes, the
  placements of a DTensor op, its FLOPs and bytes.

Every count is per device. A DTensor op is global: a mode outside
DTensor would see it at the global shapes, while a call inside
``sharding.local_map`` (kernels 5 and 6 on the mesh) runs on a rank's
local shards. So the mode hands a DTensor op back (``NotImplemented``):
DTensor then runs its local ops and collectives, and the mode counts
those, as one rank runs them. To find an op's global output shape,
DTensor first runs it on fake tensors of the global shapes (its sharding
propagation, under the step's own fake mode when there is one, else a
fake mode of its own); while the mode is open those runs are marked and
not counted: they are not the step's work. Run with real tensors, under
the step's ``FakeTensorMode`` (``fake_mode``), or on ``meta`` tensors.
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .collectives import collective_bytes, kind_of

# metadata queries: no work, nothing allocated (FlopCounterMode's list)
_QUERIES = {
    "aten::sym_is_contiguous", "aten::is_contiguous",
    "aten::is_strides_like_format", "aten::is_non_overlapping_and_dense",
    "aten::size", "aten::sym_size", "aten::stride", "aten::sym_stride",
    "aten::storage_offset", "aten::sym_storage_offset", "aten::numel",
    "aten::sym_numel", "aten::dim", "prim::layout", "prim::device",
    "_c10d_functional::wait_tensor",
}


def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None     # a tensor without storage (a subclass wrapper)


class StepTrace(TorchDispatchMode):
    """While open: counts of one rank's step (the module docstring).

    ``fake_mode`` is the ``FakeTensorMode`` the step's tensors belong to
    (None for real tensors): a fake tensor of any other mode is DTensor's
    sharding propagation, not the step."""

    def __init__(self, fake_mode=None, keep: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.keep = keep
        self.flops = 0
        self.bytes = 0
        self.calls: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.seen: List = []            # (collective kind, result bytes)
        self.rows: List[Dict] = []
        self.live = 0
        self.peak = 0
        self.arguments = 0
        self._alive: Dict[int, weakref.ref] = {}
        self._propagating = 0
        self._depth = 0
        self._saved = None

    def __enter__(self):
        # the outermost entry marks DTensor's propagation runs (the mode is
        # entered again around each decomposition)
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._depth += 1
        if self._depth == 1:
            run = ShardingPropagator._propagate_tensor_meta_non_cached
            trace = self

            def marked(prop, op_schema):
                trace._propagating += 1
                try:
                    return run(prop, op_schema)
                finally:
                    trace._propagating -= 1

            self._saved = run
            ShardingPropagator._propagate_tensor_meta_non_cached = marked
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._depth -= 1
        if self._depth == 0:
            ShardingPropagator._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    # -- memory --------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as alive until it dies; its bytes if it
        is new, else 0."""
        st = _storage(t)
        if st is None:
            return 0
        key = st._cdata
        if key in self._alive:
            return 0
        size = st.nbytes()

        def gone(_, key=key, size=size):
            self._alive.pop(key, None)
            self.live -= size

        self._alive[key] = weakref.ref(st, gone)
        self.live += size
        self.peak = max(self.peak, self.live)
        return size

    def hold_arguments(self, tree) -> int:
        """Register the step's inputs (a tree of tensors or DTensors) as
        alive before it runs; their per-device bytes (a DTensor counts its
        local shard) are added to ``arguments`` and returned."""
        got = 0
        for t in local_tensors(tree):
            got += self._hold(t)
        self.arguments += got
        return got

    # -- dispatch ------------------------------------------------------
    def _foreign(self, tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if any(issubclass(t, _dtensor_cls()) for t in types):
            if self.keep:
                self.rows.append(dict(op=str(func), dtensor=_describe(
                    (args, kwargs))))
            return NotImplemented
        if name in _QUERIES or self._propagating:
            return func(*args, **kwargs)
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if self._foreign(ins):
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self._foreign(outs):
            return out
        for t in outs:
            self._hold(t)
        kind = kind_of(name)
        moved = 0 if func.is_view else (sum(map(nbytes, ins))
                                        + sum(map(nbytes, outs)))
        flops = 0
        if func._overloadpacket in flop_registry:
            flops = int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        self.flops += flops
        self.bytes += moved
        self.flops_by_op[str(func._overloadpacket)] += flops
        self.calls[str(func._overloadpacket)] += 1
        if kind is not None:
            res = outs or [t for t in tree_leaves(args[:1])
                           if isinstance(t, torch.Tensor)]
            self.seen.append((kind, sum(map(nbytes, res))))
        if self.keep:
            self.rows.append(dict(
                op=str(func), shapes=[list(t.shape) for t in ins],
                out=[list(t.shape) for t in outs], flops=flops, bytes=moved,
                **({"collective": kind} if kind else {})))
        return out

    # -- results -------------------------------------------------------
    def collectives(self) -> Dict[str, int]:
        return collective_bytes(self.seen)

    def temp_bytes(self) -> int:
        """The peak of live bytes less the arguments'."""
        return max(self.peak - self.arguments, 0)


def local_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of ``tree``, a DTensor as its local shard."""
    out = []
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        if isinstance(t, _dtensor_cls()):
            t = t.to_local()
        out.append(t)
    return out


def tree_bytes(tree) -> int:
    """Per-device bytes of a tree: each tensor's local shard, each
    storage once."""
    seen, total = set(), 0
    for t in local_tensors(tree):
        st = _storage(t)
        key = st._cdata if st is not None else id(t)
        if key not in seen:
            seen.add(key)
            total += st.nbytes() if st is not None else nbytes(t)
    return total


def _describe(tree) -> List:
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, _dtensor_cls()):
            out.append(dict(shape=list(t.shape),
                            placements=[str(p) for p in t.placements]))
    return out


__all__ = ["StepTrace", "local_tensors", "tree_bytes", "nbytes"]
