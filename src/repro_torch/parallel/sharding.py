"""Logical-axis sharding over a ``torch.distributed`` device mesh.

Counterpart of ``repro/parallel/sharding.py``. Every tensor dimension
carries a *logical* name ("batch", "heads", "ff", "experts", "shards",
...). A ``ShardingRules`` table maps logical names to mesh axes, and a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are those axes. ``_resolve`` turns a tensor's names
and shape into a ``PartitionSpec`` (the entries JAX's ``P`` holds: None,
an axis name, or a tuple of names), and ``placements`` turns that spec
into DTensor placements, one per mesh dimension.

The rules are the reference's, entry for entry:

- an axis appears at most once in a spec (a later name that would reuse
  it is replicated);
- a dimension that its axes' total size does not divide is replicated
  (qwen2's 28 q-heads on a 16-way model axis, say), so every (arch x
  mesh) cell has a layout.

Torch has no ambient mesh: ``use_mesh`` sets the thread's (mesh, rules)
for ``shard``, ``act_spec``, ``param_specs``, ``mesh_axis``,
``mesh_resize``, ``distribute`` and ``local_map``, and nothing else
reads it. Under a mesh a plain tensor that meets a DTensor in an op is
taken as replicated (DTensor's implicit replication), as a JAX array
without a sharding is: positions, masks, a batch every rank holds.

The model on a mesh: ``distribute`` lays a param (or state, or cache)
tree out as DTensors by its logical axes, each rank keeping its slice of
the whole tensor every rank holds (no communication), and ``gather``
takes it back to plain tensors. Activations follow the reference's
``shard`` calls (a redistribute) and DTensor's own propagation between
them. What DTensor has no rule for, and the kernels, run under
``local_map``: the function sees each rank's ``to_local()`` shards and
its outputs are wrapped back with the placements it states.

Parallelism coverage (the tables of ``default_rules``):
  DP    batch -> ("pod", "data")
  FSDP  param embed dim -> "data"
  TP    heads/kv/ff/vocab/inner -> "model"
  EP    experts -> "model"
  SP    long-context KV cache length -> "data" (batch=1 decode)
  the sketch banks' shard dim ("shards") -> the DP axes
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical dim name -> mesh axis (or tuple of axes, or None)."""

    act: Dict[str, Axis]
    param: Dict[str, Axis]

    def lookup(self, table: Dict[str, Axis], name: Optional[str]) -> Axis:
        if name is None:
            return None
        return table.get(name)


def default_rules(*, multi_pod: bool = False, fsdp: bool = True,
                  seq_shard: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    act = {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        # MoE dispatch groups: one group per DP shard; the capacity dim
        # inside a group stays local
        "groups": dp,
        "capacity": None,
        "inner": "model",
        "state": None,
        "frames": None,
        # KV-cache length over the model axis; with seq_shard (batch=1
        # long context) also over the data axes
        "cache": ("model",) + tuple(dp) if seq_shard else "model",
        # the hash-sharded sketch banks (sketch.sharded, and the shard x
        # level dyadic bank): each DP slice owns S/|data| shards, and a
        # block's ingest is shard-local
        "shards": dp,
    }
    param = {
        "embed": dp if fsdp else None,   # FSDP / ZeRO-3 storage sharding
        "heads": "model",
        "kv": "model",
        "head_dim": None,
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "inner": "model",
        "state": None,
        "conv": None,
        "period": None,                  # stacked-layer leading dim
        "frames": None,
        None: None,
    }
    return ShardingRules(act=act, param=param)


class PartitionSpec(tuple):
    """A tensor's layout over the mesh, one entry per dim: None
    (replicated), an axis name, or a tuple of names. As JAX's ``P``, a
    one-name tuple is held as the name and an empty one as None."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding(NamedTuple):
    """A spec on a mesh: what ``act_spec`` and ``param_specs`` give (the
    reference's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[ShardingRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate (mesh, rules) on this thread for ``shard``, ``act_spec``,
    ``param_specs``, ``mesh_axis`` and ``mesh_resize``. Without
    ``rules``: ``default_rules``, multi-pod when the mesh has a "pod"
    axis."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules or (
        default_rules(multi_pod="pod" in axis_names(mesh))
        if mesh is not None else None)
    try:
        with (_implicit_replication() if mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _CTX.mesh, _CTX.rules = old


@contextlib.contextmanager
def _implicit_replication():
    """DTensor ops take a plain tensor argument as replicated while open;
    the flag's earlier value comes back after (a nested mesh leaves its
    caller's setting as it was)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    old = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = old


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names or ())


HOST_MESH_RECIPE = (
    "start {n} ranks of a gloo process group over a FileStore first: in "
    "each of {n} processes, torch.distributed.init_process_group('gloo', "
    "store=torch.distributed.FileStore(path, {n}), rank=r, world_size={n})")


def host_device_mesh(n: int, axis: str = "shards", device: str = "cuda"):
    """A 1-D mesh named ``axis`` over the first ``n`` ranks of the default
    process group (the port's idiom for tests: a gloo group of ``n``
    processes on one host). Raises with that recipe when the world is
    smaller than ``n`` or no group is running."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world < n:
        raise RuntimeError(
            f"host_device_mesh({n}) needs {n} ranks but the default process "
            f"group has {world}; " + HOST_MESH_RECIPE.format(n=n))
    return DeviceMesh(device, torch.arange(n), mesh_dim_names=(axis,))


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    names = axis_names(mesh)
    if isinstance(axis, str):
        return mesh.size(names.index(axis))
    n = 1
    for a in axis:
        n *= mesh.size(names.index(a))
    return n


def _resolve(table: Dict[str, Axis], names, shape, mesh) -> PartitionSpec:
    spec = []
    used: set = set()
    for name, dim in zip(names, shape):
        ax = table.get(name) if name is not None else None
        # an axis may appear at most once in a spec
        flat = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if ax is None or any(a in used for a in flat):
            spec.append(None)
            continue
        if dim % _axis_size(mesh, ax) != 0:
            spec.append(None)  # divisibility fallback -> replicate
            continue
        used.update(flat)
        spec.append(ax)
    return PartitionSpec(*spec)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(i)`` where tensor dim i is bound to it, else
    ``Replicate()``. A dim bound to several axes is split over them in
    mesh order (the order ``default_rules`` writes them in)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in axis_names(mesh)]
    for dim, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
            out[axis_names(mesh).index(a)] = Shard(dim)
    return tuple(out)


def _dtensor_type():
    """The DTensor class once ``torch.distributed.tensor`` is imported,
    else None (no tensor can be a DTensor before; importing it costs
    over a second)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_dtensor(x) -> bool:
    cls = _dtensor_type()
    return cls is not None and isinstance(x, cls)


def full(x):
    """``x`` gathered whole: a DTensor's ``full_tensor()``, any other
    tensor as it is. A CUDA DTensor on a mesh whose groups are gloo's
    (ranks sharing one card) is gathered through host memory
    (``_gather_via_host``): DTensor's functional all-gather crashes
    there (torch 2.11), while gloo's own all-gather of host tensors
    works."""
    if not is_dtensor(x):
        return x
    local = x.to_local()
    if local.is_cuda and _gloo_mesh(x.device_mesh):
        return _gather_via_host(x).to(local.device)
    return x.full_tensor()


def _gloo_mesh(mesh) -> bool:
    import torch.distributed as dist

    return any(dist.get_backend(mesh.get_group(d)) == "gloo"
               for d in range(mesh.ndim))


def _gather_via_host(x) -> torch.Tensor:
    """A DTensor of ``Shard``/``Replicate`` placements with even shards,
    gathered on the host with ``torch.distributed.all_gather`` over each
    sharded mesh dimension's group, the last mesh dimension first (the
    inner split of a dim sharded over several)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    mesh, out = x.device_mesh, x.to_local().cpu()
    for d in reversed(range(mesh.ndim)):
        p = x.placements[d]
        if isinstance(p, Replicate):
            continue
        if not isinstance(p, Shard):
            raise ValueError(f"cannot gather a {p} placement on the host")
        parts = [torch.empty_like(out) for _ in range(mesh.size(d))]
        dist.all_gather(parts, out.contiguous(), group=mesh.get_group(d))
        out = torch.cat(parts, dim=p.dim)
    return out


def shard(x, *names: Optional[str]):
    """Lay out activation ``x``'s dims by their logical names' mesh axes.

    With no mesh it returns ``x``. A DTensor is redistributed to the
    resolved placements. A plain tensor is returned unchanged: the
    constraint is a layout hint, not a value, and a tensor that is not
    on the mesh has no layout to change (the reference's
    ``with_sharding_constraint`` likewise leaves every value as it is).
    """
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"shard: {len(names)} names {names} for a tensor "
                         f"of shape {tuple(x.shape)}")
    if not is_dtensor(x):
        return x
    spec = _resolve(rules.act, names, x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def act_spec(shape, *names: Optional[str]) -> Optional[NamedSharding]:
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, _resolve(rules.act, names, shape, mesh))


def mesh_axis(name: str, table: str = "act") -> Optional[Tuple[str, ...]]:
    """Resolved mesh axes for one logical dim name under the active mesh.

    The tuple of mesh axis names the logical dim binds to, with axes
    absent from the current mesh dropped, or None when no mesh/rules are
    active or nothing binds. Lets non-tensor consumers (the sharded
    sketch bank's shard dim) reuse the one rules table.
    """
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return None
    ax = getattr(rules, table).get(name)
    if ax is None:
        return None
    flat = (ax,) if isinstance(ax, str) else tuple(ax)
    flat = tuple(a for a in flat if a in axis_names(mesh))
    return flat or None


def mesh_resize(name: str, new_size: int,
                table: str = "act") -> Optional[Tuple[str, ...]]:
    """Mesh axes a logical dim keeps after resizing to ``new_size``.

    ``sketch.elastic.reshard_session`` resizes the shard dim S -> S' at
    run time; the resized dim stays bound to its mesh axes under the
    same divisibility rule ``_resolve`` applies. Returns the bound axes
    when ``new_size`` still divides their total size, or None when no
    mesh is active, nothing binds, or divisibility breaks (the caller
    falls back to the single-device path).
    """
    axes = mesh_axis(name, table)
    mesh = current_mesh()
    if axes is None or mesh is None:
        return None
    return axes if new_size % _axis_size(mesh, axes) == 0 else None


def parse_axes(names_str: str):
    """'period,embed,ff' -> ('period', 'embed', 'ff'); '' dims -> None."""
    return (tuple(n if n else None for n in names_str.split(","))
            if names_str else ())


def param_specs(param_tree, axes_tree):
    """``NamedSharding`` tree for a param tree and its logical-axes tree
    (the ``(params, axes)`` pair ``models.model`` ``init`` returns: the
    axes tree mirrors the params with comma-joined logical dim names,
    e.g. "period,embed,ff"). With no mesh every leaf maps to None."""
    return _tree_specs(param_tree, axes_tree, "param")


def act_specs(tree, axes_tree):
    """Like ``param_specs``, resolved against the activation table
    (batch/cache/seq layouts: KV caches, input batches)."""
    return _tree_specs(tree, axes_tree, "act")


def _tree_specs(tree, axes_tree, table_name: str):
    from torch.utils import _pytree

    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return _pytree.tree_map(lambda _: None, tree)
    table = getattr(rules, table_name)

    def one(p, names_str):
        # "" is a replicated leaf of any rank (the reference asserts
        # rank 0, which its own trainer's 1-D sketch leaves break)
        names = parse_axes(names_str) or (None,) * len(p.shape)
        if len(names) != len(p.shape):
            raise ValueError(f"axes {names_str!r} for a leaf of shape "
                             f"{tuple(p.shape)}")
        return NamedSharding(mesh, _resolve(table, names, p.shape, mesh))

    return _pytree.tree_map(one, tree, axes_tree)


# ---------------------------------------------------------------------------
# The model on the mesh: trees of DTensors, and functions on local shards
# ---------------------------------------------------------------------------

def _active_mesh():
    mesh = _CTX.mesh
    if mesh is None:
        raise RuntimeError("no mesh is active: enter parallel.sharding."
                           "use_mesh(mesh, rules) first")
    return mesh


def shard_index(ax: Axis, mesh=None) -> Tuple[int, int]:
    """(this rank's chunk, the number of chunks) of a dim bound to the
    mesh axes ``ax`` (None: (0, 1)). The first axis is the outer split,
    as ``placements`` lays a dim over several axes."""
    mesh = mesh if mesh is not None else _active_mesh()
    idx, n = 0, 1
    for a in ((ax,) if isinstance(ax, str) else tuple(ax or ())):
        size = mesh.size(axis_names(mesh).index(a))
        idx, n = idx * size + mesh.get_local_rank(a), n * size
    return idx, n


def lead_spec(shape, name: str) -> PartitionSpec:
    """The spec of a tensor split on its leading dim alone, by logical
    ``name`` (a rank's batch rows, dispatch groups), under the active
    mesh."""
    return act_spec(shape, name, *([None] * (len(shape) - 1))).spec


def lay_out(x: torch.Tensor, spec: PartitionSpec, mesh=None):
    """``x`` as a DTensor of ``spec`` on the mesh. A DTensor is
    redistributed; a plain tensor, which every rank holds whole and
    alike, is cut to this rank's slice with no communication."""
    from torch.distributed.tensor import DTensor

    mesh = mesh if mesh is not None else _active_mesh()
    pl = placements(spec, mesh)
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    local = x.contiguous()
    for dim, ax in enumerate(spec):
        if ax is not None:
            i, n = shard_index(ax, mesh)
            local = local.chunk(n, dim=dim)[i]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def distribute(tree, axes_tree, table: str = "param"):
    """``tree``'s tensors laid out on the active mesh by their logical
    axes (``param_specs``, or ``act_specs`` with ``table="act"``): plain
    leaves cut to this rank's slice, DTensor leaves redistributed. With
    no mesh, ``tree`` as it is."""
    from torch.utils import _pytree

    if _CTX.mesh is None or _CTX.rules is None:
        return tree
    specs = _tree_specs(tree, axes_tree, table)
    return _pytree.tree_map(
        lambda t, s: lay_out(t, s.spec) if isinstance(t, torch.Tensor)
        else t, tree, specs)


def gather(tree):
    """``tree`` with every DTensor leaf gathered whole (``full``)."""
    from torch.utils import _pytree

    return _pytree.tree_map(full, tree)


def local_map(fn, args, in_specs, out_specs):
    """``fn`` on each rank's local shards: ``fn(*locals)``, where each
    arg with a spec is laid out by it (``lay_out``) and taken
    ``to_local()``, and an arg whose spec is None is passed as it is.
    Each output is wrapped back as a DTensor of its ``out_specs`` entry
    (``fn`` returns one tensor for one spec, else a tuple).

    Differentiable: an arg replicated over a mesh axis over which some
    output is split takes its gradient as ``Partial`` there (each rank
    holds the part its own output shard gives; the redistribute after
    sums them), else with its own placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = _active_mesh()
    outs = (out_specs,) if isinstance(out_specs, PartitionSpec) \
        else tuple(out_specs)
    split = set()
    for spec in outs:
        for d, p in enumerate(placements(spec, mesh)):
            if isinstance(p, Shard):
                split.add(d)
    local = []
    for x, spec in zip(args, in_specs):
        if spec is None:
            local.append(x)
            continue
        d_x = lay_out(x, spec, mesh)
        grad = tuple(Partial() if d in split and isinstance(p, Replicate)
                     else p for d, p in enumerate(d_x.placements))
        local.append(_ContiguousGrad.apply(
            d_x.to_local(grad_placements=grad)))
    res = fn(*local)
    single = isinstance(out_specs, PartitionSpec)
    res = (res,) if single else tuple(res)
    wrapped = tuple(DTensor.from_local(r.contiguous(), mesh,
                                       placements(spec, mesh),
                                       run_check=False)
                    for r, spec in zip(res, outs))
    return wrapped[0] if single else wrapped


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    DTensor's ops take its local tensor's views as the global tensor's,
    which a strided local gradient (from a permute inside ``fn``) would
    break."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


__all__ = ["Axis", "ShardingRules", "default_rules", "PartitionSpec",
           "NamedSharding", "use_mesh", "current_mesh", "current_rules",
           "axis_names", "host_device_mesh", "placements", "is_dtensor",
           "full", "shard", "act_spec", "mesh_axis", "mesh_resize",
           "parse_axes", "param_specs", "act_specs", "shard_index",
           "lead_spec", "lay_out", "distribute", "gather", "local_map"]
