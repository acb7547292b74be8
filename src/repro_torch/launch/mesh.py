"""Production and smoke mesh builders (counterpart of
``repro/launch/mesh.py``).

Functions, never module-level constants: importing this module touches
no process group and no device. Each builds a ``DeviceMesh`` over the
default process group, which the caller starts first (one rank per
device; on one host, a gloo group over a ``FileStore``).
"""
from __future__ import annotations


def _mesh(device: str, shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for n in shape:
        need *= n
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world < need:
        raise RuntimeError(
            f"a {shape} mesh over {names} needs a process group of {need} "
            f"ranks; the default group has {world}. Start {need} ranks "
            f"(torch.distributed.init_process_group with world_size={need}) "
            f"before building it")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512).

    Axes: ("data", "model") / ("pod", "data", "model"). The pod axis is
    the slow dimension; batch shards over (pod, data), params TP over
    model and FSDP over data (``parallel.sharding.default_rules``).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_smoke_mesh(n_devices: int = 1, device: str = "cuda"):
    """A tiny mesh over ``n_devices`` ranks: (1, 1), or (n // 2, 2),
    over ("data", "model")."""
    if n_devices <= 1:
        return _mesh(device, (1, 1), ("data", "model"))
    return _mesh(device, (n_devices // 2, 2), ("data", "model"))
