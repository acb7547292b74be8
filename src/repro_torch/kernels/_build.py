"""Build the CUDA sources of the port with nvcc and load them with ctypes.

A ``csrc/<name>.cu`` file exposes plain C entry points. ``load`` compiles
it at first use for ``sm_90a`` into ``platform.build_dir()`` (listed in
.gitignore) as ``lib<name>-<hash>.so``, where the hash covers the
source's bytes, the bytes of every ``#include "..."`` file it pulls in
(followed recursively, relative to the including file) and nvcc's
flags: a change to any of them builds a new library. ``build`` compiles
several sources at once, one nvcc process each, all started together.
``entry_point`` binds one C entry point of a library and ``launch`` calls
it on the current stream, raising on a refused launch. ``refuse_grad``,
``check_operands`` and ``aligned16`` are the operand checks every
wrapper shares.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import subprocess
from typing import Iterable, List, Sequence

import torch

from ..platform import build_dir

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build the "
                           "repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def includes(source: pathlib.Path) -> List[pathlib.Path]:
    """The quoted includes ``source`` pulls in, recursively, each once."""
    seen: List[pathlib.Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes())
    for dep in sorted(includes(source)):
        digest.update(dep.name.encode())
        digest.update(dep.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(sources: Iterable[pathlib.Path]) -> None:
    """Compile every source whose library is missing, one nvcc each, all
    at once. Raises with nvcc's output if a build fails."""
    procs = []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        # write to a private name, then rename: a concurrent loader never
        # sees a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((source, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {source.name} ({proc.returncode}):"
                          f"\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(source: pathlib.Path) -> ctypes.CDLL:
    """The library built from ``source``, compiled first if it is not
    there yet."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))


@functools.lru_cache(maxsize=None)
def entry_point(source: pathlib.Path, name: str, argtypes: tuple):
    """The C entry point ``name`` of ``source``'s library, building it first
    if needed. It takes ``argtypes``, then the stream, and returns a CUDA
    error code (0 when the launch was accepted)."""
    fn = getattr(load(source), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def refuse_grad(what: str, named: dict) -> None:
    """Raise when grad mode is on and an operand requires grad: a kernel
    fills its outputs through ctypes, so its result would be cut from the
    autograd graph and a backward would drop its share of the gradient
    without a word. Every wrapper checks this first, before the device.
    Kernel 5 takes part in autograd through ``FlashAttentionFn``."""
    if not torch.is_grad_enabled():
        return
    for name, t in named.items():
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                f"{what}: {name} requires grad and grad mode is on; the "
                f"kernel has no backward and its result would be detached "
                f"from the graph. Call it under torch.no_grad() on detached "
                f"operands (flash attention: use FlashAttentionFn)")


def check_operands(what: str, named: dict, device: torch.device) -> None:
    """Every operand a contiguous CUDA tensor on ``device`` whose elements
    an int indexes."""
    for name, t in named.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{device} (got {t.device}); CPU tensors take "
                             f"ref.py")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{what}: {name} has {t.numel()} elements; the "
                             f"kernel indexes rows with int")


def aligned16(*tensors: torch.Tensor) -> bool:
    """Every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch(fn, args: Sequence, device: torch.device, what: str) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream; raises if the
    launch was refused (it would never run, and no synchronise reports
    it)."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:   # make the device current for the launch
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


__all__ = ["NVCC_FLAGS", "includes", "library_path", "build", "load",
           "entry_point", "refuse_grad", "check_operands", "aligned16",
           "launch"]
