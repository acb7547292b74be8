"""Build the CUDA sources of the port with nvcc and load them with ctypes.

A ``csrc/<name>.cu`` file exposes plain C entry points. ``load`` compiles
it at first use for ``sm_90a`` into ``platform.build_dir()`` (listed in
.gitignore) as ``lib<name>-<hash>.so``, where the hash covers the
source's bytes, the bytes of every ``#include "..."`` file it pulls in
(followed recursively, relative to the including file) and nvcc's
flags: a change to any of them builds a new library. ``build`` compiles
several sources at once, one nvcc process each, all started together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import subprocess
from typing import Iterable, List

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


__all__ = ["NVCC_FLAGS", "includes", "library_path", "build", "load"]
