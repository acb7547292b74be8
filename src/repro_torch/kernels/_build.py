"""Build a CUDA source of the port with nvcc and load it with ctypes.

A ``csrc/<name>.cu`` file exposes a plain C entry point. ``load`` compiles
it at first use for ``sm_90a`` into ``platform.build_dir()`` (listed in
.gitignore) as ``lib<name>-<hash>.so``, where the hash covers the
source's bytes and nvcc's flags: a change to either builds a new library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

from ..platform import build_dir

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build the "
                           "repro_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(source: pathlib.Path) -> ctypes.CDLL:
    """The library built from ``source``, compiled first if it is not
    there yet. Raises with nvcc's output if the build fails."""
    lib = library_path(source)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        # write to a private name, then rename: a concurrent loader never
        # sees a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


__all__ = ["NVCC_FLAGS", "library_path", "load"]
