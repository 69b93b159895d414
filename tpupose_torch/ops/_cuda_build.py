"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``tpupose_torch/csrc/<name>.cu`` with a plain C entry
point (no PyTorch headers, so ``nvcc`` takes seconds).  It is compiled for
``sm_90a`` at first use into ``tpupose_torch/_build/`` under a name keyed by
a hash of the source and the flags, and loaded with ``ctypes``.  Nothing is
built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3")
NVCC_FLAGS = ARCH_FLAGS + ("-shared", "-Xcompiler", "-fPIC")


def source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the built library of ``csrc/<name>.cu`` lives."""
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    ``nvcc`` process per source, all started together; returns
    ``{name: library path}``.  Raises if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]))
        failed = [name for name, (_, proc) in procs.items()
                  if proc.wait() != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}")
        for name, (tmp, _) in procs.items():
            os.replace(tmp, todo[name])
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; returns
    the library's path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.  Its
    ``<name>_error_string(int)`` is typed here; the caller types its launch
    function."""
    lib = ctypes.CDLL(build(name))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
