"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``unitex_torch/csrc/<name>.cu`` has a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``unitex_torch/_build/`` (git-ignored) at first use, keyed by a hash of
the source and flags, so an edited source rebuilds and an unchanged one
is loaded as it is.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from unitex_torch/csrc at first use")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """Where the library of kernel ``name`` lives once built."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(name: str) -> float:
    """Compile kernel ``name`` unless it is built already.  Returns the
    wall seconds of the build (0.0 for a library that was already there).
    The compiler's ``-Xptxas -v`` report goes to ``<library>.log``.
    Raises ``RuntimeError`` with the compiler's output on a failure."""
    so = library_path(name)
    if os.path.exists(so):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    with open(f"{so}.log", "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, so)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
