"""ctypes wrapper around meshproc.cpp (lazy g++ build, cached .so).

The library is built into the git-ignored ``unitex_torch/_build/``, which
is not a package, so walking the package's modules never meets it."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "meshproc.cpp")
_SO = os.path.join(os.path.dirname(_HERE), "_build", "_meshproc.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return ctypes.CDLL(_SO)
    # build under a per-process name and rename into place, so processes
    # that build at once never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO)
        return ctypes.CDLL(_SO)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[native] meshproc build failed ({e}); numpy fallbacks active")
        _build_failed = True
        return None


def _get() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.qem_decimate.restype = ctypes.c_int
                lib.qem_decimate.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
                lib.farthest_point_sampling.restype = None
                lib.farthest_point_sampling.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ]
            _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def qem_decimate(
    vertices: np.ndarray, faces: np.ndarray, target_faces: int
) -> Tuple[np.ndarray, np.ndarray]:
    """C++ QEM edge-collapse decimation.  vertices [V,3] f32, faces [F,3]
    i32 -> (new_vertices, new_faces)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native meshproc unavailable")
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    out_nv = ctypes.c_int(0)
    nf = lib.qem_decimate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(f),
        int(target_faces),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(out_nv),
    )
    return out_v[: out_nv.value].copy(), out_f[:nf].copy()


def farthest_point_sampling(
    points: np.ndarray, k: int, start: int = 0
) -> np.ndarray:
    """Greedy max-min FPS; returns int32 indices [k].  Falls back to numpy
    when the native library is unavailable."""
    p = np.ascontiguousarray(points[:, :3], np.float32)
    n = len(p)
    k = min(k, n)
    lib = _get()
    if lib is not None:
        out = np.empty(k, np.int32)
        lib.farthest_point_sampling(
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k, start,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return out
    return _fps_numpy(p, k, start)


def _fps_numpy(p: np.ndarray, k: int, start: int = 0) -> np.ndarray:
    dist = np.full(len(p), np.inf, np.float32)
    idx = np.empty(k, np.int32)
    cur = start % len(p)
    for s in range(k):
        idx[s] = cur
        d = ((p - p[cur]) ** 2).sum(axis=1)
        np.minimum(dist, d, out=dist)
        cur = int(dist.argmax())
    return idx
