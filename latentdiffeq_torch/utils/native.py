"""ctypes loader for the native (C++) host-side rasterizer (counterpart of
latentdiffeq/utils/native.py).

Builds the port's ``csrc/rasterizer.cpp`` with ``g++`` on first use into
``<repo>/build/native/`` (never into the JAX package's ``native/``),
keyed on a hash of the source and the flags as JAX's loader keys its
build (native.py:30-83), and exposes it with numpy wrappers: the host-side
twin of the torch renderer (``pendulum_data.render_frames``) that
``create_data.load_or_generate(renderer="native")`` takes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["native_render_trajectories", "load_native_lib"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "rasterizer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
_LIB: Optional[ctypes.CDLL] = None

# Portable flags: no -march=native, so a library built on another host
# never traps a newer or older microarchitecture.
_CXXFLAGS = ["-O3", "-shared", "-fPIC"]


def _digest() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    return h.hexdigest()


def _build(lib: str, digest: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"       # ranks may build at once
    subprocess.run(["g++", *_CXXFLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, lib)
    with open(lib + ".sha256", "w") as f:
        f.write(digest)


def load_native_lib() -> ctypes.CDLL:
    """Load (building if needed) the rasterizer's shared library. A library
    whose stamp does not match the source and flags is rebuilt; one that
    fails to load is rebuilt once and loaded again."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = os.path.join(BUILD_DIR, "librasterizer.so")
    digest = _digest()
    try:
        with open(lib + ".sha256") as f:
            fresh = f.read().strip() == digest and os.path.exists(lib)
    except OSError:
        fresh = False
    if not fresh:
        _build(lib, digest)
    try:
        _LIB = ctypes.CDLL(lib)
    except OSError:
        _build(lib, digest)
        _LIB = ctypes.CDLL(lib)
    _LIB.ldq_render_trajectories.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
    ]
    _LIB.ldq_render_trajectories.restype = None
    return _LIB


def native_render_trajectories(angles: np.ndarray, *,
                               pendulum_length: float = 19.0,
                               radius: float = 1.75,
                               rod_thickness: float = 3.75,
                               h: int = 28, w: int = 28) -> np.ndarray:
    """Render (n_traj, T) angles to (n_traj, T, h, w) float32 frames with
    the C++ rasterizer."""
    lib = load_native_lib()
    angles = np.ascontiguousarray(angles, dtype=np.float32)
    n, T = angles.shape
    out = np.empty((n, T, h, w), dtype=np.float32)
    lib.ldq_render_trajectories(
        angles.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, T, pendulum_length, radius, rod_thickness, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
