"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``<repo>/build/kernels/``,
then loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build
takes seconds, not minutes. Builds happen at first use, never at import;
a library is rebuilt when the hash of its source and flags changes, and
all stale kernels compile in parallel (one ``nvcc`` per source). A build
that fails raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build_kernels", "load_kernel",
           "build_log", "BUILD_DIR", "CSRC_DIR"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

KERNEL_SOURCES = {
    "goku_heads": "goku_heads.cu",
    "rk_fixed_grid": "rk_fixed_grid.cu",
    "node_field": "node_field.cu",
}

# -Xptxas=-v records registers, shared memory and spills in the build log.
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# Per-kernel extra flags. The RK kernel keeps its multiply-adds unfused so
# its rounding follows the plain (elementwise) PyTorch version step by step.
_EXTRA_FLAGS = {"rk_fixed_grid": ["--fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built here")
    return found


def _flags(name: str):
    return NVCC_FLAGS + _EXTRA_FLAGS.get(name, [])


def _paths(name: str):
    src = os.path.join(CSRC_DIR, KERNEL_SOURCES[name])
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, lib, lib + ".sha256", os.path.join(BUILD_DIR, f"{name}.log")


def _digest(name: str) -> str:
    src = _paths(name)[0]
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return h.hexdigest()


def _fresh(name: str) -> bool:
    _, lib, stamp, _ = _paths(name)
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _digest(name)


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, bool]:
    """Compile every stale kernel of ``names`` (default: all), in parallel.
    Returns {name: True if it was compiled now}. Raises RuntimeError with
    the compiler output when a build fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    stale = [n for n in names if not _fresh(n)]
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in stale:
            src, lib, _, _ = _paths(n)
            # one file a process: the ranks of a launch may build at once
            procs[n] = subprocess.Popen(
                [nvcc, *_flags(n), src, "-o", f"{lib}.{os.getpid()}.tmp"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for n, proc in procs.items():
            out, _ = proc.communicate()
            _, lib, stamp, log = _paths(n)
            with open(log, "w") as f:
                f.write(out)
            if proc.returncode != 0:
                failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n"
                              f"{out}")
                continue
            os.replace(f"{lib}.{os.getpid()}.tmp", lib)
            with open(stamp, "w") as f:
                f.write(_digest(n))
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    return {n: n in stale for n in names}


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` ('' if none)."""
    log = _paths(name)[3]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(_paths(name)[1])
        _LIBS[name] = lib
    return lib
