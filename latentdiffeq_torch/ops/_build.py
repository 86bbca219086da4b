"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``<repo>/build/kernels/``,
then loaded with ``ctypes``. Nothing includes PyTorch's headers, so a build
takes seconds, not minutes. Builds happen at first use, never at import;
a library is rebuilt when the hash of its source, the ``csrc/`` headers it
includes and its flags changes, and all stale kernels compile in parallel
(one ``nvcc`` per source). A build that fails raises with the compiler's
output.

Generated sources (``register_generated``: the RK kernels on a functor
lowered from a Python field, or the Kuramoto lane-group kernels at another
width, ops/rhs_codegen.py) are written under ``build/kernels/`` and named
by the hash of their text, the headers and the flags, so a name is built
once and never goes stale; they compile with ``GEN_FLAGS`` and ``-I`` the
``csrc/`` directory. Every library compiles to a file of the building
process's own and is renamed into place, so processes that build at once
(test workers, the ranks of a launch) never load another's half-written
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "GEN_FLAGS", "build_kernels",
           "load_kernel", "build_log", "register_generated", "BUILD_DIR",
           "CSRC_DIR"]

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
# Generated sources: the RK kernels', unfused likewise.
GEN_FLAGS = NVCC_FLAGS + ["--fmad=false"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_GENERATED: Dict[str, str] = {}  # name -> source text


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
    if name in _GENERATED:
        return GEN_FLAGS + [f"-I{CSRC_DIR}"]
    return NVCC_FLAGS + _EXTRA_FLAGS.get(name, [])


def _paths(name: str):
    if name in _GENERATED:
        src = os.path.join(BUILD_DIR, f"{name}.cu")
    else:
        src = os.path.join(CSRC_DIR, KERNEL_SOURCES[name])
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, lib, lib + ".sha256", os.path.join(BUILD_DIR, f"{name}.log")


def _headers(text: str):
    """The csrc/ headers a source includes (``#include "x.cuh"``)."""
    return [h for h in re.findall(r'#include\s+"([^"]+)"', text)
            if os.path.exists(os.path.join(CSRC_DIR, h))]


def _hash(text: str, flags) -> str:
    h = hashlib.sha256(text.encode())
    for name in _headers(text):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def _digest(name: str) -> str:
    with open(_paths(name)[0]) as f:
        return _hash(f.read(), _flags(name))


def register_generated(prefix: str, text: str) -> str:
    """Register a generated source; returns its library name,
    ``<prefix>_<hash>``, for ``build_kernels`` and ``load_kernel``. Writes
    nothing until it is built."""
    name = f"{prefix}_{_hash(text, GEN_FLAGS)[:16]}"
    _GENERATED[name] = text
    return name


def _fresh(name: str) -> bool:
    _, lib, stamp, _ = _paths(name)
    if name in _GENERATED:  # named by its hash
        return os.path.exists(lib)
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == _digest(name)


def _write_atomic(path: str, text: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, bool]:
    """Compile every stale kernel of ``names`` (default: the csrc/
    sources; generated names from ``register_generated`` too), all at
    once. Returns {name: True if it was compiled now}. Raises RuntimeError
    with the compiler output (and a generated source's path) when a build
    fails."""
    names = list(KERNEL_SOURCES if names is None else names)
    stale = [n for n in names if not _fresh(n)]
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in stale:
            src, lib, _, _ = _paths(n)
            if n in _GENERATED:
                _write_atomic(src, _GENERATED[n])
            # one file a process: the ranks of a launch may build at once
            procs[n] = subprocess.Popen(
                [nvcc, *_flags(n), src, "-o", f"{lib}.{os.getpid()}.tmp"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for n, proc in procs.items():
            out, _ = proc.communicate()
            src, lib, stamp, log = _paths(n)
            _write_atomic(log, out)
            if proc.returncode != 0:
                where = f" (generated source {src})" if n in _GENERATED \
                    else ""
                failed.append(f"--- {n}{where} (nvcc exit "
                              f"{proc.returncode}) ---\n{out}")
                continue
            os.replace(f"{lib}.{os.getpid()}.tmp", lib)
            if n not in _GENERATED:
                _write_atomic(stamp, _digest(n))
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
