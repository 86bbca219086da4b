"""Time the two levers for one link of the neural-field solve's chain on one
CUDA card (kernels in node_field_levers.cu):

    python3 scripts/node_field_levers.py

  * a block barrier against a cluster barrier plus a 200-float exchange
    through distributed shared memory (cluster of 2 blocks);
  * one 200 x 200 relu layer at one row with its weights in registers
    against the same layer with its weights in shared memory.

64 blocks (the training batch at one row a block; 64 clusters of 2 for the
cluster barrier), time per iteration from CUDA events as the difference
of a long and a short run, so the launch cancels. Prints one line per
lever, the compiler's register and spill report, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(HERE), "build", "levers")


def build():
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "liblevers.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "nvcc")
    res = subprocess.run(
        [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
         os.path.join(HERE, "node_field_levers.cu"), "-o", lib],
        capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    report = [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    return ctypes.CDLL(lib), report


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    lib, report = build()
    lib.ldq_lever_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.ldq_lever_run.restype = ctypes.c_int
    for line in report:
        print(f"[ptxas] {line}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    W = (torch.randn(200, 200, generator=g) * 0.07).to(dev)
    b = (torch.randn(200, generator=g) * 0.1).to(dev)
    blocks = 64
    out = torch.empty(2 * blocks, 200, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(which, iters):
        err = lib.ldq_lever_run(which, blocks, iters, W.data_ptr(),
                                b.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            sys.exit(f"lever {which}: CUDA error {err}")

    def per_iter_ns(which, short=1000, long=11000, reps=5):
        run(which, 10)
        torch.cuda.synchronize()
        ts = []
        for iters in (short, long):
            best = float("inf")
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record()
                run(which, iters)
                z.record()
                torch.cuda.synchronize()
                best = min(best, a.elapsed_time(z))
            ts.append(best)
        return (ts[1] - ts[0]) * 1e6 / (long - short)

    names = ["block barrier + 200-float exchange",
             "cluster barrier (2 blocks) + 200-float DSMEM exchange",
             "200x200 layer, one row, weights in registers",
             "200x200 layer, one row, weights in shared memory"]
    res = {}
    for which, name in enumerate(names):
        res[name] = per_iter_ns(which)
        print(f"[levers] {name}: {res[name]:.1f} ns per iteration",
              flush=True)
    # both layer variants compute the same function
    run(2, 50)
    a = out[:blocks].clone()
    run(3, 50)
    torch.cuda.synchronize()
    print(f"[levers] layer reg vs smem max abs diff "
          f"{float((a - out[:blocks]).abs().max()):.3e}")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"levers_ns": res, "card": gpu}))


if __name__ == "__main__":
    main()
