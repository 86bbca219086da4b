"""Time each lever of the RK solve kernels' design on its own, on one CUDA
card:

    python3 scripts/rk_levers.py [--rounds 3]

Builds csrc/rk_fixed_grid.cu seven ways into build/rk_levers/ (one nvcc
each, in parallel) and times each build's forward and backward kernels,
Tsit5, for the pendulum at the train shape (B 64, T 50) and the validation
shape (B 45, T 100), substeps 1, and for Kuramoto-10 at its train shape
(B 64, T 50) and validation shape (B 26, T 100), substeps 4, dt 0.1, with
each lever taken out in turn:
  - ``design``: the library as the port builds it;
  - ``sinf``: every sine and cosine by a call of sincosf (Kuramoto's
    forward: sinf) out of line (LDQ_RK_LEVER_SINF), as the design calls it
    for the accurate rerun, so each stage holds a call; for Kuramoto instead
    of the branch-free copy of sinf's fast path (its values are the same);
  - ``inline-sincos``: the same calls inlined (LDQ_RK_LEVER_SINF and
    LDQ_RK_LEVER_INLINE_SINCOS);
  - ``one-thread``: Kuramoto through the one-thread-a-trajectory kernels,
    the design before the lane groups (LDQ_RK_LEVER_KURAMOTO_ONE_THREAD;
    pendulum as the design);
  - ``one-cta``: the Kuramoto backward on one block a row, its intervals
    in chunks, instead of a cluster of blocks a row
    (LDQ_RK_LEVER_KURAMOTO_ONE_CTA; the rest as the design);
  - ``no-dt-table``: the forward loads saveat and divides at the top of each
    step (LDQ_RK_LEVER_NO_DT_TABLE) instead of reading a table of step sizes;
  - ``fmad``: built with --fmad=true (the compiler may fuse a multiply and
    an add, so rounding no longer follows the plain version);
  - ``generic``: the design build, with Tsit5 run by the instance that reads
    the tableau at run time instead of the one with it compiled in.
Device time per launch from torch.profiler (the mean over the launches it
recorded of 50; it can drop some, and then reads none), the
configurations in turns, ``--rounds`` rounds, the order reversed every other
round. Prints one line per configuration and round, then one JSON line with
the median of the rounds per configuration, each build's largest difference
from the design build's results, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

VARIANTS = {
    "design": None,
    "sinf": ["-DLDQ_RK_LEVER_SINF"],
    "inline-sincos": ["-DLDQ_RK_LEVER_SINF", "-DLDQ_RK_LEVER_INLINE_SINCOS"],
    "one-thread": ["-DLDQ_RK_LEVER_KURAMOTO_ONE_THREAD"],
    "one-cta": ["-DLDQ_RK_LEVER_KURAMOTO_ONE_CTA"],
    "no-dt-table": ["-DLDQ_RK_LEVER_NO_DT_TABLE"],
    "fmad": "fmad",
}


def build(root):
    from latentdiffeq_torch.ops import _build
    src = os.path.join(_build.CSRC_DIR, "rk_fixed_grid.cu")
    out = os.path.join(root, "build", "rk_levers")
    os.makedirs(out, exist_ok=True)
    nvcc = _build._nvcc()
    base = _build._flags("rk_fixed_grid")
    procs = {}
    for name, extra in VARIANTS.items():
        if extra is None:
            flags = base
        elif extra == "fmad":
            flags = [f for f in base if f != "--fmad=false"] + ["--fmad=true"]
        else:
            flags = base + extra
        lib = os.path.join(out, f"librk_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *flags, src, "-o", lib], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import Tsit5, tableau_f32

    paths = build(root)
    libs = {name: ode_cuda.typed_library(ctypes.CDLL(path))
            for name, path in paths.items()}
    dev = torch.device("cuda")
    solver = Tsit5()
    n, a, b, c = tableau_f32(solver)
    baked = ode_cuda.tableau_instance(solver)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {}
    for label, (B, T) in (("train", (64, 50)), ("val", (45, 100))):
        shapes[label] = dict(
            B=B, T=T, rhs=0, sub=1, cst=None,
            u0s=torch.rand(B, 2, generator=g, device=dev) * 2 - 1,
            ps=1 + torch.rand(B, 1, generator=g, device=dev),
            saveat=torch.arange(T, dtype=torch.float32, device=dev) * 0.05,
            w=torch.randn(B, T, 2, generator=g, device=dev),
            ys=torch.empty(B, T, 2, device=dev),
            ok=torch.empty(B, dtype=torch.bool, device=dev),
            du0=torch.empty(B, 2, device=dev),
            dp=torch.empty(B, 1, device=dev))
    N = 10  # Kuramoto-10, the examples' draws
    kind, _, _ = ode_cuda.DEVICE_RHS["kuramoto"][N]
    offsets = torch.zeros(N, device=dev)  # omega_spread 0
    for label, (B, T) in (("train", (64, 50)), ("val", (26, 100))):
        shapes[f"kuramoto10_{label}"] = dict(
            B=B, T=T, rhs=kind, sub=4, cst=offsets.data_ptr(),
            u0s=(torch.rand(B, N, generator=g, device=dev) * 2 - 1)
            * math.pi,
            ps=torch.stack([1 + 2 * torch.rand(B, generator=g, device=dev),
                            0.2 + 1.8 * torch.rand(B, generator=g,
                                                   device=dev)], dim=1),
            saveat=torch.arange(T, dtype=torch.float32, device=dev) * 0.1,
            w=torch.randn(B, T, N, generator=g, device=dev),
            ys=torch.empty(B, T, N, device=dev),
            ok=torch.empty(B, dtype=torch.bool, device=dev),
            du0=torch.empty(B, N, device=dev),
            dp=torch.empty(B, 2, device=dev))

    configs = {name: (libs[name], baked) for name in VARIANTS}
    configs["generic"] = (libs["design"], 0)

    def fwd(lib, kind, x):
        err = lib.ldq_rk_fixed_grid(
            x["rhs"], kind, n, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            x["saveat"].data_ptr(), x["u0s"].data_ptr(), x["ps"].data_ptr(),
            x["cst"], x["ys"].data_ptr(), x["ok"].data_ptr(), x["B"],
            x["T"], x["sub"], stream)
        assert err == 0, err

    def bwd(lib, kind, x):
        err = lib.ldq_rk_fixed_grid_bwd(
            x["rhs"], kind, n, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            x["saveat"].data_ptr(), x["ys"].data_ptr(), x["ps"].data_ptr(),
            x["cst"], x["w"].data_ptr(), x["du0"].data_ptr(),
            x["dp"].data_ptr(), None, None, x["B"], x["T"], x["sub"], stream)
        assert err == 0, err

    def device_ms(fn, kernels, reps=50):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
              for e in prof.events() if e.device_type.name == "CUDA"
              and any(k in e.name for k in kernels)]
        return sum(us) / 1e3 / len(us) if us else None

    # each build's results against the design build's, at the train shapes
    diffs = {}
    outs = {}
    for name, (lib, kind) in configs.items():
        outs[name] = []
        for label in ("train", "kuramoto10_train"):
            x = shapes[label]
            fwd(lib, kind, x)
            bwd(lib, kind, x)
            torch.cuda.synchronize()
            outs[name] += [x["ys"].clone(), x["du0"].clone(),
                           x["dp"].clone()]
    for name, out in outs.items():
        diffs[name] = max(float((p - q).abs().max())
                          for p, q in zip(out, outs["design"]))

    times = {name: {} for name in configs}
    order = list(configs)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            lib, kind = configs[name]
            row = {}
            for label, x in shapes.items():
                fwd(lib, kind, x)   # the trajectory the backward reads
                row[f"fwd_device_ms_{label}"] = device_ms(
                    lambda: fwd(lib, kind, x),
                    ("rk_fixed_grid_kernel", "rk_kuramoto_kernel"))
                row[f"bwd_device_ms_{label}"] = device_ms(
                    lambda: bwd(lib, kind, x),
                    ("rk_fixed_grid_bwd_kernel", "rk_kuramoto_bwd_kernel"))
            for k, v in row.items():
                times[name].setdefault(k, []).append(v)
            print(f"round {rnd} {name}: " + ", ".join(
                f"{k} {v}" for k, v in row.items()), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "median": {name: {k: statistics.median(x for x in v if x is not None)
                          for k, v in t.items()}
                   for name, t in times.items()},
        "max_abs_diff_vs_design": diffs, "card": card}), flush=True)


if __name__ == "__main__":
    main()
