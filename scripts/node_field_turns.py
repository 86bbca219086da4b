"""Time the neural-field kernels of the checkout this script lies in at
the main path's training shape (B 64, T 50, 16-200-200-16 relu, Tsit5) on
one CUDA card:

    python3 scripts/node_field_turns.py [--plain]

To compare two designs in turns in one call, unpack the older commit
beside this one, copy this script into its ``scripts/`` and run the two
copies alternately. ``--plain`` times the plain PyTorch versions instead.
Prints one JSON line: per pass the device time per launch of its kernels
(torch.profiler) and the time per call with the wrapper (CUDA events),
with the checkout's root and the card's name and power limit. A design
whose backward takes the forward's tape (``neural_field_sweep_cuda``
exists) is timed with the tape-writing forward that training runs and its
sweep plus weight-gradient kernels; the older design with its forward and
its recomputing backward kernel.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch import nn
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(40)
    m = nn.mlp((16, 200, 200, 16), nn.relu, nn.identity, generator=g)
    with torch.no_grad():
        for lyr in m.layers:
            lyr.b.copy_(torch.randn(lyr.b.shape, generator=g) * 0.1)
    m = m.to(dev)
    g = torch.Generator().manual_seed(41)
    u0s = (torch.randn(64, 16, generator=g) * 0.5).to(dev)
    saveat = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    w = torch.randn(64, 50, 16, generator=g).to(dev)
    solver = Tsit5()
    taped = hasattr(node_cuda, "neural_field_sweep_cuda")

    def event_ms(fn, reps):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / reps

    def device_ms(fn, names, reps):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                for n in names:
                    if n in e.name:
                        per[n] = per.get(n, 0.0) + (
                            getattr(e, "device_time", None)
                            or getattr(e, "cuda_time", 0))
        return {n: per.get(n, 0.0) / 1e3 / reps for n in names}

    res = {"tree": root, "design": "plain" if args.plain else (
        "tape + sweep + dw" if taped else "recompute")}
    with torch.no_grad():
        if args.plain:
            fwd = lambda: node_cuda.solve_neural_field_reference(  # noqa
                m, solver, u0s, saveat)
            res["fwd_ms"] = event_ms(fwd, 3)
            bwd = None
        elif taped:
            fwd = lambda: node_cuda.solve_neural_field_cuda(  # noqa
                m, solver, u0s, saveat, tape=True)
            _, tape = fwd()

            def bwd():
                _, delta = node_cuda.neural_field_sweep_cuda(
                    m, solver, saveat, tape, w)
                return node_cuda.neural_field_dw_cuda(m, tape, delta)

            fwd0 = lambda: node_cuda.solve_neural_field_cuda(  # noqa
                m, solver, u0s, saveat)
            res["fwd_no_tape_ms"] = event_ms(fwd0, args.reps)
            res["fwd_no_tape_device_ms"] = device_ms(
                fwd0, ["node_field_fwd_kernel"], args.reps)
        else:
            fwd = lambda: node_cuda.solve_neural_field_cuda(  # noqa
                m, solver, u0s, saveat)
            ys = fwd()
            bwd = lambda: node_cuda.solve_neural_field_backward_cuda(  # noqa
                m, solver, saveat, ys, w)
        if not args.plain:
            res["fwd_ms"] = event_ms(fwd, args.reps)
            res["fwd_device_ms"] = device_ms(fwd, ["node_field_fwd_kernel"],
                                             args.reps)
            res["bwd_ms"] = event_ms(bwd, args.reps)
            res["bwd_device_ms"] = device_ms(
                bwd, ["node_field_bwd_kernel", "node_field_dw_kernel"],
                args.reps)
    if args.plain:
        u = u0s.clone().requires_grad_()
        ys_p = node_cuda.solve_neural_field_reference(m, solver, u,
                                                      saveat)[0]
        targets = [u] + list(m.parameters())
        res["bwd_ms"] = event_ms(lambda: torch.autograd.grad(
            ys_p, targets, w, retain_graph=True), 3)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
