"""Time the batched RK solve kernels of the checkout this script lies in, on
one CUDA card:

    python3 scripts/rk_turns.py

To compare two designs in turns in one call, unpack the older commit
beside this one, copy this script into its ``scripts/`` and run the two
copies alternately (older, newer, newer, older). The script calls only
what both designs have (the forward returns ys alone in the older one, ys
and the success flags in the newer). Prints one JSON line with the
checkout's root and the card's name and power limit:
  - ``fwd_device_ms_{train,val}``: device time per launch of
    ``rk_fixed_grid_kernel`` (torch.profiler, the mean over the launches it
    recorded of 50) at the
    train shape (B 64, T 50) and the validation shape (B 45, T 100),
    pendulum, Tsit5, substeps 1; ``fwd_ms_*``: per call with the wrapper
    (CUDA events, mean of 50);
  - ``bwd_device_ms_*`` / ``bwd_ms_*``: the same for
    ``rk_fixed_grid_bwd_kernel`` over the forward's trajectory;
  - ``rk_grad_ms``: forward + backward through ``solve_fixed_grid_batched``
    at the train shape, per call (with the success flags the solve returns;
    the older design computes them in three more launches).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.pendulum import pendulum_f
    from latentdiffeq_torch.solve.rk import Tsit5
    dev = torch.device("cuda")
    solver = Tsit5()

    def event_ms(fn, reps=50):
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

    def device_ms(fn, kernel, reps=50):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
              for e in prof.events() if e.device_type.name == "CUDA"
              and kernel in e.name]
        return sum(us) / 1e3 / len(us) if us else None

    g = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": root}
    for label, (B, T) in (("train", (64, 50)), ("val", (45, 100))):
        u0s = torch.rand(B, 2, generator=g, device=dev) * 2 - 1
        ps = 1 + torch.rand(B, 1, generator=g, device=dev)
        saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
        w = torch.randn(B, T, 2, generator=g, device=dev)

        def fwd():
            return ode_cuda.solve_fixed_grid_batched_cuda(pendulum_f, solver,
                                                          u0s, ps, saveat)

        with torch.no_grad():
            out = fwd()
            ys = out[0] if isinstance(out, tuple) else out

            def bwd():
                return ode_cuda.solve_fixed_grid_batched_bwd_cuda(
                    pendulum_f, solver, saveat, ys, ps, w)

            res[f"fwd_ms_{label}"] = event_ms(fwd)
            res[f"fwd_device_ms_{label}"] = device_ms(fwd,
                                                      "rk_fixed_grid_kernel")
            res[f"bwd_ms_{label}"] = event_ms(bwd)
            res[f"bwd_device_ms_{label}"] = device_ms(
                bwd, "rk_fixed_grid_bwd_kernel")
        if label == "train":
            u = u0s.clone().requires_grad_()
            p = ps.clone().requires_grad_()

            def grad():
                y = ode_cuda.solve_fixed_grid_batched(pendulum_f, solver, u,
                                                      p, saveat)[0]
                torch.autograd.grad(y, [u, p], w)

            res["rk_grad_ms"] = event_ms(grad)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
