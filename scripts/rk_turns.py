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
    the older design computes them in three more launches);
  - ``kuramoto10_*``: the same four times for Kuramoto-10 (no frequency
    offsets) at its GOKU path's train shape (B 64, T 50) and validation
    shape (B 26, T 100), Tsit5, 4 sub-steps, dt 0.1, the examples' draws,
    and ``kuramoto10_grad_ms``; the device times of whichever kernels the
    checkout launches for it (the lane-group ``rk_kuramoto_kernel`` and
    ``rk_kuramoto_bwd_kernel``, or the one-thread kernels before them);
  - ``kuramoto10_step_ms`` / ``kuramoto10_val_ms``: the median of 7
    synchronised GOKU training steps and validation passes on Kuramoto-10
    at the JAX example's width (goku_default_layers(64, ...,
    hidden_dim_resnet=100, latent_to_diffeq_dim=100), weights from seed 0,
    both kernel switches on, 4 sub-steps, dt 0.1), batch 64 x 50 frames
    and validation 26 x 100 frames of 64 channels drawn uniformly from a
    seed; ``kuramoto10_step_busy_ms``: the device time of one such step
    (torch.profiler, every CUDA op summed), and ``kuramoto10_step_ops``
    its device ops.

    python3 scripts/rk_turns.py --wide

times instead chip_smoke.py's phase 4m instances, Lorenz-96 at 40 and
Kuramoto at 64 (``lorenz96_40_*``, ``kuramoto64_*``), the same way: the
forward and backward per call and on the device (whichever kernels the
checkout launches: the one-thread or the sliced forward, the block forward
with or without its sines spread) at the 4m train (B 64, T 50) and
validation (B 26, T 100) shapes, Tsit5, 4 sub-steps, chip_smoke.gen_inputs'
draws, and the median GOKU step and validation pass at the custom width
with the device's busy time of a step, as for Kuramoto-10 above.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch import custom_dynamics as cdyn
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

    fwd_kernels = ("rk_fixed_grid_kernel", "rk_kuramoto_kernel",
                   "rk_fixed_grid_sliced_kernel", "rk_kuramoto_block_kernel")
    bwd_kernels = ("rk_fixed_grid_bwd_kernel", "rk_kuramoto_bwd_kernel",
                   "rk_fixed_grid_sweep_bwd_kernel",
                   "rk_kuramoto_block_bwd_kernel")
    g = torch.Generator(device=dev).manual_seed(0)
    kuramoto = cdyn.kuramoto_f(10)
    res = {"tree": root}
    wide = "--wide" in sys.argv[1:]
    if wide:
        import chip_smoke as cs
        fields = cs.gen_fields()
        cases = [(field.replace("-", "_") + "_", fields[field][0], shape,
                  B, T, fields[field][3], field)
                 for field in cs.WIDE for shape, B, T in cs.CUSTOM_SHAPES]
    else:
        cases = [("", pendulum_f, "train", 64, 50, 1, None),
                 ("", pendulum_f, "val", 45, 100, 1, None),
                 ("kuramoto10_", kuramoto, "train", 64, 50, 4, None),
                 ("kuramoto10_", kuramoto, "val", 26, 100, 4, None)]
    for pre, f, label, B, T, sub, field in cases:
        if wide:
            u0s, ps, saveat = cs.gen_inputs(field, B, T, g)
        elif f is pendulum_f:
            u0s = torch.rand(B, 2, generator=g, device=dev) * 2 - 1
            ps = 1 + torch.rand(B, 1, generator=g, device=dev)
            dt = 0.05
        else:  # phases ~ U(-pi, pi), omega ~ U(1, 3), K ~ U(0.2, 2)
            u0s = (torch.rand(B, 10, generator=g, device=dev) * 2
                   - 1) * math.pi
            ps = torch.stack([1 + 2 * torch.rand(B, generator=g, device=dev),
                              0.2 + 1.8 * torch.rand(B, generator=g,
                                                     device=dev)], dim=1)
            dt = 0.1
        if not wide:
            saveat = torch.arange(T, dtype=torch.float32, device=dev) * dt
        w = torch.randn(B, T, u0s.shape[1], generator=g, device=dev)

        def fwd():
            return ode_cuda.solve_fixed_grid_batched_cuda(
                f, solver, u0s, ps, saveat, substeps=sub)

        with torch.no_grad():
            out = fwd()
            ys = out[0] if isinstance(out, tuple) else out

            def bwd():
                return ode_cuda.solve_fixed_grid_batched_bwd_cuda(
                    f, solver, saveat, ys, ps, w, substeps=sub)

            res[f"{pre}fwd_ms_{label}"] = event_ms(fwd)
            res[f"{pre}fwd_device_ms_{label}"] = device_ms(fwd, fwd_kernels)
            res[f"{pre}bwd_ms_{label}"] = event_ms(bwd)
            res[f"{pre}bwd_device_ms_{label}"] = device_ms(bwd, bwd_kernels)
        if label == "train":
            u = u0s.clone().requires_grad_()
            p = ps.clone().requires_grad_()

            def grad():
                y = ode_cuda.solve_fixed_grid_batched(f, solver, u, p,
                                                      saveat,
                                                      substeps=sub)[0]
                torch.autograd.grad(y, [u, p], w)

            res[f"{pre or 'rk_'}grad_ms"] = event_ms(grad)

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           ODEDynamics, goku_default_layers)
    from latentdiffeq_torch.train import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts = SolveOptions(adaptive=False, substeps=4)
    if wide:
        steps = [("lorenz96_40_", ODEDynamics(
                     f=cs.lorenz96, z_dim=cs.L96_N, theta_dim=1,
                     solver=solver, options=opts)),
                 ("kuramoto64_", cdyn.Kuramoto(cs.KURAMOTO_WIDE_N,
                                               options=opts))]
    else:
        steps = [("kuramoto10_", cdyn.Kuramoto(10, options=opts))]
    for pre, diffeq in steps:
        enc, dec = goku_default_layers(
            64, diffeq, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
            generator=torch.Generator().manual_seed(0), device=dev)
        model = LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc,
            dec)
        trainer = Trainer(model, TrainConfig(dt=0.1, save_best=False),
                          device=dev)
        data = torch.rand(64, 50, 64, generator=g, device=dev)
        val = torch.rand(26, 100, 64, generator=g, device=dev)
        step, vals = [], []
        for i in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(data, 0.003)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.val_step(val, 0.003)
            torch.cuda.synchronize()
            if i >= 2:
                step.append(1e3 * (t1 - t0))
                vals.append(1e3 * (time.perf_counter() - t1))
        res[f"{pre}step_ms"] = sorted(step)[len(step) // 2]
        res[f"{pre}val_ms"] = sorted(vals)[len(vals) // 2]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(data, 0.003)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
        res[f"{pre}step_busy_ms"] = sum(
            getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
            for e in evs) / 1e3
        res[f"{pre}step_ops"] = len(evs)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
