"""Time the GOKU kernels and the GOKU training step of the checkout this
script lies in, on one CUDA card:

    python3 scripts/goku_turns.py

To compare two designs in turns in one call, unpack the older commit
beside this one, copy this script into its ``scripts/`` and run the two
copies alternately (older, newer, newer, older). Prints one JSON line with
the checkout's root and the card's name and power limit:
  - ``heads_fwd_device_ms``: device time per launch of the heads' forward
    kernel (torch.profiler), at the train shape (B 64, T 50) and the
    validation shape (B 45, T 100), full-width GOKU heads (32 -> 16, two
    layers, relu RNN), weights from seed 333; ``heads_fwd_ms``: per call
    with the wrapper (CUDA events);
  - ``heads_grad_ms``: forward + backward of the heads through
    ``goku_heads`` at the train shape, per call (whatever backward the
    checkout's wrapper takes by default);
  - ``rk_grad_ms``: the same for the batched RK solve (B 64, T 50, Tsit5);
  - ``step_ms`` / ``val_ms``: the median of 7 synchronised full-width GOKU
    training steps (batch 64 x 50 frames of 784 pixels drawn uniformly from
    a seed, both kernel switches on) and validation passes (45 x 100).
"""
from __future__ import annotations

import json
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

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.pendulum import Pendulum, pendulum_f
    from latentdiffeq_torch.solve.rk import Tsit5
    from latentdiffeq_torch.train import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def event_ms(fn, reps=20):
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

    def device_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
                 for e in prof.events() if e.device_type.name == "CUDA"
                 and "goku_heads" in e.name and "bwd" not in e.name)
        return us / 1e3 / reps

    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    heads = enc[1]
    params = [p for h in heads for p in h.parameters()]
    g = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": root}
    for label, (B, T) in (("train", (64, 50)), ("val", (45, 100))):
        xs = torch.randn(B, T, 32, generator=g, device=dev)
        with torch.no_grad():
            fwd = lambda: recurrent_cuda.goku_heads_cuda(*heads, xs)  # noqa
            res[f"heads_fwd_ms_{label}"] = event_ms(fwd)
            res[f"heads_fwd_device_ms_{label}"] = device_ms(fwd)
    xs = torch.randn(64, 50, 32, generator=g, device=dev)
    gz = torch.randn(64, 16, generator=g, device=dev)
    gt = torch.randn(64, 32, generator=g, device=dev)
    x = xs.clone().requires_grad_()

    def heads_grad():
        z0, th = recurrent_cuda.goku_heads(*heads, x)
        torch.autograd.grad((z0, th), [x] + params, (gz, gt))

    res["heads_grad_ms"] = event_ms(heads_grad, reps=5)
    u0s = (torch.rand(64, 2, generator=g, device=dev) * 2 - 1
           ).requires_grad_()
    ps = (1 + torch.rand(64, 1, generator=g, device=dev)).requires_grad_()
    saveat = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    w = torch.randn(64, 50, 2, generator=g, device=dev)

    def rk_grad():
        ys = ode_cuda.solve_fixed_grid_batched(pendulum_f, Tsit5(), u0s, ps,
                                               saveat)[0]
        torch.autograd.grad(ys, [u0s, ps], w)

    res["rk_grad_ms"] = event_ms(rk_grad, reps=5)

    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc, dec)
    trainer = Trainer(model, TrainConfig(epochs=1500, save_best=False),
                      device=dev)
    data = torch.rand(64, 50, 784, generator=g, device=dev)
    val = torch.rand(45, 100, 784, generator=g, device=dev)
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
    res["step_ms"] = sorted(step)[len(step) // 2]
    res["val_ms"] = sorted(vals)[len(vals) // 2]
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
