"""Where a GOKU training step's host time goes, float32 against bf16 NN
stages, in turns on one card.

    python3 scripts/bf16_step_turns.py [--reps 15]

Builds full-width GOKU on the pendulum (both kernel switches, weights from
seed 333) in float32 and with ``dtype=torch.bfloat16``, and times, in the
order float32, bf16, bf16, float32 (median of ``--reps`` synchronised runs
on the host clock each, batch 64 x 50 frames of uniform noise): the whole
``Trainer.train_step``, the forward with the loss, the forward and
backward, and ``FluxAdam.step`` alone; then the host time of one step by
operator under torch.profiler (the ten largest). Prints one JSON line of
the times with the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def med(fn, reps):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return 1e3 * ts[reps // 2]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bf16_step_turns.py needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import _build
    from latentdiffeq_torch.pendulum import Pendulum
    from latentdiffeq_torch.train import TrainConfig, Trainer, loss_batch

    _build.build_kernels()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(64, 50, 784, generator=g, device=dev)
    t = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    out = {}
    for turn, dtype in enumerate((torch.float32, torch.bfloat16,
                                  torch.bfloat16, torch.float32)):
        m = LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
            *goku_default_layers(784, diffeq, generator=torch.Generator()
                                 .manual_seed(333), device=dev,
                                 dtype=dtype))
        tr = Trainer(m, TrainConfig(save_best=False), device=dev)
        for _ in range(3):
            tr.train_step(x, 0.5)

        def fwd():
            return loss_batch(m, x, t, 0.5, generator=tr.noise_gen)[0]

        def fwd_bwd():
            m.zero_grad()
            fwd().backward()

        rec = {"train_step_ms": med(lambda: tr.train_step(x, 0.5),
                                    args.reps),
               "forward_loss_ms": med(fwd, args.reps),
               "forward_backward_ms": med(fwd_bwd, args.reps),
               "optimizer_step_ms": med(tr.opt.step, args.reps)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train_step(x, 0.5)
            torch.cuda.synchronize()
        rec["device_ops"] = sum(1 for e in prof.events()
                                if e.device_type.name == "CUDA")
        name = f"{turn}:{'bf16' if dtype == torch.bfloat16 else 'f32'}"
        out[name] = rec
        print(f"[{name}] {rec}", flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=10), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"turns": out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
