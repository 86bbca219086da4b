"""Seed sweep of goku_heads' whole backward against plain autograd, on the
card: the inputs of tests/test_torch_cuda.py's
test_goku_heads_whole_backward_matches_autograd_on_card (heads from seed 7,
xs (64, 50, D), cotangents gz, gt) drawn from an explicit generator seeded
0..N-1, instead of the global CUDA RNG.

For every seed and gradient tensor it records the kernel's error against
plain float32 autograd (as a share of the tensor's largest value, the
test's measure), the relu units that flip between the kernel's and the
plain forward (the test's count) and the RNN pre-activations within 1e-6
of zero; for each seed whose error passes 1e-5 it also records both
float32 routes' distance from float64 autograd on the same inputs, which
says whether the kernel or float32 itself is off.

    python3 scripts/heads_bwd_sweep.py [--seeds N] [--shapes 10x8,32x16]

Writes chiprun_out/heads_bwd_sweep.json and prints one summary line per
shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch.ops import recurrent_cuda  # noqa: E402

TOL = 1e-5


def heads_with(dev, act, D, H, L=2, seed=7):
    g = torch.Generator().manual_seed(seed)
    heads = (tnn.Recurrent.rnn(D, (H,) * L, act),
             tnn.Recurrent.lstm(D, (H,) * L), tnn.Recurrent.lstm(D, (H,) * L))
    with torch.no_grad():
        for p in (p for h in heads for p in h.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    return tuple(h.to(dev) for h in heads)


def names(heads):
    return ["xs"] + [f"{h}.{n}" for h, m in zip(("z0", "fwd", "bwd"), heads)
                     for n, _ in m.named_parameters()]


def grads(heads, fn, xs, gz, gt):
    params = [p for h in heads for p in h.parameters()]
    x = xs.clone().requires_grad_()
    z0, th = fn(*heads, x)
    return torch.autograd.grad((z0, th), [x] + params, (gz, gt))


def rel(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-300)


def flips_and_margin(heads, xs, D, H):
    """(units on in one forward and off in the other, pre-activations of the
    plain forward within 1e-6 of zero), over the relu RNN's two layers."""
    with torch.no_grad():
        tape = recurrent_cuda.goku_heads_cuda(*heads, xs, tape=True)[2]
        tape_p = recurrent_cuda.goku_heads_taped_reference(*heads, xs)[2]
    Hk = recurrent_cuda.kernel_widths(D, H)[1]
    flips = 0
    for layer in range(2):
        on = tape[..., layer * Hk:layer * Hk + H] > 0
        on_p = tape_p[..., layer * H:(layer + 1) * H] > 0
        flips += int((on != on_p).sum())
    # the plain pre-activations, recomputed in float64 from its tape
    cells = list(heads[0].cells)
    T = xs.shape[1]
    near = 0
    h_prev = [c.h0.detach().double().expand(xs.shape[0], H) for c in cells]
    for t in range(T):
        inp = xs[:, T - 1 - t].double()
        for layer, c in enumerate(cells):
            z = (inp @ c.Wi.detach().double() + h_prev[layer]
                 @ c.Wh.detach().double() + c.b.detach().double())
            near += int((z.abs() < 1e-6).sum())
            h = tape_p[:, t, layer * H:(layer + 1) * H].double()
            h_prev[layer] = h
            inp = h
    return flips, near


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=200)
    ap.add_argument("--shapes", default="10x8,32x16,64x32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("heads_bwd_sweep: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for shape in args.shapes.split(","):
        D, H = (int(v) for v in shape.split("x"))
        heads = heads_with(dev, tnn.relu, D, H)
        heads64 = tuple(h.double().to(dev)
                        for h in heads_with("cpu", tnn.relu, D, H))
        tags = names(heads)
        bad = 0
        for seed in range(args.seeds):
            g = torch.Generator().manual_seed(seed)
            xs = torch.randn(64, 50, D, generator=g).to(dev)
            gz = torch.randn(64, H, generator=g).to(dev)
            gt = torch.randn(64, 2 * H, generator=g).to(dev)
            k = grads(heads, recurrent_cuda.goku_heads, xs, gz, gt)
            p = grads(heads, recurrent_cuda.goku_heads_reference, xs, gz,
                      gt)
            errs = [rel(a, b) for a, b in zip(k, p)]
            worst = max(range(len(errs)), key=errs.__getitem__)
            flips, near = flips_and_margin(heads, xs, D, H)
            rec = {"D": D, "H": H, "seed": seed, "worst": tags[worst],
                   "err": errs[worst], "size": float(p[worst].abs().max()),
                   "flips": flips, "near_zero": near}
            if errs[worst] > TOL:
                bad += 1
                r = grads(heads64, recurrent_cuda.goku_heads_reference,
                          xs.double(), gz.double(), gt.double())
                rec["kernel_vs_f64"] = [rel(a, b) for a, b in zip(k, r)]
                rec["plain_vs_f64"] = [rel(a, b) for a, b in zip(p, r)]
                rec["errs"] = errs
                rec["tensors"] = tags
                rec["sizes"] = [float(b.abs().max()) for b in p]
                print(json.dumps({key: rec[key] for key in
                                  ("D", "H", "seed", "worst", "err", "size",
                                   "flips", "near_zero")})
                      + f" kernel_vs_f64 {rec['kernel_vs_f64'][worst]:.3e}"
                      f" plain_vs_f64 {rec['plain_vs_f64'][worst]:.3e}",
                      flush=True)
            out.append(rec)
        print(f"D {D} H {H}: {bad} of {args.seeds} seeds past {TOL:.0e}",
              flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "heads_bwd_sweep.json"), "w") as f:
        json.dump(out, f)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
