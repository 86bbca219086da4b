"""Seed sweep of the RK backward kernel's float32 gates, on the card: the
Van der Pol validation case of chip_smoke.py's rk_grad_checks (B 26, T 100,
Tsit5, 4 sub-steps, dt 0.1, u0 ~ U(-2, 2), mu ~ U(0.5, 4), cotangent w ~
N(0, 1)) with its inputs drawn from an explicit generator seeded 0..N-1,
instead of the generator the smoke test's earlier phases share.

For every seed it records each gated error of rk_grad_checks separately,
each as max |difference| over the reference's max |value| (the smoke
test's measure, gate 1e-5): the kernel's interval maps (J, r) against the
plain maps on the same trajectory, its gradients (du0, dp) against the
two-phase plain version (plain maps, then the plain affine sweep) and
against the step-by-step plain reverse sweep, and the whole backward
(kernel forward and backward) against plain float32 autograd. For each
seed whose largest gated error passes half the gate, it also records each
float32 route's distance from a float64 referee: the step-by-step sweep
(solve_fixed_grid_batched_backward_reference) in float64 on the same
trajectory, and the plain interval maps in float64 for the maps. That says
whether the kernel or float32 itself is off.

    python3 scripts/rk_bwd_sweep.py [--seeds N]

Writes chiprun_out/rk_bwd_sweep.json and prints one line per seed above
half the gate, a summary line, then the card's name and power limit.

    python3 scripts/rk_bwd_sweep.py --case kuramotoN [--seeds N] [--T 300]
        [--seed-list 8,20,28]

The long-grid Kuramoto case of tests/test_torch_cuda.py's
test_rk_custom_rhs_bwd_kernel_matches_plain_on_card (B 16, T 300, RK4, 4
sub-steps, dt 0.1, phases ~ U(-pi, pi), omega ~ U(1, 3), K ~ U(0.2, 2),
cotangent ~ N(0, 1)), inputs from a generator seeded 0..N-1 (or the seeds
of --seed-list): per seed the
distance (max |difference| over the referee's max |value|) of the
kernel's gradients from the float64 plain reverse sweep over the same
trajectory, beside that of the kernel's own algorithm in plain float32
(the two-phase plain version for the lane groups, N <= 31; the plain
reverse sweep for the block kernels, N >= 32), and their ratio, which the
card test gates at 2, and each distance for du0 and dp apart. Writes
chiprun_out/rk_bwd_sweep_kuramotoN.json (_seeds.json with --seed-list) and
prints a line a seed and a summary line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from latentdiffeq_torch.ops import ode_cuda  # noqa: E402
from latentdiffeq_torch.solve.rk import Tsit5  # noqa: E402

B, T = 26, 100


def rel(a, b):
    return float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-300)


def one_seed(seed):
    f, _, _, _ = cs.rk_rhs("vdp")
    solver, sub = Tsit5(), cs.CUSTOM_SUBSTEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    u0s, ps, saveat = cs.rk_inputs("vdp", B, T, gen)
    w = torch.randn(B, T, 2, generator=gen, device="cuda")
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
            f, solver, u0s, ps, saveat, substeps=sub)
    du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, solver, saveat, ys, ps, w, substeps=sub, maps=True)
    J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, solver, saveat, ys, ps, substeps=sub)
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J_p, r_p,
                                                                   w)
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, solver, saveat, ys, ps, w, substeps=sub)

    def grads(fn):
        u = u0s.clone().requires_grad_()
        p = ps.clone().requires_grad_()
        y = fn(f, solver, u, p, saveat, substeps=sub)[0]
        return torch.autograd.grad(y, [u, p], w)

    k = grads(ode_cuda.solve_fixed_grid_batched)
    auto = grads(ode_cuda.solve_fixed_grid_batched_reference)
    got = (du0, dp)
    rec = {"seed": seed,
           "maps": {"J": rel(J, J_p), "r": rel(r, r_p)},
           "two_phase": {"du0": rel(du0, two[0]), "dp": rel(dp, two[1])},
           "sweep": {"du0": rel(du0, sweep[0]), "dp": rel(dp, sweep[1])},
           "autograd": {"du0": rel(k[0], auto[0]), "dp": rel(k[1], auto[1])}}
    rec["max"] = max(v for part in ("maps", "two_phase", "sweep", "autograd")
                     for v in rec[part].values())
    rec["over"] = sorted(f"{part}.{n}" for part in
                         ("maps", "two_phase", "sweep", "autograd")
                         for n, v in rec[part].items() if v > cs.GRAD_TOL)
    if rec["max"] > cs.GRAD_TOL / 2:
        # the float64 referee on the same trajectory
        ys64, ps64, w64 = ys.double(), ps.double(), w.double()
        s64 = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, solver, saveat.double(), ys64, ps64, w64, substeps=sub)
        J64, r64 = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
            f, solver, saveat.double(), ys64, ps64, substeps=sub)
        routes = {"kernel": got, "two_phase": two, "sweep": sweep,
                  "kernel_route_autograd": k,
                  "plain_autograd (its own trajectory)": auto}
        rec["vs_float64"] = {
            name: {"du0": rel(g[0], s64[0]), "dp": rel(g[1], s64[1])}
            for name, g in routes.items()}
        rec["maps_vs_float64"] = {
            "kernel": {"J": rel(J, J64), "r": rel(r, r64)},
            "plain": {"J": rel(J_p, J64), "r": rel(r_p, r64)}}
    return rec


def kuramoto_seed(n, seed, T):
    """One seed of the long-grid Kuramoto case (module docstring)."""
    from latentdiffeq_torch import custom_dynamics as cdyn
    from latentdiffeq_torch.solve.rk import RK4
    f, solver, sub, B = cdyn.kuramoto_f(n), RK4(), 4, 16
    g = torch.Generator().manual_seed(seed)
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).cuda()
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).cuda()
    saveat = torch.arange(T, dtype=torch.float32).cuda() * 0.1
    w = torch.randn(B, T, n, generator=g).cuda()
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
            f, solver, u0s, ps, saveat, substeps=sub)
    got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, solver, saveat, ys, ps, w, substeps=sub)
    route = ode_cuda.rhs_kernel(f, n).backward
    if route == "lanes":
        J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
            f, solver, saveat, ys, ps, substeps=sub)
        own = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J, r,
                                                                       w)
    else:
        own = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, solver, saveat, ys, ps, w, substeps=sub)
    ref = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, solver, saveat.double(), ys.double(), ps.double(), w.double(),
        substeps=sub)
    e_k = [rel(a, b) for a, b in zip(got, ref)]
    e_o = [rel(a, b) for a, b in zip(own, ref)]
    return {"seed": seed, "route": route, "kernel_vs_float64": max(e_k),
            "own_plain_vs_float64": max(e_o), "ratio": max(e_k) / max(e_o),
            "kernel_vs_own_plain": max(rel(a, b) for a, b in zip(got, own)),
            "du0": {"kernel": e_k[0], "own_plain": e_o[0]},
            "dp": {"kernel": e_k[1], "own_plain": e_o[1]}}


def kuramoto_main(args):
    n = int(args.case[len("kuramoto"):])
    recs = []
    seeds = ([int(x) for x in args.seed_list.split(",")] if args.seed_list
             else range(args.seeds))
    for seed in seeds:
        rec = kuramoto_seed(n, seed, args.T)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    ratios = sorted(r["ratio"] for r in recs)
    print(json.dumps({
        "case": f"{args.case} ({recs[0]['route']} backward) B 16 T {args.T} "
                f"RK4 substeps 4", "seeds": list(seeds),
        "ratio_median": ratios[len(ratios) // 2], "ratio_max": ratios[-1],
        "ratio_min": ratios[0],
        "seeds_over_2": [r["seed"] for r in recs if r["ratio"] > 2],
        "seeds_kernel_closer": sum(r["ratio"] < 1 for r in recs)}),
        flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"rk_bwd_sweep_{args.case}"
                           f"{'_seeds' if args.seed_list else ''}.json"),
              "w") as fh:
        json.dump(recs, fh, indent=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--case", default="vdp")
    ap.add_argument("--T", type=int, default=300)
    ap.add_argument("--seed-list", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rk_bwd_sweep: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.case.startswith("kuramoto"):
        kuramoto_main(args)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        return
    recs = [one_seed(s) for s in range(args.seeds)]
    torch.cuda.synchronize()
    for rec in recs:
        if "vs_float64" in rec:
            print(json.dumps(rec), flush=True)
    over = [r for r in recs if r["max"] > cs.GRAD_TOL]
    which = sorted({n for r in over for n in r["over"]})
    worst = max(recs, key=lambda r: r["max"])
    print(json.dumps({
        "case": f"rk_fixed_grid_bwd[vdp] val B {B} T {T} Tsit5 substeps "
                f"{cs.CUSTOM_SUBSTEPS}", "seeds": args.seeds,
        "gate": cs.GRAD_TOL, "seeds_over_gate": [r["seed"] for r in over],
        "errors_over_gate": which, "worst_seed": worst["seed"],
        "worst": worst["max"],
        "median_max": sorted(r["max"] for r in recs)[len(recs) // 2]}),
        flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "rk_bwd_sweep.json"),
              "w") as fh:
        json.dump(recs, fh, indent=1)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
