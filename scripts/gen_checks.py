"""Run chip_smoke.py's checks and timing of some user-field instances
(gen_kernel_checks, phase 5) and its phase 4m (GOKU on Lorenz-96-40 and
Kuramoto-64, kernel route against plain route) alone on the card, without
the rest of the script:

    python3 scripts/gen_checks.py [--fields pendulum-untagged,lorenz96-40,kuramoto64]

--fields names chip_smoke.gen_fields() labels. Prints the check and
timing lines (for Lorenz-96-40 and Kuramoto-64 also their forwards held bit
for bit against, and timed beside, the designs before: the one-thread
forward, the block forward's sines on the oscillators' lanes), then each 4m
kernel's launches, largest error against its plain version and timing row,
the card's name and power limit, and "gen_checks: ok"; exits 1 (through
chip_smoke.fail) if a check fails.

    python3 scripts/gen_checks.py --zoo

times instead the libraries of tests/rhs_zoo.py's fields at the card
tests' first shape (B 64, T 50, dt 0.05, 2 sub-steps, Tsit5, the zoo's
draws): each instance's forward and backward kernel per call and on the
device, its plain version (the plain solve; the plain reverse sweep) on
the same inputs, its bound (the traced program's operations) and latency
model (the route's: chip_smoke.route_work), with both plans. One
line each, and chiprun_out/zoo_timing.json. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import json  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from latentdiffeq_torch.ops import _build, ode_cuda  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
import rhs_zoo  # noqa: E402


def zoo_timing(clock):
    """--zoo (module docstring): {name: row}."""
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    s = Tsit5()
    tab, n_st = s.tableau, n_solution_stages(s.tableau)
    B, T, sub = 64, 50, 2
    ode_cuda.build_instances([(f, d, p) for f, d, p, _ in
                              rhs_zoo.ZOO.values()])
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda
    rows = {}
    for name, (f, dim, pdim, _) in rhs_zoo.ZOO.items():
        rk = ode_cuda.rhs_kernel(f, dim, pdim)
        u0s, ps = (torch.from_numpy(x).cuda()
                   for x in rhs_zoo.draws(name, B, 0))
        saveat = torch.arange(T, dtype=torch.float32, device="cuda") * 0.05
        w = torch.randn(B, T, dim, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        plan = (ode_cuda.bwd_plan(f, s, dim, B, sub, pdim)
                if rk.backward == "sweep" else None)
        fplan = ode_cuda.fwd_plan(f, s, dim, B, pdim)
        fw, bw, lat = cs.route_work(rk, B, T, dim, pdim, sub, tab, n_st,
                                    clock, plan, fplan["design"])
        kf, kb = cs.route_kernels(rk, fplan["design"])
        with torch.no_grad():
            def fwd():
                return ode_cuda.solve_fixed_grid_batched_cuda(
                    f, s, u0s, ps, saveat, substeps=sub)
            ys, _ = fwd()
            _, p_f = cs.plain_timed(
                lambda: ode_cuda.solve_fixed_grid_batched_reference(
                    f, s, u0s, ps, saveat, substeps=sub))
            _, p_b = cs.plain_timed(
                lambda: ode_cuda.solve_fixed_grid_batched_backward_reference(
                    f, s, saveat, ys, ps, w, substeps=sub))
            row = {"instance": rk.name, "route": rk.backward, "plan": plan,
                   "fwd_plan": fplan}
            for part, kname, fn, p_ms, work, lat_ms in (
                    ("fwd", kf, fwd, p_f, fw, lat[0]),
                    ("bwd", kb, lambda: bwd(f, s, saveat, ys, ps, w,
                                            substeps=sub), p_b, bw, lat[1])):
                d_ms = cs.device_ms(fn, kname)
                b_ms = cs.bound_ms(*work)
                row[part] = {"ms": cs.time_ms(fn), "device_ms":
                             None if d_ms is None else float(d_ms),
                             "plain_ms": p_ms, "bound_ms": b_ms[0],
                             "bound_by": b_ms[1], "latency_model_ms": lat_ms}
        rows[name] = row
        print("zoo", name, json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "zoo_timing.json"),
              "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fields",
                    default="pendulum-untagged,lorenz96-40,kuramoto64")
    ap.add_argument("--zoo", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gen_checks: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = cs.gpu_line()
    if args.zoo:
        t0 = time.perf_counter()
        zoo_timing(cs.max_sm_clock_mhz())
        print("zoo in", time.perf_counter() - t0, flush=True)
        print(gpu)
        print("gen_checks: ok", flush=True)
        return
    fields = cs.gen_fields()
    keep = {k: fields[k] for k in args.fields.split(",")}
    t0 = time.perf_counter()
    _build.build_kernels(list(dict.fromkeys(
        list(_build.KERNEL_SOURCES)
        + [ode_cuda.rhs_kernel(f, d, p).library
           for f, d, p, *_ in keep.values()]
        + list(cs.forward_before_libraries(keep).values()))))
    print("built in", time.perf_counter() - t0, flush=True)
    for label, (f, d, p, *_) in keep.items():
        lib = ode_cuda.rhs_kernel(f, d, p).library
        print(label, lib, "spills:", cs.spill_lines(lib) or "none",
              flush=True)
    t0 = time.perf_counter()
    errs, times = cs.gen_kernel_checks(
        torch.Generator(device=dev).manual_seed(16), cs.max_sm_clock_mhz(),
        keep)
    print("checks in", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    launches = cs.wide_path(dev, gpu)
    print("4m in", time.perf_counter() - t0, flush=True)
    for name in sorted(launches):
        print(name, launches[name], errs.get(name), times.get(name),
              flush=True)
    print(gpu)
    print("gen_checks: ok", flush=True)


if __name__ == "__main__":
    main()
