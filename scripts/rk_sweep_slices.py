"""The sliced reverse-sweep kernel at each slice count, on the card.

Builds Lorenz-96-40's generated functor (chip_smoke.py's 4m field) once for
each count of --counts (ops/rhs_codegen.py's plan restricted to that
count: the same partition rule, one library each, all built in parallel),
then, at the 4m train and validation shapes (B 64, T 50 and B 26, T 100,
--solver's tableau, 4 sub-steps, chip_smoke.gen_inputs' draws), times each
library's backward kernel per call (CUDA events) in turns, checks that every count
gives the same gradients bit for bit (the slices compute every value with
the whole program's statements), and prints one JSON line per count and
shape (statements a stage of the longest eval and vjp slice, ms), then the
card's name and power limit.

    python3 scripts/rk_sweep_slices.py [--counts 1,2,4,8,16] [--rounds 3]
        [--solver Tsit5]

Each build's RK kernels at the baked Tsit5 tableau are printed first with
their SASS instruction counts (cuobjdump, beside nvcc); after each shape's
timing, the SM clock and power draw nvidia-smi reads while 400 queued
calls of the first build run.

With --levers it times the default count's library beside copies built
with one row a block (LDQ_RK_LEVER_SWEEP_ROWS 1) and cut into 8 slices
(both bit for bit with the default), and with
LDQ_RK_LEVER_SWEEP_NO_BARRIER, LDQ_RK_LEVER_SWEEP_NO_EVAL, _NO_VJP and
both (the slices' programs replaced by copies of their inputs: the rest of
the kernel's time; these gradients are not checked).

With --forward it times the forward instead: each count's sliced forward
(rk_fixed_grid_sliced_kernel, the same partition rule) beside the
one-thread forward it replaces ("before": the library built with
chip_smoke.FWD_BEFORE), in turns, every count's states and flags bit for
bit with the one-thread forward's; with --forward --levers the default
count's beside 1, 2, 4 and 32 rows a block and 8 slices (all checked), and
without barriers or without the eval slices (not checked).

With --kuramoto it times instead Kuramoto-64's block backward
(rk_kuramoto_block_bwd_kernel<64>) built as the library builds it and with
the stage loops rolled (LDQ_RK_LEVER_KUR_ROLLED), at the same shapes in
turns, and checks the two equal bit for bit; with --kuramoto --forward
its block forward (sines spread over the block) so built and with the
stage loops rolled, beside the design before (FWD_BEFORE), all bit for
bit; with --kuramoto --forward --levers also with the sines replaced by
their arguments and without the rows' sums (LDQ_RK_LEVER_KUR_NO_SINES,
_NO_SUM: the rest of the stage's time; not checked).

Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from latentdiffeq_torch.ops import (_build, ode_cuda, rhs_codegen,  # noqa: E402
                                    rhs_trace)
from latentdiffeq_torch.solve import rk  # noqa: E402
from latentdiffeq_torch.solve.rk import tableau_f32  # noqa: E402


def library(prog, count, defines=()):
    """The registered library name of ``prog`` cut into ``count`` slices
    (None: the plan's own count), built with ``defines``."""
    keep = rhs_codegen.SLICE_COUNTS
    if count is not None:
        rhs_codegen.SLICE_COUNTS = (count,)
    try:
        text = rhs_codegen.kernel_source(prog)
        plan = rhs_codegen.plan_slices(prog)
    finally:
        rhs_codegen.SLICE_COUNTS = keep
    pre = "".join(f"#define {d}\n" for d in defines)
    return _build.register_generated("rk_gen", pre + text), plan


def sass_sizes(name):
    """{kernel, its template arguments cut: SASS instructions} of the RK
    kernels in a built library at the baked Tsit5 tableau (cuobjdump)."""
    import re
    import subprocess
    lib = _build._paths(name)[1]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    sizes, cur = {}, None
    for line in text.splitlines():
        if line.strip().startswith("Function :"):
            fn = line.split(":", 1)[1]
            m = re.search(r"\d+(rk_\w+?_kernel)I", fn)
            cur = (m.group(1) if m and "Tsit5Tab" in fn else None)
            if cur:
                sizes[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            sizes[cur] += 1
    return sizes


def clocks_while_busy(run, launches=400):
    """nvidia-smi's SM clock, its maximum and the power draw, read while
    the card works through ``launches`` queued calls of ``run``."""
    import subprocess
    for _ in range(launches):
        run()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", default="1,2,4,8,16")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kuramoto", action="store_true")
    ap.add_argument("--levers", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--solver", default="Tsit5")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rk_sweep_slices: needs a CUDA GPU")
    if args.kuramoto:
        label = "kuramoto64"
        f, dim, pdim, sub, _, _ = cs.gen_fields()[label]
        text = rhs_codegen.kuramoto_source(dim)
        builds = [("unrolled", ""),
                  ("rolled", "#define LDQ_RK_LEVER_KUR_ROLLED\n")]
        if args.forward:
            builds += [("before", cs.FWD_BEFORE)]
            if args.levers:
                builds += [(f"no-{k}",
                            f"#define LDQ_RK_LEVER_KUR_NO_{k.upper()}\n")
                           for k in ("sines", "sum")]
        libs = {k: (_build.register_generated("rk_kuramoto", pre + text),
                    None) for k, pre in builds}
        offsets = f.rhs_consts("cuda", torch.float32).contiguous()
        cst = offsets.data_ptr()
    else:
        label = "lorenz96-40"
        f, dim, pdim, sub, _, _ = cs.gen_fields()[label]
        prog = rhs_trace.trace_field(f, dim, pdim)
        if args.forward:
            before = ("LDQ_RK_FWD_FLOATS 1",)
            libs = ({"default": library(prog, None),
                     **{f"rows-{r}": library(
                         prog, None, (f"LDQ_RK_LEVER_SWEEP_ROWS {r}",))
                        for r in (1, 2, 4, 32)},
                     "8-slices": library(prog, 8),
                     "no-barrier": library(
                         prog, None, ("LDQ_RK_LEVER_SWEEP_NO_BARRIER",)),
                     "no-eval": library(
                         prog, None, ("LDQ_RK_LEVER_SWEEP_NO_EVAL",))}
                    if args.levers else
                    {c: library(prog, int(c))
                     for c in args.counts.split(",")})
            libs["before"] = library(prog, None, before)
        elif args.levers:
            lv = ("LDQ_RK_LEVER_SWEEP_NO_EVAL", "LDQ_RK_LEVER_SWEEP_NO_VJP")
            libs = {"default": library(prog, None),
                    "rows-1": library(
                        prog, None, ("LDQ_RK_LEVER_SWEEP_ROWS 1",)),
                    "8-slices": library(prog, 8),
                    "no-barrier": library(
                        prog, None, ("LDQ_RK_LEVER_SWEEP_NO_BARRIER",)),
                    "no-eval": library(prog, None, lv[:1]),
                    "no-vjp": library(prog, None, lv[1:]),
                    "no-eval-no-vjp": library(prog, None, lv)}
        else:
            libs = {c: library(prog, int(c)) for c in args.counts.split(",")}
        cst = None
    t0 = time.perf_counter()
    _build.build_kernels([name for name, _ in libs.values()])
    print("built in", round(time.perf_counter() - t0, 1), flush=True)
    for count, (name, _) in libs.items():
        print(json.dumps({"build": count, "sass_instructions":
                          sass_sizes(name)}), flush=True)
    s = getattr(rk, args.solver)()
    n, a, b, c = tableau_f32(s)
    gen = torch.Generator(device="cuda").manual_seed(17)
    for shape, B, T in cs.gen_shapes(label):
        u0s, ps, saveat = cs.gen_inputs(label, B, T, gen)
        w = torch.randn(B, T, dim, generator=gen, device="cuda")
        with torch.no_grad():
            ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
                f, s, u0s, ps, saveat, substeps=sub)
        runs, outs = {}, {}
        if args.forward:
            for count, (name, _) in libs.items():
                def run(name=name):
                    return cs.forward_from(name, f, s, u0s, ps, saveat, sub)
                with torch.no_grad():
                    outs[count] = run()
                runs[count] = run
        for count, (name, plan) in ({} if args.forward else libs).items():
            lib = ode_cuda.typed_library(_build.load_kernel(name))
            du0 = torch.empty(B, dim, device="cuda")
            dp = torch.empty(B, pdim, device="cuda")

            def run(lib=lib, du0=du0, dp=dp):
                err = lib.ldq_rk_fixed_grid_bwd(
                    0, ode_cuda.tableau_instance(s), n, a.data_ptr(),
                    b.data_ptr(), c.data_ptr(), saveat.data_ptr(),
                    ys.data_ptr(), ps.data_ptr(), cst, w.data_ptr(),
                    du0.data_ptr(), dp.data_ptr(), None, None, B, T, sub,
                    torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
            run()
            torch.cuda.synchronize()
            outs[count] = (du0.clone(), dp.clone())
            runs[count] = run
        ms = {count: [] for count in libs}
        for _ in range(args.rounds):  # in turns
            for count, run in runs.items():
                ms[count].append(cs.time_ms(run))
        print(json.dumps({"shape": shape, "clocks_while_busy":
                          clocks_while_busy(next(iter(runs.values())))}),
              flush=True)
        ref = outs["before" if args.forward else next(iter(outs))]
        ok_names = ("default", "rows-1", "rows-2", "rows-4", "rows-32",
                    "8-slices", "rolled", "unrolled")
        for count, (name, plan) in libs.items():
            same = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                       for x, y in zip(outs[count], ref))
            row = {"shape": shape, "B": B, "T": T, "build": count,
                   "ms": ms[count], "same_bits_as_first": same}
            if plan is not None:
                row.update(slices=plan.count, eval_max=max(plan.eval_cost),
                           vjp_max=max(plan.vjp_cost))
            print(json.dumps(row), flush=True)
            if not same and (count in ok_names or not args.levers):
                sys.exit(f"rk_sweep_slices: {count} differs")
    print(cs.gpu_line(), flush=True)


if __name__ == "__main__":
    main()
