"""Time each lever of the neural-field weight-gradient kernel's design
(csrc/node_field.cu, node_field_dw_kernel) on its own, on one CUDA card:

    python3 scripts/node_dw_levers.py [--rounds 3]

Builds csrc/node_field.cu several ways into build/node_dw_levers/ (one nvcc
each, in parallel) and times each build's weight-gradient kernel on the
tape and Delta of a tanh field at the LatentODE train shape (16-200-200-16,
B 64, T 50: 18,816 records), the validation shape (B 45, T 100), the wide
field (128-256-256-128, B 256, T 50) and the train shape with four
replicas in one launch:
  - ``design``: the library as the port builds it (a cp.async ring of 4
    stages of 32 records fed by 8 warps of their own, 8 warps multiplying,
    clusters of 2 blocks, one wave of clusters shared out by each tile's
    cost a record, 3xTF32);
  - ``four-clusters`` / ``no-cluster``: clusters of up to 4 blocks, or
    none, every split then reduced through the workspace and the semaphore
    (LDQ_DW_MAX_CLUSTER);
  - ``kc16``: 8 stages of 16 records (LDQ_DW_KC, LDQ_DW_STAGES);
  - ``four-loaders`` / ``twelve-loaders``: 4 or 12 loading warps
    (LDQ_DW_LOADERS; 12 leave the others too few registers);
  - ``one-pass``: one TF32 product a k8 step instead of three
    (LDQ_DW_LEVER_ONE_PASS): what the tensor-core work of 3xTF32 costs;
    its results are plain TF32 and are not held to the gate;
  - ``no-mma`` / ``no-load``: the ring's loads without the products, or
    the products of whatever the ring holds without the loads
    (LDQ_DW_LEVER_NO_MMA, LDQ_DW_LEVER_NO_LOAD): timing only;
  - ``stamps``: the design with each block's global timer read at its
    start, after its main loop, after its cluster's sums and at its end,
    and block 0's before and after each stage's wait
    (LDQ_DW_LEVER_STAMPS): a timeline, printed for each shape.
Device time per launch from torch.profiler (the mean over the launches it
recorded of 30), time per call from CUDA events (the wrapper included),
the configurations in turns, ``--rounds`` rounds, the order reversed every
other round; beside them torch.mm per layer on the same tape and Delta
(torch.bmm with replicas). Prints one line per configuration, shape and
round, then one JSON line with the medians, each build's largest error
against the plain product (max |difference| over max |value| of each
tensor), the split plans, the timelines and the card's name and power
limit, and the card's line again.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch.ops import _build, node_cuda  # noqa: E402
from latentdiffeq_torch.solve.rk import Tsit5  # noqa: E402

VARIANTS = {
    "design": [],
    "four-clusters": ["-DLDQ_DW_MAX_CLUSTER=4"],
    "no-cluster": ["-DLDQ_DW_MAX_CLUSTER=1"],
    "kc16": ["-DLDQ_DW_KC=16", "-DLDQ_DW_STAGES=8"],
    "four-loaders": ["-DLDQ_DW_LOADERS=128"],
    "twelve-loaders": ["-DLDQ_DW_LOADERS=384"],
    "one-pass": ["-DLDQ_DW_LEVER_ONE_PASS"],
    "no-mma": ["-DLDQ_DW_LEVER_NO_MMA"],
    "no-load": ["-DLDQ_DW_LEVER_NO_LOAD"],
    "stamps": ["-DLDQ_DW_LEVER_STAMPS"],
}
SHAPES = (("train", (16, 200, 200, 16), 64, 50, 1),
          ("val", (16, 200, 200, 16), 45, 100, 1),
          ("wide", (128, 256, 256, 128), 256, 50, 1),
          ("train-S4", (16, 200, 200, 16), 64, 50, 4))


def build(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "node_field.cu")
    nvcc = _build._nvcc()
    procs = {}
    for name, extra in VARIANTS.items():
        lib = os.path.join(out_dir, f"libnode_field_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *extra, src, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        libs[name] = lib
        print(f"[build] {name}: {regs[-2:] if regs else ''}", flush=True)
    return libs


def use(path):
    """Make node_cuda launch the library at ``path``."""
    lib = _build._LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        _build._LIBS[path] = lib
    _build._LIBS["node_field"] = lib


def inputs(widths, B, T, S, seed):
    """(field, tape, Delta) from the forward and sweep kernels of a tanh
    field; with S > 1 the replicas' tapes stacked."""
    g = torch.Generator().manual_seed(seed)
    m = tnn.mlp(widths, tnn.tanh, tnn.identity, generator=g).cuda()
    tapes, deltas = [], []
    for s in range(S):
        u0s = (torch.randn(B, widths[0], generator=g) * 0.5).cuda()
        w = torch.randn(B, T, widths[0], generator=g).cuda()
        saveat = torch.arange(T, dtype=torch.float32, device="cuda") * 0.05
        with torch.no_grad():
            _, tape = node_cuda.solve_neural_field_cuda(m, Tsit5(), u0s,
                                                        saveat, tape=True)
        _, delta = node_cuda.neural_field_sweep_cuda(m, Tsit5(), saveat,
                                                     tape, w)
        tapes.append(tape)
        deltas.append(delta)
    if S == 1:
        return m, tapes[0], deltas[0]
    return m, torch.stack(tapes), torch.stack(deltas)


def device_ms(fn, name, reps=30):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
          for e in prof.events()
          if e.device_type.name == "CUDA" and name in e.name]
    return sum(us) / 1e3 / len(us) if us else None


def call_ms(fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def library(widths, tape, delta):
    """torch.mm per layer (torch.bmm with replicas) of [H, 1]^T Delta on
    contiguous copies of the same tape and Delta."""
    hp, rec, dp, drec = node_cuda.tape_layout(widths)
    lead = tape.shape[:-4]
    H, D = tape.reshape(*lead, -1, rec), delta.reshape(*lead, -1, drec)
    ops = []
    for o, a, q, b in zip(hp, widths[:-1], dp, widths[1:]):
        h = torch.cat([H[..., o:o + a],
                       torch.ones_like(H[..., :1])], dim=-1).contiguous()
        ops.append((h.transpose(-1, -2), D[..., q:q + b].contiguous()))
    if lead:
        return lambda: [torch.bmm(a, b) for a, b in ops]
    return lambda: [torch.mm(a, b) for a, b in ops]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("node_dw_levers: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(os.path.join(ROOT, "build", "node_dw_levers"))
    use(libs["design"])
    cases = {label: (widths, *inputs(widths, B, T, S, seed=3 + i))
             for i, (label, widths, B, T, S) in enumerate(SHAPES)}
    errs, times = {}, {}
    plans = {}
    for name, path in libs.items():
        use(path)
        plans[name] = {label: node_cuda.neural_field_dw_plan(
            widths, tape.shape[-4] * tape.shape[-3] * tape.shape[-2])
            for label, (widths, m, tape, delta) in cases.items()}
        if name.startswith("no-"):
            continue
        worst = 0.0
        for label, (widths, m, tape, delta) in cases.items():
            got = node_cuda.neural_field_dw_cuda(m, tape, delta)
            ref = node_cuda.neural_field_dw_reference(m, tape, delta)
            worst = max(worst, max(
                float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got[0] + got[1], ref[0] + ref[1])))
        errs[name] = worst
    timeline = {}
    if "stamps" in libs:
        use(libs["stamps"])
        lib = _build._LIBS["node_field"]
        buf = (ctypes.c_ulonglong * (4096 * 4))()
        chunks = (ctypes.c_ulonglong * (256 * 2))()
        for label, (widths, m, tape, delta) in cases.items():
            node_cuda.neural_field_dw_cuda(m, tape, delta)
            torch.cuda.synchronize()
            lib.ldq_node_field_dw_stamps(buf, chunks)
            nb = node_cuda.neural_field_dw_plan(
                widths, tape.shape[-4] * tape.shape[-3] * tape.shape[-2])[0]
            st = [buf[4 * i:4 * i + 4] for i in range(nb)]
            t0 = min(x[0] for x in st)
            phases = [[(x[k + 1] - x[k]) / 1e3 for x in st] for k in range(3)]
            timeline[label] = {
                "kernel_us": (max(x[3] for x in st) - t0) / 1e3,
                "start_us (min, max)": (0.0, (max(x[0] for x in st) - t0)
                                        / 1e3),
                "main loop / cluster sums / semaphore us (min, median, max)":
                [(min(p), statistics.median(p), max(p)) for p in phases],
                "block 0, first stages: wait us, then the stage's work us":
                [(round((chunks[2 * c + 1] - chunks[2 * c]) / 1e3, 3),
                  round((chunks[2 * c + 2] - chunks[2 * c + 1]) / 1e3, 3))
                 for c in range(12) if chunks[2 * c + 2] > 0]}
            print(f"[timeline] {label}: {json.dumps(timeline[label])}",
                  flush=True)
    order = list(libs)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            use(libs[name])
            for label, (widths, m, tape, delta) in cases.items():
                fn = lambda: node_cuda.neural_field_dw_cuda(m, tape, delta)
                d = device_ms(fn, "node_field_dw_kernel")
                c = call_ms(fn)
                times.setdefault((name, label), []).append((d, c))
                print(f"[round {rnd}] {name} {label}: device "
                      f"{d if d is None else round(d, 4)} ms, per call "
                      f"{c:.4f} ms", flush=True)
    lib_ms = {label: call_ms(library(widths, tape, delta))
              for label, (widths, m, tape, delta) in cases.items()}
    med = {f"{n} {l}": {
        "device_ms": statistics.median(d for d, _ in v if d is not None)
        if any(d is not None for d, _ in v) else None,
        "call_ms": statistics.median(c for _, c in v)}
        for (n, l), v in times.items()}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"median": med, "max_rel_err": errs, "plans": plans,
                      "timeline": timeline,
                      "library_ms (torch.mm per layer; bmm with S 4)":
                      lib_ms, "card": gpu}), flush=True)
    print(gpu, flush=True)


if __name__ == "__main__":
    main()
