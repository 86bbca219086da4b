"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one line (any failure exits non-zero):
  1. build    compile every CUDA kernel of the port (one nvcc per source, in
              parallel) and print the card's name and power limit;
  2. kernels  each kernel against its plain PyTorch version on the card
              (TF32 off) at the training, validation and a ragged batch shape;
  3. grads    gradients through each kernel's autograd.Function against plain
              autograd;
  4. train    the main path: generate the 450 x 100 x 28 x 28 pendulum video
              on the card, build full-width GOKU with both kernel switches on,
              Trainer.fit for 2 epochs (6 steps each, validation after every
              step); losses must be finite, every kernel must have launched,
              and the kernel path must agree with the plain path;
  5. timing   each kernel's time per call (CUDA events, wrapper included)
              and on the device alone (torch.profiler) beside its plain
              version's time, its bytes/operations bound and a latency
              model of its serial chain; with --profile, a torch.profiler
              breakdown of one training step plus validation, written to
              chiprun_out/profile_step.txt.
It then prints the kernels JSON line, the card line and, last, the result
line {"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no
result.
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TOL = 1e-5          # kernel vs plain version, float32, both kernels
GRAD_TOL = 1e-5     # gradients: the same recompute on the same cotangents
PATH_TOL = 1e-4     # model output, kernel path vs plain path


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time per launch of the CUDA kernels whose name holds
    ``kernel``, from torch.profiler (the kernel alone, without the host
    work of its wrapper); None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
             for e in prof.events()
             if e.device_type.name == "CUDA" and kernel in e.name)
    return us / 1e3 / reps if us else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def heads_work(B, T, D, H, L):
    """(bytes, float32 operations) the heads function needs: xs, weights
    and outputs moved once; per step and row, the gate products (2 flops
    per multiply-add) and the cell updates (~10 operations per LSTM unit,
    sigmoid/tanh counted as one each, 1 per RNN unit)."""
    n_w = 0
    flops_step = 0
    for s in range(3):
        G = H if s == 0 else 4 * H
        for l in range(L):
            din = D if l == 0 else H
            n_w += din * G + H * G + G + H + (H if s else 0)
            flops_step += 2 * (din + H) * G + G
            flops_step += 10 * H if s else H
    nbytes = 4 * (B * T * D + n_w + B * 3 * H)
    return nbytes, B * T * flops_step


def rk_work(B, T, dim, pdim, substeps, tab, n_stages):
    """(bytes, float32 operations) of the batched RK solve: u0s, ps,
    saveat in and ys out once; per step, the stage combinations (a
    multiply and an add per state entry per nonzero coefficient, plus the
    dt * a product), the stage times, and the pendulum RHS (divide,
    multiply, sin: 3 operations)."""
    ops = 0
    for s in range(n_stages):
        nz = sum(1 for a in tab.a[s] if a != 0.0)
        ops += nz * (2 * dim + 1) + 2 + 3
    ops += sum(1 for b in tab.b[:n_stages] if b != 0.0) * (2 * dim + 1)
    nbytes = 4 * (B * dim + B * pdim + T + B * T * dim)
    return nbytes, B * (T - 1) * substeps * ops


# Dependent-issue latencies in cycles for a latency model of the two
# kernels (both are serial chains): a float32 FMA, a special-function step
# (ex2, rcp, sin with its range reduction), a block barrier. Round figures
# for a lower bound, not measurements.
FMA_CYC, SFU_CYC, BAR_CYC = 4, 20, 20


def heads_latency_ms(T, L, D, H, clock_mhz):
    """Least time of the heads' T-step dependent chain if each gate dot
    product were a tree reduction: per layer, ceil(log2(din + H)) FMA
    levels, the LSTM cell update (sigmoid, FMA, tanh, multiply: 4
    special-function steps and 2 FMAs) and the two barriers."""
    cyc = 0
    for l in range(L):
        din = D if l == 0 else H
        cyc += (math.ceil(math.log2(din + H)) + 2) * FMA_CYC \
            + 4 * SFU_CYC + 2 * BAR_CYC
    return T * cyc / (clock_mhz * 1e3)


def rk_latency_ms(T, substeps, n_stages, clock_mhz):
    """Least time of one trajectory's chain: per stage, the last FMA of the
    stage combination and the pendulum RHS (sin and a division: 3
    special-function steps, 2 FMAs); per step, one more FMA."""
    per_step = n_stages * (3 * FMA_CYC + 3 * SFU_CYC) + FMA_CYC
    return (T - 1) * substeps * per_step / (clock_mhz * 1e3)


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def bound_ms(nbytes, flops):
    """(bound, what bounds it, bytes time, operations time), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import _build
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.pendulum import (Pendulum, pendulum_f,
                                             pendulum_friction_f)
    from latentdiffeq_torch.pendulum_data import (draw_initial_conditions,
                                                  generate_dataset)
    from latentdiffeq_torch.solve.rk import RK4, Tsit5, n_solution_stages
    from latentdiffeq_torch.train import TrainConfig, Trainer, splitobs

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_kernels()
    log("build", f"{sorted(built)} in {time.perf_counter() - t0:.2f} s "
                 f"(compiled now: {sorted(n for n, b in built.items() if b)})"
                 f"; card: {gpu}; torch {torch.__version__} cuda "
                 f"{torch.version.cuda}")
    for name in built:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        for line in dict.fromkeys(lines):
            log("build", f"{name}: {line}")

    # ---- 2. kernels vs plain ----------------------------------------------
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    heads = enc[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"goku_heads": 0.0, "rk_fixed_grid": 0.0}
    shapes = {"train": (64, 50), "val": (45, 100), "ragged": (100, 50)}
    with torch.no_grad():
        for label, (B, T) in shapes.items():
            xs = torch.randn(B, T, 32, generator=gen, device=dev)
            got = recurrent_cuda.goku_heads_cuda(*heads, xs)
            ref = recurrent_cuda.goku_heads_reference(*heads, xs)
            e = max(max_err(a, b) for a, b in zip(got, ref))
            errs["goku_heads"] = max(errs["goku_heads"], e)
            log("kernels", f"goku_heads {label} B={B} T={T}: max abs err "
                           f"{e:.3e} (tol {TOL:.0e})")
            if not e <= TOL:
                fail(f"goku_heads {label}: {e} > {TOL}")
        cases = [(label, B, T, pendulum_f, Tsit5(), 1)
                 for label, (B, T) in shapes.items()]
        cases += [("rk4-substeps3", 64, 50, pendulum_f, RK4(), 3),
                  ("friction", 64, 50, pendulum_friction_f, Tsit5(), 1)]
        for label, B, T, f, solver, sub in cases:
            u0s = (torch.rand(B, 2, generator=gen, device=dev) * 2 - 1)
            ps = 1 + torch.rand(B, 1, generator=gen, device=dev)
            saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
            got = ode_cuda.solve_fixed_grid_batched_cuda(
                f, solver, u0s, ps, saveat, substeps=sub)
            ref, _, _ = ode_cuda.solve_fixed_grid_batched_reference(
                f, solver, u0s, ps, saveat, substeps=sub)
            e = max_err(got, ref)
            errs["rk_fixed_grid"] = max(errs["rk_fixed_grid"], e)
            log("kernels", f"rk_fixed_grid {label} B={B} T={T}: max abs err "
                           f"{e:.3e} (tol {TOL:.0e})")
            if not e <= TOL:
                fail(f"rk_fixed_grid {label}: {e} > {TOL}")
    torch.cuda.synchronize()

    # ---- 3. gradients -----------------------------------------------------
    xs = torch.randn(64, 50, 32, generator=gen, device=dev,
                     requires_grad=True)
    w_z0 = torch.randn(64, 16, generator=gen, device=dev)
    w_th = torch.randn(64, 32, generator=gen, device=dev)
    params = recurrent_cuda._heads_params(*heads)

    def heads_grads(fn):
        z0, th = fn(*heads, xs)
        return torch.autograd.grad((z0 * w_z0).sum() + (th * w_th).sum(),
                                   [xs] + params)

    e = max(max_err(a, b) for a, b in zip(
        heads_grads(recurrent_cuda.goku_heads),
        heads_grads(recurrent_cuda.goku_heads_reference)))
    log("grads", f"goku_heads: max abs err {e:.3e} (tol {GRAD_TOL:.0e})")
    if not e <= GRAD_TOL:
        fail(f"goku_heads grads: {e} > {GRAD_TOL}")

    u0s = (torch.rand(64, 2, generator=gen, device=dev) * 2 - 1
           ).requires_grad_()
    ps = (1 + torch.rand(64, 1, generator=gen, device=dev)).requires_grad_()
    saveat = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    w_ys = torch.randn(64, 50, 2, generator=gen, device=dev)

    def rk_grads(fn):
        ys = fn(pendulum_f, Tsit5(), u0s, ps, saveat)[0]
        return torch.autograd.grad((ys * w_ys).sum(), [u0s, ps])

    e = max(max_err(a, b) for a, b in zip(
        rk_grads(ode_cuda.solve_fixed_grid_batched),
        rk_grads(ode_cuda.solve_fixed_grid_batched_reference)))
    log("grads", f"rk_fixed_grid: max abs err {e:.3e} (tol {GRAD_TOL:.0e})")
    if not e <= GRAD_TOL:
        fail(f"rk_fixed_grid grads: {e} > {GRAD_TOL}")

    # ---- 4. main path: GOKU training on pendulum video --------------------
    t0 = time.perf_counter()
    latent, u0s_d, ps_d, frames = generate_dataset(device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    u0_np, ps_np = draw_initial_conditions()
    if not (np.array_equal(u0s_d.cpu().numpy(), u0_np)
            and np.array_equal(ps_d.cpu().numpy(), ps_np)):
        fail("dataset initial conditions differ from the numpy draw")
    if (tuple(frames.shape) != (450, 100, 28, 28)
            or not bool(torch.isfinite(frames).all())
            or float(frames.min()) < 0 or float(frames.max()) > 1):
        fail(f"dataset frames: shape {tuple(frames.shape)}, range "
             f"[{float(frames.min())}, {float(frames.max())}]")
    x = frames.reshape(450, 100, 784)
    train_set, val_set = splitobs(x, 0.9)
    log("train", f"dataset 450x100x28x28 on {dev} in {gen_s:.3f} s; "
                 f"train {tuple(train_set.shape)} val {tuple(val_set.shape)}")

    mt = GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True)
    enc, dec = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    model = LatentDiffEqModel.build(mt, enc, dec)
    cfg = TrainConfig(epochs=1500, save_best=False)
    trainer = Trainer(model, cfg, device=dev)
    counters = {"goku_heads": recurrent_cuda.goku_heads_cuda,
                "rk_fixed_grid": ode_cuda.solve_fixed_grid_batched_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = train_set.shape[0] // cfg.batch_size
    for rec in hist:
        log("train", f"epoch {rec['epoch']}: train loss "
                     f"{rec['train_loss']:.6f} val loss {rec['val_loss']:.6f}"
                     f" beta {rec['beta']:.4f} {rec['epoch_s']:.4f} s")
        if not (math.isfinite(rec["train_loss"])
                and math.isfinite(rec["val_loss"])):
            fail(f"non-finite loss in epoch {rec['epoch']}")
    expected = 2 * steps * 2        # (train step + val pass) per step
    log("train", f"fit 2 epochs x {steps} steps in {fit_s:.3f} s; kernel "
                 f"launches {launches} (expected {expected} each)")
    for k, n in launches.items():
        if n != expected:
            fail(f"kernel {k} launched {n} times on the main path, "
                 f"expected {expected}")

    # the kernel path against the plain path, same weights, on the card
    plain = copy.deepcopy(model)
    plain.model_type = plain.encoder.model_type = \
        plain.decoder.model_type = GOKUBasic()
    t_val = torch.arange(100, dtype=torch.float32, device=dev) * cfg.dt
    with torch.no_grad():
        (xk, zk, _), _, _, aux = model(val_set, t_val)
        (xp, zp, _), _, _, _ = plain(val_set, t_val)
    e = max(max_err(xk, xp), max_err(zk, zp))
    log("train", f"trained model, kernel vs plain path on the val set: "
                 f"x_hat {tuple(xk.shape)} max abs err {e:.3e} (tol "
                 f"{PATH_TOL:.0e}); all solves ok: "
                 f"{bool(aux['success'].all())}")
    if not (e <= PATH_TOL and bool(torch.isfinite(xk).all())):
        fail(f"kernel path vs plain path: {e}")

    # step time, synchronised: one training step, then the validation pass
    data = train_set[:cfg.batch_size, :cfg.seq_len]
    beta = float(hist[-1]["beta"])
    step_t, val_t = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(data, beta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.val_step(val_set, beta)
        torch.cuda.synchronize()
        step_t.append(t1 - t0)
        val_t.append(time.perf_counter() - t1)
    log("train", f"step time (median of 5, synchronised): train step "
                 f"{1e3 * float(np.median(step_t)):.3f} ms, val pass "
                 f"{1e3 * float(np.median(val_t)):.3f} ms; card {gpu}")

    # ---- 5. kernel timing -------------------------------------------------
    tab = Tsit5().tableau
    n_st = n_solution_stages(tab)
    clock = max_sm_clock_mhz()
    kernels = []
    with torch.no_grad():
        for label, (B, T) in (("train", (64, 50)), ("val", (45, 100))):
            xs = torch.randn(B, T, 32, generator=gen, device=dev)
            k_ms = time_ms(lambda: recurrent_cuda.goku_heads_cuda(*heads,
                                                                  xs))
            p_ms = time_ms(lambda: recurrent_cuda.goku_heads_reference(
                *heads, xs), reps=5, warmup=1)
            d_ms = device_ms(lambda: recurrent_cuda.goku_heads_cuda(
                *heads, xs), "goku_heads_kernel")
            b_ms, b_by, t_b, t_o = bound_ms(*heads_work(B, T, 32, 16, 2))
            log("timing", f"goku_heads {label} B={B} T={T}: kernel "
                          f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on the "
                          f"device), plain {p_ms:.4f} ms, bound "
                          f"{b_ms:.6f} ms ({b_by}; bytes {t_b:.6f} ms, "
                          f"operations {t_o:.6f} ms), latency model "
                          f"{heads_latency_ms(T, 2, 32, 16, clock):.6f} ms "
                          f"at {clock:.0f} MHz")
            if label == "train":
                heads_t = (k_ms, p_ms, b_ms, b_by)
            u0s = torch.rand(B, 2, generator=gen, device=dev) * 2 - 1
            ps = 1 + torch.rand(B, 1, generator=gen, device=dev)
            saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
            k_ms = time_ms(lambda: ode_cuda.solve_fixed_grid_batched_cuda(
                pendulum_f, Tsit5(), u0s, ps, saveat))
            p_ms = time_ms(lambda: ode_cuda.solve_fixed_grid_batched_reference(
                pendulum_f, Tsit5(), u0s, ps, saveat), reps=5, warmup=1)
            d_ms = device_ms(lambda: ode_cuda.solve_fixed_grid_batched_cuda(
                pendulum_f, Tsit5(), u0s, ps, saveat), "rk_fixed_grid_kernel")
            b_ms, b_by, t_b, t_o = bound_ms(*rk_work(B, T, 2, 1, 1, tab,
                                                     n_st))
            log("timing", f"rk_fixed_grid {label} B={B} T={T}: kernel "
                          f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on the "
                          f"device), plain {p_ms:.4f} ms, bound "
                          f"{b_ms:.6f} ms ({b_by}; bytes {t_b:.6f} ms, "
                          f"operations {t_o:.6f} ms), latency model "
                          f"{rk_latency_ms(T, 1, n_st, clock):.6f} ms "
                          f"at {clock:.0f} MHz")
            if label == "train":
                rk_t = (k_ms, p_ms, b_ms, b_by)
    for name, src, replaces, (k_ms, p_ms, b_ms, b_by) in (
            ("goku_heads", "latentdiffeq_torch/csrc/goku_heads.cu",
             "latentdiffeq/ops/recurrent_pallas.py:86", heads_t),
            ("rk_fixed_grid", "latentdiffeq_torch/csrc/rk_fixed_grid.cu",
             "latentdiffeq/ops/ode_pallas.py:130", rk_t)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            trainer.train_step(data, beta)
            trainer.val_step(val_set, beta)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=25)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "profile_step.txt"), "w") as f:
            f.write(table)
        evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy_us = sum(getattr(e, "device_time", None)
                      or getattr(e, "cuda_time", 0) for e in evs)
        span_us = (max(e.time_range.end for e in evs)
                   - min(e.time_range.start for e in evs)) if evs else 0
        log("profile", f"one train step + val pass: {len(evs)} device ops, "
                       f"device busy {busy_us / 1e3:.3f} ms of a "
                       f"{span_us / 1e3:.3f} ms span; table in "
                       f"chiprun_out/profile_step.txt")
        for line in table.splitlines()[:14]:
            log("profile", line)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
