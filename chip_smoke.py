"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one line (any failure exits non-zero):
  1. build    compile every CUDA kernel of the port (one nvcc per source, in
              parallel) and print the card's name and power limit;
  2. kernels  each forward kernel against its plain PyTorch version on the
              card (TF32 off) at the training, validation and ragged batch
              shapes, and the tape-writing variants (goku_heads,
              node_field_fwd) against the plain tape; goku_heads also with
              heads wider than its compiled widths, and its bf16 instances
              (train, validation, ragged, wide, S 8) against the plain bf16
              version, each beside a float32 evaluation (bf16_gate); rk_fixed_grid also with
              RK4, Dopri5, sub-steps and the damped RHS, its success flags
              (also on failing rows), its baked tableau instances against
              the generic one bit for bit, rows past its fast sine's bound
              (the accurate rerun), a 1100-point grid beside a float64
              solve, and its sine against float64, and with the Van der
              Pol and Kuramoto-10 functors (also with frequency offsets)
              at their paths' shapes, each beside a float64 solve, and
              the Kuramoto kernels' copies of sinf and sincosf against
              the library's bit for bit; the
              neural-field
              solve also with RK4 and sub-steps, at the 8-wide and the
              128-256-256-128 field and with tanh, each beside a float64
              plain solve; fields the kernel does not take raise;
  3. grads    each backward kernel against its plain version on the same
              inputs: goku_heads_bwd against the plain sweep on the same
              tape (relu and tanh RNN, and wide heads; its bf16 instances
              as in phase 2, and the bf16 whole backward), rk_fixed_grid_bwd's
              interval maps against the plain maps and its gradients
              against the two-phase plain version and the plain reverse
              sweep over the same trajectory (also for Van der Pol and
              Kuramoto-10, and at T 300 beside a float64 sweep), the
              neural-field sweep and weight-gradient kernels on the same
              tape, the weight-gradient kernel also at the train, val,
              ragged, 8-wide and wide-field shapes (two calls bit for bit)
              and with 4 replicas in one launch (against the plain product
              with the replica axis, and bit for bit against 4 solo
              launches); then each whole backward against plain autograd (the
              neural field also against backward="autograd" and the plain
              recomputing sweep in float32 and float64); relu units that
              flip between the kernel's and the plain forward are counted;
  4. train    the main paths, on the 450 x 100 x 28 x 28 pendulum video
              generated on the card: full-width GOKU with both kernel
              switches on, then full-width LatentODE with the kernel solve,
              each Trainer.fit for 2 epochs (6 steps each, validation after
              every step); losses must be finite, every kernel must have
              launched the expected number of times (GOKU: 24 forward and
              12 backward launches of each of its two kernels, and no call
              of their plain versions), and the kernel path must agree with
              the plain path; step and validation times, and the device
              ops of one GOKU step; then GOKU at the JAX examples' width on
              Van der Pol (mu_max 4) and on Kuramoto-10 data made on the
              card, the same checks with the RK kernels' instance for that
              RHS; then the solve API and both adjoints on CUDA tensors
              against the same calls on CPU tensors (float64), and the
              adaptive SDE with its per-row step counts; then (4f)
              full-width GOKU on the stochastic pendulum (SRA1 over the
              threefry Brownian tree, plain PyTorch) through the
              goku_heads kernels: 24 forward and 12 backward launches, no
              RK kernel launch, the kernel route against the plain route
              and the Brownian path card against CPU on the same key, the
              ELBO of spendulum_pop4_winner.npz card against CPU, step and
              validation times, and one adaptive-SDE forward's time; then
              (4g) full-width GOKU on the pendulum as a population of 8
              seeds (333-340, MultiSeedTrainer, the sliced curriculum from
              20 frames): one masked-curriculum epoch (the sliced
              windows: a sliced epoch's launches and the first sliced
              epoch's losses), then 2 epochs
              that must launch each kernel as often as a solo Trainer of
              seed 336 (one launch a call for all replicas) with no plain
              call, replica 3 against that Trainer (rtol 2e-4), the
              replica-axis heads kernels against the plain versions
              vmapped over the weight sets (the solo rows' tolerances) and,
              with the vmapped RK solve, against solo launches bit for
              bit, kernel vs plain route, selection
              by the pixel score, a replica checkpoint into a Trainer, the
              population and solo step times and device ops, and the
              adaptive SPendulum forward before and after the autosize
              probe; then (4h) GOKU with bf16 NN stages around a float32
              solve (goku_default_layers(..., dtype=torch.bfloat16), seed
              333): the first step's ELBO and gradients, kernel route vs
              the plain bf16 and float32 routes, a Trainer.fit of 2 epochs
              that launches the heads kernels' bf16 instances 24 / 12
              times and the float32 RK kernel 24 / 12 times with no plain
              call, the ELBO of goku_bf16_gate.npz card vs CPU, the step
              beside the float32 one; and the 4g population in bf16 (the
              recipe of ttg_bf16_px_winner.npz), its bf16 replica-axis
              launches and checks; then (4i) full-width LatentODE as a
              population of 4 seeds (1-4, train_latent_ode.py
              --pallas-solve --seeds 4) for 2 epochs: each step launches
              node_field_fwd twice (the taped train forward and the
              validation pass), node_field_bwd and node_field_dw once,
              for all S replicas, no plain version runs, replica 1 against
              a solo Trainer of seed 2 (rtol 2e-4), the population's and
              the solo step's times and device ops; then (4j) the training
              CLIs through their main(argv), the pendulum cache seeded
              with this phase's video: train_goku.py --epochs 2 with its
              figures, a 3-epoch run interrupted after 2 and resumed by
              --resume against 3 epochs straight (weights within 1e-4,
              and whether bit for bit), --seeds 2 --masked --select-by
              pixel --warm-start --warm-steps 20, --dtype bf16,
              train_latent_ode.py --pallas-solve, train_vdp.py,
              train_kuramoto.py, forecast.py and train_original_data.py
              on a small npz in chiprun_out/: each run's launches exactly
              as expected, no plain call, finite losses, its steady epoch
              seconds; then (4k, run after phase 5, so that its process
              groups and profiler session follow every measurement)
              train_goku.py --data-parallel 1 in this
              process on NCCL (24 / 12 launches of each GOKU kernel, the
              weights within 1e-6 of 4j's solo run, bit for bit or not,
              in blocks), then two ranks on the one card under torch.distributed.run
              with gloo, per step (this script's --dp-worker mode; each
              rank's exit code and results checked): --data-parallel 2 (24 / 12
              launches a rank at B 32, the ranks' weights bit for bit,
              the first step's gradient against the solo step's, each
              epoch's validation loss against the solo run's, the step
              time beside the solo step's) and --seeds 8 --data-parallel
              2 (4 replicas a
              rank, one launch a call; the selected seed and its
              validation loss against the unsharded population's);
              trace_profile around one data-parallel step (its trace names
              both GOKU forward kernels) and PhaseTimer against the step
              time; create_data with renderer="native" against the torch
              renderer; the tutorial for 2 epochs (the encoder kernel, its
              section 14 decode card against CPU); then (4l, after 4k)
              user-written fields on the batched RK kernel: phase 1
              builds, beside the port's sources, a device functor
              generated from each field's trace (the tutorial's
              pendulum_f, untagged copies of pendulum_f and vdp_f, a
              forced damped oscillator that reads t, pdim 3) and the
              lane-group Kuramoto kernels at 7 oscillators; the
              tutorial's main for 2 epochs on the card with its own field
              on the kernel route (its generated instance's launches, no
              plain solve); full-width GOKU on the video with the
              tutorial's field (launches, no plain solve, the kernel
              against the plain path, its losses within 1e-4 of the
              tagged pendulum run's); GOKU on Kuramoto-7 data made by
              custom_data (4l's instances are checked against their
              plain versions and timed in phase 5); then (4m) every field
              JAX's Pallas solve runs: Lorenz-96 at 40 sites with its
              forcing in p, written with torch.roll (a generated functor,
              its interval maps past MAX_MAP_FLOATS: the sliced forward
              and the reverse-sweep backward), and Kuramoto at 64
              oscillators (the block kernels, the forward's sines spread
              over the block): GOKU at the custom dynamics' width on
              each for 2 epochs (launches, no plain solve, the kernel
              against the plain path), and the kernel and plain routes
              from the same seed for one step and a validation pass
              (losses within 1e-4 of their size; 4m's instances too are
              checked and timed in phase 5); and (4n, after 4j, before
              phase 5; the parts from (a) on after 4m) block mode, the
              Trainer's and MultiSeedTrainer's default (epochs as CUDA
              graphs, the best on the device): full-width GOKU on the
              pendulum and full-width LatentODE, then the two as
              Trainer(mesh=make_mesh(1)) on a one-rank NCCL group (DDP's
              all-reduces in each captured epoch, after 2 eager epochs of
              its warm-up; against the mesh's per-step loop and the solo
              block Trainer, bit for bit; a one-epoch device-only
              window); (after 4m) (a) GOKU on
              the stochastic pendulum, (b) the adaptive
              pendulum and adaptive SPendulum at train_goku.py
              --adaptive's settings, autosized (one block each, of 2
              epochs for the adaptive SPendulum), (c) 4g's
              population of 8 in float32 and bf16 (replica 3 against a
              solo block-mode Trainer), (d) 4 LatentODE seeds, (e) 4
              SPendulum seeds: 2 blocks of 3 epochs (replays under sync
              debug mode "error") beside jit_epoch=False from the same
              seeds, every epoch's losses, the weights, Adam's state, the
              best and the streams bit for bit, the launch counters
              (replay-aware) equal and as expected with no plain call,
              each graph's capture seconds and kernel nodes; one more
              block of each in a profiler window (one epoch for (b); the
              hand-written kernels' device records equal), steady epoch
              seconds, step + validation ms, device busy and idle share
              beside the per-step loop's; the earlier phases' Trainers
              and populations run jit_epoch=False (the per-step numbers
              recorded), 4j's CLIs and 4l's tutorial and GOKU block mode;
  5. timing   each kernel's time per call (CUDA events, wrapper included)
              and on the device alone (a torch.profiler window armed by
              utils.device_profile, its lost_kernel_records beside each
              time, as beside every profiler count) beside its plain
              version's time on the same inputs, its bytes/operations
              bound and a latency model of its serial chain; the GOKU
              heads' products; forward + backward of the heads and of the
              RK solve (pendulum, Van der Pol, Kuramoto-10) by the kernel
              route and by plain autograd, and of
              the heads by cuDNN (torch.nn.RNN + 2 torch.nn.LSTM forward,
              backward alone and forward + backward, goku_heads' and
              goku_heads_bwd's yardsticks; the port never calls them); the same for the bf16 instances (cuDNN in
              bf16, bytes at 2 an element); the replica-axis heads kernels
              at S 8 beside 8 solo launches and the vmapped plain version,
              in float32 and bf16; the
              neural-field kernels' launch plan,
              their time at 1 and 2 rows a block; the forward and sweep
              with a replica axis (S 4 and 8, train and validation
              shapes, 1 and 2 rows a block) against S solo launches bit
              for bit, their times, and at S 4 beside S solo launches,
              the plain version, bound and latency model; node_field_dw at the
              train, val and wide shapes and with 4 replicas beside
              torch.mm per layer (torch.bmm with replicas), its plain
              version, its bound on the tensor cores and the float32 SIMT
              bound; 4l's and 4m's instances (the generated functors,
              Kuramoto-7 on the lane groups, Lorenz-96-40 on the sliced
              forward and reverse sweep, Kuramoto-64 on the block
              kernels; both plans of the wide routes, the design of the
              forward, what each backward keeps in shared memory and the
              sweep's slices, and where they change; the two new
              forwards against the designs before them, built from the
              same source with FWD_BEFORE, on the same inputs, bit for
              bit, states and flags, and both timed),
              forward and backward, against the plain versions at their
              train and
              validation shapes with the gates of phase 2 and 3 (float32
              1e-5 and bit for bit where the order is the plain
              version's, float64 distance, gradients 1e-5 of each size,
              interval maps or the plain reverse sweep, the whole
              backward against plain autograd), the untagged pendulum
              and Van der Pol against their hand-written functors (bit
              for bit or the largest gap), each beside its plain
              version's time, its bound from the traced program's
              operations and a latency model from its critical path, the
              hand-written twins timed beside them; with
              --profile, a
              torch.profiler breakdown of one training step plus
              validation of each model, written to
              chiprun_out/profile_step.txt,
              chiprun_out/profile_step_latent_ode.txt and
              chiprun_out/profile_step_bf16.txt.
It then prints the kernels JSON line, the card line and, last, the result
line {"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no
result. ``python3 chip_smoke.py --dp-worker DIR`` is one rank of phase 4k,
started by the phase itself under torch.distributed.run.
"""
from __future__ import annotations

import copy
import dataclasses
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
TF32_FLOPS_PER_S = 495e12   # the tensor cores, TF32, dense
TOL = 1e-5          # kernel vs plain version, float32, both kernels
GRAD_TOL = 1e-5     # gradients, of each tensor's size: the same VJP
PATH_TOL = 1e-4     # model output, kernel path vs plain path
# Neural-field solve, kernel vs plain float32 (states of order 1, up to 297
# RK steps): the products are summed in another order than aten::mm's, so
# the two differ in the last bits and the field's dynamics carry that along.
# Besides the absolute tolerance, the kernel may be at most twice as far from
# a float64 plain solve as the float32 plain solve is (plus 1e-6).
NODE_TOL = 1e-5
# Its gradients, as max |difference| over max |gradient| of each tensor.
# The backward kernel is held against the plain reverse sweep over the SAME
# saved trajectory in float64, and end to end against plain autograd. For a
# smooth field (tanh) the tolerance is 1e-5. A relu field's gradient is
# discontinuous: a unit whose pre-activation lies within rounding of zero is
# on in one float32 evaluation and off in another (the phase counts such
# units), which changes the gradient by a finite amount however close the
# two are, and the plain float32 versions are as far from float64 as the
# kernel is (both are printed). So relu fields get RELU_GRAD_TOL, which
# still catches a wrong derivative or a dropped term, and the arithmetic at
# every width is pinned by the tanh cases.
NODE_GRAD_TOL = 1e-5
RELU_GRAD_TOL = 1e-2
NODE_WIDTHS = (16, 200, 200, 16)
WIDE_WIDTHS = (128, 256, 256, 128)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def log_phase(name: str):
    """The script's elapsed time as a phase starts (to keep the run well
    inside its time limit)."""
    log("time", f"{name} starts at {time.perf_counter() - T_START:.1f} s")


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


def plain_timed(fn):
    """(fn's result, a plain version's time per call on the card, ms): the
    call itself, synchronised (they take 10-10,000 ms, where one call's
    noise is small beside the time), or three more after it when that call
    took under 50 ms."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    return out, ms if ms >= 50 else time_ms(fn, reps=3, warmup=0)


def plain_ms(fn):
    """A plain version's time per call on the card (plain_timed)."""
    return plain_timed(fn)[1]


class DeviceMs(float):
    """A device time (ms) from a profiler window, with the window's
    ``lost_kernel_records`` (``lost``), which fmt_ms prints beside it."""
    lost: dict


PROFILE_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "profile_window.json")


def profiler_window(fn, count_lost: bool = True, device_only: bool = False):
    """Run ``fn`` (and a synchronize) in a torch.profiler window opened
    with utils.device_profile, which arms device tracing before the region
    and pads it on both sides (the profiler drops the device records that
    a device clock mapped a few ms off puts outside the window). Returns
    (the profiler, its lost_kernel_records: the region's launches with no
    kernel record, the pads' apart; None without ``count_lost``, which
    skips the window's Chrome trace). ``device_only``: record the
    device's activity alone."""
    from latentdiffeq_torch.utils import device_profile, lost_kernel_records
    kw = ({"activities": [torch.profiler.ProfilerActivity.CUDA]}
          if device_only else {})
    with device_profile(**kw) as prof:
        fn()
        torch.cuda.synchronize()
    if not count_lost:
        return prof, None
    os.makedirs(os.path.dirname(PROFILE_TRACE), exist_ok=True)
    prof.export_chrome_trace(PROFILE_TRACE)
    lost = lost_kernel_records(PROFILE_TRACE)
    os.remove(PROFILE_TRACE)
    return prof, lost


def region_device_op(name: str) -> bool:
    """Whether a CUDA event of a device_profile window is one of its
    region's operations: not the step annotation the profiler's schedule
    records over the whole window (ProfilerStep#N, a GPU user annotation),
    nor device_profile's pads (their annotations and spin kernels)."""
    from latentdiffeq_torch.utils import PAD, PAD_KERNEL
    return not (name.startswith("ProfilerStep") or name == PAD
                or PAD_KERNEL in name)


def device_events(prof):
    """The device's operations in a profiler window's region: its CUDA
    events that region_device_op keeps."""
    return [e for e in prof.events() if e.device_type.name == "CUDA"
            and region_device_op(e.name)]


def lost_str(lost) -> str:
    if lost is None:
        return "lost_kernel_records not counted"
    return (f"lost_kernel_records {lost['lost']} of {lost['launches']} "
            f"launches")


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time per launch of the CUDA kernels whose name holds
    ``kernel``, from torch.profiler (the kernel alone, without the host
    work of its wrapper), over the launches the window recorded: a
    DeviceMs carrying the window's lost_kernel_records; None (and a
    [profile] line with them) if it saw no such kernel."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    prof, lost = profiler_window(run)
    us = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
          for e in prof.events()
          if e.device_type.name == "CUDA" and kernel in e.name]
    if not us:
        log("profile", f"device_ms: no {kernel} record in the window; "
                       f"{lost_str(lost)}")
        return None
    out = DeviceMs(sum(us) / 1e3 / len(us))
    out.lost = lost
    return out


def step_times(trainer, data, val_set, beta, reps: int = 5):
    """(train step, validation pass) in ms, each the median of ``reps``
    synchronised runs on the host clock."""
    step_t, val_t = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(data, beta)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.val_step(val_set, beta)
        torch.cuda.synchronize()
        step_t.append(t1 - t0)
        val_t.append(time.perf_counter() - t1)
    step_t.sort()
    val_t.sort()
    return 1e3 * step_t[reps // 2], 1e3 * val_t[reps // 2]


def fmt_ms(ms) -> str:
    if ms is None:
        return "not measured"
    lost = getattr(ms, "lost", None)
    return f"{ms:.4f} ms" + (f" [{lost_str(lost)}]" if lost else "")


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def heads_work(B, T, D, H, L, S=1, elem=4):
    """(bytes, float32 operations) the heads function needs: xs, weights
    and outputs moved once, ``elem`` bytes an element (2 for bfloat16);
    per step and row, the gate products (2 flops per multiply-add) and the
    cell updates (~10 operations per LSTM unit, sigmoid/tanh counted as one
    each, 1 per RNN unit). ``S`` weight sets of B rows each: S * B rows and
    S sets of weights."""
    n_w = 0
    flops_step = 0
    for s in range(3):
        G = H if s == 0 else 4 * H
        for l in range(L):
            din = D if l == 0 else H
            n_w += din * G + H * G + G + H + (H if s else 0)
            flops_step += 2 * (din + H) * G + G
            flops_step += 10 * H if s else H
    nbytes = elem * (S * B * T * D + S * n_w + S * B * 3 * H)
    return nbytes, S * B * T * flops_step


def rhs_ops(which, dim):
    """(operations of one RHS evaluation, of one VJP) of an RK device
    functor: the pendulum 3 (divide, multiply, sin) and 8 (cos, sin,
    reciprocal, products); Van der Pol 5 (x x, 1 -, mu *, * y, - x) and 13;
    Kuramoto N the N(N-1)/2 differences and their sines, N(N-2) adds of the
    sums and 3 N more, and for the VJP 3 N(N-1) products and adds for the
    cosine sums, N(N-1) for the sine sums again and ~5 N more."""
    if which == "pendulum":
        return 3, 8
    if which == "vdp":
        return 5, 13
    n = dim
    return n * (n - 1) + n * (n - 2) + 3 * n, 4 * n * (n - 1) + 5 * n


def rk_work(B, T, dim, pdim, substeps, tab, n_stages, which="pendulum",
            n_cst=0, ops=None):
    """(bytes, float32 operations) of the batched RK solve: u0s, ps,
    saveat and the functor's n_cst run-time constants in and ys out once;
    per step, the stage combinations (a multiply and an add per state entry
    per nonzero coefficient, plus the dt * a product), the stage times, and
    the RHS (rhs_ops, or ``ops`` = (evaluation, VJP) counts of a generated
    functor, gen_ops)."""
    ev = (ops or rhs_ops(which, dim))[0]
    ops = 0
    for s in range(n_stages):
        nz = sum(1 for a in tab.a[s] if a != 0.0)
        ops += nz * (2 * dim + 1) + 2 + ev
    ops += sum(1 for b in tab.b[:n_stages] if b != 0.0) * (2 * dim + 1)
    nbytes = 4 * (B * dim + B * pdim + T + B * T * dim + n_cst)
    return nbytes, B * (T - 1) * substeps * ops


# Dependent-issue latencies in cycles for a latency model of the two
# kernels (both are serial chains): a float32 FMA, a special-function step
# (ex2, rcp, sin with its range reduction), a block barrier. Round figures
# for a lower bound, not measurements.
FMA_CYC, SFU_CYC, BAR_CYC = 4, 20, 20


def heads_latency_ms(T, L, D, H, clock_mhz):
    """Least time of the forward's chain as csrc/goku_heads.cu runs it, a
    wavefront of T + L - 1 links (layer l + 1 one step behind layer l), if
    each gate product were a tree reduction: per link the longest layer,
    ceil(log2(D + H)) FMA levels, the LSTM cell update (sigmoid, FMA, tanh,
    multiply: 4 special-function steps and 2 FMAs) and one barrier."""
    cyc = (math.ceil(math.log2(D + H)) + 2) * FMA_CYC + 4 * SFU_CYC + BAR_CYC
    return (T + L - 1) * cyc / (clock_mhz * 1e3)


def heads_bwd_latency_ms(T, L, H, clock_mhz):
    """The same for the sweep: per link the LSTM cell's backward (one tanh,
    4 dependent FMAs), the 4H-term products as a tree, and one barrier."""
    cyc = (math.ceil(math.log2(4 * H)) + 4) * FMA_CYC + SFU_CYC + BAR_CYC
    return (T + L - 1) * cyc / (clock_mhz * 1e3)


def heads_bwd_work(B, T, D, H, L, S=1, elem=4):
    """(bytes, float32 operations) of the sweep: the tape, the cotangents
    and the recurrent and inter-layer weights in, dgates, dh0 and dc0 out;
    per row-step and cell the products dgates Wh^T (and dgates Wi^T above
    layer 0; 2 flops per multiply-add) and the cell's backward (~16
    operations per LSTM unit, 2 per RNN unit). ``S`` weight sets of B rows
    each; ``elem`` bytes an element."""
    n_w = 0
    ops = 0
    for s in range(3):
        G = H if s == 0 else 4 * H
        for l in range(L):
            prods = 2 if l else 1
            n_w += prods * H * G
            ops += 2 * prods * H * G + (16 * H if s else 2 * H)
    B = S * B
    nbytes = elem * (B * T * 13 * H * L + B * 3 * H + S * n_w
                     + B * T * 9 * H * L + 2 * B * 3 * L * H)
    return nbytes, B * T * ops


# Dependent steps of the RK kernels' branch-free sine (csrc/rk_fixed_grid.cu,
# sincos_fast): a multiply, a rounding, the reduction's 3 FMAs, a square, the
# cosine polynomial's 4 FMAs (the longer of the two) and a select.
SIN_STEPS = 11
RK_BWD_CHUNK = 256  # intervals a chunk of the RK backward kernel


# The Kuramoto kernels (rk_kuramoto_kernel, rk_kuramoto_bwd_kernel) take a
# trajectory or an interval on a group of N lanes. A lane's N-1 sines of a
# stage are independent (the branch-free copy of sinf's fast path), so its
# warp issues them one after another: SINF_ISSUE instructions each with the
# shuffle that gathers the other phase, the difference and the add into the
# sum (SINCOS_ISSUE with the cosine and its store, in the backward), and the
# last one's latency, SINF_STEPS dependent steps (a multiply, two
# conversions, the reduction's 3 FMAs, the square, 4 polynomial FMAs and a
# select). SHFL_CYC: a shuffle's latency. Round figures, not measurements.
SINF_ISSUE, SINCOS_ISSUE, SINF_STEPS, SHFL_CYC = 24, 34, 12, 8


def kuramoto_stage_cycles(dim, issue=SINF_ISSUE):
    """Cycles of one stage on a Kuramoto lane: its input (an unfused
    multiply and add on the previous stage's slope), the shuffles and the
    first difference, the dim - 1 sines issued one after another and the
    last one's latency, then the sum's last add, the product and the
    add."""
    return ((3 + SINF_STEPS + 3) * FMA_CYC + SHFL_CYC
            + (dim - 1) * issue)


def rk_step_cycles(n_stages, which="pendulum", dim=2):
    """Cycles of one RK step on a trajectory's chain. The pendulum: stage
    s's angle needs only the sines of stages <= s - 2 (a stage's velocity
    enters the angle one stage later), so a step is two interleaved chains
    of ceil(n_stages / 2) sines; a link is the sine, the slope's product and
    two unfused multiply-adds (4 steps: into the next stage's velocity,
    then into the angle after it). Van der Pol, per stage its input (an
    unfused multiply and add on the previous stage's slope) and its 5
    dependent operations. Kuramoto, per stage `kuramoto_stage_cycles`."""
    if which == "pendulum":
        return math.ceil(n_stages / 2) * (SIN_STEPS + 5) * FMA_CYC
    if which == "vdp":
        return n_stages * (2 + 5) * FMA_CYC
    return n_stages * kuramoto_stage_cycles(dim)


def rk_latency_ms(T, substeps, n_stages, clock_mhz, which="pendulum", dim=2):
    """Least time of one trajectory's chain in the forward kernel:
    (T - 1) * substeps steps of `rk_step_cycles`."""
    return ((T - 1) * substeps * rk_step_cycles(n_stages, which, dim)
            / (clock_mhz * 1e3))


# Dependent steps of one stage's VJP of one basis cotangent.
VJP_STEPS = {"pendulum": 3, "vdp": 4}


def rk_bwd_latency_ms(T, substeps, n_stages, clock_mhz, which="pendulum",
                      dim=2):
    """Least time of the backward kernel's chain per trajectory: per chunk
    of intervals, one interval's work and a barrier; then the T - 1 links
    of the affine sweep, ybar' = J^T ybar + g. The pendulum and Van der Pol
    (RK_BWD_CHUNK intervals a chunk, a thread an interval): per sub-step
    the stages, as in the forward, the VJP of the dim basis cotangents
    through the stages in reverse, VJP_STEPS a stage, in parallel, and the
    dim-term composition; a link is a dim-term dot product and an add.
    Kuramoto (a group of dim lanes an interval, a row's intervals all at
    once on a cluster of blocks): per sub-step the stages as in the
    forward (with the cosines), then lane e's sweep of basis cotangent e,
    all dim in parallel, per stage issued by one warp (the dim(dim-1)
    products of the cosine sums with their loads, 3 dim(dim-1), and ~6 dim
    more), and the composition (dim^2 products with their loads, 3 dim^2);
    a link is the shuffles of ybar, a dim-term sum and an add."""
    if which == "kuramoto":
        chunks = 1
        vjp = 3 * dim * (dim - 1) + 6 * dim
        interval = substeps * (
            n_stages * (kuramoto_stage_cycles(dim, SINCOS_ISSUE) + vjp)
            + 3 * dim * dim)
        link = SHFL_CYC + (dim + 1) * FMA_CYC
    else:
        chunks = math.ceil((T - 1) / RK_BWD_CHUNK)
        interval = substeps * (rk_step_cycles(n_stages, which, dim)
                               + (n_stages * VJP_STEPS[which] + dim)
                               * FMA_CYC)
        link = (dim + 1) * FMA_CYC
    cyc = chunks * (interval + BAR_CYC) + (T - 1) * link
    return cyc / (clock_mhz * 1e3)


def rk_sweep_latency_ms(T, substeps, n_stages, clock_mhz):
    """The same for the step-by-step reverse sweep (the backward's design
    before the interval maps, one thread per trajectory), as that design's
    model had it: per step, each stage recomputed and its VJP, 3 FMAs and
    3 special-function steps each, and one more FMA."""
    per_step = 2 * n_stages * (3 * FMA_CYC + 3 * SFU_CYC) + FMA_CYC
    return (T - 1) * substeps * per_step / (clock_mhz * 1e3)


def rk_bwd_work(B, T, dim, pdim, substeps, tab, n_stages, which="pendulum",
                n_cst=0, ops=None):
    """(bytes, float32 operations) of the RK reverse sweep: saveat, ys, ps,
    g and the run-time constants in, du0 and dp out; per step the forward
    stages again and, per stage, the VJP (rhs_ops) and the cotangent
    updates (as the stage combinations)."""
    nbytes = 4 * (T + 2 * B * T * dim + 2 * B * pdim + B * dim + n_cst)
    fwd_ops = rk_work(B, T, dim, pdim, substeps, tab, n_stages, which,
                      ops=ops)[1]
    return (nbytes, 2 * fwd_ops + B * (T - 1) * substeps * n_stages
            * (ops or rhs_ops(which, dim))[1])


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def node_work(B, T, widths, substeps, tab, n_stages, part="fwd"):
    """(bytes, float32 operations) of one neural-field kernel, each input
    read once and each output written once.
    fwd:   u0s, saveat and the weights in, ys out; per stage the layer
           products (2 per multiply-add), bias and activation (2 per unit)
           and the stage combination; per step the solution update.
    sweep: the tape (layer outputs, unpadded), g, saveat and the weights
           in, du0 and Delta out; per stage the input-gradient products,
           the activation derivatives (2 per unit) and the cotangent
           updates; per step the kbar initialisation.
    dw:    the layer inputs of the tape and Delta in, the weight gradient
           out; 2 operations per multiply-add of [H, 1]^T Delta."""
    dim = widths[0]
    macs = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    units = sum(widths[1:])
    n_w = macs + units
    combos = sum(sum(1 for a in tab.a[s] if a != 0.0)
                 for s in range(n_stages)) * 2 * dim
    update = sum(1 for b in tab.b[:n_stages] if b != 0.0) * 2 * dim
    steps = B * (T - 1) * substeps
    if part == "fwd":
        nbytes = 4 * (B * dim + T + n_w + B * T * dim)
        ops = steps * (n_stages * (2 * macs + 2 * units) + combos + update)
    elif part == "sweep":
        nbytes = 4 * (steps * n_stages * (sum(widths) + units)
                      + B * T * dim + T + macs + B * dim)
        ops = steps * (n_stages * (2 * macs + 2 * units) + combos + update)
    else:
        aug = sum((a + 1) * b for a, b in zip(widths[:-1], widths[1:]))
        nbytes = 4 * (steps * n_stages * (sum(widths[:-1]) + units) + n_w)
        ops = 2 * steps * n_stages * aug
    return nbytes, ops


def node_latency_ms(T, substeps, n_stages, widths, clock_mhz):
    """Least time of one tile's chain if every dot product were a tree
    reduction: per layer ceil(log2(in)) FMA levels and a block barrier, per
    stage one more FMA for the combination. The reverse sweep's chain has
    the same links (one input-gradient product per layer; the weight
    gradients lie off it, in node_field_dw)."""
    per_stage = sum(math.ceil(math.log2(w)) * FMA_CYC + BAR_CYC
                    for w in widths[:-1]) + FMA_CYC
    cyc = (T - 1) * substeps * (n_stages * per_stage + FMA_CYC)
    return cyc / (clock_mhz * 1e3)


def make_field(widths, act="relu", seed=0, device="cuda"):
    """A Chain-of-Dense field with the port's default weight init and
    biases from N(0, 0.1^2), made on the CPU from a seed."""
    from latentdiffeq_torch import nn
    g = torch.Generator().manual_seed(seed)
    m = nn.mlp(widths, getattr(nn, act), nn.identity, generator=g)
    with torch.no_grad():
        for lyr in m.layers:
            lyr.b.copy_(torch.randn(lyr.b.shape, generator=g) * 0.1)
    return m.to(device)


def node_inputs(widths, B, T, seed, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    u0s = (torch.randn(B, widths[0], generator=g) * 0.5).to(device)
    saveat = torch.arange(T, dtype=torch.float32, device=device) * 0.05
    w = torch.randn(B, T, widths[0], generator=g).to(device)
    return u0s, saveat, w


def rel_err(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@torch.no_grad()
def relu_switches(m, tab, ys, saveat):
    """(switched, all): hidden relu units whose on/off state differs between
    a float32 and a float64 recompute of every RK stage of every interval
    from the saved states, as the reverse sweep recomputes them."""
    from latentdiffeq_torch.solve.rk import n_solution_stages
    hidden = m.layers[:-1]
    last = m.layers[-1]
    dt = (saveat[1:] - saveat[:-1])[None, :, None]
    switched = units = 0
    k32, k64 = [], []
    y32, y64 = ys[:, :-1], ys[:, :-1].double()
    for s in range(n_solution_stages(tab)):
        h32, h64 = y32, y64
        for q, a in enumerate(tab.a[s]):
            if a != 0.0:
                h32 = h32 + (dt * a) * k32[q]
                h64 = h64 + (dt.double() * a) * k64[q]
        for lyr in hidden:
            h32 = torch.relu(h32 @ lyr.W + lyr.b)
            h64 = torch.relu(h64 @ lyr.W.double() + lyr.b.double())
            switched += int(((h32 > 0) != (h64 > 0)).sum())
            units += h32.numel()
        k32.append(h32 @ last.W + last.b)
        k64.append(h64 @ last.W.double() + last.b.double())
    return switched, units


def node_kernel_checks(gen_seed: int = 0) -> float:
    """Phase 2 for the neural-field forward kernel; returns the largest
    error against the plain float32 version."""
    from latentdiffeq_torch import nn
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import RK4, Tsit5
    cases = [("train", NODE_WIDTHS, 64, 50, Tsit5(), 1, "relu"),
             ("val", NODE_WIDTHS, 45, 100, Tsit5(), 1, "relu"),
             ("ragged", NODE_WIDTHS, 37, 21, Tsit5(), 1, "relu"),
             ("rk4-substeps3", NODE_WIDTHS, 64, 50, RK4(), 3, "relu"),
             ("d8", (8, 200, 200, 8), 64, 50, Tsit5(), 1, "relu"),
             ("wide", WIDE_WIDTHS, 256, 50, Tsit5(), 1, "relu"),
             ("tanh", NODE_WIDTHS, 64, 50, Tsit5(), 1, "tanh")]
    worst = 0.0
    with torch.no_grad():
        for i, (label, widths, B, T, solver, sub, act) in enumerate(cases):
            m = make_field(widths, act, seed=gen_seed + i)
            u0s, saveat, _ = node_inputs(widths, B, T, seed=100 + i)
            got = node_cuda.solve_neural_field_cuda(m, solver, u0s, saveat,
                                                    substeps=sub)
            ref = node_cuda.solve_neural_field_reference(
                m, solver, u0s, saveat, substeps=sub)[0]
            ys_t, tape = node_cuda.solve_neural_field_cuda(
                m, solver, u0s, saveat, substeps=sub, tape=True)
            tape_p = node_cuda.solve_neural_field_taped_reference(
                m, solver, u0s, saveat, substeps=sub)[1]
            hp = node_cuda.tape_layout(widths)[0]
            e_tape = max(rel_err(tape[..., o:o + n], tape_p[..., o:o + n])
                         for o, n in zip(hp, widths))
            ref64 = node_cuda.solve_neural_field_reference(
                copy.deepcopy(m).double(), solver, u0s.double(),
                saveat.double(), substeps=sub)[0]
            e = max_err(got, ref)
            e_k, e_p = max_err(got.double(), ref64), max_err(ref.double(),
                                                             ref64)
            worst = max(worst, e)
            log("kernels", f"node_field_fwd {label} {widths} B={B} T={T} "
                           f"{type(solver).__name__} substeps={sub} {act}: "
                           f"max abs err {e:.3e} (tol {NODE_TOL:.0e}); vs "
                           f"float64: kernel {e_k:.3e}, plain {e_p:.3e}; "
                           f"max |y| {float(ref.abs().max()):.3f}; "
                           f"tape-writing variant: same ys "
                           f"{torch.equal(ys_t, got)}, tape vs plain tape "
                           f"max rel err {e_tape:.3e} (tol {NODE_TOL:.0e})")
            if not (e <= NODE_TOL and e_k <= 2 * e_p + 1e-6
                    and bool(torch.isfinite(got).all())
                    and torch.equal(ys_t, got) and e_tape <= NODE_TOL):
                fail(f"node_field_fwd {label}: {e} > {NODE_TOL} or "
                     f"{e_k} > 2 * {e_p} + 1e-6 or tape {e_tape}")

    # no fallback: what the kernel does not take raises on CUDA tensors
    u0s, saveat, _ = node_inputs((8, 8), 4, 5, seed=0)
    refused = {
        "unknown activation": (
            ValueError, lambda: node_cuda.solve_neural_field(
                nn.mlp((8, 16, 8), torch.nn.functional.gelu).cuda(),
                Tsit5(), u0s, saveat)),
        "too deep": (
            ValueError, lambda: node_cuda.solve_neural_field(
                nn.mlp((8,) * (node_cuda.MAX_LAYERS + 2), nn.relu).cuda(),
                Tsit5(), u0s, saveat)),
        "not a Chain of Dense": (
            TypeError, lambda: node_cuda.solve_neural_field(
                nn.Chain([nn.Dense(8, 8, nn.relu), nn.SkipConnection(
                    nn.Dense(8, 8))]).cuda(), Tsit5(), u0s, saveat)),
        "too wide for a block": (
            ValueError, lambda: node_cuda.kernel_plan(
                (4096, 4096, 4096), 6, 64, backward=True)),
    }
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda,
                node_cuda.neural_field_dw_cuda)
    before = [fn.launches for fn in counters]
    for what, (exc, call) in refused.items():
        try:
            call()
        except exc as err:
            log("kernels", f"node_field refuses ({what}): "
                           f"{type(err).__name__}: {str(err)[:90]}")
        else:
            fail(f"node_field: {what} did not raise")
    if before != [fn.launches for fn in counters]:
        fail("a refused field launched a kernel")
    return worst


def node_grad_checks():
    """Phase 3 for the neural-field backward kernels; returns the largest
    absolute errors of the sweep kernel (du0 and Delta) and of the
    weight-gradient kernel against their plain versions on the same
    inputs."""
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5
    solver = Tsit5()
    names = ["du0", "dW0", "db0", "dW1", "db1", "dW2", "db2"]

    def flat(out):
        du0, dWs, dbs = out
        return [du0] + [t for pair in zip(dWs, dbs) for t in pair]

    def through(fn, m, u0s, saveat, w, **kw):
        u = u0s.detach().clone().requires_grad_()
        ys = fn(m, solver, u, saveat, **kw)[0]
        return torch.autograd.grad((ys * w.to(ys.dtype)).sum(),
                                   [u] + list(m.parameters()))

    worst_sweep = worst_dw = 0.0
    cases = [("train", NODE_WIDTHS, 64, 50, "relu"),
             ("train-tanh", NODE_WIDTHS, 64, 50, "tanh"),
             ("val", NODE_WIDTHS, 45, 100, "relu"),
             ("wide", WIDE_WIDTHS, 256, 50, "relu"),
             ("wide-tanh", WIDE_WIDTHS, 256, 50, "tanh")]
    for i, (label, widths, B, T, act) in enumerate(cases):
        m = make_field(widths, act, seed=20 + i)
        m64 = copy.deepcopy(m).double()
        u0s, saveat, w = node_inputs(widths, B, T, seed=200 + i)
        tol = RELU_GRAD_TOL if act == "relu" else NODE_GRAD_TOL
        # (a) each kernel against its plain version on the same inputs:
        # both read the same tape, so relu fields agree as closely as
        # smooth ones
        with torch.no_grad():
            ys, tape = node_cuda.solve_neural_field_cuda(m, solver, u0s,
                                                         saveat, tape=True)
        du0, delta = node_cuda.neural_field_sweep_cuda(m, solver, saveat,
                                                       tape, w)
        du0_p, delta_p = node_cuda.neural_field_sweep_reference(
            m, solver, saveat, tape, w)
        _, _, dp, _ = node_cuda.tape_layout(widths)
        pieces = [(du0, du0_p)] + [(delta[..., o:o + n], delta_p[..., o:o + n])
                                   for o, n in zip(dp, widths[1:])]
        e_sw = max(rel_err(a, b) for a, b in pieces)
        worst_sweep = max(worst_sweep, max(max_err(a, b) for a, b in pieces))
        dWs, dbs = node_cuda.neural_field_dw_cuda(m, tape, delta)
        dWs_p, dbs_p = node_cuda.neural_field_dw_reference(m, tape, delta)
        e_dw = max(rel_err(a, b) for a, b in zip(dWs + dbs, dWs_p + dbs_p))
        worst_dw = max(worst_dw, max(max_err(a, b) for a, b in
                                     zip(dWs + dbs, dWs_p + dbs_p)))
        log("grads", f"{label} {widths} B={B} T={T} {act}: node_field_bwd "
                     f"(sweep) vs plain sweep on the same tape, max rel err "
                     f"{e_sw:.3e}; node_field_dw vs plain product on the "
                     f"same tape and Delta {e_dw:.3e} (tol "
                     f"{NODE_GRAD_TOL:.0e})")
        if not (e_sw <= NODE_GRAD_TOL and e_dw <= NODE_GRAD_TOL):
            fail(f"node_field sweep / dw {label}: {e_sw}, {e_dw} > "
                 f"{NODE_GRAD_TOL}")
        # (b) the whole backward against the sweep that recomputes the
        # stages from the same saved trajectory
        got = [du0] + [t for pair in zip(dWs, dbs) for t in pair]
        ref = flat(node_cuda.solve_neural_field_backward_reference(
            m, solver, saveat, ys, w))
        ref64 = flat(node_cuda.solve_neural_field_backward_reference(
            m64, solver, saveat.double(), ys.double(), w.double()))
        e_sweep = max(rel_err(a, b) for a, b in zip(got, ref))
        e_k = max(rel_err(a.double(), c) for a, c in zip(got, ref64))
        e_p = max(rel_err(b.double(), c) for b, c in zip(ref, ref64))
        e_abs = max(max_err(a.double(), c) for a, c in zip(got, ref64))
        log("grads", f"node_field backward {label}, over the same ys, max "
                     f"rel err: kernels vs float64 plain recompute sweep "
                     f"{e_k:.3e} (tol {tol:.0e}; max abs err {e_abs:.3e}, "
                     f"largest gradient "
                     f"{max(float(c.abs().max()) for c in ref64):.3g}), "
                     f"float32 plain vs float64 plain {e_p:.3e}, kernels vs "
                     f"float32 plain {e_sweep:.3e}")
        if act == "relu":
            flips, units = relu_switches(m, solver.tableau, ys, saveat)
            log("grads", f"  relu units that are on in a float32 recompute "
                         f"of the sweep's stages and off in a float64 one, or "
                         f"the other way round: {flips} of {units}")
        if not (e_k <= tol and (act == "relu" or e_sweep <= tol)):
            fail(f"node_field backward {label} vs reverse sweep: {e_k}, "
                 f"{e_sweep} > {tol}")
    # (b) end to end through autograd: kernel route, recompute route,
        # plain autograd (its own forward), float64 plain autograd
        k = through(node_cuda.solve_neural_field, m, u0s, saveat, w)
        r = through(node_cuda.solve_neural_field, m, u0s, saveat, w,
                    backward="autograd")
        p = through(node_cuda.solve_neural_field_reference, m, u0s, saveat,
                    w)
        d = through(node_cuda.solve_neural_field_reference, m64,
                    u0s.double(), saveat.double(), w)
        e_kp = [rel_err(a, b) for a, b in zip(k, p)]
        e_kr = [rel_err(a, b) for a, b in zip(k, r)]
        e_kd = [rel_err(a.double(), c) for a, c in zip(k, d)]
        e_pd = [rel_err(b.double(), c) for b, c in zip(p, d)]
        log("grads", f"node_field backward {label}: kernels vs plain autograd max "
                     f"rel err {max(e_kp):.3e}, vs backward='autograd' "
                     f"{max(e_kr):.3e} (tol {tol:.0e}); vs float64 autograd: "
                     f"kernel {max(e_kd):.3e}, plain {max(e_pd):.3e}")
        log("grads", "  per tensor kernel|plain vs float64: " + ", ".join(
            f"{n} {a:.1e}|{b:.1e}" for n, a, b in zip(names, e_kd, e_pd)))
        if not (max(e_kp) <= tol and max(e_kr) <= tol
                and all(bool(torch.isfinite(t).all()) for t in k)):
            fail(f"node_field backward {label} vs autograd: {max(e_kp)}, "
                 f"{max(e_kr)} > {tol}")
    return worst_sweep, worst_dw


def latent_ode_path(train_set, val_set, dev, gpu):
    """The second main path: full-width LatentODE (the defaults of
    examples/pendulum/train_latent_ode.py) with the kernel solve,
    Trainer.fit for 2 epochs. Returns (launches, trainer, batch, beta)."""
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (LatentDiffEqModel, LatentODE, NODE,
                                           default_layers)
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.train import TrainConfig, Trainer

    g = torch.Generator().manual_seed(1)
    mt = LatentODE(use_kernel_solve=True)
    node = NODE(16, options=SolveOptions(adaptive=False, substeps=1),
                generator=g, device=dev)
    enc, dec = default_layers(mt, 784, node, generator=g, device=dev)
    model = LatentDiffEqModel.build(mt, enc, dec)
    widths = tuple([node.dudt.layers[0].in_dim]
                   + [lyr.out_dim for lyr in node.dudt.layers])
    if widths != NODE_WIDTHS:
        fail(f"LatentODE field widths {widths}, expected {NODE_WIDTHS}")
    cfg = TrainConfig(decay=1e-4, seed=1, epochs=1500, save_best=False,
                      jit_epoch=False)
    trainer = Trainer(model, cfg, device=dev)
    counters = {"node_field_fwd": node_cuda.solve_neural_field_cuda,
                "node_field_bwd": node_cuda.neural_field_sweep_cuda,
                "node_field_dw": node_cuda.neural_field_dw_cuda}
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
        log("train", f"LatentODE epoch {rec['epoch']}: train loss "
                     f"{rec['train_loss']:.6f} val loss {rec['val_loss']:.6f}"
                     f" kl {rec['kl']:.6f} beta {rec['beta']:.4f} "
                     f"{rec['epoch_s']:.4f} s")
        if not (math.isfinite(rec["train_loss"])
                and math.isfinite(rec["val_loss"])):
            fail(f"LatentODE: non-finite loss in epoch {rec['epoch']}")
    # forward: one per train step (writing the tape) and one per
    # validation pass (writing none); sweep and weight gradients: one each
    # per train step
    expected = {"node_field_fwd": 2 * steps * 2, "node_field_bwd": 2 * steps,
                "node_field_dw": 2 * steps}
    log("train", f"LatentODE fit 2 epochs x {steps} steps in {fit_s:.3f} s; "
                 f"kernel launches {launches} (expected {expected})")
    if launches != expected:
        fail(f"LatentODE main path launched {launches}, expected {expected}")

    plain = copy.deepcopy(model)
    plain.model_type = plain.encoder.model_type = \
        plain.decoder.model_type = LatentODE()
    t_val = torch.arange(100, dtype=torch.float32, device=dev) * cfg.dt
    with torch.no_grad():
        (xk, zk, _), _, _, aux = model(val_set, t_val)
        (xp, zp, _), _, _, _ = plain(val_set, t_val)
    e = max(max_err(xk, xp), max_err(zk, zp))
    log("train", f"trained LatentODE, kernel vs plain path on the val set: "
                 f"x_hat {tuple(xk.shape)} z_hat {tuple(zk.shape)} max abs "
                 f"err {e:.3e} (tol {PATH_TOL:.0e}); all solves ok: "
                 f"{bool(aux['success'].all())}")
    if not (e <= PATH_TOL and bool(torch.isfinite(xk).all())
            and tuple(xk.shape) == (45, 100, 784)
            and tuple(zk.shape) == (45, 100, 16)):
        fail(f"LatentODE kernel path vs plain path: {e}")

    data = train_set[:cfg.batch_size, :cfg.seq_len]
    beta = float(hist[-1]["beta"])
    step_ms, val_ms = step_times(trainer, data, val_set, beta)
    log("train", f"LatentODE step time (median of 5, synchronised): train "
                 f"step {step_ms:.3f} ms, val pass {val_ms:.3f} ms; card "
                 f"{gpu}")
    # the same step and pass with the plain solve and autograd
    step_ms, val_ms = step_times(Trainer(plain, cfg, device=dev), data,
                                 val_set, beta, reps=3)
    log("train", f"LatentODE plain path (median of 3): train step "
                 f"{step_ms:.3f} ms, val pass {val_ms:.3f} ms")
    return launches, trainer, data, beta


# ---------------------------------------------------------------------------
# The weight-gradient kernel's own checks (phase 3) and its timing (phase 5):
# node_field_dw on the tape and Delta of the forward and sweep kernels.

DW_SHAPES = (("train", NODE_WIDTHS, 64, 50), ("val", NODE_WIDTHS, 45, 100),
             ("ragged", NODE_WIDTHS, 37, 21), ("d8", (8, 200, 200, 8), 64, 50),
             ("wide", WIDE_WIDTHS, 256, 50))
DW_POP = 4          # replicas of the replica-axis checks and timing


def dw_inputs(widths, B, T, seed, S=None):
    """(field, tape, Delta) of a tanh field from the forward and sweep
    kernels; with S, S replicas' tapes stacked (one field, S inputs)."""
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5
    m = make_field(widths, "tanh", seed=seed)
    tapes, deltas = [], []
    for i in range(S or 1):
        u0s, saveat, w = node_inputs(widths, B, T, seed=seed + 1 + i)
        with torch.no_grad():
            _, tape = node_cuda.solve_neural_field_cuda(m, Tsit5(), u0s,
                                                        saveat, tape=True)
        _, delta = node_cuda.neural_field_sweep_cuda(m, Tsit5(), saveat,
                                                     tape, w)
        tapes.append(tape)
        deltas.append(delta)
    if S is None:
        return m, tapes[0], deltas[0]
    return m, torch.stack(tapes), torch.stack(deltas)


def dw_bounds(widths, B, T, S=1):
    """((bound ms, what bounds it) on the tensor cores: the bytes over the
    HBM rate against 3 x the operations (3xTF32) over the TF32 rate; the
    float32 SIMT bound of node_work) for S replicas."""
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    tab = Tsit5().tableau
    nbytes, ops = node_work(B, T, widths, 1, tab, n_solution_stages(tab),
                            part="dw")
    t_b = S * nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = 3 * S * ops / TF32_FLOPS_PER_S * 1e3
    tc = (max(t_b, t_tc), "bytes" if t_b >= t_tc else "operations")
    return tc, bound_ms(S * nbytes, S * ops)


def node_dw_checks():
    """Phase 3 for the weight-gradient kernel: against the plain product on
    the same tape and Delta at the train, val, ragged (B not a multiple of
    anything the kernel tiles), 8-wide and wide-field shapes (1e-5 of each
    tensor's size), two calls bit for bit; at the train shape with DW_POP
    replicas in one launch against the plain product with the replica axis
    and bit for bit against DW_POP solo launches. Returns {name: largest
    absolute error}."""
    from latentdiffeq_torch.ops import node_cuda
    worst = {"node_field_dw": 0.0, "node_field_dw[pop4]": 0.0}
    for i, (label, widths, B, T) in enumerate(DW_SHAPES):
        m, tape, delta = dw_inputs(widths, B, T, seed=60 + 3 * i)
        R = B * (T - 1) * 6
        plan = node_cuda.neural_field_dw_plan(widths, R)
        n0 = node_cuda.neural_field_dw_cuda.launches
        got = node_cuda.neural_field_dw_cuda(m, tape, delta)
        one = node_cuda.neural_field_dw_cuda.launches - n0
        again = node_cuda.neural_field_dw_cuda(m, tape, delta)
        ref = node_cuda.neural_field_dw_reference(m, tape, delta)
        pairs = list(zip(got[0] + got[1], ref[0] + ref[1]))
        e = max(rel_err(a, b) for a, b in pairs)
        worst["node_field_dw"] = max(worst["node_field_dw"],
                                     max(max_err(a, b) for a, b in pairs))
        same = all(torch.equal(a, b) for a, b in zip(got[0] + got[1],
                                                     again[0] + again[1]))
        log("grads", f"node_field_dw {label} {widths} B={B} T={T} ({R} "
                     f"records; plan: {plan[0]} blocks, clusters of "
                     f"{plan[1]}, {plan[2]} workspace floats) vs the plain "
                     f"product on the same tape and Delta: max rel err "
                     f"{e:.3e} (tol {NODE_GRAD_TOL:.0e}); launches {one}; "
                     f"two calls bit for bit {same}")
        if not (e <= NODE_GRAD_TOL and same and one == 1):
            fail(f"node_field_dw {label}: {e}, bit for bit {same}, "
                 f"launches {one}")
    m, tape, delta = dw_inputs(NODE_WIDTHS, 64, 50, seed=90, S=DW_POP)
    n0 = node_cuda.neural_field_dw_cuda.launches
    got = node_cuda.neural_field_dw_cuda(m, tape, delta)
    one = node_cuda.neural_field_dw_cuda.launches - n0
    ref = node_cuda.neural_field_dw_reference(m, tape, delta)
    e = max(rel_err(a[i], b[i]) for a, b in zip(got[0] + got[1],
                                                ref[0] + ref[1])
            for i in range(DW_POP))
    worst["node_field_dw[pop4]"] = max(max_err(a, b) for a, b in
                                       zip(got[0] + got[1], ref[0] + ref[1]))
    same = True
    for i in range(DW_POP):
        solo = node_cuda.neural_field_dw_cuda(m, tape[i], delta[i])
        same = same and all(torch.equal(a[i], b) for a, b in
                            zip(got[0] + got[1], solo[0] + solo[1]))
    log("grads", f"node_field_dw with a replica axis, S={DW_POP} at the train "
                 f"shape in {one} launch: vs the plain product with the "
                 f"replica axis max rel err {e:.3e} (tol {NODE_GRAD_TOL:.0e}, "
                 f"each replica's tensors); vs {DW_POP} solo launches bit "
                 f"for bit {same}")
    if not (e <= NODE_GRAD_TOL and same and one == 1):
        fail(f"node_field_dw replica axis: {e}, bit for bit {same}, "
             f"launches {one}")
    return worst


def node_dw_timing():
    """Phase 5 for the weight-gradient kernel at the train, val and wide
    shapes and at the train shape with DW_POP replicas: per call (CUDA
    events) and on the device (torch.profiler) beside torch.mm per layer
    (torch.bmm with replicas) on contiguous copies of the same tape and
    Delta, the plain version, the tensor-core bound and the float32 SIMT
    bound. Returns {name: (ms, plain_ms, bound_ms, bound_by, library_ms)}
    for the kernels line: node_field_dw (train) and node_field_dw[pop4]."""
    from latentdiffeq_torch.ops import node_cuda
    out = {}
    cases = [(label, widths, B, T, None) for label, widths, B, T in
             DW_SHAPES if label in ("train", "val", "wide")]
    cases.append((f"train S={DW_POP}", NODE_WIDTHS, 64, 50, DW_POP))
    for i, (label, widths, B, T, S) in enumerate(cases):
        m, tape, delta = dw_inputs(widths, B, T, seed=120 + 5 * i, S=S)
        hp, rec, dp, drec = node_cuda.tape_layout(widths)
        lead = tuple(tape.shape[:-4])
        H = tape.reshape(*lead, -1, rec)
        D = delta.reshape(*lead, -1, drec)
        ops = []
        for o, a, q, b in zip(hp, widths[:-1], dp, widths[1:]):
            h = torch.cat([H[..., o:o + a], torch.ones_like(H[..., :1])],
                          dim=-1).contiguous()
            ops.append((h.transpose(-1, -2), D[..., q:q + b].contiguous()))
        lib = (lambda: [torch.bmm(a, b) for a, b in ops]) if S else (
            lambda: [torch.mm(a, b) for a, b in ops])
        reps = 20 if label != "wide" else 10
        kernel = lambda: node_cuda.neural_field_dw_cuda(m, tape, delta)
        k_ms = time_ms(kernel, reps=reps)
        d_ms = device_ms(kernel, "node_field_dw_kernel", reps=reps)
        l_ms = time_ms(lib, reps=reps)
        p_ms = plain_ms(lambda: node_cuda.neural_field_dw_reference(
            m, tape, delta))
        (tc, tc_by), (simt, simt_by, _, _) = dw_bounds(widths, B, T, S or 1)
        log("timing", f"node_field_dw {label} {widths} B={B} T={T}: kernel "
                      f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on the "
                      f"device), library ({'torch.bmm' if S else 'torch.mm'}"
                      f" per layer) {l_ms:.4f} ms, plain {fmt_ms(p_ms)}; bound "
                      f"on the tensor cores (3xTF32) {tc:.6f} ms ({tc_by}), "
                      f"float32 SIMT bound {simt:.6f} ms ({simt_by})")
        if label == "train":
            out["node_field_dw"] = (k_ms, p_ms, tc, tc_by, l_ms)
        elif S:
            out["node_field_dw[pop4]"] = (k_ms, p_ms, tc, tc_by, l_ms)
    return out


# ---------------------------------------------------------------------------
# The forward and sweep kernels with a replica axis (phase 5): one launch for
# a population of fields, each replica as its own launch computes it.

NODE_POP_SHAPES = (("train", 64, 50), ("val", 45, 100))
NODE_POP_SIZES = (4, 8)


def node_population(widths, S, B, T, seed):
    """(S relu fields, their weights stacked on a replica axis as one
    _Field, u0s (S, B, dim), saveat, the cotangent (S, B, T, dim))."""
    from latentdiffeq_torch.ops import node_cuda
    ms = [make_field(widths, seed=seed + i) for i in range(S)]
    ins = [node_inputs(widths, B, T, seed=seed + 100 + i) for i in range(S)]
    f = node_cuda.dense_stack(ms[0])
    pop = f._replace(
        Ws=[torch.stack([m.layers[l].W.detach() for m in ms])
            for l in range(len(ms[0].layers))],
        bs=[torch.stack([m.layers[l].b.detach() for m in ms])
            for l in range(len(ms[0].layers))])
    return (ms, pop, torch.stack([i[0] for i in ins]), ins[0][1],
            torch.stack([i[2] for i in ins]))


def node_population_timing(clock):
    """Phase 5 for node_field_fwd and node_field_bwd with a replica axis,
    at S 4 and 8, B 64 T 50 (train) and B 45 T 100 (validation): the
    launch plan; at one and at two rows a block, one launch against S solo
    launches at the same rows a block, bit for bit (ys with and without
    the tape, the tape, du0, Delta), and its time per call (CUDA events);
    the default launch against S solo launches at their own default
    (largest difference logged) and its time on the device. At S 4,
    train (the population's shape): time per call and on the device
    beside S solo launches, the plain version with the replica axis, the
    kernel against it (ys NODE_TOL absolute; du0 and Delta NODE_GRAD_TOL
    of each tensor's size), the bound of S weight sets and S * B rows,
    the latency model. Returns
    ({name: (ms, plain_ms, bound_ms, bound_by, None)}, {name: max abs
    err}) for the [pop4] rows."""
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    solver = Tsit5()
    tab = solver.tableau
    n_st = n_solution_stages(tab)
    fwd, sweep = node_cuda.solve_neural_field_cuda, \
        node_cuda.neural_field_sweep_cuda
    times, errs = {}, {}
    for S in NODE_POP_SIZES:
        for label, B, T in NODE_POP_SHAPES:
            ms, pop, u0s, saveat, w = node_population(NODE_WIDTHS, S, B, T,
                                                      seed=300 + S + T)
            for bwd in (False, True):
                rows, place, reg, threads, nbytes = node_cuda.kernel_plan(
                    NODE_WIDTHS, n_st, B, backward=bwd, replicas=S)
                log("timing", f"node_field {label} S={S} B={B} "
                              f"{'sweep' if bwd else 'forward'} plan: "
                              f"{rows} row(s) a block, {S} x "
                              f"{-(-B // rows)} blocks of {threads} threads, "
                              f"weights in {place} (register layer {reg}), "
                              f"{nbytes} B of shared memory")

            def runs(rows, solo):
                """(ys, tape, ys without the tape, du0, delta): one launch
                with the replica axis, or S solo launches stacked."""
                with torch.no_grad():
                    if not solo:
                        ys, tape = fwd(pop, solver, u0s, saveat, tape=True,
                                       rows_per_block=rows)
                        ys0 = fwd(pop, solver, u0s, saveat,
                                  rows_per_block=rows)
                        return (ys, tape, ys0) + sweep(
                            pop, solver, saveat, tape, w,
                            rows_per_block=rows)
                    outs = []
                    for i, m in enumerate(ms):
                        ys, tape = fwd(m, solver, u0s[i], saveat, tape=True,
                                       rows_per_block=rows)
                        ys0 = fwd(m, solver, u0s[i], saveat,
                                  rows_per_block=rows)
                        outs.append((ys, tape, ys0) + sweep(
                            m, solver, saveat, tape, w[i],
                            rows_per_block=rows))
                    return [torch.stack(t) for t in zip(*outs)]

            for rows in (1, 2):
                got, want = runs(rows, False), runs(rows, True)
                same = [torch.equal(a, b) for a, b in zip(got, want)]
                tape = got[1]
                k_f = time_ms(lambda: fwd(pop, solver, u0s, saveat,
                                          rows_per_block=rows))
                k_b = time_ms(lambda: sweep(pop, solver, saveat, tape, w,
                                            rows_per_block=rows))
                log("timing", f"node_field {label} S={S} B={B} T={T}, "
                              f"{rows} row(s) a block ({S} x {-(-B // rows)} "
                              f"blocks): forward {k_f:.4f} ms, sweep "
                              f"{k_b:.4f} ms per call; against {S} solo "
                              f"launches at {rows} row(s) a block bit for "
                              f"bit (ys, tape, ys without tape, du0, Delta) "
                              f"{same}")
                if not all(same):
                    fail(f"node_field replica axis {label} S={S} rows "
                         f"{rows}: not bit for bit with solo launches "
                         f"{same}")
            got, want = runs(0, False), runs(0, True)
            diff = max(max_err(a, b) for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            r_pop, r_solo = (node_cuda.kernel_plan(
                NODE_WIDTHS, n_st, B, backward=False, replicas=n)[0]
                for n in (S, 1))
            tape = got[1]
            d_f = device_ms(lambda: fwd(pop, solver, u0s, saveat),
                            "node_field_fwd_kernel")
            d_b = device_ms(lambda: sweep(pop, solver, saveat, tape, w),
                            "node_field_bwd_kernel")
            log("timing", f"node_field {label} S={S}: default launch "
                          f"({r_pop} row(s) a block; forward "
                          f"{fmt_ms(d_f)}, sweep {fmt_ms(d_b)} on the "
                          f"device) against {S} solo launches at theirs "
                          f"({r_solo}): bit for bit {same}, largest "
                          f"difference {diff:.3e}")
            if S != 4 or label != "train":
                continue
            ys, tape, _, du0, delta = got
            with torch.no_grad():
                ys_p = node_cuda.solve_neural_field_reference(
                    pop, solver, u0s, saveat)[0]
            du0_p, delta_p = node_cuda.neural_field_sweep_reference(
                pop, solver, saveat, tape, w)
            dp = node_cuda.tape_layout(NODE_WIDTHS)[2]
            pieces = [(du0[i], du0_p[i]) for i in range(S)] + [
                (delta[i, ..., o:o + n], delta_p[i, ..., o:o + n])
                for i in range(S) for o, n in zip(dp, NODE_WIDTHS[1:])]
            e_f = max_err(ys, ys_p)
            e_b = max(rel_err(a, b) for a, b in pieces)
            errs["node_field_fwd[pop4]"] = e_f
            errs["node_field_bwd[pop4]"] = max(max_err(a, b)
                                               for a, b in pieces)
            log("grads", f"node_field {label} S={S} B={B} T={T} in one "
                         f"launch vs the plain versions with the replica "
                         f"axis: ys max abs err {e_f:.3e} (tol "
                         f"{NODE_TOL:.0e}), sweep max rel err {e_b:.3e} "
                         f"(tol {NODE_GRAD_TOL:.0e}, each replica's du0 and "
                         f"Delta pieces)")
            if not (e_f <= NODE_TOL and e_b <= NODE_GRAD_TOL):
                fail(f"node_field replica axis vs plain: {e_f}, {e_b}")
            calls = {
                "node_field_fwd[pop4]": (
                    lambda: fwd(pop, solver, u0s, saveat),
                    lambda: [fwd(m, solver, u0s[i], saveat)
                             for i, m in enumerate(ms)],
                    lambda: node_cuda.solve_neural_field_reference(
                        pop, solver, u0s, saveat),
                    "node_field_fwd_kernel", "fwd"),
                "node_field_bwd[pop4]": (
                    lambda: sweep(pop, solver, saveat, tape, w),
                    lambda: [sweep(m, solver, saveat, tape[i], w[i])
                             for i, m in enumerate(ms)],
                    lambda: node_cuda.neural_field_sweep_reference(
                        pop, solver, saveat, tape, w),
                    "node_field_bwd_kernel", "sweep"),
            }
            for name, (kernel, solo, plain, kname, part) in calls.items():
                with torch.no_grad():
                    k_ms = time_ms(kernel)
                    d_ms = device_ms(kernel, kname)
                    s_ms = time_ms(solo)
                    p_ms = plain_ms(plain)
                nb, ops = node_work(B, T, NODE_WIDTHS, 1, tab, n_st,
                                    part=part)
                bd, by, t_b, t_o = bound_ms(S * nb, S * ops)
                lat = node_latency_ms(T, 1, n_st, NODE_WIDTHS, clock)
                log("timing", f"{name} S={S} B={B} T={T}: kernel "
                              f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on "
                              f"the device), {S} solo launches {s_ms:.4f} "
                              f"ms, plain (replica by replica) {p_ms:.4f} "
                              f"ms, bound {bd:.6f} ms ({by}; bytes "
                              f"{t_b:.6f} ms, operations {t_o:.6f} ms), "
                              f"latency model {lat:.6f} ms at {clock:.0f} "
                              f"MHz; library: none, no one PyTorch call "
                              f"runs {S} fields")
                times[name] = (k_ms, p_ms, bd, by, None)
    return times, errs


# ---------------------------------------------------------------------------
# Phase 4i: a LatentODE population (train_latent_ode.py --pallas-solve
# --seeds 4): the forward, sweep and weight-gradient kernels each once for
# all replicas.

NODE_POP_SEEDS = (1, 2, 3, 4)
NODE_PLAIN = ("solve_neural_field_reference",
              "solve_neural_field_taped_reference",
              "neural_field_sweep_reference", "neural_field_dw_reference")


class plain_node_calls:
    """Counts the calls of the neural-field kernels' plain versions while
    it is entered (the kernel route must make none on CUDA tensors)."""

    def __enter__(self):
        from latentdiffeq_torch.ops import node_cuda
        self.n, self.saved = 0, {}
        for name in NODE_PLAIN:
            fn = getattr(node_cuda, name)
            self.saved[name] = fn

            def counted(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(node_cuda, name, counted)
        return self

    def __exit__(self, *exc):
        from latentdiffeq_torch.ops import node_cuda
        for name, fn in self.saved.items():
            setattr(node_cuda, name, fn)


def latent_ode_population_path(train_set, val_set, dev, gpu):
    """Phase 4i: a MultiSeedTrainer of full-width LatentODE with the kernel
    solve (the defaults of examples/pendulum/train_latent_ode.py with
    --pallas-solve --seeds 4: NODE(16), TrainConfig(decay=1e-4), seeds 1-4),
    2 epochs on the pendulum video: finite losses; each step launches
    node_field_fwd twice (the train step with its tape and the validation
    pass), node_field_bwd and node_field_dw once, each for all S replicas,
    and no plain version runs; replica 1 (seed 2) against a solo Trainer
    of seed 2 (rtol 2e-4); the population's step and validation times and
    device ops beside the solo step's. Returns the launches."""
    import numpy as np

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (LatentDiffEqModel, LatentODE,
                                           NODE, default_layers)
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig,
                                          Trainer)

    def init(seed):
        g = torch.Generator().manual_seed(seed)
        mt = LatentODE(use_kernel_solve=True)
        node = NODE(16, options=SolveOptions(adaptive=False, substeps=1),
                    generator=g, device=dev)
        return LatentDiffEqModel.build(mt, *default_layers(
            mt, 784, node, generator=g, device=dev))

    S = len(NODE_POP_SEEDS)
    cfg = TrainConfig(decay=1e-4, seed=1, epochs=1500, save_best=False,
                      jit_epoch=False)
    steps = 2 * (train_set.shape[0] // cfg.batch_size)
    counters = {"node_field_fwd": node_cuda.solve_neural_field_cuda,
                "node_field_bwd": node_cuda.neural_field_sweep_cuda,
                "node_field_dw": node_cuda.neural_field_dw_cuda}

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    ms = MultiSeedTrainer(init, cfg, NODE_POP_SEEDS, device=dev)
    reset_counts()
    with plain_node_calls() as plain:
        t0 = time.perf_counter()
        hist = ms.fit(train_set, val_set, epochs=2, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = counts()
    want = {"node_field_fwd": 2 * steps, "node_field_bwd": steps,
            "node_field_dw": steps}
    for rec in hist:
        log("train", f"LatentODE population epoch {rec['epoch']}: train "
                     f"loss per seed "
                     f"{[round(float(v), 6) for v in rec['train_loss']]}, "
                     f"val loss {[round(float(v), 6) for v in rec['val_loss']]}"
                     f" {rec['epoch_s']:.4f} s")
        if not (np.isfinite(rec["train_loss"]).all()
                and np.isfinite(rec["val_loss"]).all()):
            fail(f"LatentODE population: non-finite loss in epoch "
                 f"{rec['epoch']}")
    i = NODE_POP_SEEDS.index(2)
    solo = Trainer(init(2), TrainConfig(decay=1e-4, seed=2, epochs=1500,
                                        save_best=False, jit_epoch=False),
                   device=dev)
    reset_counts()
    t1 = time.perf_counter()
    shist = solo.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t1
    solo_launches = counts()
    pop_v = np.array([float(r["val_loss"][i]) for r in hist])
    solo_v = np.array([r["val_loss"] for r in shist])
    rel = float(np.abs(pop_v - solo_v).max() / np.abs(solo_v).max())
    log("train", f"LatentODE population fit 2 epochs x {steps // 2} steps of "
                 f"{S} seeds {list(NODE_POP_SEEDS)} in {fit_s:.3f} s, solo "
                 f"Trainer of seed 2 in {solo_s:.3f} s; launches population "
                 f"{launches} (expected {want}: node_field_fwd 2, "
                 f"node_field_bwd 1 and node_field_dw 1 a step for all {S} "
                 f"seeds), plain calls "
                 f"{plain.n}; solo {solo_launches}; replica {i} (seed 2) val "
                 f"losses {pop_v.tolist()} vs solo {solo_v.tolist()}: max rel "
                 f"err {rel:.3e} (tol {POP_RTOL:.1e})")
    if launches != want or plain.n != 0:
        fail(f"LatentODE population launches {launches}, expected {want}; "
             f"plain calls {plain.n}")
    if not rel <= POP_RTOL:
        fail(f"LatentODE population replica {i} vs solo Trainer: {rel}")
    beta = float(hist[-1]["beta"])
    xs = train_set[:cfg.batch_size, :cfg.seq_len]
    step_report(f"LatentODE population ({S} seeds)", ms,
                xs.unsqueeze(0).expand(S, -1, -1, -1).contiguous(), val_set,
                beta, gpu)
    step_report("LatentODE population solo seed 2", solo, xs, val_set, beta,
                gpu)
    return launches


def node_timing(clock):
    """Phase 5 for the neural-field solve's kernels: {name: (ms, plain_ms,
    bound_ms, bound_by, None)} at the training shape for node_field_fwd
    (the variant without a tape) and node_field_bwd (the sweep); the
    tape-writing forward, the validation shape, the wide field, the launch
    plan and 1 against 2 rows a block are logged (node_field_dw:
    node_dw_timing)."""
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    from latentdiffeq_torch.utils import device_profile
    solver = Tsit5()
    tab = solver.tableau
    n_st = n_solution_stages(tab)
    out = {}
    for label, widths, B, T in (("train", NODE_WIDTHS, 64, 50),
                                ("val", NODE_WIDTHS, 45, 100),
                                ("wide", WIDE_WIDTHS, 256, 50)):
        m = make_field(widths, seed=40)
        u0s, saveat, w = node_inputs(widths, B, T, seed=41)
        reps = 20 if label != "wide" else 5
        for bwd in (False, True):
            rows, place, reg, threads, nbytes = node_cuda.kernel_plan(
                widths, n_st, B, backward=bwd)
            log("timing", f"node_field {label} {widths} B={B} "
                          f"{'sweep' if bwd else 'forward'} plan: {rows} "
                          f"row(s) a block, {-(-B // rows)} blocks of "
                          f"{threads} threads, weights in {place} (register "
                          f"layer {reg}), {nbytes} B of shared memory")
        with torch.no_grad():
            ys, tape = node_cuda.solve_neural_field_cuda(m, solver, u0s,
                                                         saveat, tape=True)
            _, delta = node_cuda.neural_field_sweep_cuda(m, solver, saveat,
                                                         tape, w)
            calls = {
                "node_field_fwd": (
                    lambda: node_cuda.solve_neural_field_cuda(
                        m, solver, u0s, saveat),
                    lambda: node_cuda.solve_neural_field_reference(
                        m, solver, u0s, saveat),
                    "node_field_fwd_kernel", "fwd"),
                "node_field_fwd (writing the tape)": (
                    lambda: node_cuda.solve_neural_field_cuda(
                        m, solver, u0s, saveat, tape=True),
                    lambda: node_cuda.solve_neural_field_taped_reference(
                        m, solver, u0s, saveat),
                    "node_field_fwd_kernel", None),
                "node_field_bwd": (
                    lambda: node_cuda.neural_field_sweep_cuda(
                        m, solver, saveat, tape, w),
                    lambda: node_cuda.neural_field_sweep_reference(
                        m, solver, saveat, tape, w),
                    "node_field_bwd_kernel", "sweep"),
            }
            for name, (kernel, plain, kname, part) in calls.items():
                k_ms = time_ms(kernel, reps=reps)
                d_ms = device_ms(kernel, kname, reps=reps)
                p_ms = plain_ms(plain)
                line = (f"{name} {label} {widths} B={B} T={T}: kernel "
                        f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on the "
                        f"device), plain {fmt_ms(p_ms)}")
                if part is not None:
                    bd, by, t_b, t_o = bound_ms(*node_work(
                        B, T, widths, 1, tab, n_st, part=part))
                    lat = node_latency_ms(T, 1, n_st, widths, clock)
                    line += (f", bound {bd:.6f} ms ({by}; bytes "
                             f"{t_b:.6f} ms, operations {t_o:.6f} ms), "
                             f"latency model {lat:.6f} ms at {clock:.0f} "
                             f"MHz")
                    if label == "train":
                        out[name] = (k_ms, p_ms, bd, by, None)
                log("timing", line)
        # plain backward: autograd through the plain solve's graph
        u = u0s.clone().requires_grad_()
        ys_p = node_cuda.solve_neural_field_reference(m, solver, u,
                                                      saveat)[0]
        targets = [u] + list(m.parameters())
        b_plain = time_ms(lambda: torch.autograd.grad(
            ys_p, targets, w, retain_graph=True), reps=2, warmup=1)
        del ys_p
        log("timing", f"node_field {label}: plain autograd backward "
                      f"{b_plain:.4f} ms")
        if label == "train":
            # the layout: the default of one row a block against two
            with torch.no_grad():
                for rows in (1, 2):
                    rf = time_ms(lambda: node_cuda.solve_neural_field_cuda(
                        m, solver, u0s, saveat, rows_per_block=rows))
                    rb = time_ms(lambda: node_cuda.neural_field_sweep_cuda(
                        m, solver, saveat, tape, w, rows_per_block=rows))
                    log("timing", f"node_field train, {rows} row(s) a "
                                  f"block ({-(-B // rows)} blocks): forward "
                                  f"{rf:.4f} ms, sweep {rb:.4f} ms per call")
            # the kernel route calls no library matrix product (rounds
            # under the profiler until it has recorded each kernel, at
            # most 3 windows of 2 rounds; each window armed by
            # device_profile, as a plain window opened late in this
            # process loses the records of its first launches, 4k (d))
            u = u0s.clone().requires_grad_()
            ops, devk = set(), set()
            for window in range(3):
                with device_profile() as prof:
                    for _ in range(2):
                        ys_k = node_cuda.solve_neural_field(m, solver, u,
                                                            saveat)[0]
                        torch.autograd.grad(ys_k,
                                            [u] + list(m.parameters()), w)
                    torch.cuda.synchronize()
                ops |= {e.name for e in prof.events()
                        if e.device_type.name == "CPU"
                        and e.name.startswith("aten::")}
                devk |= {e.name[:60] for e in prof.events()
                         if e.device_type.name == "CUDA"}
                if all(any(n in k for k in devk) for n in (
                        "node_field_fwd_kernel", "node_field_bwd_kernel",
                        "node_field_dw_kernel")):
                    break
            ops, devk = sorted(ops), sorted(devk)
            log("timing", f"solve_neural_field forward + backward, kernel "
                          f"route ({window + 1} profiler windows): aten ops "
                          f"{ops}")
            log("timing", f"  device kernels {devk}")
            banned = [o for o in ops if any(
                k in o for k in ("mm", "matmul", "linear", "bmm", "einsum"))]
            if banned or not all(any(n in k for k in devk) for n in (
                    "node_field_fwd_kernel", "node_field_bwd_kernel",
                    "node_field_dw_kernel")):
                fail(f"kernel route ran {banned}; device kernels {devk}")
    return out


def cudnn_heads(heads, dev):
    """The three GOKU heads as torch.nn.RNN (relu) and two torch.nn.LSTM
    modules on the same weights, in the heads' dtype: W_ih = Wi^T, W_hh =
    Wh^T, Flux's one bias as b_ih with b_hh = 0, gates i, f, g, o in both.
    Returns ``run(xs, xs_reversed)``, the three cuDNN calls, giving (z0,
    theta)."""
    rnn_h, lstm_f, lstm_b = heads
    D = rnn_h.cells[0].Wi.shape[0]
    H = rnn_h.cells[0].hidden_dim
    L = len(rnn_h.cells)
    mods = (torch.nn.RNN(D, H, num_layers=L, nonlinearity="relu",
                         batch_first=True),
            torch.nn.LSTM(D, H, num_layers=L, batch_first=True),
            torch.nn.LSTM(D, H, num_layers=L, batch_first=True))
    mods = [mod.to(dev, rnn_h.cells[0].Wi.dtype) for mod in mods]
    with torch.no_grad():
        for mod, head in zip(mods, heads):
            for k, cell in enumerate(head.cells):
                getattr(mod, f"weight_ih_l{k}").copy_(cell.Wi.t())
                getattr(mod, f"weight_hh_l{k}").copy_(cell.Wh.t())
                getattr(mod, f"bias_ih_l{k}").copy_(cell.b)
                getattr(mod, f"bias_hh_l{k}").zero_()
            mod.flatten_parameters()

    def state(head, name, B):
        return torch.stack([getattr(c, name).detach().expand(B, H)
                            for c in head.cells]).contiguous()

    def run(xs, xr):
        B = xs.shape[0]
        _, hz = mods[0](xr, state(rnn_h, "h0", B))
        _, (hf, _) = mods[1](xs, (state(lstm_f, "h0", B),
                                  state(lstm_f, "c0", B)))
        _, (hb, _) = mods[2](xr, (state(lstm_b, "h0", B),
                                  state(lstm_b, "c0", B)))
        return hz[-1], torch.cat([hf[-1], hb[-1]], dim=-1)

    return mods, state, run


# Heads wider than goku_heads' compiled widths (32, 16): they run at their
# own widths in the kernels that read the widths at run time.
WIDE_HEADS = (64, 32, 2)


def wide_heads(act="relu", seed=5):
    """GOKU-shaped heads at WIDE_HEADS, every tensor from N(0, 0.15^2)."""
    from latentdiffeq_torch import nn as tnn
    D, H, L = WIDE_HEADS
    g = torch.Generator().manual_seed(seed)
    heads = (tnn.Recurrent.rnn(D, (H,) * L, getattr(tnn, act)),
             tnn.Recurrent.lstm(D, (H,) * L), tnn.Recurrent.lstm(D, (H,) * L))
    with torch.no_grad():
        for p in (p for h in heads for p in h.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    return tuple(h.to("cuda") for h in heads)


def goku_kernel_checks(heads, gen) -> float:
    """Phase 2 for goku_heads: the forward kernel and its tape-writing
    variant against the plain versions (the same outputs, and the tape
    against the plain tape) at the train, validation and two ragged
    shapes, and wide heads at the train shape. Returns the largest
    absolute error of the outputs."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    worst = 0.0
    with torch.no_grad():
        for label, hs, (B, T) in (
                ("train", heads, (64, 50)), ("val", heads, (45, 100)),
                ("ragged", heads, (100, 50)),
                ("ragged-short", heads, (37, 21)),
                (f"wide {WIDE_HEADS}", wide_heads(), (64, 50))):
            D = hs[0].cells[0].Wi.shape[0]
            xs = torch.randn(B, T, D, generator=gen, device="cuda")
            z, th = rc.goku_heads_cuda(*hs, xs)
            zt, tht, tape = rc.goku_heads_cuda(*hs, xs, tape=True)
            zp, thp, tape_p = rc.goku_heads_taped_reference(*hs, xs)
            e = max(max_err(z, zp), max_err(th, thp))
            e_tape = rel_err(tape, tape_p)
            same = torch.equal(z, zt) and torch.equal(th, tht)
            worst = max(worst, e)
            log("kernels", f"goku_heads {label} B={B} T={T}: max abs err "
                           f"{e:.3e} (tol {TOL:.0e}); tape-writing variant: "
                           f"same outputs {same}, tape vs plain tape max rel "
                           f"err {e_tape:.3e} (tol {TOL:.0e})")
            if not (e <= TOL and same and e_tape <= TOL):
                fail(f"goku_heads {label}: {e}, tape {e_tape}, same {same}")
    return worst


def heads_relu_flips(tape, tape_p, L, H):
    """(flipped, all): z0 RNN units on (h > 0) in the kernel's tape and off
    in the plain tape, or the other way round."""
    a, b = tape[..., :L * H] > 0, tape_p[..., :L * H] > 0
    return int((a != b).sum()), a.numel()


def goku_grad_checks(heads, gen):
    """Phase 3 for goku_heads: the sweep kernel against the plain sweep on
    the same tape, then the whole backward against plain autograd, for the
    main path's relu heads and the same heads with a tanh RNN at the train
    and validation shapes, and for wide heads (relu and tanh) at the train
    shape. Returns the largest absolute error of the sweep."""
    from latentdiffeq_torch import nn as tnn
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    tanh_heads = copy.deepcopy(heads)
    for cell in tanh_heads[0].cells:
        cell.activation = tnn.tanh
    both = (("train", (64, 50)), ("val", (45, 100)))
    worst = 0.0
    for act, hs, shapes in (
            ("relu", heads, both), ("tanh", tanh_heads, both),
            (f"wide {WIDE_HEADS} relu", wide_heads("relu"), both[:1]),
            (f"wide {WIDE_HEADS} tanh", wide_heads("tanh"), both[:1])):
        params = rc._heads_params(*hs)
        L, H = len(hs[0].cells), hs[0].cells[0].hidden_dim
        D = hs[0].cells[0].Wi.shape[0]
        for label, (B, T) in shapes:
            xs = torch.randn(B, T, D, generator=gen, device="cuda")
            gz = torch.randn(B, H, generator=gen, device="cuda")
            gt = torch.randn(B, 2 * H, generator=gen, device="cuda")
            with torch.no_grad():
                _, _, tape = rc.goku_heads_cuda(*hs, xs, tape=True)
                tape_p = rc.goku_heads_taped_reference(*hs, xs)[2]
            got = rc.goku_heads_bwd_cuda(*hs, tape, gz, gt)
            ref = rc.goku_heads_sweep_reference(*hs, tape, gz, gt)
            e_sw = max(rel_err(a, b) for a, b in zip(got, ref))
            worst = max(worst, max(max_err(a, b) for a, b in zip(got, ref)))

            def grads(fn):
                x = xs.clone().requires_grad_()
                z, th = fn(*hs, x)
                return torch.autograd.grad((z, th), [x] + params, (gz, gt))

            k = grads(rc.goku_heads)
            p = grads(rc.goku_heads_reference)
            e_kp = max(rel_err(a, b) for a, b in zip(k, p))
            flips, units = heads_relu_flips(tape, tape_p, L, H)
            tol = (GRAD_TOL if act.endswith("tanh") or flips == 0
                   else RELU_GRAD_TOL)
            log("grads", f"goku_heads {act} RNN {label} B={B} T={T}: "
                         f"goku_heads_bwd vs plain sweep on the same tape max "
                         f"rel err {e_sw:.3e} (tol {GRAD_TOL:.0e}); whole "
                         f"backward vs plain autograd {e_kp:.3e} (tol "
                         f"{tol:.0e}); relu units on in the kernel's tape and "
                         f"off in the plain tape or back: {flips} of {units}")
            if not (e_sw <= GRAD_TOL and e_kp <= tol
                    and all(bool(torch.isfinite(t).all()) for t in k)):
                fail(f"goku_heads grads {act} {label}: sweep {e_sw}, whole "
                     f"{e_kp} > {tol}")
    return worst


# Angles past the RK kernels' branch-free sine bound (|x| > 105615), from
# 2e5, where the fast sine is still close, to 1e9, where it is meaningless.
BIG_ANGLES = (2e5, -3e6, 4.5e7, 1e9, -2.5e8)
# The branch-free sine and cosine against float64 over the bound: 4 units in
# the last place of values in [0.5, 1), as CUDA's sincosf.
TRIG_TOL = 2.4e-7


def rk_trig_check():
    """The RK kernels' branch-free sine and cosine, and sincosf, against
    float64 over |x| <= 105615: a uniform grid of 2^24 points, a dense grid
    on [-8, 8] and the floats nearest each multiple of pi/2 and their
    neighbours (the reduction's hardest arguments); and the Kuramoto
    kernels' branch-free copies of sinf's and sincosf's fast paths against
    torch.sin (the plain version's sine) and sincosf, bit for bit, on the
    same points below 105615 and on zeros, subnormals and NaN. Returns the
    largest error of the branch-free pair."""
    from latentdiffeq_torch.ops import ode_cuda
    k = torch.arange(-67237, 67238, dtype=torch.float64, device="cuda")
    near = (k * (math.pi / 2)).float()
    steps = torch.arange(-3, 4, device="cuda", dtype=torch.int32)
    near = (near.view(torch.int32)[:, None] + steps).view(torch.float32)
    x = torch.cat([torch.linspace(-105615.0, 105615.0, 1 << 24,
                                  device="cuda"),
                   torch.linspace(-8.0, 8.0, 1 << 22, device="cuda"),
                   near.flatten()])
    x = x[x.abs() <= 105615.0]
    s64, c64 = torch.sin(x.double()), torch.cos(x.double())
    errs = []
    for accurate in (False, True):
        s, c = ode_cuda.sincos_cuda(x, accurate=accurate)
        errs.append((max_err(s.double(), s64), max_err(c.double(), c64)))
    log("kernels", f"rk_fixed_grid sine and cosine vs float64 over "
                   f"{x.numel()} points of |x| <= 105615: branch-free "
                   f"{errs[0][0]:.3e} / {errs[0][1]:.3e}, sincosf "
                   f"{errs[1][0]:.3e} / {errs[1][1]:.3e} (tol {TRIG_TOL:.1e})")
    if not max(max(e) for e in errs) <= TRIG_TOL:
        fail(f"rk_fixed_grid trig: {errs} > {TRIG_TOL}")
    x = torch.cat([x[x.abs() < 105615.0], torch.tensor(
        [0.0, -0.0, 1e-30, -1e-30, 1e-45, math.nan], device="cuda")])
    s_acc, c_acc = ode_cuda.sincos_cuda(x, accurate=True)

    def differ(a, b):  # bit patterns: a NaN equals a NaN of the same bits
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    s_cp, c_cp = ode_cuda.sincos_cuda(x, copy="sinf")
    s_sc, c_sc = ode_cuda.sincos_cuda(x, copy="sincosf")
    bad = {"sinf copy vs torch.sin": differ(s_cp, torch.sin(x)),
           "sincosf copy vs sincosf": differ(s_sc, s_acc)
           + differ(c_sc, c_acc) + differ(c_cp, c_acc)}
    log("kernels", f"rk_kuramoto sine copies over {x.numel()} points of "
                   f"|x| < 105615, values that differ in a bit: {bad} "
                   f"(must be 0)")
    if any(bad.values()):
        fail(f"rk_kuramoto sine copies differ from the library's: {bad}")
    return max(errs[0])


# The RK kernels' instances on the GOKU paths beside the pendulum's: Van der
# Pol (mu_max 4) and Kuramoto-10 at their paths' train and validation
# shapes, 4 sub-steps (kuramoto10-spread: with frequency offsets, the same
# instance).
CUSTOM = ("vdp", "kuramoto10")
CUSTOM_SHAPES = (("train", 64, 50), ("val", 26, 100))
CUSTOM_SUBSTEPS = 4
CUSTOM_DT = 0.1


def rk_rhs(which):
    """(f, state width, parameter width, functor family) of an RK case."""
    from latentdiffeq_torch import custom_dynamics as cdyn
    from latentdiffeq_torch.pendulum import pendulum_f, pendulum_friction_f
    if which == "pendulum":
        return pendulum_f, 2, 1, "pendulum"
    if which == "friction":
        return pendulum_friction_f, 2, 1, "pendulum"
    if which == "vdp":
        return cdyn.vdp_f, 2, 1, "vdp"
    spread = 0.5 if which.endswith("spread") else 0.0
    return cdyn.Kuramoto(10, omega_spread=spread).f, 10, 2, "kuramoto"


def rk_name(kernel, f, dim, pdim=None):
    """The kernels line's name of an RK kernel for ``f``: the pendulum's
    instances under the kernel's own name, the others with their
    instance, as rk_fixed_grid[vdp] or rk_fixed_grid[gen_<hash8>]."""
    from latentdiffeq_torch.ops import ode_cuda
    inst = ode_cuda.rhs_instance(f, dim, pdim)
    return kernel if inst.startswith("pendulum") else f"{kernel}[{inst}]"


def rk_kernel(family, bwd=False):
    """The profiler's name of the CUDA kernel that runs a functor family in
    csrc/rk_fixed_grid.cu: Kuramoto's lane-group pair, or the others'."""
    name = "rk_kuramoto" if family == "kuramoto" else "rk_fixed_grid"
    return f"{name}_bwd_kernel" if bwd else f"{name}_kernel"


def rk_inputs(which, B, T, gen, dev="cuda"):
    """(u0s, ps, saveat) of an RK case: the pendulum's angle and velocity
    ~ U(-1, 1), its parameter ~ U(1, 2), dt 0.05; the examples' draws for
    the others, dt 0.1: VdP u0 ~ U(-2, 2), mu ~ U(0.5, 4) (mu_max 4);
    Kuramoto phases ~ U(-pi, pi), omega ~ U(1, 3), K ~ U(0.2, 2)."""
    _, n, _, family = rk_rhs(which)
    if family == "pendulum":
        u0s = torch.rand(B, 2, generator=gen, device=dev) * 2 - 1
        ps = 1 + torch.rand(B, 1, generator=gen, device=dev)
        dt = 0.05
    elif family == "vdp":
        u0s = torch.rand(B, 2, generator=gen, device=dev) * 4 - 2
        ps = 0.5 + 3.5 * torch.rand(B, 1, generator=gen, device=dev)
        dt = CUSTOM_DT
    else:
        u0s = (torch.rand(B, n, generator=gen, device=dev) * 2 - 1) * math.pi
        ps = torch.stack([1 + 2 * torch.rand(B, generator=gen, device=dev),
                          0.2 + 1.8 * torch.rand(B, generator=gen,
                                                 device=dev)], dim=1)
        dt = CUSTOM_DT
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * dt
    return u0s, ps, saveat


def rk_custom_cases():
    """(label, which, B, T, solver, substeps) of the Van der Pol and
    Kuramoto-10 instances: Tsit5 at both shapes."""
    from latentdiffeq_torch.solve.rk import Tsit5
    return [(label, which, B, T, Tsit5(), CUSTOM_SUBSTEPS)
            for which in CUSTOM + ("kuramoto10-spread",)
            for label, B, T in CUSTOM_SHAPES]


def rk_kernel_checks(gen):
    """Phase 2 for rk_fixed_grid: the forward kernel against the plain
    version, for the pendulum at the train, validation and ragged shapes,
    with RK4, Dopri5 and sub-steps and the damped RHS, and for Van der Pol
    and Kuramoto-10 (also with frequency offsets) at their paths' shapes;
    its success flags against the plain flags and isfinite(ys) (also on
    rows that fail; all rows ok for the new functors); the baked tableau
    instances (Tsit5, RK4) against the instance that reads the same tableau
    at run time, bit for bit; rows past the fast sine's bound, which rerun
    their steps with sinf; a grid of 1100 points, held against float64 (its
    float32 trajectories part by more than rounding: the phase drifts); the
    float64-distance gate also for the new functors; and the sine itself.
    Returns {kernel name: largest absolute error against the plain
    version}."""
    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import RK4, Dopri5, Tsit5
    worst = {}
    with torch.no_grad():
        cases = [("train", "pendulum", 64, 50, Tsit5(), 1),
                 ("val", "pendulum", 45, 100, Tsit5(), 1),
                 ("ragged", "pendulum", 100, 50, Tsit5(), 1),
                 ("rk4-substeps3", "pendulum", 64, 50, RK4(), 3),
                 ("dopri5-substeps3", "pendulum", 64, 50, Dopri5(), 3),
                 ("friction", "friction", 64, 50, Tsit5(), 1),
                 ("non-finite rows", "pendulum", 64, 50, Tsit5(), 1),
                 ("large angles", "pendulum", 64, 50, Tsit5(), 1),
                 ("long", "pendulum", 16, 1100, Tsit5(), 1)]
        for label, which, B, T, solver, sub in cases + rk_custom_cases():
            f, n, _, family = rk_rhs(which)
            name = rk_name("rk_fixed_grid", f, n)
            u0s, ps, saveat = rk_inputs(which, B, T, gen)
            big = torch.zeros(B, dtype=torch.bool, device="cuda")
            if label == "non-finite rows":
                u0s[1, 0], ps[3, 0], u0s[5, 1] = math.nan, 0.0, math.inf
            if label == "large angles":
                big[::13] = True
                u0s[big, 0] = torch.tensor(BIG_ANGLES, device="cuda")
            got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
                f, solver, u0s, ps, saveat, substeps=sub)
            ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
                f, solver, u0s, ps, saveat, substeps=sub)
            flags = (torch.equal(ok, ok_p) and torch.equal(
                ok, torch.isfinite(got).all(dim=2).all(dim=1)))
            if family != "pendulum":
                flags = flags and bool(ok.all())
            fine = ok & ok_p & ~big
            e = max_err(got[fine], ref[fine])
            tol = ("held against float64" if label == "long"
                   else f"tol {TOL:.0e}")
            tag = label if family == "pendulum" else f"{which} {label}"
            line = (f"{name} {tag} B={B} T={T} "
                    f"{type(solver).__name__} substeps={sub}: max abs err "
                    f"{e:.3e} ({tol}); success flags as plain and "
                    f"isfinite: {flags} ({int(ok.sum())} of {B} rows)")
            good = flags and (e <= TOL or label == "long")
            if label == "long" or family != "pendulum":
                # the kernel at most twice as far from float64 as the plain
                # float32 solve, as the neural-field forward is held
                ref64 = ode_cuda.solve_fixed_grid_batched_reference(
                    f, solver, u0s.double(), ps.double(), saveat.double(),
                    substeps=sub)[0]
                e_k = max_err(got.double(), ref64)
                e_p = max_err(ref.double(), ref64)
                line += (f"; vs float64: kernel {e_k:.3e}, plain {e_p:.3e} "
                         f"(gate 2 x plain + 1e-6)")
                good = good and e_k <= 2 * e_p + 1e-6
            if family == "kuramoto":  # the lane-group kernel: bit for bit
                bits = torch.equal(got.view(torch.int32),
                                   ref.view(torch.int32))
                line += f"; bit for bit as plain: {bits}"
                good = good and bits
            if label != "long":
                worst[name] = max(worst.get(name, 0.0), e)
            if label == "large angles":
                e_big = max(rel_err(got[big][..., d], ref[big][..., d])
                            for d in range(2))
                line += (f"; rows at angles {BIG_ANGLES} (the accurate "
                         f"rerun) max rel err {e_big:.3e} (tol {TOL:.0e})")
                good = good and e_big <= TOL
            if ode_cuda.tableau_instance(solver) != 0:
                gen_ys, gen_ok = ode_cuda.solve_fixed_grid_batched_cuda(
                    f, solver, u0s, ps, saveat, substeps=sub, generic=True)
                # bit patterns: NaN rows compare equal only as bits
                same = (torch.equal(got.view(torch.int32),
                                    gen_ys.view(torch.int32))
                        and torch.equal(ok, gen_ok))
                line += f"; baked instance = generic bit for bit: {same}"
                good = good and same
            log("kernels", line)
            if not good:
                fail(f"{name} {tag}: {line}")
    rk_trig_check()
    return worst


def rk_grad_checks(gen):
    """Phase 3 for rk_fixed_grid: the backward kernel's interval maps
    against the plain maps over the same trajectory, its gradients against
    the two-phase plain version (plain maps, then the plain affine sweep)
    and the plain step-by-step reverse sweep over the same trajectory, then
    the whole backward against plain autograd, for the pendulum cases and
    Van der Pol and Kuramoto-10 at their paths' shapes. On grids of several
    chunks only against the plain versions on the same trajectory (the
    plain forward's own trajectory drifts from the kernel's, see
    rk_kernel_checks): the pendulum's T 1100 against both; Van der Pol and
    Kuramoto-10 at T 300 (1196 steps, over which the interval maps and the
    step-by-step sweep, two float32 orders, can part by more than GRAD_TOL;
    for Kuramoto the maps, the kernel's and the plain ones alike, end
    farther from float64) against the two-phase plain version, and against
    a float64 sweep over the same trajectory, at most twice as far from it
    as the two-phase plain version is. Returns {kernel name: largest absolute error of the kernel's
    gradients against the plain versions on the same trajectory}, at the
    grids of 50 and 100 points."""
    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import RK4, Dopri5, Tsit5
    worst = {}
    cases = [("train", "pendulum", 64, 50, Tsit5(), 1),
             ("val", "pendulum", 45, 100, Tsit5(), 1),
             ("rk4-substeps3", "pendulum", 64, 50, RK4(), 3),
             ("dopri5-substeps3", "pendulum", 64, 50, Dopri5(), 3),
             ("friction", "friction", 64, 50, Tsit5(), 1),
             ("long", "pendulum", 16, 1100, Tsit5(), 1)]
    cases += rk_custom_cases() + [("long", which, 16, 300, Tsit5(),
                                   CUSTOM_SUBSTEPS) for which in CUSTOM]
    for label, which, B, T, solver, sub in cases:
        f, n, _, family = rk_rhs(which)
        name = rk_name("rk_fixed_grid_bwd", f, n)
        tag = label if family == "pendulum" else f"{which} {label}"
        u0s, ps, saveat = rk_inputs(which, B, T, gen)
        w = torch.randn(B, T, n, generator=gen, device="cuda")
        with torch.no_grad():
            ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
                f, solver, u0s, ps, saveat, substeps=sub)
        du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, solver, saveat, ys, ps, w, substeps=sub, maps=True)
        got = (du0, dp)
        J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
            f, solver, saveat, ys, ps, substeps=sub)
        two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(
            J_p, r_p, w)
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, solver, saveat, ys, ps, w, substeps=sub)
        e_maps = max(rel_err(J, J_p), rel_err(r, r_p))
        e_two = max(rel_err(a, b) for a, b in zip(got, two))
        e_sw = max(rel_err(a, b) for a, b in zip(got, sweep))
        if label != "long":  # its gradients reach ~1e3: held relatively
            worst[name] = max(worst.get(name, 0.0),
                              max(max_err(a, b) for a, b in zip(got, sweep)),
                              max(max_err(a, b) for a, b in zip(got, two)))
        line = (f"{name} {tag} B={B} T={T} "
                f"{type(solver).__name__} substeps={sub}: interval maps vs "
                f"plain maps on the same ys max rel err {e_maps:.3e}; "
                f"gradients vs two-phase plain {e_two:.3e}, vs plain reverse "
                f"sweep {e_sw:.3e}")
        e_kp = 0.0
        gated = [e_maps, e_two, e_sw]
        far = True
        if label != "long":
            def grads(fn):
                u = u0s.clone().requires_grad_()
                p = ps.clone().requires_grad_()
                y = fn(f, solver, u, p, saveat, substeps=sub)[0]
                return torch.autograd.grad(y, [u, p], w)

            k = grads(ode_cuda.solve_fixed_grid_batched)
            p = grads(ode_cuda.solve_fixed_grid_batched_reference)
            e_kp = max(rel_err(a, b) for a, b in zip(k, p))
            line += f"; whole backward vs plain autograd {e_kp:.3e}"
            gated.append(e_kp)
        elif family != "pendulum":
            sweep64 = ode_cuda.solve_fixed_grid_batched_backward_reference(
                f, solver, saveat.double(), ys.double(), ps.double(),
                w.double(), substeps=sub)
            d = [[rel_err(a.double(), ref) for a, ref in zip(grads, sweep64)]
                 for grads in (got, two, sweep)]
            far = all(k <= 2 * t for k, t in zip(d[0], d[1]))
            line += ("; vs a float64 sweep (du0, dp): kernel "
                     f"{d[0][0]:.3e}, {d[0][1]:.3e}; two-phase plain "
                     f"{d[1][0]:.3e}, {d[1][1]:.3e}; step-by-step sweep "
                     f"{d[2][0]:.3e}, {d[2][1]:.3e} (gate kernel <= 2 x "
                     f"two-phase)")
            gated.remove(e_sw)  # another float32 order, held through float64
        log("grads", line + f" (tol {GRAD_TOL:.0e})")
        if not (max(gated) <= GRAD_TOL and far):
            fail(f"{name} {tag}: maps {e_maps}, two-phase {e_two}, sweep "
                 f"{e_sw}, autograd {e_kp}, float64 gate {far}")
    return worst


def rk_timing(gen, clock):
    """Phase 5 for the RK kernels, Tsit5: the pendulum at its GOKU path's
    train (B 64, T 50) and validation (B 45, T 100) shapes, substeps 1, and
    Van der Pol and Kuramoto-10 at theirs (B 64, T 50; B 26, T 100),
    substeps 4: each kernel's time per call and on the device beside its
    plain version on the same inputs (the backward's: the plain reverse
    sweep), its bound and latency model; forward + backward by the kernel
    route and by plain autograd. Returns {name: (ms, plain_ms, bound_ms,
    bound_by, library_ms)} at the train shape."""
    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    s = Tsit5()
    tab = s.tableau
    n_st = n_solution_stages(tab)
    cases = [("pendulum", "train", 64, 50, 1), ("pendulum", "val", 45, 100, 1)]
    cases += [(which, label, B, T, CUSTOM_SUBSTEPS) for which in CUSTOM
              for label, B, T in CUSTOM_SHAPES]
    out = {}
    for which, label, B, T, sub in cases:
        f, n, pdim, family = rk_rhs(which)
        n_cst = n if family == "kuramoto" else 0
        fwd_name = rk_name("rk_fixed_grid", f, n)
        bwd_name = rk_name("rk_fixed_grid_bwd", f, n)
        u0s, ps, saveat = rk_inputs(which, B, T, gen)
        w = torch.randn(B, T, n, generator=gen, device="cuda")
        with torch.no_grad():
            ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
                f, s, u0s, ps, saveat, substeps=sub)
        u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()

        def route(fn):
            y = fn(f, s, u, p, saveat, substeps=sub)[0]
            torch.autograd.grad(y, [u, p], w)

        k_r = time_ms(lambda: route(ode_cuda.solve_fixed_grid_batched))
        p_r = plain_ms(lambda: route(
            ode_cuda.solve_fixed_grid_batched_reference))
        log("timing", f"{fwd_name} {label} forward + backward, per call: "
                      f"kernel route (rk_fixed_grid, rk_fixed_grid_bwd) "
                      f"{k_r:.4f} ms, plain autograd {fmt_ms(p_r)}")
        calls = {
            fwd_name: (
                lambda: ode_cuda.solve_fixed_grid_batched_cuda(
                    f, s, u0s, ps, saveat, substeps=sub),
                lambda: ode_cuda.solve_fixed_grid_batched_reference(
                    f, s, u0s, ps, saveat, substeps=sub),
                rk_kernel(family),
                rk_work(B, T, n, pdim, sub, tab, n_st, family, n_cst),
                rk_latency_ms(T, sub, n_st, clock, family, n)),
            bwd_name: (
                lambda: ode_cuda.solve_fixed_grid_batched_bwd_cuda(
                    f, s, saveat, ys, ps, w, substeps=sub),
                lambda: ode_cuda.solve_fixed_grid_batched_backward_reference(
                    f, s, saveat, ys, ps, w, substeps=sub),
                rk_kernel(family, bwd=True),
                rk_bwd_work(B, T, n, pdim, sub, tab, n_st, family, n_cst),
                rk_bwd_latency_ms(T, sub, n_st, clock, family, n))}
        with torch.no_grad():
            for name, (kernel, plain, kname, work, lat) in calls.items():
                k_ms = time_ms(kernel)
                d_ms = device_ms(kernel, kname)
                p_ms = plain_ms(plain)
                b_ms, b_by, t_b, t_o = bound_ms(*work)
                line = (f"{name} {label} B={B} T={T} substeps={sub}: kernel "
                        f"{k_ms:.4f} ms per call ({fmt_ms(d_ms)} on the "
                        f"device), plain {fmt_ms(p_ms)}, bound {b_ms:.6f} ms "
                        f"({b_by}; bytes {t_b:.6f} ms, operations "
                        f"{t_o:.6f} ms), latency model {lat:.6f} ms at "
                        f"{clock:.0f} MHz; library: none")
                if name == "rk_fixed_grid_bwd":
                    line += (f" (the step-by-step reverse sweep's model "
                             f"{rk_sweep_latency_ms(T, sub, n_st, clock):.6f}"
                             f" ms)")
                log("timing", line)
                if label == "train":
                    out[name] = (k_ms, p_ms, b_ms, b_by, None)
    return out


def goku_timing(heads, gen, clock, dev):
    """Phase 5 for the GOKU kernels at the train and validation shapes:
    each kernel's time per call and on the device beside its plain version
    on the same inputs (a backward kernel's: the plain sweep), its bound
    and its latency model; the heads' products; forward + backward of the
    heads by the kernel route, plain autograd and cuDNN (torch.nn.RNN and
    two torch.nn.LSTM on the same weights, the yardstick; the port never
    calls them). In the heads' dtype: bfloat16 heads time the bf16
    instances against the plain bf16 versions and cuDNN in bf16, with the
    bytes at 2 an element, under the names ``goku_heads[bf16]`` and
    ``goku_heads_bwd[bf16]``. Returns {name: (ms, plain_ms, bound_ms,
    bound_by, library_ms)} at the train shape."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    L, H = len(heads[0].cells), heads[0].cells[0].hidden_dim
    dtype = heads[0].cells[0].Wi.dtype
    bf16 = dtype == torch.bfloat16
    tag, elem = ("[bf16]", 2) if bf16 else ("", 4)
    params = rc._heads_params(*heads)
    mods, state, cudnn_run = cudnn_heads(heads, dev)
    mod_params = [p for m in mods for p in m.parameters()]
    out = {}
    for label, (B, T) in (("train", (64, 50)), ("val", (45, 100))):
        xs = torch.randn(B, T, 32, generator=gen, device=dev).to(dtype)
        gz = torch.randn(B, H, generator=gen, device=dev).to(dtype)
        gt = torch.randn(B, 2 * H, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            _, _, tape = rc.goku_heads_cuda(*heads, xs, tape=True)
            dg, dh0, dc0 = rc.goku_heads_bwd_cuda(*heads, tape, gz, gt)
        x = xs.clone().requires_grad_()

        def route(fn, **kw):
            z, th = fn(*heads, x, **kw)
            torch.autograd.grad((z, th), [x] + params, (gz, gt))

        # the yardstick, checked against the plain version first
        xr = xs.flip(1).contiguous()
        with torch.no_grad():
            z_c, th_c = cudnn_run(xs, xr)
            z_p, th_p = rc.goku_heads_reference(*heads, xs)
        e = max(max_err(z_c.float(), z_p.float()),
                max_err(th_c.float(), th_p.float()))
        # bf16: cuDNN rounds at other places than the plain version; a
        # check that the yardstick computes the same function
        e_tol = (2 ** -6 * float(torch.cat([z_p, th_p], -1).float().abs()
                                 .max()) if bf16 else 1e-4)
        if not e <= e_tol:
            fail(f"cuDNN RNN/LSTM vs goku_heads' plain version: {e}")
        s_z = state(heads[0], "h0", B)
        s_f = (state(heads[1], "h0", B), state(heads[1], "c0", B))
        s_b = (state(heads[2], "h0", B), state(heads[2], "c0", B))
        xl, xrl = xs.clone().requires_grad_(), xr.clone().requires_grad_()

        def three():
            return (mods[0](xr, s_z)[1], mods[1](xs, s_f)[1][0],
                    mods[2](xr, s_b)[1][0])

        def three_grad():
            hz = mods[0](xrl, s_z)[1]
            hf = mods[1](xl, s_f)[1][0]
            hb = mods[2](xrl, s_b)[1][0]
            torch.autograd.grad((hz[-1], hf[-1], hb[-1]),
                                [xl, xrl] + mod_params,
                                (gz, gt[:, :H], gt[:, H:]))

        with torch.no_grad():
            lib_f = time_ms(three)
        lib_fb = time_ms(three_grad)
        # cuDNN's backward alone (goku_heads_bwd's yardstick): the graph of
        # one forward kept, autograd's backward through it timed
        hz = mods[0](xrl, s_z)[1]
        hf = mods[1](xl, s_f)[1][0]
        hb = mods[2](xrl, s_b)[1][0]
        lib_b = time_ms(lambda: torch.autograd.grad(
            (hz[-1], hf[-1], hb[-1]), [xl, xrl] + mod_params,
            (gz, gt[:, :H], gt[:, H:]), retain_graph=True))
        log("timing", f"goku_heads{tag} {label} yardstick: torch.nn.RNN "
                      f"(relu) + 2 torch.nn.LSTM, {L} layers each, {dtype}, "
                      f"cuDNN {torch.backends.cudnn.version()}: forward "
                      f"{lib_f:.4f} ms, backward alone {lib_b:.4f} ms, "
                      f"forward + backward {lib_fb:.4f} ms for the three "
                      f"(vs the plain version max abs err {e:.3e}, tol "
                      f"{e_tol:.1e})")
        k_route = time_ms(lambda: route(rc.goku_heads))
        p_route = plain_ms(lambda: route(rc.goku_heads_reference))
        log("timing", f"goku_heads{tag} {label} forward + backward, per call: "
                      f"kernel route (tape forward, goku_heads_bwd, "
                      f"products) {k_route:.4f} ms, plain autograd "
                      f"{fmt_ms(p_route)}, cuDNN {lib_fb:.4f} ms")
        with torch.no_grad():
            prod_ms = time_ms(lambda: rc.goku_heads_param_grads(
                *heads, xs, tape, dg, dh0, dc0))
        log("timing", f"goku_heads{tag} {label} products (dxs, dW, db, "
                      f"dh0, dc0; PyTorch matrix products): {prod_ms:.4f} ms "
                      f"per call")
        # bf16: the plain forward is the kernel's own (rounding where it
        # rounds); autograd's CPU route runs goku_heads_reference
        plain_fwd = (rc.goku_heads_taped_reference if bf16
                     else rc.goku_heads_reference)
        calls = {
            f"goku_heads{tag}": (
                lambda: rc.goku_heads_cuda(*heads, xs),
                lambda: plain_fwd(*heads, xs),
                "goku_heads_fwd_kernel", heads_work(B, T, 32, H, L,
                                                    elem=elem),
                heads_latency_ms(T, L, 32, H, clock), lib_f),
            f"goku_heads{tag} (writing the tape)": (
                lambda: rc.goku_heads_cuda(*heads, xs, tape=True),
                lambda: rc.goku_heads_taped_reference(*heads, xs),
                "goku_heads_fwd_kernel", None,
                heads_latency_ms(T, L, 32, H, clock), None),
            f"goku_heads_bwd{tag}": (
                lambda: rc.goku_heads_bwd_cuda(*heads, tape, gz, gt),
                lambda: rc.goku_heads_sweep_reference(*heads, tape, gz, gt),
                "goku_heads_bwd_kernel", heads_bwd_work(B, T, 32, H, L,
                                                        elem=elem),
                heads_bwd_latency_ms(T, L, H, clock), lib_b),
        }
        with torch.no_grad():
            for name, (kernel, plain, kname, work, lat, lib) in calls.items():
                k_ms = time_ms(kernel)
                d_ms = device_ms(kernel, kname)
                p_ms = plain_ms(plain)
                line = (f"{name} {label} B={B} T={T}: kernel {k_ms:.4f} ms "
                        f"per call ({fmt_ms(d_ms)} on the device), plain "
                        f"{fmt_ms(p_ms)}")
                if work is not None:
                    b_ms, b_by, t_b, t_o = bound_ms(*work)
                    line += (f", bound {b_ms:.6f} ms ({b_by}; bytes "
                             f"{t_b:.6f} ms, operations {t_o:.6f} ms)")
                line += f", latency model {lat:.6f} ms at {clock:.0f} MHz"
                log("timing", line)
                if label == "train" and work is not None:
                    out[name] = (k_ms, p_ms, b_ms, b_by, lib)
    # heads wider than the compiled widths run in the any-width kernels (off
    # the main path, not tuned)
    wh = tuple(h.to(dtype) for h in wide_heads())
    D, Hw, _ = WIDE_HEADS
    xs = torch.randn(64, 50, D, generator=gen, device=dev).to(dtype)
    gz = torch.randn(64, Hw, generator=gen, device=dev).to(dtype)
    gt = torch.randn(64, 2 * Hw, generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        _, _, tape = rc.goku_heads_cuda(*wh, xs, tape=True)
        f_ms = device_ms(lambda: rc.goku_heads_cuda(*wh, xs),
                         "goku_heads_fwd_any_kernel")
        b_ms = device_ms(lambda: rc.goku_heads_bwd_cuda(*wh, tape, gz, gt),
                         "goku_heads_bwd_any_kernel")
    log("timing", f"goku_heads{tag} wide {WIDE_HEADS} B=64 T=50, the "
                  f"any-width kernels: forward {fmt_ms(f_ms)}, sweep "
                  f"{fmt_ms(b_ms)} on the device")
    return out


# ---------------------------------------------------------------------------
# The GOKU paths and the counters they read.

def reset_counts():
    """Every kernel wrapper's launch count (the RK launchers' by instance)
    and the plain versions' call counts to 0."""
    from latentdiffeq_torch.ops import launches
    launches.reset()


def log_epochs(what, hist):
    """One line an epoch of a fit; fails on a non-finite loss."""
    for rec in hist:
        log("train", f"{what} epoch {rec['epoch']}: train loss "
                     f"{rec['train_loss']:.6f} val loss {rec['val_loss']:.6f}"
                     f" beta {rec['beta']:.4f} {rec['epoch_s']:.4f} s")
        if not (math.isfinite(rec["train_loss"])
                and math.isfinite(rec["val_loss"])):
            fail(f"{what}: non-finite loss in epoch {rec['epoch']}")


def plain_copy(model, model_type):
    """A copy of ``model`` (same weights) that runs ``model_type``: the
    plain route when the type's kernel switches are off."""
    plain = copy.deepcopy(model)
    plain.model_type = plain.encoder.model_type = \
        plain.decoder.model_type = model_type
    return plain


STEP_REPORTS = {}


def step_report(what, trainer, data, val_set, beta, gpu):
    """The step and validation times and the device ops of one step (kept
    in STEP_REPORTS[what] as (step ms, val ms, ops, busy ms, span ms))."""
    step_ms, val_ms = step_times(trainer, data, val_set, beta)
    n_ops, busy, span, lost = step_device_ops(trainer, data, beta)
    STEP_REPORTS[what] = (step_ms, val_ms, n_ops, busy, span)
    log("train", f"{what} step time (median of 5, synchronised): train "
                 f"step {step_ms:.3f} ms, val pass {val_ms:.3f} ms; one "
                 f"train step under torch.profiler: {n_ops} device ops, "
                 f"device busy {busy:.3f} ms of a {span:.3f} ms span (idle "
                 f"{100 * (1 - busy / span) if span else 0:.1f} %; "
                 f"{lost_str(lost)}); card {gpu}")


def goku_path(what, train_set, val_set, diffeq, layers, cfg, dev, gpu):
    """A GOKU main path: GOKUBasic with both kernel switches on, on
    ``layers`` (encoder, decoder) for ``diffeq``, Trainer.fit under ``cfg``
    for 2 epochs, each followed by validation. Per train step it must
    launch goku_heads and the RK kernel's instance for ``diffeq``'s RHS
    (writing the tape) and both backward kernels, per validation pass the
    two forward kernels, no other RK instance and no plain version; then
    the trained model, kernel route against the plain route on the same
    weights on the validation set, and the step and validation times and
    the device ops of one step. Returns (launches, trainer, batch, beta)."""
    from latentdiffeq_torch.models import GOKUBasic, LatentDiffEqModel
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.train import Trainer

    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    trainer = Trainer(model, cfg, device=dev)
    fwd = ode_cuda.solve_fixed_grid_batched_cuda
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda
    dims = (diffeq.z_dim, diffeq.theta_dim)
    inst = ode_cuda.rhs_instance(diffeq.f, *dims)
    names = (rk_name("rk_fixed_grid", diffeq.f, *dims),
             rk_name("rk_fixed_grid_bwd", diffeq.f, *dims))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"goku_heads": recurrent_cuda.goku_heads_cuda.launches,
                "goku_heads_bwd": recurrent_cuda.goku_heads_bwd_cuda.launches,
                names[0]: fwd.launches.get(inst, 0),
                names[1]: bwd.launches.get(inst, 0)}
    others = (sum(fwd.launches.values()) - launches[names[0]],
              sum(bwd.launches.values()) - launches[names[1]])
    plain_calls = [recurrent_cuda.goku_heads_reference.calls,
                   ode_cuda.solve_fixed_grid_batched_reference.calls]
    steps = train_set.shape[0] // cfg.batch_size
    log_epochs(what, hist)
    # forward kernels: one per train step (writing the tape) and one per
    # validation pass; backward kernels: one per train step
    expected = {"goku_heads": 2 * steps * 2, "goku_heads_bwd": 2 * steps,
                names[0]: 2 * steps * 2, names[1]: 2 * steps}
    log("train", f"{what} fit 2 epochs x {steps} steps in {fit_s:.3f} s; "
                 f"kernel launches {launches} (expected {expected}); "
                 f"launches of other RK instances {others} (expected (0, "
                 f"0)); calls of the plain goku_heads / RK solve: "
                 f"{plain_calls} (expected [0, 0])")
    if launches != expected or others != (0, 0):
        fail(f"{what} path launched {launches} (+{others}), expected "
             f"{expected}")
    if plain_calls != [0, 0]:
        fail(f"the plain version ran during the {what} fit: {plain_calls}")

    # the kernel path against the plain path, same weights, on the card
    plain = plain_copy(model, GOKUBasic())
    t_val = torch.arange(val_set.shape[1], dtype=torch.float32,
                         device=dev) * cfg.dt
    with torch.no_grad():
        (xk, zk, _), _, _, aux = model(val_set, t_val)
        (xp, zp, _), _, _, _ = plain(val_set, t_val)
    e = max(max_err(xk, xp), max_err(zk, zp))
    log("train", f"trained {what} GOKU, kernel vs plain path on the val "
                 f"set: x_hat {tuple(xk.shape)} z_hat {tuple(zk.shape)} max "
                 f"abs err {e:.3e} (tol {PATH_TOL:.0e}); all solves ok: "
                 f"{bool(aux['success'].all())}")
    if not (e <= PATH_TOL and bool(torch.isfinite(xk).all())
            and xk.shape == val_set.shape
            and tuple(zk.shape) == (*val_set.shape[:2], diffeq.z_dim)):
        fail(f"{what} kernel path vs plain path: {e}")

    data = train_set[:cfg.batch_size, :cfg.seq_len]
    beta = float(hist[-1]["beta"])
    step_report(what, trainer, data, val_set, beta, gpu)
    return launches, trainer, data, beta


def custom_dataset(which, dev):
    """The Van der Pol (mu_max 4) or Kuramoto-N ("kuramoto10",
    "kuramoto7") GOKU path's data and
    config, as the JAX examples have them: 256 trajectories x 100 frames of
    64 channels made on the card (230 / 26 split), batch 64, seq 50, dt
    0.1; Van der Pol with TrainConfig(seed=7), Kuramoto-10 with the KL
    ceiling 0.01 in one cycle. Returns (train set, val set, dynamics,
    config)."""
    from latentdiffeq_torch.custom_data import (make_kuramoto_data,
                                                make_vdp_data)
    from latentdiffeq_torch.train import TrainConfig, splitobs

    t0 = time.perf_counter()
    if which == "vdp":
        x, _, _, diffeq = make_vdp_data(mu_max=4.0, device=dev)
        cfg = TrainConfig(jit_epoch=False, batch_size=64, seq_len=50,
                          dt=CUSTOM_DT, seed=7,
                          epochs=300, save_best=False)
    else:
        x, _, _, diffeq = make_kuramoto_data(
            n_osc=int(which[len("kuramoto"):]), device=dev)
        cfg = TrainConfig(jit_epoch=False, batch_size=64, seq_len=50,
                          dt=CUSTOM_DT, seed=7,
                          epochs=300, start_beta=0.0, end_beta=0.01,
                          n_cycle=1, save_best=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if (tuple(x.shape) != (256, 100, 64) or not bool(torch.isfinite(x).all())
            or float(x.min()) != 0.0 or float(x.max()) != 1.0):
        fail(f"{which} data: shape {tuple(x.shape)}, range "
             f"[{float(x.min())}, {float(x.max())}]")
    train_set, val_set = splitobs(x, 0.9)
    log("train", f"{which}: data 256x100x64 on {dev} in {gen_s:.3f} s "
                 f"(port's solve_ensemble, fixed grid, 4 sub-steps); train "
                 f"{tuple(train_set.shape)} val {tuple(val_set.shape)}")
    return train_set, val_set, diffeq, cfg


API_TOL = 1e-9  # float64, card vs CPU: the same steps, sums in other orders


def solve_api_card_checks(dev):
    """The solve API and the adjoints on CUDA tensors against the same calls
    on CPU tensors (float64, small): solve_ensemble on the fixed grid and
    adaptively, odeint(adaptive=True) with Unrolled gradients, both
    adjoints over an adaptive forward (per-row parameters), and the
    backsolve with a neural field as p (its per-row parameter adjoint
    through torch.func on the card). Returns the largest relative error."""
    import latentdiffeq_torch as ldt
    from latentdiffeq_torch import nn as tnn
    from latentdiffeq_torch.custom_dynamics import vdp_f

    g = torch.Generator().manual_seed(3)
    u0s = torch.rand(6, 2, generator=g, dtype=torch.float64) * 4 - 2
    ps = 0.5 + 3.5 * torch.rand(6, 1, generator=g, dtype=torch.float64)
    saveat = torch.arange(20, dtype=torch.float64) * CUSTOM_DT
    w = torch.randn(6, 20, 2, generator=g, dtype=torch.float64)
    field = tnn.mlp((2, 8, 2), tnn.tanh, generator=g, dtype=torch.float64)
    ada = dict(rtol=1e-6, atol=1e-9)

    def run(device):
        u, p, s, ww = (t.to(device) for t in (u0s, ps, saveat, w))
        prob = ldt.ODEProblem(f=vdp_f, u0=u[0], tspan=(0.0, 1.9), p=p[0])
        out = {"solve_ensemble fixed": (ldt.solve_ensemble(
                   prob, ldt.Tsit5(), u0s=u, ps=p, saveat=s, adaptive=False,
                   substeps=4).ys,),
               "solve_ensemble adaptive": (ldt.solve_ensemble(
                   prob, ldt.Tsit5(), u0s=u, ps=p, saveat=s, **ada).ys,)}
        for name, sa in (("odeint adaptive", ldt.Unrolled()),
                         ("InterpolatingAdjoint", ldt.InterpolatingAdjoint()),
                         ("BacksolveAdjoint", ldt.BacksolveAdjoint())):
            uu, pp = u.clone().requires_grad_(), p.clone().requires_grad_()
            ys = ldt.odeint(vdp_f, ldt.Tsit5(), uu, pp, s,
                            ldt.make_options(**ada), sa)[0]
            out[name] = (ys,) + torch.autograd.grad((ys * ww).sum(),
                                                    [uu, pp])
        fm = copy.deepcopy(field).to(device)
        uu = u.clone().requires_grad_()
        ys = ldt.odeint(lambda y, q, t: q(y), ldt.Tsit5(), uu, fm, s,
                        ldt.make_options(adaptive=False, substeps=2),
                        ldt.BacksolveAdjoint(bwd_substeps=4))[0]
        out["BacksolveAdjoint, neural field p"] = (ys,) + torch.autograd.grad(
            (ys * ww).sum(), [uu] + list(fm.parameters()))
        return out

    t0 = time.perf_counter()
    got = run(dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    ref = run("cpu")
    worst = 0.0
    for name, tensors in got.items():
        e = max(rel_err(a.cpu(), b) for a, b in zip(tensors, ref[name]))
        worst = max(worst, e)
        log("api", f"{name} on the card vs the CPU (float64): max rel err "
                   f"{e:.3e} over ys and the gradients (tol {API_TOL:.0e})")
        if not (e <= API_TOL and all(bool(torch.isfinite(a).all())
                                     for a in tensors)):
            fail(f"{name} card vs CPU: {e}")
    log("api", f"solve API and adjoints on the card in {card_s:.3f} s")
    return worst


def sde_api_card_check(dev):
    """The adaptive SDE through solve_ensemble on CUDA tensors against the
    same call on CPU tensors (float64, B 8, T 20, depth_cap 4): ys within
    API_TOL, and per row (solve_sde_adaptive on the ensemble's keys) the
    same accepted and rejected steps and the same deepest level."""
    import latentdiffeq_torch as ldt
    from latentdiffeq_torch import random as jr
    from latentdiffeq_torch.pendulum import pendulum_f, spendulum_g
    from latentdiffeq_torch.solve.sde import solve_sde_adaptive

    g = torch.Generator().manual_seed(4)
    u0s = torch.rand(8, 2, generator=g, dtype=torch.float64) * 2 - 1
    ps = 0.5 + 1.5 * torch.rand(8, 1, generator=g, dtype=torch.float64)
    saveat = torch.arange(20, dtype=torch.float64) * 0.05
    kw = dict(adaptive=True, rtol=1e-4, atol=1e-4, max_steps=256,
              depth_cap=4)
    cfg = ldt.SDEAdaptiveConfig(rtol=1e-4, atol=1e-4, max_steps=256,
                                depth_cap=4)

    def run(device):
        u, p, s = (x.to(device) for x in (u0s, ps, saveat))
        key = jr.PRNGKey(21, device=device)
        prob = ldt.SDEProblem(f=pendulum_f, g=spendulum_g, u0=u[0],
                              tspan=(0.0, 0.95), p=p[0])
        sol = ldt.solve_ensemble(prob, ldt.SRA1(), u0s=u, ps=p, saveat=s,
                                 key=key, **kw)
        _, _, stats = solve_sde_adaptive(pendulum_f, spendulum_g, ldt.SRA1(),
                                         u, p, s, jr.split(key, 8), cfg)
        return sol, {k: v.cpu().tolist() for k, v in stats.items()}

    (got, st), (ref, st_ref) = run(dev), run("cpu")
    e = rel_err(got.ys.cpu(), ref.ys)
    log("api", f"adaptive SDE solve_ensemble (SRA1, float64, B 8, T 20, "
               f"depth_cap 4) on the card vs the CPU: max rel err {e:.3e} "
               f"(tol {API_TOL:.0e}); per-row steps accepted "
               f"{st['n_accepted']}, rejected {st['n_rejected']}, deepest "
               f"level {st['max_depth']} (CPU: {st_ref['n_accepted']}, "
               f"{st_ref['n_rejected']}, {st_ref['max_depth']})")
    if not (e <= API_TOL and st == st_ref and bool(got.success.all())
            and got.success.cpu().tolist() == ref.success.tolist()):
        fail(f"adaptive SDE card vs CPU: {e}, {st} vs {st_ref}")


def ulps(a, b) -> float:
    """The largest |a - b| in units in the last place of b."""
    m = b.abs()
    ulp = torch.nextafter(m, torch.full_like(m, math.inf)) - m
    return float(((a - b).abs() / ulp).max())


SPENDULUM_CKPT = os.path.join("benchmarks", "artifacts",
                              "spendulum_pop4_winner.npz")
SDE_ULPS = 2        # threefry normals, card vs CPU: every operation of a
#                     draw is correctly rounded, so 0 is expected


def brownian_card_check(keys, t_val):
    """The Brownian path of one forward, card against CPU: the interval
    keys bit for bit, their normals within SDE_ULPS units in the last
    place, and the increments' largest difference."""
    from latentdiffeq_torch import random as jr
    from latentdiffeq_torch.solve.brownian import bridge_increments

    cells = torch.arange(t_val.shape[0] - 1, device=keys.device)
    ik = jr.fold_in(keys[:, None, :], cells)
    ik_cpu = jr.fold_in(keys.cpu()[:, None, :], cells.cpu())
    z, z_cpu = jr.normal(ik, (2, 2)), jr.normal(ik_cpu, (2, 2))
    w, i = bridge_increments(keys, t_val, 1, (2,))
    w_cpu, i_cpu = bridge_increments(keys.cpu(), t_val.cpu(), 1, (2,))
    e_z = ulps(z.cpu(), z_cpu)
    e_w = max(max_err(w.cpu(), w_cpu), max_err(i.cpu(), i_cpu))
    same = torch.equal(ik.cpu(), ik_cpu)
    log("train", f"spendulum Brownian path of one forward ({tuple(ik.shape)}"
                 f" interval keys, {z.numel()} normals): keys bit for bit "
                 f"{same}; normals {e_z:.1f} ulp (tol {SDE_ULPS}); "
                 f"increments max abs err {e_w:.3e}")
    if not (same and e_z <= SDE_ULPS):
        fail(f"Brownian path card vs CPU: keys equal {same}, {e_z} ulp")


def spendulum_path(train_set, val_set, dev, gpu):
    """Phase 4f: full-width GOKU on the stochastic pendulum (SPendulum:
    SRA1 on the grid, one sub-step), both kernel switches on, Trainer.fit
    for 2 epochs with validation after every step. Per train step one
    goku_heads launch (writing the tape) and one goku_heads_bwd, per
    validation pass one goku_heads; no RK kernel launch (SDE dynamics take
    the SDE solvers) and no plain-version call. Then, on one variational
    forward of the validation set with the same eps and Brownian key: the
    kernel route against the plain route, and the Brownian path card
    against CPU; the ELBO of spendulum_pop4_winner.npz card against CPU;
    step, validation and device ops; and one forward of the adaptive
    SPendulum at train_goku.py --adaptive's settings, timed (a record, not
    a gate). Returns the trained model."""
    from latentdiffeq_torch import random as jr
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.pendulum import SPendulum
    from latentdiffeq_torch.train import (TrainConfig, Trainer,
                                          load_checkpoint, loss_batch)

    what = "spendulum"
    cfg = TrainConfig(jit_epoch=False, epochs=1500, save_best=False)
    layers = goku_default_layers(
        784, SPendulum(), generator=torch.Generator().manual_seed(333),
        device=dev)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    trainer = Trainer(model, cfg, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"goku_heads": recurrent_cuda.goku_heads_cuda.launches,
                "goku_heads_bwd": recurrent_cuda.goku_heads_bwd_cuda.launches}
    rk = (sum(ode_cuda.solve_fixed_grid_batched_cuda.launches.values()),
          sum(ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches.values()))
    plain_calls = [recurrent_cuda.goku_heads_reference.calls,
                   ode_cuda.solve_fixed_grid_batched_reference.calls]
    steps = train_set.shape[0] // cfg.batch_size
    log_epochs(what, hist)
    expected = {"goku_heads": 2 * steps * 2, "goku_heads_bwd": 2 * steps}
    log("train", f"{what} fit 2 epochs x {steps} steps in {fit_s:.3f} s; "
                 f"kernel launches {launches} (expected {expected}); RK "
                 f"kernel launches (forward, backward) {rk} (expected (0, "
                 f"0)); calls of the plain goku_heads / RK solve: "
                 f"{plain_calls} (expected [0, 0])")
    if launches != expected or rk != (0, 0) or plain_calls != [0, 0]:
        fail(f"{what} path launched {launches}, RK {rk}, plain "
             f"{plain_calls}; expected {expected}, (0, 0), [0, 0]")

    # the kernel route against the plain route, same weights, same eps and
    # Brownian key, on the card
    plain = plain_copy(model, GOKUBasic())
    t_val = torch.arange(val_set.shape[1], dtype=torch.float32,
                         device=dev) * cfg.dt
    g = torch.Generator(device=dev).manual_seed(7)
    eps = tuple(torch.randn(val_set.shape[0], 16, generator=g, device=dev)
                for _ in range(2))
    key = jr.PRNGKey(7, device=dev)
    with torch.no_grad():
        (xk, zk, _), _, _, aux = model(val_set, t_val, variational=True,
                                       eps=eps, key=key)
        (xp, zp, _), _, _, _ = plain(val_set, t_val, variational=True,
                                     eps=eps, key=key)
    e = max(max_err(xk, xp), max_err(zk, zp))
    log("train", f"trained {what} GOKU, kernel vs plain route on the val "
                 f"set (same eps and Brownian key): x_hat {tuple(xk.shape)} "
                 f"z_hat {tuple(zk.shape)} max abs err {e:.3e} (tol "
                 f"{PATH_TOL:.0e}); all solves ok: "
                 f"{bool(aux['success'].all())}; stats "
                 f"{ {k: int(v) for k, v in aux['stats'].items()} }")
    if not (e <= PATH_TOL and bool(torch.isfinite(xk).all())
            and xk.shape == val_set.shape
            and tuple(zk.shape) == (*val_set.shape[:2], 2)):
        fail(f"{what} kernel route vs plain route: {e}")
    brownian_card_check(jr.split(key, val_set.shape[0]), t_val)

    # the ELBO of the committed stochastic-pendulum checkpoint
    here = os.path.dirname(os.path.abspath(__file__))
    winner = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(784, SPendulum(), device=dev))
    load_checkpoint(os.path.join(here, SPENDULUM_CKPT), winner)
    winner_cpu = plain_copy(winner, GOKUBasic()).cpu()
    with torch.no_grad():
        elbo = float(loss_batch(winner, val_set, t_val, 1.0, eps=eps,
                                key=key)[0])
        elbo_cpu = float(loss_batch(winner_cpu, val_set.cpu(), t_val.cpu(),
                                   1.0, eps=tuple(x.cpu() for x in eps),
                                   key=key.cpu())[0])
    e = abs(elbo - elbo_cpu)
    log("train", f"spendulum_pop4_winner.npz ELBO (beta 1) on the "
                 f"{val_set.shape[0]} validation rows, same eps and key: "
                 f"card {elbo:.6f} CPU {elbo_cpu:.6f} abs err {e:.3e} (tol "
                 f"{PATH_TOL:.0e})")
    if not (math.isfinite(elbo) and e <= PATH_TOL):
        fail(f"{what} checkpoint ELBO card vs CPU: {elbo} vs {elbo_cpu}")

    data = train_set[:cfg.batch_size, :cfg.seq_len]
    beta = float(hist[-1]["beta"])
    step_report(what, trainer, data, val_set, beta, gpu)
    adaptive_forward_timing(model, data, dev, gpu)
    return model


ADAPTIVE_SDE = dict(max_steps=256, depth_cap=6, max_steps_per_interval=6)


def adaptive_spendulum(trained, dev):
    """The adaptive SPendulum GOKU at train_goku.py --adaptive's settings
    (ADAPTIVE_SDE), both kernel switches on, holding ``trained``'s
    weights."""
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.pendulum import SPendulum
    from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig

    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(784, SPendulum(
            adaptive=True, adaptive_cfg=SDEAdaptiveConfig(**ADAPTIVE_SDE)),
            device=dev))
    model.load_state_dict(trained.state_dict())
    return model


def adaptive_forward(model, data, dev, key_seed=3):
    """One no_grad forward of ``model`` on ``data`` (dt 0.05) with the
    Brownian key PRNGKey(key_seed): (ms, the median of 3 synchronised runs
    after a warm-up; device ops in a profiler window (profiler_window), with
    its lost_kernel_records; aux; x_hat)."""
    from latentdiffeq_torch import random as jr

    t = torch.arange(data.shape[1], dtype=torch.float32, device=dev) * 0.05
    key = jr.PRNGKey(key_seed, device=dev)
    runs = []
    with torch.no_grad():
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (x_hat, _, _), _, _, aux = model(data, t, key=key)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        prof, lost = profiler_window(lambda: model(data, t, key=key))
    n_ops = len(device_events(prof))
    return sorted(runs[1:])[1], (n_ops, lost), aux, x_hat


def adaptive_forward_timing(trained, data, dev, gpu):
    """One forward of the adaptive SPendulum GOKU (the trained weights) at
    train_goku.py --adaptive's settings, B 64, T 50, under no_grad: its
    time (median of 3, synchronised) and its device ops (torch.profiler).
    A record, not a gate: the masked loop draws the Brownian tree's keys
    and normals for every level of every step."""
    ms, (n_ops, lost), aux, _ = adaptive_forward(
        adaptive_spendulum(trained, dev), data, dev)
    log("train", f"adaptive spendulum forward (B {data.shape[0]}, T "
                 f"{data.shape[1]}, max_steps 256, depth_cap 6, "
                 f"max_steps_per_interval 6, no_grad): {ms:.3f} ms (median "
                 f"of 3 after a warm-up), {n_ops} device ops "
                 f"({lost_str(lost)}); stats "
                 f"{ {k: int(v) for k, v in aux['stats'].items()} }, all ok "
                 f"{bool(aux['success'].all())}; card {gpu}")


# ---------------------------------------------------------------------------
# Phase 4g: the population (train_goku.py --seeds 8).

POP_SEEDS = tuple(range(333, 341))
POP_RTOL = 2e-4     # replica s against a solo Trainer of seed s: batched
#                     products sum in another order (tests/test_multiseed.py)
CKPT_TOL = 1e-6     # a replica checkpoint's validation loss after restore
MASKED_RTOL = 1e-6  # the masked curriculum's epoch against the sliced one:
#                     the same program on the same draws


class _Heads(torch.nn.Module):
    """The three GOKU heads as one module, so torch.func can run a plain
    version ``ref(*heads, *args)`` over stacked weight sets."""

    def __init__(self, heads, ref):
        super().__init__()
        self.h = torch.nn.ModuleList(heads)
        self.ref = ref

    def forward(self, *args):
        return self.ref(*self.h, *args)


def population_plain(heads, params, ref):
    """``ref`` (a plain heads function) vmapped over the S weight sets
    ``params`` (in the order of _heads_params): a function of the stacked
    inputs, each with the leading S."""
    from torch.func import functional_call, vmap
    mod = _Heads(heads, ref)
    stacked = dict(zip([n for n, _ in mod.named_parameters()], params))
    return lambda *args: vmap(lambda p, *a: functional_call(mod, p, a))(
        stacked, *args)


def population_heads(ms):
    """(the base model's heads, their tensors of every replica (S, ...) in
    the order of _heads_params, the packed weights (S, n_w))."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    pe = ms.base.encoder.pattern_extractor
    params = [ms.params[f"encoder.pattern_extractor.{n}"].detach()
              for n, _ in pe.named_parameters()]
    heads = tuple(pe)
    return heads, params, rc.pack_goku_heads(*heads, params=params).float()


def population_kernel_checks(ms, gen, dev):
    """At the main path's train shape (B 64, T 20): goku_heads and
    goku_heads_bwd on the S replicas' weights in one launch each against
    the plain forward with its tape and the plain sweep on the same tape,
    vmapped over the weight sets (the solo rows' tolerances), and against
    S solo launches bit for bit; the RK kernels under torch.func.vmap over
    S replicas (S * B rows, forward and backward) against S solo launches
    of B rows bit for bit. Returns the heads kernels' largest absolute
    errors against the plain versions {name: error}. A bf16 population
    runs the bf16 instances, held by bf16_gate against the plain float32
    versions vmapped over the upcast weight sets (the sweep on the kernel's
    tape upcast); its RK solve is float32, checked by the float32 run."""
    from torch.func import vmap

    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    from latentdiffeq_torch.pendulum import pendulum_f
    from latentdiffeq_torch.solve.rk import Tsit5

    S, B, T = ms.n_seeds, 64, 20
    heads, params, wts = population_heads(ms)
    dtype = params[0].dtype
    if dtype == torch.bfloat16:
        return population_bf16_kernel_checks(ms, heads, params, wts, gen,
                                             dev)
    xs = torch.randn(S, B, T, 32, generator=gen, device=dev)
    gz = torch.randn(S, B, 16, generator=gen, device=dev)
    gt = torch.randn(S, B, 32, generator=gen, device=dev)
    with torch.no_grad():
        z, th, tape = rc.goku_heads_cuda(*heads, xs, tape=True, wts=wts)
        dg, dh0, dc0 = rc.goku_heads_bwd_cuda(*heads, tape, gz, gt, wts=wts)
        # the plain versions over the same weight sets: the forward with
        # its tape, and the sweep on the kernel's tape
        zp, thp, tape_p = population_plain(
            heads, params, rc.goku_heads_taped_reference)(xs)
        sweep_p = population_plain(
            heads, params, rc.goku_heads_sweep_reference)(tape, gz, gt)
        ef = max(max_err(z, zp), max_err(th, thp))
        e_tape = rel_err(tape, tape_p)
        eb = max(max_err(a, b) for a, b in zip((dg, dh0, dc0), sweep_p))
        e_sw = max(rel_err(a, b) for a, b in zip((dg, dh0, dc0), sweep_p))
        same = True
        for i in range(S):
            hs = tuple(ms.seed_model(i).encoder.pattern_extractor)
            zs, ths, tps = rc.goku_heads_cuda(*hs, xs[i], tape=True)
            solo = rc.goku_heads_bwd_cuda(*hs, tps, gz[i], gt[i])
            same = same and all(torch.equal(a, b) for a, b in zip(
                (z[i], th[i], tape[i], dg[i], dh0[i], dc0[i]),
                (zs, ths, tps) + solo))
    log("kernels", f"goku_heads / goku_heads_bwd at S={S} (B={B}, T={T}, "
                   f"one launch each on a ({B}, {S}) grid) vs the plain "
                   f"versions vmapped over the replicas' weights: outputs "
                   f"max abs err {ef:.3e} (tol {TOL:.0e}), tape max rel err "
                   f"{e_tape:.3e} (tol {TOL:.0e}); sweep on the same tape "
                   f"dgates/dh0/dc0 max abs err {eb:.3e}, max rel err "
                   f"{e_sw:.3e} (tol {GRAD_TOL:.0e}); vs {S} solo launches "
                   f"on the replicas' weights bit for bit {same}")
    if not (ef <= TOL and e_tape <= TOL and e_sw <= GRAD_TOL):
        fail(f"goku_heads population launch vs plain: outputs {ef}, tape "
             f"{e_tape}, sweep {e_sw}")
    if not same:
        fail("goku_heads population launch differs from solo launches")
    errs = {"goku_heads[pop8]": ef, "goku_heads_bwd[pop8]": eb}

    u0s = (torch.rand(S, B, 2, generator=gen, device=dev) * 2 - 1)
    ps = 1 + torch.rand(S, B, 1, generator=gen, device=dev)
    w = torch.randn(S, B, T, 2, generator=gen, device=dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
    u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    n0 = (sum(fwd.values()), sum(bwd.values()))
    ys, ok = vmap(lambda a, b: ode_cuda.solve_fixed_grid_batched(
        pendulum_f, Tsit5(), a, b, saveat)[:2])(u, p)
    (ys * w).sum().backward()
    n1 = (sum(fwd.values()) - n0[0], sum(bwd.values()) - n0[1])
    ef = eb = 0.0
    same = n1 == (1, 1)
    for i in range(S):
        ui, pi = (u0s[i].clone().requires_grad_(),
                  ps[i].clone().requires_grad_())
        yi, oki, _ = ode_cuda.solve_fixed_grid_batched(pendulum_f, Tsit5(),
                                                       ui, pi, saveat)
        (yi * w[i]).sum().backward()
        ef = max(ef, max_err(ys[i].detach(), yi.detach()))
        eb = max(eb, max_err(u.grad[i], ui.grad), max_err(p.grad[i],
                                                          pi.grad))
        same = same and torch.equal(ys[i], yi) and torch.equal(ok[i], oki) \
            and torch.equal(u.grad[i], ui.grad) \
            and torch.equal(p.grad[i], pi.grad)
    log("kernels", f"rk_fixed_grid / rk_fixed_grid_bwd under torch.func.vmap "
                   f"over {S} replicas of B={B} rows, T={T}: launches "
                   f"(forward, backward) {n1} (expected (1, 1)); vs {S} solo "
                   f"launches: ys max abs err {ef:.3e}, gradients {eb:.3e}; "
                   f"bit for bit {same}")
    if not same:
        fail(f"RK solve under vmap differs from solo launches: {n1}, {ef}, "
             f"{eb}")
    return errs


def population_timing(ms, gen, clock, dev):
    """The replica-axis heads kernels at the main path's train shape (S 8,
    B 64, T 20): time per call and on the device beside the plain version
    over the same weight sets (torch.func.vmap of goku_heads_reference and
    of the plain sweep) and 8 solo launches, and the bound of S * B rows
    with S weight sets. Returns {name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)}; no one PyTorch call runs 8 weight sets, so library_ms is
    None. A bf16 population times the bf16 instances (``[pop8-bf16]``,
    the plain version the kernel's own forward, 2 bytes an element)."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc

    S, B, T = ms.n_seeds, 64, 20
    heads, params, wts = population_heads(ms)
    L, H = len(heads[0].cells), heads[0].cells[0].hidden_dim
    dtype = params[0].dtype
    bf16 = dtype == torch.bfloat16
    tag, elem = ("-bf16", 2) if bf16 else ("", 4)
    xs = torch.randn(S, B, T, 32, generator=gen, device=dev).to(dtype)
    gz = torch.randn(S, B, H, generator=gen, device=dev).to(dtype)
    gt = torch.randn(S, B, 2 * H, generator=gen, device=dev).to(dtype)
    solo_heads = [tuple(ms.seed_model(i).encoder.pattern_extractor)
                  for i in range(S)]
    out = {}
    with torch.no_grad():
        _, _, tape = rc.goku_heads_cuda(*heads, xs, tape=True, wts=wts)
        solo_tapes = [rc.goku_heads_cuda(*solo_heads[i], xs[i], tape=True)[2]
                      for i in range(S)]
        plain_fwd = population_plain(heads, params, (
            rc.goku_heads_taped_reference if bf16
            else rc.goku_heads_reference))
        plain_sweep = population_plain(heads, params,
                                       rc.goku_heads_sweep_reference)
        calls = {
            f"goku_heads[pop8{tag}]": (
                lambda: rc.goku_heads_cuda(*heads, xs, wts=wts),
                lambda: plain_fwd(xs),
                lambda: [rc.goku_heads_cuda(*solo_heads[i], xs[i])
                         for i in range(S)],
                "goku_heads_fwd_kernel", heads_work(B, T, 32, H, L, S,
                                                    elem=elem)),
            f"goku_heads_bwd[pop8{tag}]": (
                lambda: rc.goku_heads_bwd_cuda(*heads, tape, gz, gt,
                                               wts=wts),
                lambda: plain_sweep(tape, gz, gt),
                lambda: [rc.goku_heads_bwd_cuda(*solo_heads[i],
                                                solo_tapes[i], gz[i], gt[i])
                         for i in range(S)],
                "goku_heads_bwd_kernel", heads_bwd_work(B, T, 32, H, L, S,
                                                        elem=elem)),
        }
        for name, (kernel, plain, solo, kname, work) in calls.items():
            k_ms = time_ms(kernel)
            d_ms = device_ms(kernel, kname)
            s_ms = time_ms(solo)
            p_ms = plain_ms(plain)
            b_ms, b_by, t_b, t_o = bound_ms(*work)
            lat = (heads_bwd_latency_ms(T, L, H, clock) if "bwd" in name
                   else heads_latency_ms(T, L, 32, H, clock))
            log("timing", f"{name} S={S} B={B} T={T}: kernel {k_ms:.4f} ms "
                          f"per call ({fmt_ms(d_ms)} on the device), {S} "
                          f"solo launches {s_ms:.4f} ms, plain (vmapped over "
                          f"the weight sets) {p_ms:.4f} ms, bound "
                          f"{b_ms:.6f} ms ({b_by}; bytes {t_b:.6f} ms, "
                          f"operations {t_o:.6f} ms), latency model "
                          f"{lat:.6f} ms at {clock:.0f} MHz; library: none, "
                          f"no one PyTorch call runs {S} weight sets")
            out[name] = (k_ms, p_ms, b_ms, b_by, None)
    return out


def autosize_check(trained, train_set, dev, gpu):
    """One forward of the adaptive SPendulum GOKU (ADAPTIVE_SDE, the trained
    weights; B 64, T 50) before and after Trainer.autosize_adaptive_budget
    probes the training set: the sized budget and depth cap, each
    forward's time and device ops, and, where no row of the forward
    reaches the new caps (per-row depth and attempts from the same solve),
    the two outputs must be equal."""
    from latentdiffeq_torch import random as jr
    from latentdiffeq_torch.solve.sde import solve_sde_adaptive
    from latentdiffeq_torch.train import TrainConfig, Trainer

    model = adaptive_spendulum(trained, dev)
    data = train_set[:64, :50]
    before = adaptive_forward(model, data, dev)
    old = model.decoder.diffeq.adaptive_cfg
    tr = Trainer(model, TrainConfig(save_best=False, mask_failures=True,
                                    jit_epoch=False),
                 device=dev)
    t0 = time.perf_counter()
    sized = tr.autosize_adaptive_budget(train_set)
    probe_s = time.perf_counter() - t0
    new = model.decoder.diffeq.adaptive_cfg
    after = adaptive_forward(model, data, dev)
    de = model.decoder.diffeq
    t = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    with torch.no_grad():
        mu, _ = model.encoder(data)
        z0, th = model.model_type.apply_latent_out(model.decoder, mu)
        keys = jr.split(jr.PRNGKey(3, device=dev), 64)
        _, _, st = solve_sde_adaptive(de.f, de.g, de.solver, z0, th, t, keys,
                                      old)
    attempts = st["n_accepted"] + st["n_rejected"]
    reach = int(((st["max_depth"] >= new.depth_cap)
                 | (attempts > new.max_steps)).sum())
    e = max_err(before[3], after[3])
    for tag, (ms_, (n_ops, lost), aux, _), cfg in (("before", before, old),
                                                  ("after", after, new)):
        log("train", f"autosize: adaptive spendulum forward {tag} (B 64, T "
                     f"50, max_steps {cfg.max_steps}, depth_cap "
                     f"{cfg.depth_cap}, max_steps_per_interval "
                     f"{cfg.max_steps_per_interval}, no_grad): {ms_:.3f} ms "
                     f"(median of 3 after a warm-up), {n_ops} device ops "
                     f"({lost_str(lost)}); "
                     f"stats {({k: int(v) for k, v in aux['stats'].items()})}"
                     f", all ok {bool(aux['success'].all())}; card {gpu}")
    log("train", f"autosize: probe of {train_set.shape[0]} training rows "
                 f"(first 64, T 50) in {probe_s:.3f} s sized max_steps "
                 f"{sized}, depth_cap {old.depth_cap} -> {new.depth_cap}; "
                 f"forward's rows per-row max depth "
                 f"{int(st['max_depth'].max())}, attempts "
                 f"{int(attempts.max())}; rows reaching the new caps {reach}"
                 f"; x_hat before vs after max abs err {e:.3e}")
    if sized is None or (reach == 0 and e != 0.0):
        fail(f"autosize: sized {sized}, rows at the cap {reach}, outputs "
             f"differ by {e}")


def population_path(train_set, val_set, sde_model, dev, gpu, gen,
                    dtype=torch.float32):
    """Phase 4g: full-width GOKU on the pendulum video as a population of
    8 seeds (333-340), both kernel switches on, train_goku.py --seeds 8:
    one masked-curriculum epoch (it trains the sliced windows: a sliced
    epoch's launches, and the main path's first epoch), then the main path,
    MultiSeedTrainer.fit for 2 epochs of the sliced curriculum (windows of
    20 frames), which must launch each kernel as often as a solo Trainer
    of seed 336 does (one launch a call for all 8 replicas) and call no
    plain version; replica 3 against that solo Trainer (rtol 2e-4); the
    replica-axis kernels against solo launches bit for bit; the kernel
    route against the plain route on the trained population; select by
    the pixel score; save_replica into a Trainer; the population and solo
    step and validation times and device ops; the autosize probe on the
    adaptive SPendulum. With ``dtype`` bfloat16 (phase 4h, the recipe of
    ttg_bf16_px_winner.npz) the replicas are bf16 GOKUs and run the heads
    kernels' bf16 instances: every heads launch must be a bf16 one, replica
    3 is held to its solo Trainer at BF16_POP_RTOL, the kernel checks and
    the kernel-vs-plain route by bf16_gate; no autosize probe. Returns
    (launches, errors, the trainer)."""
    import dataclasses
    import tempfile

    import numpy as np

    from latentdiffeq_torch import pixel_observable as px
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.pendulum import Pendulum
    from latentdiffeq_torch.train import (MultiSeedTrainer, StackedModels,
                                          TrainConfig, Trainer, selectors)

    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))

    bf16 = dtype == torch.bfloat16
    what = "bf16 population" if bf16 else "population"

    def init(seed):
        return LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
            *goku_default_layers(784, diffeq, generator=torch.Generator()
                                 .manual_seed(seed), device=dev,
                                 dtype=dtype))

    cfg = TrainConfig(jit_epoch=False, epochs=1500, save_best=False,
                      progressive_training=True,
                      start_seq_len=20, prog_training_duration=300)
    steps = train_set.shape[0] // cfg.batch_size
    heads_fwd = recurrent_cuda.goku_heads_cuda
    heads_bwd = recurrent_cuda.goku_heads_bwd_cuda
    rk_fwd = ode_cuda.solve_fixed_grid_batched_cuda
    rk_bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda

    def counts():
        return {"goku_heads": heads_fwd.launches,
                "goku_heads_bwd": heads_bwd.launches,
                "rk_fixed_grid": sum(rk_fwd.launches.values()),
                "rk_fixed_grid_bwd": sum(rk_bwd.launches.values()),
                "bf16 heads": (heads_fwd.bf16_launches,
                               heads_bwd.bf16_launches),
                "plain": recurrent_cuda.goku_heads_reference.calls
                + ode_cuda.solve_fixed_grid_batched_reference.calls}

    # one masked-curriculum epoch: the sliced windows, as the main path's
    # first epoch
    masked = MultiSeedTrainer(init, dataclasses.replace(
        cfg, masked_curriculum=True), POP_SEEDS, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    hist = masked.fit(train_set, val_set, epochs=1, verbose=False)
    torch.cuda.synchronize()
    got = counts()
    want = {"goku_heads": 2 * steps, "goku_heads_bwd": steps,
            "rk_fixed_grid": 2 * steps, "rk_fixed_grid_bwd": steps,
            "bf16 heads": (2 * steps, steps) if bf16 else (0, 0),
            "plain": 0}
    masked_vals = hist[0]["val_loss"]
    log("train", f"{what} masked curriculum: 1 epoch x {steps} steps of "
                 f"{len(POP_SEEDS)} seeds (windows of {hist[0]['seq_len']} "
                 f"frames) in {time.perf_counter() - t0:.3f} s; val loss per "
                 f"seed {[round(float(v), 6) for v in masked_vals]}; launches "
                 f"{got} (expected {want}: a sliced epoch's)")
    if got != want or not np.isfinite(masked_vals).all():
        fail(f"{what} masked epoch: {got}, expected {want}; "
             f"{masked_vals}")
    del masked

    # the main path
    ms = MultiSeedTrainer(init, cfg, POP_SEEDS, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = ms.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counts()
    for rec in hist:
        log("train", f"{what} epoch {rec['epoch']} (seq_len "
                     f"{rec['seq_len']}): train loss per seed "
                     f"{[round(float(v), 6) for v in rec['train_loss']]}, "
                     f"val loss {[round(float(v), 6) for v in rec['val_loss']]}"
                     f" {rec['epoch_s']:.4f} s")
        if not (np.isfinite(rec["train_loss"]).all()
                and np.isfinite(rec["val_loss"]).all()):
            fail(f"{what}: non-finite loss in epoch {rec['epoch']}")

    rel = float(np.abs(masked_vals - hist[0]["val_loss"]).max()
                / np.abs(hist[0]["val_loss"]).max())
    log("train", f"{what} masked epoch vs the main path's first epoch: "
                 f"val losses max rel err {rel:.3e} (tol {MASKED_RTOL:.0e})")
    if not rel <= MASKED_RTOL:
        fail(f"{what} masked epoch vs sliced epoch 0: {rel}")

    # replica 3 against a solo Trainer of seed 336
    i = POP_SEEDS.index(336)
    solo = Trainer(init(336), dataclasses.replace(cfg, seed=336), device=dev)
    reset_counts()
    t1 = time.perf_counter()
    shist = solo.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t1
    solo_launches = counts()
    pop_v = np.array([float(r["val_loss"][i]) for r in hist])
    solo_v = np.array([r["val_loss"] for r in shist])
    rel = float(np.abs(pop_v - solo_v).max() / np.abs(solo_v).max())
    rtol = BF16_POP_RTOL if bf16 else POP_RTOL
    log("train", f"{what} fit 2 epochs x {steps} steps of "
                 f"{len(POP_SEEDS)} seeds in {fit_s:.3f} s, solo Trainer of "
                 f"seed 336 in {solo_s:.3f} s; launches population "
                 f"{launches}, solo {solo_launches} (must be equal; plain "
                 f"calls 0); replica {i} (seed 336) val losses "
                 f"{pop_v.tolist()} vs solo {solo_v.tolist()}: max rel err "
                 f"{rel:.3e} (tol {rtol:.1e})")
    if launches != solo_launches or launches["plain"] != 0:
        fail(f"{what} launches {launches} != solo {solo_launches}")
    if not rel <= rtol:
        fail(f"{what} replica {i} vs solo Trainer: {rel}")

    errs = population_kernel_checks(ms, gen, dev)

    # the kernel route against the plain route on the trained population
    plain = StackedModels(plain_copy(ms.base, GOKUBasic()), ms.params,
                          ms.buffers)
    t_val = torch.arange(val_set.shape[1], dtype=torch.float32,
                         device=dev) * cfg.dt
    reset_counts()
    xk = selectors.population_decode(ms.stacked_models, val_set, t_val)
    dec = counts()
    xp = selectors.population_decode(plain, val_set, t_val)
    e = max_err(xk.float(), xp.float())
    ok, tol_note = e <= PATH_TOL, f"tol {PATH_TOL:.0e}"
    if bf16:
        plain32 = StackedModels(
            plain_copy(ms.base, GOKUBasic()).float(),
            {k: v.float() for k, v in ms.params.items()}, ms.buffers)
        x32 = selectors.population_decode(plain32, val_set, t_val)
        ok, d_k, d_p, allow = bf16_gate(xk, xp, x32)
        tol_note = (f"bf16 gate: kernel route vs float32 {d_k:.3e}, plain "
                    f"bf16 route vs float32 {d_p:.3e}, allowed {allow:.3e}")
    log("train", f"trained {what}, kernel vs plain route on the val set "
                 f"(one vmapped forward each): x_hat {tuple(xk.shape)} max "
                 f"abs err {e:.3e} ({tol_note}); the kernel route's "
                 f"launches {dec}")
    if not (ok and bool(torch.isfinite(xk).all())
            and dec["goku_heads"] == 1 and dec["rk_fixed_grid"] == 1):
        fail(f"{what} kernel vs plain route: {e}, launches {dec}")

    # selection by the pixel score, and a replica checkpoint into a Trainer
    th_obs = px.pixel_angles(val_set)
    t0 = time.perf_counter()
    _, info = ms.select(lambda st: px.population_pixel_scores(
        st, val_set, th_obs, cfg.dt))
    sel_s = time.perf_counter() - t0
    log("train", f"{what} select by population_pixel_scores in "
                 f"{sel_s:.3f} s: winner seed {info['seed']} (index "
                 f"{info['index']}, from_best {info['from_best']}) score "
                 f"{info['score']:.6f}; live {info['scores_live']}, best "
                 f"{info['scores_best']}")
    if not math.isfinite(info["score"]):
        fail(f"{what} select: no finite winner {info}")
    j = info["index"]
    beta = float(hist[-1]["beta"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "replica.npz")
        ms.save_replica(path, j)
        tr = Trainer(init(ms.seeds[j]), cfg, device=dev)
        tr.restore(path)
    with torch.no_grad():
        v_restored = float(tr.val_step(val_set, beta)["loss"])
        v_module = float(Trainer(ms.best_seed_model(j), cfg,
                                 device=dev).val_step(val_set, beta)["loss"])
    e = abs(v_restored - v_module)
    log("train", f"save_replica(index {j}) -> Trainer.restore: val loss "
                 f"{v_restored:.6f} vs the replica's best weights "
                 f"{v_module:.6f} abs err {e:.3e} (tol {CKPT_TOL:.0e}); the "
                 f"population's recorded best val {ms.per_seed_best_vals[j]:.6f}")
    if not e <= CKPT_TOL:
        fail(f"save_replica round trip: {v_restored} vs {v_module}")

    # step and validation times at the full window (50 frames)
    xs = train_set[:cfg.batch_size, :cfg.seq_len]
    step_report(f"{what} (8 seeds)", ms,
                xs.unsqueeze(0).expand(len(POP_SEEDS), -1, -1,
                                       -1).contiguous(), val_set, beta, gpu)
    step_report(f"{what} solo seed 336", solo, xs, val_set, beta, gpu)
    if not bf16:
        autosize_check(sde_model, train_set, dev, gpu)
    return {k: v for k, v in launches.items()
            if k not in ("plain", "bf16 heads")}, errs, ms


# ---------------------------------------------------------------------------
# bfloat16 NN stages (train_goku.py --dtype bf16): the heads kernels' bf16
# instances, checked in phases 2 and 3, run on the main path in phase 4h.
# bf16 rounds at other places in the kernel (float32 gates, h and c rounded
# each step) and in PyTorch (its products, every operation of the plain
# route), so each bf16 gate holds the kernel's result against a float32
# evaluation of the same bf16 weights and inputs upcast (the plain float32
# version): the kernel may be at most twice as far from it as the plain
# bf16 version is, plus BF16_SLACK of its size (bf16_gate). Outputs, tape,
# dgates and each gradient are gated so.

BF = torch.bfloat16
BF16_SLACK = 2.0 ** -8
BF16_ELBO_RTOL = 1e-2      # goku_bf16_gate.npz's ELBO, card vs CPU
BF16_POP_RTOL = 2.0 ** -7  # replica vs solo Trainer: one bf16 step
BF16_CKPT = os.path.join("benchmarks", "artifacts", "goku_bf16_gate.npz")


def bf16_gate(k, p, f):
    """(ok, |k - f|, |p - f|, allowed) for the bf16 kernel's result ``k``,
    the plain bf16 version's ``p`` and the float32 evaluation ``f``."""
    f = f.float()
    d_k, d_p = max_err(k.float(), f), max_err(p.float(), f)
    allow = 2 * d_p + BF16_SLACK * float(f.abs().max())
    return d_k <= allow, d_k, d_p, allow


def as_dtype(heads, dtype):
    """Copies of the heads in ``dtype``."""
    return tuple(copy.deepcopy(h).to(dtype) for h in heads)


def weight_sets(heads, S, gen):
    """S weight sets of the heads' shapes and dtype: the heads' tensors plus
    N(0, 0.05^2), each (S, ...) in the order of _heads_params."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    return [(p.detach().float() + 0.05 * torch.randn(
        (S,) + tuple(p.shape), generator=gen, device=p.device)).to(p.dtype)
        for p in rc._heads_params(*heads)]


def goku_bf16_kernel_checks(heads, gen):
    """Phase 2 for the bf16 instances: the forward kernel and its
    tape-writing variant against the plain bf16 forward with its tape
    (goku_heads_taped_reference, rounding where the kernel rounds), by
    bf16_gate against the plain float32 forward on the upcast weights and
    inputs, at the train, validation and a ragged shape, with wide heads
    (the any-width kernel) and with S 8 weight sets in one launch. Returns
    {name: largest absolute error of the outputs, kernel vs plain bf16}."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    hb = as_dtype(heads, BF)
    errs = {"goku_heads[bf16]": 0.0}
    with torch.no_grad():
        for label, hs, (B, T), S in (
                ("train", hb, (64, 50), 1), ("val", hb, (45, 100), 1),
                ("ragged", hb, (37, 21), 1),
                (f"wide {WIDE_HEADS}", as_dtype(wide_heads(), BF), (64, 50),
                 1), ("S 8", hb, (64, 20), 8)):
            D = hs[0].cells[0].Wi.shape[0]
            h32 = as_dtype(hs, torch.float32)
            lead = (S,) if S > 1 else ()
            xs = torch.randn(lead + (B, T, D), generator=gen,
                             device="cuda").to(BF)
            if S == 1:
                z, th = rc.goku_heads_cuda(*hs, xs)
                zt, tht, tape = rc.goku_heads_cuda(*hs, xs, tape=True)
                ref = rc.goku_heads_taped_reference(*hs, xs)
                r32 = rc.goku_heads_taped_reference(*h32, xs.float())
            else:
                params = weight_sets(hs, S, gen)
                wts = rc.pack_goku_heads(*hs, params=params).float()
                z, th = rc.goku_heads_cuda(*hs, xs, wts=wts)
                zt, tht, tape = rc.goku_heads_cuda(*hs, xs, tape=True,
                                                   wts=wts)
                ref = population_plain(hs, params,
                                       rc.goku_heads_taped_reference)(xs)
                r32 = population_plain(
                    h32, [p.float() for p in params],
                    rc.goku_heads_taped_reference)(xs.float())
            same = torch.equal(z, zt) and torch.equal(th, tht)
            gates = [bf16_gate(k, p, f) for k, p, f in zip((z, th, tape),
                                                          ref, r32)]
            e = max(max_err(z.float(), ref[0].float()),
                    max_err(th.float(), ref[1].float()))
            if S == 1:
                errs["goku_heads[bf16]"] = max(errs["goku_heads[bf16]"], e)
            log("kernels", f"goku_heads[bf16] {label} B={B} T={T}"
                           f"{f' S={S}' if S > 1 else ''}: kernel vs plain "
                           f"bf16 max abs err {e:.3e}; vs float32 (z0, "
                           f"theta, tape): kernel "
                           f"{[f'{g[1]:.3e}' for g in gates]}, plain bf16 "
                           f"{[f'{g[2]:.3e}' for g in gates]}, allowed "
                           f"{[f'{g[3]:.3e}' for g in gates]}; tape-writing "
                           f"variant same outputs {same}; dtypes {z.dtype}, "
                           f"{tape.dtype}")
            if not (same and all(g[0] for g in gates)
                    and z.dtype == tape.dtype == BF):
                fail(f"goku_heads[bf16] {label}: {gates}, same {same}")
    return errs


def goku_bf16_grad_checks(heads, gen):
    """Phase 3 for the bf16 instances: the sweep kernel against the plain
    bf16 sweep on the same bf16 tape (dgates, dh0, dc0), by bf16_gate
    against the plain float32 sweep on that tape upcast, at the train and
    validation shapes, with wide heads and with S 8 weight sets; then the
    whole backward at the train shape (goku_heads on the card: the tape
    forward, the sweep, the bf16 products) against plain bf16 autograd
    (goku_heads_reference) and float32 autograd on the upcast weights, each
    gradient by bf16_gate. Returns {name: largest absolute error of the
    sweep, kernel vs plain bf16}."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    hb = as_dtype(heads, BF)
    errs = {"goku_heads_bwd[bf16]": 0.0}
    for label, hs, (B, T), S in (
            ("train", hb, (64, 50), 1), ("val", hb, (45, 100), 1),
            (f"wide {WIDE_HEADS}", as_dtype(wide_heads(), BF), (64, 50), 1),
            ("S 8", hb, (64, 20), 8)):
        D = hs[0].cells[0].Wi.shape[0]
        H = hs[0].cells[0].hidden_dim
        h32 = as_dtype(hs, torch.float32)
        lead = (S,) if S > 1 else ()
        xs = torch.randn(lead + (B, T, D), generator=gen,
                         device="cuda").to(BF)
        gz = torch.randn(lead + (B, H), generator=gen, device="cuda").to(BF)
        gt = torch.randn(lead + (B, 2 * H), generator=gen,
                         device="cuda").to(BF)
        with torch.no_grad():
            if S == 1:
                tape = rc.goku_heads_cuda(*hs, xs, tape=True)[2]
                got = rc.goku_heads_bwd_cuda(*hs, tape, gz, gt)
                ref = rc.goku_heads_sweep_reference(*hs, tape, gz, gt)
                r32 = rc.goku_heads_sweep_reference(
                    *h32, tape.float(), gz.float(), gt.float())
            else:
                params = weight_sets(hs, S, gen)
                wts = rc.pack_goku_heads(*hs, params=params).float()
                tape = rc.goku_heads_cuda(*hs, xs, tape=True, wts=wts)[2]
                got = rc.goku_heads_bwd_cuda(*hs, tape, gz, gt, wts=wts)
                ref = population_plain(hs, params,
                                       rc.goku_heads_sweep_reference)(
                    tape, gz, gt)
                r32 = population_plain(
                    h32, [p.float() for p in params],
                    rc.goku_heads_sweep_reference)(tape.float(), gz.float(),
                                                   gt.float())
        gates = [bf16_gate(k, p, f) for k, p, f in zip(got, ref, r32)]
        e = max(max_err(a.float(), b.float()) for a, b in zip(got, ref))
        if S == 1:
            errs["goku_heads_bwd[bf16]"] = max(errs["goku_heads_bwd[bf16]"],
                                               e)
        line = (f"goku_heads_bwd[bf16] {label} B={B} T={T}"
                f"{f' S={S}' if S > 1 else ''}: sweep on the same bf16 tape"
                f", kernel vs plain bf16 max abs err {e:.3e}; vs float32 "
                f"(dgates, dh0, dc0): kernel "
                f"{[f'{g[1]:.3e}' for g in gates]}, plain bf16 "
                f"{[f'{g[2]:.3e}' for g in gates]}, allowed "
                f"{[f'{g[3]:.3e}' for g in gates]}")
        ok = all(g[0] for g in gates) and got[0].dtype == BF
        if label == "train":
            params = rc._heads_params(*hs)

            def grads(fn, heads_, x, g):
                x = x.clone().requires_grad_()
                z, th = fn(*heads_, x)
                return torch.autograd.grad(
                    (z, th), [x] + rc._heads_params(*heads_), g)

            k = grads(rc.goku_heads, hs, xs, (gz, gt))
            p = grads(rc.goku_heads_reference, hs, xs, (gz, gt))
            f = grads(rc.goku_heads_reference, h32, xs.float(),
                      (gz.float(), gt.float()))
            wg = [bf16_gate(a, b, c) for a, b, c in zip(k, p, f)]
            worst = max(wg, key=lambda g: g[1] / max(g[3], 1e-30))
            line += (f"; whole backward, {len(wg)} gradients in "
                     f"{k[1].dtype}: by bf16_gate all ok "
                     f"{all(g[0] for g in wg)}, the closest to its limit "
                     f"kernel {worst[1]:.3e} plain bf16 {worst[2]:.3e} "
                     f"allowed {worst[3]:.3e}")
            ok = ok and all(g[0] for g in wg) and all(
                a.dtype == b.dtype for a, b in zip(k[1:], params))
        log("grads", line)
        if not ok:
            fail(f"goku_heads_bwd[bf16] {label}: {line}")
    return errs


def population_bf16_kernel_checks(ms, heads, params, wts, gen, dev):
    """population_kernel_checks for a bf16 population: the replica-axis
    bf16 forward with its tape and sweep against the plain bf16 versions
    vmapped over the 8 weight sets, by bf16_gate against the plain float32
    versions over the upcast sets, and against 8 solo launches bit for
    bit."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    S, B, T = ms.n_seeds, 64, 20
    h32 = as_dtype(heads, torch.float32)
    p32 = [p.float() for p in params]
    xs = torch.randn(S, B, T, 32, generator=gen, device=dev).to(BF)
    gz = torch.randn(S, B, 16, generator=gen, device=dev).to(BF)
    gt = torch.randn(S, B, 32, generator=gen, device=dev).to(BF)
    with torch.no_grad():
        z, th, tape = rc.goku_heads_cuda(*heads, xs, tape=True, wts=wts)
        sw = rc.goku_heads_bwd_cuda(*heads, tape, gz, gt, wts=wts)
        fwd_p = population_plain(heads, params,
                                 rc.goku_heads_taped_reference)(xs)
        fwd_f = population_plain(h32, p32, rc.goku_heads_taped_reference)(
            xs.float())
        sw_p = population_plain(heads, params, rc.goku_heads_sweep_reference)(
            tape, gz, gt)
        sw_f = population_plain(h32, p32, rc.goku_heads_sweep_reference)(
            tape.float(), gz.float(), gt.float())
        same = True
        for i in range(S):
            hs = tuple(ms.seed_model(i).encoder.pattern_extractor)
            zs, ths, tps = rc.goku_heads_cuda(*hs, xs[i], tape=True)
            solo = rc.goku_heads_bwd_cuda(*hs, tps, gz[i], gt[i])
            same = same and all(torch.equal(a, b) for a, b in zip(
                (z[i], th[i], tape[i]) + tuple(a[i] for a in sw),
                (zs, ths, tps) + solo))
    gf = [bf16_gate(k, p, f) for k, p, f in zip((z, th, tape), fwd_p, fwd_f)]
    gb = [bf16_gate(k, p, f) for k, p, f in zip(sw, sw_p, sw_f)]
    ef = max(max_err(a.float(), b.float()) for a, b in zip((z, th),
                                                           fwd_p[:2]))
    eb = max(max_err(a.float(), b.float()) for a, b in zip(sw, sw_p))
    log("kernels", f"goku_heads[bf16] / goku_heads_bwd[bf16] at S={S} "
                   f"(B={B}, T={T}, one launch each) vs the plain bf16 "
                   f"versions vmapped over the replicas' weights: outputs "
                   f"max abs err {ef:.3e}, sweep {eb:.3e}; bf16 gate vs "
                   f"float32 (z0, theta, tape; dgates, dh0, dc0): kernel "
                   f"{[f'{g[1]:.3e}' for g in gf + gb]}, plain bf16 "
                   f"{[f'{g[2]:.3e}' for g in gf + gb]}, allowed "
                   f"{[f'{g[3]:.3e}' for g in gf + gb]}; vs {S} solo "
                   f"launches bit for bit {same}")
    if not all(g[0] for g in gf + gb):
        fail(f"goku_heads[bf16] population launch: {gf} {gb}")
    if not same:
        fail("goku_heads[bf16] population launch differs from solo launches")
    return {"goku_heads[pop8-bf16]": ef, "goku_heads_bwd[pop8-bf16]": eb}


def bf16_solo_path(train_set, val_set, dev, gpu):
    """Phase 4h, solo: full-width GOKU with bf16 NN stages
    (goku_default_layers(..., dtype=torch.bfloat16), weights from seed 333)
    and both kernel switches. First the first step's ELBO and every
    gradient, kernel route against the plain bf16 route and the float32
    route on the upcast weights, same bf16 eps, by bf16_gate; then
    Trainer.fit for 2 epochs (6 steps each, validation after every step),
    which must launch the bf16 heads instances 24 / 12 times and the
    float32 RK kernel 24 / 12 times (through GOKU's casts), with no plain
    call; the ELBO of goku_bf16_gate.npz on the validation set card vs CPU
    (bf16 both, same eps) within BF16_ELBO_RTOL; step, validation and
    device ops beside the float32 pendulum step of phase 4. Returns (the
    launches, the trainer, its batch, beta)."""
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.pendulum import Pendulum
    from latentdiffeq_torch.train import (TrainConfig, Trainer,
                                          load_checkpoint, loss_batch)

    what = "bf16 pendulum"
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    cfg = TrainConfig(jit_epoch=False, epochs=1500, save_best=False)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(784, diffeq, generator=torch.Generator()
                             .manual_seed(333), device=dev, dtype=BF))
    t50 = torch.arange(cfg.seq_len, dtype=torch.float32,
                       device=dev) * cfg.dt
    x = train_set[:cfg.batch_size, :cfg.seq_len]
    g = torch.Generator(device=dev).manual_seed(5)
    eps = tuple(torch.randn(cfg.batch_size, 16, generator=g, device=dev,
                            dtype=BF) for _ in range(2))

    def elbo_grads(m):
        m.zero_grad()
        loss = loss_batch(m, x, t50, 0.5, eps=tuple(
            e.to(next(m.parameters()).dtype) for e in eps))[0]
        loss.backward()
        return loss.detach(), [p.grad.detach() for p in m.parameters()]

    plain = plain_copy(model, GOKUBasic())
    f32 = plain_copy(model, GOKUBasic()).float()
    lk, gk = elbo_grads(model)
    lp, gp = elbo_grads(plain)
    lf, gf = elbo_grads(f32)
    model.zero_grad()
    lg = bf16_gate(lk.reshape(1), lp.reshape(1), lf.reshape(1))
    wg = [bf16_gate(a, b, c) for a, b, c in zip(gk, gp, gf)]
    worst = max(wg, key=lambda v: v[1] / max(v[3], 1e-30))
    log("train", f"{what} first step (B 64, T 50, beta 0.5, same bf16 eps): "
                 f"ELBO kernel route {float(lk):.6f}, plain bf16 route "
                 f"{float(lp):.6f}, float32 route {float(lf):.6f} (bf16 "
                 f"gate ok {lg[0]}); {len(wg)} gradients in "
                 f"{gk[0].dtype}, by bf16_gate all ok "
                 f"{all(v[0] for v in wg)}, the closest to its limit: "
                 f"kernel {worst[1]:.3e} plain bf16 {worst[2]:.3e} allowed "
                 f"{worst[3]:.3e}")
    if not (lg[0] and all(v[0] for v in wg) and math.isfinite(float(lk))
            and all(a.dtype == BF for a in gk)):
        fail(f"{what} first step kernel vs plain route: {lg} {wg}")

    trainer = Trainer(model, cfg, device=dev)
    heads_f = recurrent_cuda.goku_heads_cuda
    heads_b = recurrent_cuda.goku_heads_bwd_cuda
    rk_f = ode_cuda.solve_fixed_grid_batched_cuda
    rk_b = ode_cuda.solve_fixed_grid_batched_bwd_cuda
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.fit(train_set, val_set, epochs=2, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = train_set.shape[0] // cfg.batch_size
    launches = {"goku_heads[bf16]": heads_f.bf16_launches,
                "goku_heads_bwd[bf16]": heads_b.bf16_launches,
                "goku_heads (all dtypes)": heads_f.launches,
                "goku_heads_bwd (all dtypes)": heads_b.launches,
                "rk_fixed_grid": rk_f.launches.get(
                    ode_cuda.rhs_instance(diffeq.f, diffeq.z_dim), 0),
                "rk_fixed_grid_bwd": rk_b.launches.get(
                    ode_cuda.rhs_instance(diffeq.f, diffeq.z_dim), 0)}
    plain_calls = [recurrent_cuda.goku_heads_reference.calls,
                   ode_cuda.solve_fixed_grid_batched_reference.calls]
    expected = {k: (2 * steps if "bwd" in k else 4 * steps)
                for k in launches}
    log_epochs(what, hist)
    log("train", f"{what} fit 2 epochs x {steps} steps in {fit_s:.3f} s; "
                 f"kernel launches {launches} (expected {expected}); calls "
                 f"of the plain goku_heads / RK solve: {plain_calls} "
                 f"(expected [0, 0])")
    if launches != expected or plain_calls != [0, 0]:
        fail(f"{what} path launched {launches}, plain {plain_calls}")

    # the ELBO of the committed bf16 checkpoint, card against CPU
    here = os.path.dirname(os.path.abspath(__file__))
    winner = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(784, diffeq, device=dev, dtype=BF))
    load_checkpoint(os.path.join(here, BF16_CKPT), winner)
    winner_cpu = plain_copy(winner, GOKUBasic()).cpu()
    t_val = torch.arange(val_set.shape[1], dtype=torch.float32,
                         device=dev) * cfg.dt
    ev = tuple(torch.randn(val_set.shape[0], 16, generator=g, device=dev,
                           dtype=BF) for _ in range(2))
    with torch.no_grad():
        elbo = float(loss_batch(winner, val_set, t_val, 1.0, eps=ev)[0])
        elbo_cpu = float(loss_batch(winner_cpu, val_set.cpu(), t_val.cpu(),
                                    1.0, eps=tuple(e.cpu() for e in ev))[0])
    rel = abs(elbo - elbo_cpu) / abs(elbo_cpu)
    log("train", f"goku_bf16_gate.npz ELBO (beta 1) on the "
                 f"{val_set.shape[0]} validation rows, same bf16 eps: card "
                 f"(kernels) {elbo:.6f} CPU (plain) {elbo_cpu:.6f} rel err "
                 f"{rel:.3e} (tol {BF16_ELBO_RTOL:.0e})")
    if not (math.isfinite(elbo) and rel <= BF16_ELBO_RTOL):
        fail(f"{what} checkpoint ELBO card vs CPU: {elbo} vs {elbo_cpu}")

    beta = float(hist[-1]["beta"])
    step_report(what, trainer, x, val_set, beta, gpu)
    b, f = STEP_REPORTS[what], STEP_REPORTS.get("pendulum")
    if f is not None:
        log("train", f"bf16 vs float32 pendulum step on this card: train "
                     f"step {b[0]:.3f} vs {f[0]:.3f} ms, val pass "
                     f"{b[1]:.3f} vs {f[1]:.3f} ms, device ops {b[2]} vs "
                     f"{f[2]}, device busy {b[3]:.3f} vs {f[3]:.3f} ms")
    return ({k: v for k, v in launches.items() if "[bf16]" in k}, trainer,
            x, beta)


# ---------------------------------------------------------------------------
# Phase 4j: the training CLIs (latentdiffeq_torch/examples/), each script's
# main(argv) called in this process so that the launch counters can be read;
# outputs under build/cli_smoke/ (the pendulum cache seeded with phase 4's
# video: it is not generated twice).

CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "cli_smoke")


def cli_counts():
    """Every kernel counter and the plain versions' calls, the RK
    launchers' as {instance family: launches}."""
    from latentdiffeq_torch.ops import node_cuda, ode_cuda, recurrent_cuda
    fam = {}
    for key, fn in (("rk_fixed_grid", ode_cuda.solve_fixed_grid_batched_cuda),
                    ("rk_fixed_grid_bwd",
                     ode_cuda.solve_fixed_grid_batched_bwd_cuda)):
        for inst, n in fn.launches.items():
            f = ("pendulum" if inst.startswith("pendulum") else
                 "kuramoto10" if inst.startswith("kuramoto") else inst)
            fam[f"{key}[{f}]"] = fam.get(f"{key}[{f}]", 0) + n
    fam.update({
        "goku_heads": recurrent_cuda.goku_heads_cuda.launches,
        "goku_heads_bwd": recurrent_cuda.goku_heads_bwd_cuda.launches,
        "goku_heads[bf16]": recurrent_cuda.goku_heads_cuda.bf16_launches,
        "goku_heads_bwd[bf16]":
            recurrent_cuda.goku_heads_bwd_cuda.bf16_launches,
        "node_field_fwd": node_cuda.solve_neural_field_cuda.launches,
        "node_field_bwd": node_cuda.neural_field_sweep_cuda.launches,
        "node_field_dw": node_cuda.neural_field_dw_cuda.launches})
    return {k: v for k, v in fam.items() if v}


def cli_run(what, mod, argv, want, gpu):
    """``mod.main(argv)`` with every counter at 0: the launches must equal
    ``want`` (kernel counts not named there 0), no plain version may run
    and every loss must be finite. Returns (result, steady epoch s)."""
    import numpy as np

    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    reset_counts()
    t0 = time.perf_counter()
    with plain_node_calls() as plain:
        res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = cli_counts()
    plain_calls = [recurrent_cuda.goku_heads_reference.calls,
                   ode_cuda.solve_fixed_grid_batched_reference.calls,
                   plain.n]
    hist = getattr(res, "history", None) or []
    for rec in hist:
        if not (np.isfinite(rec["train_loss"]).all()
                and np.isfinite(rec["val_loss"]).all()):
            fail(f"{what}: non-finite loss in epoch {rec['epoch']}")
    epoch_s = hist[-1]["epoch_s"] if hist else float("nan")
    log("cli", f"{what}: {' '.join(argv)}; {len(hist)} epochs in {wall:.3f} "
               f"s, steady epoch {epoch_s:.4f} s; last train loss "
               f"{np.round(hist[-1]['train_loss'], 6) if hist else None} val "
               f"{np.round(hist[-1]['val_loss'], 6) if hist else None}; "
               f"launches {got} (expected {want}); plain calls {plain_calls} "
               f"(expected [0, 0, 0]); card {gpu}")
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    if plain_calls != [0, 0, 0]:
        fail(f"{what}: the plain version ran: {plain_calls}")
    return res, epoch_s


def cli_path(video, dev, gpu):
    """Phase 4j: the port's training CLIs on the card through their
    ``main(argv)``: train_goku.py (2 epochs with its figures; a run
    interrupted after 2 of 3 epochs and resumed from its checkpoint by
    --resume against the uninterrupted 3 epochs, within PATH_TOL; the
    population recipe --seeds 2 --masked --select-by pixel --warm-start
    --warm-steps 20; --dtype bf16), train_latent_ode.py --pallas-solve,
    train_vdp.py, train_kuramoto.py, forecast.py on the checkpoint just
    written and train_original_data.py on a small npz of the documented
    shape. Each run's kernel launches exactly as expected, no plain
    version, finite losses; its steady epoch seconds. Returns ({run: steady
    epoch s}, the Trainer of train_goku.py --epochs 2)."""
    import shutil

    import numpy as np

    from latentdiffeq_torch.examples.custom_dynamics import (
        train_kuramoto, train_vdp)
    from latentdiffeq_torch.examples.pendulum import (
        create_data, forecast, train_goku, train_latent_ode,
        train_original_data)
    from latentdiffeq_torch.train import Trainer, load_checkpoint

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    create_data.DATA_DIR = os.path.join(CLI_DIR, "data")
    t0 = time.perf_counter()
    create_data.write_cache(
        os.path.join(create_data.DATA_DIR, create_data.DEFAULT_FILE), video,
        create_data.cache_key(device=dev))

    def no_generation(**kw):
        fail("the CLI phase regenerated the pendulum video")

    create_data.generate_dataset = no_generation
    log("cli", f"pendulum cache seeded with phase 4's video in "
               f"{time.perf_counter() - t0:.3f} s "
               f"({create_data.DATA_DIR})")
    steps = 405 // 64
    times = {}

    def out(mod, name):
        mod.OUTPUT_DIR = os.path.join(CLI_DIR, name)
        return mod.OUTPUT_DIR

    def goku(fwd, bwd, rk_fwd, rk_bwd, bf16=False, rk="pendulum"):
        w = {"goku_heads": fwd, "goku_heads_bwd": bwd,
             f"rk_fixed_grid[{rk}]": rk_fwd,
             f"rk_fixed_grid_bwd[{rk}]": rk_bwd}
        if bf16:
            w.update({"goku_heads[bf16]": fwd, "goku_heads_bwd[bf16]": bwd})
        return w

    # train_goku.py, 2 epochs with its figures (JAX's block ends: epoch 1):
    # a step launches the heads and the RK solve forward and backward, a
    # validation pass and the figure each forward
    d = out(train_goku, "goku")
    tr, times["train_goku"] = cli_run(
        "train_goku", train_goku, ["--epochs", "2"],
        goku(4 * steps + 1, 2 * steps, 4 * steps + 1, 2 * steps), gpu)
    fig = os.path.join(d, "visualization", "fig_1.png")
    ckpt = os.path.join(d, "best_model.npz")
    if not (os.path.exists(fig) and os.path.exists(ckpt)):
        fail(f"train_goku wrote no {fig} or {ckpt}")
    log("cli", f"train_goku wrote {ckpt} and {fig} "
               f"({os.path.getsize(fig)} bytes)")

    # --resume: 3 epochs straight against a 3-epoch run interrupted after 2
    # (the KL schedule spans --epochs) and resumed from its checkpoint
    out(train_goku, "goku3")
    full, _ = cli_run("train_goku 3 epochs", train_goku,
                      ["--epochs", "3", "--no-viz"],
                      goku(6 * steps, 3 * steps, 6 * steps, 3 * steps), gpu)

    class Interrupted(Trainer):
        def fit(self, *args, **kw):
            return super().fit(*args, epochs=2, **kw)

    d_int = out(train_goku, "goku_interrupted")
    train_goku.Trainer = Interrupted
    try:
        cli_run("train_goku interrupted after 2 of 3 epochs", train_goku,
                ["--epochs", "3", "--no-viz"],
                goku(4 * steps, 2 * steps, 4 * steps, 2 * steps), gpu)
    finally:
        train_goku.Trainer = Trainer
    mid = os.path.join(d_int, "best_model.npz")
    e0 = int(load_checkpoint(mid, copy.deepcopy(full.model))["epoch"])
    out(train_goku, "goku_resumed")
    back, _ = cli_run(
        "train_goku --resume", train_goku,
        ["--epochs", "3", "--no-viz", "--resume", mid],
        goku(2 * steps * (3 - e0), steps * (3 - e0),
             2 * steps * (3 - e0), steps * (3 - e0)), gpu)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(full.model.state_dict().values(),
                   back.model.state_dict().values()))
    log("cli", f"--resume from the checkpoint of epoch {e0} to epoch 3 "
               f"against 3 epochs straight: weights max |difference| "
               f"{diff:.3e} (gate {PATH_TOL:.0e}); "
               f"{'bit for bit' if diff == 0 else 'not bit for bit'}")
    if not diff <= PATH_TOL:
        fail(f"--resume: weights {diff} from the uninterrupted run's")

    # the recipe flags: a population of 2 (the heads and RK kernels once a
    # call for both replicas): warm start 20 steps (the heads forward with
    # its tape and backward), 2 epochs, the pixel selection's decodes of
    # the live and best weights
    out(train_goku, "goku_pop2")
    ms, times["train_goku --seeds 2"] = cli_run(
        "train_goku --seeds 2", train_goku,
        ["--seeds", "2", "--masked", "--select-by", "pixel", "--warm-start",
         "--warm-steps", "20", "--epochs", "2"],
        goku(20 + 4 * steps + 2, 20 + 2 * steps, 4 * steps + 2, 2 * steps),
        gpu)
    d = out(train_goku, "goku_bf16")
    _, times["train_goku --dtype bf16"] = cli_run(
        "train_goku --dtype bf16", train_goku, ["--dtype", "bf16",
                                                "--epochs", "2"],
        goku(4 * steps + 1, 2 * steps, 4 * steps + 1, 2 * steps, bf16=True),
        gpu)

    out(train_latent_ode, "latent_ode")
    _, times["train_latent_ode --pallas-solve"] = cli_run(
        "train_latent_ode --pallas-solve", train_latent_ode,
        ["--pallas-solve", "--epochs", "2"],
        {"node_field_fwd": 4 * steps, "node_field_bwd": 2 * steps,
         "node_field_dw": 2 * steps}, gpu)

    c_steps = 230 // 64
    for name, mod, rk in (("train_vdp", train_vdp, "vdp"),
                          ("train_kuramoto", train_kuramoto, "kuramoto10")):
        out(mod, name)
        _, times[name] = cli_run(
            name, mod, ["--epochs", "2"],
            goku(4 * c_steps, 2 * c_steps, 4 * c_steps, 2 * c_steps, rk=rk),
            gpu)

    forecast.OUTPUT_DIR = os.path.join(CLI_DIR, "goku")
    t1 = time.perf_counter()
    reset_counts()
    res = forecast.main([])
    torch.cuda.synchronize()
    got = cli_counts()
    want = goku(1, 0, 1, 0)
    del want["goku_heads_bwd"], want["rk_fixed_grid_bwd[pendulum]"]
    log("cli", f"forecast.py on {ckpt}: inside {res['inside']:.6f} beyond "
               f"{res['beyond']:.6f} in {time.perf_counter() - t1:.3f} s; "
               f"launches {got} (expected {want})")
    if got != want or not np.isfinite(res["err"]).all():
        fail(f"forecast: launches {got}, errors {res['err'][:4]}")

    os.makedirs("chiprun_out", exist_ok=True)
    orig = os.path.join("chiprun_out", "original_data_small.npz")
    np.savez_compressed(orig, train_data=video[3][:72, :60].cpu().numpy())
    out(train_original_data, "original")
    o_steps = int(72 * 0.9) // 64
    _, times["train_original_data"] = cli_run(
        "train_original_data", train_original_data,
        ["--data", orig, "--epochs", "2"],
        goku(4 * o_steps, 2 * o_steps, 4 * o_steps, 2 * o_steps), gpu)
    log("cli", f"steady epoch seconds {json.dumps(times)}; card {gpu}")
    return times, tr


# ---------------------------------------------------------------------------
# Phase 4n: block mode (TrainConfig.jit_epoch, epochs_per_dispatch; the
# Trainer's and MultiSeedTrainer's default): make_block_fn's epochs as CUDA
# graphs, replayed with no host read inside a block, the best tracked on the
# device, against the per-step loop (jit_epoch=False) from the same seeds:
# full-width GOKU and LatentODE, GOKU on the stochastic pendulum (SRA1 on
# the grid), the adaptive pendulum and adaptive SPendulum (whole step
# budgets in the captured epochs), and the populations of 8 GOKU (float32
# and bf16), 4 LatentODE and 4 SPendulum seeds.

BLOCK_E = 3         # epochs a block
BLOCK_N = 2         # blocks held against the per-step loop before the window
# block_parts' paths that run before phase 5, and those that run last
BLOCK_FIRST = ("GOKU", "LatentODE")
BLOCK_LAST = ("(a) SDE GOKU", "(b) adaptive GOKU", "(b) adaptive SDE GOKU",
              "(c) population of 8", "(c) bf16 population of 8",
              "(d) LatentODE population of 4",
              "(e) SPendulum population of 4")
HAND_KERNEL = r"(goku_heads_\w+?_kernel|rk_\w+?_kernel|node_field_\w+?_kernel)"


@dataclasses.dataclass
class BlockPart:
    """A configuration of phase 4n: ``make(**cfg changes)`` builds its
    Trainer or MultiSeedTrainer; ``per_epoch`` the launches each kernel
    counter gains an epoch, ``extra`` those of a fit's start (the autosize
    probe's encoder); ``blocks`` blocks of ``epochs`` epochs held against
    the per-step loop, then ``window`` epochs of each in a profiler window
    (``lean``: device activity only, without the Chrome trace and its
    lost-record count: the window of an adaptive SDE epoch holds ~1e6
    device ops)."""
    make: object
    per_epoch: dict
    extra: dict = dataclasses.field(default_factory=dict)
    blocks: int = BLOCK_N
    window: int = BLOCK_E
    lean: bool = False
    epochs: int = BLOCK_E      # a block's
    solo: object = None     # (replica, make a solo block-mode Trainer, rtol)


def block_parts(train_set, dev):
    """{path: BlockPart}: phase 4's full-width GOKU on the pendulum, phase
    4b's full-width LatentODE; (a) GOKU on SPendulum(); (b) GOKU on the
    adaptive pendulum and the adaptive SPendulum at train_goku.py
    --adaptive's settings (ADAPTIVE_SDE), autosized at the fit's start
    (the SPendulum's budget without the safety factor), mask_failures;
    (c) 4g's population of 8 seeds in float32 and in bf16 (4h), replica 3
    against a solo block-mode Trainer of seed 336;
    (d) 4i's population of 4 LatentODE seeds; (e) 4 SPendulum seeds. A
    forward a step and a validation pass, a backward a step."""
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           LatentODE, NODE, default_layers,
                                           goku_default_layers)
    from latentdiffeq_torch.pendulum import Pendulum, SPendulum
    from latentdiffeq_torch.solve import make_options
    from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig
    from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig,
                                          Trainer)

    steps = train_set.shape[0] // 64
    grid = dict(options=SolveOptions(adaptive=False, substeps=1))
    dynamics = {
        "pendulum": lambda: Pendulum(**grid),
        "spendulum": lambda: SPendulum(),
        "adaptive": lambda: Pendulum(options=make_options(adaptive=True)),
        "adaptive spendulum": lambda: SPendulum(
            adaptive=True, adaptive_cfg=SDEAdaptiveConfig(**ADAPTIVE_SDE))}

    def goku(which, seed=333, dtype=torch.float32):
        return LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
            *goku_default_layers(784, dynamics[which](), device=dev,
                                 generator=torch.Generator().manual_seed(
                                     seed), dtype=dtype))

    def latent_ode(seed):
        g = torch.Generator().manual_seed(seed)
        mt = LatentODE(use_kernel_solve=True)
        node = NODE(16, generator=g, device=dev, **grid)
        return LatentDiffEqModel.build(
            mt, *default_layers(mt, 784, node, generator=g, device=dev))

    def cfg(**kw):
        return TrainConfig(epochs=1500, save_best=False, **kw)

    def solo(build, **c):
        return lambda mesh=None, **kw: Trainer(build(), cfg(**c, **kw),
                                               device=dev, mesh=mesh)

    def pop(init, seeds, **c):
        return lambda **kw: MultiSeedTrainer(init, cfg(**c, **kw), seeds,
                                             device=dev)

    heads = {"goku_heads": 2 * steps, "goku_heads_bwd": steps}
    rk = {"rk_fixed_grid": 2 * steps, "rk_fixed_grid_bwd": steps}
    bf = {"goku_heads[bf16]": 2 * steps, "goku_heads_bwd[bf16]": steps}
    node = {"node_field_fwd": 2 * steps, "node_field_bwd": steps,
            "node_field_dw": steps}
    # autosized at the fit's start: rows that outgrow the budget as the
    # weights train fail and are masked (the validation sequences, 99
    # intervals, outrun the adaptive SPendulum's budget sized on 49)
    sized = dict(autosize_adaptive=True, mask_failures=True)
    short = dict(window=1, lean=True)     # a one-epoch device-only window
    s336 = POP_SEEDS.index(336)
    return {
        "GOKU": BlockPart(solo(lambda: goku("pendulum")), {**heads, **rk}),
        "LatentODE": BlockPart(solo(lambda: latent_ode(1), decay=1e-4,
                                    seed=1), node),
        "(a) SDE GOKU": BlockPart(solo(lambda: goku("spendulum")), heads,
                                  **short),
        "(b) adaptive GOKU": BlockPart(
            solo(lambda: goku("adaptive"), **sized), heads,
            {"goku_heads": 1}, blocks=1, **short),
        # blocks of 2, and the step budget at the probe's most attempts
        # (autosize_safety 1, not 1.5): the graph of ~0.9e6 nodes at 1.5
        # cost 35-52 s to capture, and the part ~155-216 s of the run
        "(b) adaptive SDE GOKU": BlockPart(
            solo(lambda: goku("adaptive spendulum"), **sized,
                 autosize_safety=1.0), heads,
            {"goku_heads": 1}, blocks=1, epochs=2, **short),
        "(c) population of 8": BlockPart(
            pop(lambda s: goku("pendulum", s), POP_SEEDS), {**heads, **rk},
            blocks=1, solo=(s336, solo(lambda: goku("pendulum", 336),
                                       seed=336), POP_RTOL), **short),
        "(c) bf16 population of 8": BlockPart(
            pop(lambda s: goku("pendulum", s, BF), POP_SEEDS),
            {**heads, **rk, **bf}, blocks=1,
            solo=(s336, solo(lambda: goku("pendulum", 336, BF), seed=336),
                  BF16_POP_RTOL), **short),
        "(d) LatentODE population of 4": BlockPart(
            pop(latent_ode, NODE_POP_SEEDS, decay=1e-4, seed=1), node,
            blocks=1, **short),
        "(e) SPendulum population of 4": BlockPart(
            pop(lambda s: goku("spendulum", s), POP_SEEDS[:4]), heads,
            blocks=1, **short)}


def block_state(tr):
    """What block mode must reproduce bit for bit, of a Trainer or a
    MultiSeedTrainer: each epoch's history (less its times), the weights,
    the optimizer's step count and state, the best (each replica's) and
    the random streams."""
    import numpy as np
    keys = ("epoch", "train_loss", "val_loss", "kl", "n_failed", "beta",
            "seq_len")
    hist = [[np.asarray(h[k]).tobytes() for k in keys if k in h]
            for h in tr.history]
    if hasattr(tr, "params"):           # a population
        b = tr._best
        return {"history": hist, "weights": list(tr.params.values()),
                "optimizer": [tr.opt.t, tr.opt.state_tensors()],
                "best": [list(b["params"].values()), b["m"], b["v"],
                         np.asarray(b["val"]).tobytes(),
                         np.asarray(b["epoch"]).tobytes()],
                "streams": [[r.bit_generator.state for r in tr.np_rngs],
                            [g.get_state() for g in tr.window_gens
                             + tr.noise_gens]]}
    best = (None if tr.best is None else
            [tr.best["epoch"], tr.best["val"],
             list(tr.best["model"].values())])
    return {"history": hist, "weights": list(tr.model.parameters()),
            "optimizer": [tr.opt.t, tr.opt.state_tensors()],
            "best": [best, tr.best_val_loss],
            "streams": [tr.np_rng.bit_generator.state,
                        [tr.window_gen.get_state(),
                         tr.noise_gen.get_state()]]}


def _same(x, y) -> bool:
    """Equal, tensors bit for bit (a NaN equals the same NaN)."""
    if isinstance(x, torch.Tensor):
        return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                and x.shape == y.shape and torch.equal(
                    x.detach().reshape(-1).view(torch.uint8),
                    y.detach().reshape(-1).view(torch.uint8)))
    if isinstance(x, (list, tuple)):
        return (isinstance(y, (list, tuple)) and len(x) == len(y)
                and all(_same(a, b) for a, b in zip(x, y)))
    return x == y


def block_differences(a, b):
    """The parts of ``block_state`` in which two trainers differ (for the
    weights, how many tensors and how many of them hold a non-finite
    value)."""
    sa, sb = block_state(a), block_state(b)
    out = [k for k in sa if not _same(sa[k], sb[k])]
    if "weights" in out:
        pairs = list(zip(sa["weights"], sb["weights"]))

        def nonfinite(ts):
            return sum(not bool(torch.isfinite(t).all()) for t in ts)

        out.append(f"{sum(not _same(x, y) for x, y in pairs)} of "
                   f"{len(pairs)} weight tensors, non-finite in "
                   f"{nonfinite(sa['weights'])} / "
                   f"{nonfinite(sb['weights'])}")
    return out


def kernel_counts(prof):
    """{hand-written kernel: device records} of a profiler window."""
    import re
    out = {}
    for e in device_events(prof):
        m = re.search(HAND_KERNEL, e.name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def lean_window(prof):
    """(hand-written kernels' device records, and NCCL's under "nccl",
    device ops, busy ms, span ms) of a profiler window read from its raw
    kineto records, without building the profiler's event objects (~1e6
    device ops a window)."""
    import re
    out, busy, lo, hi, n = {}, 0, None, None, 0
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or not region_device_op(e.name()):
            continue
        n += 1
        busy += e.duration_ns()
        lo = e.start_ns() if lo is None else min(lo, e.start_ns())
        hi = e.end_ns() if hi is None else max(hi, e.end_ns())
        m = re.search(HAND_KERNEL + "|(nccl)", e.name())
        if m:
            k = m.group(1) or m.group(2)
            out[k] = out.get(k, 0) + 1
    return out, n, busy / 1e6, (hi - lo) / 1e6 if n else 0


def block_window(tr, train_set, val_set, epochs, lean=False):
    """Fit ``tr`` on to ``epochs`` in a utils.device_profile window: (its
    hand-written kernels' device records, device ops, busy ms, span ms,
    lost_kernel_records), or with ``lean`` device activity only, read by
    ``lean_window``, lost_kernel_records None (no trace)."""
    prof, lost = profiler_window(
        lambda: tr.fit(train_set, val_set, epochs=epochs, verbose=False),
        count_lost=not lean, device_only=lean)
    if lean:
        return (*lean_window(prof), None)
    evs = device_events(prof)
    busy = sum(getattr(e, "device_time", None)
               or getattr(e, "cuda_time", 0) for e in evs) / 1e3
    span = ((max(e.time_range.end for e in evs)
             - min(e.time_range.start for e in evs)) / 1e3 if evs else 0)
    return kernel_counts(prof), len(evs), busy, span, lost


def launch_totals():
    """Every launch counter, the RK launchers' summed over instances."""
    from latentdiffeq_torch.ops import launches
    return {k: (sum(v.values()) if isinstance(v, dict) else v)
            for k, v in launches.snapshot().items()}


def block_path(train_set, val_set, dev, gpu, only=None, mesh=None):
    """Phase 4n: for each of ``block_parts`` (or those named in ``only``, in
    that order), a trainer in block mode (blocks of its ``epochs``, replays
    under torch.cuda.set_sync_debug_mode("error")) and one with
    jit_epoch=False, same seeds, fitted ``blocks`` blocks: every epoch's
    losses, the weights, the optimizer state, the best and the streams bit
    for bit;
    the launch counters (replay-aware) equal, as expected and with no plain
    call; each graph's capture seconds and nodes. Then ``window`` more
    epochs of each in a profiler window: the hand-written kernels' device
    records equal, the states again bit for bit; steady epoch seconds,
    step + validation ms, device busy and idle share of each. With
    ``mesh`` (a one-rank NCCL mesh: mesh_block_path) both are
    ``Trainer(mesh=mesh)``s, whose block runs DDP's warm-up of eager epochs
    before its capture, the window is one epoch, device activity only
    (NCCL's records counted), and a solo block-mode Trainer fitted alike
    must equal the mesh's blocks bit for bit (at one rank DDP's mean and
    the loss's sums are exact), its graph's nodes beside theirs. Returns
    {path: (per-step, block) steady epoch s}."""
    import numpy as np

    from latentdiffeq_torch.train.trainer import DDP_WARMUP_STEPS

    parts = block_parts(train_set, dev)
    out = {}
    for name in only or parts:
        part, what = parts[name], name
        if mesh is not None:
            part = dataclasses.replace(
                part, make=lambda make=part.make, **kw: make(mesh=mesh, **kw),
                window=1, lean=True)
            what = f"{name} on a one-rank NCCL mesh"
        t_part = time.perf_counter()
        steps = train_set.shape[0] // 64
        n = part.epochs * part.blocks
        want = {k: n * v + part.extra.get(k, 0)
                for k, v in part.per_epoch.items()}
        runs = {}
        for mode, kw in (("per-step", dict(jit_epoch=False)),
                         ("block", dict(epochs_per_dispatch=part.epochs))):
            tr = part.make(**kw)
            tr.sync_debug = "error"       # the block's replays
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(train_set, val_set, epochs=n, verbose=False)
            torch.cuda.synchronize()
            got = launch_totals()
            runs[mode] = (tr, time.perf_counter() - t0, got)
            log("block", f"{what} {mode}: {n} epochs in "
                         f"{runs[mode][1]:.3f} s; launches "
                         f"{ {k: v for k, v in got.items() if v} }")
        (ref, _, got_ref), (blk, _, got_blk) = runs["per-step"], \
            runs["block"]
        bad = block_differences(ref, blk)
        for h in blk.history:
            log("train", f"{what} block epoch {h['epoch']}: train loss "
                         f"{h['train_loss']} val loss {h['val_loss']} beta "
                         f"{h['beta']:.4f} failed rows {h['n_failed']} "
                         f"{h['epoch_s']:.4f} s (the per-step loop's "
                         f"differ in {bad or 'nothing'})")
            if not (np.isfinite(h["train_loss"]).all()
                    and np.isfinite(h["val_loss"]).all()):
                fail(f"{what}: non-finite loss in epoch {h['epoch']}")
        kernels = {k: got_blk[k] for k in want}
        plain = {k: v for k, v in got_blk.items() if k.startswith("plain")}
        graphs = [(fn.seq_len, round(fn.capture_s, 3), fn.graph_nodes)
                  for fn in blk._block_fns.values()]
        de = (blk.model if hasattr(blk, "model") else
              blk.base).decoder.diffeq
        acfg = getattr(de, "adaptive_cfg", None) or getattr(
            getattr(de, "options", None), "adaptive_cfg", None)
        log("block", f"{what}: block mode vs per-step loop after "
                     f"{part.blocks} block(s) of {part.epochs} epochs: "
                     f"differences {bad or 'none'} (bit for bit: history, "
                     f"weights, optimizer, best, streams); launches "
                     f"{kernels} (expected {want}, per-step "
                     f"{ {k: got_ref[k] for k in want} }); plain calls "
                     f"{plain}; replays under sync debug mode 'error'; "
                     f"graphs (window length, capture s, nodes) {graphs}"
                     + (f"; step budget max_steps {acfg.max_steps}"
                        + (f", depth_cap {acfg.depth_cap}"
                           if hasattr(acfg, "depth_cap") else "")
                        if part.extra else ""))
        if bad:
            fail(f"{what}: block mode differs from the per-step loop in {bad}")
        if got_blk != got_ref or kernels != want or any(plain.values()):
            fail(f"{what}: block launches {got_blk}, per-step {got_ref}, "
                 f"expected {want}")
        if not graphs or any(g[1] is None or not g[2] for g in graphs):
            fail(f"{what}: no graph was captured: {graphs}")
        if mesh is not None:
            solo = parts[name].make(epochs_per_dispatch=part.epochs)
            solo.sync_debug = "error"
            solo.fit(train_set, val_set, epochs=n, verbose=False)
            bad = block_differences(solo, blk)
            solo_graphs = [(fn.seq_len, round(fn.capture_s, 3),
                            fn.graph_nodes)
                           for fn in solo._block_fns.values()]
            log("block", f"{what}: DDP's forwards run by the host "
                         f"{blk._ddp_steps} of {n * steps} (eager warm-up "
                         f"of {-(-DDP_WARMUP_STEPS // steps)} epochs, then "
                         f"the capture); against a solo block-mode Trainer: "
                         f"differences {bad or 'none'}; its graphs "
                         f"{solo_graphs}")
            if bad:
                fail(f"{what}: the mesh's blocks differ from the solo "
                     f"Trainer's in {bad}")
        if part.solo is not None:
            i, make_solo, rtol = part.solo
            s = make_solo(epochs_per_dispatch=part.epochs)
            s.fit(train_set, val_set, epochs=n, verbose=False)
            pop_v = np.array([float(h["val_loss"][i]) for h in blk.history])
            solo_v = np.array([h["val_loss"] for h in s.history])
            rel = float(np.abs(pop_v - solo_v).max() / np.abs(solo_v).max())
            log("block", f"{what}: replica {i} (seed {blk.seeds[i]}) val "
                         f"losses {pop_v.tolist()} vs a solo block-mode "
                         f"Trainer's {solo_v.tolist()}: max rel err "
                         f"{rel:.3e} (tol {rtol:.1e})")
            if not rel <= rtol:
                fail(f"{what}: replica {i} vs the solo Trainer: {rel}")
        # more epochs of each in a profiler window
        wins = {}
        for mode, (tr, _, _) in runs.items():
            wins[mode] = block_window(tr, train_set, val_set,
                                      n + part.window, part.lean)
        bad = block_differences(ref, blk)
        if bad or wins["block"][0] != wins["per-step"][0]:
            fail(f"{what}: profiled block: differences {bad}, device "
                 f"records {wins['block'][0]} vs {wins['per-step'][0]}")
        steady = {}
        for mode, (tr, _, _) in runs.items():
            ep_s = sum(h["epoch_s"] for h in
                       tr.history[-part.window:]) / part.window
            rec, ops, busy, span, lost = wins[mode]
            steady[mode] = ep_s
            log("block", f"{what} {mode}, epochs {n}-{n + part.window - 1}"
                         f" (synchronised at each epoch's end / the "
                         f"block's): steady epoch {ep_s:.4f} s, step + "
                         f"validation {1e3 * ep_s / steps:.3f} ms; profiler "
                         f"window of the {part.window} epoch(s): {ops} "
                         f"device ops, busy {busy:.3f} ms of a {span:.3f} "
                         f"ms span (idle "
                         f"{100 * (1 - busy / span) if span else 0:.1f} %, "
                         f"busy {busy / part.window / steps:.3f} ms a step "
                         f"+ validation), hand-written kernels' records "
                         f"{rec} ({lost_str(lost)}); card {gpu}")
        out[what] = (steady["per-step"], steady["block"])
        log("block", f"{what}: {time.perf_counter() - t_part:.1f} s")
        del runs, ref, blk, wins
        torch.cuda.empty_cache()
    return out


def mesh_block_path(train_set, val_set, dev, gpu, only=BLOCK_FIRST):
    """Phase 4n on a mesh: ``block_path(..., mesh=)`` for the paths named
    in ``only`` (full-width GOKU and LatentODE) as Trainer(mesh=
    make_mesh(1)) block fits on a one-rank NCCL group set up here and
    ended after. Run before phase 5: a profiler window opened after phase
    5's loses kernel records (PERF.md section 7), and block_path compares
    two windows' records."""
    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    initialize_distributed(device=dev)
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"the one-rank group runs {torch.distributed.get_backend()}")
        return block_path(train_set, val_set, dev, gpu, only=only,
                          mesh=make_mesh(1))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 4k: train_goku.py --data-parallel (parallel/, Trainer(mesh=),
# MultiSeedTrainer(mesh=)) on one rank in this process and on two ranks on
# the one card (torch.distributed.run, gloo: NCCL refuses two ranks on one
# device), the profiling utilities, the native renderer and the tutorial.

DP_TOL = 1e-6       # one rank against the solo run: the same arithmetic
# N ranks against one process (the data-parallel Trainer equals the solo
# Trainer up to the order of its sums): after 2 epochs every weight within
# DP_RTOL (atol 1e-6) and each epoch's validation loss within DP_RTOL of
# that epoch's; the first step's loss within 1e-5 and its gradients, per
# tensor (max |difference| over max |gradient|), within DP_GRAD_TOL. A relu
# unit whose pre-activation lies within rounding of zero may be on in one
# run's products and off in the other's, which moves the gradients of its
# part of the model (e.g. decoder.reconstructor) by a finite step: the
# units are counted, and the tensors of a part with a flipped unit get
# RELU_GRAD_TOL.
DP_RTOL = 2e-4
DP_GRAD_TOL = 1e-5
DP_TIMEOUT = 600
DP_DIR = os.path.join(CLI_DIR, "dp")
# each GOKU kernel's launches in 2 epochs of train_goku.py without figures
# (405 training videos, 6 steps of 64 an epoch): forward in each step and
# validation, backward in each step; on every rank of a data-parallel run
DP_LAUNCHES = {"goku_heads": 24, "goku_heads_bwd": 12,
               "rk_fixed_grid[pendulum]": 24,
               "rk_fixed_grid_bwd[pendulum]": 12}
RENDER_ATOL, RENDER_RTOL = 2e-6, 1e-7   # tests/test_native.py:27's assert


def dp_argv(extra, device=None, small=False):
    """train_goku.py's arguments of phase 4k's runs: 2 epochs without
    figures (``small``: batch 8, windows of 8, for a small video)."""
    return (["--epochs", "2", "--no-viz"]
            + ([] if device is None else ["--device", device])
            + (["--batch-size", "8", "--seq-len", "8"] if small else [])
            + extra)


def weights_of(model):
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def goku_333(dev, mesh=None, batch_size=64, **cfg):
    """train_goku.py's model (seed 333, both kernel switches) in a Trainer
    of its configuration (per step, unless ``cfg`` says otherwise)."""
    from latentdiffeq_torch.examples.pendulum import train_goku
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.train import TrainConfig, Trainer
    diffeq = train_goku.make_diffeq(train_goku.build_parser().parse_args([]))
    layers = goku_default_layers(784, diffeq, device=dev,
                                 generator=torch.Generator().manual_seed(333))
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    return Trainer(model, TrainConfig(**dict(
        dict(jit_epoch=False, epochs=1500, save_best=False,
             batch_size=batch_size), **cfg)), device=dev, mesh=mesh)


def dp_first_step(tr, x, rank=0, world=1):
    """One train step of ``tr`` (goku_333's weights) on its rows of the
    minibatch ``x``. Returns its loss, the gradients (averaged over the
    ranks with a mesh) and, for every relu site, which units were on:
    ``relu/<module>`` for each relu Dense's output and ``relu/<heads>``
    for the encoder RNN's units in the heads kernel's tape (the plain
    version's on the CPU), from the heads' input of the step."""
    from latentdiffeq_torch.ops import recurrent_cuda as rc
    b = tr.cfg.batch_size // world
    model = tr.model
    on, hooks = {}, []

    def record(name):
        def hook(mod, inp, y):
            on[name] = (y > 0).cpu().numpy()
        return hook

    for name, m in model.named_modules():
        if hasattr(m, "W") and getattr(m, "activation", None) is torch.relu:
            hooks.append(m.register_forward_hook(record(name)))
    fe = model.encoder.feature_extractor
    hooks.append(fe.register_forward_hook(
        lambda mod, inp, y: on.__setitem__("heads input", y.detach())))
    try:
        m = tr.train_step(x[rank * b:(rank + 1) * b], 1.0)
    finally:
        for h in hooks:
            h.remove()
    hs = model.encoder.pattern_extractor
    L, H = len(hs[0].cells), hs[0].cells[0].hidden_dim
    xs = on.pop("heads input")
    with torch.no_grad():
        tape = (rc.goku_heads_cuda(*hs, xs, tape=True) if xs.is_cuda
                else rc.goku_heads_taped_reference(*hs, xs))[2]
    on["encoder.pattern_extractor.0"] = (tape[..., :L * H] > 0).cpu().numpy()
    grads = {f"grad/{k}": p.grad.float().cpu().numpy()
             for k, p in model.named_parameters()}
    return float(m["loss"]), dict(grads, **{f"relu/{k}": v
                                            for k, v in on.items()})


def split_step(world):
    """A Trainer.train_step computing in one process what ``world``
    data-parallel ranks compute, without torch.distributed: the global
    batch's noise, each rank's rows' loss and gradient, the gradients'
    mean (each divided by ``world``, then summed in rank order), one
    optimizer step. For losses without batch couplings (no
    ``mask_failures``, no ``free_bits``: train_goku.py's pendulum)."""
    def train_step(self, x, beta, *, eps=None, key=None):
        cfg = self.cfg
        eps, kw = self._shard_randomness(x.shape[0], eps, self._key_kw(key))
        b = x.shape[0] // world
        params = list(self.model.parameters())
        total = [torch.zeros_like(p) for p in params]
        ms = []
        for r in range(world):
            rows = slice(r * b, (r + 1) * b)
            loss, m = self.loss_fn(
                self.model, x[rows], self._grid(x.shape[1]), beta,
                variational=cfg.variational, generator=self.noise_gen,
                eps=(tuple(e[rows] for e in eps) if isinstance(eps, tuple)
                     else eps[rows]),
                mask_failures=cfg.mask_failures, free_bits=cfg.free_bits,
                **kw)
            for t, g in zip(total, torch.autograd.grad(loss, params)):
                t.add_(g / world)
            ms.append(m)
        self.opt.zero_grad()
        for p, t in zip(params, total):
            p.grad = t
        self.opt.step()
        return {k: torch.stack([m[k].detach() for m in ms]).sum(0)
                if k.startswith("n_") else
                torch.stack([m[k].detach() for m in ms]).mean(0)
                for k in ms[0]}
    return train_step


def dp_worker(argv):
    """One rank of a data-parallel launch, ``chip_smoke.py --dp-worker OUT
    [--device D] [--seeds S] [--small]`` under torch.distributed.run, on
    OUT/data's pendulum cache. ``--device cuda``: rank r on cuda:r (NCCL);
    ``cuda:0``: every rank on that card (gloo); ``cpu``: gloo. Runs
    train_goku.py --data-parallel N twice, with every counter at 0 before
    each (its launches, losses, weights and step times), with ``--seeds``
    also --seeds S --data-parallel N, and one first step of goku_333 on
    its rows; where the Trainer runs blocks (not gloo over a card's
    tensors), goku_333 on the mesh in 2 blocks of 3 epochs (DDP's warm-up,
    then the captured epochs on the card) and in the per-step loop; rank
    0 then runs both in one process, and the run again with
    split_step's emulation of N ranks. Writes OUT/rank<r>.json and .npz
    (keys ``<run>/<tensor>``)."""
    import argparse

    import numpy as np

    from latentdiffeq_torch.examples.pendulum import create_data, train_goku
    from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
    from latentdiffeq_torch.train import Trainer, splitobs

    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    create_data.DATA_DIR = os.path.join(a.out, "data")

    def no_generation(**kw):
        raise RuntimeError("the data-parallel phase regenerated the video")

    create_data.generate_dataset = no_generation
    world = int(os.environ["WORLD_SIZE"])
    # the group for every run below (train_goku.py leaves a group it did
    # not start), its backend as train_goku.py picks it
    mesh, dev, _ = train_goku.data_parallel_mesh(world, a.device)
    rank = mesh.get_local_rank()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res, arrays = {"rank": rank, "world": world, "device": str(dev),
                   "backend": torch.distributed.get_backend()}, {}
    x = None

    def run(tag, extra, rows):
        nonlocal x
        train_goku.OUTPUT_DIR = os.path.join(a.out, tag)
        reset_counts()
        t0 = time.perf_counter()
        got = train_goku.main(dp_argv(extra, a.device, a.small))
        sync()
        r = res[tag] = {
            "wall_s": time.perf_counter() - t0, "counts": cli_counts(),
            "plain": [recurrent_cuda.goku_heads_reference.calls,
                      ode_cuda.solve_fixed_grid_batched_reference.calls],
            "val": [np.asarray(h["val_loss"]).tolist() for h in got.history],
            "epoch_s": got.history[-1]["epoch_s"],
            "blocks": bool(got._block_fns)}
        if "--seeds" in extra:
            r.update(best_seed=got.best_seed, best_val=got.best_val_loss,
                     local_seeds=got.local_seeds)
            return
        arrays.update({f"{tag}/{k}": v
                       for k, v in weights_of(got.model).items()})
        if x is None:
            frames = train_goku.load_data("pendulum", dev)[3]
            x = splitobs(torch.as_tensor(frames.reshape(
                *frames.shape[:2], -1), device=dev), 0.9)
        if dev.type == "cuda" and tag in ("dp", "one"):
            b = got.cfg.batch_size // (world if rows else 1)
            start = rank * b if rows else 0
            r["step_ms"] = step_times(
                got, x[0][start:start + b, :got.cfg.seq_len], x[1],
                float(got.history[-1]["beta"]))

    dp = ["--data-parallel", str(world)]
    run("dp", dp, True)
    run("again", dp, True)
    if a.seeds:
        run("seeds", dp + ["--seeds", str(a.seeds)], True)
    seq = 8 if a.small else 50
    bs = 8 if a.small else 64
    res["dp"]["first_loss"], g = dp_first_step(
        goku_333(dev, mesh, bs), x[0][:, :seq], rank, world)
    arrays.update({f"dp/{k}": v for k, v in g.items()})
    if not (res["backend"] == "gloo" and dev.type == "cuda"):
        for tag, kw in (("mesh_blocks", dict(epochs_per_dispatch=3)),
                        ("mesh_per_step", {})):
            tr = goku_333(dev, mesh, bs, seq_len=seq, **kw)
            if dev.type == "cuda":
                tr.sync_debug = "error"
            t0 = time.perf_counter()
            tr.fit(*x, epochs=6, verbose=False)
            sync()
            res[tag] = {
                "wall_s": time.perf_counter() - t0,
                "history": [[h[k] for k in ("train_loss", "val_loss", "kl",
                                            "n_failed")]
                            for h in tr.history],
                "epoch_s": tr.history[-1]["epoch_s"],
                "graphs": [(fn.seq_len, fn.capture_s, fn.graph_nodes)
                           for fn in tr._block_fns.values()]}
            arrays.update({f"{tag}/{k}": v
                           for k, v in weights_of(tr.model).items()})
    torch.distributed.barrier()
    if rank == 0:
        run("one", [], False)
        res["one"]["first_loss"], g = dp_first_step(goku_333(dev, None, bs),
                                                    x[0][:, :seq])
        arrays.update({f"one/{k}": v for k, v in g.items()})
        plain_step = Trainer.train_step
        Trainer.train_step = split_step(world)
        try:
            run("split", [], False)
        finally:
            Trainer.train_step = plain_step
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def dp_launch(out, n, worker_args, video=None, cache=None):
    """Start ``n`` ranks of ``dp_worker`` under torch.distributed.run on
    a pendulum cache in OUT/data (``video`` written with ``cache``'s key,
    or a copy of the directory ``cache``); fails unless the launch exits 0
    within DP_TIMEOUT and every rank wrote its files. Returns [(info,
    arrays)] by rank and the launch's seconds."""
    import shutil

    import numpy as np

    from latentdiffeq_torch.examples.pendulum import create_data
    shutil.rmtree(out, ignore_errors=True)
    if video is None:
        shutil.copytree(cache, os.path.join(out, "data"))
    else:
        create_data.write_cache(os.path.join(out, "data",
                                             create_data.DEFAULT_FILE),
                                video, cache)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), os.path.abspath(__file__),
           "--dp-worker", out] + worker_args
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log_text, _ = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"the {n} ranks did not finish in {DP_TIMEOUT} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"dp_ranks_{os.path.basename(out)}.log"), "w") as f:
        f.write(log_text)
    ranks = []
    for r in range(n):
        path = os.path.join(out, f"rank{r}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            fail(f"the {n}-rank launch exited {proc.returncode} (rank {r} "
                 f"wrote {path}: {os.path.exists(path)}); its log ends: "
                 f"{log_text[-3000:]}")
        with open(path) as f:
            info = json.load(f)
        with np.load(os.path.join(out, f"rank{r}.npz")) as f:
            ranks.append((info, dict(f)))
    return ranks, time.perf_counter() - t0


def rows_of(full, part, rank, world):
    """``part``'s rows of ``full``: rank ``rank``'s block of the axis that
    ``world`` ranks split."""
    import numpy as np
    for ax in range(full.ndim):
        if part.shape[ax] * world == full.shape[ax] and all(
                part.shape[i] == full.shape[i]
                for i in range(full.ndim) if i != ax):
            return np.split(full, world, axis=ax)[rank]
    raise ValueError(f"{part.shape} is no rank's block of {full.shape}")


def dp_check(ranks, what, want=None, gpu=""):
    """The gates of N ranks against one process (the worker's arrays):
    each rank's launches as the one-process run's (and ``want``, with no
    plain call, on the card); both runs of each rank and all ranks bit for
    bit; the first step's loss within 1e-5 and gradients within
    DP_GRAD_TOL (RELU_GRAD_TOL for a part with a flipped relu unit); each
    epoch's validation loss and every weight within DP_RTOL. Logs each,
    fails on a miss; returns a summary."""
    import numpy as np
    world = len(ranks)
    one, a0 = ranks[0][0]["one"], ranks[0][1]
    summary = {"what": what, "ranks": world, "backend": ranks[0][0]["backend"],
               "device": [info["device"] for info, _ in ranks]}
    for r, (info, _) in enumerate(ranks):
        for case in ("dp", "again") + (("seeds",) if "seeds" in info else ()):
            c = info[case]
            log("dp", f"{what}, rank {r} {case}: launches {c['counts']} "
                      f"(one process {one['counts']}), plain calls "
                      f"{c['plain']}; val losses {c['val']}; steady epoch "
                      f"{c['epoch_s']:.4f} s; run {c['wall_s']:.3f} s; {gpu}")
            if c["counts"] != one["counts"] or (
                    want is not None and (c["counts"] != want
                                          or c["plain"] != [0, 0])):
                fail(f"{what} rank {r} {case}: launches {c['counts']}, plain"
                     f" {c['plain']}, one process {one['counts']}, expected"
                     f" {want}")
            if not np.isfinite(c["val"]).all():
                fail(f"{what} rank {r} {case}: non-finite validation loss")
    # the Trainer runs blocks on NCCL and on the CPU; gloo over a card's
    # tensors runs the per-step loop
    blocks = not (summary["backend"] == "gloo"
                  and summary["device"][0].startswith("cuda"))
    ran = [info[c]["blocks"] for info, _ in ranks for c in ("dp", "again")]
    log("dp", f"{what}: train_goku's Trainer(mesh) ran "
              f"{'blocks' if all(ran) else 'per step' if not any(ran) else ran}"
              f" (expected {'blocks' if blocks else 'per step'})")
    if ran != [blocks] * len(ran):
        fail(f"{what}: Trainer(mesh) ran blocks {ran}, expected {blocks}")
    if blocks:
        mesh_blocks_check(ranks, what, gpu)
    keys = [k[3:] for k in a0 if k.startswith("dp/")]
    again = all(np.array_equal(a[f"again/{k}"], a[f"dp/{k}"])
                for _, a in ranks for k in keys if not k.startswith(
                    ("grad/", "relu/")))
    same = all(np.array_equal(a[f"dp/{k}"], a0[f"dp/{k}"])
               for _, a in ranks[1:] for k in keys if not k.startswith(
                   "relu/"))
    log("dp", f"{what}: each rank's second run bit for bit with its first: "
              f"{again}; the ranks' weights and first-step gradients bit "
              f"for bit: {same}")
    if not (again and same):
        fail(f"{what}: a rank's runs differ ({again}) or the ranks differ "
             f"({same})")
    # the first step from the same weights
    flips, units, parts = 0, 0, set()
    for k in (k for k in keys if k.startswith("relu/")):
        for r, (_, a) in enumerate(ranks):
            mine = rows_of(a0[f"one/{k}"], a[f"dp/{k}"], r, world)
            n = int((mine != a[f"dp/{k}"]).sum())
            flips, units = flips + n, units + mine.size
            if n:
                parts.add(".".join(k[5:].split(".")[:2]))
    loss_dp = float(np.mean([info["dp"]["first_loss"] for info, _ in ranks]))
    worst = []
    for k in (k for k in keys if k.startswith("grad/")):
        g = a0[f"one/{k}"]
        e = float(np.abs(a0[f"dp/{k}"] - g).max() / max(np.abs(g).max(),
                                                        1e-30))
        tol = (RELU_GRAD_TOL if ".".join(k[5:].split(".")[:2]) in parts
               else DP_GRAD_TOL)
        worst.append((e / tol, e, tol, k[5:]))
    worst.sort(reverse=True)
    log("dp", f"{what}, first step against one process: loss {loss_dp:.6f} "
              f"(mean over the ranks) vs {one['first_loss']:.6f}; relu "
              f"units on in one and off in the other {flips} of {units} "
              f"(parts {sorted(parts)}); gradients max |difference| / max "
              f"|gradient|, the worst against its tolerance: "
              f"{[(k, f'{e:.3e}', t) for _, e, t, k in worst[:3]]}")
    if worst[0][0] > 1 or not abs(loss_dp - one["first_loss"]) <= 1e-5 * abs(
            one["first_loss"]):
        fail(f"{what}: first step off one process's: {worst[:3]}, loss "
             f"{loss_dp} vs {one['first_loss']}")
    # 2 epochs. Against split_step's emulation of the ranks in one process
    # (no torch.distributed): bit for bit on 2 ranks, whose sum of two
    # halves is exact (on more the collective sums in an order of its own:
    # printed). Against one process: each epoch's validation loss within
    # DP_RTOL; the weights' spread is printed, not gated: B/N-row products
    # round otherwise than B-row ones and 12 Adam steps spread that (the
    # emulation, bit for bit with 2 ranks on an H100, is as far).
    w_keys = [k for k in keys if not k.startswith(("grad/", "relu/"))]
    n = sum(a0[f"one/{k}"].size for k in w_keys)

    def spread(ref):
        """(elements past DP_RTOL + atol 1e-6, max |difference|, the 3
        tensors with most past) of the ranks' weights against ``ref``'s."""
        past = {k: int((np.abs(a0[f"dp/{k}"] - a0[f"{ref}/{k}"])
                        > DP_RTOL * np.abs(a0[f"{ref}/{k}"]) + 1e-6).sum())
                for k in w_keys}
        return (sum(past.values()),
                max(float(np.abs(a0[f"dp/{k}"] - a0[f"{ref}/{k}"]).max())
                    for k in w_keys),
                sorted(past.items(), key=lambda kv: -kv[1])[:3])

    v1, vd = np.array(one["val"]), np.array(ranks[0][0]["dp"]["val"])
    rel = float((np.abs(vd - v1) / np.abs(v1)).max())
    s_off, s_max, _ = spread("split")
    off, w_max, top = spread("one")
    split_ok = s_max == 0 or world > 2
    log("dp", f"{what}, 2 epochs against split_step's emulation of {world} "
              f"ranks in one process: weights max |difference| {s_max:.3e}"
              f", {s_off} of {n} elements past rtol {DP_RTOL:.0e} + atol "
              f"1e-6 (gate: {'bit for bit' if world == 2 else 'none'}"
              f"); val losses {ranks[0][0]['split']['val']}")
    log("dp", f"{what}, 2 epochs against one process: val losses "
              f"{vd.tolist()} vs {v1.tolist()}, max rel err {rel:.3e} (tol "
              f"{DP_RTOL:.0e}); weights max |difference| {w_max:.3e}, {off} "
              f"of {n} elements past rtol {DP_RTOL:.0e} + atol 1e-6 (most "
              f"in {top})")
    if not (rel <= DP_RTOL and split_ok):
        fail(f"{what}: 2 epochs: val {rel} off one process's, weights "
             f"{s_max} ({s_off} past) off the emulation's")
    summary.update(first_step={"loss": [loss_dp, one["first_loss"]],
                               "relu_flips": [flips, units],
                               "grad_worst": worst[:3]},
                   val=[vd.tolist(), v1.tolist()], val_rel=rel,
                   weights_max_diff=w_max, weights_off=[off, n],
                   emulation_max_diff=s_max, emulation_off=s_off,
                   launches_a_rank=ranks[0][0]["dp"]["counts"],
                   step_ms_a_rank=[info["dp"].get("step_ms")
                                   for info, _ in ranks],
                   step_ms_one=one.get("step_ms"),
                   epoch_s_a_rank=[info["dp"]["epoch_s"]
                                   for info, _ in ranks],
                   epoch_s_one=one["epoch_s"])
    return summary


def mesh_blocks_check(ranks, what, gpu):
    """dp_check's gate on the worker's goku_333 fits on the mesh: the
    blocks bit for bit with the per-step loop (history and weights) on
    every rank, the ranks bit for bit, and on the card a graph captured."""
    import numpy as np
    a0 = ranks[0][1]
    keys = [k[12:] for k in a0 if k.startswith("mesh_blocks/")]
    for r, (info, a) in enumerate(ranks):
        blk, ref = info["mesh_blocks"], info["mesh_per_step"]
        same = blk["history"] == ref["history"] and all(
            np.array_equal(a[f"mesh_blocks/{k}"], a[f"mesh_per_step/{k}"])
            and np.array_equal(a[f"mesh_blocks/{k}"], a0[f"mesh_blocks/{k}"])
            for k in keys)
        log("dp", f"{what}, rank {r}: goku_333 on the mesh, 2 blocks of 3 "
                  f"epochs against the per-step loop: bit for bit (history, "
                  f"weights, and with rank 0) {same}; graphs (window length, "
                  f"capture s, nodes) {blk['graphs']}; steady epoch "
                  f"{blk['epoch_s']:.4f} s against {ref['epoch_s']:.4f} s; "
                  f"{gpu}")
        if not same:
            fail(f"{what}, rank {r}: the mesh's blocks differ from its "
                 f"per-step loop or from rank 0")
        if info["device"].startswith("cuda") and not blk["graphs"]:
            fail(f"{what}, rank {r}: no graph was captured")


def dp_path(solo, train_set, val_set, dev, gpu):
    """Phase 4k. (a) train_goku.py --data-parallel 1 in this process, on
    NCCL (its own one-rank group) and on gloo: every GOKU kernel launched
    as often as the solo run's (24 / 12, no figure), no plain call, weights
    within DP_TOL of the solo run of 4j (and whether bit for bit), blocks
    on NCCL and the per-step loop on gloo (the mesh's block fits at full
    width run in phase 4n: mesh_block_path). (b), (c)
    two ranks on the one card under torch.distributed.run, gloo (the
    Trainer's per-step loop: gloo cannot be captured), the
    launch's exit code checked (dp_launch): dp_check's gates against the
    one-process run in rank 0's process (each rank 24 / 12 launches at
    B 32, runs and ranks bit for bit, the first step, the validation
    losses and the weights), that run against 4j's, the step time beside
    the solo step's; --seeds 8 (each rank's 4 replicas in one launch a
    call: 24 / 12; the selected seed and its validation loss against the
    unsharded population's, POP_RTOL).
    (d) trace_profile around one step of a one-rank data-parallel Trainer
    names both GOKU forward kernels; the launches without a kernel record
    in its trace and in a plain profiler window's around the same step
    (lost_kernel_records, logged); PhaseTimer with block_on against
    step_times. (e) create_data with renderer="native", 3 trajectories,
    against the torch renderer on the card. (f) the tutorial, 2 epochs on
    the card: finite losses, the encoder kernel launched, section 14's
    decode of goku_best_model.npz against the CPU's (PATH_TOL)."""
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile as tprofile

    from latentdiffeq_torch.examples.pendulum import create_data, train_goku
    from latentdiffeq_torch.examples.tutorial import tutorial
    from latentdiffeq_torch.ops import recurrent_cuda
    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    from latentdiffeq_torch.pendulum_data import generate_dataset
    from latentdiffeq_torch.train import TrainConfig, Trainer, splitobs
    from latentdiffeq_torch.train.visualize import val_image_data
    from latentdiffeq_torch.utils import (PhaseTimer, lost_kernel_records,
                                          trace_profile)

    want = DP_LAUNCHES
    solo_w = weights_of(solo.model)

    # (a) one rank, in this process: NCCL, then gloo (the all-reduce of
    # (b)'s ranks, here of one rank's CUDA tensors)
    for backend in ("nccl", "gloo"):
        if backend == "gloo":
            initialize_distributed(backend="gloo", device=dev)
        train_goku.OUTPUT_DIR = os.path.join(CLI_DIR, f"goku_dp1_{backend}")
        try:
            dp1, _ = cli_run(f"train_goku --data-parallel 1 ({backend})",
                             train_goku, dp_argv(["--data-parallel", "1"]),
                             want, gpu)
        finally:
            if backend == "gloo":
                torch.distributed.destroy_process_group()
        if torch.distributed.is_initialized():
            fail("train_goku --data-parallel 1 left its group behind")
        diff = max(float(np.abs(a - solo_w[k]).max())
                   for k, a in weights_of(dp1.model).items())
        # a gloo group over the card's tensors cannot be captured
        blocks = bool(dp1._block_fns)
        log("dp", f"--data-parallel 1 ({backend}, one rank) against the solo "
                  f"run of 4j, seed 333: weights max |difference| {diff:.3e} "
                  f"(gate {DP_TOL:.0e}); "
                  f"{'bit for bit' if diff == 0 else 'not bit for bit'}; "
                  f"Trainer(mesh) ran {'blocks' if blocks else 'per step'} "
                  f"(expected {'blocks' if backend == 'nccl' else 'per step'})")
        if not diff <= DP_TOL:
            fail(f"--data-parallel 1 ({backend}): weights {diff} off the "
                 f"solo run")
        if blocks != (backend == "nccl"):
            fail(f"--data-parallel 1 ({backend}) ran blocks: {blocks}")

    # (b), (c) two ranks on the one card, under torch.distributed.run
    ranks, launch_s = dp_launch(DP_DIR, 2, ["--device", "cuda:0", "--seeds",
                                            "8"],
                                cache=os.path.join(CLI_DIR, "data"))
    backend = ranks[0][0]["backend"]
    log("dp", f"two ranks on {[info['device'] for info, _ in ranks]} over "
              f"{backend}: launch and all runs {launch_s:.3f} s; {gpu}")
    if backend != "gloo":
        fail(f"two ranks on one card ran {backend}, not gloo")
    summ = dp_check(ranks, "2 ranks on cuda:0", want, gpu)
    # the worker's one-process run against this process's (4j's)
    a0 = ranks[0][1]
    d_main = max(float(np.abs(a0[f"one/{k}"] - w).max())
                 for k, w in solo_w.items())
    log("dp", f"the one-process run in rank 0's process against 4j's in this "
              f"process: weights max |difference| {d_main:.3e}; "
              f"{'bit for bit' if d_main == 0 else 'not bit for bit'}")
    solo_ms = step_times(solo, train_set[:64, :50], val_set,
                         float(solo.history[-1]["beta"]))
    dp_ms = summ["step_ms_a_rank"][0]
    log("dp", f"step time (median of 5, synchronised): two ranks on one "
              f"card {dp_ms[0]:.3f} ms a step (B 32 a rank), val "
              f"{dp_ms[1]:.3f} ms; the solo Trainer {solo_ms[0]:.3f} ms "
              f"(B 64), val {solo_ms[1]:.3f} ms; {gpu}")

    train_goku.OUTPUT_DIR = os.path.join(CLI_DIR, "goku_pop8")
    pop, _ = cli_run("train_goku --seeds 8 (unsharded)", train_goku,
                     dp_argv(["--seeds", "8"]), want, gpu)
    for r, (info, _) in enumerate(ranks):
        c = info["seeds"]
        rel = abs(c["best_val"] - pop.best_val_loss) / abs(pop.best_val_loss)
        log("dp", f"--seeds 8 --data-parallel 2, rank {r} (seeds "
                  f"{c['local_seeds']}): selected seed {c['best_seed']} val "
                  f"{c['best_val']:.6f}; unsharded: seed {pop.best_seed} val "
                  f"{pop.best_val_loss:.6f} (rel {rel:.2e}, tol "
                  f"{POP_RTOL:.0e})")
        if c["best_seed"] != pop.best_seed or not rel <= POP_RTOL:
            fail(f"rank {r}: sharded population selected seed "
                 f"{c['best_seed']} ({c['best_val']}), unsharded "
                 f"{pop.best_seed} ({pop.best_val_loss})")

    # (d) the profiling utilities around steps of a one-rank data-parallel
    # Trainer (the step of (a))
    initialize_distributed(device=dev)
    try:
        tr = Trainer(copy.deepcopy(solo.model),
                     TrainConfig(jit_epoch=False, epochs=1500,
                                 save_best=False), device=dev,
                     mesh=make_mesh(1))
        x, beta = train_set[:64, :50], float(solo.history[-1]["beta"])
        step_ms, _ = step_times(tr, x, val_set, beta)
        trace_dir = os.path.join("chiprun_out", "trace_4k")
        shutil.rmtree(trace_dir, ignore_errors=True)
        # the control: a plain torch.profiler window around the same step,
        # which can lose the kernel records of the step's first launches
        # (trace_profile arms its window and pads it on both sides)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            tr.train_step(x, beta)
            torch.cuda.synchronize()
        plain_trace = os.path.join("chiprun_out", "trace_4k_plain.json")
        prof.export_chrome_trace(plain_trace)
        with trace_profile(trace_dir):
            tr.train_step(x, beta)
            torch.cuda.synchronize()
        (trace,) = os.listdir(trace_dir)
        lost = {"plain window": lost_kernel_records(plain_trace),
                "trace_profile": lost_kernel_records(
                    os.path.join(trace_dir, trace))}
        with open(os.path.join(trace_dir, trace)) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        found = {k: any(k in n for n in names)
                 for k in ("goku_heads_fwd_kernel", "rk_fixed_grid_kernel")}
        timer = PhaseTimer()
        for _ in range(5):
            with timer("step", block_on=x):     # x's card: the step's
                tr.train_step(x, beta)
    finally:
        torch.distributed.destroy_process_group()
    summ = timer.summary()
    ratio = summ["step"]["mean_ms"] / step_ms
    log("dp", f"trace_profile of one data-parallel step: {trace} "
              f"({os.path.getsize(os.path.join(trace_dir, trace))} bytes), "
              f"kernels named {found}; PhaseTimer(block_on=the batch) "
              f"{summ}: {summ['step']['mean_ms']:.3f} ms a step "
              f"against step_times' {step_ms:.3f} ms (ratio {ratio:.2f}, "
              f"host noise 0.5-2); card {gpu}")
    log("dp", f"launches without a kernel record in one traced step: "
              f"{lost}; card {gpu}")
    if not all(found.values()):
        fail(f"trace_profile's trace lacks a kernel: {found}")
    if not 0.5 <= ratio <= 2.0:
        fail(f"PhaseTimer's blocked step {ratio:.2f} x step_times'")

    # (e) the native renderer through the cache, against the torch renderer
    real_gen = create_data.generate_dataset
    create_data.generate_dataset = generate_dataset
    try:
        t0 = time.perf_counter()
        nat = create_data.load_or_generate(
            os.path.join(DP_DIR, "native.npz"), n_traj=3, device=dev,
            renderer="native")
        nat_s = time.perf_counter() - t0
    finally:
        create_data.generate_dataset = real_gen
    ref = generate_dataset(n_traj=3, device=dev)
    err = float(np.abs(nat[3] - ref[3].cpu().numpy()).max())
    ok = np.allclose(nat[3], ref[3].cpu().numpy(), rtol=RENDER_RTOL,
                     atol=RENDER_ATOL)
    same_traj = all(np.array_equal(a, b.cpu().numpy())
                    for a, b in zip(nat[:3], ref[:3]))
    log("dp", f"create_data renderer='native', 3 x 100 frames in "
              f"{nat_s:.3f} s: against the torch renderer on the card max "
              f"|difference| {err:.3e} (atol {RENDER_ATOL:.0e} + rtol "
              f"{RENDER_RTOL:.0e}: {ok}); trajectories equal: {same_traj};"
              f" card {gpu}")
    if not (ok and same_traj):
        fail(f"native frames {err} from the torch renderer's")

    # (f) the tutorial on the card
    tutorial.OUTPUT_DIR = os.path.join(CLI_DIR, "tutorial")
    reset_counts()
    t0 = time.perf_counter()
    res = tutorial.main(["--epochs", "2"])
    torch.cuda.synchronize()
    tut_s = time.perf_counter() - t0
    enc = recurrent_cuda.goku_heads_cuda.launches
    hist = res["trainer"].history
    d = res["decoded"]
    if d is None:
        fail("the tutorial found no goku_best_model.npz")
    latent, _, ps, _ = create_data.load_or_generate(device=dev)
    dc = val_image_data(copy.deepcopy(res["trainer"].model).cpu(),
                        val_set.cpu(), splitobs(latent, 0.9)[1],
                        splitobs(ps, 0.9)[1], vis_len=60, dt=0.05,
                        rng=np.random.default_rng(4))
    e = max(float(np.abs(d["x_hat"] - dc["x_hat"]).max()),
            float(np.abs(d["z"] - dc["z"]).max()),
            abs(d["theta_hat"] - dc["theta_hat"]))
    log("dp", f"tutorial --epochs 2 on the card in {tut_s:.3f} s: losses "
              f"{[(round(h['train_loss'], 4), round(h['val_loss'], 4)) for h in hist]}"
              f"; goku_heads launches {enc}; section 14 decode of "
              f"goku_best_model.npz (sample {d['j']}, start {d['s']}) card "
              f"against CPU: max |difference| {e:.3e} (tol {PATH_TOL:.0e}); "
              f"figures {len(res['figures'])}; card {gpu}")
    if not all(math.isfinite(h["train_loss"]) and math.isfinite(
            h["val_loss"]) for h in hist) or len(hist) != 2:
        fail("the tutorial's losses are not finite")
    if enc == 0:
        fail("the tutorial's training did not launch the encoder kernel")
    if (d["j"], d["s"]) != (dc["j"], dc["s"]) or not e <= PATH_TOL:
        fail(f"the tutorial's decode card against CPU: {e}")


# ---------------------------------------------------------------------------
# Phase 4l: user-written fields on the batched RK kernel. A field without a
# hand-written functor runs on one generated from its trace
# (ops/rhs_trace.py, ops/rhs_codegen.py), Kuramoto at a width without a
# compiled instance on the lane-group kernels instantiated for it, and the
# tutorial trains its own pendulum_f on the kernel route. The fields below
# are module-level so that their instances are cached once.

def tutorial_field_copy(u, p, t):
    """A verbatim copy of the tutorial's pendulum_f (tutorial.main, section
    1): the same trace, so the same generated source and library, which
    phase 1 builds with the others; 4l checks the tutorial's own field
    names that instance."""
    return torch.stack([u[..., 1], -10.0 / p[..., 0] * torch.sin(u[..., 0])],
                       dim=-1)


tutorial_field_copy.__name__ = "pendulum_f"


def pendulum_untagged(u, p, t):
    """pendulum.py's pendulum_f without its device_rhs tag."""
    from latentdiffeq_torch.pendulum import pendulum_f
    return pendulum_f(u, p, t)


def vdp_untagged(u, p, t):
    """custom_dynamics.py's vdp_f without its device_rhs tag."""
    from latentdiffeq_torch.custom_dynamics import vdp_f
    return vdp_f(u, p, t)


def forced_oscillator(u, p, t):
    """A forced damped oscillator, x'' = -k x - c x' + a cos(2 t), p = (k,
    c, a): non-autonomous, pdim 3."""
    x, v = u[..., 0], u[..., 1]
    k, c, a = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([v, -k * x - c * v + a * torch.cos(2.0 * t)], dim=-1)


KURAMOTO_N = 7  # a width without a compiled instance
# 4m's fields: Lorenz-96 at 40 sites, written with torch.roll (its interval
# maps, 40 * 40 + 40 * 1 floats, past MAX_MAP_FLOATS: the reverse-sweep
# backward), and Kuramoto at 64 oscillators, past a warp's lanes (the block
# kernels)
L96_N = 40
KURAMOTO_WIDE_N = 64
WIDE = (f"lorenz96-{L96_N}", f"kuramoto{KURAMOTO_WIDE_N}")


def lorenz96(u, p, t):
    """Lorenz-96 on N sites, dx_i = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F,
    F = p[0], as a user writes it (no device_rhs tag)."""
    return ((torch.roll(u, -1, -1) - torch.roll(u, 2, -1))
            * torch.roll(u, 1, -1) - u + p[..., 0:1])


def gen_fields():
    """label -> (f, dim, pdim, substeps, dt, tagged twin or None) of the
    user-written fields: 4l's, the tutorial's (by its copy; the pendulum
    path's shapes), the untagged pendulum and Van der Pol (beside their
    tagged functors), the forced oscillator and Kuramoto-7 with offsets
    (the custom dynamics' shapes); 4m's, Lorenz-96 at 40 and Kuramoto at
    64 (the examples' Kuramoto, no offsets), the custom dynamics' shapes."""
    from latentdiffeq_torch import custom_dynamics as cdyn
    from latentdiffeq_torch.pendulum import pendulum_f
    custom = (CUSTOM_SUBSTEPS, CUSTOM_DT, None)
    return {"tutorial": (tutorial_field_copy, 2, 1, 1, 0.05, None),
            "pendulum-untagged": (pendulum_untagged, 2, 1, 1, 0.05,
                                  pendulum_f),
            "vdp-untagged": (vdp_untagged, 2, 1, CUSTOM_SUBSTEPS, CUSTOM_DT,
                             cdyn.vdp_f),
            "forced": (forced_oscillator, 2, 3) + custom,
            f"kuramoto{KURAMOTO_N}": (
                cdyn.Kuramoto(KURAMOTO_N, omega_spread=0.5).f, KURAMOTO_N,
                2) + custom,
            WIDE[0]: (lorenz96, L96_N, 1) + custom,
            WIDE[1]: (cdyn.Kuramoto(KURAMOTO_WIDE_N).f, KURAMOTO_WIDE_N,
                      2) + custom}


def gen_specs():
    """(f, dim, pdim) of every 4l and 4m instance, for phase 1's build."""
    return [(f, d, p) for f, d, p, *_ in gen_fields().values()]


def gen_shapes(label):
    """(shape label, B, T): the pendulum path's for the pendulum fields,
    the custom dynamics' for the others."""
    if label in ("tutorial", "pendulum-untagged"):
        return (("train", 64, 50), ("val", 45, 100))
    return CUSTOM_SHAPES


def gen_inputs(label, B, T, gen):
    """(u0s, ps, saveat): pendulum states and L as rk_inputs draws them;
    Van der Pol's too; the oscillator x, v ~ U(-1, 1), k ~ U(1, 4), c ~
    U(0.1, 0.5), a ~ U(0.5, 2); Lorenz-96 states ~ U(-2, 2), F ~ U(4, 8);
    Kuramoto's phases, omega and K as rk_inputs."""
    f, dim, pdim, sub, dt, _ = gen_fields()[label]
    if label in ("tutorial", "pendulum-untagged"):
        return rk_inputs("pendulum", B, T, gen)
    if label == "vdp-untagged":
        return rk_inputs("vdp", B, T, gen)
    saveat = torch.arange(T, dtype=torch.float32, device="cuda") * dt
    if label == "forced":
        u0s = torch.rand(B, 2, generator=gen, device="cuda") * 2 - 1
        lo = torch.tensor([1.0, 0.1, 0.5], device="cuda")
        hi = torch.tensor([4.0, 0.5, 2.0], device="cuda")
        ps = lo + (hi - lo) * torch.rand(B, 3, generator=gen, device="cuda")
    elif label == WIDE[0]:
        u0s = torch.rand(B, dim, generator=gen, device="cuda") * 4 - 2
        ps = 4 + 4 * torch.rand(B, 1, generator=gen, device="cuda")
    else:
        u0s = (torch.rand(B, dim, generator=gen, device="cuda") * 2 - 1) \
            * math.pi
        ps = torch.stack([1 + 2 * torch.rand(B, generator=gen, device="cuda"),
                          0.2 + 1.8 * torch.rand(B, generator=gen,
                                                 device="cuda")], dim=1)
    return u0s, ps, saveat


def route_kernels(rk, fwd=None):
    """The profiler's names of the CUDA kernels (forward, backward) that an
    instance's route launches; ``fwd``, the forward's design
    (ode_cuda.fwd_plan's), names the sliced forward of a sweep functor."""
    kf, kb = {"lanes": ("rk_kuramoto_kernel", "rk_kuramoto_bwd_kernel"),
              "block": ("rk_kuramoto_block_kernel",
                        "rk_kuramoto_block_bwd_kernel"),
              "sweep": ("rk_fixed_grid_kernel",
                        "rk_fixed_grid_sweep_bwd_kernel"),
              "maps": ("rk_fixed_grid_kernel",
                       "rk_fixed_grid_bwd_kernel")}[rk.backward]
    return ("rk_fixed_grid_sliced_kernel" if fwd == "sliced" else kf), kb


def route_work(rk, B, T, dim, pdim, sub, tab, n_st, clock, plan=None,
               fwd=None):
    """((bytes, operations) of the forward, of the backward, (forward,
    backward) latency model ms) of an instance on its route: Kuramoto's by
    rhs_ops, a generated functor's from its program's operation count; the
    reverse-sweep routes' models by their ``plan`` (ode_cuda.bwd_plan), the
    forward's by its design ``fwd`` (ode_cuda.fwd_plan's)."""
    if rk.program is None:  # Kuramoto: the lane groups or the block
        work = (rk_work(B, T, dim, pdim, sub, tab, n_st, "kuramoto", dim),
                rk_bwd_work(B, T, dim, pdim, sub, tab, n_st, "kuramoto",
                            dim))
        if rk.backward == "lanes":
            return work + ((rk_latency_ms(T, sub, n_st, clock, "kuramoto",
                                          dim),
                            rk_bwd_latency_ms(T, sub, n_st, clock,
                                              "kuramoto", dim)),)
        return work + ((block_latency_ms(T, sub, n_st, dim, clock,
                                         spread=fwd == "spread"),
                        block_latency_ms(T, sub, n_st, dim, clock, bwd=True,
                                         keep=plan["keep"],
                                         spread=plan["spread"])),)
    ops = gen_ops(rk.program)
    if rk.backward == "sweep":
        bwd_lat = sweep_latency_ms(rk.program, T, sub, tab, n_st, clock,
                                   keep=plan["keep"])
    else:
        bwd_lat = gen_bwd_latency_ms(rk.program, T, sub, tab, n_st, clock)
    fwd_lat = (sliced_fwd_latency_ms(rk.program, T, sub, tab, n_st, clock)
               if fwd == "sliced" else
               gen_latency_ms(rk.program, T, sub, tab, n_st, clock))
    return (rk_work(B, T, dim, pdim, sub, tab, n_st, ops=ops),
            rk_bwd_work(B, T, dim, pdim, sub, tab, n_st, ops=ops),
            (fwd_lat, bwd_lat))


# A source built with every forward on the design before the sliced and
# the spread ones (the header's LDQ_RK_FWD_FLOATS at 1): the one-thread
# kernel for a sweep functor, the Kuramoto block forward's sines on the
# oscillators' own lanes.
FWD_BEFORE = "#define LDQ_RK_FWD_FLOATS 1\n"


def forward_before_libraries(fields):
    """{label: the registered FWD_BEFORE library of its instance} of the
    fields whose forward at Tsit5 runs a design past a thread or a warp
    (ode_cuda.fwd_design: "sliced", "spread")."""
    from latentdiffeq_torch.ops import _build, ode_cuda, rhs_codegen
    out = {}
    for label, (f, dim, pdim, *_) in fields.items():
        rk = ode_cuda.rhs_kernel(f, dim, pdim)
        if ode_cuda.fwd_design(rk.backward, dim, 6) not in ("sliced",
                                                            "spread"):
            continue
        if rk.program is not None:
            out[label] = _build.register_generated(
                "rk_gen", FWD_BEFORE + rhs_codegen.kernel_source(rk.program))
        else:
            out[label] = _build.register_generated(
                "rk_kuramoto", FWD_BEFORE + rhs_codegen.kuramoto_source(dim))
    return out


def forward_from(library, f, s, u0s, ps, saveat, sub):
    """(ys, success) from the forward entry point of ``library`` (a build of
    ``f``'s instance source, as forward_before_libraries registers it),
    launched as ode_cuda.solve_fixed_grid_batched_cuda launches the
    instance's own; not counted."""
    from latentdiffeq_torch.ops import _build, ode_cuda
    from latentdiffeq_torch.solve.rk import tableau_f32
    B, dim = u0s.shape
    rk = ode_cuda.rhs_kernel(f, dim, ps.shape[1])
    lib = ode_cuda.typed_library(_build.load_kernel(library))
    n, a, b, c = tableau_f32(s)
    cst = ode_cuda._rhs_consts(f, u0s.device, rk.ncst)
    ys = torch.empty(B, saveat.shape[0], dim, device=u0s.device)
    ok = torch.empty(B, dtype=torch.bool, device=u0s.device)
    err = lib.ldq_rk_fixed_grid(
        0, ode_cuda.tableau_instance(s), n, a.data_ptr(), b.data_ptr(),
        c.data_ptr(), saveat.data_ptr(), u0s.data_ptr(), ps.data_ptr(),
        None if cst is None else cst.data_ptr(), ys.data_ptr(),
        ok.data_ptr(), B, saveat.shape[0], sub,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"{library}: forward launch failed, CUDA error {err}")
    return ys, ok


def exact_forward(rk):
    """Whether an instance's forward fixes every order its plain version
    fixes, so that it is held bit for bit: Kuramoto's (its sums in j order,
    as the plain field's), a generated program without a reduction past
    rhs_trace.EXACT_TERMS terms or a matrix product among what the slope
    needs."""
    if rk.program is None:
        return True
    nodes = {i.node for i in rk.program.needed(rk.program.dy)}
    return not any(n.split(":")[0] in nodes for n in rk.program.inexact)


def gen_kernel_checks(gen, clock, fields):
    """4l (a)-(c) and 4m (a), with the instances' times: each field's
    instance, forward and backward, against the plain versions at its
    train and validation shapes, Tsit5, with PERF.md section 2's gates.
    The forward within TOL of the plain solve, bit for bit where it fixes
    the plain version's order (exact_forward), with the same success flags
    (all rows ok), and at most twice as far from a float64 plain solve as
    the plain float32 solve (+1e-6). The backward on its route: the
    two-phase kernel's interval maps against the plain maps and its
    gradients against the two-phase plain version (maps, lanes); the
    reverse-sweep kernels' gradients against the plain reverse sweep on
    the same trajectory (sweep, block), one launch, within GRAD_TOL of
    each size; the two-phase kernel's also against the step-by-step
    reverse sweep, and every route's against plain autograd (the
    reverse-sweep routes at the train shape), within GRAD_TOL or else at
    most twice as far from the float64 version as the kernel's own
    algorithm in float32. (b): the untagged pendulum and Van der Pol
    against their tagged, hand-written functors on the same inputs, bit
    for bit or the largest gap. Each kernel's time per call and on the
    device beside its plain version's (the plain call that gave the
    reference: the plain reverse sweep for a backward), its bound (bytes,
    and operations: the program's count, Kuramoto's rhs_ops) and its
    latency model (route_work); the hand-written twins timed beside the
    generated ones. Returns ({kernels-line name: largest absolute error
    against the plain version}, {name: (ms, plain_ms, bound_ms, bound_by,
    library_ms)} at the train shape)."""
    from latentdiffeq_torch.ops import _build, ode_cuda
    from latentdiffeq_torch.solve.rk import Tsit5, n_solution_stages
    s = Tsit5()
    tab = s.tableau
    n_st = n_solution_stages(tab)
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda
    old_libs = forward_before_libraries(fields)
    _build.build_kernels(list(old_libs.values()))  # built in phase 1
    worst, times = {}, {}
    for label, (f, dim, pdim, sub, _, twin) in fields.items():
        rk = ode_cuda.rhs_kernel(f, dim, pdim)
        fn = rk_name("rk_fixed_grid", f, dim, pdim)
        bn = rk_name("rk_fixed_grid_bwd", f, dim, pdim)
        maps = rk.backward in ("maps", "lanes")
        for shape, B, T in gen_shapes(label):
            u0s, ps, saveat = gen_inputs(label, B, T, gen)
            w = torch.randn(B, T, dim, generator=gen, device="cuda")
            plan = None
            at = f"{label} {shape} B={B} T={T} substeps={sub}"
            fplan = ode_cuda.fwd_plan(f, s, dim, B, pdim)
            kf, kb = route_kernels(rk, fplan["design"])
            if rk.backward in ("sweep", "block"):
                log("kernels", f"{fn} ({rk.backward} route) {at} Tsit5: "
                               f"forward plan {fplan}; where the design "
                               f"changes at 227 KB (last width, design): "
                               f"{ode_cuda.fwd_switches(rk.backward, n_st)}")
            if rk.backward in ("sweep", "block"):
                plan = ode_cuda.bwd_plan(f, s, dim, B, sub, pdim)
                over = ("width" if rk.backward == "block"
                        else "sub-step count")
                runs = ode_cuda.bwd_switches(rk.backward, dim, n_st, sub)
                log("kernels", f"{bn} ({rk.backward} route) {at} Tsit5: "
                               f"plan {plan} (keeps "
                               f"{ode_cuda.BWD_KEEP[plan['keep']]}"
                               + (f"; {rhs_slices(rk.program)}"
                                  if rk.program is not None else "")
                               + f"); where it changes at 227 KB (last "
                               f"{over}, keeps, spread): {runs}")
            fw, bw, lat = route_work(rk, B, T, dim, pdim, sub, tab, n_st,
                                     clock, plan, fplan["design"])

            def timing(name, kname, kernel, p_ms, work, lat_ms):
                k_ms = time_ms(kernel)
                d_ms = device_ms(kernel, kname)
                b_ms, b_by, t_b, t_o = bound_ms(*work)
                log("timing", f"{name} {at} ({kname}): kernel {k_ms:.4f} "
                              f"ms per call ({fmt_ms(d_ms)} on the device), "
                              f"plain {fmt_ms(p_ms)}, bound {b_ms:.6f} ms "
                              f"({b_by}; bytes {t_b:.6f} ms, operations "
                              f"{t_o:.6f} ms), latency model {lat_ms:.6f} ms"
                              f" at {clock:.0f} MHz; library: none")
                if shape == "train":
                    times[name] = (k_ms, p_ms, b_ms, b_by, None)

            with torch.no_grad():
                got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
                    f, s, u0s, ps, saveat, substeps=sub)
                (ref, ok_p, _), p_ms = plain_timed(
                    lambda: ode_cuda.solve_fixed_grid_batched_reference(
                        f, s, u0s, ps, saveat, substeps=sub))
            e = max_err(got, ref)
            bits = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            flags = torch.equal(ok, ok_p) and bool(ok.all())
            line = (f"{fn} ({rk.backward} route) {at} Tsit5: max abs err "
                    f"{e:.3e} (tol {TOL:.0e}), bit for bit as plain: {bits}"
                    f" (required: {exact_forward(rk)}); success flags as "
                    f"plain, all rows: {flags}")
            good = e <= TOL and flags and (bits or not exact_forward(rk))
            if not bits:  # bit for bit, it is as far from float64 as plain
                with torch.no_grad():
                    ref64 = ode_cuda.solve_fixed_grid_batched_reference(
                        f, s, u0s.double(), ps.double(), saveat.double(),
                        substeps=sub)[0]
                e_k = max_err(got.double(), ref64)
                e_p = max_err(ref.double(), ref64)
                line += (f"; vs float64: kernel {e_k:.3e}, plain {e_p:.3e} "
                         f"(gate 2 x plain + 1e-6)")
                good = good and e_k <= 2 * e_p + 1e-6
            log("kernels", line)
            if not good:
                fail(f"forward {label} {shape}: {line}")
            worst[fn] = max(worst.get(fn, 0.0), e)
            with torch.no_grad():
                timing(fn, kf, lambda: ode_cuda.solve_fixed_grid_batched_cuda(
                    f, s, u0s, ps, saveat, substeps=sub), p_ms, fw, lat[0])
            if label in old_libs:  # the design before, on the same inputs
                old_k = ("rk_fixed_grid_kernel" if rk.program is not None
                         else "rk_kuramoto_block_kernel")
                with torch.no_grad():
                    def old():
                        return forward_from(old_libs[label], f, s, u0s, ps,
                                            saveat, sub)
                    ys_o, ok_o = old()
                    same = (torch.equal(got.view(torch.int32),
                                        ys_o.view(torch.int32))
                            and torch.equal(ok, ok_o))
                    log("kernels", f"{fn} ({fplan['design']}) {at}: against"
                                   f" the design before ({old_k}, "
                                   f"{old_libs[label]}) on the same inputs: "
                                   f"states and flags bit for bit {same}")
                    if not same:
                        fail(f"forward {label} {shape}: the "
                             f"{fplan['design']} design differs from the "
                             f"design before")
                    old_lat = route_work(rk, B, T, dim, pdim, sub, tab,
                                         n_st, clock, plan)[2][0]
                    log("timing", f"{fn} {at}, the design before ({old_k}):"
                                  f" {time_ms(old):.4f} ms per call "
                                  f"({fmt_ms(device_ms(old, old_k))} on the "
                                  f"device), latency model {old_lat:.6f} ms")

            before = bwd.launches.get(rk.name, 0)
            out = bwd(f, s, saveat, got, ps, w, substeps=sub, maps=maps)
            one = bwd.launches[rk.name] == before + 1
            du0, dp = out[:2]
            sweep, p_ms = plain_timed(
                lambda: ode_cuda.solve_fixed_grid_batched_backward_reference(
                    f, s, saveat, got, ps, w, substeps=sub))
            e_sw = max(max_err(a, b) for a, b in zip((du0, dp), sweep))
            line = f"{bn} ({rk.backward} route, one launch: {one}) {at}: "
            if maps:
                J_p, r_p = ode_cuda \
                    .solve_fixed_grid_batched_interval_maps_reference(
                        f, s, saveat, got, ps, substeps=sub)
                own = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(
                    J_p, r_p, w)
                e_maps = max(rel_err(out[2], J_p), rel_err(out[3], r_p))
                e_own = max(rel_err(a, b) for a, b in zip((du0, dp), own))
                line += (f"interval maps vs plain maps max rel err "
                         f"{e_maps:.3e}; gradients vs two-phase plain "
                         f"{e_own:.3e} (tol {GRAD_TOL:.0e})")
                good = max(e_maps, e_own) <= GRAD_TOL
                e_sw = max(e_sw, max(max_err(a, b)
                                     for a, b in zip((du0, dp), own)))
            else:
                own = sweep
                e_own = max(rel_err(a, b) for a, b in zip((du0, dp), own))
                line += (f"gradients vs the plain reverse sweep {e_own:.3e} "
                         f"(tol {GRAD_TOL:.0e})")
                good = e_own <= GRAD_TOL
            good = good and one
            worst[bn] = max(worst.get(bn, 0.0), e_sw)

            def grads(dtype):
                u = u0s.to(dtype).requires_grad_()
                p = ps.to(dtype).requires_grad_()
                y = ode_cuda.solve_fixed_grid_batched_reference(
                    f, s, u, p, saveat.to(dtype), substeps=sub)[0]
                return torch.autograd.grad(y, [u, p], w.to(dtype))

            # the step-by-step sweep and autograd through the plain forward
            # sum in other float32 orders: past GRAD_TOL the kernel is held
            # to a float64 referee, at most twice as far from it as its own
            # algorithm in float32 (as the long grids of phase 3 are)
            refs = {}
            if maps:
                refs["plain reverse sweep"] = (sweep, lambda: ode_cuda
                    .solve_fixed_grid_batched_backward_reference(
                        f, s, saveat.double(), got.double(), ps.double(),
                        w.double(), substeps=sub))
            if maps or shape == "train":
                refs["plain autograd"] = (grads(torch.float32),
                                          lambda: grads(torch.float64))
            for what, (plain32, referee) in refs.items():
                e = max(rel_err(a, b) for a, b in zip((du0, dp), plain32))
                line += f", vs {what} {e:.3e}"
                if e > GRAD_TOL:
                    r64 = referee()
                    e_k = max(rel_err(a.double(), b) for a, b in zip(
                        (du0, dp), r64))
                    e_p = max(rel_err(a.double(), b) for a, b in zip(
                        own, r64))
                    line += (f" (past the tol: vs float64 kernel {e_k:.3e},"
                             f" its algorithm in plain float32 {e_p:.3e}, "
                             f"gate 2 x)")
                    good = good and e_k <= 2 * e_p
            log("kernels", line)
            if not good:
                fail(f"backward {label} {shape}: {line}")
            with torch.no_grad():
                timing(bn, kb, lambda: bwd(f, s, saveat, got, ps, w,
                                           substeps=sub), p_ms, bw, lat[1])

            if twin is not None:  # (b) generated against hand-written
                with torch.no_grad():
                    hw, _ = ode_cuda.solve_fixed_grid_batched_cuda(
                        twin, s, u0s, ps, saveat, substeps=sub)
                hdu0, hdp = bwd(twin, s, saveat, hw, ps, w, substeps=sub)
                same = torch.equal(got.view(torch.int32),
                                   hw.view(torch.int32))
                gap = max_err(got, hw)
                gap_b = max(rel_err(a, b) for a, b in zip((du0, dp),
                                                           (hdu0, hdp)))
                log("kernels", f"{label} {shape}: generated {rk.name} "
                               f"against the hand-written "
                               f"{ode_cuda.rhs_instance(twin, dim)}: forward"
                               f" bit for bit {same}, largest gap "
                               f"{gap:.3e}; gradients (each on its own "
                               f"trajectory) largest relative gap "
                               f"{gap_b:.3e}")
                if gap > TOL or gap_b > GRAD_TOL:
                    fail(f"{label}: generated vs hand-written {gap}, "
                         f"{gap_b}")
                with torch.no_grad():
                    for k, kname, kernel in (
                            ("rk_fixed_grid", rk_kernel("pendulum"),
                             lambda: ode_cuda.solve_fixed_grid_batched_cuda(
                                 twin, s, u0s, ps, saveat, substeps=sub)),
                            ("rk_fixed_grid_bwd", rk_kernel("pendulum", True),
                             lambda: bwd(twin, s, saveat, hw, ps, w,
                                         substeps=sub))):
                        log("timing", f"{rk_name(k, twin, dim)} (hand-written"
                                      f" twin) {at}: kernel "
                                      f"{time_ms(kernel):.4f} ms per call "
                                      f"({fmt_ms(device_ms(kernel, kname))} "
                                      f"on the device)")
    return worst, times


def tutorial_on_card(f_copy):
    """4l (e): the tutorial's main on the card, 2 epochs: its own
    pendulum_f runs on the generated instance (the one its verbatim copy
    names), the RK backward launches once a train step, no plain solve.
    Returns (its field, its trainer's history)."""
    from latentdiffeq_torch.examples.tutorial import tutorial
    from latentdiffeq_torch.ops import ode_cuda
    tutorial.OUTPUT_DIR = os.path.join(CLI_DIR, "tutorial_4l")
    reset_counts()
    t0 = time.perf_counter()
    res = tutorial.main(["--epochs", "2"])
    torch.cuda.synchronize()
    tut_s = time.perf_counter() - t0
    trainer = res["trainer"]
    f = trainer.model.decoder.diffeq.f
    inst = ode_cuda.rhs_instance(f, 2, 1)
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    steps = 2 * (405 // trainer.cfg.batch_size)
    plain = ode_cuda.solve_fixed_grid_batched_reference.calls
    hist = trainer.history
    log("4l", f"tutorial --epochs 2 on the card in {tut_s:.3f} s: its field "
              f"{f.__name__!r} (device_rhs {getattr(f, 'device_rhs', None)})"
              f" on instance {inst} (its copy's: "
              f"{ode_cuda.rhs_instance(f_copy, 2, 1)}); RK launches forward "
              f"{dict(fwd)}, backward {dict(bwd)} (backward expected "
              f"{steps}); plain solve calls {plain}; losses "
              f"{[(round(h['train_loss'], 4), round(h['val_loss'], 4)) for h in hist]}")
    if (inst != ode_cuda.rhs_instance(f_copy, 2, 1) or not inst.startswith(
            "gen_") or set(fwd) != {inst} or bwd != {inst: steps}
            or fwd[inst] < 2 * steps or plain != 0 or len(hist) != 2
            or not all(math.isfinite(h["train_loss"]) for h in hist)):
        fail("4l: the tutorial did not train on the generated RK instance")
    return f, hist


def gen_path(train_set, val_set, tagged_hist, dev, gpu):
    """4l: each instance's spills, the tutorial on the card (e), GOKU at
    full width on the full video with the tutorial's field (d), and GOKU
    on Kuramoto-7 data (f); (a)-(c), the instances against the plain
    versions and the hand-written functors, ran in phase 5
    (gen_kernel_checks). Returns {kernels-line name: launches}."""
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import ODEDynamics, goku_default_layers
    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import Tsit5
    from latentdiffeq_torch.train import TrainConfig

    fields = gen_fields()
    for label, (f, dim, pdim, *_) in fields.items():
        rk = ode_cuda.rhs_kernel(f, dim, pdim)
        spills = spill_lines(rk.library)
        log("4l", f"{label}: instance {rk.name}, backward route "
                  f"{rk.backward}, library {rk.library}; kernels that spill "
                  f"(ptxas -v): {len(spills)}" + "".join(
                      f"; {fn}: {ln}" for fn, ln in spills))
    f_tut, _ = tutorial_on_card(fields["tutorial"][0])

    # (d) GOKU at full width on the full video, the tutorial's field
    diffeq = ODEDynamics(f=f_tut, z_dim=2, theta_dim=1, solver=Tsit5(),
                         options=SolveOptions(adaptive=False, substeps=1))
    layers = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    launches, trainer, _, _ = goku_path(
        "pendulum, the tutorial's field", train_set, val_set, diffeq,
        layers, TrainConfig(epochs=1500, save_best=False), dev, gpu)
    gaps = [max(abs(a["train_loss"] - b["train_loss"]),
                abs(a["val_loss"] - b["val_loss"]))
            for a, b in zip(trainer.history, tagged_hist)]
    log("4l", f"GOKU on the tutorial's field against the tagged pendulum "
              f"run (phase 4, same seed and batches): loss gaps by epoch "
              f"{[f'{g:.3e}' for g in gaps]} (tol {PATH_TOL:.0e})")
    if len(gaps) != 2 or max(gaps) > PATH_TOL:
        fail(f"4l: tutorial-field GOKU losses {gaps} from the tagged run's")

    # (f) GOKU on Kuramoto-7 data, at the JAX examples' width
    c_train, c_val, c_diffeq, c_cfg = custom_dataset(
        f"kuramoto{KURAMOTO_N}", dev)
    c_layers = goku_default_layers(
        64, c_diffeq, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
        generator=torch.Generator().manual_seed(0), device=dev)
    k_launches = goku_path(f"kuramoto{KURAMOTO_N}", c_train, c_val, c_diffeq,
                           c_layers, c_cfg, dev, gpu)[0]
    launches.update(k_launches)
    return {k: v for k, v in launches.items()
            if k.startswith("rk_fixed_grid")}


def program_cycles(prog, outputs, ready):
    """Cycles until every value of ``outputs`` is ready, given the ready
    times of the program's inputs (``ready``, by scalar id; per-row values
    are ready at 0): FMA_CYC an arithmetic op, SFU_CYC a division,
    reciprocal or square root, SIN_STEPS FMA steps a sinf, cosf, expf,
    logf, tanhf or powf. Returns the ready times of ``outputs``."""
    slow = {"sin", "cos", "exp", "log", "tanh", "pow"}
    sfu = {"div", "divs", "recip", "sqrt", "rsqrt"}
    at = dict(ready)
    for ins in prog.needed(outputs):
        if ins.out in prog.per_row:
            at[ins.out] = 0
            continue
        t = max([at.get(a, 0) for a in ins.args if isinstance(a, int)],
                default=0)
        at[ins.out] = t + (SIN_STEPS * FMA_CYC if ins.op in slow else
                           SFU_CYC if ins.op in sfu else FMA_CYC)
    return [at.get(r, 0) if isinstance(r, int) else 0 for r in outputs]


def gen_step_cycles(prog, tab, n_stages):
    """The critical path of one RK step of a generated functor, from the
    step's state to the next: stage s's input is y + sum_q (dt a_sq) k_q,
    added in order (the product of each term in parallel, the adds one
    after another), its slope the forward program; then the update."""
    dim = prog.dim
    k = []
    for s in range(n_stages):
        Y = [0] * dim
        for q, a in enumerate(tab.a[s]):
            if a != 0.0:
                Y = [max(Y[d], k[q][d] + FMA_CYC) + FMA_CYC
                     for d in range(dim)]
        ready = dict(zip(prog.u_ids, Y))
        ready[prog.t_id] = 0
        k.append(program_cycles(prog, prog.dy, ready))
    y = [0] * dim
    for s, b in enumerate(tab.b[:n_stages]):
        if b != 0.0:
            y = [max(y[d], k[s][d] + FMA_CYC) + FMA_CYC for d in range(dim)]
    return max(y)


def gen_latency_ms(prog, T, substeps, tab, n_stages, clock_mhz):
    """Least time of a trajectory's chain in the forward kernel: (T - 1) *
    substeps steps of `gen_step_cycles`."""
    return ((T - 1) * substeps * gen_step_cycles(prog, tab, n_stages)
            / (clock_mhz * 1e3))


def gen_bwd_latency_ms(prog, T, substeps, tab, n_stages, clock_mhz):
    """The backward kernel's chain for a generated functor, as
    rk_bwd_latency_ms has the one-thread kernel's: per chunk of intervals
    one interval (per sub-step the step's stages, then the VJP program of
    each stage in reverse, the basis cotangents in parallel, its
    cotangent updates 2 FMA steps, and the dim-term composition) and a
    barrier; then T - 1 links of a dim-term dot product and an add."""
    dim = prog.dim
    ready = {i: 0 for i in prog.u_ids + prog.kb_ids + [prog.t_id]}
    vjp = max(program_cycles(prog, prog.ubar + prog.pbar, ready))
    interval = substeps * (gen_step_cycles(prog, tab, n_stages)
                           + n_stages * (vjp + 2 * FMA_CYC)
                           + dim * 2 * FMA_CYC)
    chunks = math.ceil((T - 1) / RK_BWD_CHUNK)
    cyc = chunks * (interval + BAR_CYC) + (T - 1) * (dim + 1) * FMA_CYC
    return cyc / (clock_mhz * 1e3)


def rhs_slices(prog):
    """A sweep functor's slices as its generated source states them."""
    from latentdiffeq_torch.ops import rhs_codegen
    plan = rhs_codegen.plan_slices(prog)
    return (f"{plan.count} slices, statements a stage: eval "
            f"{list(plan.eval_cost)} (whole {plan.whole[0]}), vjp "
            f"{list(plan.vjp_cost)} (whole {plan.whole[1]})")


def gen_ops(prog):
    """(operations of one evaluation, of one VJP) of a generated functor:
    its scalar operations that run a stage (the per-row ones run once a
    row and are left out)."""
    return tuple(sum(1 for i in prog.needed(out) if i.out not in
                     prog.per_row) for out in (prog.dy, prog.ubar + prog.pbar))


# ---------------------------------------------------------------------------
# Phase 4m: every field JAX's Pallas solve runs goes through the RK kernel:
# GOKU on Lorenz-96 at 40 (a generated functor on the sliced kernels
# rk_fixed_grid_sliced_kernel and rk_fixed_grid_sweep_bwd_kernel) and on
# Kuramoto at 64 (the block kernels rk_kuramoto_block_kernel, its sines
# spread over the block, and rk_kuramoto_block_bwd_kernel); the kernels
# against their plain versions in phase 5 (gen_kernel_checks).

LOSS_TOL = 1e-4  # kernel route against the plain route, of each loss's size


def lorenz96_dataset(dev):
    """Lorenz-96 data in the custom dynamics' recipe: 256 trajectories x
    100 frames, dt 0.1, 4 sub-steps of Tsit5 (the plain solve), x0 ~
    U(-2, 2), F ~ U(4, 8), observed through a seeded random relu lift to
    64 channels scaled to [0, 1] (custom_data's observation); 230 / 26,
    batch 64, seq 50. Returns (train set, val set, dynamics, config)."""
    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import ODEDynamics
    from latentdiffeq_torch.ops import ode_cuda
    from latentdiffeq_torch.solve.rk import Tsit5
    from latentdiffeq_torch.train import TrainConfig, splitobs
    g = torch.Generator(device=dev).manual_seed(40)
    u0s = torch.rand(256, L96_N, generator=g, device=dev) * 4 - 2
    ps = 4 + 4 * torch.rand(256, 1, generator=g, device=dev)
    saveat = torch.arange(100, dtype=torch.float32, device=dev) * CUSTOM_DT
    with torch.no_grad():
        z, ok, _ = ode_cuda.solve_fixed_grid_batched_reference(
            lorenz96, Tsit5(), u0s, ps, saveat, substeps=CUSTOM_SUBSTEPS)
        W = torch.randn(L96_N, 64, generator=g, device=dev) / L96_N ** 0.5
        b = torch.randn(64, generator=g, device=dev)
        x = torch.relu(z @ W + b)
        x = (x - x.min()) / (x.max() - x.min())
    if not bool(ok.all()):
        fail("Lorenz-96 data: a trajectory failed")
    diffeq = ODEDynamics(f=lorenz96, z_dim=L96_N, theta_dim=1,
                         solver=Tsit5(), options=SolveOptions(
                             adaptive=False, substeps=CUSTOM_SUBSTEPS))
    cfg = TrainConfig(jit_epoch=False, batch_size=64, seq_len=50,
                      dt=CUSTOM_DT, seed=7,
                      epochs=300, save_best=False)
    train_set, val_set = splitobs(x, 0.9)
    return train_set, val_set, diffeq, cfg


def wide_path(dev, gpu):
    """4m: GOKU at the custom dynamics' width
    (goku_default_layers(64, ..., 100, 100), input 64 as train_kuramoto.py)
    on each field, both kernel switches on, 2 epochs (goku_path: a forward
    launch a train step and a validation pass, a backward launch a train
    step, no plain solve; the kernel path against the plain path on the
    trained weights); then the kernel route and the plain route from the
    same seed for one epoch on the first batch and 8 validation rows (one
    train step and a validation pass: the plain Kuramoto-64 route takes
    ~8 s a step), losses within LOSS_TOL of each loss's size. Returns
    {kernels-line name: launches}."""
    from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                           goku_default_layers)
    from latentdiffeq_torch.train import Trainer

    launches = {}
    for label in WIDE:
        if label == WIDE[0]:
            train_set, val_set, diffeq, cfg = lorenz96_dataset(dev)
        else:
            train_set, val_set, diffeq, cfg = custom_dataset(label, dev)

        def layers():
            return goku_default_layers(
                64, diffeq, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
                generator=torch.Generator().manual_seed(0), device=dev)
        got = goku_path(label, train_set, val_set, diffeq, layers(), cfg,
                        dev, gpu)[0]
        launches.update({k: v for k, v in got.items()
                         if k.startswith("rk_fixed_grid")})
        first, few = train_set[:cfg.batch_size], val_set[:8]
        hists = []
        t0 = time.perf_counter()
        for kind in (GOKUBasic(use_kernel_encoder=True,
                               use_kernel_solver=True), GOKUBasic()):
            tr = Trainer(LatentDiffEqModel.build(kind, *layers()), cfg,
                         device=dev)
            hists.append(tr.fit(first, few, epochs=1, verbose=False))
        torch.cuda.synchronize()
        gaps = [abs(hists[0][0][k] - hists[1][0][k]) / abs(hists[1][0][k])
                for k in ("train_loss", "val_loss")]
        log("4m", f"GOKU on {label}, kernel route against the plain route "
                  f"(same seed and weights, one epoch on the first batch "
                  f"and 8 validation rows, both routes in "
                  f"{time.perf_counter() - t0:.3f} s): train, val losses "
                  f"{hists[0][0]['train_loss']:.6f}, "
                  f"{hists[0][0]['val_loss']:.6f} against "
                  f"{hists[1][0]['train_loss']:.6f}, "
                  f"{hists[1][0]['val_loss']:.6f}, relative gaps "
                  f"{[f'{g:.3e}' for g in gaps]} (tol {LOSS_TOL:.0e}); card "
                  f"{gpu}")
        if max(gaps) > LOSS_TOL:
            fail(f"4m: {label} kernel-route losses {gaps} from the plain "
                 f"route's")
    return launches


# A shared-memory load's latency, cycles (round figure, not a measurement).
LDS_CYC = 30
# Sub-steps of stages run again an interval by what a reverse-sweep backward
# keeps (ode_cuda.BWD_KEEP): every stage input, the sub-step starts, nothing.
RECOMPUTED = {2: lambda u: u, 1: lambda u: 2 * u - 1,
              0: lambda u: u * (u + 1) // 2}


def slice_cycles(prog, outputs):
    """(latency, issue) cycles of one slice of a generated program a stage:
    its critical path with the stage inputs and cotangents ready after a
    shared-memory load (program_cycles), and its instructions (its
    statements, a load for each input it reads, a store or add for each
    output)."""
    inputs = set(prog.u_ids + prog.kb_ids)
    ready = {i: LDS_CYC for i in inputs}
    ready[prog.t_id] = 0
    lat = max(program_cycles(prog, outputs, ready), default=0)
    needed = [i for i in prog.needed(outputs) if i.out not in prog.per_row]
    read = {a for i in needed for a in i.args if a in inputs}
    read |= {r for r in outputs if r in inputs}
    return lat, len(needed) + len(read) + len(outputs)


def sweep_latency_ms(prog, T, substeps, tab, n_stages, clock_mhz, keep=2):
    """The reverse-sweep kernel's chain for a generated functor, counting
    issue as well as latency. The sliced kernel (keep 2, 1, 0: its
    ``ode_cuda.bwd_plan``): G = SLICES warps a row, ceil(G / 4) of them on
    each of the SM's 4 schedulers; a slice's stage takes the longer of its
    critical path and its scheduler's issue (the warps sharing it, each
    its slice's instructions: slice_cycles), the longest slice a stage.
    Per interval the recomputed sub-steps (RECOMPUTED[keep]: per stage the
    stage input of its own entries, a term a nonzero a_sq, each a
    shared-memory load of the slope and a multiply and an add one after
    another (the loop is rolled), a barrier, the eval slices) and, per
    swept sub-step, per stage a barrier, the vjp slices and the cotangent
    updates (a load, a multiply and an add a term), then a barrier. The
    one-thread kernel (keep -1): per interval and sub-step j, j + 1 steps
    of `gen_step_cycles`, then the whole VJP program of each stage in
    reverse and its updates."""
    if keep == -1:
        ready = {i: 0 for i in prog.u_ids + prog.kb_ids + [prog.t_id]}
        vjp = max(program_cycles(prog, prog.ubar + prog.pbar, ready))
        step = gen_step_cycles(prog, tab, n_stages)
        per = (substeps * (substeps + 1) // 2 * step
               + substeps * n_stages * (vjp + 2 * FMA_CYC))
        return (T - 1) * per / (clock_mhz * 1e3)
    fwd, bwd = sliced_stage_cycles(prog, tab, n_stages)
    per = RECOMPUTED[keep](substeps) * fwd + substeps * bwd
    return (T - 1) * per / (clock_mhz * 1e3)


def sliced_stage_cycles(prog, tab, n_stages, unrolled=False):
    """(a sub-step's stages, a sub-step's sweep) in cycles, in the sliced
    kernels (sweep_latency_ms): per stage its inputs' terms (a shared-memory
    load of a_sq and of the slope, a multiply and an add a nonzero a_sq,
    one chain for all the slice's entries; ``unrolled``, as the sliced
    forward takes them, every load at once and then the multiplies and
    adds), a barrier and the longest eval slice; per swept stage a barrier,
    the longest vjp slice and the cotangent updates, then a barrier."""
    from latentdiffeq_torch.ops import rhs_codegen
    plan = rhs_codegen.plan_slices(prog)
    share = math.ceil(plan.count / 4)

    def stage(parts):
        cyc = [slice_cycles(prog, outs) for outs in parts]
        return max(max(c[0] for c in cyc), share * max(c[1] for c in cyc))
    ev = stage([[prog.dy[i] for i in part] for part in plan.eval_parts])
    vj = stage([[prog.ubar[i] for i in u] + [prog.pbar[q] for q in pq]
                for u, pq in zip(plan.vjp_ubar, plan.vjp_pbar)])
    counts = [sum(1 for a in tab.a[s][:s] if a != 0.0)
              for s in range(n_stages)]
    terms = [c * (LDS_CYC + 2 * FMA_CYC) for c in counts]
    fwd = sum((LDS_CYC * (c > 0) + 2 * FMA_CYC * c if unrolled else t)
              + BAR_CYC + ev for c, t in zip(counts, terms))
    bwd = sum(BAR_CYC + vj + FMA_CYC + t for t in terms) + BAR_CYC
    return fwd, bwd


def sliced_fwd_latency_ms(prog, T, substeps, tab, n_stages, clock_mhz):
    """The sliced forward's chain for a trajectory: (T - 1) * substeps
    sub-steps of the sliced stages, their terms unrolled
    (sliced_stage_cycles), and the update, the slopes' shared-memory loads
    at once, then a multiply and an add a nonzero b_s."""
    fwd, _ = sliced_stage_cycles(prog, tab, n_stages, unrolled=True)
    update = LDS_CYC + (sum(1 for b in tab.b[:n_stages] if b != 0.0)
                        * 2 * FMA_CYC)
    return (T - 1) * substeps * (fwd + update) / (clock_mhz * 1e3)


def block_threads(dim):
    """Threads a block and oscillators a lane of the Kuramoto block forward
    (csrc/rk_fixed_grid.cuh: kKurBlockThreads, kKurBlockOsc), and the
    backward's lanes an oscillator (kKurBlockBwdLanes)."""
    th = min((dim + 31) // 32 * 32, 512)
    lanes = next(g for g in (8, 4, 2, 1) if th * g <= 512)
    return th, -(-dim // th), lanes


def block_latency_ms(T, substeps, n_stages, dim, clock_mhz, bwd=False,
                     keep=2, spread=False):
    """The Kuramoto block kernels' chain for a trajectory. A stage of the
    forward (its ``ode_cuda.fwd_plan``: spread or not) and of the
    backward's recompute (its ``ode_cuda.bwd_plan``: keep, spread): a
    barrier and each of a lane's oscillators' N sines issued one after
    another (`kuramoto_stage_cycles` with the diagonal's) or, spread, a
    barrier, the N^2 pairs' sines over the block's warps (ceil(warps / 4)
    a scheduler, each issuing its lanes' share), a barrier and lane i's N
    dependent adds. The backward, per interval the recomputed sub-steps
    (RECOMPUTED[keep]) of those stages; then per swept sub-step and
    stage three barriers (the cotangent row, the block sum), each lane's
    ceil(N / G) sines and cosines with the three sums (SINCOS_ISSUE each,
    ceil(warps / 4) warps a scheduler), the group's xor tree and the block
    sum's shuffles (SHFL_CYC + FMA_CYC a level) and its cotangent
    updates."""
    th, osc, lanes = block_threads(dim)
    share = math.ceil(th * lanes // 32 / 4)
    if spread:
        rec = (2 * BAR_CYC + 3 * FMA_CYC
               + share * math.ceil(dim * dim / (th * lanes)) * SINF_ISSUE
               + SINF_STEPS * FMA_CYC + LDS_CYC + dim * FMA_CYC)
    else:
        rec = osc * kuramoto_stage_cycles(dim + 1) + BAR_CYC
    if not bwd:
        return ((T - 1) * substeps * n_stages * rec) / (clock_mhz * 1e3)
    rev = (3 * BAR_CYC + share * osc * math.ceil(dim / lanes) * SINCOS_ISSUE
           + (int(math.log2(lanes)) + 5) * (SHFL_CYC + FMA_CYC) + 4 * FMA_CYC)
    per = (RECOMPUTED[keep](substeps) * n_stages * rec
           + substeps * n_stages * rev)
    return (T - 1) * per / (clock_mhz * 1e3)


def spill_lines(name):
    """(kernel, its stack and spill line) of each kernel of a library's
    build log that spills (ptxas -v)."""
    import re
    from latentdiffeq_torch.ops import _build
    out, fn = [], None
    for line in _build.build_log(name).splitlines():
        if "Function properties for" in line:
            fn = line.split("for", 1)[1].strip()
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and int(m.group(1)) > 0 and fn is not None:
            out.append((fn, line.strip()))
    return out


def step_device_ops(trainer, data, beta):
    """(device ops, device busy ms, span ms, lost_kernel_records) of one
    train step in a profiler window (profiler_window)."""
    prof, lost = profiler_window(lambda: trainer.train_step(data, beta))
    evs = device_events(prof)
    busy_us = sum(getattr(e, "device_time", None)
                  or getattr(e, "cuda_time", 0) for e in evs)
    span_us = (max(e.time_range.end for e in evs)
               - min(e.time_range.start for e in evs)) if evs else 0
    return len(evs), busy_us / 1e3, span_us / 1e3, lost


def profile_step(trainer, data, val_set, beta, fname, what):
    def run():
        trainer.train_step(data, beta)
        trainer.val_step(val_set, beta)
    prof, lost = profiler_window(run)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    host = prof.key_averages().table(sort_by="self_cpu_time_total",
                                     row_limit=25)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", fname), "w") as f:
        f.write(table + "\nBy host time:\n" + host)
    evs = device_events(prof)
    busy_us = sum(getattr(e, "device_time", None)
                  or getattr(e, "cuda_time", 0) for e in evs)
    span_us = (max(e.time_range.end for e in evs)
               - min(e.time_range.start for e in evs)) if evs else 0
    log("profile", f"{what}, one train step + val pass: {len(evs)} device "
                   f"ops, device busy {busy_us / 1e3:.3f} ms of a "
                   f"{span_us / 1e3:.3f} ms span ({lost_str(lost)}); table "
                   f"in chiprun_out/{fname}")
    for line in table.splitlines()[:14]:
        log("profile", line)


def bound_ms(nbytes, flops):
    """(bound, what bounds it, bytes time, operations time), in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def main():
    if "--dp-worker" in sys.argv[1:]:
        return dp_worker(sys.argv[sys.argv.index("--dp-worker") + 1:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from latentdiffeq_torch.adjoint import SolveOptions
    from latentdiffeq_torch.models import goku_default_layers
    from latentdiffeq_torch.ops import _build, ode_cuda
    from latentdiffeq_torch.pendulum import Pendulum
    from latentdiffeq_torch.pendulum_data import (draw_initial_conditions,
                                                  generate_dataset)
    from latentdiffeq_torch.train import TrainConfig, splitobs

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    # the port's sources, phase 4l's and 4m's instances and phase 5's
    # builds of them on the forwards before, all at once
    built = _build.build_kernels(list(dict.fromkeys(
        list(_build.KERNEL_SOURCES)
        + [ode_cuda.rhs_kernel(*spec).library for spec in gen_specs()]
        + list(forward_before_libraries(gen_fields()).values()))))
    log("build", f"{sorted(built)} in {time.perf_counter() - t0:.2f} s "
                 f"(compiled now: {sorted(n for n, b in built.items() if b)})"
                 f"; card: {gpu}; torch {torch.__version__} cuda "
                 f"{torch.version.cuda}")
    for name in _build.KERNEL_SOURCES:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        for line in dict.fromkeys(lines):
            log("build", f"{name}: {line}")

    log_phase("phase 2")
    # ---- 2. kernels vs plain ----------------------------------------------
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    heads = enc[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    # the bf16 phases draw from their own generator, so every float32
    # check sees the inputs it saw before they were added
    gen_bf = torch.Generator(device=dev).manual_seed(16)
    errs = {"goku_heads": goku_kernel_checks(heads, gen)}
    errs.update(goku_bf16_kernel_checks(heads, gen_bf))
    errs.update(rk_kernel_checks(gen))
    errs["node_field_fwd"] = node_kernel_checks()
    torch.cuda.synchronize()

    log_phase("phase 3")
    # ---- 3. gradients -----------------------------------------------------
    errs["goku_heads_bwd"] = goku_grad_checks(heads, gen)
    errs.update(goku_bf16_grad_checks(heads, gen_bf))
    errs.update(rk_grad_checks(gen))
    errs["node_field_bwd"], errs["node_field_dw"] = node_grad_checks()
    dw_errs = node_dw_checks()
    errs["node_field_dw"] = max(errs["node_field_dw"], dw_errs["node_field_dw"])
    errs["node_field_dw[pop4]"] = dw_errs["node_field_dw[pop4]"]

    log_phase("phase 4")
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
    layers = goku_default_layers(
        784, diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    launches, trainer, data, beta = goku_path(
        "pendulum", train_set, val_set, diffeq, layers,
        TrainConfig(jit_epoch=False, epochs=1500, save_best=False), dev, gpu)

    log_phase("phase 4b")
    # ---- 4b. second main path: LatentODE training on the same video ------
    node_launches, node_trainer, node_data, node_beta = latent_ode_path(
        train_set, val_set, dev, gpu)
    launches.update(node_launches)

    log_phase("phase 4c")
    # ---- 4c, 4d. GOKU on Van der Pol and on Kuramoto-10 at the JAX
    # examples' width: goku_default_layers(64, diffeq, hidden_dim_resnet=100,
    # latent_to_diffeq_dim=100), RNN/LSTM 32->16->16, latent 16 (the kernels
    # line's goku_heads counts stay the pendulum path's)
    for which in CUSTOM:
        c_train, c_val, c_diffeq, c_cfg = custom_dataset(which, dev)
        layers = goku_default_layers(
            64, c_diffeq, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
            generator=torch.Generator().manual_seed(0), device=dev)
        path_launches = goku_path(which, c_train, c_val, c_diffeq, layers,
                                  c_cfg, dev, gpu)[0]
        launches.update({k: v for k, v in path_launches.items()
                         if k.startswith("rk_fixed_grid")})

    log_phase("phase 4e")
    # ---- 4e. the solve API and the adjoints on the card -------------------
    solve_api_card_checks(dev)
    sde_api_card_check(dev)

    log_phase("phase 4f")
    # ---- 4f. GOKU on the stochastic pendulum (the goku_heads kernels; the
    # SDE solve is plain PyTorch, as in the JAX package) -------------------
    sde_model = spendulum_path(train_set, val_set, dev, gpu)

    log_phase("phase 4g")
    # ---- 4g. GOKU on the pendulum as a population of 8 seeds (one launch of
    # each kernel a call for all replicas), and the autosize probe ----------
    pop_launches, pop_errs, pop_ms = population_path(
        train_set, val_set, sde_model, dev, gpu, gen)
    errs.update(pop_errs)
    for k in ("goku_heads", "goku_heads_bwd"):
        launches[f"{k}[pop8]"] = pop_launches[k]

    log_phase("phase 4h")
    # ---- 4h. bf16 NN stages around a float32 solve: solo, then the
    # population of 8 (the bf16 instances of the heads kernels) ------------
    bf16_launches, bf16_trainer, bf16_data, bf16_beta = bf16_solo_path(
        train_set, val_set, dev, gpu)
    launches.update(bf16_launches)
    bpop_launches, bpop_errs, bpop_ms = population_path(
        train_set, val_set, None, dev, gpu, gen_bf, dtype=BF)
    errs.update(bpop_errs)
    for k in ("goku_heads", "goku_heads_bwd"):
        launches[f"{k}[pop8-bf16]"] = bpop_launches[k]

    log_phase("phase 4i")
    # ---- 4i. LatentODE as a population of 4 seeds: the forward, sweep and
    # weight-gradient kernels each once for all replicas -------------------
    node_pop = latent_ode_population_path(train_set, val_set, dev, gpu)
    for k in ("node_field_fwd", "node_field_bwd", "node_field_dw"):
        launches[f"{k}[pop4]"] = node_pop[k]

    log_phase("phase 4j")
    # ---- 4j. the training CLIs through their main(argv) -------------------
    _, cli_goku = cli_path((latent, u0s_d, ps_d, frames), dev, gpu)

    log_phase("phase 4n")
    # ---- 4n. block mode: the epochs as CUDA graphs against the per-step
    # loop, bit for bit (before phase 5 and 4k, whose profiler sessions
    # come after every window it opens); parts (a)-(e) run last ---------
    block_path(train_set, val_set, dev, gpu, only=BLOCK_FIRST)
    # the same two as Trainer(mesh=make_mesh(1)) on a one-rank NCCL group:
    # DDP's all-reduces inside the captured epochs
    log_phase("phase 4n, on a mesh")
    mesh_block_path(train_set, val_set, dev, gpu)

    log_phase("phase 5")
    # ---- 5. kernel timing -------------------------------------------------
    clock = max_sm_clock_mhz()
    times = goku_timing(heads, gen, clock, dev)
    times.update(goku_timing(as_dtype(heads, BF), gen_bf, clock, dev))
    times.update(rk_timing(gen, clock))
    times.update(node_timing(clock))
    times.update(node_dw_timing())
    node_pop_times, node_pop_errs = node_population_timing(clock)
    times.update(node_pop_times)
    errs.update(node_pop_errs)
    times.update(population_timing(pop_ms, gen, clock, dev))
    times.update(population_timing(bpop_ms, gen_bf, clock, dev))
    # phase 4l's and 4m's instances (the tutorial's by its copy, the same
    # library) against their plain versions and timed here, before 4k,
    # after which torch.profiler drops launches
    gen_errs, gen_times = gen_kernel_checks(
        torch.Generator(device=dev).manual_seed(16), clock, gen_fields())
    errs.update(gen_errs)
    times.update(gen_times)

    log_phase("phase 4k")
    # ---- 4k. data parallelism, the profiling utilities, the native
    # renderer and the tutorial: after phase 5, whose check that
    # solve_neural_field runs no library product reads the node kernels'
    # launches from torch.profiler, which drops some (device_ms): run after
    # 4k, it saw no node_field_fwd_kernel in any of its windows in both
    # runs that tried (PERF.md, open questions) ---------------------------
    dp_path(cli_goku, train_set, val_set, dev, gpu)

    log_phase("phase 4l")
    # ---- 4l. user-written fields on the RK kernel: generated functors,
    # Kuramoto-7 on the lane-group kernels, GOKU and the tutorial on the
    # tutorial's own field (the instances' checks and times ran in phase
    # 5) ---------------------------------------------------------------
    gen_launches = gen_path(train_set, val_set, trainer.history, dev, gpu)

    log_phase("phase 4m")
    # ---- 4m. every field JAX's Pallas solve runs: GOKU on Lorenz-96 at 40
    # (a generated forward, the reverse-sweep backward) and on Kuramoto at
    # 64 (the block kernels), kernel route against plain route ------------
    gen_launches.update(wide_path(dev, gpu))
    launches.update(gen_launches)

    log_phase("phase 4n, continued")
    # ---- 4n. block mode for SDE dynamics, adaptive solves and populations:
    # last, since phase 5's node_field check reads torch.profiler, which
    # dropped its forward kernel's records after these windows (~1e6
    # device ops in the adaptive SPendulum's) ------------------------------
    block_path(train_set, val_set, dev, gpu, only=BLOCK_LAST)

    heads_src = "latentdiffeq_torch/csrc/goku_heads.cu"
    rk_src = "latentdiffeq_torch/csrc/rk_fixed_grid.cu"
    node_src = "latentdiffeq_torch/csrc/node_field.cu"
    origin = {"goku_heads": (heads_src, "recurrent_pallas.py:86"),
              "goku_heads_bwd": (heads_src, "recurrent_pallas.py:142"),
              "rk_fixed_grid": (rk_src, "ode_pallas.py:130"),
              "rk_fixed_grid_bwd": (rk_src, "ode_pallas.py:156"),
              "node_field_fwd": (node_src, "node_pallas.py:154"),
              "node_field_bwd": (node_src, "node_pallas.py:269"),
              "node_field_dw": (node_src, "node_pallas.py:269")}
    kernels = []
    for name in (list(origin) + [f"{k}[{inst}]" for inst in CUSTOM
                                 for k in ("rk_fixed_grid",
                                           "rk_fixed_grid_bwd")]
                 + ["goku_heads[pop8]", "goku_heads_bwd[pop8]",
                    "goku_heads[bf16]", "goku_heads_bwd[bf16]",
                    "goku_heads[pop8-bf16]", "goku_heads_bwd[pop8-bf16]",
                    "node_field_fwd[pop4]", "node_field_bwd[pop4]",
                    "node_field_dw[pop4]"] + sorted(gen_launches)):
        src, replaces = origin[name.split("[")[0]]
        if name in gen_launches:  # generated sources on the header's kernels
            src = "latentdiffeq_torch/csrc/rk_fixed_grid.cuh"
        k_ms, p_ms, b_ms, b_by, lib_ms = times[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"latentdiffeq/ops/{replaces}",
                        "launches": launches[name],
                        "max_abs_err": errs[name], "ms": k_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms})

    if profile:
        profile_step(trainer, data, val_set, beta, "profile_step.txt", "GOKU")
        profile_step(node_trainer, node_data, val_set, node_beta,
                     "profile_step_latent_ode.txt", "LatentODE")
        profile_step(bf16_trainer, bf16_data, val_set, bf16_beta,
                     "profile_step_bf16.txt", "GOKU, bf16 NN stages")

    log_phase("the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
