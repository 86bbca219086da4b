"""CUDA kernels for the batched fixed-grid RK solve and its gradient
(replace the Pallas TPU kernel
latentdiffeq/ops/ode_pallas.py::pallas_solve_fixed_grid_batched and its
``custom_vjp``).

``solve_fixed_grid_batched`` runs the kernels on CUDA tensors and the plain
PyTorch version on CPU tensors. As JAX's Pallas solve traces any ``f(u, p,
t)`` into its kernel, the kernels run any field, through one of three kinds
of instance (``rhs_kernel``; ``rhs_instance`` names it, and the two
launchers count their launches by that name):
- a field tagged ``device_rhs`` at a width in ``DEVICE_RHS`` keeps its
  hand-written functor in csrc/rk_fixed_grid.cu (pendulum, damped pendulum,
  Van der Pol; Kuramoto at 4 and 10 oscillators on the lane-group kernels);
- Kuramoto at another width N gets the kernels instantiated for N,
  ``kuramotoN``, from a one-line source that includes
  csrc/rk_fixed_grid.cuh: the lane-group kernels from 2 to
  ``rhs_codegen.KURAMOTO_LANES_MAX_N`` oscillators, the block kernels (a
  block a trajectory, a reverse-sweep backward) past it, up to
  ``rhs_codegen.KURAMOTO_MAX_N`` (their shared memory);
- any other field is traced on one row with its VJP (ops/rhs_trace.py) and
  runs on a device functor generated from the trace (ops/rhs_codegen.py),
  ``gen_<hash8>`` (the hash of the generated source), cached by the field
  object and (dim, pdim), at any width: its backward is the two-phase
  kernel while the interval maps fit ``rhs_codegen.MAX_MAP_FLOATS``
  floats, the reverse-sweep kernel past that.
``RhsKernel.backward`` names the backward's route: "maps" (the two-phase
kernel), "sweep", "lanes" or "block". The two reverse-sweep routes keep
what they can of an interval in shared memory, decided at each launch
(``bwd_plan`` asks the library; ``bwd_switches`` says where it changes).
The forward's design is the library's choice too, from sizes (``fwd_plan``;
``fwd_design`` and ``fwd_switches`` mirror it): a functor on the "sweep"
route too wide for one thread's registers runs forward on warp slices of
its program (``rk_fixed_grid_sliced_kernel``), and Kuramoto's block
forward spreads a stage's sines over the block where they fit beside its
stage inputs.
Generated sources build at first use into build/kernels/, named by their
hash (ops/_build.py). A field the kernel cannot run raises ValueError
naming the graph node while it is traced, before the device is looked at,
on either device: it is never solved with the plain path instead. Run-time
constants (Kuramoto's frequency offsets, a field's ``rhs_consts(device,
dtype)``) reach the kernel as the ``cst`` vector. The forward kernel also
writes the per-row success flag. Tsit5 and RK4 run an instance with their
float32 coefficients compiled in (``tableau_instance``); any other tableau
the instance that reads it at run time. The gradient is the VJP the JAX
``custom_vjp`` takes by recomputing the plain solve: on the card one launch
of ``rk_fixed_grid_bwd_kernel``, which builds every interval's map (J_n =
d ys[n+1] / d ys[n], r_n = d ys[n+1] / d p) in parallel from the saved
trajectory and then runs a short affine sweep over them (the lane-group
pair for Kuramoto). Its plain versions are
``solve_fixed_grid_batched_interval_maps_reference`` and
``solve_fixed_grid_batched_affine_sweep_reference``;
``solve_fixed_grid_batched_backward_reference`` is the step-by-step reverse
sweep over the same trajectory, and the plain version of the kernels that
take it on the card: ``rk_fixed_grid_sweep_bwd_kernel`` for a generated
functor whose maps pass ``rhs_codegen.MAX_MAP_FLOATS`` floats, and
``rk_kuramoto_block_bwd_kernel`` for Kuramoto past the lane groups (which
``rk_kuramoto_block_kernel`` solves forward, a block a trajectory). They take the RHS's VJP written by hand
(``RHS_VJP``) where it has one, else ``torch.func.vjp`` of the field
(``field_vjp``). ``saveat`` gets no gradient. Shapes on the main paths: the
pendulum u0s (64, 2), ps (64, 1), 50 save points in training; (45, 2),
(45, 1), 100 points in validation; Tsit5 (6 stages), substeps 1; Van der
Pol and Kuramoto-10 (64, 2 or 10) and (26, 2 or 10), substeps 4.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
from typing import Callable, Optional

import torch
from torch.autograd.function import once_differentiable

from ..solve.fixed import fixed_grid_stats, solve_fixed_grid
from ..solve.rk import (RK4, AbstractSolver, Tsit5, n_solution_stages,
                        tableau_f32)
from . import rhs_codegen, rhs_trace
from ._build import (KERNEL_SOURCES, build_kernels, load_kernel,
                     register_generated)

__all__ = ["solve_fixed_grid_batched", "solve_fixed_grid_batched_cuda",
           "solve_fixed_grid_batched_bwd_cuda",
           "solve_fixed_grid_batched_reference",
           "solve_fixed_grid_batched_backward_reference",
           "solve_fixed_grid_batched_interval_maps_reference",
           "solve_fixed_grid_batched_affine_sweep_reference",
           "tableau_instance", "sincos_cuda", "SINF_COPIES",
           "BAKED_TABLEAUS", "DEVICE_RHS", "RHS_VJP", "RhsKernel",
           "rhs_kernel", "rhs_instance", "field_vjp", "build_instances",
           "BWD_KEEP", "SMEM_OPTIN", "bwd_floats", "bwd_switches",
           "bwd_keep", "bwd_plan", "FWD_DESIGN", "FWD_THREAD_FLOATS",
           "fwd_floats", "fwd_design", "fwd_switches", "fwd_plan"]

# device_rhs family -> {state width: (functor index in csrc/rk_fixed_grid.cu,
# parameter width, instance name)}: the widths each hand-written functor is
# compiled for.
DEVICE_RHS = {
    "pendulum": {2: (0, 1, "pendulum")},
    "pendulum_friction": {2: (1, 1, "pendulum_friction")},
    "vdp": {2: (2, 1, "vdp")},
    "kuramoto": {4: (3, 2, "kuramoto4"), 10: (4, 2, "kuramoto10")},
}

# Kernel instance index -> the solver whose float32 tableau
# csrc/rk_fixed_grid.cuh compiles in (Tsit5Tab, Rk4Tab). The library refuses
# an index whose tableau is not exactly the one it was handed.
BAKED_TABLEAUS = {1: Tsit5(), 2: RK4()}


@dataclasses.dataclass(frozen=True)
class RhsKernel:
    """The kernel instance that runs a field: its launch-counter ``name``,
    the library (``_build`` name) and its ``rhs_kind`` argument, the
    parameter width it takes, how many run-time constants it reads (None:
    none), for a generated functor the traced program, and the backward's
    route: "maps" (the two-phase kernel: interval maps, then the affine
    sweep), "sweep" (the reverse sweep of a functor whose maps pass
    ``rhs_codegen.MAX_MAP_FLOATS``), "lanes" or "block" (Kuramoto's lane
    groups, or a block a trajectory)."""
    name: str
    library: str
    kind: int
    pdim: int
    ncst: Optional[int]
    program: Optional[rhs_trace.FieldProgram] = None
    backward: str = "maps"


_GENERATED = {}  # (field, dim, pdim) -> RhsKernel


def _generated(f: Callable, dim: int, pdim: int) -> RhsKernel:
    try:
        key = (f, dim, pdim)
        hit = _GENERATED.get(key)
    except TypeError:  # an unhashable callable: by identity
        key = (id(f), dim, pdim)
        hit = _GENERATED.get(key)
    if hit is None:
        prog = rhs_trace.trace_field(f, dim, pdim)
        text = rhs_codegen.kernel_source(prog)
        lib = register_generated("rk_gen", text)
        hit = _GENERATED[key] = RhsKernel(
            f"gen_{lib.rsplit('_', 1)[1][:8]}", lib, 0, pdim,
            prog.ncst or None, prog,
            "maps" if rhs_codegen.maps_fit(dim, pdim) else "sweep")
    return hit


@functools.lru_cache(maxsize=None)
def _kuramoto(dim: int) -> RhsKernel:
    """The Kuramoto kernels at ``dim`` oscillators, from a one-line source
    (cached: a launch looks its instance up)."""
    if not 1 <= dim <= rhs_codegen.KURAMOTO_MAX_N:
        raise ValueError(
            f"Kuramoto's block kernels keep a row's stage inputs in shared "
            f"memory: 1 to {rhs_codegen.KURAMOTO_MAX_N} oscillators, not "
            f"{dim}")
    lib = register_generated("rk_kuramoto", rhs_codegen.kuramoto_source(dim))
    lanes = 2 <= dim <= rhs_codegen.KURAMOTO_LANES_MAX_N
    return RhsKernel(f"kuramoto{dim}", lib, 0, 2, dim,
                     backward="lanes" if lanes else "block")


def rhs_kernel(f: Callable, dim: int, pdim: Optional[int] = None
               ) -> RhsKernel:
    """The kernel instance for ``f`` at state width ``dim`` (module
    docstring). A generated functor needs ``pdim``; tracing it raises
    ValueError, naming the node, for a field the kernel cannot run."""
    family = getattr(f, "device_rhs", None)
    widths = DEVICE_RHS.get(family, {})
    if dim in widths:
        kind, pd, name = widths[dim]
        kur = family == "kuramoto"
        return RhsKernel(name, "rk_fixed_grid", kind, pd,
                         dim if kur else None,
                         backward="lanes" if kur else "maps")
    if family == "kuramoto":
        return _kuramoto(dim)
    if pdim is None:
        raise ValueError(f"{rhs_trace.field_name(f)!r} has no hand-written "
                         f"functor: its generated one needs the parameter "
                         f"width")
    return _generated(f, dim, pdim)


def rhs_instance(f: Callable, dim: int, pdim: Optional[int] = None) -> str:
    """The name of the kernel instance that runs ``f`` at state width
    ``dim`` (the two launchers count their launches by it)."""
    return rhs_kernel(f, dim, pdim).name


def build_instances(specs):
    """Build the libraries of the instances of ``specs``, (f, dim, pdim)
    triples, with the port's own kernels, every stale one at once (one
    ``nvcc`` each). Returns ``_build.build_kernels``' dict."""
    libs = list(KERNEL_SOURCES)
    for f, dim, pdim in specs:
        lib = rhs_kernel(f, dim, pdim).library
        if lib not in libs:
            libs.append(lib)
    return build_kernels(libs)


# What a reverse-sweep backward keeps of an interval in shared memory (the
# kernel's ``keep``, csrc/rk_fixed_grid.cuh's BwdPlan): every sub-step's
# stage inputs, the sub-step starts, or nothing (sub-steps 0 .. j-1 run
# again for sub-step j); -1 the one-thread sweep kernel (a row past the
# sliced kernel's shared memory); -2 a two-phase route, which has no plan.
BWD_KEEP = {2: "stages", 1: "starts", 0: "nothing", -1: "one-thread",
            -2: "two-phase"}
SMEM_OPTIN = 232448  # the shared memory an H100 block opts into (227 KB)


def bwd_floats(route: str, keep: int, dim: int, n_stages: int,
               substeps: int, spread: bool = False) -> int:
    """The header's shared-memory floats of the Kuramoto block backward
    (``kur_block_bwd_floats``, route "block"; ``spread``: with a stage's
    pairs) or of the sliced sweep with one row (route "sweep": the tableau,
    ``sweep_coef``, and a row, ``sweep_row_floats``) keeping ``keep``."""
    stages = (substeps if keep == 2 else 1) * n_stages * dim
    starts = substeps * dim if keep == 1 else 0
    if route == "block":
        pairs = dim * (dim + 1) if spread else 0
        return stages + starts + 2 * dim + 512 // 16 + pairs
    return (n_stages * (n_stages + 2)
            + ((stages + starts + 2 * n_stages * dim) | 1))


def bwd_keep(route: str, dim: int, n_stages: int, substeps: int,
             smem: int = SMEM_OPTIN):
    """(keep, spread) as the header's kur_block_bwd_plan and
    sweep_bwd_plan choose them at ``smem`` bytes a block ((None, False)
    where nothing fits)."""
    cap = smem // 4
    if route == "block":
        lanes = -(-dim // 32) * 32 * 2 <= 512  # kKurBlockBwdLanes > 1
        for keep in (2, 1, 0):
            for spread in ((True, False) if lanes else (False,)):
                if bwd_floats(route, keep, dim, n_stages, substeps,
                              spread) <= cap:
                    return keep, spread
        return None, False
    if n_stages * (n_stages + 2) + (3 * n_stages * dim | 1) > cap:
        return -1, False
    for keep in (2, 1, 0):
        if bwd_floats(route, keep, dim, n_stages, substeps) <= cap:
            return keep, False
    return None, False


def bwd_switches(route: str, dim: int, n_stages: int, substeps: int,
                 smem: int = SMEM_OPTIN) -> list:
    """Where a reverse-sweep backward changes what it keeps, at ``smem``
    bytes a block: [(last, keep name, spread), ...] in order, ``last`` the
    largest value of the run. Route "block": over the Kuramoto width, at
    ``n_stages`` and ``substeps``, up to what fits at all; route "sweep":
    over the sub-step count, for a row of width ``dim``, up to the first
    count that keeps nothing (kept at every count past it), or one run of
    the one-thread kernel."""
    runs = []
    x = 1
    while True:
        keep, spread = (bwd_keep(route, x, n_stages, substeps, smem)
                        if route == "block" else
                        bwd_keep(route, dim, n_stages, x, smem))
        if keep is None:
            break
        plan = (BWD_KEEP[keep], spread)
        if runs and runs[-1][1:] == plan:
            runs[-1] = (x,) + plan
        else:
            runs.append((x,) + plan)
        if route == "sweep" and keep in (0, -1):
            break
        x += 1
    return runs


def bwd_plan(f: Callable, solver: AbstractSolver, dim: int, B: int,
             substeps: int, pdim: Optional[int] = None) -> dict:
    """The backward kernel's plan for ``f`` at ``B`` rows and ``substeps``
    on this card (the library's ``ldq_rk_bwd_plan``): ``keep`` (a key of
    ``BWD_KEEP``), threads and rows a block, dynamic shared memory bytes,
    whether the Kuramoto block backward spreads its recompute. Generated
    and one-line Kuramoto libraries only."""
    rk = rhs_kernel(f, dim, pdim)
    lib = _lib(rk.library)
    out = (ctypes.c_int * 5)()
    err = lib.ldq_rk_bwd_plan(n_solution_stages(solver.tableau), B, substeps,
                              out)
    if err != 0:
        raise RuntimeError(f"ldq_rk_bwd_plan failed: CUDA error {err}")
    return dict(keep=out[0], threads=out[1], rows=out[2], smem=out[3],
                spread=bool(out[4]))


# The forward kernel's design (the header's FwdPlan, ``ldq_rk_fwd_plan``):
# rk_fixed_grid_kernel, a thread a row; rk_fixed_grid_sliced_kernel, a
# warp a slice of a sweep functor's program; the Kuramoto lane groups; the
# Kuramoto block kernel with each oscillator's sines on its own lane, or
# with a stage's sines spread over the block.
FWD_DESIGN = {0: "one-thread", 1: "sliced", 2: "lanes", 3: "block",
              4: "spread"}
DT_TABLE = 1024  # the block forward's static table of step sizes, floats
FWD_FLAGS = 32  # the sliced forward's row flags, ints
# The one-thread forward's stage inputs and slopes (2 NS dim floats) up to
# which a sweep functor keeps it (a thread's registers; the header's
# LDQ_RK_FWD_THREAD_FLOATS).
FWD_THREAD_FLOATS = 255


def fwd_floats(design: str, dim: int, n_stages: int) -> int:
    """The header's shared-memory floats of a forward block: the Kuramoto
    block kernel's (``kur_block_fwd_floats`` and the step sizes' table;
    "spread" with a stage's pairs) or the sliced kernel's with one row
    (the tableau, the flags and ``fwd_row_floats``)."""
    if design in ("block", "spread"):
        pairs = dim * (dim + 1) if design == "spread" else 0
        return DT_TABLE + n_stages * dim + pairs
    return (n_stages * (n_stages + 2) + FWD_FLAGS
            + (2 * n_stages * dim | 1))


def fwd_design(route: str, dim: int, n_stages: int,
               smem: int = SMEM_OPTIN) -> str:
    """The forward design the header's plans choose at ``smem`` bytes a
    block for an instance whose backward takes ``route`` (``RhsKernel
    .backward``): the block kernel spreads its sines where the block has
    lanes to spread over (at most 256 oscillators) and the pairs fit; a
    sweep functor runs the sliced kernel where the sliced sweep runs it
    (its leanest row fits) and the one-thread kernel's stage inputs and
    slopes pass ``FWD_THREAD_FLOATS``."""
    cap = smem // 4
    if route == "block":
        lanes = -(-dim // 32) * 32 * 2 <= 512  # kKurBlockBwdLanes > 1
        return ("spread" if lanes and fwd_floats("spread", dim, n_stages)
                <= cap else "block")
    if route == "sweep":
        sliced = (n_stages * (n_stages + 2) + (3 * n_stages * dim | 1)
                  <= cap and 2 * n_stages * dim > FWD_THREAD_FLOATS
                  and fwd_floats("sliced", dim, n_stages) <= cap)
        return "sliced" if sliced else "one-thread"
    return "lanes" if route == "lanes" else "one-thread"


def fwd_switches(route: str, n_stages: int, smem: int = SMEM_OPTIN) -> list:
    """Where the forward design changes over the width, at ``smem`` bytes a
    block: [(last width, design), ...] in order. Route "block": Kuramoto's
    block widths up to ``rhs_codegen.KURAMOTO_MAX_N`` (1 and 32 on); route
    "sweep": a sweep functor's state width, up to the first width past the
    sliced kernel's that runs the one-thread kernel."""
    runs = []
    for x in itertools.count(1):
        if route == "block" and 2 <= x <= rhs_codegen.KURAMOTO_LANES_MAX_N:
            continue
        if route == "block" and x > rhs_codegen.KURAMOTO_MAX_N:
            break
        design = fwd_design(route, x, n_stages, smem)
        if runs and runs[-1][1] == design:
            runs[-1] = (x, design)
        else:
            runs.append((x, design))
        if (route == "sweep" and design == "one-thread"
                and len(runs) > 1):
            break
    return runs


def fwd_plan(f: Callable, solver: AbstractSolver, dim: int, B: int,
             pdim: Optional[int] = None) -> dict:
    """The forward kernel's plan for ``f`` at ``B`` rows on this card (the
    library's ``ldq_rk_fwd_plan``): ``design`` (a value of ``FWD_DESIGN``),
    threads and rows a block, dynamic shared memory bytes. Generated and
    one-line Kuramoto libraries only."""
    lib = _lib(rhs_kernel(f, dim, pdim).library)
    out = (ctypes.c_int * 4)()
    err = lib.ldq_rk_fwd_plan(n_solution_stages(solver.tableau), B, out)
    if err != 0:
        raise RuntimeError(f"ldq_rk_fwd_plan failed: CUDA error {err}")
    return dict(design=FWD_DESIGN[out[0]], threads=out[1], rows=out[2],
                smem=out[3])


def _rhs_consts(f: Callable, device, n: Optional[int]):
    """``f``'s run-time constants as float32 on ``device`` (the tensor the
    field itself uses there), or None when the instance reads none."""
    if n is None:
        return None
    if getattr(f, "rhs_consts", None) is None:
        raise ValueError(f"{rhs_trace.field_name(f)!r}: its kernel instance "
                         f"reads {n} run-time constants, and the field has "
                         f"no rhs_consts")
    consts = f.rhs_consts(device, torch.float32)
    if consts.shape != (n,):
        raise ValueError(f"{rhs_trace.field_name(f)!r} carries rhs_consts "
                         f"of shape {tuple(consts.shape)}; its kernel "
                         f"instance reads {n}")
    return consts.contiguous()


@functools.lru_cache(maxsize=None)
def tableau_instance(solver: AbstractSolver) -> int:
    """The kernel instance for ``solver``: the index in ``BAKED_TABLEAUS``
    of the baked tableau whose float32 coefficients (``tableau_f32``) equal
    the solver's, value by value, else 0, the instance that reads the
    tableau at run time."""
    n, a, b, c = tableau_f32(solver)
    for kind, baked in BAKED_TABLEAUS.items():
        m, a2, b2, c2 = tableau_f32(baked)
        if (n == m and torch.equal(a, a2) and torch.equal(b, b2)
                and torch.equal(c, c2)):
            return kind
    return 0


def solve_fixed_grid_batched_reference(f: Callable, solver: AbstractSolver,
                                       u0s, ps, saveat, *,
                                       substeps: int = 1):
    """The plain PyTorch version: the batched `solve_fixed_grid`.
    Returns ``(ys (B, T, dim), success (B,), stats)``. ``calls`` counts
    its calls (the kernel path makes none, forward or backward)."""
    solve_fixed_grid_batched_reference.calls += 1
    return solve_fixed_grid(f, solver, u0s, ps, saveat, substeps=substeps)


solve_fixed_grid_batched_reference.calls = 0


def _pendulum_vjp(y, p, kb, friction: bool):
    inv = 1.0 / p[..., 0]
    ubar0 = kb[..., 1] * ((-10.0 * inv) * torch.cos(y[..., 0]))
    ubar1 = kb[..., 0] - 0.7 * kb[..., 1] if friction else kb[..., 0]
    pbar = kb[..., 1] * ((10.0 * inv * inv) * torch.sin(y[..., 0]))
    return torch.stack([ubar0, ubar1], dim=-1), pbar[..., None]


def _vdp_vjp(y, p, kb):
    x, v, mu = y[..., 0], y[..., 1], p[..., 0]
    w = 1.0 - x * x
    ubar0 = kb[..., 1] * (mu * (-2.0 * x) * v - 1.0)
    ubar1 = kb[..., 0] + kb[..., 1] * (mu * w)
    return (torch.stack([ubar0, ubar1], dim=-1),
            (kb[..., 1] * (w * v))[..., None])


def _kuramoto_vjp(y, p, kb):
    """Any width N. With C_ij = cos(phi_j - phi_i): ubar_j = (K/N)
    (sum_{i != j} kb_i C_ij - kb_j sum_{m != j} C_jm), d/domega = sum_i
    kb_i, d/dK = (sum_i kb_i S_i) / N, S_i = sum_j sin(phi_j - phi_i)."""
    n = y.shape[-1]
    diff = y[..., None, :] - y[..., :, None]
    off = 1.0 - torch.eye(n, dtype=y.dtype, device=y.device)
    C = torch.cos(diff) * off
    S = (torch.sin(diff) * off).sum(-1)
    kn = p[..., 1:2] * (1.0 / n)
    ubar = kn * ((kb[..., :, None] * C).sum(-2) - kb * C.sum(-1))
    gw = kb.sum(-1)
    gk = (kb * S).sum(-1) * (1.0 / n)
    return ubar, torch.stack([gw, gk], dim=-1)


# device_rhs family -> (y, p, kbar) -> (J_f(y)^T kbar, (df/dp)^T kbar): the
# VJPs of the device functors, written by hand as the kernel has them.
RHS_VJP = {
    "pendulum": lambda y, p, kb: _pendulum_vjp(y, p, kb, False),
    "pendulum_friction": lambda y, p, kb: _pendulum_vjp(y, p, kb, True),
    "vdp": _vdp_vjp,
    "kuramoto": _kuramoto_vjp,
}


def field_vjp(f: Callable):
    """``(y, p, t, kbar) -> (J_f(y)^T kbar, (df/dp)^T kbar)`` for the plain
    references: the hand-written VJP of ``f``'s family (``RHS_VJP``), else
    ``torch.func.vjp`` of ``f`` at ``t``."""
    hand = RHS_VJP.get(getattr(f, "device_rhs", None))
    if hand is not None:
        return lambda y, p, t, kb: hand(y, p, kb)

    def vjp(y, p, t, kb):
        _, pull = torch.func.vjp(lambda y_, p_: f(y_, p_, t), y, p)
        return pull(kb)
    return vjp


@torch.no_grad()
def solve_fixed_grid_batched_backward_reference(f: Callable,
                                                solver: AbstractSolver,
                                                saveat, ys, ps, g, *,
                                                substeps: int = 1):
    """The plain reverse sweep, the backward one step at a time and the
    end-to-end plain version of the backward kernel's two phases: from
    ``ys`` (B, T, dim), the trajectory the forward saved, and
    the cotangent ``g`` of ys, ``ybar = g[:, T-1]``; for each step from the
    last, recompute the stage inputs Y_s and slopes from the step's start
    (ys[:, n] advanced j sub-steps), kbar_s = dt b_s ybar, and for s = S-1
    .. 0: ubar = J_f(Y_s)^T kbar_s, pbar += (df/dp)^T kbar_s, ybar += ubar,
    kbar_q += dt a_sq ubar; ``g[:, n]`` is added at each save point.
    Returns ``(du0 (B, dim), dp (B, pdim))``."""
    vjp = field_vjp(f)
    tab = solver.tableau
    S = n_solution_stages(tab)
    ys, ps, g, saveat = ys.detach(), ps.detach(), g.detach(), saveat.detach()
    T = ys.shape[1]

    def stages(y, t, dt):
        Y, k = [], []
        for s in range(S):
            u = y
            for q, a in enumerate(tab.a[s]):
                if a != 0.0:
                    u = u + (dt * a) * k[q]
            Y.append(u)
            k.append(f(u, ps, t + tab.c[s] * dt))
        return Y, k

    ybar = g[:, T - 1]
    pbar = torch.zeros_like(ps)
    for n in range(T - 2, -1, -1):
        ta = saveat[n]
        dt = (saveat[n + 1] - ta) / substeps
        for j in range(substeps - 1, -1, -1):
            y = ys[:, n]
            for r in range(j):
                _, k = stages(y, ta + r * dt, dt)
                for b, ks in zip(tab.b, k):
                    if b != 0.0:
                        y = y + (dt * b) * ks
            tj = ta + j * dt
            Y, _ = stages(y, tj, dt)
            kbar = [(dt * b) * ybar for b in tab.b[:S]]
            for s in range(S - 1, -1, -1):
                ubar, pb = vjp(Y[s], ps, tj + tab.c[s] * dt, kbar[s])
                pbar = pbar + pb
                ybar = ybar + ubar
                for q, a in enumerate(tab.a[s]):
                    if a != 0.0:
                        kbar[q] = kbar[q] + (dt * a) * ubar
        ybar = ybar + g[:, n]
    return ybar, pbar


@torch.no_grad()
def solve_fixed_grid_batched_interval_maps_reference(
        f: Callable, solver: AbstractSolver, saveat, ys, ps, *,
        substeps: int = 1):
    """The first phase of the backward kernel, vectorised over rows and
    intervals: each interval's map from the state at its start, the saved
    ``ys[:, n]``, to ``ys[:, n+1]``. All intervals run their sub-steps at
    once; each sub-step's Jacobians are the step's VJP (``RHS_VJP`` through
    the stages in reverse, as the plain reverse sweep has it) of each basis
    cotangent, and the sub-steps compose as J = Js J, r = Js r + Rs.
    Returns ``J (B, T-1, dim, dim)``, J[b, n, i, j] = d ys[b, n+1, i] /
    d ys[b, n, j], and ``r (B, T-1, dim, pdim)``, r[b, n, i, q] =
    d ys[b, n+1, i] / d ps[b, q]. A field without a hand-written VJP runs
    under ``torch.func.vmap`` over the intervals, so that it sees ``t`` as
    a number, as the solve calls it."""
    tab = solver.tableau
    ys, ps, saveat = ys.detach(), ps.detach(), saveat.detach()
    B, T, D = ys.shape
    dts = (saveat[1:] - saveat[:-1]) / substeps
    if getattr(f, "device_rhs", None) in RHS_VJP:
        p = ps[:, None, :].expand(B, T - 1, ps.shape[-1])
        return _interval_maps(f, tab, ys[:, :-1], p,
                              saveat[:-1][None, :, None],
                              dts[None, :, None], substeps)
    return torch.func.vmap(
        lambda y, ta, dt: _interval_maps(f, tab, y, ps, ta, dt, substeps),
        in_dims=(1, 0, 0), out_dims=1)(ys[:, :-1], saveat[:-1], dts)


def _interval_maps(f, tab, y, p, ta, dt, substeps):
    """(J, r) of the intervals that start at ``y`` (..., dim) at time
    ``ta`` with sub-step ``dt`` (broadcast against the batch axes)."""
    vjp = field_vjp(f)
    S = n_solution_stages(tab)
    D = y.shape[-1]
    eye = torch.eye(D, dtype=y.dtype, device=y.device)
    J = r = None
    for j in range(substeps):
        t = ta + j * dt
        Y, k = [], []
        for s in range(S):
            u = y
            for q, a in enumerate(tab.a[s]):
                if a != 0.0:
                    u = u + (dt * a) * k[q]
            Y.append(u)
            k.append(f(u, p, t + tab.c[s] * dt))
        rows_j, rows_r = [], []
        for e in range(D):
            ybar = eye[e].expand_as(y)
            pbar = torch.zeros_like(p)
            kbar = [(dt * b) * ybar for b in tab.b[:S]]
            for s in range(S - 1, -1, -1):
                ubar, pb = vjp(Y[s], p, t + tab.c[s] * dt, kbar[s])
                pbar = pbar + pb
                ybar = ybar + ubar
                for q, a in enumerate(tab.a[s]):
                    if a != 0.0:
                        kbar[q] = kbar[q] + (dt * a) * ubar
            rows_j.append(ybar)
            rows_r.append(pbar)
        Js = torch.stack(rows_j, dim=-2)
        Rs = torch.stack(rows_r, dim=-2)
        if J is None:
            J, r = Js, Rs
        else:
            J, r = Js @ J, Js @ r + Rs
        for b, ks in zip(tab.b, k):
            if b != 0.0:
                y = y + (dt * b) * ks
    return J, r


@torch.no_grad()
def solve_fixed_grid_batched_affine_sweep_reference(J, r, g):
    """The second phase of the backward kernel: from the interval maps ``J``
    (B, T-1, dim, dim), ``r`` (B, T-1, dim, pdim) and the cotangent ``g``
    (B, T, dim) of ys, ybar = g[:, T-1], then for n = T-2 .. 0: pbar +=
    r_n^T ybar, ybar = J_n^T ybar + g[:, n]. Returns ``(du0 (B, dim),
    dp (B, pdim))``."""
    T = g.shape[1]
    ybar = g[:, T - 1]
    pbar = g.new_zeros(g.shape[0], r.shape[-1])
    for n in range(T - 2, -1, -1):
        pbar = pbar + torch.einsum("biq,bi->bq", r[:, n], ybar)
        ybar = torch.einsum("bij,bi->bj", J[:, n], ybar) + g[:, n]
    return ybar, pbar


def typed_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a loaded csrc/rk_fixed_grid.cu library
    or a generated one (also for scripts/rk_levers.py, which builds it with
    other flags); ``ldq_rk_sincos`` only the first has, ``ldq_rk_bwd_plan``
    and ``ldq_rk_fwd_plan`` only the others."""
    if not getattr(lib, "_ldq_typed", False):
        lib.ldq_rk_fixed_grid.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ldq_rk_fixed_grid.restype = ctypes.c_int
        lib.ldq_rk_fixed_grid_bwd.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 12
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ldq_rk_fixed_grid_bwd.restype = ctypes.c_int
        if hasattr(lib, "ldq_rk_bwd_plan"):
            lib.ldq_rk_bwd_plan.argtypes = ([ctypes.c_int] * 3
                                            + [ctypes.c_void_p])
            lib.ldq_rk_bwd_plan.restype = ctypes.c_int
            lib.ldq_rk_fwd_plan.argtypes = ([ctypes.c_int] * 2
                                            + [ctypes.c_void_p])
            lib.ldq_rk_fwd_plan.restype = ctypes.c_int
        if hasattr(lib, "ldq_rk_sincos"):
            lib.ldq_rk_sincos.argtypes = ([ctypes.c_void_p] * 3
                                          + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
            lib.ldq_rk_sincos.restype = ctypes.c_int
        lib._ldq_typed = True
    return lib


def _lib(name: str = "rk_fixed_grid"):
    return typed_library(load_kernel(name))


def _instance(solver: AbstractSolver, generic: bool) -> int:
    return 0 if generic else tableau_instance(solver)


def solve_fixed_grid_batched_cuda(f: Callable, solver: AbstractSolver, u0s,
                                  ps, saveat, *, substeps: int = 1,
                                  generic: bool = False):
    """Launch the forward kernel once (no autograd); returns ``(ys (B, T,
    dim), success (B,))``, success true where every value of the row is
    finite. ``generic=True`` runs the instance that reads the tableau at
    run time even where a baked one exists (for the checks that hold the two
    against each other). Counts its launches by kernel instance
    (``rhs_instance``) in ``launches``, a dict; their total is its sum."""
    dim = u0s.shape[-1] if u0s.dim() else 0
    rk = rhs_kernel(f, dim, ps.shape[-1] if ps.dim() == 2 else None)
    kind, pdim, inst = rk.kind, rk.pdim, rk.name
    for name, t in (("u0s", u0s), ("ps", ps), ("saveat", saveat)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"solve_fixed_grid_batched_cuda: {name} must "
                             f"be a float32 CUDA tensor")
    if (u0s.dim() != 2 or u0s.shape[1] != dim or ps.dim() != 2
            or ps.shape != (u0s.shape[0], pdim) or saveat.dim() != 1):
        raise ValueError(
            f"solve_fixed_grid_batched_cuda: expected u0s (B, {dim}), ps "
            f"(B, {pdim}), saveat (T,); got {tuple(u0s.shape)}, "
            f"{tuple(ps.shape)}, {tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    u0s, ps, saveat = u0s.contiguous(), ps.contiguous(), saveat.contiguous()
    B, T = u0s.shape[0], saveat.shape[0]
    n_stages, a, b, c = tableau_f32(solver)
    consts = _rhs_consts(f, u0s.device, rk.ncst)
    ys = torch.empty(B, T, dim, device=u0s.device, dtype=torch.float32)
    success = torch.empty(B, device=u0s.device, dtype=torch.bool)
    lib = _lib(rk.library)
    stream = torch.cuda.current_stream(u0s.device).cuda_stream
    with torch.cuda.device(u0s.device):
        err = lib.ldq_rk_fixed_grid(
            kind, _instance(solver, generic), n_stages, a.data_ptr(),
            b.data_ptr(), c.data_ptr(), saveat.data_ptr(), u0s.data_ptr(),
            ps.data_ptr(), None if consts is None else consts.data_ptr(),
            ys.data_ptr(), success.data_ptr(), B, T, substeps, stream)
    if err != 0:
        raise RuntimeError(f"rk_fixed_grid kernel launch failed: CUDA error "
                           f"{err}")
    by = solve_fixed_grid_batched_cuda.launches
    by[inst] = by.get(inst, 0) + 1
    return ys, success


solve_fixed_grid_batched_cuda.launches = {}


def solve_fixed_grid_batched_bwd_cuda(f: Callable, solver: AbstractSolver,
                                      saveat, ys, ps, g, *,
                                      substeps: int = 1, maps: bool = False,
                                      generic: bool = False):
    """Launch the backward kernel once: the interval maps over ``ys`` (B,
    T, dim), the trajectory the forward kernel wrote, and the affine sweep
    with the cotangent ``g`` of ys. Returns ``(du0 (B, dim), dp (B,
    pdim))``; with ``maps=True`` also the maps the kernel built, ``J`` (B,
    T-1, dim, dim) and ``r`` (B, T-1, dim, pdim), as
    ``solve_fixed_grid_batched_interval_maps_reference`` returns them
    (only on the routes that form them, ``RhsKernel.backward`` "maps" or
    "lanes"). ``generic`` and the counters as for the forward."""
    dim = ys.shape[-1] if ys.dim() else 0
    rk = rhs_kernel(f, dim, ps.shape[-1] if ps.dim() == 2 else None)
    kind, pdim, inst = rk.kind, rk.pdim, rk.name
    if maps and rk.backward not in ("maps", "lanes"):
        raise ValueError(f"solve_fixed_grid_batched_bwd_cuda: the {inst} "
                         f"instance's backward is the reverse sweep "
                         f"({rk.backward!r}), which forms no interval maps; "
                         f"maps=True needs the two-phase kernel")
    for name, t in (("saveat", saveat), ("ys", ys), ("ps", ps), ("g", g)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"solve_fixed_grid_batched_bwd_cuda: {name} "
                             f"must be a float32 CUDA tensor")
    B, T = ys.shape[0], saveat.shape[0]
    if (ys.shape != (B, T, dim) or g.shape != ys.shape
            or ps.shape != (B, pdim) or saveat.dim() != 1):
        raise ValueError(
            f"solve_fixed_grid_batched_bwd_cuda: expected ys and g (B, T, "
            f"{dim}), ps (B, {pdim}), saveat (T,); got {tuple(ys.shape)}, "
            f"{tuple(g.shape)}, {tuple(ps.shape)}, {tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    saveat, ys, ps, g = (t.detach().contiguous() for t in (saveat, ys, ps, g))
    n_stages, a, b, c = tableau_f32(solver)
    consts = _rhs_consts(f, ys.device, rk.ncst)
    du0 = torch.empty(B, dim, device=ys.device, dtype=torch.float32)
    dp = torch.empty(B, pdim, device=ys.device, dtype=torch.float32)
    J = r = None
    if maps:
        J = torch.empty(B, T - 1, dim, dim, device=ys.device,
                        dtype=torch.float32)
        r = torch.empty(B, T - 1, dim, pdim, device=ys.device,
                        dtype=torch.float32)
    lib = _lib(rk.library)
    stream = torch.cuda.current_stream(ys.device).cuda_stream
    with torch.cuda.device(ys.device):
        err = lib.ldq_rk_fixed_grid_bwd(
            kind, _instance(solver, generic), n_stages, a.data_ptr(),
            b.data_ptr(), c.data_ptr(), saveat.data_ptr(), ys.data_ptr(),
            ps.data_ptr(), None if consts is None else consts.data_ptr(),
            g.data_ptr(), du0.data_ptr(), dp.data_ptr(),
            J.data_ptr() if maps else None, r.data_ptr() if maps else None,
            B, T, substeps, stream)
    if err != 0:
        raise RuntimeError(f"rk_fixed_grid backward kernel launch failed: "
                           f"CUDA error {err}")
    by = solve_fixed_grid_batched_bwd_cuda.launches
    by[inst] = by.get(inst, 0) + 1
    return (du0, dp, J, r) if maps else (du0, dp)


solve_fixed_grid_batched_bwd_cuda.launches = {}


# sincos_cuda's ``copy``: the branch-free copies of CUDA's sinf and sincosf
# fast paths (|x| < 105615) that the Kuramoto kernels take, by mode of
# ldq_rk_sincos: "sinf" the sine from sinf's copy and the cosine from
# sincosf's, "sincosf" both from sincosf's.
SINF_COPIES = {"sinf": 2, "sincosf": 3}


def sincos_cuda(x, *, accurate: bool = False, copy: str | None = None):
    """The sine and cosine the RK kernels evaluate, on a float32 CUDA tensor
    ``x``: the branch-free ``sincos_fast`` (valid for |x| <= 105615), or
    with ``accurate=True`` CUDA's sincosf, which the kernels rerun a step
    with when a stage angle passes that bound; with ``copy`` (a key of
    ``SINF_COPIES``) the Kuramoto kernels' copies of sinf's and sincosf's
    fast paths (valid for |x| < 105615). Returns ``(sin, cos)``. For the
    checks that hold the one against the other."""
    if not x.is_cuda or x.dtype != torch.float32:
        raise ValueError("sincos_cuda: x must be a float32 CUDA tensor")
    if copy is not None and copy not in SINF_COPIES:
        raise ValueError(f"sincos_cuda: copy must be one of "
                         f"{sorted(SINF_COPIES)}, not {copy!r}")
    mode = SINF_COPIES[copy] if copy is not None else int(accurate)
    x = x.contiguous()
    s, c = torch.empty_like(x), torch.empty_like(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ldq_rk_sincos(x.data_ptr(), s.data_ptr(), c.data_ptr(),
                                x.numel(), mode, stream)
    if err != 0:
        raise RuntimeError(f"rk sincos kernel launch failed: CUDA error "
                           f"{err}")
    return s, c


class _RKSolveFn(torch.autograd.Function):
    """(ys, success) = the batched solve on the card; the gradient is the
    backward kernel. Under ``torch.func.vmap`` over replicas
    (train/multiseed.py) the ``vmap`` rule folds the replica axis into the
    rows: S replicas of B rows are one launch on S * B rows (each row
    carries its own u0 and parameters), unfolded after."""

    @staticmethod
    def forward(f, solver, substeps, u0s, ps, saveat):
        return solve_fixed_grid_batched_cuda(f, solver, u0s, ps, saveat,
                                             substeps=substeps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        f, solver, substeps, _, ps, saveat = inputs
        ys, success = output
        ctx.mark_non_differentiable(success)
        ctx.set_materialize_grads(False)  # no zero fill for success
        ctx.spec = (f, solver, substeps)
        ctx.save_for_backward(ps, saveat, ys)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _):
        f, solver, substeps = ctx.spec
        ps, saveat, ys = ctx.saved_tensors
        want = ctx.needs_input_grad[3:5]
        if g is None or not any(want):
            return None, None, None, None, None, None
        du0, dp = solve_fixed_grid_batched_bwd_cuda(
            f, solver, saveat, ys, ps, g, substeps=substeps)
        return (None, None, None, du0 if want[0] else None,
                dp if want[1] else None, None)

    @staticmethod
    def vmap(info, in_dims, f, solver, substeps, u0s, ps, saveat):
        if in_dims[5] is not None:
            raise ValueError("solve_fixed_grid_batched: replicas share one "
                             "saveat grid; got a grid per replica")
        S = info.batch_size
        u0s, ps = (x.movedim(d, 0) if d is not None
                   else x.expand(S, *x.shape)
                   for x, d in ((u0s, in_dims[3]), (ps, in_dims[4])))
        B = u0s.shape[1]
        ys, success = _RKSolveFn.apply(f, solver, substeps,
                                       u0s.reshape(S * B, u0s.shape[-1]),
                                       ps.reshape(S * B, ps.shape[-1]),
                                       saveat)
        return ((ys.reshape(S, B, *ys.shape[1:]), success.reshape(S, B)),
                (0, 0))


def solve_fixed_grid_batched(f: Callable, solver: AbstractSolver, u0s, ps,
                             saveat, *, substeps: int = 1):
    """Batched fixed-grid solve: the CUDA kernels for CUDA tensors, the
    plain version (differentiated by autograd) for CPU tensors. ``u0s``
    (B, dim), ``ps`` (B, pdim), ``saveat`` (T,). Returns ``(ys (B, T,
    dim), success (B,), stats)`` with per-trajectory analytic counters
    (ode_pallas.py:175-183). On the card the forward kernel writes the
    success flags and the gradient is the backward kernel; under
    ``torch.func.vmap`` over replicas both launch once for all of them.
    Either device first finds the kernel instance (``rhs_kernel``), so a
    field the kernel cannot run raises ValueError on the CPU too."""
    rhs_kernel(f, u0s.shape[-1], ps.shape[-1])
    if u0s.device.type == "cpu":
        return solve_fixed_grid_batched_reference(f, solver, u0s, ps, saveat,
                                                  substeps=substeps)
    ys, success = _RKSolveFn.apply(f, solver, substeps, u0s, ps, saveat)
    stats = fixed_grid_stats((u0s.shape[0],), saveat.shape[0] - 1, substeps,
                             n_solution_stages(solver.tableau),
                             device=u0s.device)
    return ys, success, stats
