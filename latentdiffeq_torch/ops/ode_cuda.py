"""CUDA kernel for the batched fixed-grid RK solve (replaces the Pallas TPU
kernel latentdiffeq/ops/ode_pallas.py::pallas_solve_fixed_grid_batched).

``solve_fixed_grid_batched`` runs the kernel (csrc/rk_fixed_grid.cu) on
CUDA tensors and the plain PyTorch version on CPU tensors. The RHS must
name a device functor (its ``device_rhs`` attribute, see pendulum.py);
one without raises ValueError on either device rather than dropping to the
plain solve. As in the JAX ``custom_vjp``, the backward recomputes through
the plain solve with autograd, and ``saveat`` gets no gradient. Shapes on
the main path: u0s (64, 2), ps (64, 1), 50 save points in training;
(45, 2), (45, 1), 100 points in validation; Tsit5 (6 stages), substeps 1.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch

from ..solve.fixed import fixed_grid_stats, solve_fixed_grid
from ..solve.rk import AbstractSolver, n_solution_stages, tableau_f32
from ._build import load_kernel

__all__ = ["solve_fixed_grid_batched", "solve_fixed_grid_batched_cuda",
           "solve_fixed_grid_batched_reference", "DEVICE_RHS"]

# device_rhs name -> functor index in csrc/rk_fixed_grid.cu, with the
# (state, parameter) widths the functor is compiled for.
DEVICE_RHS = {"pendulum": (0, 2, 1), "pendulum_friction": (1, 2, 1)}


def _device_rhs(f: Callable):
    name = getattr(f, "device_rhs", None)
    if name not in DEVICE_RHS:
        raise ValueError(
            f"the batched-solve kernel has no device implementation of "
            f"{getattr(f, '__name__', f)!r} (device_rhs={name!r}; known: "
            f"{sorted(DEVICE_RHS)}); set use_kernel_solver=False to solve "
            f"it with the plain PyTorch path")
    return DEVICE_RHS[name]


def solve_fixed_grid_batched_reference(f: Callable, solver: AbstractSolver,
                                       u0s, ps, saveat, *,
                                       substeps: int = 1):
    """The plain PyTorch version: the batched `solve_fixed_grid`.
    Returns ``(ys (B, T, dim), success (B,), stats)``."""
    return solve_fixed_grid(f, solver, u0s, ps, saveat, substeps=substeps)


def _lib():
    lib = load_kernel("rk_fixed_grid")
    if not getattr(lib, "_ldq_typed", False):
        lib.ldq_rk_fixed_grid.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ldq_rk_fixed_grid.restype = ctypes.c_int
        lib._ldq_typed = True
    return lib


def solve_fixed_grid_batched_cuda(f: Callable, solver: AbstractSolver, u0s,
                                  ps, saveat, *, substeps: int = 1):
    """Launch the kernel once (no autograd); returns ys (B, T, dim)."""
    kind, dim, pdim = _device_rhs(f)
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
    ys = torch.empty(B, T, dim, device=u0s.device, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(u0s.device).cuda_stream
    with torch.cuda.device(u0s.device):
        err = lib.ldq_rk_fixed_grid(kind, n_stages, a.data_ptr(),
                                    b.data_ptr(), c.data_ptr(),
                                    saveat.data_ptr(), u0s.data_ptr(),
                                    ps.data_ptr(), ys.data_ptr(), B, T,
                                    substeps, stream)
    if err != 0:
        raise RuntimeError(f"rk_fixed_grid kernel launch failed: CUDA error "
                           f"{err}")
    solve_fixed_grid_batched_cuda.launches += 1
    return ys


solve_fixed_grid_batched_cuda.launches = 0


class _RKSolveFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, solver, substeps, u0s, ps, saveat):
        ctx.spec = (f, solver, substeps)
        ctx.save_for_backward(u0s, ps, saveat)
        return solve_fixed_grid_batched_cuda(f, solver, u0s, ps, saveat,
                                             substeps=substeps)

    @staticmethod
    def backward(ctx, g):
        f, solver, substeps = ctx.spec
        u0s, ps, saveat = ctx.saved_tensors
        want = ctx.needs_input_grad[3:5]
        u0_ = u0s.detach().requires_grad_(want[0])
        p_ = ps.detach().requires_grad_(want[1])
        inputs = [t for t, w in zip((u0_, p_), want) if w]
        grads = iter(())
        if inputs:
            with torch.enable_grad():
                ys, _, _ = solve_fixed_grid_batched_reference(
                    f, solver, u0_, p_, saveat.detach(), substeps=substeps)
            grads = iter(torch.autograd.grad(ys, inputs, g,
                                             allow_unused=True))
        du0, dp = (next(grads) if w else None for w in want)
        return None, None, None, du0, dp, None


def solve_fixed_grid_batched(f: Callable, solver: AbstractSolver, u0s, ps,
                             saveat, *, substeps: int = 1):
    """Batched fixed-grid solve: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``u0s`` (B, dim), ``ps`` (B, pdim),
    ``saveat`` (T,). Returns ``(ys (B, T, dim), success (B,), stats)``
    with per-trajectory analytic counters (ode_pallas.py:175-183)."""
    _device_rhs(f)
    if u0s.device.type == "cpu":
        return solve_fixed_grid_batched_reference(f, solver, u0s, ps, saveat,
                                                  substeps=substeps)
    ys = _RKSolveFn.apply(f, solver, substeps, u0s, ps, saveat)
    success = torch.isfinite(ys).all(dim=2).all(dim=1)
    stats = fixed_grid_stats((u0s.shape[0],), saveat.shape[0] - 1, substeps,
                             n_solution_stages(solver.tableau),
                             device=u0s.device)
    return ys, success, stats
