"""CUDA kernel for the batched fixed-grid RK solve (replaces the Pallas TPU
kernel latentdiffeq/ops/ode_pallas.py::pallas_solve_fixed_grid_batched).

``solve_fixed_grid_batched`` runs the kernel (csrc/rk_fixed_grid.cu) on
CUDA tensors and the plain PyTorch version on CPU tensors. The RHS must
name a device functor (its ``device_rhs`` attribute, see pendulum.py);
one without raises ValueError on either device rather than dropping to the
plain solve. The gradient is the VJP the JAX ``custom_vjp`` takes by
recomputing the plain solve: on the card one launch of
``rk_fixed_grid_bwd_kernel``, a reverse sweep that recomputes each step's
stages from the saved trajectory.
``solve_fixed_grid_batched_backward_reference``
is the sweep's plain version, with the RHS's VJP written by hand
(``RHS_VJP``). ``saveat`` gets no gradient. Shapes on the main path: u0s
(64, 2), ps (64, 1), 50 save points in training; (45, 2), (45, 1), 100
points in validation; Tsit5 (6 stages), substeps 1.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from ..solve.fixed import fixed_grid_stats, solve_fixed_grid
from ..solve.rk import AbstractSolver, n_solution_stages, tableau_f32
from ._build import load_kernel

__all__ = ["solve_fixed_grid_batched", "solve_fixed_grid_batched_cuda",
           "solve_fixed_grid_batched_bwd_cuda",
           "solve_fixed_grid_batched_reference",
           "solve_fixed_grid_batched_backward_reference", "DEVICE_RHS",
           "RHS_VJP"]

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


# device_rhs name -> (y, p, kbar) -> (J_f(y)^T kbar, (df/dp)^T kbar): the
# VJPs of the device functors, written by hand as the kernel has them.
RHS_VJP = {
    "pendulum": lambda y, p, kb: _pendulum_vjp(y, p, kb, False),
    "pendulum_friction": lambda y, p, kb: _pendulum_vjp(y, p, kb, True),
}


@torch.no_grad()
def solve_fixed_grid_batched_backward_reference(f: Callable,
                                                solver: AbstractSolver,
                                                saveat, ys, ps, g, *,
                                                substeps: int = 1):
    """The plain reverse sweep, step for step the recursion of the backward
    kernel: from ``ys`` (B, T, dim), the trajectory the forward saved, and
    the cotangent ``g`` of ys, ``ybar = g[:, T-1]``; for each step from the
    last, recompute the stage inputs Y_s and slopes from the step's start
    (ys[:, n] advanced j sub-steps), kbar_s = dt b_s ybar, and for s = S-1
    .. 0: ubar = J_f(Y_s)^T kbar_s, pbar += (df/dp)^T kbar_s, ybar += ubar,
    kbar_q += dt a_sq ubar; ``g[:, n]`` is added at each save point.
    Returns ``(du0 (B, dim), dp (B, pdim))``."""
    _device_rhs(f)
    vjp = RHS_VJP[f.device_rhs]
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
            Y, _ = stages(y, ta + j * dt, dt)
            kbar = [(dt * b) * ybar for b in tab.b[:S]]
            for s in range(S - 1, -1, -1):
                ubar, pb = vjp(Y[s], ps, kbar[s])
                pbar = pbar + pb
                ybar = ybar + ubar
                for q, a in enumerate(tab.a[s]):
                    if a != 0.0:
                        kbar[q] = kbar[q] + (dt * a) * ubar
        ybar = ybar + g[:, n]
    return ybar, pbar


def _lib():
    lib = load_kernel("rk_fixed_grid")
    if not getattr(lib, "_ldq_typed", False):
        lib.ldq_rk_fixed_grid.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ldq_rk_fixed_grid.restype = ctypes.c_int
        lib.ldq_rk_fixed_grid_bwd.argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.ldq_rk_fixed_grid_bwd.restype = ctypes.c_int
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


def solve_fixed_grid_batched_bwd_cuda(f: Callable, solver: AbstractSolver,
                                      saveat, ys, ps, g, *,
                                      substeps: int = 1):
    """Launch the backward kernel once: the reverse sweep over ``ys`` (B,
    T, dim), the trajectory the forward kernel wrote, with the cotangent
    ``g`` of ys. Returns ``(du0 (B, dim), dp (B, pdim))``."""
    kind, dim, pdim = _device_rhs(f)
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
    du0 = torch.empty(B, dim, device=ys.device, dtype=torch.float32)
    dp = torch.empty(B, pdim, device=ys.device, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(ys.device).cuda_stream
    with torch.cuda.device(ys.device):
        err = lib.ldq_rk_fixed_grid_bwd(
            kind, n_stages, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            saveat.data_ptr(), ys.data_ptr(), ps.data_ptr(), g.data_ptr(),
            du0.data_ptr(), dp.data_ptr(), B, T, substeps, stream)
    if err != 0:
        raise RuntimeError(f"rk_fixed_grid backward kernel launch failed: "
                           f"CUDA error {err}")
    solve_fixed_grid_batched_bwd_cuda.launches += 1
    return du0, dp


solve_fixed_grid_batched_bwd_cuda.launches = 0


class _RKSolveFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, solver, substeps, u0s, ps, saveat):
        ys = solve_fixed_grid_batched_cuda(f, solver, u0s, ps, saveat,
                                           substeps=substeps)
        ctx.spec = (f, solver, substeps)
        ctx.save_for_backward(ps, saveat, ys)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        f, solver, substeps = ctx.spec
        ps, saveat, ys = ctx.saved_tensors
        want = ctx.needs_input_grad[3:5]
        if not any(want):
            return None, None, None, None, None, None
        du0, dp = solve_fixed_grid_batched_bwd_cuda(
            f, solver, saveat, ys, ps, g, substeps=substeps)
        return (None, None, None, du0 if want[0] else None,
                dp if want[1] else None, None)


def solve_fixed_grid_batched(f: Callable, solver: AbstractSolver, u0s, ps,
                             saveat, *, substeps: int = 1):
    """Batched fixed-grid solve: the CUDA kernel for CUDA tensors, the
    plain version (differentiated by autograd) for CPU tensors. ``u0s``
    (B, dim), ``ps`` (B, pdim), ``saveat`` (T,). Returns ``(ys (B, T,
    dim), success (B,), stats)`` with per-trajectory analytic counters
    (ode_pallas.py:175-183). On the card the gradient is the reverse-sweep
    kernel."""
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
