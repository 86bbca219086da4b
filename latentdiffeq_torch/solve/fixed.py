"""Fixed-grid ODE solving (counterpart of latentdiffeq/solve/fixed.py).

``substeps`` method steps per ``saveat`` interval, differentiable by
autograd straight through the steps (the ``Unrolled`` gradient mode).
Unlike the JAX function, which solves one trajectory and is vmapped, this
one takes any leading batch dimensions on ``u0``/``p`` and steps the whole
batch at once: ``u0`` (..., dim) gives ``ys`` (..., T, dim).

``checkpoint=True`` runs each grid interval (each macro-step when strided)
under ``torch.utils.checkpoint``: the backward recomputes its stages
instead of storing them, with the same values. ``interp_stride > 1``
macro-steps: one method step per ``interp_stride`` grid intervals, the
interior save points from the method's dense output, the remainder
intervals as single steps.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .rk import AbstractSolver, interpolate_dense, n_solution_stages, rk_step

__all__ = ["solve_fixed_grid", "fixed_grid_stats"]


def _stats(batch_shape, n_evals: int, n_accepted: int, device):
    def full(v):
        return torch.full(tuple(batch_shape), v, dtype=torch.int32,
                          device=device)
    return {"n_rhs_evals": full(n_evals), "n_accepted": full(n_accepted),
            "n_rejected": full(0)}


def fixed_grid_stats(batch_shape, n_intervals: int, substeps: int,
                     n_stages: int, device=None):
    """Per-trajectory analytic counters, shaped like the batch (as the
    vmapped JAX solve returns them)."""
    return _stats(batch_shape, n_intervals * substeps * n_stages,
                  n_intervals * substeps, device)


def _maybe_checkpoint(fn, checkpoint: bool):
    if not checkpoint:
        return fn
    return lambda *args: _checkpoint(fn, *args, use_reentrant=False)


def _solve_strided(f, solver, u0, p, saveat, stride: int, checkpoint: bool):
    """Macro-stepping (fixed.py:39-90): one step per ``stride`` intervals,
    every stage run (the FSAL stage feeds the interpolant and the next
    step), the interior points from the continuous extension; remainder
    intervals ((T-1) % stride) run as single steps."""
    tab = solver.tableau
    if not tab.fsal:
        raise ValueError("interp_stride needs an FSAL pair with a "
                         "high-order interpolant (Tsit5/Dopri5)")
    T = saveat.shape[0]
    n_macro = (T - 1) // stride
    rem = (T - 1) - n_macro * stride
    cut = n_macro * stride

    def macro(y, f0, ta, tb, t_int):
        dt = tb - ta
        y1, _, ks = rk_step(f, tab, y, p, ta, dt, f0=f0, with_error=True)
        theta = (t_int - ta) / dt
        y_int = interpolate_dense(tab, y[..., None, :], y1[..., None, :],
                                  [k[..., None, :] for k in ks], dt, theta)
        return y1, ks[-1], y_int

    macro = _maybe_checkpoint(macro, checkpoint)
    y, f0 = u0, f(u0, p, saveat[0])
    ys = [u0[..., None, :]]
    for m in range(n_macro):
        lo = m * stride
        y, f0, y_int = macro(y, f0, saveat[lo], saveat[lo + stride],
                             saveat[lo + 1:lo + stride])
        ys += [y_int, y[..., None, :]]
    for j in range(rem):
        y, _, _ = rk_step(f, tab, y, p, saveat[cut + j],
                          saveat[cut + j + 1] - saveat[cut + j],
                          with_error=False)
        ys.append(y[..., None, :])
    ys = torch.cat(ys, dim=-2)
    success = torch.isfinite(ys).all(dim=-1).all(dim=-1)
    n_evals = 1 + n_macro * (len(tab.b) - 1) + rem * n_solution_stages(tab)
    return ys, success, _stats(u0.shape[:-1], n_evals, n_macro + rem,
                               u0.device)


def solve_fixed_grid(f: Callable, solver: AbstractSolver, u0, p, saveat,
                     *, substeps: int = 1, checkpoint: bool = False,
                     interp_stride: int = 1, unroll: int = 1):
    """Integrate du/dt = f(u, p, t) across ``saveat`` (T,).

    Returns ``(ys, success, stats)``: ``ys`` (..., T, dim), ``success``
    (...,) true where the whole trajectory is finite, ``stats`` analytic
    per-trajectory counters. ``interp_stride > 1`` needs ``substeps == 1``
    and an FSAL tableau. ``unroll`` is a JAX scheduling knob with no effect
    on results; it is accepted and ignored.
    """
    if interp_stride > 1:
        if substeps != 1:
            raise ValueError("interp_stride requires substeps == 1")
        return _solve_strided(f, solver, u0, p, saveat, interp_stride,
                              checkpoint)
    tab = solver.tableau

    def interval(y, ta, tb):
        dt = (tb - ta) / substeps
        for j in range(substeps):
            y, _, _ = rk_step(f, tab, y, p, ta + j * dt, dt,
                              with_error=False)
        return y

    interval = _maybe_checkpoint(interval, checkpoint)
    y = u0
    ys = [u0]
    for i in range(saveat.shape[0] - 1):
        y = interval(y, saveat[i], saveat[i + 1])
        ys.append(y)
    ys = torch.stack(ys, dim=-2)
    success = torch.isfinite(ys).all(dim=-1).all(dim=-1)
    stats = fixed_grid_stats(u0.shape[:-1], saveat.shape[0] - 1, substeps,
                             n_solution_stages(tab), device=u0.device)
    return ys, success, stats
