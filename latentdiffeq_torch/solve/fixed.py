"""Fixed-grid ODE solving (counterpart of latentdiffeq/solve/fixed.py:93-147).

``substeps`` method steps per ``saveat`` interval, differentiable by
autograd straight through the steps (the ``Unrolled`` gradient mode).
Unlike the JAX function, which solves one trajectory and is vmapped, this
one takes any leading batch dimensions on ``u0``/``p`` and steps the whole
batch at once: ``u0`` (..., dim) gives ``ys`` (..., T, dim).
"""
from __future__ import annotations

from typing import Callable

import torch

from .rk import AbstractSolver, n_solution_stages, rk_step

__all__ = ["solve_fixed_grid", "fixed_grid_stats"]


def fixed_grid_stats(batch_shape, n_intervals: int, substeps: int,
                     n_stages: int, device=None):
    """Per-trajectory analytic counters, shaped like the batch (as the
    vmapped JAX solve returns them)."""
    def full(v):
        return torch.full(tuple(batch_shape), v, dtype=torch.int32,
                          device=device)
    return {"n_rhs_evals": full(n_intervals * substeps * n_stages),
            "n_accepted": full(n_intervals * substeps),
            "n_rejected": full(0)}


def solve_fixed_grid(f: Callable, solver: AbstractSolver, u0, p, saveat,
                     *, substeps: int = 1, checkpoint: bool = False,
                     interp_stride: int = 1, unroll: int = 1):
    """Integrate du/dt = f(u, p, t) across ``saveat`` (T,).

    Returns ``(ys, success, stats)``: ``ys`` (..., T, dim), ``success``
    (...,) true where the whole trajectory is finite, ``stats`` analytic
    per-trajectory counters. ``unroll`` is a JAX scheduling knob with no
    effect on results; it is accepted and ignored. ``checkpoint`` and
    ``interp_stride`` are not ported yet and raise.
    """
    if checkpoint:
        raise NotImplementedError(
            "solve_fixed_grid(checkpoint=True) is not ported yet")
    if interp_stride != 1:
        raise NotImplementedError(
            "solve_fixed_grid(interp_stride>1) is not ported yet")
    tab = solver.tableau
    y = u0
    ys = [u0]
    for i in range(saveat.shape[0] - 1):
        ta, tb = saveat[i], saveat[i + 1]
        dt = (tb - ta) / substeps
        for j in range(substeps):
            y, _, _ = rk_step(f, tab, y, p, ta + j * dt, dt,
                              with_error=False)
        ys.append(y)
    ys = torch.stack(ys, dim=-2)
    success = torch.isfinite(ys).all(dim=-1).all(dim=-1)
    stats = fixed_grid_stats(u0.shape[:-1], saveat.shape[0] - 1, substeps,
                             n_solution_stages(tab), device=u0.device)
    return ys, success, stats
