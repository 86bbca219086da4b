"""ODE integration with a selectable gradient mode (counterpart of
latentdiffeq/adjoint/odeint.py:31-63, 222).

The port covers the fixed-grid ``Unrolled`` case, the one the GOKU parity
workload trains with. ``odeint`` takes batched ``u0``/``p`` directly (no
vmap) and returns ``(ys, success, stats)`` with ``ys`` (..., T, dim).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..solve.fixed import solve_fixed_grid
from ..solve.rk import AbstractSolver
from .modes import AbstractSensealg, Unrolled

__all__ = ["SolveOptions", "odeint"]


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Static solve configuration. ``unroll`` is a JAX scheduling knob
    with no effect on results; it is accepted and ignored here."""

    adaptive: bool = True
    substeps: int = 1
    interp_stride: int = 1
    unroll: int = 1

    def replace(self, **kw) -> "SolveOptions":
        return dataclasses.replace(self, **kw)


def uses_fixed_grid(solver: AbstractSolver, options: SolveOptions) -> bool:
    """The JAX package solves on the fixed grid when asked to, or when the
    solver has no embedded error estimate (RK4, Midpoint, Euler)."""
    return not options.adaptive or not solver.is_adaptive_capable


def odeint(f: Callable, solver: AbstractSolver, u0, p, saveat,
           options: SolveOptions = SolveOptions(),
           sensealg: AbstractSensealg = Unrolled()):
    if not isinstance(sensealg, Unrolled):
        raise NotImplementedError(
            f"sensealg {sensealg!r} is not ported yet (Unrolled only)")
    if not uses_fixed_grid(solver, options):
        raise NotImplementedError(
            "adaptive stepping is not ported yet; use "
            "SolveOptions(adaptive=False)")
    return solve_fixed_grid(f, solver, u0, p, saveat,
                            substeps=options.substeps,
                            checkpoint=sensealg.checkpoint,
                            interp_stride=options.interp_stride)
