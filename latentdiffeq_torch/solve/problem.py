"""ODE/SDE problem containers (counterpart of
latentdiffeq/solve/problem.py:28-94).

``u0`` and ``p`` are the problem's data (``p`` may be a tensor or an
``nn.Module``), the RHS callables are static; ``remake`` is a record
update, as DiffEq's ``remake(prob; u0=..., p=..., tspan=...)``.
``solve``/``solve_ensemble`` send an ``SDEProblem`` to the SDE solvers
(solve/sde.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

__all__ = ["ODEProblem", "SDEProblem", "remake", "Solution"]


@dataclasses.dataclass(frozen=True)
class ODEProblem:
    """du/dt = f(u, p, t)."""

    u0: Any
    tspan: Tuple
    p: Any
    f: Optional[Callable] = None

    def remake(self, *, u0=None, p=None, tspan=None, f=None) -> "ODEProblem":
        return ODEProblem(
            f=f if f is not None else self.f,
            u0=u0 if u0 is not None else self.u0,
            tspan=tspan if tspan is not None else self.tspan,
            p=p if p is not None else self.p)


@dataclasses.dataclass(frozen=True)
class SDEProblem:
    """du = f(u, p, t) dt + g(u, p, t) dW (diagonal or additive noise)."""

    u0: Any
    tspan: Tuple
    p: Any
    f: Optional[Callable] = None
    g: Optional[Callable] = None

    def remake(self, *, u0=None, p=None, tspan=None) -> "SDEProblem":
        return SDEProblem(
            f=self.f, g=self.g,
            u0=u0 if u0 is not None else self.u0,
            tspan=tspan if tspan is not None else self.tspan,
            p=p if p is not None else self.p)


def remake(prob, **kwargs):
    """Functional analogue of DiffEq's ``remake``."""
    return prob.remake(**kwargs)


@dataclasses.dataclass(frozen=True)
class Solution:
    """The result of a solve: ``ts`` (T,) save times, ``ys`` (T, dim), or
    (batch, T, dim) for an ensemble, ``success`` a flag per trajectory
    (failure: step-size underflow, step budget exhausted or a non-finite
    state) and ``stats`` the counters."""

    ts: Any
    ys: Any
    success: Any
    stats: dict
