"""Explicit Runge–Kutta tableaus, the single step and the dense output
(counterpart of latentdiffeq/solve/rk.py).

Tableaus are Python floats (float64) and meet float32 state at use, as in
the JAX package. States carry any leading batch dimensions: the RHS
``f(y, p, t)`` works on the last axis, so one call steps a whole batch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

__all__ = ["ButcherTableau", "AbstractSolver", "Euler", "Midpoint", "RK4",
           "Tsit5", "Dopri5", "rk_step", "n_solution_stages", "tableau_f32",
           "interpolate_dense"]


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    c: tuple          # (s,)
    a: tuple          # strictly lower triangular rows
    b: tuple          # (s,) solution weights
    b_err: tuple      # (s,) error weights (b - b_hat), or None
    order: int
    fsal: bool        # last stage == f(t+dt, y1)
    interpolation: str  # "hermite..." | "tsit5" | "dopri5" | "linear"


@dataclasses.dataclass(frozen=True)
class AbstractSolver:
    @property
    def tableau(self) -> ButcherTableau:
        raise NotImplementedError

    @property
    def is_adaptive_capable(self) -> bool:
        return self.tableau.b_err is not None


_EULER = ButcherTableau(c=(0.0,), a=((),), b=(1.0,), b_err=None, order=1,
                        fsal=False, interpolation="linear")

_MIDPOINT = ButcherTableau(c=(0.0, 0.5), a=((), (0.5,)), b=(0.0, 1.0),
                           b_err=None, order=2, fsal=False,
                           interpolation="linear")

_RK4 = ButcherTableau(
    c=(0.0, 0.5, 0.5, 1.0),
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1 / 6, 1 / 3, 1 / 3, 1 / 6), b_err=None, order=4, fsal=False,
    interpolation="hermite_recompute")

# Tsitouras 5(4) (Tsitouras 2011), the reference's default solver.
_TSIT5 = ButcherTableau(
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    a=(
        (),
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774, 0.0),
    b_err=(-0.00178001105222577714, -0.0008164344596567469,
           0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
           -0.45808210592918697, 0.015151515151515152),
    order=5, fsal=True, interpolation="tsit5")

# Dormand–Prince 5(4).
_DOPRI5 = ButcherTableau(
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
           22 / 525, -1 / 40),
    order=5, fsal=True, interpolation="dopri5")

# Hairer's dense-output coefficients for DOPRI5 (DOPRI5.f, CONTD5).
_DOPRI5_D = (
    -12715105075 / 11282082432, 0.0, 87487479700 / 32700410799,
    -10690763975 / 1880347072, 701980252875 / 199316789632,
    -1453857185 / 822651844, 69997945 / 29380423,
)


def _tsit5_b_theta(th):
    """Tsit5's 4th-order continuous extension b_i(theta) (Tsitouras 2011),
    rk.py:123-144: degree-4 polynomials with b_i(0) = 0 and b_i(1) = b_i."""
    b1 = (-1.0530884977290216 * th * (th - 1.3299890189751412)
          * (th * th - 1.4364028541716351 * th + 0.7139816917074209))
    b2 = 0.1017 * th**2 * (th * th - 2.1966568338249754 * th
                           + 1.2949852507374631)
    b3 = (2.490627285651252793 * th**2
          * (th * th - 2.38535645472061657 * th + 1.57803468208092486))
    b4 = (-16.54810288924490272 * (th - 1.21712927295533244)
          * (th - 0.61620406037800089) * th**2)
    b5 = (47.37952196281928122 * (th - 1.203071208372362603)
          * (th - 0.658047292653547382) * th**2)
    b6 = (-34.87065786149660974 * (th - 1.2)
          * (th - 0.666666666666666667) * th**2)
    b7 = 2.5 * (th - 1.0) * (th - 0.6) * th**2
    return (b1, b2, b3, b4, b5, b6, b7)


@dataclasses.dataclass(frozen=True)
class Euler(AbstractSolver):
    @property
    def tableau(self):
        return _EULER


@dataclasses.dataclass(frozen=True)
class Midpoint(AbstractSolver):
    @property
    def tableau(self):
        return _MIDPOINT


@dataclasses.dataclass(frozen=True)
class RK4(AbstractSolver):
    @property
    def tableau(self):
        return _RK4


@dataclasses.dataclass(frozen=True)
class Tsit5(AbstractSolver):
    @property
    def tableau(self):
        return _TSIT5


@dataclasses.dataclass(frozen=True)
class Dopri5(AbstractSolver):
    @property
    def tableau(self):
        return _DOPRI5


def n_solution_stages(tab: ButcherTableau) -> int:
    """Stages with nonzero solution weight: the fixed-step stage count
    (Tsit5's FSAL 7th stage is skipped). Every fixed-step path and kernel
    agrees on it."""
    return max(i for i in range(len(tab.b)) if tab.b[i] != 0.0) + 1


@functools.lru_cache(maxsize=None)
def tableau_f32(solver: AbstractSolver):
    """``(n_stages, a, b, c)`` of the fixed-step method for the CUDA
    kernels: the first ``n_solution_stages`` stages as float32 host tensors,
    ``a`` row-major (n, n). Built once per solver (solvers are frozen
    dataclasses, so they hash by value); callers must not write to them."""
    tab = solver.tableau
    n = n_solution_stages(tab)
    a = torch.zeros(n, n, dtype=torch.float32)
    for i in range(n):
        for j, aij in enumerate(tab.a[i]):
            a[i, j] = aij
    b = torch.tensor(tab.b[:n], dtype=torch.float32)
    c = torch.tensor(tab.c[:n], dtype=torch.float32)
    return n, a.contiguous(), b, c


def rk_step(f: Callable, tab: ButcherTableau, y, p, t, dt, f0=None,
            with_error: bool = True):
    """One explicit RK step; returns ``(y1, err, ks)`` (rk.py:184-222).
    Zero coefficients are skipped, and in fixed-step mode the trailing
    zero-weight stages are not evaluated."""
    need_err = with_error and tab.b_err is not None
    s = len(tab.b) if need_err else n_solution_stages(tab)
    ks = []
    for i in range(s):
        if i == 0:
            k = f0 if f0 is not None else f(y, p, t)
        else:
            yi = y
            for j, aij in enumerate(tab.a[i]):
                if aij != 0.0:
                    yi = yi + (dt * aij) * ks[j]
            k = f(yi, p, t + tab.c[i] * dt)
        ks.append(k)

    y1 = y
    for bi, k in zip(tab.b, ks):
        if bi != 0.0:
            y1 = y1 + (dt * bi) * k

    err = None
    if need_err:
        err = torch.zeros_like(y)
        for bei, k in zip(tab.b_err, ks):
            if bei != 0.0:
                err = err + (dt * bei) * k
    return y1, err, ks


def interpolate_dense(tab: ButcherTableau, y0, y1, ks, dt, theta):
    """The step's continuous extension at ``theta`` in [0, 1]
    (rk.py:250-290). ``theta`` (..., T) gives (..., T, dim) when y0, y1,
    ks and dt broadcast against (..., 1, dim): a single trajectory passes
    y0 (dim,) and a scalar dt, a batch passes y0[:, None] and
    dt[:, None, None]."""
    th = theta[..., None]

    if tab.interpolation == "linear":
        return y0 + th * (y1 - y0)

    if tab.interpolation == "tsit5":
        out = y0
        for bi, k in zip(_tsit5_b_theta(th), ks):
            out = out + (dt * bi) * k
        return out

    if tab.interpolation == "dopri5":
        k1, k3, k4, k5, k6, k7 = ks[0], ks[2], ks[3], ks[4], ks[5], ks[6]
        d = _DOPRI5_D
        ydiff = y1 - y0
        bspl = dt * k1 - ydiff
        r4 = ydiff - dt * k7 - bspl
        r5 = dt * (d[0] * k1 + d[2] * k3 + d[3] * k4 + d[4] * k5
                   + d[5] * k6 + d[6] * k7)
        return y0 + th * (ydiff + (1 - th) * (bspl + th * (r4 + (1 - th)
                                                           * r5)))

    # cubic Hermite on the endpoint derivatives (FSAL gives f1); without
    # FSAL a quadratic on f0 only
    f0 = ks[0]
    if not tab.fsal:
        return y0 + th * dt * f0 + th * th * (y1 - y0 - dt * f0)
    f1 = ks[-1]
    h00 = 2 * th**3 - 3 * th**2 + 1
    h10 = th**3 - 2 * th**2 + th
    h01 = -2 * th**3 + 3 * th**2
    h11 = th**3 - th**2
    return h00 * y0 + h10 * dt * f0 + h01 * y1 + h11 * dt * f1
