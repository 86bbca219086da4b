"""Dynamics spec for the diffeq slot (counterpart of
latentdiffeq/models/dynamics.py:35-45).

``ODEDynamics`` is static configuration with no parameters: a mechanistic
vector field ``f(u, theta, t)`` whose parameters theta the GOKU encoder
infers per sample.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..adjoint.modes import AbstractSensealg, Unrolled
from ..adjoint.odeint import SolveOptions
from ..solve.rk import AbstractSolver, Tsit5

__all__ = ["ODEDynamics"]


@dataclasses.dataclass(frozen=True)
class ODEDynamics:
    f: Callable = None
    z_dim: int = 2
    theta_dim: int = 1
    solver: AbstractSolver = Tsit5()
    sensealg: AbstractSensealg = Unrolled()
    options: SolveOptions = SolveOptions()
    transform: Optional[Callable] = None
