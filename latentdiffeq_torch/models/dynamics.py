"""Dynamics specs for the diffeq slot (counterpart of
latentdiffeq/models/dynamics.py).

``ODEDynamics`` and ``SDEDynamics`` are static configuration with no
parameters: a mechanistic vector field ``f(u, theta, t)`` (and, for an
SDE, a diagonal noise ``g(u, theta, t)``) whose parameters theta the GOKU
encoder infers per sample. ``NeuralODEDynamics`` holds the trainable
vector field of a Latent ODE, so it is a module whose child ``dudt``
registers its weights (``decoder/diffeq/dudt/layers/...`` in the
checkpoint).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from torch import nn

from ..adjoint.modes import AbstractSensealg, Unrolled
from ..adjoint.odeint import SolveOptions
from ..solve.rk import AbstractSolver, Tsit5
from ..solve.sde import AbstractSDESolver, SDEAdaptiveConfig, SRA1

__all__ = ["ODEDynamics", "SDEDynamics", "NeuralODEDynamics"]


@dataclasses.dataclass(frozen=True)
class ODEDynamics:
    f: Callable = None
    z_dim: int = 2
    theta_dim: int = 1
    solver: AbstractSolver = Tsit5()
    sensealg: AbstractSensealg = Unrolled()
    options: SolveOptions = SolveOptions()
    transform: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class SDEDynamics:
    """Mechanistic SDE du = f dt + g dW (reference: SPendulum,
    pendulum.jl:96-140). ``adaptive=False`` integrates on the save grid with
    ``substeps`` steps per interval (solve_sde_fixed_grid);
    ``adaptive=True`` steps each trajectory by dyadic bisection
    (solve_sde_adaptive under ``adaptive_cfg``). Both consume the same
    virtual Brownian tree."""
    f: Callable = None
    g: Callable = None
    z_dim: int = 2
    theta_dim: int = 1
    solver: AbstractSDESolver = SRA1()
    substeps: int = 1
    adaptive: bool = False
    adaptive_cfg: SDEAdaptiveConfig = SDEAdaptiveConfig()
    transform: Optional[Callable] = None


class NeuralODEDynamics(nn.Module):
    """Neural ODE latent dynamics (reference: nODE.jl:13-31).

    ``dudt``: trainable network mapping (..., dim) -> (..., dim) with
    dim = latent_dim_in + augment_dim. ``augment_dim > 0`` gives an
    augmented neural ODE: the initial state is padded with zeros
    (reference: LatentODE.jl:72). The other fields are static."""

    def __init__(self, dudt: nn.Module, latent_dim_in: int = 16,
                 augment_dim: int = 0, solver: AbstractSolver = Tsit5(),
                 sensealg: AbstractSensealg = Unrolled(),
                 options: SolveOptions = SolveOptions(),
                 transform: Optional[Callable] = None):
        super().__init__()
        self.dudt = dudt
        self.latent_dim_in = latent_dim_in
        self.augment_dim = augment_dim
        self.solver = solver
        self.sensealg = sensealg
        self.options = options
        self.transform = transform

    @property
    def latent_dim_out(self) -> int:
        return self.latent_dim_in + self.augment_dim
