"""Pendulum dynamics specs (counterpart of examples/pendulum/pendulum.py):
the frictionless, damped and stochastic pendulums.

The vector fields act on the last axis, so one call evaluates a whole
batch: ``u`` (..., 2) = (angle, angular velocity), ``p`` (..., 1) = (L,).
Each carries ``device_rhs``, the name of its hand-written CUDA functor in
csrc/rk_fixed_grid.cu; the batched-solve kernel runs an untagged field on a
functor generated from its trace (ops/ode_cuda.py).
"""
from __future__ import annotations

import torch

from .adjoint import SolveOptions, Unrolled
from .models.dynamics import ODEDynamics, SDEDynamics
from .solve.rk import Tsit5
from .solve.sde import SDEAdaptiveConfig, SRA1

__all__ = ["G", "pendulum_f", "pendulum_friction_f", "spendulum_g",
           "Pendulum", "PendulumFriction", "SPendulum"]

G = 10.0


def pendulum_f(u, p, t):
    """du1 = u2; du2 = -G/L * sin(u1) (reference: pendulum.jl:19-26)."""
    x, y = u[..., 0], u[..., 1]
    L = p[..., 0]
    return torch.stack([y, -G / L * torch.sin(x)], dim=-1)


def pendulum_friction_f(u, p, t):
    """Adds damping -(b/m) * y, b=0.7, m=1 (reference: pendulum.jl:64-73)."""
    x, y = u[..., 0], u[..., 1]
    L = p[..., 0]
    b, m = 0.7, 1.0
    return torch.stack([y, -G / L * torch.sin(x) - (b / m) * y], dim=-1)


def spendulum_g(u, p, t):
    """Additive noise du .= 0.01 (reference: pendulum.jl:122-124)."""
    return torch.full_like(u, 0.01)


pendulum_f.device_rhs = "pendulum"
pendulum_friction_f.device_rhs = "pendulum_friction"


def Pendulum(solver=Tsit5(), sensealg=Unrolled(),
             options=SolveOptions()) -> ODEDynamics:
    """Frictionless pendulum spec (reference: pendulum.jl:4-46)."""
    return ODEDynamics(f=pendulum_f, z_dim=2, theta_dim=1, solver=solver,
                       sensealg=sensealg, options=options)


def PendulumFriction(solver=Tsit5(), sensealg=Unrolled(),
                     options=SolveOptions()) -> ODEDynamics:
    """Damped pendulum spec (reference: pendulum.jl:51-91)."""
    return ODEDynamics(f=pendulum_friction_f, z_dim=2, theta_dim=1,
                       solver=solver, sensealg=sensealg, options=options)


def SPendulum(solver=SRA1(), substeps: int = 1, adaptive: bool = False,
              adaptive_cfg: SDEAdaptiveConfig = None) -> SDEDynamics:
    """Stochastic pendulum with additive noise (reference:
    pendulum.jl:96-140), solved with SRA1 over the virtual Brownian tree;
    ``adaptive=True`` steps each trajectory by dyadic bisection, the
    reference's ``SOSRI()`` semantics (pendulum.jl:103)."""
    if adaptive_cfg is None:
        adaptive_cfg = SDEAdaptiveConfig()
    return SDEDynamics(f=pendulum_f, g=spendulum_g, z_dim=2, theta_dim=1,
                       solver=solver, substeps=substeps, adaptive=adaptive,
                       adaptive_cfg=adaptive_cfg)
