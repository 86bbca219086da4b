"""Pendulum dynamics specs (counterpart of examples/pendulum/pendulum.py:18-54).

The vector fields act on the last axis, so one call evaluates a whole
batch: ``u`` (..., 2) = (angle, angular velocity), ``p`` (..., 1) = (L,).
Each carries ``device_rhs``, the name of its CUDA functor in
csrc/rk_fixed_grid.cu; the batched-solve kernel accepts only such RHSs.
"""
from __future__ import annotations

import torch

from .adjoint import SolveOptions, Unrolled
from .models.dynamics import ODEDynamics
from .solve.rk import Tsit5

__all__ = ["G", "pendulum_f", "pendulum_friction_f", "Pendulum",
           "PendulumFriction"]

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
