"""User-defined mechanistic latent dynamics (counterpart of
examples/custom_dynamics/custom.py:20-95): Van der Pol, the stochastic Van
der Pol and Kuramoto.

The vector fields act on the last axis, so one call evaluates a whole
batch, and each keeps the JAX function's operation order. Each carries
``device_rhs``, the name of its CUDA functor family in
csrc/rk_fixed_grid.cu (Kuramoto also ``rhs_consts(device, dtype)``, its
frequency offsets there),
so ``GOKUBasic(use_kernel_solver=True)`` solves it in the batched-solve
kernel; Kuramoto's lane-group kernels are compiled for 4 and 10 oscillators
and built at first use for another width (2 to 31).
The stochastic Van der Pol is an ``SDEDynamics``, solved by the SDE solvers.
"""
from __future__ import annotations

import torch

from .adjoint import SolveOptions, Unrolled
from .models.dynamics import ODEDynamics, SDEDynamics
from .solve.rk import Tsit5
from .solve.sde import SOSRI, SDEAdaptiveConfig

__all__ = ["vdp_f", "kuramoto_f", "VanDerPol", "StochasticVanDerPol",
           "Kuramoto"]


def vdp_f(u, p, t):
    """dx = y; dy = mu (1 - x^2) y - x, p = (mu,) (custom.py:20-23)."""
    x, y = u[..., 0], u[..., 1]
    mu = p[..., 0]
    return torch.stack([y, mu * (1.0 - x * x) * y - x], dim=-1)


vdp_f.device_rhs = "vdp"


def kuramoto_f(n_oscillators: int, deltas=None):
    """The Kuramoto field on N phases, p = (omega, K): dphi_i = (omega +
    delta_i) + (K/N) sum_j sin(phi_j - phi_i) (custom.py:57-61, 83-92),
    the sum taken in j order and K/N as K * (1/N), the product PyTorch
    divides by a number with on the card (on the CPU it divides; the kernel
    follows the product). ``deltas`` (N,), the fixed frequency offsets,
    default zeros; ``omega + 0`` is exact, so zeros give the
    identical-frequency field."""
    n = n_oscillators
    if deltas is None:
        deltas = torch.zeros(n, dtype=torch.float32)
    deltas = torch.as_tensor(deltas, dtype=torch.float32)
    if deltas.shape != (n,):
        raise ValueError(f"deltas must have shape ({n},), got "
                         f"{tuple(deltas.shape)}")

    on = {}  # the offsets by (device, dtype), for the field and the kernel

    def offsets(device, dtype):
        d = on.get((device, dtype))
        if d is None:
            d = on[(device, dtype)] = deltas.to(device, dtype)
        return d

    def f(u, p, t):
        omega, K = p[..., 0:1], p[..., 1:2]
        s = torch.sin(u[..., None, :] - u[..., :, None])  # sin(phi_j - phi_i)
        acc = s[..., 0]
        for j in range(1, n):
            acc = acc + s[..., j]
        return (omega + offsets(u.device, u.dtype)) + (K * (1.0 / n)) * acc

    f.device_rhs = "kuramoto"
    f.rhs_consts = offsets
    f.__name__ = f"kuramoto{n}_f"
    return f


def VanDerPol(solver=Tsit5(), sensealg=Unrolled(),
              options=SolveOptions()) -> ODEDynamics:
    """Van der Pol with learned theta = [mu] (custom.py:26-29)."""
    return ODEDynamics(f=vdp_f, z_dim=2, theta_dim=1, solver=solver,
                       sensealg=sensealg, options=options)


def StochasticVanDerPol(sigma: float = 0.05, adaptive: bool = True,
                        substeps: int = 1, adaptive_cfg=None) -> SDEDynamics:
    """Van der Pol with multiplicative (diagonal) noise du = f dt +
    sigma u dW (custom.py:32-54), solved with SOSRI (the SRIW1 tableau) over
    the virtual Brownian tree; adaptive by default."""
    def g(u, p, t):
        return sigma * u

    if adaptive_cfg is None:
        adaptive_cfg = SDEAdaptiveConfig(rtol=1e-2, atol=1e-2,
                                         max_steps=256, depth_cap=8)
    return SDEDynamics(f=vdp_f, g=g, z_dim=2, theta_dim=1, solver=SOSRI(),
                       substeps=substeps, adaptive=adaptive,
                       adaptive_cfg=adaptive_cfg)


def Kuramoto(n_oscillators: int = 10, solver=Tsit5(), sensealg=Unrolled(),
             options=SolveOptions(),
             omega_spread: float = 0.0) -> ODEDynamics:
    """Kuramoto phase oscillators with learned theta = [omega, K], observed
    through ``transform = sin`` (custom.py:64-95). ``omega_spread > 0``
    gives oscillator i the fixed offset delta_i = linspace(-spread, +spread,
    N)."""
    deltas = None
    if omega_spread > 0.0:
        deltas = torch.linspace(-omega_spread, omega_spread, n_oscillators,
                                dtype=torch.float32)
    return ODEDynamics(f=kuramoto_f(n_oscillators, deltas),
                       z_dim=n_oscillators, theta_dim=2, solver=solver,
                       sensealg=sensealg, options=options,
                       transform=torch.sin)
