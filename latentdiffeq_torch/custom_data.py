"""Van der Pol and Kuramoto observation data (counterparts of
examples/custom_dynamics/train_vdp.py:25-64 and train_kuramoto.py:37-86).

The initial states, parameters and observation map come from the same
numpy ``default_rng(seed)`` draws, in the same order, as the JAX examples,
so they are identical. The trajectories come from the port's
``solve_ensemble`` on ``device`` (the card unless the caller asks for the
CPU), on the training grid: the options of the dynamics spec returned,
``make_options(adaptive=False, substeps=4)``. The stochastic Van der Pol
(``stochastic_sigma > 0``) is solved as the example solves it: SOSRI on
the grid with 4 sub-steps over the Brownian path of ``PRNGKey(seed)``.
(The examples' ``make_data`` for the ODE passes no options, so it solves
adaptively at rtol 1e-3, atol 1e-6; in float32 that is no closer than
~0.5 to the true Van der Pol trajectories at mu 4, the relaxation jumps'
timing, and two float32 implementations differ by as much. A caller who
wants that recipe passes ``options=make_options()``, as the port's
training CLIs do, latentdiffeq_torch/examples/custom_dynamics/.) The
observations are a fixed random linear + relu lift of the state (VdP) or of
sin(phases) (Kuramoto), min-max normalised over the whole set.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import random as jr
from .adjoint import SolveOptions
from .core import resolve_device
from .custom_dynamics import Kuramoto, StochasticVanDerPol, VanDerPol
from .solve import ODEProblem, SDEProblem, make_options, solve_ensemble

__all__ = ["make_vdp_data", "make_kuramoto_data"]


def _lift(z, W, b):
    """(relu(z @ W + b), its min, its max) on z's device."""
    W = torch.from_numpy(W).to(z.device)
    b = torch.from_numpy(b).to(z.device)
    x = torch.relu(z @ W + b)
    return x, x.min(), x.max()


def make_vdp_data(n_traj: int = 256, T: int = 100, dt: float = 0.1,
                  input_dim: int = 64, seed: int = 0, mu_max: float = 2.0,
                  stochastic_sigma: float = 0.0, device=None,
                  options: Optional[SolveOptions] = None):
    """Van der Pol trajectories with mu ~ U(0.5, mu_max), u0 ~ U(-2, 2),
    observed through a random relu lift to ``input_dim`` channels.
    Returns ``(x (n, T, input_dim), z (n, T, 2), mus (n, 1), vdp)``, the
    tensors on ``device``. ``stochastic_sigma > 0``: the trajectories of
    the multiplicative-noise SDE du = f dt + sigma u dW
    (train_vdp.py:41-51), and ``vdp`` is its SDE spec. ``options``: the
    ODE solve's, default the returned dynamics' own (the training grid);
    ``make_options()`` is the examples' adaptive solve."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    u0s = rng.uniform(-2.0, 2.0, (n_traj, 2)).astype(np.float32)
    mus = rng.uniform(0.5, mu_max, (n_traj, 1)).astype(np.float32)
    saveat = torch.arange(T, dtype=torch.float32, device=device) * dt
    u0s_t = torch.from_numpy(u0s).to(device)
    mus_t = torch.from_numpy(mus).to(device)
    tspan = (0.0, float(saveat[-1]))
    with torch.no_grad():
        if stochastic_sigma > 0.0:
            vdp = StochasticVanDerPol(sigma=stochastic_sigma)
            prob = SDEProblem(f=vdp.f, g=vdp.g, u0=u0s_t[0], tspan=tspan,
                              p=mus_t[0])
            z = solve_ensemble(prob, vdp.solver, u0s=u0s_t, ps=mus_t,
                               saveat=saveat, key=jr.PRNGKey(seed),
                               substeps=4).ys
        else:
            vdp = VanDerPol(options=make_options(adaptive=False,
                                                 substeps=4))
            prob = ODEProblem(f=vdp.f, u0=u0s_t[0], tspan=tspan, p=mus_t[0])
            z = solve_ensemble(prob, vdp.solver, u0s=u0s_t, ps=mus_t,
                               saveat=saveat,
                               options=options if options is not None
                               else vdp.options).ys
    W = rng.normal(0, 1, (2, input_dim)).astype(np.float32)
    b = rng.normal(0, 0.3, (input_dim,)).astype(np.float32)
    x, lo, hi = _lift(z, W, b)
    return (x - lo) / (hi - lo), z, mus_t, vdp


def make_kuramoto_data(n_traj: int = 256, T: int = 100, dt: float = 0.1,
                       n_osc: int = 10, input_dim: int = 64, seed: int = 0,
                       omega_range=(1.0, 3.0), k_range=(0.2, 2.0),
                       omega_spread: float = 0.0, return_lift: bool = False,
                       device=None, options: Optional[SolveOptions] = None):
    """Kuramoto ensembles with omega ~ U(omega_range), K ~ U(k_range),
    phases ~ U(-pi, pi), observed through sin and a random relu lift.
    Returns ``(x (n, T, input_dim), z_sin (n, T, n_osc), thetas (n, 2),
    kur)``, the tensors on ``device``; with ``return_lift`` also the exact
    observation map ``{"W", "b", "mn", "mx"}`` (numpy W and b, float mn and
    mx): x = (relu(z_sin @ W + b) - mn) / (mx - mn). ``options``: the
    solve's, default the returned dynamics' own (the training grid)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    u0s = rng.uniform(-np.pi, np.pi, (n_traj, n_osc)).astype(np.float32)
    thetas = np.stack([rng.uniform(*omega_range, n_traj),
                       rng.uniform(*k_range, n_traj)],
                      axis=1).astype(np.float32)
    saveat = torch.arange(T, dtype=torch.float32, device=device) * dt
    kur = Kuramoto(n_oscillators=n_osc,
                   options=make_options(adaptive=False, substeps=4),
                   omega_spread=omega_spread)
    u0s_t = torch.from_numpy(u0s).to(device)
    th_t = torch.from_numpy(thetas).to(device)
    prob = ODEProblem(f=kur.f, u0=u0s_t[0], tspan=(0.0, float(saveat[-1])),
                      p=th_t[0])
    with torch.no_grad():
        z_sin = torch.sin(solve_ensemble(
            prob, kur.solver, u0s=u0s_t, ps=th_t, saveat=saveat,
            options=options if options is not None else kur.options).ys)
    W = rng.normal(0, 1, (n_osc, input_dim)).astype(np.float32)
    b = rng.normal(0, 0.3, (input_dim,)).astype(np.float32)
    x, lo, hi = _lift(z_sin, W, b)
    mn, mx = float(lo), float(hi)
    x = (x - mn) / (mx - mn)
    if return_lift:
        return x, z_sin, th_t, kur, {"W": W, "b": b, "mn": mn, "mx": mx}
    return x, z_sin, th_t, kur
