"""latentdiffeq_torch — the PyTorch / CUDA port of latentdiffeq.

A second package beside the JAX one (which stays the reference), laid out
the same way so each module's counterpart is easy to find:
  nn/        Dense / resnet-MLP / RNN and LSTM cells, Flux init
  solve/     RK tableaus, the fixed-grid and adaptive solves, the SDE
             solvers and their Brownian tree, problems and the solve /
             solve_ensemble API
  random.py  JAX's threefry PRNG keys (PRNGKey, fold_in, split, normal)
  adjoint/   SolveOptions and odeint (Unrolled gradients, the
             interpolating and backsolve adjoints)
  ops/       hand-written CUDA kernels for Hopper, each beside its plain
             PyTorch version (csrc/ holds the sources)
  models/    the six-slot template, GOKU, LatentODE
  train/     ELBO losses, KL annealing, windows, Flux ADAMW, trainer
             (curricula, adaptive-budget autosize), population training
             (multiseed.py), selection scores, the latent warm start,
             checkpoints and the JAX weight bridge
  pendulum.py, pendulum_data.py: the pendulum problem and its video data
  pixel_observable.py: the pendulum's pixel-angle readout, its warm start
             and population selection scores
  custom_dynamics.py, custom_data.py: Van der Pol and Kuramoto, and their
             lifted observations

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from .core import Identity, resolve_device
from . import nn, random, solve, adjoint, ops, models, train
from .solve import (ODEProblem, SDEProblem, Solution, remake, Euler,
                    Midpoint, RK4, Tsit5, Dopri5, solve, solve_ensemble,
                    make_options, autosize_max_steps, AdaptiveConfig,
                    EulerMaruyama, StochasticHeun, SRA1, SRIW1, SOSRI,
                    SDEAdaptiveConfig)
from .adjoint import (Unrolled, InterpolatingAdjoint, BacksolveAdjoint,
                      odeint, SolveOptions)
from .train import (vector_mse, kl, vector_kl, frange_cycle_linear,
                    normalize_to_unit_segment, denormalize_unit_segment,
                    time_loader, rand_time)

__all__ = ["resolve_device", "Identity", "nn", "ODEProblem", "SDEProblem",
           "Solution", "remake", "Euler", "Midpoint", "RK4", "Tsit5",
           "Dopri5", "solve", "solve_ensemble", "make_options",
           "autosize_max_steps", "AdaptiveConfig", "EulerMaruyama",
           "StochasticHeun", "SRA1", "SRIW1", "SOSRI", "SDEAdaptiveConfig",
           "Unrolled",
           "InterpolatingAdjoint", "BacksolveAdjoint", "odeint",
           "SolveOptions", "vector_mse", "kl", "vector_kl",
           "frange_cycle_linear", "normalize_to_unit_segment",
           "denormalize_unit_segment", "time_loader", "rand_time",
           "adjoint", "ops", "models", "train", "random"]
