"""latentdiffeq_torch — the PyTorch / CUDA port of latentdiffeq.

A second package beside the JAX one (which stays the reference), laid out
the same way so each module's counterpart is easy to find:
  nn/        Dense / resnet-MLP / RNN and LSTM cells, Flux init
  solve/     RK tableaus and the fixed-grid solve
  adjoint/   SolveOptions and odeint (Unrolled gradients)
  ops/       hand-written CUDA kernels for Hopper, each beside its plain
             PyTorch version (csrc/ holds the sources)
  models/    the six-slot template, GOKU, LatentODE
  train/     ELBO losses, KL annealing, windows, Flux ADAMW, trainer,
             checkpoints and the JAX weight bridge
  pendulum.py, pendulum_data.py: the pendulum problem and its video data

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from .core import Identity, resolve_device
from . import nn, solve, adjoint, ops, models, train
from .solve import Euler, Midpoint, RK4, Tsit5, Dopri5
from .adjoint import SolveOptions, Unrolled, odeint

__all__ = ["resolve_device", "Identity", "nn", "solve", "adjoint", "ops", "models",
           "train", "Euler", "Midpoint", "RK4", "Tsit5", "Dopri5",
           "SolveOptions", "Unrolled", "odeint"]
