"""Gradient modes (counterpart of latentdiffeq/adjoint/modes.py).

- ``Unrolled``: autograd straight through the solver's steps (exact
  gradients of the discrete solve); ``checkpoint=True`` recomputes each grid
  interval in the backward instead of storing its stages.
- ``InterpolatingAdjoint``: the backward re-solves each ``saveat`` interval
  from the stored state and differentiates the re-solve; error-controlled
  (``bwd_rtol``/``bwd_atol``, ``bwd_max_steps`` attempts an interval) when
  ``adaptive`` and the solver has an error estimate, else ``bwd_substeps``
  fixed steps. A fixed-grid forward is exact: it is the checkpointed
  unrolled solve.
- ``BacksolveAdjoint``: the continuous adjoint ODE integrated backward in
  time (Chen et al. 2018), with the state reset to the stored forward state
  at each save point when ``checkpointing``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AbstractSensealg", "Unrolled", "InterpolatingAdjoint",
           "BacksolveAdjoint"]


@dataclasses.dataclass(frozen=True)
class AbstractSensealg:
    pass


@dataclasses.dataclass(frozen=True)
class Unrolled(AbstractSensealg):
    checkpoint: bool = False


@dataclasses.dataclass(frozen=True)
class InterpolatingAdjoint(AbstractSensealg):
    bwd_substeps: int = 8
    adaptive: bool = True
    bwd_rtol: float = 1e-4
    bwd_atol: float = 1e-7
    bwd_max_steps: int = 32   # per saveat interval


@dataclasses.dataclass(frozen=True)
class BacksolveAdjoint(AbstractSensealg):
    bwd_substeps: int = 8
    adaptive: bool = True
    bwd_rtol: float = 1e-4
    bwd_atol: float = 1e-7
    bwd_max_steps: int = 32   # per saveat interval
    checkpointing: bool = True
