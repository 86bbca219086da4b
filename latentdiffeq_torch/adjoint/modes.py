"""Gradient modes (counterpart of latentdiffeq/adjoint/modes.py).

Only ``Unrolled`` is ported: autograd straight through the solver's steps
(exact gradients of the discrete solve). The interpolating and backsolve
adjoints come in a later slice.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AbstractSensealg", "Unrolled"]


@dataclasses.dataclass(frozen=True)
class AbstractSensealg:
    pass


@dataclasses.dataclass(frozen=True)
class Unrolled(AbstractSensealg):
    checkpoint: bool = False
