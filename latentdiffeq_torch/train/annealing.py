"""Cyclical KL-annealing schedule (counterpart of
latentdiffeq/train/annealing.py; reference: src/utils/utils.jl:53-67),
including Julia's banker's rounding of the cycle offsets and its 1-based
index bound."""
from __future__ import annotations

import numpy as np

__all__ = ["frange_cycle_linear"]


def frange_cycle_linear(n_iter: int, start: float = 0.0, stop: float = 1.0,
                        n_cycle: int = 4, ratio: float = 0.5) -> np.ndarray:
    L = np.full(n_iter, stop, dtype=np.float32)
    period = n_iter / n_cycle
    step = (stop - start) / (period * ratio)
    for c in range(n_cycle):
        v, i = start, 1
        while v <= stop and int(np.round(i + c * period)) < n_iter:
            L[int(np.round(i + c * period)) - 1] = v
            v += step
            i += 1
    return L
