"""Weight initializers (counterpart of latentdiffeq/nn/init.py).

Flux's ``kaiming_uniform(gain)``: for a weight of shape ``(fan_in,
fan_out)`` (the port's Dense layout, ``y = x @ W + b``), draw from
U(-bound, bound) with ``bound = sqrt(3) * gain / sqrt(fan_in)``. The
default gain 1/sqrt(3) gives bound = 1/sqrt(fan_in). Randomness comes from
an explicit ``torch.Generator``; the draws differ from ``jax.random``, so
parity tests import weights instead of re-drawing them.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["kaiming_uniform", "glorot_uniform", "zeros_init",
           "default_init", "Initializer"]

# (shape, generator, device, dtype) -> tensor
Initializer = Callable[..., torch.Tensor]


def kaiming_uniform(gain: float = math.sqrt(2.0)) -> Initializer:
    def init(shape, generator: Optional[torch.Generator] = None,
             device=None, dtype=torch.float32):
        fan_in = shape[0] if len(shape) >= 1 else 1
        bound = math.sqrt(3.0) * gain / math.sqrt(fan_in)
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device if generator is not None
                       else device)
        return (u * (2 * bound) - bound).to(device)

    return init


def glorot_uniform() -> Initializer:
    """Glorot/Xavier uniform (init.py:34-42): U(-bound, bound) with
    ``bound = sqrt(6 / (fan_in + fan_out))``, fan_in the first and
    fan_out the last axis of ``shape`` (1 where the shape has none)."""
    def init(shape, generator: Optional[torch.Generator] = None,
             device=None, dtype=torch.float32):
        fan_in = shape[0] if len(shape) >= 1 else 1
        fan_out = shape[-1] if len(shape) >= 2 else 1
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device if generator is not None
                       else device)
        return (u * (2 * bound) - bound).to(device)

    return init


def zeros_init() -> Initializer:
    def init(shape, generator=None, device=None, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return init


# The reference's default everywhere (GOKU.jl:204).
default_init = kaiming_uniform(gain=1.0 / math.sqrt(3.0))
