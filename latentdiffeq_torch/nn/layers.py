"""Feed-forward layers (counterpart of latentdiffeq/nn/layers.py:20-122).

``Dense.W`` keeps the JAX layout ``(in, out)`` and computes
``x @ W + b``; ``torch.nn.Linear`` stores ``(out, in)`` and is not used.
Parameter names and registration order follow the JAX pytree, so
``named_parameters()`` with '.' read as '/' gives the JAX key paths
(train/checkpoint.py relies on it).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import Initializer, default_init

__all__ = ["Dense", "Chain", "SkipConnection", "FrozenLinear", "mlp",
           "resnet_mlp", "identity", "relu", "softplus", "sigmoid", "tanh"]


def identity(x):
    return x


relu = torch.relu
softplus = F.softplus
sigmoid = torch.sigmoid
tanh = torch.tanh


class Dense(nn.Module):
    """``y = activation(x @ W + b)`` (Flux ``Dense``, reference:
    GOKU.jl:214-258)."""

    def __init__(self, in_dim: int, out_dim: int,
                 activation: Callable = identity, *,
                 winit: Initializer = default_init,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.W = nn.Parameter(winit((in_dim, out_dim), generator=generator,
                                    device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device,
                                          dtype=dtype))
        self.activation = activation

    @property
    def in_dim(self) -> int:
        return self.W.shape[0]

    @property
    def out_dim(self) -> int:
        return self.W.shape[1]

    def forward(self, x):
        return self.activation(x.to(self.W.dtype) @ self.W + self.b)


class Chain(nn.Module):
    """Sequential composition (Flux ``Chain``)."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def __getitem__(self, i):
        return self.layers[i]

    def __len__(self):
        return len(self.layers)


class SkipConnection(nn.Module):
    """``y = layer(x) + x`` (Flux ``SkipConnection(l, +)``)."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return self.layer(x) + x


class FrozenLinear(nn.Module):
    """``y = activation(x @ W + b) * out_scale + out_shift`` with W and b
    held as buffers, not parameters, so neither autograd nor ADAMW's
    decoupled weight decay ever touches them, and the JAX weight bridge
    (which reads parameters) skips them: the JAX checkpoint has no leaves
    for them either (layers.py:126-188). A known observation model in the
    reconstructor slot, as the Kuramoto known-lift campaign uses it. The
    product runs in W's type (float32); the result is cast back to x's."""

    def __init__(self, W, b, activation: Callable = identity,
                 out_scale: float = 1.0, out_shift: float = 0.0):
        super().__init__()
        W = torch.as_tensor(W, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32)
        if W.dim() != 2 or tuple(b.shape) != (W.shape[1],):
            raise ValueError(
                f"FrozenLinear: W must be 2-D and b must have shape "
                f"(W.shape[1],); got W {tuple(W.shape)}, b "
                f"{tuple(b.shape)}")
        self.register_buffer("W", W.clone())
        self.register_buffer("b", b.clone())
        self.activation = activation
        self.out_scale = float(out_scale)
        self.out_shift = float(out_shift)

    @staticmethod
    def from_arrays(W, b, activation: Callable = identity,
                    out_scale: float = 1.0,
                    out_shift: float = 0.0) -> "FrozenLinear":
        """From numpy arrays or tensors (on the CPU; move it with
        ``.to(device)``)."""
        return FrozenLinear(torch.as_tensor(np.asarray(W, np.float32)),
                            torch.as_tensor(np.asarray(b, np.float32)),
                            activation, out_scale, out_shift)

    def forward(self, x):
        y = self.activation(x.to(self.W.dtype) @ self.W + self.b)
        return (y * self.out_scale + self.out_shift).to(x.dtype)


def mlp(dims, activation: Callable = relu,
        out_activation: Callable = identity, *,
        winit: Initializer = default_init, generator=None, device=None,
        dtype=torch.float32) -> Chain:
    """Dense stack with ``activation`` on hidden layers (GOKU.jl:252-258)."""
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        act = out_activation if i == len(dims) - 2 else activation
        layers.append(Dense(din, dout, act, winit=winit, generator=generator,
                            device=device, dtype=dtype))
    return Chain(layers)


def resnet_mlp(in_dim: int, hidden_dim: int, out_dim: int,
               activation: Callable = relu,
               out_activation: Callable = identity, *,
               winit: Initializer = default_init, generator=None,
               device=None, dtype=torch.float32) -> Chain:
    """Dense -> 2x (Dense + skip) -> Dense (GOKU.jl:214-221, 262-269)."""
    kw = dict(winit=winit, generator=generator, device=device, dtype=dtype)
    return Chain([
        Dense(in_dim, hidden_dim, activation, **kw),
        SkipConnection(Dense(hidden_dim, hidden_dim, activation, **kw)),
        SkipConnection(Dense(hidden_dim, hidden_dim, activation, **kw)),
        Dense(hidden_dim, out_dim, out_activation, **kw),
    ])
