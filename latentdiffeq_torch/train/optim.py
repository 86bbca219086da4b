"""ADAM and ADAMW with Flux semantics (counterpart of
latentdiffeq/train/optim.py:52-92).

Flux's ADAMW is ``Optimiser(ADAM(eta, beta), WeightDecay(decay))``: the
decay term is added to the Adam update and is NOT scaled by the learning
rate (update = adam(g) + decay * p; p <- p - update). That differs from
``torch.optim.AdamW`` (decay * lr), which is not used.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

__all__ = ["FluxAdam", "adam", "adamw"]


class FluxAdam:
    """Adam with bias correction (Flux 0.13 ADAM) plus optional decoupled
    weight decay, over a fixed list of parameters. ``step()`` reads each
    parameter's ``.grad`` (a missing gradient counts as zero)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 decay: float = 0.0, scale_decay_by_lr: bool = False):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = decay * lr if scale_decay_by_lr else decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.b1, self.b2
        # bias corrections in float32, as the JAX package computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.t))
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            # a parameter below float32 (bfloat16) keeps its moments in its
            # dtype; the update is computed in float32 and rounded once into
            # it, as JAX's float32 c1, c2 promote (optim.py:36-39, 69-72)
            ct = torch.promote_types(p.dtype, torch.float32)
            upd = self.lr * (m.to(ct) / c1) / (torch.sqrt(v.to(ct) / c2)
                                               + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            p.sub_(upd.to(p.dtype))

    def state_dict(self):
        return {"m": [t.clone() for t in self.m],
                "v": [t.clone() for t in self.v], "t": self.t}

    def load_state_dict(self, state):
        with torch.no_grad():
            for dst, src in zip(self.m, state["m"]):
                dst.copy_(torch.as_tensor(src))
            for dst, src in zip(self.v, state["v"]):
                dst.copy_(torch.as_tensor(src))
        self.t = int(state["t"])


def adam(params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> FluxAdam:
    return FluxAdam(params, lr, b1, b2, eps)


def adamw(params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          decay: float = 0.0, eps: float = 1e-8,
          scale_decay_by_lr: bool = False) -> FluxAdam:
    """Flux ADAMW (reference: model_train.jl:138 uses
    ADAMW(1e-3, (0.9, 0.999), 0.001))."""
    return FluxAdam(params, lr, b1, b2, eps, decay, scale_decay_by_lr)
