"""Recurrent cells and stacked runners (counterpart of
latentdiffeq/nn/recurrent.py).

Flux cell semantics, one bias and learned initial states (``h0``/``c0``);
``torch.nn.RNN``/``LSTM`` (two biases, zero initial state) are not used:
  RNNCell:  h' = act(x @ Wi + h @ Wh + b)
  LSTMCell: gates (i, f, g, o) = split(x @ Wi + h @ Wh + b, 4)
            c' = sigmoid(f) * c + sigmoid(i) * tanh(g);  h' = sigmoid(o) * tanh(c')
The time loop is a Python loop; on the card the three GOKU heads run as one
CUDA kernel instead (ops/recurrent_cuda.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .init import Initializer, default_init
from .layers import relu

__all__ = ["RNNCell", "LSTMCell", "Recurrent", "fused_goku_heads"]


class RNNCell(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int,
                 activation: Callable = relu, *,
                 winit: Initializer = default_init, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.Wi = nn.Parameter(winit((in_dim, hidden_dim), **kw))
        self.Wh = nn.Parameter(winit((hidden_dim, hidden_dim), **kw))
        self.b = nn.Parameter(torch.zeros(hidden_dim, device=device,
                                          dtype=dtype))
        self.h0 = nn.Parameter(torch.zeros(hidden_dim, device=device,
                                           dtype=dtype))
        self.activation = activation

    @property
    def hidden_dim(self) -> int:
        return self.Wh.shape[0]

    def initial_state(self, batch: int):
        return self.h0.expand(batch, self.h0.shape[0])

    def forward(self, state, x):
        h_new = self.activation(x.to(self.Wi.dtype) @ self.Wi
                                + state @ self.Wh + self.b)
        return h_new, h_new


class LSTMCell(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, *,
                 winit: Initializer = default_init, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.Wi = nn.Parameter(winit((in_dim, 4 * hidden_dim), **kw))
        self.Wh = nn.Parameter(winit((hidden_dim, 4 * hidden_dim), **kw))
        z = dict(device=device, dtype=dtype)
        self.b = nn.Parameter(torch.zeros(4 * hidden_dim, **z))
        self.h0 = nn.Parameter(torch.zeros(hidden_dim, **z))
        self.c0 = nn.Parameter(torch.zeros(hidden_dim, **z))

    @property
    def hidden_dim(self) -> int:
        return self.h0.shape[0]

    def initial_state(self, batch: int):
        n = self.hidden_dim
        return (self.h0.expand(batch, n), self.c0.expand(batch, n))

    def forward(self, state, x):
        h, c = state
        gates = x.to(self.Wi.dtype) @ self.Wi + h @ self.Wh + self.b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return (h_new, c_new), h_new


def _advance_stack(cells, states, x):
    new_states = []
    out = x
    for cell, st in zip(cells, states):
        st, out = cell(st, out)
        new_states.append(st)
    return new_states, out


def _top(states):
    t = states[-1]
    return t[0] if isinstance(t, tuple) else t


class Recurrent(nn.Module):
    """A stack of cells advanced together, one time step at a time
    (GOKU.jl:224-234, 36-41). ``xs``: (batch, time, in). ``reverse=True``
    consumes t = T-1 .. 0."""

    def __init__(self, cells: Sequence[nn.Module]):
        super().__init__()
        self.cells = nn.ModuleList(cells)

    @staticmethod
    def rnn(in_dim: int, hidden_dims, activation: Callable = relu, **kw):
        cells, d = [], in_dim
        for h in hidden_dims:
            cells.append(RNNCell(d, h, activation, **kw))
            d = h
        return Recurrent(cells)

    @staticmethod
    def lstm(in_dim: int, hidden_dims, **kw):
        cells, d = [], in_dim
        for h in hidden_dims:
            cells.append(LSTMCell(d, h, **kw))
            d = h
        return Recurrent(cells)

    def forward(self, xs, *, reverse: bool = False,
                return_sequence: bool = False,
                mask: Optional[torch.Tensor] = None):
        """Last top-layer output (batch, hidden), or the full (batch, time,
        hidden) sequence. ``mask`` (time,) bool: steps where it is False
        leave the state unchanged; it indexes the time axis of ``xs`` for
        either direction (masked-curriculum building block)."""
        if mask is not None and return_sequence:
            raise NotImplementedError(
                "mask + return_sequence: masked mode supports final-state "
                "reads only")
        batch, T = xs.shape[0], xs.shape[1]
        states = [cell.initial_state(batch) for cell in self.cells]
        outs = [None] * T
        order = range(T - 1, -1, -1) if reverse else range(T)
        for t in order:
            new_states, out = _advance_stack(self.cells, states, xs[:, t])
            if mask is not None:
                m = mask[t]
                new_states = [
                    tuple(torch.where(m, a, b) for a, b in zip(ns, st))
                    if isinstance(ns, tuple) else torch.where(m, ns, st)
                    for ns, st in zip(new_states, states)]
            states = new_states
            outs[t] = out
        if return_sequence:
            return torch.stack(outs, dim=1)
        return _top(states)


def fused_goku_heads(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
                     pe_theta_bwd: Recurrent, xs):
    """All three GOKU pattern-extractor heads in one time loop: step t
    advances the forward LSTM on x[t] and the z0 RNN and backward LSTM on
    x[T-1-t] (GOKU.jl:30-49). Returns ``(z0_out, theta_out)`` with
    theta_out = fwd_last ++ bwd_last."""
    batch, T = xs.shape[0], xs.shape[1]
    st_z0 = [c.initial_state(batch) for c in pe_z0.cells]
    st_f = [c.initial_state(batch) for c in pe_theta_fwd.cells]
    st_b = [c.initial_state(batch) for c in pe_theta_bwd.cells]
    for t in range(T):
        x_fwd, x_rev = xs[:, t], xs[:, T - 1 - t]
        st_f, _ = _advance_stack(pe_theta_fwd.cells, st_f, x_fwd)
        st_z0, _ = _advance_stack(pe_z0.cells, st_z0, x_rev)
        st_b, _ = _advance_stack(pe_theta_bwd.cells, st_b, x_rev)
    return _top(st_z0), torch.cat([_top(st_f), _top(st_b)], dim=-1)
