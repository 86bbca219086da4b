"""Refinement-consistent Brownian paths: bridge increments and the virtual
Brownian tree (counterpart of latentdiffeq/solve/brownian.py:38-146).

Every dyadic cell's ``(dW, I(1,0))``, with ``I(1,0) = int_t^{t+h} (W(s) -
W(t)) ds``, comes from recursive conditional bisection keyed on (interval,
level, node), so any two traversals agree exactly and no state is carried.
The keys are JAX's threefry keys (``latentdiffeq_torch.random``), so a key
gives the same path here as in the JAX package.

Root law over a cell of width h: ``W ~ N(0, h)``, ``I | W ~ N(W h/2,
h^3/12)``. Bisection law, given the cell's totals ``(w, i)``:

    W_left  ~ N( -w/4 + (3/(2h)) i,  h/16   )
    I_left  ~ N( -(h/8) w + i/2,     h^3/192 )
    W_right = w - W_left
    I_right = i - I_left - (h/2) W_left      (relative to the midpoint)

Unlike the JAX functions, which take one key and are vmapped, these take a
batch of keys ``(..., 2)``; the state ``shape`` follows the batch. Their
arithmetic is correctly rounded on every device (square roots by
``sqrt_rn``, divisions by a tensor: PyTorch divides a card tensor by a
number as a product with its reciprocal), so a key gives the same bits on
the CPU and on the card.
"""
from __future__ import annotations

import torch

from .. import random as jr

__all__ = ["interval_root", "bridge_split", "bridge_increments",
           "vbt_query"]


def _trailing(h, ndim: int):
    """``h`` (batch...) -> (batch..., 1 x ndim), to broadcast over a state."""
    return h.reshape(h.shape + (1,) * ndim)


def _cube(h):
    return h * (h * h)   # XLA's integer_pow(h, 3)


def _div(x, c: float):
    return x / x.new_full((), c)


def _width(h, dtype, device):
    """A cell width as a tensor: a number is filled on the device (no copy
    from the host, so a CUDA graph can capture it)."""
    if isinstance(h, torch.Tensor):
        return h.to(device=device, dtype=dtype)
    return torch.full((), float(h), dtype=dtype, device=device)


def _normals(key, shape, dtype):
    """The two normals of a cell, each (..., *shape): JAX draws them as one
    (2, *shape) array."""
    z = jr.normal(key, (2,) + tuple(shape), dtype)
    return z.unbind(-len(shape) - 1)


def _root(z, h):
    """Root law from the normals ``z = (z0, z1)``; ``h`` broadcasts against
    a state."""
    w = jr.sqrt_rn(h) * z[0]
    i = 0.5 * h * w + jr.sqrt_rn(_div(_cube(h), 12.0)) * z[1]
    return w, i


def _split(z, w, i, h):
    """Bisection law from the normals ``z = (z0, z1)``."""
    w_l = -0.25 * w + (h.new_full((), 1.5) / h) * i \
        + jr.sqrt_rn(h / 16.0) * z[0]
    i_l = -(h / 8.0) * w + 0.5 * i + jr.sqrt_rn(_div(_cube(h), 192.0)) \
        * z[1]
    w_r = w - w_l
    i_r = i - i_l - 0.5 * h * w_l
    return w_l, i_l, w_r, i_r


def interval_root(key, h, shape, dtype=torch.float32):
    """``(W, I)`` of whole cells of width ``h``: key (..., 2), ``h`` a
    number or a tensor of the keys' batch shape; returns two (...,
    *shape)."""
    shape = tuple(shape)
    h = _width(h, dtype, key.device)
    return _root(_normals(key, shape, dtype), _trailing(h, len(shape)))


def bridge_split(key, w, i, h):
    """Split cells of width ``h`` with totals ``(w, i)`` (..., *shape) into
    halves, one key (..., 2) a cell. Returns ``(w_left, i_left, w_right,
    i_right)``, each ``I`` relative to its own half's start."""
    shape = w.shape[key.dim() - 1:]
    h = _width(h, w.dtype, w.device)
    if h.dim():
        h = _trailing(h, len(shape))
    return _split(_normals(key, shape, w.dtype), w, i, h)


def _node_key(interval_key, level, node):
    return jr.fold_in(jr.fold_in(interval_key, level), node)


def bridge_increments(key, saveat, substeps: int, shape,
                      dtype=torch.float32):
    """Per-interval Brownian increments and space-time integrals on the
    grid ``saveat`` (T,): interval n is the root cell of
    ``fold_in(key, n)``, bisected ``log2(substeps)`` times. key (..., 2);
    returns ``(dws, i10s)``, each (..., T-1, substeps, *shape). The path at
    ``substeps = 2m`` is a bisection of the path at ``m``: pairwise sums of
    its increments are the coarser ones. ``substeps`` must be a power of
    two."""
    if substeps < 1 or (substeps & (substeps - 1)) != 0:
        raise ValueError(f"substeps must be a power of 2, got {substeps}")
    shape = tuple(shape)
    saveat = torch.as_tensor(saveat, device=key.device)
    n = saveat.shape[0] - 1
    hs = (saveat[1:] - saveat[:-1]).to(dtype)
    cells = torch.arange(n, dtype=torch.int64, device=key.device)
    interval_keys = jr.fold_in(key[..., None, :], cells)    # (..., n, 2)
    w, i = interval_root(interval_keys, hs.expand(interval_keys.shape[:-1]),
                         shape, dtype)
    w, i = w.unsqueeze(-len(shape) - 1), i.unsqueeze(-len(shape) - 1)
    lead = w.shape[:-len(shape) - 2]
    h = _trailing(hs, len(shape) + 1)                       # (n, 1, 1...)
    level, m = 1, 1
    while m < substeps:
        nodes = torch.arange(m, dtype=torch.int64, device=key.device)
        node_keys = _node_key(interval_keys[..., None, :], level, nodes)
        z = _normals(node_keys, shape, dtype)             # (..., n, m, *)
        w_l, i_l, w_r, i_r = _split(z, w, i, h / m)
        # interleave left and right halves: (..., n, 2m, *shape)
        w = torch.stack([w_l, w_r], dim=-len(shape) - 1).reshape(
            lead + (n, 2 * m) + shape)
        i = torch.stack([i_l, i_r], dim=-len(shape) - 1).reshape(
            lead + (n, 2 * m) + shape)
        m *= 2
        level += 1
    return w, i


def vbt_query(key, interval_idx, h_interval, k, m, shape, depth_cap: int,
              dtype=torch.float32):
    """``(dW, I(1,0))`` of the dyadic cell ``[m/2^k, (m+1)/2^k]`` of save
    interval ``interval_idx`` (width ``h_interval``), by descending the
    virtual tree. One row a key: key (N, 2); ``interval_idx``, ``k``, ``m``
    (N,) integers with ``k <= depth_cap``; ``h_interval`` (N,). Returns two
    (N, *shape).

    The descent runs ``depth_cap`` masked levels, as the JAX loop does. The
    node keys and normals of every level do not depend on the descent's
    values, so they are drawn for all levels in one batched call first.
    Node keying matches :func:`bridge_increments`: a fixed-grid solve with
    ``substeps = 2^k`` and an adaptive solve that lands on the same cells
    consume the same numbers."""
    shape = tuple(shape)
    dev = key.device
    interval_key = jr.fold_in(key, interval_idx)            # (N, 2)
    levels = torch.arange(1, depth_cap + 1, dtype=torch.int64, device=dev)
    kk, mm = k.to(torch.int64)[:, None], m.to(torch.int64)[:, None]
    active = levels <= kk                                   # (N, D)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    parent = torch.where(active, mm >> (kk - levels + 1).clamp(min=0), zero)
    bit = torch.where(active, (mm >> (kk - levels).clamp(min=0)) & 1, zero)
    node_keys = _node_key(interval_key[:, None, :], levels, parent)
    keys = torch.cat([interval_key[:, None, :], node_keys], dim=1)
    z0, z1 = _normals(keys, shape, dtype)                 # (N, D+1, *)
    h = _trailing(_width(h_interval, dtype, dev), len(shape))
    w, i = _root((z0[:, 0], z1[:, 0]), h)
    for j in range(depth_cap):
        on = _trailing(active[:, j], len(shape))
        right = _trailing(bit[:, j] == 1, len(shape))
        w_l, i_l, w_r, i_r = _split((z0[:, j + 1], z1[:, j + 1]), w, i, h)
        w = torch.where(on, torch.where(right, w_r, w_l), w)
        i = torch.where(on, torch.where(right, i_r, i_l), i)
        h = torch.where(on, h / 2.0, h)
    return w, i
