"""Data-parallel ELBO steps over the ranks of a mesh (counterpart of
latentdiffeq/parallel/data_parallel.py).

The port keeps the semantics of JAX's two steps, not their mechanism:

1. ``make_dp_train_step`` is JAX's GSPMD step: it computes what the one
   device step computes on the global minibatch. One window from ``key``
   for the whole minibatch; the global batch's reparameterisation noise
   drawn from ``kvar`` as JAX's template draws it (models/template.py:
   146-152, here through ``latentdiffeq_torch.random``), each rank taking
   its rows; the loss's batch couplings made global (``BatchShards``: the
   count of successful rows under ``mask_failures``, the per-dimension KL
   under ``free_bits``); the gradients averaged over the ranks, which is
   the global mean since every rank holds the same number of rows.
2. ``make_shardmap_train_step`` is JAX's explicit step: the same window on
   every rank, noise from ``fold_in(kvar, rank)``, each rank's loss on its
   own rows, the gradients' all-reduce mean, the ``n_*`` metrics summed
   over the ranks and every other metric averaged.

``Trainer(mesh=)`` trains the GSPMD way through
``torch.nn.parallel.DistributedDataParallel``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import random as jr
from ..models.dynamics import SDEDynamics
from ..models.template import _noise_dtype, _noise_widths
from ..train.losses import loss_batch

__all__ = ["make_dp_train_step", "make_shardmap_train_step",
           "BatchShards", "allreduce_mean", "reduce_metrics",
           "template_noise"]


class BatchShards:
    """The ranks of a data-parallel minibatch, as the loss sees them:
    ``world`` ranks of equal shards and ``sum(t)``, the sum of ``t`` over
    them (no gradient). ``loss_batch(shards=)`` uses it to compute each
    rank's share of the global batch's loss."""

    def __init__(self, group, world: int):
        self.group, self.world = group, world

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t


def allreduce_mean(tensors, group, world: int):
    """Average ``tensors`` over the ranks in place, in one all-reduce of a
    flat buffer (gloo has no average reduction, so a sum then a
    division)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def reduce_metrics(metrics, group, world: int):
    """Metrics of every rank's shard made global, as JAX's explicit step
    makes them (data_parallel.py:100-106): the ``n_*`` counts summed, the
    rest averaged (in float32)."""
    names = list(metrics)
    counts = [k for k in names if k.startswith("n_")]
    means = [k for k in names if not k.startswith("n_")]
    out = {}
    if counts:
        c = torch.stack([metrics[k].detach().to(torch.int64)
                         for k in counts])
        dist.all_reduce(c, group=group)
        out.update(zip(counts, c))
    if means:
        m = torch.stack([metrics[k].detach().float() for k in means])
        dist.all_reduce(m, group=group)
        out.update(zip(means, m / world))
    return {k: out[k] for k in names}


def template_noise(model, key, batch: int):
    """The reparameterisation noise of ``batch`` rows that JAX's template
    draws from ``key`` (models/template.py:146-152): ``skey = split(key)
    [0]``, then GOKU's ``split(skey)`` for z0 and theta (goku.py:79-83), or
    one draw from ``skey`` (latent_ode.py:60-63)."""
    skey = jr.split(key)[0]
    widths, dtype = _noise_widths(model), _noise_dtype(model)
    if isinstance(widths, tuple):
        return tuple(jr.normal(k, (batch, w), dtype)
                     for k, w in zip(jr.split(skey, len(widths)), widths))
    return jr.normal(skey, (batch, widths), dtype)


def _rows(tree, r: int, b: int):
    if isinstance(tree, tuple):
        return tuple(_rows(t, r, b) for t in tree)
    return tree[r * b:(r + 1) * b]


def _window(x, key, seq_len: int):
    full = x.shape[1]
    start = int(jr.randint(key, (), 0, max(full - seq_len, 1)))
    return x[:, start:start + seq_len]


def _is_sde(model) -> bool:
    return isinstance(getattr(model.decoder, "diffeq", None), SDEDynamics)


def _step(optimizer, mesh, seq_len, dt, variational, loss_fn, shardmap):
    group, world = mesh.get_group(), mesh.size()
    rank = mesh.get_local_rank()
    shards = None if shardmap else BatchShards(group, world)

    def step(model, opt, x, key, beta):
        opt = optimizer if opt is None else opt
        dev = x.device
        t = torch.arange(seq_len, dtype=torch.float32, device=dev) * dt
        kwin, kvar = jr.split(jr.as_key(key, dev))
        if shardmap:
            kvar = jr.fold_in(kvar, rank)
        xw = _window(x, kwin, seq_len)
        b = x.shape[0]
        n = b if shardmap else b * world     # the rows the noise covers
        kw = {}
        if variational:
            kw["eps"] = _rows(template_noise(model, kvar, n),
                              0 if shardmap else rank, b)
        if _is_sde(model):
            dkey = jr.split(kvar)[1] if variational else kvar
            if not shardmap:                 # the global rows' paths
                dkey = _rows(jr.split(dkey, n), rank, b)
            kw["key"] = dkey
        if shards is not None:
            kw["shards"] = shards
        opt.zero_grad()
        loss, metrics = loss_fn(model, xw, t, beta, variational=variational,
                                **kw)
        loss.backward()
        allreduce_mean([p.grad for p in model.parameters()
                        if p.grad is not None], group, world)
        opt.step()
        return model, opt, reduce_metrics(metrics, group, world)

    return step


def make_dp_train_step(optimizer, mesh, *, seq_len: int, dt: float,
                       variational: bool = True,
                       loss_fn: Callable = loss_batch,
                       axis_name: str = "data"):
    """The GSPMD data-parallel step. Call as ``step(model, optimizer, x,
    key, beta)`` on every rank, with ``x`` this rank's rows of the global
    minibatch (``shard_batch``; global batch = rows x ranks) and the same
    ``key`` (a JAX key, ``latentdiffeq_torch.random``) everywhere. The
    port's optimizers are objects bound to the parameters, so the step
    takes one in place of JAX's ``opt_state`` (None: ``optimizer``) and
    updates it in place.
    ``loss_fn`` must take ``eps=`` and ``shards=`` as ``loss_batch`` does.
    Returns ``(model, optimizer, metrics)``, the metrics those of the
    global batch and equal on every rank."""
    return _step(optimizer, mesh, seq_len, dt, variational, loss_fn, False)


def make_shardmap_train_step(optimizer, mesh, *, seq_len: int, dt: float,
                             variational: bool = True,
                             loss_fn: Callable = loss_batch,
                             axis_name: str = "data"):
    """JAX's explicit-SPMD step: each rank's loss on its own rows (``x``
    as for ``make_dp_train_step``), with its noise from ``fold_in(kvar,
    rank)``, then the gradients' all-reduce mean; the ``n_*`` metrics are
    summed over the ranks and the others averaged."""
    return _step(optimizer, mesh, seq_len, dt, variational, loss_fn, True)
