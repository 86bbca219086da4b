"""Latent-regression warm start (counterpart of
latentdiffeq/train/warm_start.py): pull a model's deterministic encode ->
latent_out path onto caller-supplied targets before ELBO training.

When the latent chart is an assignment problem (which latent slot carries
which state), gradient descent from a random init can settle in a mixed
basin the ELBO never leaves; inverting a known observation model gives
unsupervised latent estimates (the pendulum's pixel readout,
pixel_observable.py), and regressing the encoder onto them starts training
in the aligned basin. The targets are domain code, so the caller supplies
``loss_fn`` over the latent_out output.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import optim

__all__ = ["latent_warm_start"]


def latent_warm_start(model, x, loss_fn: Callable, *, steps: int = 500,
                      lr: float = 1e-3, optimizer=None,
                      with_moments: bool = False):
    """Regress the deterministic encode -> latent_out path onto targets
    (warm_start.py:41-95): ``steps`` full-batch Adam steps (Flux ADAM, no
    decay) on ``loss_fn(l_hat)``, ``l_hat = apply_latent_out(decoder,
    encoder(x).mu)``, or ``loss_fn(l_hat, mu, logvar)`` with
    ``with_moments`` (to calm fresh logvar heads as well). Only the encoder
    and the latent_out heads get gradients.

    ``model``: a module, updated in place, or a ``StackedModels``
    population (train/multiseed.py), whose stacked parameters are updated
    in place by one vmapped regression of every replica from its own
    weights. ``optimizer``: a ``train.optim`` optimizer over those
    parameters (default ``adam(lr)``). Returns ``(model, losses)``, the
    loss before each step: (steps,), or (steps, S) for a population."""
    from .multiseed import StackedModels

    stacked = isinstance(model, StackedModels)
    params = (list(model.params.values()) if stacked
              else list(model.parameters()))
    opt = optim.adam(params, lr) if optimizer is None else optimizer

    def objective(m):
        if stacked:
            l_hat, mu, logvar = m.latent(x)
        else:
            mu, logvar = m.encoder(x)
            l_hat = m.model_type.apply_latent_out(m.decoder, mu)
        return loss_fn(l_hat, mu, logvar) if with_moments else loss_fn(l_hat)

    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = model.map(objective) if stacked else objective(model)
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    return model, torch.stack(losses)
