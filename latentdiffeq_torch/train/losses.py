"""ELBO losses (counterpart of latentdiffeq/train/losses.py).

Layout (batch, time, pixels):
  reconstruction = sum over pixels of mean over (batch, time) of sq. error
  KL             = per (z0, theta) group: sum over latent dims of the batch
                   mean; groups summed
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["kl", "vector_kl", "vector_mse", "reconstruction_loss",
           "loss_batch"]


def kl(mu, logvar):
    """Elementwise KL(N(mu, exp(logvar)) || N(0, 1)) (utils.jl:16)."""
    return (torch.exp(logvar) + mu ** 2 - logvar - 1) / 2


def _kl_group(mu, logvar, free_bits: float = 0.0, shards=None):
    per_dim = torch.mean(kl(mu, logvar), dim=0)
    if free_bits > 0.0:
        if shards is None:
            per_dim = torch.clamp(per_dim, min=free_bits)
        else:
            # the floor applies to the global batch's mean: this rank's
            # mean where the global one passes it, else the floor, so the
            # ranks' mean is the global term and its gradient clamp's
            glob = shards.sum(per_dim) / shards.world
            per_dim = torch.where(glob >= free_bits, per_dim,
                                  torch.full_like(per_dim, free_bits))
    return torch.sum(per_dim)


def vector_kl(mu, logvar, free_bits: float = 0.0, shards=None):
    """KL of a (batch, latent) tensor or a tuple of them; ``free_bits``
    floors each latent dim's batch-mean KL (0 = reference semantics).
    ``shards``: see ``loss_batch``."""
    if isinstance(mu, (tuple, list)):
        return sum(_kl_group(m, lv, free_bits, shards)
                   for m, lv in zip(mu, logvar))
    return _kl_group(mu, logvar, free_bits, shards)


def vector_mse(x, x_hat):
    """Sum over features of mean over (batch, time) squared error."""
    return torch.sum(torch.mean((x - x_hat) ** 2, dim=(0, 1)))


reconstruction_loss = vector_mse


def loss_batch(model, x, t, beta, *, variational: bool = True,
               generator: Optional[torch.Generator] = None, eps=None,
               mask_failures: bool = False, free_bits: float = 0.0,
               cur_len=None, anchor=None, anchor_weight: float = 0.0,
               anchor_frames=None, key=None, shards=None):
    """reconstruction + beta * KL (model_train.jl:225-238). Returns
    ``(loss, metrics)``.

    ``mask_failures``: samples whose solve failed are left out of the
    reconstruction term. ``cur_len``: only the first ``cur_len`` frames are
    real (masked curriculum). ``generator``/``eps``: the reparameterisation
    noise source and ``key`` the Brownian path of SDE dynamics (see
    LatentDiffEqModel.forward).

    ``anchor`` + ``anchor_weight`` (losses.py:81-104; for known observation
    models): ``anchor(x) -> (batch, time, z_dim)`` reads the latent chart
    off the observations frame by frame (the pendulum's pixel angle), and
    the loss gains ``anchor_weight`` times its squared error against the
    decoded latent trajectory, with the reconstruction term's frame and
    failure masking. ``anchor_frames``: anchor only the first k frames
    (normalised over those).

    ``shards`` (``parallel.BatchShards``): ``x`` is this rank's equal shard
    of a minibatch spread over ``shards.world`` ranks. The terms that
    couple the batch then use the global batch, the count of successful
    rows under ``mask_failures`` and the batch-mean KL under ``free_bits``,
    so that the mean over the ranks of the loss (and of its gradient) is
    the global batch's, as JAX's GSPMD step computes it."""
    (x_hat, z_hat, l_hat), mu, logvar, aux = model(
        x, t, variational=variational, generator=generator, eps=eps,
        cur_len=cur_len, key=key)
    se = (x - x_hat) ** 2
    if cur_len is not None:
        tmask = torch.arange(x.shape[1], device=x.device) < cur_len
        se = torch.where(tmask[None, :, None], se, torch.zeros_like(se))
        n_frames = cur_len
    else:
        n_frames = x.shape[1]
    if mask_failures:
        ok = aux["success"]
        se = torch.where(ok[:, None, None], se, torch.zeros_like(se))
        n_ok = ok.sum() if shards is None else shards.sum(ok.sum())
        denom = torch.clamp(n_ok, min=1)
        if shards is not None:
            # each rank's share of the global term: the ranks' mean is it
            denom = denom / shards.world
        rec = torch.sum(torch.sum(se, dim=(0, 1)) / (denom * n_frames))
    elif cur_len is not None:
        rec = torch.sum(torch.sum(se, dim=(0, 1)) / (x.shape[0] * n_frames))
    else:
        rec = reconstruction_loss(x, x_hat)
    kld = vector_kl(mu, logvar, free_bits, shards)
    loss = rec + beta * kld
    metrics = {"loss": loss, "rec": rec, "kl": kld,
               "n_failed": torch.sum(~aux["success"]),
               "n_rhs_evals": aux["stats"]["n_rhs_evals"]}
    if anchor is not None and anchor_weight:
        a_se = (anchor(x) - z_hat) ** 2                 # (b, time, z_dim)
        a_frames = n_frames
        zero = torch.zeros_like(a_se)
        if anchor_frames is not None:
            amask = torch.arange(x.shape[1], device=x.device) < anchor_frames
            a_se = torch.where(amask[None, :, None], a_se, zero)
            a_frames = min(anchor_frames, n_frames)
        if cur_len is not None:
            a_se = torch.where(tmask[None, :, None], a_se, zero)
        if mask_failures:
            a_se = torch.where(aux["success"][:, None, None], a_se, zero)
            anc = torch.sum(torch.sum(a_se, dim=(0, 1)) / (denom * a_frames))
        else:
            anc = torch.sum(torch.sum(a_se, dim=(0, 1))
                            / (x.shape[0] * a_frames))
        loss = loss + anchor_weight * anc
        metrics["anchor"] = anc
        metrics["loss"] = loss
    return loss, metrics
