"""Domain-agnostic population selection scores (counterpart of
latentdiffeq/train/selectors.py), each a ``score_fn`` for
``MultiSeedTrainer.select``: observations only, no latent ground truth.

- ``temporal_agreement``: per trajectory, remove each observation channel's
  temporal mean from prediction and data, correlate what remains, take the
  median; a static or blurry prediction scores ~0 instead of winning on
  mean squared error.
- ``observation_forecast_scores``: that agreement on the frames beyond an
  encoder context of ``ctx`` frames.
- ``observation_composite_scores`` / ``combine_composite``: the forecast
  score among replicas whose in-context agreement clears a bar (by default
  within ``rel_margin`` of the best), the rest below them.
- ``observation_consensus_scores``: each replica's median agreement with
  the other replicas beyond the context.

The populations are ``StackedModels`` (train/multiseed.py): one vmapped
forward scores every replica. The scores are computed on the host in
float64, as the JAX package does.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .. import random as jr
from ..models.dynamics import SDEDynamics

__all__ = ["temporal_agreement", "observation_forecast_scores",
           "observation_composite_scores", "combine_composite",
           "observation_consensus_scores"]


def _host(a) -> np.ndarray:
    """Scores read in float64 (a bfloat16 model's outputs too)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def temporal_agreement(x_pred, x_true, start: int = 0) -> float:
    """Median per-trajectory Pearson correlation between temporally
    centred prediction and data over frames ``[start:]`` (selectors.py:60).
    ``x_pred, x_true``: (n, T, *obs) tensors or arrays. A trajectory with a
    non-finite prediction scores -inf."""
    p = _host(x_pred)[:, start:]
    q = _host(x_true)[:, start:]
    n = p.shape[0]
    p = p.reshape(n, p.shape[1], -1)
    q = q.reshape(n, q.shape[1], -1)
    finite = np.all(np.isfinite(p), axis=(1, 2))
    p = np.where(np.isfinite(p), p, 0.0)
    p = p - p.mean(axis=1, keepdims=True)
    q = q - q.mean(axis=1, keepdims=True)
    num = (p * q).sum(axis=(1, 2))
    den = np.sqrt((p * p).sum(axis=(1, 2)) * (q * q).sum(axis=(1, 2)))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.where(den > 0, num / den, 0.0)
    r = np.where(finite, r, -np.inf)
    med = np.median(r)
    return float(med) if np.isfinite(med) else -np.inf


@torch.no_grad()
def population_decode(stacked, x, t, key=None, *, latent: bool = False):
    """Every replica's deterministic decode of ``x`` over the grid ``t``
    in one vmapped forward: (S, n, T, *obs), or with ``latent`` the latent
    trajectories. SDE decoders all take ``key`` (default PRNGKey(0)), one
    common Brownian path."""
    dev = next(iter(stacked.params.values())).device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    t = torch.as_tensor(t, dtype=torch.float32).to(dev)
    kw = {}
    if isinstance(stacked.base.decoder.diffeq, SDEDynamics):
        kw["key"] = jr.PRNGKey(0, device=dev) if key is None else key

    def one(m):
        (x_hat, z, _), _, _, _ = m(x, t, variational=False, **kw)
        return z if latent else x_hat

    return stacked.map(one)


def _grid(n: int, dt: float):
    return torch.arange(n, dtype=torch.float32) * dt


def observation_forecast_scores(stacked, val_set, dt: float, ctx: int,
                                key=None) -> np.ndarray:
    """(S,) beyond-context temporal agreement (selectors.py:105): encode
    ``val_set[:, :ctx]``, predict the whole horizon, score frames
    ``[ctx:]``."""
    T = val_set.shape[1]
    xh = population_decode(stacked, val_set[:, :ctx], _grid(T, dt), key)
    return np.asarray([temporal_agreement(x, val_set, start=ctx)
                       for x in xh])


def observation_composite_scores(stacked, val_set, dt: float, ctx: int,
                                 incontext_bar: Union[float, str] = "rel",
                                 rel_margin: float = 0.02,
                                 key=None) -> np.ndarray:
    """(S,) composite score (selectors.py:120): the forecast agreement
    among replicas whose in-context (full encode, full horizon) agreement
    clears the bar, the others below them, non-finite ones -inf."""
    T = val_set.shape[1]
    xh = population_decode(stacked, val_set, _grid(T, dt), key)
    in_ctx = np.asarray([temporal_agreement(x, val_set) for x in xh])
    fc = observation_forecast_scores(stacked, val_set, dt, ctx, key)
    return combine_composite(in_ctx, fc, incontext_bar, rel_margin)


def combine_composite(in_ctx, fc, incontext_bar: Union[float, str] = "rel",
                      rel_margin: float = 0.02) -> np.ndarray:
    """The composite law (selectors.py:165): passers with a finite forecast
    score 1 + fc, everyone else in_ctx - 1, non-finite in_ctx -inf;
    ``incontext_bar="rel"`` is (max finite in_ctx) - rel_margin."""
    in_ctx = np.asarray(in_ctx, np.float64)
    fc = np.asarray(fc, np.float64)
    if incontext_bar == "rel":
        finite = in_ctx[np.isfinite(in_ctx)]
        bar = (float(finite.max()) - rel_margin) if finite.size else np.inf
    else:
        bar = float(incontext_bar)
    out = np.where((in_ctx >= bar) & np.isfinite(fc), 1.0 + fc,
                   in_ctx - 1.0)
    return np.where(np.isfinite(in_ctx), out, -np.inf)


def observation_consensus_scores(stacked, val_set, dt: float, ctx: int,
                                 key=None, condition_in_ctx: bool = False,
                                 incontext_bar: Union[float, str] = "rel",
                                 rel_margin: float = 0.02) -> np.ndarray:
    """(S,) cross-replica forecast consensus (selectors.py:184): each
    replica's median, over the other finite replicas, of the pairwise
    beyond-context agreement of their predictions; non-finite replicas
    -inf, a replica without partners 0. ``condition_in_ctx`` gates it by
    the in-context agreement with the data (``combine_composite``)."""
    T = val_set.shape[1]
    xh = _host(population_decode(stacked, val_set[:, :ctx], _grid(T, dt),
                                 key))
    S = xh.shape[0]
    finite = np.array([np.all(np.isfinite(x)) for x in xh])
    scores = np.full(S, -np.inf)
    for i in range(S):
        if not finite[i]:
            continue
        partners = [j for j in range(S) if j != i and finite[j]]
        if not partners:
            scores[i] = 0.0
            continue
        scores[i] = float(np.median([
            temporal_agreement(xh[i], xh[j], start=ctx) for j in partners]))
    if not condition_in_ctx:
        return scores
    xf = population_decode(stacked, val_set, _grid(T, dt), key)
    in_ctx = np.asarray([temporal_agreement(x, val_set) for x in xf])
    return combine_composite(in_ctx, scores, incontext_bar, rel_margin)
