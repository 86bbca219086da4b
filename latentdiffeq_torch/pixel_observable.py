"""The pendulum's pixel-angle observable (the port's copy of
examples/pendulum/pixel_observable.py): domain code for unsupervised model
selection and warm starts.

The rendered pendulum's angle can be read off each frame by inverting the
renderer's geometry (pendulum_data.py: pivot at canvas (0, -8.5), y down,
bob along (cos(pi/2 + theta), sin(pi/2 + theta))), so the correlation of a
model's latent angle with the pixel-read angle needs the observations
only. Selecting a population's winner by it (``MultiSeedTrainer.select``
with ``population_pixel_scores``) is the recipe behind the JAX package's
quality records (train_goku.py ``--select-by pixel``).

The functions take tensors (or arrays) and compute in float64 on the
tensors' device; the score vectors come back as numpy arrays, medians
taken as numpy takes them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import random as jr
from .models.dynamics import SDEDynamics

__all__ = ["pearson_rows", "pixel_angles", "pendulum_pixel_estimates",
           "warm_start_pendulum", "pixel_angle_corr", "pixel_forecast_corr",
           "population_pixel_scores", "population_pixel_forecast_scores",
           "population_pixel_composite_scores", "composite_scores"]


def _f64(a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.detach().to(torch.float64)


def pearson_rows(a, b) -> torch.Tensor:
    """Row-wise Pearson correlation of two (n, T) tensors."""
    a, b = _f64(a), _f64(b)
    a = a - a.mean(dim=1, keepdim=True)
    b = b - b.mean(dim=1, keepdim=True)
    denom = torch.sqrt((a * a).sum(dim=1) * (b * b).sum(dim=1)) + 1e-12
    return (a * b).sum(dim=1) / denom


def _unwrap(p) -> torch.Tensor:
    """``np.unwrap(p, axis=1)``: remove 2 pi jumps along time."""
    dd = p[:, 1:] - p[:, :-1]
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0),
                        torch.full_like(ddmod, math.pi), ddmod)
    corr = torch.where(dd.abs() < math.pi, torch.zeros_like(dd),
                       ddmod - dd)
    return torch.cat([p[:, :1], p[:, 1:] + torch.cumsum(corr, dim=1)], dim=1)


def _gradient(f, dt: float) -> torch.Tensor:
    """``np.gradient(f, dt, axis=1)``: central differences inside,
    one-sided at the ends."""
    mid = (f[:, 2:] - f[:, :-2]) / (2.0 * dt)
    first = (f[:, 1:2] - f[:, :1]) / dt
    last = (f[:, -1:] - f[:, -2:-1]) / dt
    return torch.cat([first, mid, last], dim=1)


def pixel_angles(val_set, h: int = 28, w: int = 28) -> torch.Tensor:
    """(n, T) pendulum angle read from the frames: the intensity-weighted
    centroid of the mass far from the pivot (rod and bob) points along the
    rod; unwrapped along time (pixel_observable.py:40)."""
    x = _f64(val_set)
    x = x.reshape(x.shape[0], x.shape[1], h, w)
    ys = torch.arange(h, dtype=torch.float64, device=x.device) - (h - 1) / 2
    xs = torch.arange(w, dtype=torch.float64, device=x.device) - (w - 1) / 2
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    dx, dy = px - 0.0, py - (-8.5)
    dist = torch.hypot(dx, dy)
    wgt = x * torch.clamp(dist - 3.0, min=0.0)
    sx = (wgt * dx).sum(dim=(-2, -1))
    sy = (wgt * dy).sum(dim=(-2, -1))
    return _unwrap(torch.atan2(sy, sx) - math.pi / 2)


def pendulum_pixel_estimates(x, dt: float, h: int = 28, w: int = 28,
                             G: float = 10.0):
    """Unsupervised per-trajectory latent estimates from the pixels
    (pixel_observable.py:64): the angle from ``pixel_angles``, the angular
    velocity by finite differences, and L from the pendulum residual
    theta'' = -(G/L) sin(theta) by least squares (clipped to [0.25, 4];
    1.5 where the slope is unphysical). Returns ``(th (n, T), om (n, T),
    L (n,))`` in float32."""
    th = pixel_angles(x, h, w)
    om = _gradient(th, dt)
    acc = _gradient(om, dt)
    s, a = torch.sin(th[:, 2:-2]), acc[:, 2:-2]
    slope = (s * a).sum(dim=1) / torch.clamp((s * s).sum(dim=1), min=1e-9)
    L = torch.where(slope < -1e-3, -G / torch.clamp(slope, max=-1e-3),
                    torch.full_like(slope, 1.5))
    L = torch.clamp(L, 0.25, 4.0)
    return th.float(), om.float(), L.float()


def warm_start_pendulum(model, train_x, dt: float, *, window: int = 50,
                        offsets=(0, 25, 50), steps: int = 300,
                        lr: float = 1e-3, estimates=None,
                        logvar_target: float = -6.0,
                        logvar_weight: float = 0.1):
    """Warm-start a GOKU pendulum model from the pixel readout
    (pixel_observable.py:101): ``train.latent_warm_start`` onto (theta,
    omega) at each window start in ``offsets`` and the residual-estimated
    L, plus a pull of the logvar heads toward ``logvar_target``. ``model``
    a module or a ``StackedModels`` population (one vmapped regression).
    ``estimates``: ``pendulum_pixel_estimates(train_x, dt)``, if at hand.
    Returns ``(model, losses)``."""
    from .train.warm_start import latent_warm_start

    th, om, L = (estimates if estimates is not None
                 else pendulum_pixel_estimates(train_x, dt))
    x = torch.as_tensor(train_x, dtype=torch.float32)
    dev = (next(iter(model.params.values())).device
           if hasattr(model, "params") else next(model.parameters()).device)
    xb = torch.cat([x[:, s:s + window] for s in offsets]).to(dev)
    z0t = torch.cat([torch.stack([th[:, s], om[:, s]], dim=1)
                     for s in offsets]).to(dev)
    Lt = L.repeat(len(offsets)).to(dev)

    def loss_fn(l_hat, mu, logvar):
        # in float32 whatever the model's dtype (pixel_observable.py:129-131)
        z0_hat, th_hat = l_hat
        l_z0 = torch.mean((z0_hat.float() - z0t) ** 2)
        l_L = torch.mean((th_hat[:, 0].float() - Lt) ** 2)
        l_lv = sum(torch.mean((lv.float() - logvar_target) ** 2)
                   for lv in logvar)
        return l_z0 + l_L + logvar_weight * l_lv

    return latent_warm_start(model, xb, loss_fn, steps=steps, lr=lr,
                             with_moments=True)


@torch.no_grad()
def _ztraj(model, x, T: int, dt: float):
    """The decoded latent trajectories of one model (a module): encode
    ``x``, decode over T frames (SDE dynamics on PRNGKey(0))."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    t = torch.arange(T, dtype=torch.float32, device=dev) * dt
    kw = ({"key": jr.PRNGKey(0, device=dev)}
          if isinstance(model.decoder.diffeq, SDEDynamics) else {})
    (_, z, _), _, _, _ = model(x, t, variational=False, **kw)
    return z


def _angle_score(z, th_obs) -> float:
    """Median |Pearson| of z[..., 0] with the pixel angle, the chart's sign
    from the median; -inf for a non-finite median."""
    r = pearson_rows(z[:, :, 0], _f64(th_obs).to(z.device)[:, :z.shape[1]])
    r = r.cpu().numpy()
    med = np.median(r)
    if not np.isfinite(med):
        return -np.inf
    sign = float(np.sign(med)) or 1.0
    return float(np.median(sign * r))


def _forecast_score(z, th_obs, ctx: int) -> float:
    """The sign gauge from the whole horizon, the score beyond ``ctx``."""
    T = z.shape[1]
    th = _f64(th_obs).to(z.device)
    med = np.median(pearson_rows(z[:, :, 0], th[:, :T]).cpu().numpy())
    if not np.isfinite(med):
        return -np.inf
    sign = float(np.sign(med)) or 1.0
    r = sign * pearson_rows(z[:, ctx:, 0], th[:, ctx:T]).cpu().numpy()
    out = float(np.median(r))
    return out if np.isfinite(out) else -np.inf


def pixel_angle_corr(model, val_set, th_obs, dt: float) -> float:
    """Median per-trajectory |Pearson| between the model's decoded latent
    angle and the pixel-read angle (pixel_observable.py:153)."""
    return _angle_score(_ztraj(model, val_set, val_set.shape[1], dt),
                        th_obs)


def pixel_forecast_corr(model, val_set, th_obs, dt: float,
                        ctx: int) -> float:
    """The same on the frames beyond an encoder context of ``ctx`` frames
    (pixel_observable.py:174)."""
    return _forecast_score(
        _ztraj(model, val_set[:, :ctx], val_set.shape[1], dt), th_obs, ctx)


def _pop_ztraj(stacked, x, T: int, dt: float):
    from .train.selectors import population_decode
    return population_decode(stacked, x, torch.arange(T) * dt, latent=True)


def population_pixel_scores(stacked, val_set, th_obs,
                            dt: float) -> np.ndarray:
    """(S,) ``pixel_angle_corr`` of every replica of a ``StackedModels``
    population in one vmapped forward (pixel_observable.py:283); a
    diverged replica scores -inf. A ``score_fn`` for
    ``MultiSeedTrainer.select``."""
    z = _pop_ztraj(stacked, val_set, val_set.shape[1], dt).double()
    return np.asarray([_angle_score(zs, th_obs) for zs in z])


def population_pixel_forecast_scores(stacked, val_set, th_obs, dt: float,
                                     ctx: int) -> np.ndarray:
    """(S,) ``pixel_forecast_corr`` of every replica
    (pixel_observable.py:228)."""
    z = _pop_ztraj(stacked, val_set[:, :ctx], val_set.shape[1], dt).double()
    return np.asarray([_forecast_score(zs, th_obs, ctx) for zs in z])


def population_pixel_composite_scores(stacked, val_set, th_obs, dt: float,
                                      ctx: int,
                                      incontext_bar: float = 0.95
                                      ) -> np.ndarray:
    """(S,) composite score (pixel_observable.py:241): the pixel forecast
    among replicas whose in-context pixel score clears ``incontext_bar``,
    the others below them."""
    in_ctx = population_pixel_scores(stacked, val_set, th_obs, dt)
    fc = population_pixel_forecast_scores(stacked, val_set, th_obs, dt, ctx)
    return composite_scores(in_ctx, fc, incontext_bar)


def composite_scores(in_ctx, fc, incontext_bar: float = 0.95) -> np.ndarray:
    """The composite law (pixel_observable.py:262): passers with a finite
    forecast score 1 + fc, the rest in_ctx - 1, non-finite in_ctx -inf."""
    in_ctx = np.asarray(in_ctx, np.float64)
    fc = np.asarray(fc, np.float64)
    out = np.where((in_ctx >= incontext_bar) & np.isfinite(fc),
                   1.0 + fc, in_ctx - 1.0)
    return np.where(np.isfinite(in_ctx), out, -np.inf)
