"""Adaptive ODE solving: PI-controlled embedded RK pairs with dense
``saveat`` output (counterpart of latentdiffeq/solve/adaptive.py).

Unlike the JAX function, which solves one trajectory and is vmapped, this
one steps a whole batch at once: ``u0`` (..., dim) gives ``ys``
(..., T, dim). Every row keeps its own ``t``, ``dt``, ``facold``,
``last_rejected``, ``done``, ``fail`` and counters; a row that is done or
has failed takes masked no-op steps, exactly like the JAX ``scan`` body.
The loop is a Python loop of at most the step budget and stops once every
row is done or has failed; the masked steps it skips change nothing, so
the results equal the JAX solve's for both values of ``early_exit``. Where
that flag cannot steer Python (under ``torch.func.vmap``, or while a CUDA
graph is being captured) the loop runs its whole budget, as JAX's bounded
scan does, with the same results: a masked step changes no row's state,
and its gradient contributions are zeros (a row that is done steps by at
most ``1e-6 * span``, one that has failed by less than ``dtmin``, from
its last accepted state), so the gradients equal the early-exiting loop's
too (tests/test_torch_full_budget.py).

The RHS is called as ``f(y, p, t)`` with ``y`` (N, dim) and ``t`` (N, 1),
one time per row. The PI step-size controller follows Hairer, Nørsett &
Wanner (DOPRI5.f).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .rk import AbstractSolver, interpolate_dense, rk_step

__all__ = ["solve_adaptive", "AdaptiveConfig"]


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Adaptive-solve configuration, the fields and defaults of
    latentdiffeq/solve/adaptive.py:36-74. ``max_steps`` bounds the step
    attempts of a row; with ``early_exit`` the budget rounds up to a
    multiple of ``chunk_size``, as the JAX chunked loop does."""
    rtol: float = 1e-3          # OrdinaryDiffEq defaults (reltol=1e-3,
    atol: float = 1e-6          # abstol=1e-6), which the reference inherits.
    max_steps: int = 256
    safety: float = 0.9
    max_growth: float = 10.0
    min_shrink: float = 0.2
    beta: Optional[float] = None    # PI coefficient; default 0.2/order
    dt0: Optional[float] = None     # initial dt; default: Hairer's hinit
    dtmin_frac: float = 1e-7        # dtmin = dtmin_frac * span
    force_dtmin_fail: bool = True
    # clamp steps so they land exactly on each save point (DiffEq's tstops)
    step_to_saveat: bool = False
    early_exit: bool = False
    chunk_size: int = 32


def _err_norm(err, y0, y1, rtol, atol):
    """RMS of the scaled error of each row (the mean is over the last
    axis, as under the JAX vmap)."""
    sc = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = err / sc
    return torch.sqrt(torch.mean(r * r, dim=-1))


def _rms(x):
    return torch.sqrt(torch.mean(x * x, dim=-1))


def _hairer_hinit(f, y0, p, t0, f0, span, order, rtol, atol):
    """Hairer's automatic initial step size (HINIT in DOPRI5.f), per row:
    y0, f0 (N, dim), t0 (N,); returns (N,)."""
    sc = atol + rtol * torch.abs(y0)
    d0 = _rms(y0 / sc)
    d1 = _rms(f0 / sc)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    h0 = torch.minimum(h0, span)
    y1 = y0 + h0[:, None] * f0
    f1 = f(y1, p, (t0 + h0)[:, None])
    d2 = _rms((f1 - f0) / sc) / h0
    m = torch.maximum(d1, d2)
    h1 = torch.where(m <= 1e-15,
                     torch.maximum(torch.full_like(h0, 1e-6), h0 * 1e-3),
                     (0.01 / m) ** (1.0 / order))
    return torch.minimum(torch.minimum(100.0 * h0, h1), span)


def _stream_capturing(t) -> bool:
    """Whether ``t`` lies on a CUDA device whose current stream is being
    captured into a CUDA graph (train/trainer.py's epochs)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def all_inactive(active) -> bool:
    """True when no row of ``active`` is left, so a masked step loop may
    stop early. Under ``torch.func.vmap`` (a population of replicas,
    train/multiseed.py) the flags are batched and cannot steer Python
    control flow, and while a CUDA graph is captured reading them would
    sync with the host (a graph replays without Python); the loop then runs
    its whole budget of masked no-op steps, as the JAX package's bounded
    scan always does."""
    if torch._C._functorch.is_batchedtensor(active):
        return False
    if _stream_capturing(active):
        return False
    return not bool(active.any())


def solve_adaptive(f: Callable, solver: AbstractSolver, u0, p, saveat,
                   cfg: AdaptiveConfig = AdaptiveConfig()):
    """Integrate over ``[saveat[0], saveat[-1]]`` adaptively and emit
    ``saveat`` (T,) by dense output. ``u0`` (..., dim); ``p`` is handed to
    ``f`` as it is (batched like ``u0``, or shared).

    Returns ``(ys (..., T, dim), success (...,), stats)``, ``stats`` the
    per-row int32 counters ``n_rhs_evals``, ``n_accepted``, ``n_rejected``.
    Gradients flow through the accepted stage values; the step-size
    controller is detached, as the JAX code's ``stop_gradient``."""
    tab = solver.tableau
    if tab.b_err is None:
        raise ValueError(f"{solver} has no embedded error estimate; "
                         "use solve_fixed_grid instead.")
    if not tab.fsal:
        raise NotImplementedError("adaptive stepping currently assumes FSAL")

    batch_shape = u0.shape[:-1]
    y = u0.reshape(-1, u0.shape[-1])
    N, dev, dtype = y.shape[0], y.device, y.dtype
    saveat = saveat.to(device=dev, dtype=dtype)
    t0, t_end = saveat[0], saveat[-1]
    span = t_end - t0
    order = tab.order
    beta = cfg.beta if cfg.beta is not None else 0.2 / order
    expo1 = 1.0 / order - 0.75 * beta
    dtmin = cfg.dtmin_frac * span
    tiny = 1e-6 * span

    t = t0.expand(N).clone()
    f0 = f(y, p, t[:, None])
    n_hinit = 0
    if cfg.dt0 is None:
        dt_cur = _hairer_hinit(f, y, p, t, f0, span, order, cfg.rtol,
                               cfg.atol).detach()
        n_hinit = 1
    else:
        dt_cur = torch.full((N,), cfg.dt0, dtype=dtype, device=dev)

    T = saveat.shape[0]
    ys = torch.where((saveat <= t0 + tiny)[None, :, None], y[:, None, :],
                     torch.full((N, T, y.shape[-1]), float("nan"),
                                dtype=dtype, device=dev))
    facold = torch.full((N,), 1e-4, dtype=dtype, device=dev)
    last_rejected = torch.zeros(N, dtype=torch.bool, device=dev)
    done = torch.zeros(N, dtype=torch.bool, device=dev)
    fail = torch.zeros(N, dtype=torch.bool, device=dev)
    n_acc = torch.zeros(N, dtype=torch.int32, device=dev)
    n_rej = torch.zeros(N, dtype=torch.int32, device=dev)
    n_stage_evals = len(tab.b) - 1  # FSAL: k1 carried over
    budget = cfg.max_steps
    if cfg.early_exit:
        budget = -(-cfg.max_steps // cfg.chunk_size) * cfg.chunk_size

    for _ in range(budget):
        active = ~(done | fail)
        if all_inactive(active):
            break   # every later step would be a masked no-op
        dt = torch.minimum(dt_cur, t_end - t)
        if cfg.step_to_saveat:
            # distance to the next save point strictly ahead of t
            ahead = torch.where(saveat[None, :] > (t + tiny)[:, None],
                                saveat[None, :] - t[:, None],
                                torch.full((N, T), float("inf"),
                                           dtype=dtype, device=dev))
            dt = torch.minimum(dt, ahead.min(dim=1).values)
        dt = torch.clamp(dt, min=0.0)

        y1, err, ks = rk_step(f, tab, y, p, t[:, None], dt[:, None],
                              f0=f0, with_error=True)
        en = _err_norm(err.detach(), y.detach(), y1.detach(), cfg.rtol,
                       cfg.atol)
        finite = torch.isfinite(y1).all(dim=-1) & torch.isfinite(en)
        accept = (en <= 1.0) & finite

        # PI controller (Hairer DOPRI5)
        en_safe = torch.clamp(en, min=1e-10)
        fac11 = en_safe ** expo1
        fac = fac11 / (facold ** beta)
        fac = torch.clamp(fac / cfg.safety, 1.0 / cfg.max_growth,
                          1.0 / cfg.min_shrink)
        dt_acc = dt / fac
        if cfg.step_to_saveat:
            # a step truncated onto a save point keeps the working h
            dt_acc = torch.where(dt < dt_cur - tiny,
                                 torch.maximum(dt_acc, dt_cur), dt_acc)
        dt_acc = torch.where(last_rejected, torch.minimum(dt_acc, dt),
                             dt_acc)
        dt_rej = dt / torch.clamp(fac11 / cfg.safety,
                                  max=1.0 / cfg.min_shrink)
        dt_rej = torch.where(torch.isfinite(dt_rej), dt_rej,
                             dt * cfg.min_shrink)
        dt_next = torch.where(accept, dt_acc, dt_rej)

        step_ok = accept & active
        t_new = t + dt
        at_end = t_new >= t_end - tiny

        # dense output over the whole saveat grid
        mask = (saveat[None, :] > t[:, None]) & (
            (saveat[None, :] <= (t_new + tiny)[:, None]) | at_end[:, None])
        dt_div = torch.clamp(dt, min=tiny)
        theta = torch.clamp((saveat[None, :] - t[:, None])
                            / dt_div[:, None], 0.0, 1.0)
        yint = interpolate_dense(tab, y[:, None], y1[:, None],
                                 [k[:, None] for k in ks],
                                 dt[:, None, None], theta)
        ys = torch.where((mask & step_ok[:, None])[..., None], yint, ys)

        rejected = active & ~accept
        too_small = dt_next < dtmin
        fail = (fail | (rejected & too_small if cfg.force_dtmin_fail
                        else torch.zeros_like(fail))
                | (active & ~finite & too_small))
        done = done | (step_ok & at_end)
        t = torch.where(step_ok, t_new, t)
        y = torch.where(step_ok[:, None], y1, y)
        f0 = torch.where(step_ok[:, None], ks[-1], f0)
        dt_cur = torch.where(active, dt_next, dt_cur)
        facold = torch.where(step_ok, torch.clamp(en, min=1e-4), facold)
        last_rejected = torch.where(active, ~accept, last_rejected)
        n_acc = n_acc + step_ok.to(torch.int32)
        n_rej = n_rej + rejected.to(torch.int32)

    fail = fail | ~done
    success = ~fail & torch.isfinite(ys).all(dim=-1).all(dim=-1)
    attempts = n_acc + n_rej
    stats = {"n_rhs_evals": 1 + n_hinit + attempts * n_stage_evals,
             "n_accepted": n_acc, "n_rejected": n_rej}
    out = ys.reshape(batch_shape + ys.shape[1:])
    return (out, success.reshape(batch_shape),
            {k: v.reshape(batch_shape) for k, v in stats.items()})
