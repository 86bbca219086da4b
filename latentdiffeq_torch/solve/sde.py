"""SDE solvers: Euler-Maruyama, stochastic Heun, SRA1 and SRIW1 (strong
order 1.5), on a fixed grid and with adaptive dyadic stepping (counterpart
of latentdiffeq/solve/sde.py).

Every solver consumes the virtual-Brownian-tree path of
``solve/brownian.py``: the path is a fixed function of the key, so a
power-of-two ``substeps`` refinement or an adaptive step sequence samples
the same path. Gradients are pathwise, by autograd through the increments
and the steps.

SRA1 (Rossler 2010, Sec. 6, additive noise), with chi = I(1,0)/h:

    f1 = f(y, t)
    H2 = y + (3/4) h f1 + (3/2) chi g(t+h)
    f2 = f(H2, t + (3/4) h)
    y1 = y + h (f1 + 2 f2)/3 + dW g(t+h) + chi (g(t) - g(t+h))

with the embedded drift error ``(2h/3)(f2 - f1)`` (Ralston against Euler).
SRIW1 (Sec. 5.1, diagonal noise, alias ``SOSRI``) adds the iterated
integrals I(1,1) = (dW^2 - h)/2 and I(1,1,1) = (dW^3 - 3 h dW)/6 and its
error adds the order-1.5 noise corrections.

Unlike the JAX functions, which solve one trajectory and are vmapped, these
step a batch of rows at once: ``u0`` (..., dim) with one key (..., 2) a row;
``p`` is handed to ``f`` and ``g`` as it is (batched like ``u0``, or
shared). On the fixed grid ``f``/``g`` get one time for all rows; in the
adaptive solve ``t`` is (N, 1), one time a row.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .adaptive import all_inactive
from .brownian import bridge_increments, vbt_query
from .fixed import _maybe_checkpoint

__all__ = ["EulerMaruyama", "StochasticHeun", "SRA1", "SRIW1", "SOSRI",
           "solve_sde_fixed_grid", "solve_sde_adaptive",
           "SDEAdaptiveConfig", "AbstractSDESolver"]


@dataclasses.dataclass(frozen=True)
class AbstractSDESolver:
    pass


@dataclasses.dataclass(frozen=True)
class EulerMaruyama(AbstractSDESolver):
    """y1 = y + f dt + g dW. Strong order 0.5 (1.0 for additive noise)."""


@dataclasses.dataclass(frozen=True)
class StochasticHeun(AbstractSDESolver):
    """Drift-Heun with additive or diagonal noise: strong order 1.0."""


@dataclasses.dataclass(frozen=True)
class SRA1(AbstractSDESolver):
    """Rossler SRA1: strong order 1.5 for additive noise (g must not depend
    on y). The default for the stochastic pendulum."""


@dataclasses.dataclass(frozen=True)
class SRIW1(AbstractSDESolver):
    """Rossler SRIW1: strong order 1.5 for diagonal noise (g may depend on
    the state elementwise), the noise class of the reference's ``SOSRI()``;
    :data:`SOSRI` aliases it."""


SOSRI = SRIW1


def _em_step(f, g, y, p, t, dt, dw, i10):
    return y + dt * f(y, p, t) + g(y, p, t) * dw, None


def _heun_step(f, g, y, p, t, dt, dw, i10):
    gy = g(y, p, t)
    f1 = f(y, p, t)
    y_pred = y + dt * f1 + gy * dw
    f2 = f(y_pred, p, t + dt)
    g2 = g(y_pred, p, t + dt)
    return y + 0.5 * dt * (f1 + f2) + 0.5 * (gy + g2) * dw, None


def _sra1_step(f, g, y, p, t, dt, dw, i10):
    f1 = f(y, p, t)
    g_end = g(y, p, t + dt)
    g_start = g(y, p, t)
    chi = i10 / dt
    h2 = y + 0.75 * dt * f1 + 1.5 * chi * g_end
    f2 = f(h2, p, t + 0.75 * dt)
    y1 = (y + dt * (f1 + 2.0 * f2) / 3.0 + dw * g_end
          + chi * (g_start - g_end))
    err = (2.0 * dt / 3.0) * (f2 - f1)
    return y1, err


def _sriw1_step(f, g, y, p, t, dt, dw, i10):
    """One SRIW1 step (the tableau of latentdiffeq/solve/sde.py:128-179)."""
    sqh = torch.sqrt(dt)
    i11 = 0.5 * (dw * dw - dt)
    i111 = (dw * dw * dw - 3.0 * dt * dw) / 6.0
    chi = i10 / dt

    f1 = f(y, p, t)
    g1 = g(y, p, t)
    h0_2 = y + 0.75 * dt * f1 + 1.5 * chi * g1
    h1_2 = y + 0.25 * dt * f1 + 0.5 * sqh * g1
    f2 = f(h0_2, p, t + 0.75 * dt)
    g2 = g(h1_2, p, t + 0.25 * dt)
    h1_3 = y + dt * f1 - sqh * g1
    g3 = g(h1_3, p, t + dt)
    h1_4 = y + 0.25 * dt * f1 + sqh * (-5.0 * g1 + 3.0 * g2 + 0.5 * g3)
    g4 = g(h1_4, p, t + 0.25 * dt)

    b1 = -g1 + (4.0 / 3.0) * g2 + (2.0 / 3.0) * g3
    b2 = -g1 + (4.0 / 3.0) * g2 - (1.0 / 3.0) * g3
    e3 = 2.0 * g1 - (4.0 / 3.0) * g2 - (2.0 / 3.0) * g3
    e4 = -2.0 * g1 + (5.0 / 3.0) * g2 - (2.0 / 3.0) * g3 + g4

    noise15 = e3 * chi + e4 * (i111 / dt)
    y1 = (y + dt * (f1 + 2.0 * f2) / 3.0
          + b1 * dw + b2 * (i11 / sqh) + noise15)
    err = (2.0 * dt / 3.0) * (f2 - f1) + noise15
    return y1, err


_STEPPERS = {
    EulerMaruyama: (_em_step, 1),
    StochasticHeun: (_heun_step, 2),
    SRA1: (_sra1_step, 2),
    SRIW1: (_sriw1_step, 2),
}

# the solvers whose stepper returns an embedded error estimate
_EMBEDDED = (SRA1, SRIW1)


def _stepper(solver):
    for cls, entry in _STEPPERS.items():
        if isinstance(solver, cls):
            return entry
    raise ValueError(f"unknown SDE solver {solver}")


def _counts(batch_shape, value, device):
    return torch.full(tuple(batch_shape), value, dtype=torch.int32,
                      device=device)


def solve_sde_fixed_grid(f: Callable, g: Callable,
                         solver: AbstractSDESolver, u0, p, saveat, key, *,
                         substeps: int = 1, checkpoint: bool = False):
    """Integrate across ``saveat`` (T,) with ``substeps`` (a power of two)
    method steps per save interval. ``u0`` (..., dim), ``key`` (..., 2).
    Returns ``(ys (..., T, dim), success (...,), stats)``, the counters per
    row. ``checkpoint=True`` runs each interval under
    ``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``): the backward
    recomputes its steps, with the same values."""
    step, evals_per = _stepper(solver)
    saveat = torch.as_tensor(saveat, dtype=u0.dtype, device=u0.device)
    n = saveat.shape[0] - 1
    dts = (saveat[1:] - saveat[:-1]) / substeps
    dws, i10s = bridge_increments(key, saveat, substeps, u0.shape[-1:],
                                  u0.dtype)          # (..., n, substeps, dim)

    def interval(y, p, ta, dt, dw, i10):
        for j in range(substeps):
            y, _ = step(f, g, y, p, ta + j * dt, dt, dw[..., j, :],
                        i10[..., j, :])
        return y

    interval = _maybe_checkpoint(interval, checkpoint)
    y, ys = u0, [u0]
    for a in range(n):
        y = interval(y, p, saveat[a], dts[a], dws[..., a, :, :],
                     i10s[..., a, :, :])
        ys.append(y)
    ys = torch.stack(ys, dim=-2)
    batch = u0.shape[:-1]
    success = torch.isfinite(ys).flatten(len(batch)).all(dim=-1)
    stats = {"n_rhs_evals": _counts(batch, n * substeps * evals_per,
                                    u0.device),
             "n_accepted": _counts(batch, n * substeps, u0.device),
             "n_rejected": _counts(batch, 0, u0.device)}
    return ys, success, stats


@dataclasses.dataclass(frozen=True)
class SDEAdaptiveConfig:
    """Adaptive SDE configuration, the fields and defaults of
    latentdiffeq/solve/sde.py:249-276."""
    # StochasticDiffEq's SDE defaults, the tolerances the reference's
    # SOSRI() runs at; a much tighter atol drives training trajectories
    # deep into refinement
    rtol: float = 1e-2
    atol: float = 1e-2
    max_steps: int = 1024
    # dyadic refinement bounds: step = interval / 2^k, k in [0, depth_cap]
    depth_cap: int = 10
    # coarsen (double the step) when the error norm falls below this on an
    # even cell boundary; err ~ h^2, so 0.2 leaves a 4x margin after doubling
    coarsen_below: float = 0.2
    # > 0: the step budget is at most max_steps_per_interval * n_intervals
    max_steps_per_interval: int = 0
    # run the loop in chunks of chunk_size while any row is active (the
    # budget rounds up to whole chunks); forward/inference only in JAX
    early_exit: bool = False
    chunk_size: int = 32


def solve_sde_adaptive(f: Callable, g: Callable, solver: AbstractSDESolver,
                       u0, p, saveat, key,
                       cfg: SDEAdaptiveConfig = SDEAdaptiveConfig()):
    """Adaptive SDE integration by dyadic step bisection per save interval:
    a row steps by ``interval / 2^k``, halving on rejection (up to
    ``depth_cap``) and doubling when comfortably inside tolerance. Every
    step is a cell of the virtual Brownian tree, so a rejection never
    perturbs the path.

    ``u0`` (..., dim), ``key`` (..., 2). Returns ``(ys (..., T, dim),
    success (...,), stats)``, stats per row: ``n_rhs_evals``,
    ``n_accepted``, ``n_rejected``, ``max_depth``. Failed rows keep NaN at
    the save points they did not reach.

    Each row has its own interval index ``i``, cell ``m``, depth ``k``,
    state and counters; a row that is done or has failed takes masked
    no-op steps, as in the JAX scan, so the loop stops once every row has
    (the steps skipped change nothing). Under ``torch.func.vmap`` or while
    a CUDA graph is captured it runs its whole budget instead
    (``adaptive.all_inactive``), with the same results and gradients. The
    error norm is taken on detached values (JAX's ``stop_gradient``);
    gradients flow through the accepted steps. Only SRA1 and SRIW1/SOSRI
    carry an embedded error estimate."""
    step, evals_per = _stepper(solver)
    if not isinstance(solver, _EMBEDDED):
        raise ValueError("adaptive SDE stepping requires an embedded error "
                         "estimate; use SRA1 or SRIW1/SOSRI "
                         "(or solve_sde_fixed_grid)")
    batch = u0.shape[:-1]
    dim = u0.shape[-1]
    y = u0.reshape(-1, dim)
    keys = key.reshape(-1, 2)
    N, dev, dtype = y.shape[0], y.device, y.dtype
    saveat = torch.as_tensor(saveat, device=dev).to(dtype)
    T = saveat.shape[0]
    n_int = T - 1

    def ints(v):
        return torch.full((N,), v, dtype=torch.int64, device=dev)

    ys = torch.cat([y[:, None, :],
                    torch.full((N, T - 1, dim), float("nan"), dtype=dtype,
                               device=dev)], dim=1)
    i, m, k, k_max = ints(0), ints(0), ints(0), ints(0)
    n_acc, n_rej = ints(0), ints(0)
    done = torch.full((N,), n_int == 0, dtype=torch.bool, device=dev)
    fail = torch.zeros(N, dtype=torch.bool, device=dev)
    slots = torch.arange(T, device=dev)

    budget = cfg.max_steps
    if cfg.max_steps_per_interval > 0:
        budget = min(budget, cfg.max_steps_per_interval * max(n_int, 1))
    if cfg.early_exit:
        budget = -(-budget // cfg.chunk_size) * cfg.chunk_size

    for _ in range(budget):
        active = ~(done | fail)
        if all_inactive(active):
            break   # every later step would be a masked no-op
        ic = torch.clamp(i, max=n_int - 1)
        h_i = saveat[ic + 1] - saveat[ic]
        pow_k = 1 << k
        hstep = h_i / pow_k.to(dtype)
        t = saveat[ic] + m.to(dtype) * hstep

        dw, i10 = vbt_query(keys, ic, h_i, k, m, (dim,), cfg.depth_cap,
                            dtype)
        y1, err = step(f, g, y, p, t[:, None], hstep[:, None], dw, i10)

        yd, y1d = y.detach(), y1.detach()
        sc = cfg.atol + cfg.rtol * torch.maximum(torch.abs(yd),
                                                 torch.abs(y1d))
        r = err.detach() / sc
        en = torch.sqrt(torch.mean(r * r, dim=-1))
        finite = torch.isfinite(y1d).all(dim=-1) & torch.isfinite(en)
        accept = (en <= 1.0) & finite

        step_ok = accept & active
        reject = active & ~accept
        m_next = m + 1
        crossed = step_ok & (m_next >= pow_k)
        i_new = torch.where(crossed, i + 1, i)
        m_next = torch.where(crossed, 0, torch.where(step_ok, m_next, m))
        # coarsen: comfortably inside tolerance, on an even cell boundary
        can_coarsen = (k > 0) & (en <= cfg.coarsen_below) & (m_next % 2 == 0)
        k_acc = torch.where(can_coarsen, k - 1, k)
        m_acc = torch.where(can_coarsen, m_next // 2, m_next)
        # refine on reject: the same position at half the step
        at_cap = k >= cfg.depth_cap
        k_rej = torch.clamp(k + 1, max=cfg.depth_cap)

        slot = torch.clamp(ic + 1, max=n_int)
        put = crossed[:, None] & (slots == slot[:, None])
        ys = torch.where(put[:, :, None], y1[:, None, :], ys)
        y = torch.where(step_ok[:, None], y1, y)
        k_max = torch.where(active, torch.maximum(k_max, k), k_max)
        i = torch.where(step_ok, i_new, i)
        m = torch.where(step_ok, m_acc, torch.where(reject, m * 2, m))
        k = torch.where(step_ok, k_acc, torch.where(reject, k_rej, k))
        done = done | (crossed & (i_new >= n_int))
        fail = fail | (reject & at_cap)
        n_acc = n_acc + step_ok.to(torch.int64)
        n_rej = n_rej + reject.to(torch.int64)

    fail = fail | ~done
    success = ~fail & torch.isfinite(ys).flatten(1).all(dim=-1)
    attempts = n_acc + n_rej
    stats = {"n_rhs_evals": attempts * evals_per, "n_accepted": n_acc,
             "n_rejected": n_rej, "max_depth": k_max}
    stats = {name: v.to(torch.int32).reshape(batch)
             for name, v in stats.items()}
    return (ys.reshape(batch + (T, dim)), success.reshape(batch), stats)
