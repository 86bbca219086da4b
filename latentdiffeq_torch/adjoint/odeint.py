"""ODE integration with a selectable gradient mode (counterpart of
latentdiffeq/adjoint/odeint.py).

``odeint`` takes batched ``u0`` (..., dim) directly (no vmap) and returns
``(ys (..., T, dim), success (...,), stats)``. ``p`` is handed to ``f`` as
it is: a tensor batched like ``u0`` (one parameter row per trajectory), a
tensor shared by every row, or an ``nn.Module`` (a neural vector field),
whose parameters get the gradient.

The two adjoints are ``torch.autograd.Function``s on the plain path. The
JAX package vmaps its per-trajectory adjoint; here the rows are solved
together, each with its own step control: the backward re-solves of
``InterpolatingAdjoint`` control their steps on each row's state, and
``BacksolveAdjoint`` integrates the augmented state (y, a, a_p) of each row
with that row's own parameter adjoint a_p (through ``torch.func`` when the
parameters are shared), so every row's error norms, and so its steps, are
the JAX solve's. The rows' parameter adjoints are summed at the end when
the parameters are shared.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..solve.adaptive import AdaptiveConfig, solve_adaptive
from ..solve.fixed import solve_fixed_grid
from ..solve.rk import AbstractSolver, rk_step
from .modes import (AbstractSensealg, BacksolveAdjoint, InterpolatingAdjoint,
                    Unrolled)

__all__ = ["SolveOptions", "odeint"]

_STATS = ("n_rhs_evals", "n_accepted", "n_rejected")


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Static solve configuration. ``unroll`` is a JAX scheduling knob
    with no effect on results; it is accepted and ignored here."""

    adaptive: bool = True
    substeps: int = 1
    adaptive_cfg: AdaptiveConfig = AdaptiveConfig()
    interp_stride: int = 1
    unroll: int = 1

    def replace(self, **kw) -> "SolveOptions":
        return dataclasses.replace(self, **kw)


def uses_fixed_grid(solver: AbstractSolver, options: SolveOptions) -> bool:
    """The JAX package solves on the fixed grid when asked to, or when the
    solver has no embedded error estimate (RK4, Midpoint, Euler)."""
    return not options.adaptive or not solver.is_adaptive_capable


def _forward(f, solver, u0, p, saveat, options: SolveOptions,
             checkpoint: bool = False):
    """odeint.py:51-62: with ``adaptive`` and an error estimate the
    adaptive solve; a solver without one the fixed grid (then without
    ``interp_stride``, as in JAX); else the fixed grid."""
    if options.adaptive:
        if not solver.is_adaptive_capable:
            return solve_fixed_grid(f, solver, u0, p, saveat,
                                    substeps=options.substeps,
                                    checkpoint=checkpoint)
        return solve_adaptive(f, solver, u0, p, saveat, options.adaptive_cfg)
    return solve_fixed_grid(f, solver, u0, p, saveat,
                            substeps=options.substeps, checkpoint=checkpoint,
                            interp_stride=options.interp_stride)


def _bwd_adaptive(solver, sensealg) -> bool:
    return bool(sensealg.adaptive) and solver.is_adaptive_capable


def _bwd_cfg(sensealg) -> AdaptiveConfig:
    return AdaptiveConfig(rtol=sensealg.bwd_rtol, atol=sensealg.bwd_atol,
                          max_steps=sensealg.bwd_max_steps)


def _nan_unless(ok, y):
    """Rows whose solve failed become NaN (odeint.py:103-105)."""
    return torch.where(ok[..., None], y, torch.full_like(y, float("nan")))


class _Bound:
    """A module called with other parameters (``torch.func``), for an ``f``
    that calls its ``p``."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def __call__(self, *args):
        return torch.func.functional_call(self.module, self.params, args)


class _Adjoint:
    """One adjoint solve: the forward, and its backward given the cotangent
    of ys. ``leaves`` are the tensors that get a gradient from ``p``: ``p``
    itself, or a module's parameters that require one."""

    def __init__(self, f, solver, options, sensealg, u0, p):
        self.f, self.solver = f, solver
        self.options, self.sensealg, self.p = options, sensealg, p
        self.batch = tuple(u0.shape[:-1])
        if isinstance(p, torch.nn.Module):
            named = [(n, q) for n, q in p.named_parameters()
                     if q.requires_grad]
            self.names = [n for n, _ in named]
            self.leaves = tuple(q for _, q in named)
            self.per_row = False
        elif isinstance(p, torch.Tensor):
            self.names, self.leaves = None, (p,)
            self.per_row = (p.dim() == len(self.batch) + 1
                            and tuple(p.shape[:-1]) == self.batch)
        elif p is None:
            self.names, self.leaves, self.per_row = None, (), False
        else:
            raise TypeError(f"odeint: p must be a tensor, an nn.Module or "
                            f"None for {type(sensealg).__name__}, got "
                            f"{type(p).__name__}")

    def _live(self):
        """(p to call f with, the tensors to differentiate)."""
        if isinstance(self.p, torch.Tensor):
            q = self.p.detach().requires_grad_()
            return q, (q,)
        return self.p, self.leaves

    # -- InterpolatingAdjoint ------------------------------------------------
    def _interval_map(self):
        f, solver, sa = self.f, self.solver, self.sensealg
        if _bwd_adaptive(solver, sa):
            cfg = _bwd_cfg(sa)

            def run(y, p, t_lo, t_hi):
                ys, ok, _ = solve_adaptive(f, solver, y, p,
                                           torch.stack([t_lo, t_hi]), cfg)
                return _nan_unless(ok, ys[..., -1, :])
            return run
        tab, substeps = solver.tableau, sa.bwd_substeps

        def run(y, p, t_lo, t_hi):
            dt = (t_hi - t_lo) / substeps
            for j in range(substeps):
                y, _, _ = rk_step(f, tab, y, p, t_lo + j * dt, dt,
                                  with_error=False)
            return y
        return run

    def _interpolating_backward(self, ys, saveat, g):
        run = self._interval_map()
        a = g[..., -1, :]
        dleaves = [torch.zeros_like(q) for q in self.leaves]
        for n in range(saveat.shape[0] - 2, -1, -1):
            with torch.enable_grad():
                y_lo = ys[..., n, :].detach().requires_grad_()
                p, live = self._live()
                y_hi = run(y_lo, p, saveat[n], saveat[n + 1])
                grads = torch.autograd.grad(y_hi, (y_lo,) + tuple(live), a,
                                            allow_unused=True)
            a = grads[0] + g[..., n, :]
            for i, d in enumerate(grads[1:]):
                if d is not None:
                    dleaves[i] = dleaves[i] + d
        return a, dleaves

    # -- BacksolveAdjoint ----------------------------------------------------
    def _aug_rhs(self, dim, t_hi, N):
        """The augmented field in s = t_hi - t for rows (N, 2 dim + np):
        (-f(y), a^T df/dy, a^T df/dp), a^T df/dp per row."""
        f, p = self.f, self.p
        shared = not self.per_row and len(self.leaves) > 0

        def rhs(aug, _unused, s):
            y, a = aug[:, :dim], aug[:, dim:2 * dim]
            t = t_hi - s
            if shared:
                tr = torch.as_tensor(t, dtype=aug.dtype,
                                     device=aug.device).expand(N, 1)
                fy, ay, ap = self._shared_vjp(y, a, tr)
            else:
                with torch.enable_grad():
                    yy = y.detach().requires_grad_()
                    pp, live = self._live()
                    if self.per_row:
                        pp = pp.reshape(N, -1)
                    fy = f(yy, pp, t)
                    grads = torch.autograd.grad(fy, (yy,) + tuple(live), a,
                                                allow_unused=True)
                ay = grads[0]
                ap = [gr if gr is not None else torch.zeros_like(q)
                      for gr, q in zip(grads[1:], live)]
                ap = [x.reshape(N, -1) for x in ap]
            return torch.cat([-fy.detach(), ay] + list(ap), dim=-1)
        return rhs

    def _shared_vjp(self, y, a, t):
        """f and its VJPs row by row (``torch.func.vmap``) with parameters
        shared by the rows: (f (N, dim), a^T df/dy (N, dim), [a^T df/dp
        flattened per row (N, n)])."""
        f = self.f
        if self.names is not None:
            params = {n: q.detach() for n, q in zip(self.names, self.leaves)}

            def call(yr, prm, tr):
                return f(yr[None], _Bound(self.p, prm), tr[None])[0]
        else:
            params = self.p.detach()

            def call(yr, prm, tr):
                return f(yr[None], prm, tr[None])[0]

        def one(yr, ar, tr):
            out, pull = torch.func.vjp(lambda yy, pp: call(yy, pp, tr), yr,
                                       params)
            gy, gp = pull(ar)
            return out, gy, gp

        out, gy, gp = torch.func.vmap(one)(y, a, t)
        if self.names is not None:
            gp = [gp[n].reshape(y.shape[0], -1) for n in self.names]
        else:
            gp = [gp.reshape(y.shape[0], -1)]
        return out, gy, gp

    def _backsolve_backward(self, ys, saveat, g):
        sa, solver = self.sensealg, self.solver
        dim = ys.shape[-1]
        T = saveat.shape[0]
        ys_r = ys.reshape(-1, T, dim)
        g_r = g.reshape(-1, T, dim)
        N = ys_r.shape[0]
        sizes = [q.numel() // (N if self.per_row else 1)
                 for q in self.leaves]
        zeros = ys_r.new_zeros(N, sum(sizes))
        aug = torch.cat([ys_r[:, -1], g_r[:, -1], zeros], dim=-1)
        tab = solver.tableau
        for n in range(T - 2, -1, -1):
            t_lo, t_hi = saveat[n], saveat[n + 1]
            rhs = self._aug_rhs(dim, t_hi, N)
            h = t_hi - t_lo
            if _bwd_adaptive(solver, sa):
                aug_ys, ok, _ = solve_adaptive(
                    rhs, solver, aug, None, torch.stack([torch.zeros_like(h),
                                                         h]), _bwd_cfg(sa))
                end = _nan_unless(ok, aug_ys[:, -1])
            else:
                ds = h / sa.bwd_substeps
                end = aug
                for j in range(sa.bwd_substeps):
                    end, _, _ = rk_step(rhs, tab, end, None, j * ds, ds,
                                        with_error=False)
            y1, a1, ap1 = end[:, :dim], end[:, dim:2 * dim], end[:, 2 * dim:]
            a1 = a1 + g_r[:, n]
            if sa.checkpointing:
                y1 = ys_r[:, n]
            aug = torch.cat([y1, a1, ap1], dim=-1)
        a0 = aug[:, dim:2 * dim].reshape(g.shape[:-2] + (dim,))
        dleaves, at = [], 2 * dim
        for q, k in zip(self.leaves, sizes):
            d = aug[:, at:at + k]
            at += k
            dleaves.append(d.reshape(q.shape) if self.per_row
                           else d.sum(0).reshape(q.shape))
        return a0, dleaves

    def backward(self, ys, saveat, g):
        if isinstance(self.sensealg, BacksolveAdjoint):
            return self._backsolve_backward(ys, saveat, g)
        return self._interpolating_backward(ys, saveat, g)


class _AdjointFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, u0, saveat, *leaves):
        with torch.no_grad():
            ys, success, stats = _forward(adj.f, adj.solver, u0, adj.p,
                                          saveat, adj.options)
        ctx.adj = adj
        ctx.save_for_backward(ys, saveat)
        outs = (ys, success) + tuple(stats[k] for k in _STATS)
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, g, *_):
        ys, saveat = ctx.saved_tensors
        du0, dleaves = ctx.adj.backward(ys.detach(), saveat.detach(), g)
        return (None, du0, None) + tuple(dleaves)


def _adjoint(f, solver, u0, p, saveat, options, sensealg):
    adj = _Adjoint(f, solver, options, sensealg, u0, p)
    ys, success, *stats = _AdjointFn.apply(adj, u0, saveat, *adj.leaves)
    return ys, success, dict(zip(_STATS, stats))


def odeint(f: Callable, solver: AbstractSolver, u0, p, saveat,
           options: SolveOptions = SolveOptions(),
           sensealg: AbstractSensealg = Unrolled()):
    """Integrate du/dt = f(u, p, t), emitting states at ``saveat``.
    Returns ``(ys, success, stats)``, differentiable with respect to ``u0``
    and ``p`` according to ``sensealg`` (odeint.py:222-246)."""
    if isinstance(sensealg, Unrolled):
        return _forward(f, solver, u0, p, saveat, options,
                        checkpoint=sensealg.checkpoint)
    if isinstance(sensealg, InterpolatingAdjoint):
        if not options.adaptive:
            # exact: each interval checkpointed, the backward recomputes it
            return _forward(f, solver, u0, p, saveat, options,
                            checkpoint=True)
        return _adjoint(f, solver, u0, p, saveat, options, sensealg)
    if isinstance(sensealg, BacksolveAdjoint):
        return _adjoint(f, solver, u0, p, saveat, options, sensealg)
    raise ValueError(f"unknown sensealg {sensealg}")
