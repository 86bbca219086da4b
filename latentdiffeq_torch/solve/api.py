"""The user-facing solve API (counterpart of latentdiffeq/solve/api.py):
``make_options``, ``autosize_max_steps``, ``solve`` and
``solve_ensemble``.

``solve_ensemble`` takes batched ``u0s``/``ps`` and solves them in one
batched ``odeint`` call, each row with its own step control (the JAX
package vmaps the single solve); failed rows are NaN-filled and the
counters summed. An ``SDEProblem`` goes to the SDE solvers with SRA1 as the
default and a PRNG ``key`` (``latentdiffeq_torch.random``) for its
Brownian path; ensemble rows take ``split(key, batch)``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch

from ..adjoint.modes import AbstractSensealg, Unrolled
from ..adjoint.odeint import SolveOptions, odeint
from .adaptive import AdaptiveConfig, solve_adaptive
from .. import random as jr
from .problem import SDEProblem, Solution
from .rk import Tsit5
from .sde import (SDEAdaptiveConfig, SRA1, solve_sde_adaptive,
                  solve_sde_fixed_grid)

__all__ = ["solve", "solve_ensemble", "make_options", "autosize_max_steps"]


def make_options(*, adaptive: Optional[bool] = None, substeps: int = 1,
                 rtol: float = 1e-3, atol: float = 1e-6,
                 max_steps: int = 256, dt0: Optional[float] = None,
                 interp_stride: int = 1, unroll: int = 1,
                 **adaptive_kw) -> SolveOptions:
    """SolveOptions from flat keyword arguments (api.py:27-56).
    ``interp_stride > 1`` degrades training stability, so it warns."""
    if adaptive is None:
        adaptive = True
    if interp_stride > 1:
        warnings.warn(
            "interp_stride > 1 (macro-stepping) is a known-bad TRAINING "
            "configuration — it degrades training stability "
            "(benchmarks/RESULTS.md). Use it for inference/data "
            "generation only.", UserWarning, stacklevel=2)
    return SolveOptions(
        adaptive=adaptive, substeps=substeps, interp_stride=interp_stride,
        unroll=unroll,
        adaptive_cfg=AdaptiveConfig(rtol=rtol, atol=atol,
                                    max_steps=max_steps, dt0=dt0,
                                    **adaptive_kw))


@torch.no_grad()
def autosize_max_steps(f, solver, u0s, ps, saveat, options: SolveOptions,
                       *, safety: float = 1.5,
                       floor: int = 16) -> SolveOptions:
    """Size the adaptive step budget from one batched probe solve
    (api.py:59-96): ``max_steps = ceil(safety * most attempts)``, at least
    ``floor`` and at most the current budget. If a probe row fails, the
    options come back unchanged."""
    _, success, stats = solve_adaptive(f, solver, u0s, ps, saveat,
                                       options.adaptive_cfg)
    if not bool(success.all()):
        return options
    attempts = stats["n_accepted"] + stats["n_rejected"]
    sized = max(floor, int(math.ceil(safety * int(attempts.max()))))
    sized = min(sized, options.adaptive_cfg.max_steps)
    return dataclasses.replace(
        options, adaptive_cfg=dataclasses.replace(options.adaptive_cfg,
                                                  max_steps=sized))


def _pop_sde_kwargs(kwargs) -> dict:
    """The SDE solve options from flat kwargs (api.py:99-110); leftovers
    raise in the caller."""
    return {
        "substeps": kwargs.pop("substeps", 1),
        "checkpoint": kwargs.pop("checkpoint", False),
        "adaptive": kwargs.pop("adaptive", False),
        "rtol": kwargs.pop("rtol", 1e-2),
        "atol": kwargs.pop("atol", 1e-2),
        "max_steps": kwargs.pop("max_steps", 1024),
        "depth_cap": kwargs.pop("depth_cap", 10),
    }


def _sde_setup(solver, key, kwargs, device):
    """(solver, the key on ``device``, the SDE options) of an SDE solve."""
    if key is None:
        raise ValueError("SDE solve requires a PRNG `key`")
    kw = _pop_sde_kwargs(kwargs)
    if kwargs:
        raise TypeError(f"unsupported SDE solve kwargs: {kwargs}")
    return (SRA1() if solver is None else solver,
            jr.as_key(key, device), kw)


def _solve_sde(prob, solver, u0, p, saveat, key, kw):
    if kw["adaptive"]:
        cfg = SDEAdaptiveConfig(rtol=kw["rtol"], atol=kw["atol"],
                                max_steps=kw["max_steps"],
                                depth_cap=kw["depth_cap"])
        return solve_sde_adaptive(prob.f, prob.g, solver, u0, p, saveat,
                                  key, cfg)
    return solve_sde_fixed_grid(prob.f, prob.g, solver, u0, p, saveat, key,
                                substeps=kw["substeps"],
                                checkpoint=kw["checkpoint"])


def _options(options, kwargs):
    if options is None:
        return make_options(**kwargs)
    if kwargs:
        raise TypeError("pass either `options` or flat kwargs, not both")
    return options


def _grid(saveat, like):
    return torch.as_tensor(saveat, dtype=like.dtype, device=like.device)


def solve(prob, solver=None, *, saveat,
          sensealg: AbstractSensealg = Unrolled(),
          options: Optional[SolveOptions] = None, key=None,
          **kwargs) -> Solution:
    """Solve the problem's trajectory, saving at ``saveat``. An
    ``SDEProblem`` needs ``key``, its Brownian path, and takes the SDE
    options (``substeps``, ``checkpoint``, ``adaptive``, ``rtol``,
    ``atol``, ``max_steps``, ``depth_cap``) as flat kwargs."""
    saveat = _grid(saveat, prob.u0)
    if isinstance(prob, SDEProblem):
        solver, key, kw = _sde_setup(solver, key, kwargs, prob.u0.device)
        ys, success, stats = _solve_sde(prob, solver, prob.u0, prob.p,
                                        saveat, key, kw)
        return Solution(ts=saveat, ys=ys, success=success, stats=stats)
    solver = Tsit5() if solver is None else solver
    options = _options(options, kwargs)
    ys, success, stats = odeint(prob.f, solver, prob.u0, prob.p, saveat,
                                options, sensealg)
    return Solution(ts=saveat, ys=ys, success=success, stats=stats)


def solve_ensemble(prob, solver=None, *, u0s, ps, saveat,
                   sensealg: AbstractSensealg = Unrolled(),
                   options: Optional[SolveOptions] = None, key=None,
                   nan_fill: bool = True, **kwargs) -> Solution:
    """Batched solve over per-trajectory ``u0s`` (batch, dim) and ``ps``
    (batch, pdim). Failed rows are NaN-filled when ``nan_fill``;
    ``sol.success`` (batch,) says which; ``stats`` are summed. An
    ``SDEProblem``'s rows take the keys ``split(key, batch)``."""
    saveat = _grid(saveat, u0s)
    if isinstance(prob, SDEProblem):
        solver, key, kw = _sde_setup(solver, key, kwargs, u0s.device)
        ys, success, stats = _solve_sde(prob, solver, u0s, ps, saveat,
                                        jr.split(key, u0s.shape[0]), kw)
    else:
        solver = Tsit5() if solver is None else solver
        options = _options(options, kwargs)
        ys, success, stats = odeint(prob.f, solver, u0s, ps, saveat,
                                    options, sensealg)
    if nan_fill:
        ys = torch.where(success[:, None, None], ys,
                         torch.full_like(ys, float("nan")))
    stats = {k: v.sum() for k, v in stats.items()}
    return Solution(ts=saveat, ys=ys, success=success, stats=stats)
