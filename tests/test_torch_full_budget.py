"""The adaptive solves' masked tail: a solve that runs its whole step budget
(as under a CUDA graph capture, where ``solve.adaptive.all_inactive`` cannot
read the flags and answers False, or under ``torch.func.vmap``) equals the
solve that stops once every row is done, bit for bit: ``ys``, ``success``,
the counters, and the gradients in ``u0`` and ``p``.

- ``solve_adaptive`` (Tsit5, Dopri5) with Unrolled gradients through the
  steps, and through ``odeint``'s InterpolatingAdjoint and BacksolveAdjoint
  with their adaptive backward solves, whose own loops run the budget too.
- ``solve_sde_adaptive`` (SRA1, SRIW1) with pathwise gradients.
- A row that fails (its state blows up, its step shrinks below dtmin)
  keeps finite gradients through the masked tail, equal to the early-
  exiting solve's.

Rows of different difficulty finish at different steps, so each early-
exiting solve stops well short of its budget (checked)."""
import pytest
import torch

from latentdiffeq_torch.adjoint import (BacksolveAdjoint,
                                        InterpolatingAdjoint, SolveOptions,
                                        Unrolled, odeint)
from latentdiffeq_torch.random import PRNGKey, split
from latentdiffeq_torch.solve import adaptive
from latentdiffeq_torch.solve.adaptive import AdaptiveConfig, solve_adaptive
from latentdiffeq_torch.solve.rk import Dopri5, Tsit5
from latentdiffeq_torch.solve.sde import (SDEAdaptiveConfig, SRA1, SRIW1,
                                          solve_sde_adaptive)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CAPTURING = adaptive._stream_capturing


class Budget:
    """Counts the solves' loop iterations (``all_inactive`` calls) and,
    with ``full``, makes ``all_inactive`` answer as under a capture."""

    def __init__(self, monkeypatch, full: bool):
        self.iterations = 0

        def capturing(t):
            self.iterations += 1
            return full or _CAPTURING(t)

        monkeypatch.setattr(adaptive, "_stream_capturing", capturing)


def pendulum(y, p, t):
    return torch.stack([y[..., 1], -p[..., 0] * torch.sin(y[..., 0])], -1)


def damped(y, p, t):
    """A field that blows up past |y| 4 (a row that has failed steps into
    infinities)."""
    return torch.stack([y[..., 1], p[..., 0] * y[..., 0] ** 3], -1)


def rows(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    u0 = (torch.rand(n, 2, generator=g, dtype=torch.float64) - 0.5) * 3
    p = torch.rand(n, 1, generator=g, dtype=torch.float64) * 30 + 0.5
    return u0, p


def run(f, solve, u0, p, weights):
    u0 = u0.clone().requires_grad_()
    p = p.clone().requires_grad_()
    ys, ok, stats = solve(f, u0, p)
    loss = (torch.nan_to_num(ys, nan=0.0) * weights).sum()
    du0, dp = torch.autograd.grad(loss, (u0, p))
    return ys.detach(), ok, stats, du0, dp


def both(monkeypatch, f, solve, u0, p, T):
    """The early-exiting solve and the whole-budget one: (results, loop
    iterations) each, the loss weighting ys by the same random weights."""
    w = torch.rand((u0.shape[0], T, u0.shape[1]), dtype=u0.dtype,
                   generator=torch.Generator().manual_seed(5))
    out = []
    for full in (False, True):
        counter = Budget(monkeypatch, full)
        out.append((run(f, solve, u0, p, w), counter.iterations))
    return out


def assert_same(a, b):
    (ys_a, ok_a, st_a, du_a, dp_a), (ys_b, ok_b, st_b, du_b, dp_b) = a, b
    assert torch.equal(torch.nan_to_num(ys_a, nan=7.0),
                       torch.nan_to_num(ys_b, nan=7.0))
    assert torch.equal(ok_a, ok_b)
    assert st_a.keys() == st_b.keys()
    for k in st_a:
        assert torch.equal(st_a[k], st_b[k]), k
    assert torch.equal(du_a, du_b) and torch.equal(dp_a, dp_b)
    assert torch.isfinite(du_a).all() and torch.isfinite(dp_a).all()


SAVEAT = torch.linspace(0.0, 2.0, 21, dtype=torch.float64)
ODE_CFG = AdaptiveConfig(rtol=1e-5, atol=1e-7, max_steps=400)


def ode_solve(solver, sensealg):
    def solve(f, u0, p):
        if isinstance(sensealg, Unrolled):
            return solve_adaptive(f, solver, u0, p, SAVEAT, ODE_CFG)
        return odeint(f, solver, u0, p, SAVEAT,
                      SolveOptions(adaptive=True, adaptive_cfg=ODE_CFG),
                      sensealg)
    return solve


@pytest.mark.parametrize("sensealg", [Unrolled(), InterpolatingAdjoint(),
                                      BacksolveAdjoint()],
                         ids=["unrolled", "interpolating", "backsolve"])
@pytest.mark.parametrize("solver", [Tsit5(), Dopri5()],
                         ids=["tsit5", "dopri5"])
def test_ode_full_budget_equals_early_exit(monkeypatch, solver, sensealg):
    u0, p = rows()
    solve = ode_solve(solver, sensealg)
    (early, n_early), (full, n_full) = both(monkeypatch, pendulum, solve,
                                            u0, p, len(SAVEAT))
    assert_same(early, full)
    attempts = early[2]["n_accepted"] + early[2]["n_rejected"]
    # the early-exiting forward stopped at the slowest row, short of the
    # budget; the rows finished at different steps
    assert int(attempts.max()) < ODE_CFG.max_steps // 2
    assert int(attempts.min()) < int(attempts.max())
    assert n_full > n_early
    assert bool(early[1].all())


def test_ode_failed_row_keeps_finite_gradients(monkeypatch):
    """A row whose state blows up fails (its step shrinks below dtmin);
    the masked steps after it start from its last accepted state with that
    step, so the tail passes no NaN back: the whole-budget gradients equal
    the early exit's and are finite."""
    u0 = torch.tensor([[0.3, 0.0], [0.2, 0.1], [3.0, 2.0]],
                      dtype=torch.float64)
    p = torch.tensor([[-1.0], [-2.0], [40.0]], dtype=torch.float64)
    solve = ode_solve(Tsit5(), Unrolled())
    (early, _), (full, n_full) = both(monkeypatch, damped, solve, u0, p,
                                        len(SAVEAT))
    assert not bool(early[1][2]) and bool(early[1][:2].all())
    assert_same(early, full)


SDE_CFG = SDEAdaptiveConfig(rtol=1e-3, atol=1e-3, max_steps=600,
                            depth_cap=5)


def additive(y, p, t):
    return 0.3 * torch.ones_like(y)


def diagonal(y, p, t):
    return 0.2 * torch.cos(y)


@pytest.mark.parametrize("solver,g", [(SRA1(), additive),
                                      (SRIW1(), diagonal)],
                         ids=["sra1", "sriw1"])
def test_sde_full_budget_equals_early_exit(monkeypatch, solver, g):
    u0, p = rows(seed=1)
    keys = split(PRNGKey(3), u0.shape[0])
    saveat = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)

    def solve(f, u0, p):
        return solve_sde_adaptive(f, g, solver, u0, p, saveat, keys,
                                  SDE_CFG)

    (early, n_early), (full, n_full) = both(monkeypatch, pendulum, solve,
                                            u0, p, len(saveat))
    assert_same(early, full)
    attempts = early[2]["n_accepted"] + early[2]["n_rejected"]
    assert int(attempts.max()) < SDE_CFG.max_steps // 2
    assert int(attempts.min()) < int(attempts.max())
    assert int(early[2]["max_depth"].max()) > 0
    assert n_full > n_early
