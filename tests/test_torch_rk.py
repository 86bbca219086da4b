"""The plain versions of the RK backward kernel's two phases, on the CPU at
small sizes: the interval maps (J_n = d ys[n+1] / d ys[n], r_n =
d ys[n+1] / d p) against autograd's Jacobian of one interval in float64,
the two phases together (maps, then the affine sweep) against ``jax.vjp`` of
``pallas_solve_fixed_grid_batched(..., interpret=True)`` and against the
plain step-by-step reverse sweep; and the wrapper's choice of kernel
instance (a tableau compiled in, or the one read at run time). The CUDA
kernels follow these plain versions (tests/test_torch_cuda.py holds them to
it on the card).

Tolerances: float64 maps within 1e-10 of autograd (atol: entries of order
1, the same derivative summed in another order); float32 gradients within
1e-5 of each gradient's size of the JAX result (the same arithmetic in
another order); float64 two-phase within 1e-10 of each gradient's size of
the reverse sweep.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched
from latentdiffeq.solve import rk as jrk
from latentdiffeq_torch.ops import ode_cuda
from latentdiffeq_torch.pendulum import pendulum_f, pendulum_friction_f
from latentdiffeq_torch.solve import rk as trk
from latentdiffeq_torch.solve.fixed import solve_fixed_grid


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def jpend_friction(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0]) - 0.7 * u[1]])


RHS = {"pendulum": (jpend, pendulum_f),
       "friction": (jpend_friction, pendulum_friction_f)}
CASES = [(rhs, solver, substeps) for rhs in sorted(RHS)
         for solver in ("Tsit5", "RK4") for substeps in (1, 3)]


def inputs(B, T, seed, dtype=np.float64):
    """Rows, lengths and cotangents from numpy; the grid's intervals differ
    in length (0.03-0.07), so each interval has its own map."""
    rng = np.random.default_rng(seed)
    u0s = rng.uniform(-1, 1, (B, 2)).astype(dtype)
    ps = rng.uniform(1, 2, (B, 1)).astype(dtype)
    saveat = np.cumsum(rng.uniform(0.03, 0.07, T)).astype(dtype)
    g = rng.normal(size=(B, T, 2)).astype(dtype)
    return u0s, ps, saveat, g


def rel(got, ref):
    scale = max(float(ref.abs().max()), 1e-30)
    return float((got - ref).abs().max()) / scale


@pytest.mark.parametrize("rhs,solver,substeps", CASES)
def test_interval_maps_match_autograd_jacobian(rhs, solver, substeps):
    """Each interval's map against torch.autograd.functional.jacobian of
    the plain solve over that one interval, from the saved state."""
    f = RHS[rhs][1]
    s = getattr(trk, solver)()
    u0s, ps, saveat, _ = (torch.from_numpy(a) for a in inputs(3, 6, 11))
    ys = ode_cuda.solve_fixed_grid_batched_reference(
        f, s, u0s, ps, saveat, substeps=substeps)[0]
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, ys, ps, substeps=substeps)
    assert J.shape == (3, 5, 2, 2) and r.shape == (3, 5, 2, 1)
    rows = torch.arange(3)
    for n in range(5):
        def interval(y, p):
            return solve_fixed_grid(f, s, y, p, saveat[n:n + 2],
                                    substeps=substeps)[0][:, 1]

        jy, jp = torch.autograd.functional.jacobian(interval,
                                                    (ys[:, n], ps))
        # (B, dim, B, k): the rows do not mix, so take the diagonal blocks
        torch.testing.assert_close(J[:, n], jy[rows, :, rows], rtol=0,
                                   atol=1e-10)
        torch.testing.assert_close(r[:, n], jp[rows, :, rows], rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("rhs,solver,substeps", CASES)
def test_two_phase_backward_matches_jax_vjp(rhs, solver, substeps):
    """Maps and sweep, from the plain forward's float32 trajectory, against
    jax.vjp of the Pallas kernel (its custom_vjp)."""
    u0s, ps, saveat, g = inputs(5, 12, 8, np.float32)
    jf, tf = RHS[rhs]

    def run(u, p):
        return pallas_solve_fixed_grid_batched(
            jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
            substeps=substeps, interpret=True)[0]

    _, vjp = jax.vjp(run, jnp.asarray(u0s), jnp.asarray(ps))
    du0_j, dp_j = (torch.from_numpy(np.array(a))
                   for a in vjp(jnp.asarray(g)))
    s = getattr(trk, solver)()
    t_ps, t_saveat = torch.from_numpy(ps), torch.from_numpy(saveat)
    ys = ode_cuda.solve_fixed_grid_batched_reference(
        tf, s, torch.from_numpy(u0s), t_ps, t_saveat, substeps=substeps)[0]
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        tf, s, t_saveat, ys, t_ps, substeps=substeps)
    du0, dp = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(
        J, r, torch.from_numpy(g))
    assert rel(du0, du0_j) <= 1e-5
    assert rel(dp, dp_j) <= 1e-5


@pytest.mark.parametrize("rhs,solver,substeps", CASES)
def test_two_phase_backward_matches_reverse_sweep_float64(rhs, solver,
                                                          substeps):
    f = RHS[rhs][1]
    s = getattr(trk, solver)()
    u0s, ps, saveat, g = (torch.from_numpy(a) for a in inputs(4, 15, 12))
    ys = ode_cuda.solve_fixed_grid_batched_reference(
        f, s, u0s, ps, saveat, substeps=substeps)[0]
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, ys, ps, substeps=substeps)
    got = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J, r, g)
    ref = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, saveat, ys, ps, g, substeps=substeps)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        assert rel(a, b) <= 1e-10


@dataclasses.dataclass(frozen=True)
class _Solver(trk.AbstractSolver):
    tab: trk.ButcherTableau

    @property
    def tableau(self):
        return self.tab


def _tsit5_with_b0(factor):
    tab = trk.Tsit5().tableau
    b = (tab.b[0] * factor,) + tab.b[1:]
    return _Solver(dataclasses.replace(tab, b=b))


@pytest.mark.parametrize("solver,want", [
    (trk.Tsit5(), 1), (trk.RK4(), 2), (trk.Euler(), 0), (trk.Midpoint(), 0),
    (trk.Dopri5(), 0), (_tsit5_with_b0(1 + 1e-6), 0),
    (_tsit5_with_b0(1 + 1e-13), 1)],
    ids=["Tsit5", "RK4", "Euler", "Midpoint", "Dopri5", "Tsit5-perturbed",
         "Tsit5-below-float32"])
def test_tableau_instance_compares_float32_coefficients(solver, want):
    """Tsit5 and RK4 run their baked instances, every other tableau the
    generic one; the choice compares the float32 roundings, so a change
    below float32 resolution keeps the baked instance."""
    if want:
        baked = trk.tableau_f32(ode_cuda.BAKED_TABLEAUS[want])
        mine = trk.tableau_f32(solver)
        assert all(torch.equal(x, y) for x, y in zip(mine[1:], baked[1:]))
    assert ode_cuda.tableau_instance(solver) == want
