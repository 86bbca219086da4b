"""Parity of the PyTorch port's RK tableaus, fixed-grid solve, odeint and
the batched-solve kernel's plain version against the JAX package, on the
CPU. Inputs from numpy; float32, atol 1e-5 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched
from latentdiffeq.solve import rk as jrk
from latentdiffeq.solve.fixed import solve_fixed_grid as jsolve
from latentdiffeq_torch import adjoint as tadj
from latentdiffeq_torch.ops import ode_cuda
from latentdiffeq_torch.pendulum import pendulum_f, pendulum_friction_f
from latentdiffeq_torch.solve import rk as trk
from latentdiffeq_torch.solve.fixed import solve_fixed_grid as tsolve

ATOL = 1e-5
SOLVERS = ["Euler", "Midpoint", "RK4", "Tsit5", "Dopri5"]


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def jpend_friction(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0]) - 0.7 * u[1]])


def inputs(B=6, T=12, seed=0):
    rng = np.random.default_rng(seed)
    u0s = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (B, 1)).astype(np.float32)
    saveat = (np.arange(T) * 0.05).astype(np.float32)
    return u0s, ps, saveat


def t_(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("name", SOLVERS)
def test_tableaus_equal_jax(name):
    jt, tt = getattr(jrk, name)().tableau, getattr(trk, name)().tableau
    assert (jt.a, jt.b, jt.c, jt.b_err, jt.order, jt.fsal) == \
        (tt.a, tt.b, tt.c, tt.b_err, tt.order, tt.fsal)
    assert jrk.n_solution_stages(jt) == trk.n_solution_stages(tt)


@pytest.mark.parametrize("name", SOLVERS)
def test_rk_step_matches_jax(name):
    rng = np.random.default_rng(1)
    y = rng.normal(size=2).astype(np.float32)
    p = np.array([1.3], np.float32)
    jt, tt = getattr(jrk, name)().tableau, getattr(trk, name)().tableau
    for with_error in (False, True):
        yj, ej, _ = jrk.rk_step(jpend, jt, jnp.asarray(y), jnp.asarray(p),
                                jnp.float32(0.1), jnp.float32(0.05),
                                with_error=with_error)
        yt, et, _ = trk.rk_step(pendulum_f, tt, t_(y), t_(p),
                                torch.tensor(0.1), torch.tensor(0.05),
                                with_error=with_error)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=ATOL)
        assert (ej is None) == (et is None)
        if ej is not None:
            np.testing.assert_allclose(et.numpy(), np.asarray(ej),
                                       atol=ATOL)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("substeps", [1, 3])
def test_solve_fixed_grid_matches_jax(name, substeps):
    u0s, ps, saveat = inputs()
    solver_j, solver_t = getattr(jrk, name)(), getattr(trk, name)()
    ys_j, ok_j, st_j = jax.vmap(lambda u, p: jsolve(
        jpend, solver_j, u, p, jnp.asarray(saveat), substeps=substeps))(
        jnp.asarray(u0s), jnp.asarray(ps))
    ys_t, ok_t, st_t = tsolve(pendulum_f, solver_t, t_(u0s), t_(ps),
                              t_(saveat), substeps=substeps)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=ATOL)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    for k in ("n_rhs_evals", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]))


@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("substeps", [1, 3])
def test_batched_plain_matches_pallas_interpret(solver, substeps):
    """The kernel's plain version against the JAX Pallas kernel in
    interpret mode (as tests/test_pallas_ops.py runs it)."""
    u0s, ps, saveat = inputs(B=5, T=15, seed=2)
    ys_j, ok_j, st_j = pallas_solve_fixed_grid_batched(
        jpend, getattr(jrk, solver)(), jnp.asarray(u0s), jnp.asarray(ps),
        jnp.asarray(saveat), substeps=substeps, interpret=True)
    for fn in (ode_cuda.solve_fixed_grid_batched_reference,
               ode_cuda.solve_fixed_grid_batched):
        ys_t, ok_t, st_t = fn(pendulum_f, getattr(trk, solver)(), t_(u0s),
                              t_(ps), t_(saveat), substeps=substeps)
        assert ys_t.shape == (5, 15, 2)
        np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j),
                                   atol=ATOL)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        for k in ("n_rhs_evals", "n_accepted", "n_rejected"):
            assert int(st_t[k].sum()) == int(st_j[k])


def test_friction_rhs_matches_jax():
    u0s, ps, saveat = inputs(seed=3)
    ys_j, _, _ = jax.vmap(lambda u, p: jsolve(
        jpend_friction, jrk.Tsit5(), u, p, jnp.asarray(saveat)))(
        jnp.asarray(u0s), jnp.asarray(ps))
    ys_t, _, _ = tsolve(pendulum_friction_f, trk.Tsit5(), t_(u0s), t_(ps),
                        t_(saveat))
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=ATOL)


def test_solve_gradients_match_jax():
    """Unrolled gradients wrt u0 and p (the kernel's backward recomputes
    through this path); atol 1e-4 on O(10) gradients."""
    u0s, ps, saveat = inputs(B=4, T=10, seed=4)
    w = np.random.default_rng(5).normal(size=(4, 10, 2)).astype(np.float32)

    def lj(u, p):
        ys = jax.vmap(lambda a, b: jsolve(jpend, jrk.Tsit5(), a, b,
                                          jnp.asarray(saveat))[0])(u, p)
        return jnp.sum(ys * w)

    gu_j, gp_j = jax.grad(lj, argnums=(0, 1))(jnp.asarray(u0s),
                                              jnp.asarray(ps))
    u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
    ys, _, _ = ode_cuda.solve_fixed_grid_batched(pendulum_f, trk.Tsit5(), u,
                                                 p, t_(saveat))
    (ys * t_(w)).sum().backward()
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(gu_j), atol=1e-4)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp_j), atol=1e-4)


def test_success_flags_and_nan():
    u0s, ps, saveat = inputs(B=3)
    ps[1, 0] = 0.0                     # L = 0: division by zero
    ys, ok, _ = tsolve(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps),
                       t_(saveat))
    assert ok.tolist() == [True, False, True]
    assert bool(torch.isfinite(ys[0]).all())


def test_odeint_unrolled_and_unported_options():
    u0s, ps, saveat = inputs()
    opts = tadj.SolveOptions(adaptive=False, substeps=2, unroll=7)
    ys, _, _ = tadj.odeint(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps),
                           t_(saveat), opts)
    ref, _, _ = tsolve(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps),
                       t_(saveat), substeps=2)
    torch.testing.assert_close(ys, ref, rtol=0, atol=0)
    # RK4 has no error estimate: adaptive=True solves on the fixed grid
    tadj.odeint(pendulum_f, trk.RK4(), t_(u0s), t_(ps), t_(saveat))
    with pytest.raises(NotImplementedError):
        tadj.odeint(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat))
    with pytest.raises(NotImplementedError):
        tadj.odeint(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat),
                    opts, tadj.Unrolled(checkpoint=True))
    with pytest.raises(NotImplementedError):
        tsolve(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat),
               interp_stride=2)


def test_kernel_solver_rejects_rhs_without_device_functor():
    u0s, ps, saveat = inputs()

    def no_functor(u, p, t):
        return pendulum_f(u, p, t)

    with pytest.raises(ValueError):
        ode_cuda.solve_fixed_grid_batched(no_functor, trk.Tsit5(), t_(u0s),
                                          t_(ps), t_(saveat))
    with pytest.raises(ValueError):    # a CPU tensor never reaches it
        ode_cuda.solve_fixed_grid_batched_cuda(pendulum_f, trk.Tsit5(),
                                               t_(u0s), t_(ps), t_(saveat))
