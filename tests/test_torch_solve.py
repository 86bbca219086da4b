"""Parity of the PyTorch port's RK tableaus, dense output, fixed-grid and
adaptive solves, odeint and the batched-solve kernel's plain version
against the JAX package, on the CPU. Inputs from numpy; float32, atol 1e-5
unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq.adjoint.odeint import odeint as jodeint
from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched
from latentdiffeq.solve import adaptive as jad
from latentdiffeq.solve import rk as jrk
from latentdiffeq.solve.fixed import solve_fixed_grid as jsolve
from latentdiffeq_torch import adjoint as tadj
from latentdiffeq_torch import pendulum_data
from latentdiffeq_torch.ops import ode_cuda
from latentdiffeq_torch.pendulum import pendulum_f, pendulum_friction_f
from latentdiffeq_torch.solve import adaptive as tad
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
    assert (jt.a, jt.b, jt.c, jt.b_err, jt.order, jt.fsal,
            jt.interpolation) == (tt.a, tt.b, tt.c, tt.b_err, tt.order,
                                  tt.fsal, tt.interpolation)
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
def test_interpolate_dense_matches_jax(name):
    """Each tableau's continuous extension (linear, cubic Hermite, tsit5,
    dopri5) at a vector of theta, one trajectory and a batch of rows."""
    rng = np.random.default_rng(11)
    y = rng.normal(size=2).astype(np.float32)
    p = np.array([1.4], np.float32)
    theta = np.linspace(0, 1, 9).astype(np.float32)
    jt, tt = getattr(jrk, name)().tableau, getattr(trk, name)().tableau
    y1j, _, ksj = jrk.rk_step(jpend, jt, jnp.asarray(y), jnp.asarray(p),
                              jnp.float32(0.0), jnp.float32(0.3))
    ref = np.asarray(jrk.interpolate_dense(jt, jnp.asarray(y), y1j, ksj,
                                           jnp.float32(0.3),
                                           jnp.asarray(theta)))
    y1t, _, kst = trk.rk_step(pendulum_f, tt, t_(y), t_(p),
                              torch.tensor(0.0), torch.tensor(0.3))
    got = trk.interpolate_dense(tt, t_(y), y1t, kst, torch.tensor(0.3),
                                t_(theta))
    assert got.shape == (9, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[-1].numpy(), y1t.numpy(), rtol=0,
                               atol=ATOL)
    # rows of a batch, each with its own theta, as solve_adaptive calls it
    yb = torch.stack([t_(y), 2 * t_(y)])
    y1b, _, ksb = trk.rk_step(pendulum_f, tt, yb, t_(p),
                              torch.zeros(2, 1), torch.full((2, 1), 0.3))
    th = torch.stack([t_(theta), t_(theta[::-1].copy())])
    gb = trk.interpolate_dense(tt, yb[:, None], y1b[:, None],
                               [k[:, None] for k in ksb],
                               torch.full((2, 1, 1), 0.3), th)
    assert gb.shape == (2, 9, 2)
    np.testing.assert_allclose(gb[0].numpy(), ref, rtol=0, atol=ATOL)


def jmlp_rhs(seed=0, dim=3, hidden=8):
    """A small tanh MLP field for both packages, weights from numpy."""
    rng = np.random.default_rng(seed)
    W1 = (rng.normal(size=(dim, hidden)) * 0.8).astype(np.float32)
    b1 = (rng.normal(size=hidden) * 0.3).astype(np.float32)
    W2 = (rng.normal(size=(hidden, dim)) * 0.8).astype(np.float32)
    b2 = (rng.normal(size=dim) * 0.3).astype(np.float32)

    def jf(u, p, t):
        return jnp.tanh(u @ W1 + b1) @ W2 + b2

    def tf(u, p, t):
        return torch.tanh(u @ t_(W1) + t_(b1)) @ t_(W2) + t_(b2)

    return jf, tf


# The controller reads the embedded error estimate. Where that estimate is
# at float32 rounding level (the first step from Hairer's initial size on a
# smooth field: err ~ 1e-11 where the float64 value is ~ 1e-12), any two
# float32 evaluations of the same sums disagree on it, and so do the next
# step sizes and the dense output, by the interpolant's own error (~1e-4
# at rtol 1e-3); the JAX solve jitted and run eagerly disagree with each
# other the same way. The float32 cases give a first step whose estimate
# is the truncation error, and tolerances at which the interpolant is good
# to well under 1e-5. "pendulum-dataset" is the dataset generator's own
# configuration (AdaptiveConfig() on its rows and frame grid), run in
# float64 on both sides, where the estimates are far above rounding.
TIGHT = dict(rtol=1e-5, atol=1e-7)
ADAPTIVE_CASES = {
    "pendulum": dict(dt0=0.1, **TIGHT),
    "pendulum-step-to-saveat": dict(dt0=0.25, step_to_saveat=True),
    "pendulum-early-exit": dict(dt0=0.1, early_exit=True, chunk_size=4,
                                **TIGHT),
    "pendulum-dtmin-fail": dict(dt0=0.1, **TIGHT),
    "mlp": dict(dt0=0.3, **TIGHT),
    "mlp-dopri5": dict(dt0=0.05, **TIGHT),
    "pendulum-dataset": dict(),
}


@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_solve_adaptive_matches_jax(case):
    """The batched solve against the JAX solve under jax.vmap: per row the
    same accepted and rejected step counts and success flag, ys to atol
    1e-5. In "pendulum-dtmin-fail" one row has L = 0, so its every step
    is non-finite and rejected, dt shrinks by min_shrink until it is below
    dtmin and the row fails; the others succeed."""
    cfg_kw = ADAPTIVE_CASES[case]
    solver = "Dopri5" if "dopri5" in case else "Tsit5"
    if case == "pendulum-dataset":
        u0s, ps = pendulum_data.draw_initial_conditions(64)
        u0s, ps = u0s.astype(np.float64), ps.astype(np.float64)
        saveat = (np.arange(100) * pendulum_data.DT).astype(np.float64)
        jf, tf = jpend, pendulum_f
    elif case.startswith("pendulum"):
        u0s, ps, saveat = inputs(B=7, T=21, seed=12)
        if case.endswith("dtmin-fail"):
            ps[2, 0] = 0.0
        jf, tf = jpend, pendulum_f
    else:
        seed = 0 if case.endswith("dopri5") else 3
        u0s = np.random.default_rng(13 + seed).normal(size=(6, 3)).astype(
            np.float32)
        ps = np.zeros((6, 1), np.float32)
        saveat = (np.arange(16) * 0.1).astype(np.float32)
        jf, tf = jmlp_rhs(seed)
    jcfg, tcfg = jad.AdaptiveConfig(**cfg_kw), tad.AdaptiveConfig(**cfg_kw)
    js, ts = getattr(jrk, solver)(), getattr(trk, solver)()
    with jax.enable_x64(u0s.dtype == np.float64):
        ys_j, ok_j, st_j = jax.vmap(lambda u, p: jad.solve_adaptive(
            jf, js, u, p, jnp.asarray(saveat), jcfg))(jnp.asarray(u0s),
                                                      jnp.asarray(ps))
    assert ys_j.dtype == u0s.dtype
    ys_t, ok_t, st_t = tad.solve_adaptive(tf, ts, t_(u0s), t_(ps),
                                          t_(saveat), tcfg)
    assert ys_t.shape == tuple(ys_j.shape)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    for k in ("n_rhs_evals", "n_accepted", "n_rejected"):
        assert st_t[k].dtype == torch.int32
        np.testing.assert_array_equal(st_t[k].numpy(), np.asarray(st_j[k]),
                                      err_msg=k)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=0,
                               atol=ATOL, equal_nan=True)
    if case.endswith("dtmin-fail"):
        assert ok_t.tolist() == [True, True, False, True, True, True, True]
        assert st_t["n_rejected"].tolist()[2] == 9
        assert bool(torch.isnan(ys_t[2, 1:]).all())
    else:
        assert bool(ok_t.all())


def test_hairer_hinit_matches_jax():
    """Hairer's initial step, per row, against the JAX function under
    jax.vmap (rtol 2e-5: its d2 term differences two slopes)."""
    u0s, ps, _ = inputs(B=7, seed=12)
    t0 = jnp.float32(0.0)
    ref = jax.vmap(lambda u, p: jad._hairer_hinit(
        jpend, u, p, t0, jpend(u, p, t0), jnp.float32(1.0), 5, 1e-3,
        1e-6))(jnp.asarray(u0s), jnp.asarray(ps))
    got = tad._hairer_hinit(pendulum_f, t_(u0s), t_(ps), torch.zeros(7),
                            pendulum_f(t_(u0s), t_(ps), None),
                            torch.tensor(1.0), 5, 1e-3, 1e-6)
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5)


def test_solve_adaptive_stops_early_and_refuses_fixed_tableaus():
    """The loop stops once every row is done: the counters show far fewer
    attempts than the budget, and a budget one short of them fails the
    row. Tableaus without an error estimate (RK4, Euler) raise."""
    u0s, ps, saveat = inputs(B=3, T=11, seed=14)
    ys, ok, st = tad.solve_adaptive(pendulum_f, trk.Tsit5(), t_(u0s),
                                    t_(ps), t_(saveat))
    attempts = st["n_accepted"] + st["n_rejected"]
    assert bool(ok.all()) and int(attempts.max()) < 64
    n = int(attempts.max())
    _, ok2, _ = tad.solve_adaptive(
        pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat),
        tad.AdaptiveConfig(max_steps=n - 1))
    assert ok2.tolist() == (attempts <= n - 1).tolist()
    with pytest.raises(ValueError, match="error estimate"):
        tad.solve_adaptive(pendulum_f, trk.RK4(), t_(u0s), t_(ps),
                           t_(saveat))
    with pytest.raises(ValueError, match="error estimate"):
        tad.solve_adaptive(pendulum_f, trk.Euler(), t_(u0s), t_(ps),
                           t_(saveat))


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
    """odeint's fixed-grid Unrolled solve is solve_fixed_grid's; the options
    the port once refused now run and match JAX: adaptive stepping (float64,
    where both take the same steps: 1e-10), Unrolled(checkpoint=True) (the
    unrolled values exactly) and interp_stride (atol 1e-5)."""
    u0s, ps, saveat = inputs()
    opts = tadj.SolveOptions(adaptive=False, substeps=2, unroll=7)
    ys, _, _ = tadj.odeint(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps),
                           t_(saveat), opts)
    ref, _, _ = tsolve(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps),
                       t_(saveat), substeps=2)
    torch.testing.assert_close(ys, ref, rtol=0, atol=0)
    # RK4 has no error estimate: adaptive=True solves on the fixed grid
    tadj.odeint(pendulum_f, trk.RK4(), t_(u0s), t_(ps), t_(saveat))
    # adaptive stepping, per row, against the vmapped JAX odeint
    u64, p64, s64 = (a.astype(np.float64) for a in (u0s, ps, saveat))
    with jax.enable_x64(True):
        ys_j = jax.vmap(lambda u, p: jodeint(
            jpend, jrk.Tsit5(), u, p, jnp.asarray(s64))[0])(
                jnp.asarray(u64), jnp.asarray(p64))
        ys_j = np.asarray(ys_j)
    ys_a = tadj.odeint(pendulum_f, trk.Tsit5(), t_(u64), t_(p64),
                       t_(s64))[0]
    np.testing.assert_allclose(ys_a.numpy(), ys_j, rtol=0, atol=1e-10)
    # checkpointing changes no value
    ys_c = tadj.odeint(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat),
                       opts, tadj.Unrolled(checkpoint=True))[0]
    torch.testing.assert_close(ys_c, ref, rtol=0, atol=0)
    # macro-stepping, against the JAX strided solve
    ys_s = tsolve(pendulum_f, trk.Tsit5(), t_(u0s), t_(ps), t_(saveat),
                  interp_stride=2)[0]
    ys_js = jax.vmap(lambda u, p: jsolve(
        jpend, jrk.Tsit5(), u, p, jnp.asarray(saveat),
        interp_stride=2)[0])(jnp.asarray(u0s), jnp.asarray(ps))
    np.testing.assert_allclose(ys_s.numpy(), np.asarray(ys_js), rtol=0,
                               atol=ATOL)


def test_kernel_solver_rejects_rhs_without_device_functor():
    """A field without a hand-written functor is no longer refused: it is
    traced and runs on a generated one (on CPU tensors the plain version,
    equal to the tagged field's solve); the kernel still refuses a field it
    cannot lower (here a branch on data) with ValueError on either device,
    and a CPU tensor never reaches the kernel."""
    u0s, ps, saveat = inputs()

    def no_functor(u, p, t):
        return pendulum_f(u, p, t)

    ys = ode_cuda.solve_fixed_grid_batched(no_functor, trk.Tsit5(), t_(u0s),
                                           t_(ps), t_(saveat))[0]
    ref = ode_cuda.solve_fixed_grid_batched(pendulum_f, trk.Tsit5(),
                                            t_(u0s), t_(ps), t_(saveat))[0]
    assert torch.equal(ys, ref)
    assert ode_cuda.rhs_instance(no_functor, 2, 1).startswith("gen_")

    def branches(u, p, t):
        return pendulum_f(u, p, t) if u[0] > 0 else -u

    with pytest.raises(ValueError, match="node 'gt'"):
        ode_cuda.solve_fixed_grid_batched(branches, trk.Tsit5(), t_(u0s),
                                          t_(ps), t_(saveat))
    with pytest.raises(ValueError):    # a CPU tensor never reaches it
        ode_cuda.solve_fixed_grid_batched_cuda(pendulum_f, trk.Tsit5(),
                                               t_(u0s), t_(ps), t_(saveat))
