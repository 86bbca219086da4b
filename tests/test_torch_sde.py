"""Parity of the port's threefry keys, Brownian tree and SDE solvers
against the JAX package (``jax.random``, latentdiffeq/solve/brownian.py and
sde.py) on the CPU, on the same keys, and the port of the JAX package's SDE
property tests (tests/test_solve.py).

Tolerances: keys bit for bit; float32 normals 1e-6 (XLA's erfinv
polynomial written out; the two log1p implementations differ by an ulp),
float64 normals 1e-13; Brownian tree values 1e-6; one step of each stepper
1e-6; fixed-grid and adaptive solves 1e-5 with equal per-row step counts
and depths; gradients 1e-4 of each gradient's size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latentdiffeq as ldq
from latentdiffeq.solve import brownian as jb
from latentdiffeq.solve import sde as js
import latentdiffeq_torch as ldt
from latentdiffeq_torch import random as jr
from latentdiffeq_torch.solve import brownian as tb
from latentdiffeq_torch.solve import sde as ts

SOLVERS = ["EulerMaruyama", "StochasticHeun", "SRA1", "SRIW1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tk(key):
    """A JAX key array as the port's int64 key words."""
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def close(t, a, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol, equal_nan=True)


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def tpend(u, p, t):
    return torch.stack([u[..., 1], -10.0 / p[..., 0] * torch.sin(u[..., 0])],
                       dim=-1)


def jdiag(u, p, t):
    return 0.05 * u + 0.01


def tdiag(u, p, t):
    return 0.05 * u + 0.01


def jadd(u, p, t):
    return jnp.full_like(u, 0.01)


def tadd(u, p, t):
    return torch.full_like(u, 0.01)


def rows(B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 2)).astype(np.float32),
            rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32))


# ---------------------------------------------------------------------------
# threefry keys and normals


def test_prngkey_fold_in_split_bit_for_bit():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2 ** 31, 1000)
    jkeys = np.stack([np.asarray(jax.random.PRNGKey(int(s))) for s in seeds])
    tkeys = torch.stack([jr.PRNGKey(int(s)) for s in seeds])
    np.testing.assert_array_equal(tkeys.numpy(), jkeys.astype(np.int64))
    data = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64).astype(np.uint32)
    jf = jax.vmap(jax.random.fold_in)(jnp.asarray(jkeys), jnp.asarray(data))
    tf = jr.fold_in(tkeys, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
    js_ = jax.vmap(lambda k: jax.random.split(k, 5))(jnp.asarray(jkeys))
    np.testing.assert_array_equal(jr.split(tkeys, 5).numpy(),
                                  np.asarray(js_).astype(np.int64))
    assert jr.split(tkeys[0]).shape == (2, 2)
    assert jr.fold_in(tkeys[0], 7).shape == (2,)


@pytest.mark.parametrize("shape", [(100_000,), (3, 5, 7), ()])
def test_normal_float32_matches_jax(shape):
    key = jax.random.PRNGKey(3)
    z_j = np.asarray(jax.random.normal(key, shape, jnp.float32))
    z_t = jr.normal(tk(key), shape)
    assert z_t.dtype == torch.float32 and tuple(z_t.shape) == shape
    close(z_t, z_j, 1e-6)
    if shape == (100_000,):
        assert np.abs(z_j).max() > 4.0     # the tails are in the draw


def test_normal_batched_keys_and_float64_match_jax():
    keys = jax.random.split(jax.random.PRNGKey(9), 64)
    z_j = jax.vmap(lambda k: jax.random.normal(k, (2, 3)))(keys)
    close(jr.normal(tk(keys), (2, 3)), z_j, 1e-6)
    with jax.enable_x64(True):
        z64 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (50_000,),
                                           jnp.float64))
    z_t = jr.normal(tk(jax.random.PRNGKey(3)), (50_000,), torch.float64)
    assert z_t.dtype == torch.float64
    close(z_t, z64, 1e-13)
    with pytest.raises(TypeError):
        jr.normal(jr.PRNGKey(0), (2,), torch.float16)


# ---------------------------------------------------------------------------
# the Brownian tree


def test_interval_root_and_bridge_split_match_jax():
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    hs = np.array([0.05, 0.1, 0.5, 1.0, 2.0, 0.3], np.float32)
    w_j, i_j = jax.vmap(lambda k, h: jb.interval_root(k, h, (3,)))(keys, hs)
    w_t, i_t = tb.interval_root(tk(keys), torch.from_numpy(hs), (3,))
    close(w_t, w_j, 1e-6)
    close(i_t, i_j, 1e-6)
    out_j = jax.vmap(jb.bridge_split)(keys, w_j, i_j, hs)
    out_t = tb.bridge_split(tk(keys), w_t, i_t, torch.from_numpy(hs))
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-6)


@pytest.mark.parametrize("substeps", [1, 2, 8])
def test_bridge_increments_match_jax(substeps):
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    saveat = np.array([0.0, 0.05, 0.15, 0.2, 0.7], np.float32)
    w_j, i_j = jax.vmap(lambda k: jb.bridge_increments(
        k, jnp.asarray(saveat), substeps, (2,)))(keys)
    w_t, i_t = tb.bridge_increments(tk(keys), torch.from_numpy(saveat),
                                    substeps, (2,))
    assert tuple(w_t.shape) == (4, 4, substeps, 2)
    close(w_t, w_j, 1e-6)
    close(i_t, i_j, 1e-6)
    with pytest.raises(ValueError, match="power of 2"):
        tb.bridge_increments(tk(keys), torch.from_numpy(saveat), 3, (2,))


@pytest.mark.parametrize("depth_cap", [0, 3, 6])
def test_vbt_query_matches_jax(depth_cap):
    rng = np.random.default_rng(depth_cap)
    B = 32
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    idx = rng.integers(0, 10, B)
    ks = rng.integers(0, depth_cap + 1, B)
    ms = np.array([rng.integers(0, 2 ** k) for k in ks])
    hs = rng.uniform(0.01, 1.0, B).astype(np.float32)
    w_j, i_j = jax.vmap(lambda k, a, h, kk, mm: jb.vbt_query(
        k, a, h, kk, mm, (2,), depth_cap))(keys, idx, hs, ks, ms)
    w_t, i_t = tb.vbt_query(tk(keys), torch.from_numpy(idx),
                            torch.from_numpy(hs), torch.from_numpy(ks),
                            torch.from_numpy(ms), (2,), depth_cap)
    close(w_t, w_j, 1e-6)
    close(i_t, i_j, 1e-6)


# ---------------------------------------------------------------------------
# the steppers and the solves


@pytest.mark.parametrize("name", SOLVERS)
def test_one_step_matches_jax(name):
    u0, p = rows(5)
    rng = np.random.default_rng(1)
    dw = rng.normal(0, 0.2, (5, 2)).astype(np.float32)
    i10 = rng.normal(0, 0.01, (5, 2)).astype(np.float32)
    jstep, _ = js._stepper(getattr(js, name)())
    tstep, _ = ts._stepper(getattr(ts, name)())
    dt = np.float32(0.05)
    y_j, e_j = jax.vmap(lambda y, q, a, b: jstep(
        jpend, jdiag, y, q, 0.1, dt, a, b))(u0, p, dw, i10)
    y_t, e_t = tstep(tpend, tdiag, torch.from_numpy(u0), torch.from_numpy(p),
                     torch.tensor(0.1), torch.tensor(dt),
                     torch.from_numpy(dw), torch.from_numpy(i10))
    close(y_t, y_j, 1e-6)
    assert (e_t is None) == (e_j is None)
    if e_t is not None:
        close(e_t, e_j, 1e-6)


def jfixed(solver, u0, p, saveat, keys, substeps, g=jdiag):
    return jax.vmap(lambda a, b, k: js.solve_sde_fixed_grid(
        jpend, g, solver, a, b, jnp.asarray(saveat), k,
        substeps=substeps))(u0, p, keys)


@pytest.mark.parametrize("substeps", [1, 4])
@pytest.mark.parametrize("name", SOLVERS)
def test_fixed_grid_matches_jax(name, substeps):
    u0, p = rows(6)
    saveat = (np.arange(21) * 0.05).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    y_j, ok_j, st_j = jfixed(getattr(js, name)(), u0, p, saveat, keys,
                             substeps)
    y_t, ok_t, st_t = ts.solve_sde_fixed_grid(
        tpend, tdiag, getattr(ts, name)(), torch.from_numpy(u0),
        torch.from_numpy(p), torch.from_numpy(saveat), tk(keys),
        substeps=substeps)
    close(y_t, y_j, 1e-5)
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    for k, v in st_j.items():
        assert st_t[k].tolist() == np.asarray(v).tolist(), k


def adaptive_pair(name, cfg_kw, B=6, T=21, g=(jdiag, tdiag), seed=0):
    u0, p = rows(B, seed)
    saveat = (np.arange(T) * 0.05).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6 + seed), B)
    out_j = jax.vmap(lambda a, b, k: js.solve_sde_adaptive(
        jpend, g[0], getattr(js, name)(), a, b, jnp.asarray(saveat), k,
        js.SDEAdaptiveConfig(**cfg_kw)))(u0, p, keys)
    out_t = ts.solve_sde_adaptive(
        tpend, g[1], getattr(ts, name)(), torch.from_numpy(u0),
        torch.from_numpy(p), torch.from_numpy(saveat), tk(keys),
        ts.SDEAdaptiveConfig(**cfg_kw))
    return out_j, out_t


ADAPTIVE_CASES = [
    dict(rtol=1e-3, atol=1e-3, max_steps=200, depth_cap=6),
    dict(rtol=1e-4, atol=1e-5, max_steps=256, depth_cap=4),   # capped rows
    dict(max_steps=256, depth_cap=6, max_steps_per_interval=6),
    dict(rtol=1e-3, atol=1e-3, max_steps=40, depth_cap=6),    # budget out
    dict(rtol=1e-3, atol=1e-3, max_steps=100, depth_cap=6, early_exit=True,
         chunk_size=16),
]


@pytest.mark.parametrize("case", range(len(ADAPTIVE_CASES)))
@pytest.mark.parametrize("name", ["SRA1", "SRIW1"])
def test_adaptive_matches_jax_with_equal_step_counts(name, case):
    (y_j, ok_j, st_j), (y_t, ok_t, st_t) = adaptive_pair(
        name, ADAPTIVE_CASES[case])
    close(y_t, y_j, 1e-5)
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    for k in ("n_accepted", "n_rejected", "max_depth", "n_rhs_evals"):
        assert st_t[k].tolist() == np.asarray(st_j[k]).tolist(), k


def grad_pair(solve_j, solve_t, u0, p, w):
    def jloss(a, b):
        return jnp.sum(solve_j(a, b) * w)

    g_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(p))
    ut = torch.from_numpy(u0).requires_grad_()
    pt = torch.from_numpy(p).requires_grad_()
    g_t = torch.autograd.grad((solve_t(ut, pt) * torch.from_numpy(w)).sum(),
                              [ut, pt])
    for a, b in zip(g_t, g_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("name", ["SRA1", "SRIW1"])
def test_fixed_grid_gradients_match_jax_vjp(name, checkpoint):
    u0, p = rows(4, 3)
    saveat = (np.arange(16) * 0.05).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    w = np.random.default_rng(2).normal(size=(4, 16, 2)).astype(np.float32)
    grad_pair(
        lambda a, b: jfixed(getattr(js, name)(), a, b, saveat, keys, 2)[0],
        lambda a, b: ts.solve_sde_fixed_grid(
            tpend, tdiag, getattr(ts, name)(), a, b,
            torch.from_numpy(saveat), tk(keys), substeps=2,
            checkpoint=checkpoint)[0],
        u0, p, w)


@pytest.mark.parametrize("name", ["SRA1", "SRIW1"])
def test_adaptive_gradients_match_jax_vjp(name):
    u0, p = rows(4, 4)
    saveat = (np.arange(16) * 0.05).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(10), 4)
    w = np.random.default_rng(3).normal(size=(4, 16, 2)).astype(np.float32)
    kw = dict(rtol=1e-3, atol=1e-3, max_steps=128, depth_cap=5)
    grad_pair(
        lambda a, b: jax.vmap(lambda u, q, k: js.solve_sde_adaptive(
            jpend, jdiag, getattr(js, name)(), u, q, jnp.asarray(saveat), k,
            js.SDEAdaptiveConfig(**kw))[0])(a, b, keys),
        lambda a, b: ts.solve_sde_adaptive(
            tpend, tdiag, getattr(ts, name)(), a, b,
            torch.from_numpy(saveat), tk(keys),
            ts.SDEAdaptiveConfig(**kw))[0],
        u0, p, w)


# ---------------------------------------------------------------------------
# the JAX package's SDE property tests (tests/test_solve.py), on the port


def test_sde_additive_ou_moments():
    """OU process dy = -a y dt + s dW (test_solve.py:237)."""
    a, s = 1.0, 0.5
    prob = ldt.SDEProblem(f=lambda u, p, t: -p[..., :1] * u,
                          g=lambda u, p, t: torch.full_like(u, s),
                          u0=torch.ones(1), tspan=(0.0, 2.0),
                          p=torch.tensor([a]))
    saveat = torch.linspace(0.0, 2.0, 41)
    n = 4096
    for solver in (ldt.EulerMaruyama(), ldt.StochasticHeun()):
        ens = ldt.solve_ensemble(prob, solver, u0s=torch.ones(n, 1),
                                 ps=torch.full((n, 1), a), saveat=saveat,
                                 key=jr.PRNGKey(0), substeps=4)
        y_end = ens.ys[:, -1, 0].numpy()
        assert abs(y_end.mean() - np.exp(-a * 2.0)) < 0.02
        var_exact = s ** 2 / (2 * a) * (1 - np.exp(-2 * a * 2.0))
        assert abs(y_end.var() - var_exact) < 0.02


def test_sde_heun_stronger_than_em_on_drift():
    """Zero noise: Heun is 2nd order, EM 1st (test_solve.py:264)."""
    lam, u0 = -0.7, torch.tensor([1.3])
    prob = ldt.SDEProblem(f=lambda u, p, t: p * u,
                          g=lambda u, p, t: torch.zeros_like(u), u0=u0,
                          tspan=(0.0, 1.0), p=torch.tensor([lam]))
    saveat = torch.linspace(0.0, 1.0, 6)
    exact = u0[None] * torch.exp(lam * saveat)[:, None]
    errs = {}
    for solver in (ldt.EulerMaruyama(), ldt.StochasticHeun()):
        sol = ldt.solve(prob, solver, saveat=saveat, key=jr.PRNGKey(1),
                        substeps=8)
        errs[type(solver).__name__] = float((sol.ys - exact).abs().max())
    assert errs["StochasticHeun"] < errs["EulerMaruyama"] / 10


def test_brownian_bridge_refinement_consistency():
    """The same key at any power-of-two refinement samples the same path,
    and vbt_query's cells are bridge_increments' (test_solve.py:283)."""
    key = jr.PRNGKey(0)
    saveat = torch.tensor([0.0, 0.5, 1.2])
    w1, i1 = tb.bridge_increments(key, saveat, 1, (3,))
    w2, i2 = tb.bridge_increments(key, saveat, 2, (3,))
    w4, i4 = tb.bridge_increments(key, saveat, 4, (3,))
    torch.testing.assert_close(w2.sum(1), w1.sum(1), rtol=0, atol=1e-6)
    torch.testing.assert_close(w4.sum(1), w1.sum(1), rtol=0, atol=1e-6)
    torch.testing.assert_close(i2[0, 0] + i2[0, 1] + 0.25 * w2[0, 0],
                               i1[0, 0], rtol=0, atol=1e-6)
    one = lambda v: torch.tensor([v])  # noqa: E731
    for k, m, wref, iref in [(0, 0, w1, i1), (1, 1, w2, i2), (2, 3, w4, i4)]:
        wq, iq = tb.vbt_query(key[None], one(0), one(0.5), one(k), one(m),
                              (3,), depth_cap=4)
        torch.testing.assert_close(wq[0], wref[0, m], rtol=0, atol=1e-6)
        torch.testing.assert_close(iq[0], iref[0, m], rtol=0, atol=1e-6)


def test_brownian_bridge_marginal_stats():
    """W ~ N(0, h), Var I = h^3/3, Cov(W, I) = h^2/2; refined halves
    independent with Var h/2 (test_solve.py:307)."""
    keys = jr.split(jr.PRNGKey(1), 20000)
    grid = torch.tensor([0.0, 1.0])
    W, I = tb.bridge_increments(keys, grid, 1, ())
    W, I = W.numpy().ravel(), I.numpy().ravel()
    assert abs(W.var() - 1.0) < 0.03
    assert abs(I.var() - 1 / 3) < 0.02
    assert abs(np.cov(W, I)[0, 1] - 0.5) < 0.02
    W2 = tb.bridge_increments(keys, grid, 2, ())[0][:, 0, :].numpy()
    assert np.all(np.abs(W2.var(axis=0) - 0.5) < 0.03)
    assert abs(np.corrcoef(W2[:, 0], W2[:, 1])[0, 1]) < 0.03


def test_sde_adaptive_matches_fine_fixed_grid():
    """Adaptive SRA1 sits on the fine fixed grid's path (test_solve.py:411);
    ensembles step each row on its own."""
    u0, p = torch.tensor([0.3, 0.2]), torch.tensor([1.5])
    saveat = torch.arange(20) * 0.05
    key = jr.PRNGKey(11)
    ys_f, ok_f, _ = ts.solve_sde_fixed_grid(tpend, tadd, ts.SRA1(), u0, p,
                                            saveat, key, substeps=64)
    ys_a, ok_a, st = ts.solve_sde_adaptive(
        tpend, tadd, ts.SRA1(), u0, p, saveat, key,
        ts.SDEAdaptiveConfig(rtol=1e-4, atol=1e-6))
    assert bool(ok_f) and bool(ok_a)
    assert float((ys_a - ys_f).abs().max()) < 2e-3
    assert int(st["n_accepted"]) >= 19
    prob = ldt.SDEProblem(f=tpend, g=tadd, u0=u0, tspan=(0.0, 0.95), p=p)
    ens = ldt.solve_ensemble(prob, ldt.SRA1(), u0s=torch.stack([u0, u0 / 2]),
                             ps=torch.stack([p, 2 * p]), saveat=saveat,
                             key=key, adaptive=True, rtol=1e-3, atol=1e-5)
    assert bool(ens.success.all()) and not bool(ens.ys.isnan().any())


def test_sde_adaptive_failure_semantics():
    """A drift blow-up refines to the depth cap and fails
    (test_solve.py:447); the unreached save points stay NaN."""
    ys, ok, _ = ts.solve_sde_adaptive(
        lambda u, p, t: u * u * 3.0, tadd, ts.SRA1(), torch.tensor([2.0]),
        torch.zeros(1), torch.linspace(0.0, 5.0, 10), jr.PRNGKey(0),
        ts.SDEAdaptiveConfig(max_steps=256, depth_cap=8))
    assert not bool(ok)
    assert bool(ys[-1].isnan().all())


def test_sde_adaptive_early_exit_matches_bounded_scan():
    """early_exit runs the same masked body (test_solve.py:594)."""
    saveat = torch.linspace(0.0, 2.0, 40)
    u0s = torch.tensor([[0.3, 0.2], [1.5, -0.5]])
    ps = torch.tensor([[1.0], [2.0]])
    keys = jr.split(jr.PRNGKey(0), 2)
    out = [ts.solve_sde_adaptive(tpend, tadd, ts.SRA1(), u0s, ps, saveat,
                                 keys, ts.SDEAdaptiveConfig(**kw))
           for kw in (dict(max_steps=256, depth_cap=6),
                      dict(max_steps=256, depth_cap=6, early_exit=True,
                           chunk_size=16))]
    (ys_a, ok_a, st_a), (ys_b, ok_b, st_b) = out
    assert bool(ok_a.all()) and bool(ok_b.all())
    torch.testing.assert_close(ys_a, ys_b, rtol=0, atol=0)
    assert st_a["n_accepted"].tolist() == st_b["n_accepted"].tolist()


def test_sde_adaptive_depth0_equals_fixed_grid_incl_grads():
    """Loose tolerances keep every step a depth-0 cell: the adaptive solve
    is the fixed grid, its values bit for bit (test_solve.py:624). The
    gradients agree to 1e-5 of their size, not bit for bit as in JAX:
    autograd sums the several contributions to a state's gradient in the
    order of its graph, and the masked loop's graph is another than the
    fixed grid's."""
    saveat = torch.linspace(0.0, 4.95, 100)
    key = jr.PRNGKey(7)
    cfg = ts.SDEAdaptiveConfig(rtol=1e-1, atol=1e-1, max_steps=256,
                               depth_cap=6)

    def run(adaptive):
        u0 = torch.tensor([0.8, -0.2], requires_grad=True)
        p = torch.tensor([1.4], requires_grad=True)
        if adaptive:
            ys, _, st = ts.solve_sde_adaptive(tpend, tadd, ts.SRA1(), u0, p,
                                              saveat, key, cfg)
        else:
            ys, _, st = ts.solve_sde_fixed_grid(tpend, tadd, ts.SRA1(), u0,
                                                p, saveat, key)
        loss = (ys ** 2).sum()
        return loss.detach(), torch.autograd.grad(loss, [u0, p]), st

    la, ga, st_a = run(True)
    lf, gf, st_f = run(False)
    assert int(st_a["n_rejected"]) == 0
    assert int(st_a["n_accepted"]) == int(st_f["n_accepted"])
    assert float(la) == float(lf)
    for a, b in zip(ga, gf):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_sde_adaptive_rejects_methods_without_embedded_error():
    """test_solve.py:781."""
    with pytest.raises(ValueError, match="embedded error"):
        ts.solve_sde_adaptive(lambda u, p, t: u, lambda u, p, t: u,
                              ts.EulerMaruyama(), torch.ones(1),
                              torch.zeros(1), torch.linspace(0.0, 1.0, 3),
                              jr.PRNGKey(0), ts.SDEAdaptiveConfig())


def test_solver_exports_and_config_match_jax():
    assert ldt.SOSRI is ldt.SRIW1
    jf = {f.name: f.default for f in
          js.SDEAdaptiveConfig.__dataclass_fields__.values()}
    tf = {f.name: f.default for f in
          ts.SDEAdaptiveConfig.__dataclass_fields__.values()}
    assert jf == tf
    assert ldq.SDEAdaptiveConfig is js.SDEAdaptiveConfig
