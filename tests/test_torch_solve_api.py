"""Parity of the port's solve API against the JAX package, on the CPU:
ODEProblem / SDEProblem / remake / Solution (and SDE problems through
solve and solve_ensemble on JAX's Brownian path: 1e-5, equal step counts),
make_options (and its warning),
autosize_max_steps, solve, solve_ensemble (NaN-fill, summed counters),
macro-stepping (interp_stride with a remainder), checkpointed fixed-grid
solves, odeint's adaptive stepping, and the data helpers the JAX root
exports.

Adaptive solves are compared in float64, where both packages take the same
steps (1e-10); in float32 the step controller reads error estimates at
rounding level on the first step and the two drift apart by the
interpolant's error (tests/test_torch_solve.py says why). Fixed-grid and
strided solves are compared in float32 at 1e-5, their gradients at 1e-5 of
each gradient's size; checkpointing must change no value and no gradient.
"""
import dataclasses
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latentdiffeq as ldq
from latentdiffeq.solve.adaptive import AdaptiveConfig as JAdaptiveConfig
from latentdiffeq.solve.fixed import solve_fixed_grid as jsolve
from latentdiffeq.train import data as jdata
import latentdiffeq_torch as ldt
from latentdiffeq_torch.pendulum import pendulum_f, spendulum_g
from latentdiffeq_torch.solve.fixed import solve_fixed_grid as tsolve
from latentdiffeq_torch.train import data as tdata


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def jblowup(u, p, t):
    return u * u * p[0]


def tblowup(u, p, t):
    return u * u * p[..., 0:1]


def inputs(B=5, T=25, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    u0s = rng.uniform(-1, 1, (B, 2)).astype(dtype)
    ps = rng.uniform(1, 2, (B, 1)).astype(dtype)
    saveat = (np.arange(T) * 0.05).astype(dtype)
    return u0s, ps, saveat


def t_(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol,
                               atol=atol, equal_nan=True)


def test_problems_remake_and_solution():
    prob = ldt.ODEProblem(u0=torch.zeros(2), tspan=(0.0, 1.0),
                          p=torch.ones(1), f=pendulum_f)
    p2 = ldt.remake(prob, p=torch.full((1,), 2.0), tspan=(0.0, 2.0))
    assert p2.f is pendulum_f and p2.tspan == (0.0, 2.0)
    assert p2.u0 is prob.u0 and float(p2.p) == 2.0
    assert prob.remake(f=tblowup).f is tblowup
    sde = ldt.SDEProblem(u0=torch.zeros(2), tspan=(0.0, 1.0), p=None,
                         f=pendulum_f, g=pendulum_f)
    assert sde.remake(u0=torch.ones(2)).g is pendulum_f
    sol = ldt.Solution(ts=1, ys=2, success=3, stats={})
    assert (sol.ts, sol.ys, sol.success) == (1, 2, 3)
    for call in (lambda: ldt.solve(sde, saveat=torch.arange(3.0)),
                 lambda: ldt.solve_ensemble(sde, u0s=torch.zeros(2, 2),
                                            ps=None,
                                            saveat=torch.arange(3.0))):
        with pytest.raises(ValueError, match="PRNG `key`"):
            call()
    # SDE problems solve on the JAX package's Brownian path for the key
    u0 = np.array([0.3, 0.2], np.float32)
    p = np.array([1.5], np.float32)
    u0s = np.stack([u0, 0.5 * u0, -u0])
    ps = np.stack([p, 2 * p, 0.7 * p])
    saveat = (np.arange(16) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jprob = ldq.SDEProblem(f=jpend, g=lambda u, p, t: jnp.full_like(u, 0.01),
                           u0=jnp.asarray(u0), tspan=(0.0, 0.75),
                           p=jnp.asarray(p))
    tprob = ldt.SDEProblem(f=pendulum_f, g=spendulum_g, u0=t_(u0),
                           tspan=(0.0, 0.75), p=t_(p))
    for kw in (dict(substeps=2), dict(substeps=1, checkpoint=True),
               dict(adaptive=True, rtol=1e-4, atol=1e-5, max_steps=128,
                    depth_cap=5)):
        js = ldq.solve(jprob, saveat=jnp.asarray(saveat), key=key, **kw)
        ts = ldt.solve(tprob, saveat=t_(saveat), key=np.asarray(key), **kw)
        close(ts.ys, js.ys, 1e-5)
        je = ldq.solve_ensemble(jprob, ldq.SRA1(), u0s=jnp.asarray(u0s),
                                ps=jnp.asarray(ps),
                                saveat=jnp.asarray(saveat), key=key, **kw)
        te = ldt.solve_ensemble(tprob, ldt.SRA1(), u0s=t_(u0s), ps=t_(ps),
                                saveat=t_(saveat),
                                key=ldt.random.PRNGKey(4), **kw)
        close(te.ys, je.ys, 1e-5)
        assert te.success.tolist() == np.asarray(je.success).tolist()
        for name, v in je.stats.items():
            assert int(te.stats[name]) == int(v), (kw, name)
    with pytest.raises(TypeError, match="unsupported SDE"):
        ldt.solve(tprob, saveat=t_(saveat), key=ldt.random.PRNGKey(0),
                  dt0=0.1)


OPTION_CASES = [dict(), dict(adaptive=False, substeps=4),
                dict(rtol=1e-5, atol=1e-8, max_steps=64, dt0=0.1,
                     early_exit=True, chunk_size=8),
                dict(adaptive=False, interp_stride=3, unroll=2)]


@pytest.mark.parametrize("kw", OPTION_CASES, ids=range(len(OPTION_CASES)))
def test_make_options_matches_jax(kw):
    """Every field, the adaptive configuration's too; interp_stride > 1
    warns in both (a known-bad training configuration)."""
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        jo = ldq.make_options(**kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        to = ldt.make_options(**kw)
    assert [w.category for w in wt] == [w.category for w in wj]
    assert len(wt) == (1 if kw.get("interp_stride", 1) > 1 else 0)
    if wt:
        assert issubclass(wt[0].category, UserWarning)
        assert "macro-stepping" in str(wt[0].message)
    for f in dataclasses.fields(jo):
        if f.name != "adaptive_cfg":
            assert getattr(to, f.name) == getattr(jo, f.name), f.name
    assert dataclasses.asdict(to.adaptive_cfg) == dataclasses.asdict(
        jo.adaptive_cfg)
    assert ldt.SolveOptions().adaptive_cfg == ldt.AdaptiveConfig()
    with pytest.raises(TypeError):
        ldt.solve(ldt.ODEProblem(u0=torch.zeros(2), tspan=None, p=None,
                                 f=pendulum_f),
                  saveat=torch.arange(3.0), options=to, substeps=2)


SOLVE_CASES = {"fixed": dict(adaptive=False, substeps=3),
               "adaptive": dict(rtol=1e-6, atol=1e-9),
               "strided": dict(adaptive=False, interp_stride=4)}


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_matches_jax(case):
    """One trajectory through ``solve``: ys, success and the counters."""
    kw = SOLVE_CASES[case]
    dtype = np.float64 if case == "adaptive" else np.float32
    u0s, ps, saveat = inputs(dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax.enable_x64(dtype == np.float64):
            sj = ldq.solve(ldq.ODEProblem(f=jpend, u0=jnp.asarray(u0s[0]),
                                          tspan=(0.0, 1.2),
                                          p=jnp.asarray(ps[0])),
                           ldq.Tsit5(), saveat=jnp.asarray(saveat), **kw)
            ys_j = np.asarray(sj.ys)
            st_j = {k: int(v) for k, v in sj.stats.items()}
        st = ldt.solve(ldt.ODEProblem(f=pendulum_f, u0=t_(u0s[0]),
                                      tspan=(0.0, 1.2), p=t_(ps[0])),
                       ldt.Tsit5(), saveat=saveat, **kw)
    assert st.ys.shape == (25, 2) and bool(st.success)
    close(st.ys, ys_j, 1e-10 if case == "adaptive" else 1e-5)
    assert {k: int(v) for k, v in st.stats.items()} == st_j
    close(st.ts, saveat, 0.0)


@pytest.mark.parametrize("case", ["fixed", "adaptive", "nan-fill"])
def test_solve_ensemble_matches_jax(case):
    """The batched solve against JAX's vmapped one: ys (NaN-filled where a
    row failed), success per row and the summed counters. In "nan-fill" the
    second row blows up before the end and runs out of steps."""
    if case == "nan-fill":
        u0s = np.array([[0.1], [2.0], [0.15]])
        ps = np.full((3, 1), 3.0)
        saveat = np.linspace(0.0, 2.0, 10)
        jf, tf, kw = jblowup, tblowup, dict(max_steps=64)
    else:
        u0s, ps, saveat = inputs(dtype=np.float64)
        jf, tf = jpend, pendulum_f
        kw = (dict(adaptive=False, substeps=2) if case == "fixed"
              else dict(rtol=1e-6, atol=1e-9))
    with jax.enable_x64(True):
        sj = ldq.solve_ensemble(
            ldq.ODEProblem(f=jf, u0=jnp.asarray(u0s[0]), tspan=(0.0, 2.0),
                           p=jnp.asarray(ps[0])),
            ldq.Tsit5(), u0s=jnp.asarray(u0s), ps=jnp.asarray(ps),
            saveat=jnp.asarray(saveat), **kw)
        ys_j, ok_j = np.asarray(sj.ys), np.asarray(sj.success)
        st_j = {k: int(v) for k, v in sj.stats.items()}
    st = ldt.solve_ensemble(
        ldt.ODEProblem(f=tf, u0=t_(u0s[0]), tspan=(0.0, 2.0), p=t_(ps[0])),
        ldt.Tsit5(), u0s=t_(u0s), ps=t_(ps), saveat=t_(saveat), **kw)
    np.testing.assert_array_equal(st.success.numpy(), ok_j)
    close(st.ys, ys_j, 1e-10)
    assert {k: int(v) for k, v in st.stats.items()} == st_j
    if case == "nan-fill":
        assert st.success.tolist() == [True, False, True]
        assert bool(torch.isnan(st.ys[1]).all())
        raw = ldt.solve_ensemble(
            ldt.ODEProblem(f=tf, u0=None, tspan=None, p=None), ldt.Tsit5(),
            u0s=t_(u0s), ps=t_(ps), saveat=t_(saveat), nan_fill=False,
            **kw)
        assert bool(torch.isfinite(raw.ys[1, 0]).all())


def test_autosize_max_steps_matches_jax():
    """The budget from a probe solve: ceil(1.5 x most attempts), at least
    16, at most the current budget; a failing probe leaves it."""
    u0s, ps, saveat = inputs(B=6, T=40, dtype=np.float64)
    kw = dict(rtol=1e-7, atol=1e-9, max_steps=512)
    with jax.enable_x64(True):
        jo = ldq.autosize_max_steps(jpend, ldq.Tsit5(), jnp.asarray(u0s),
                                    jnp.asarray(ps), jnp.asarray(saveat),
                                    ldq.make_options(**kw))
    to = ldt.autosize_max_steps(pendulum_f, ldt.Tsit5(), t_(u0s), t_(ps),
                                t_(saveat), ldt.make_options(**kw))
    assert 16 < to.adaptive_cfg.max_steps < 512
    assert to.adaptive_cfg.max_steps == jo.adaptive_cfg.max_steps
    assert dataclasses.replace(to.adaptive_cfg, max_steps=512) == \
        ldt.make_options(**kw).adaptive_cfg
    capped = ldt.make_options(rtol=1e-9, atol=1e-12, max_steps=20)
    assert ldt.autosize_max_steps(pendulum_f, ldt.Tsit5(), t_(u0s), t_(ps),
                                  t_(saveat), capped) is capped


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("solver", ["Tsit5", "Dopri5"])
@pytest.mark.parametrize("stride", [2, 3, 5])
def test_interp_stride_matches_jax(stride, solver, checkpoint):
    """Macro-stepping over 24 intervals (stride 5 leaves a remainder of 4
    single steps, stride 3 none, stride 2 none): ys and counters against
    the JAX solve under vmap, and the gradients of a weighted sum against
    jax.grad of the same."""
    u0s, ps, saveat = inputs(B=4)
    w = np.random.default_rng(1).normal(size=(4, 25, 2)).astype(np.float32)

    def jrun(u, p):
        return jax.vmap(lambda a, b: jsolve(
            jpend, getattr(ldq, solver)(), a, b, jnp.asarray(saveat),
            interp_stride=stride, checkpoint=checkpoint))(u, p)

    (ys_j, ok_j, st_j) = jrun(jnp.asarray(u0s), jnp.asarray(ps))
    gj = jax.grad(lambda u, p: jnp.sum(jrun(u, p)[0] * w), argnums=(0, 1))(
        jnp.asarray(u0s), jnp.asarray(ps))
    u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
    ys, ok, st = tsolve(pendulum_f, getattr(ldt, solver)(), u, p,
                        t_(saveat), interp_stride=stride,
                        checkpoint=checkpoint)
    close(ys, ys_j, 1e-5)
    assert bool(ok.all()) and bool(np.all(ok_j))
    for k in st:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(st_j[k]))
    n_macro, rem = 24 // stride, 24 % stride
    assert int(st["n_rhs_evals"][0]) == 1 + n_macro * 6 + rem * 6
    gt = torch.autograd.grad((ys * t_(w)).sum(), [u, p])
    for a, b in zip(gt, gj):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * np.abs(b).max()


def test_interp_stride_refusals():
    u0s, ps, saveat = inputs(B=2)
    with pytest.raises(ValueError, match="substeps"):
        tsolve(pendulum_f, ldt.Tsit5(), t_(u0s), t_(ps), t_(saveat),
               interp_stride=2, substeps=2)
    with pytest.raises(ValueError, match="FSAL"):
        tsolve(pendulum_f, ldt.RK4(), t_(u0s), t_(ps), t_(saveat),
               interp_stride=2)


@pytest.mark.parametrize("stride,substeps", [(1, 1), (1, 4), (3, 1)])
def test_checkpoint_gradients_equal_unrolled_exactly(stride, substeps):
    """torch.utils.checkpoint recomputes each interval (each macro-step)
    in the backward with the same operations: the same values and the
    same gradients, bit for bit (JAX tests/test_adjoint.py:54)."""
    u0s, ps, saveat = inputs(B=3)
    w = t_(np.random.default_rng(2).normal(size=(3, 25, 2)).astype(
        np.float32))
    out = []
    for ck in (False, True):
        u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
        ys = ldt.odeint(pendulum_f, ldt.Tsit5(), u, p, t_(saveat),
                        ldt.SolveOptions(adaptive=False, substeps=substeps,
                                         interp_stride=stride),
                        ldt.Unrolled(checkpoint=ck))[0]
        out.append((ys,) + torch.autograd.grad((ys * w).sum(), [u, p]))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def jmlp(dim=3, hidden=8, seed=0):
    rng = np.random.default_rng(seed)
    W1 = rng.normal(size=(dim, hidden)) * 0.8
    b1 = rng.normal(size=hidden) * 0.3
    W2 = rng.normal(size=(hidden, dim)) * 0.8

    def jf(u, p, t):
        return jnp.tanh(u @ W1 + b1) @ W2 * p[0]

    def tf(u, p, t):
        return torch.tanh(u @ t_(W1) + t_(b1)) @ t_(W2) * p[..., 0:1]

    return jf, tf


@pytest.mark.parametrize("field", ["pendulum", "mlp"])
@pytest.mark.parametrize("solver", ["Tsit5", "Dopri5"])
def test_odeint_adaptive_matches_jax(field, solver):
    """odeint(adaptive=True) with per-row step control against the vmapped
    JAX odeint (float64): ys, counters per row, and the Unrolled
    gradients through the accepted steps."""
    if field == "pendulum":
        u0s, ps, saveat = inputs(B=4, dtype=np.float64)
        jf, tf = jpend, pendulum_f
    else:
        rng = np.random.default_rng(3)
        u0s = rng.normal(size=(4, 3))
        ps = rng.uniform(0.5, 1.5, (4, 1))
        saveat = np.arange(16) * 0.1
        jf, tf = jmlp()
    w = np.random.default_rng(4).normal(size=(4,) + (len(saveat),)
                                        + u0s.shape[1:])
    opts_kw = dict(rtol=1e-6, atol=1e-9, max_steps=128)

    def jrun(u, p):
        return jax.vmap(lambda a, b: ldq.odeint(
            jf, getattr(ldq, solver)(), a, b, jnp.asarray(saveat),
            ldq.make_options(**opts_kw)))(u, p)

    with jax.enable_x64(True):
        ys_j, ok_j, st_j = jrun(jnp.asarray(u0s), jnp.asarray(ps))
        gj = jax.grad(lambda u, p: jnp.sum(jrun(u, p)[0] * w),
                      argnums=(0, 1))(jnp.asarray(u0s), jnp.asarray(ps))
        ys_j, ok_j = np.asarray(ys_j), np.asarray(ok_j)
        st_j = {k: np.asarray(v) for k, v in st_j.items()}
        gj = [np.asarray(g) for g in gj]
    u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
    ys, ok, st = ldt.odeint(tf, getattr(ldt, solver)(), u, p, t_(saveat),
                            ldt.make_options(**opts_kw))
    close(ys, ys_j, 1e-10)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    for k in st:
        np.testing.assert_array_equal(st[k].numpy(), st_j[k], err_msg=k)
    assert int(st["n_rejected"].sum()) + int(st["n_accepted"].sum()) > 0
    for a, b in zip(torch.autograd.grad((ys * t_(w)).sum(), [u, p]), gj):
        close(a, b, 1e-9 * max(1.0, np.abs(b).max()))


def test_data_helpers_match_jax():
    """normalize/denormalize on tensors and arrays, and the numpy window
    sampler: the same generator gives the same windows."""
    x = np.random.default_rng(5).normal(size=(4, 30, 3)).astype(np.float32)
    xn_j, lo_j, hi_j = jdata.normalize_to_unit_segment(jnp.asarray(x))
    xn, lo, hi = tdata.normalize_to_unit_segment(t_(x))
    close(xn, xn_j, 1e-7)
    assert float(lo) == float(lo_j) and float(hi) == float(hi_j)
    close(tdata.denormalize_unit_segment(xn, lo, hi), x, 1e-6)
    xa, _, _ = ldt.normalize_to_unit_segment(x)
    np.testing.assert_allclose(xa, np.asarray(xn_j), rtol=0, atol=1e-7)
    rj, rt = np.random.default_rng(6), np.random.default_rng(6)
    for seq in (10, 29, 30, 40):
        assert ldt.rand_time(rt, 30, seq) == jdata.rand_time(rj, 30, seq)
        wt = ldt.time_loader(t_(x), 30, min(seq, 30), rt)
        wj = jdata.time_loader(x, 30, min(seq, 30), rj)
        close(wt, wj, 0.0)


def test_root_exports_the_jax_roots_ported_names():
    """The names of the JAX package root, as ``latentdiffeq_torch`` exports
    them, and every name in the ``__all__`` of the subpackages train, nn,
    solve, models, adjoint, ops, parallel and utils, less those with no
    port by design (listed below with the reason); ``tree_size`` counts
    what JAX's counts."""
    # JAX's pytree registration (a frozen dataclass as a pytree): the
    # port's layers are torch.nn.Modules
    pytree_only = {"module", "static_field"}
    missing = set(ldq.__all__) - set(ldt.__all__) - pytree_only
    assert not missing, missing
    for name in set(ldq.__all__) - pytree_only:
        assert hasattr(ldt, name), name
    assert ldt.AdaptiveConfig is not None and JAdaptiveConfig is not None
    # the subpackages' __all__ (sys.modules: the roots rebind ``solve`` to
    # the function), less the names that have no port by design
    by_design = {
        # JAX's fused epoch-block program: the port's Trainer steps one
        # batch at a time (train/trainer.py module docstring)
        "train": {"make_block_fn"},
        # the Pallas TPU kernels themselves; their ports are the CUDA
        # kernels' wrappers in ops/ (goku_heads, solve_fixed_grid_batched,
        # solve_neural_field)
        "ops": {"pallas_goku_heads", "pallas_solve_fixed_grid_batched",
                "pallas_solve_neural_field"},
        # JAX's names for the layout of one global array over a JAX mesh;
        # the port's ranks each hold their own tensors (parallel/mesh.py)
        "parallel": {"P", "NamedSharding"},
    }
    for sub in ("train", "nn", "solve", "models", "adjoint", "ops",
                "parallel", "utils"):
        jmod = sys.modules[f"latentdiffeq.{sub}"]
        tmod = sys.modules[f"latentdiffeq_torch.{sub}"]
        missing = (set(jmod.__all__) - set(getattr(tmod, "__all__", ()))
                   - by_design.get(sub, set()))
        assert not missing, (sub, missing)
        for name in set(jmod.__all__) - by_design.get(sub, set()):
            assert hasattr(tmod, name), (sub, name)
    from latentdiffeq.models import GOKUBasic, default_layers
    from latentdiffeq_torch.models import goku_default_layers
    from latentdiffeq_torch.pendulum import Pendulum
    small = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    layers = goku_default_layers(32, Pendulum(), device="cpu", **small)
    jlayers = default_layers(jax.random.PRNGKey(0), GOKUBasic(), 32,
                             ldq.models.ODEDynamics(), **small)
    assert ldt.tree_size(layers) == ldq.tree_size(jlayers) > 0
