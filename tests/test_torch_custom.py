"""Parity of the port's custom dynamics (Van der Pol, Kuramoto), their data
makers, ``nn.FrozenLinear`` and GOKU on them against the JAX package, on the
CPU. The JAX fields come from examples/custom_dynamics/custom.py (through
sys.path, as tests/test_models.py imports them).

Tolerances: the fields 1e-6 (the same float32 operations; the JAX sum over
oscillators may be taken in another order), the hand-written VJPs 1e-6 of
each value's size (atol and rtol 1e-6: VdP's VJP reaches ~50 where a float32
ulp is 4e-6), the RK solve's plain backward versions 1e-5 of each
gradient's size against jax.vjp of the Pallas kernel in interpret mode, the
GOKU forward and loss 1e-4 (a 100-wide resnet, 64 outputs, a 4-sub-step
solve), the data makers' x 2e-4 over 396 float32 steps.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "custom_dynamics"))

import custom  # noqa: E402
import train_kuramoto  # noqa: E402
import train_vdp  # noqa: E402

import latentdiffeq as ldq  # noqa: E402
from latentdiffeq import nn as jnn  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched  # noqa: E402
from latentdiffeq.solve import rk as jrk  # noqa: E402
from latentdiffeq.solve.fixed import solve_fixed_grid as jsolve  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train.checkpoint import (_path_str,  # noqa: E402
                                           load_checkpoint as jload)
from latentdiffeq_torch import custom_data  # noqa: E402
from latentdiffeq_torch import custom_dynamics as cdyn  # noqa: E402
from latentdiffeq_torch import (ODEProblem, make_options,  # noqa: E402
                                solve_ensemble)
from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.ops import ode_cuda  # noqa: E402
from latentdiffeq_torch.solve import rk as trk  # noqa: E402
from latentdiffeq_torch.train import losses, optim  # noqa: E402
from latentdiffeq_torch.train.checkpoint import (jax_param_paths,  # noqa: E402
                                                 load_checkpoint,
                                                 load_jax_params)

VDP_WINNER = os.path.join(ROOT, "benchmarks", "artifacts",
                          "vdp_mu4_winner.npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fields(name):
    """(JAX f, port f, state width) of each RHS under test."""
    if name == "vdp":
        return custom._vdp_f, cdyn.vdp_f, 2
    n = int(name.split("-")[0][len("kuramoto"):])
    spread = 0.5 if name.endswith("spread") else 0.0
    return (custom.Kuramoto(n, omega_spread=spread).f,
            cdyn.Kuramoto(n, omega_spread=spread).f, n)


RHS = ["vdp", "kuramoto4", "kuramoto10", "kuramoto10-spread", "kuramoto7"]


def draws(name, B, seed):
    """The examples' parameter ranges; phases far out on the line too."""
    rng = np.random.default_rng(seed)
    _, _, n = fields(name)
    if name == "vdp":
        u = rng.uniform(-2.5, 2.5, (B, 2))
        p = rng.uniform(0.5, 4.0, (B, 1))
    else:
        u = rng.uniform(-30.0, 30.0, (B, n))
        p = np.stack([rng.uniform(1, 3, B), rng.uniform(0.2, 2, B)], 1)
    return u.astype(np.float32), p.astype(np.float32)


def t_(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", RHS)
def test_custom_fields_match_jax(name):
    jf, tf, _ = fields(name)
    u, p = draws(name, 9, 0)
    ref = np.stack([np.asarray(jf(jnp.asarray(a), jnp.asarray(b), 0.0))
                    for a, b in zip(u, p)])
    got = tf(t_(u), t_(p), None).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", RHS)
def test_custom_vjps_match_jax(name):
    """RHS_VJP, the VJP each device functor computes, against jax.vjp."""
    jf, tf, n = fields(name)
    u, p = draws(name, 7, 1)
    kb = np.random.default_rng(2).normal(size=u.shape).astype(np.float32)
    vjp = ode_cuda.RHS_VJP[tf.device_rhs]
    gu, gp = vjp(t_(u), t_(p), t_(kb))
    for i in range(u.shape[0]):
        _, pull = jax.vjp(lambda a, b: jf(a, b, 0.0), jnp.asarray(u[i]),
                          jnp.asarray(p[i]))
        ju, jp = pull(jnp.asarray(kb[i]))
        np.testing.assert_allclose(gu[i].numpy(), np.asarray(ju), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(gp[i].numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-6)


def rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


@pytest.mark.parametrize("substeps", [1, 4])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("name", ["vdp", "kuramoto4", "kuramoto10",
                                  "kuramoto10-spread"])
def test_custom_backward_references_match_pallas_vjp(name, solver,
                                                     substeps):
    """The RK kernel's plain backward versions for the new functors (the
    interval maps and the affine sweep, and the step-by-step reverse sweep)
    over the plain forward's trajectory, against jax.vjp of
    pallas_solve_fixed_grid_batched in interpret mode (its custom_vjp).
    The Pallas kernel refuses a field that captures an array (the spread
    variant's offsets), so that one is held against jax.vjp of the vmapped
    plain solve."""
    jf, tf, n = fields(name)
    rng = np.random.default_rng(3)
    u0s, ps = draws(name, 4, 4)
    if name != "vdp":
        u0s = rng.uniform(-np.pi, np.pi, u0s.shape).astype(np.float32)
    saveat = (np.arange(8) * 0.1).astype(np.float32)
    g = rng.normal(size=(4, 8, n)).astype(np.float32)

    def run(u, p):
        if name.endswith("spread"):
            return jax.vmap(lambda a, b: jsolve(
                jf, getattr(jrk, solver)(), a, b, jnp.asarray(saveat),
                substeps=substeps)[0])(u, p)
        return pallas_solve_fixed_grid_batched(
            jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
            substeps=substeps, interpret=True)[0]

    ys_j, pull = jax.vjp(run, jnp.asarray(u0s), jnp.asarray(ps))
    du0_j, dp_j = pull(jnp.asarray(g))
    s = getattr(trk, solver)()
    ys = ode_cuda.solve_fixed_grid_batched_reference(
        tf, s, t_(u0s), t_(ps), t_(saveat), substeps=substeps)[0]
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        tf, s, t_(saveat), ys, t_(ps), substeps=substeps)
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J, r,
                                                                   t_(g))
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        tf, s, t_(saveat), ys, t_(ps), t_(g), substeps=substeps)
    for got in (two, sweep):
        assert rel(got[0], du0_j) <= 1e-5
        assert rel(got[1], dp_j) <= 1e-5


def test_kuramoto_widths_of_the_kernel():
    """Kuramoto's device functor is compiled for 4 and 10 oscillators: any
    other width raises ValueError naming them on the kernel route (before
    it looks at the device), while the plain route solves any width."""
    f = cdyn.kuramoto_f(7)
    u0s, ps = torch.zeros(3, 7), torch.ones(3, 2)
    saveat = torch.arange(5) * 0.1
    with pytest.raises(ValueError, match=r"\[4, 10\]"):
        ode_cuda.solve_fixed_grid_batched_cuda(f, trk.Tsit5(), u0s, ps,
                                               saveat)
    ys = ode_cuda.solve_fixed_grid_batched(f, trk.Tsit5(), u0s, ps,
                                           saveat)[0]
    assert ys.shape == (3, 5, 7) and bool(torch.isfinite(ys).all())
    assert ode_cuda.rhs_instance(cdyn.kuramoto_f(10), 10) == "kuramoto10"
    assert ode_cuda.rhs_instance(cdyn.vdp_f, 2) == "vdp"


# ---------------------------------------------------------------------------
# GOKU on Van der Pol and Kuramoto

def jax_vdp_model():
    vdp = custom.VanDerPol(options=ldq.make_options(adaptive=False,
                                                    substeps=4))
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), 64, vdp,
                               hidden_dim_resnet=100,
                               latent_to_diffeq_dim=100)
    return JModel.build(JGOKUBasic(), enc, dec)


def torch_model(diffeq, input_dim, use_kernels=False, **kw):
    enc, dec = goku_default_layers(input_dim, diffeq, device="cpu", **kw)
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=use_kernels,
                  use_kernel_solver=use_kernels), enc, dec)


@pytest.fixture(scope="module")
def vdp_winner():
    """(JAX model, port model) holding vdp_mu4_winner.npz's weights."""
    jm = jax_vdp_model()
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    tree, _ = jload(VDP_WINNER, {"key": jax.random.PRNGKey(0), "model": jm,
                                 "opt_state": opt.init(jm)})
    tm = torch_model(cdyn.VanDerPol(options=make_options(adaptive=False,
                                                         substeps=4)),
                     64, hidden_dim_resnet=100, latent_to_diffeq_dim=100)
    load_checkpoint(VDP_WINNER, tm)
    return tree["model"], tm


def noise_for(key, lv_j):
    """The (z0, theta) noise the JAX model draws from ``key``."""
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, lv.shape)))
                 for k, lv in zip((k1, k2), lv_j))


def test_goku_vdp_forward_and_loss_match_jax_on_winner(vdp_winner):
    jm, tm = vdp_winner
    x = np.random.default_rng(5).uniform(0, 1, (4, 20, 64)).astype(
        np.float32)
    t = (np.arange(20) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    (xh_j, z_j, (z0_j, th_j)), mu_j, lv_j, aux_j = jm(
        jnp.asarray(x), jnp.asarray(t), variational=True, key=key)
    eps = noise_for(key, lv_j)
    with torch.no_grad():
        (xh, z, (z0, th)), mu, lv, aux = tm(t_(x), t_(t), variational=True,
                                            eps=eps)
    for a, b in ((xh, xh_j), (z, z_j), (z0, z0_j), (th, th_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    assert int(aux["stats"]["n_rhs_evals"]) == int(
        aux_j["stats"]["n_rhs_evals"]) == 4 * 19 * 4 * 6
    lj, mj = jlosses.loss_batch(jm, jnp.asarray(x), jnp.asarray(t), 0.01,
                                variational=True, key=key)
    with torch.no_grad():
        lt, mt = losses.loss_batch(tm, t_(x), t_(t), 0.01, variational=True,
                                   eps=eps)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    np.testing.assert_allclose(float(mt["kl"]), float(mj["kl"]), rtol=1e-4)


def test_goku_vdp_kernel_switches_on_cpu_run_the_plain_path(vdp_winner):
    _, tm = vdp_winner
    tk = torch_model(cdyn.VanDerPol(options=make_options(adaptive=False,
                                                         substeps=4)),
                     64, use_kernels=True, hidden_dim_resnet=100,
                     latent_to_diffeq_dim=100)
    tk.load_state_dict(tm.state_dict())
    x = torch.rand(3, 12, 64, generator=torch.Generator().manual_seed(6))
    t = torch.arange(12) * 0.1
    with torch.no_grad():
        a = tm(x, t)[0][0]
        b = tk(x, t)[0][0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n", [4, 10])
def test_goku_kuramoto_matches_jax_from_jax_weights(n):
    """A narrow GOKU on Kuramoto (transform = sin) built from the JAX
    default_layers weights: forward, variational sample and loss."""
    kw = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    opts = ldq.make_options(adaptive=False, substeps=4)
    enc, dec = jdefault_layers(jax.random.PRNGKey(3), JGOKUBasic(), 24,
                               custom.Kuramoto(n, options=opts), **kw)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    tm = torch_model(cdyn.Kuramoto(n, options=make_options(
        adaptive=False, substeps=4)), 24, **kw)
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    x = np.random.default_rng(7).uniform(0, 1, (5, 15, 24)).astype(
        np.float32)
    t = (np.arange(15) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(12)
    (xh_j, z_j, _), _, lv_j, _ = jm(jnp.asarray(x), jnp.asarray(t),
                                    variational=True, key=key)
    eps = noise_for(key, lv_j)
    with torch.no_grad():
        (xh, z, _), _, _, aux = tm(t_(x), t_(t), variational=True, eps=eps)
    assert z.shape == (5, 15, n) and float(z.abs().max()) <= 1.0
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(xh.numpy(), np.asarray(xh_j), rtol=0,
                               atol=1e-4)
    lj, _ = jlosses.loss_batch(jm, jnp.asarray(x), jnp.asarray(t), 0.5,
                               variational=True, key=key)
    with torch.no_grad():
        lt, _ = losses.loss_batch(tm, t_(x), t_(t), 0.5, variational=True,
                                  eps=eps)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)


# ---------------------------------------------------------------------------
# The data makers

@pytest.fixture
def examples_on_training_grid(monkeypatch):
    """The examples' make_data solved as the port's is: on the
    training grid (make_options(adaptive=False, substeps=4)). Their own
    solve_ensemble call passes no options, i.e. float32 adaptive Tsit5 at
    rtol 1e-3, whose step decisions two implementations round differently
    (see latentdiffeq_torch/custom_data.py)."""
    def fixed(*args, **kw):
        return ldq.solve_ensemble(
            *args, options=ldq.make_options(adaptive=False, substeps=4),
            **kw)
    monkeypatch.setattr(train_vdp, "solve_ensemble", fixed)
    monkeypatch.setattr(train_kuramoto, "solve_ensemble", fixed)


def test_make_vdp_data_matches_example(examples_on_training_grid):
    xj, zj, mj, _ = train_vdp.make_data(n_traj=16, mu_max=4.0)
    xt, zt, mt, vdp = custom_data.make_vdp_data(n_traj=16, mu_max=4.0,
                                                device="cpu")
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(zt[:, 0].numpy(), zj[:, 0])  # the u0s
    assert xt.shape == (16, 100, 64) and xt.dtype == torch.float32
    assert float(xt.min()) == 0.0 and float(xt.max()) == 1.0
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=2e-4)
    assert vdp.options.substeps == 4 and not vdp.options.adaptive


def test_make_kuramoto_data_matches_example(examples_on_training_grid):
    xj, zj, thj, _, lj = train_kuramoto.make_data(n_traj=16,
                                                  return_lift=True)
    xt, zt, tht, kur, lt = custom_data.make_kuramoto_data(
        n_traj=16, return_lift=True, device="cpu")
    np.testing.assert_array_equal(tht.numpy(), thj)
    np.testing.assert_array_equal(lt["W"], lj["W"])
    np.testing.assert_array_equal(lt["b"], lj["b"])
    np.testing.assert_allclose(zt[:, 0].numpy(), zj[:, 0], rtol=0,
                               atol=1e-7)  # sin of the same u0s
    np.testing.assert_allclose([lt["mn"], lt["mx"]], [lj["mn"], lj["mx"]],
                               rtol=1e-5)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=2e-4)
    assert kur.transform is torch.sin and kur.z_dim == 10


def test_data_makers_solve_on_the_training_grid():
    """The trajectories are the port's solve_ensemble on the returned
    dynamics' own grid (fixed, 4 sub-steps), bit for bit; the stochastic
    data (SOSRI, 4 sub-steps, the Brownian path of PRNGKey(seed)) match the
    example's make_data on the same seed (z 1e-4 over 116 float32 SRIW1
    steps of multiplicative noise, x 2e-4)."""
    x, z, mus, vdp = custom_data.make_vdp_data(n_traj=4, T=30, device="cpu")
    saveat = torch.arange(30, dtype=torch.float32) * 0.1
    prob = ODEProblem(f=vdp.f, u0=z[0, 0], tspan=(0.0, float(saveat[-1])),
                      p=mus[0])
    ref = solve_ensemble(prob, vdp.solver, u0s=z[:, 0], ps=mus,
                         saveat=saveat, adaptive=False, substeps=4).ys
    torch.testing.assert_close(z, ref, rtol=0, atol=0)
    assert bool(torch.isfinite(x).all())
    xs, zs, ms, svdp = custom_data.make_vdp_data(
        n_traj=4, T=30, stochastic_sigma=0.05, device="cpu")
    xj, zj, mj, svdp_j = train_vdp.make_data(n_traj=4, T=30,
                                             stochastic_sigma=0.05)
    np.testing.assert_array_equal(ms.numpy(), mj)
    np.testing.assert_allclose(zs.numpy(), zj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(xs.numpy(), xj, rtol=0, atol=2e-4)
    assert svdp.adaptive == svdp_j.adaptive and svdp.g is not None
    assert not np.allclose(zs.numpy(), z.numpy())


# ---------------------------------------------------------------------------
# nn.FrozenLinear

def frozen_arrays(din=10, dout=64, seed=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(din, dout)).astype(np.float32),
            rng.normal(0, 0.3, dout).astype(np.float32))


def test_frozen_linear_matches_jax():
    W, b = frozen_arrays()
    jfl = jnn.FrozenLinear.from_arrays(W, b, jnn.relu, out_scale=0.1,
                                       out_shift=-0.2)
    tfl = tnn.FrozenLinear.from_arrays(W, b, tnn.relu, out_scale=0.1,
                                       out_shift=-0.2)
    x = np.random.default_rng(9).normal(size=(3, 5, 10)).astype(np.float32)
    np.testing.assert_allclose(tfl(t_(x)).numpy(), np.asarray(jfl(x)),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tnn.FrozenLinear.from_arrays(W, b[:3])


def test_frozen_linear_is_never_trained():
    """W and b are buffers: no parameters, untouched by autograd and by
    ADAMW's decoupled decay; the JAX weight bridge skips them (the JAX
    checkpoint has no leaves for them)."""
    W, b = frozen_arrays()
    kur = cdyn.Kuramoto(10, options=make_options(adaptive=False, substeps=4))
    enc, dec = goku_default_layers(64, kur, device="cpu",
                                   hidden_dim_resnet=16,
                                   latent_to_diffeq_dim=16)
    recon = tnn.FrozenLinear.from_arrays(W, b, tnn.relu)
    model = LatentDiffEqModel.build(GOKUBasic(), enc, (dec[0], dec[1], recon))
    assert list(recon.parameters()) == []
    assert not any("reconstructor" in p for p in jax_param_paths(model))
    opt = optim.adamw(model.parameters(), 1e-2, decay=0.5)
    x = torch.rand(4, 10, 64, generator=torch.Generator().manual_seed(1))
    t = torch.arange(10) * 0.1
    loss, _ = losses.loss_batch(model, x, t, 0.1, variational=False)
    loss.backward()
    opt.step()
    np.testing.assert_array_equal(recon.W.numpy(), W)
    np.testing.assert_array_equal(recon.b.numpy(), b)
    # the bridge loads every other leaf of the JAX stack
    jenc, jdec = jdefault_layers(
        jax.random.PRNGKey(1), JGOKUBasic(), 64,
        custom.Kuramoto(10, options=ldq.make_options(adaptive=False,
                                                     substeps=4)),
        hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    jfl = jnn.FrozenLinear.from_arrays(W, b, jnn.relu)
    jm = JModel.build(JGOKUBasic(), jenc, (jdec[0], jdec[1], jfl))
    load_jax_params(model, {_path_str(p): np.asarray(l) for p, l in
                            jax.tree_util.tree_flatten_with_path(jm)[0]})
    xs = np.asarray(x)
    xh_j = jm(jnp.asarray(xs), jnp.asarray(np.asarray(t, np.float32)))[0][0]
    with torch.no_grad():
        xh = model(x, t)[0][0]
    np.testing.assert_allclose(xh.numpy(), np.asarray(xh_j), rtol=0,
                               atol=1e-4)
