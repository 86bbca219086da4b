"""Parity of GOKU on stochastic dynamics against the JAX package, on the
CPU: the stochastic pendulum on the committed checkpoints
``benchmarks/artifacts/spendulum_pop4_winner.npz`` (fixed-grid SRA1) and
``spendulum_adaptive_winner.npz`` (adaptive SRA1), GOKU on the stochastic
Van der Pol (SOSRI, adaptive), the missing-key errors, and a few CPU
Trainer steps on a small stochastic-pendulum GOKU.

Both models get the same reparameterisation noise (JAX's normals of
``split(split(key)[0])``) and the same Brownian key (JAX's ``dkey =
split(key)[1]``). Tolerances: x_hat, z_hat and the ELBO 1e-4 (784 outputs
through a 200-wide resnet and a 20-point SDE solve), step counts equal, the
loss gradients 1e-4 of each gradient's size (or, where JAX's own float32
gradient is that far off, held against both packages' float64 solves: see
the gradient test).
"""
import copy
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))
sys.path.insert(0, os.path.join(ROOT, "examples", "custom_dynamics"))

import custom  # noqa: E402
from pendulum import SPendulum as JSPendulum  # noqa: E402

from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import goku as jgoku  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.solve.sde import SDEAdaptiveConfig as JCfg  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train.checkpoint import (_path_str,  # noqa: E402
                                           load_checkpoint as jload)
from latentdiffeq_torch import custom_dynamics as cdyn  # noqa: E402
from latentdiffeq_torch import pendulum_data  # noqa: E402
from latentdiffeq_torch import random as jr  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import SPendulum  # noqa: E402
from latentdiffeq_torch.solve import brownian as tb  # noqa: E402
from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig  # noqa: E402
from latentdiffeq_torch.train import (TrainConfig, Trainer,  # noqa: E402
                                      losses)
from latentdiffeq_torch.train.checkpoint import (jax_param_paths,  # noqa: E402
                                                 load_checkpoint,
                                                 load_jax_params)

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
# the checkpoint and the dynamics it was trained with (train_goku.py
# --diffeq spendulum [--adaptive]); at the trained tolerances (1e-2) every
# step of these inputs is a whole interval, so "adaptive-tight" also runs
# the adaptive winner at 1e-3, where rows refine and reject
ADAPTIVE = dict(max_steps=256, depth_cap=6, max_steps_per_interval=6)
CKPT = {"fixed": ("spendulum_pop4_winner.npz", {}),
        "adaptive": ("spendulum_adaptive_winner.npz", ADAPTIVE),
        "adaptive-tight": ("spendulum_adaptive_winner.npz",
                           dict(ADAPTIVE, rtol=1e-3, atol=1e-3))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dynamics(which):
    _, cfg = CKPT[which]
    if which == "fixed":
        return JSPendulum(), SPendulum()
    return (JSPendulum(adaptive=True, adaptive_cfg=JCfg(**cfg)),
            SPendulum(adaptive=True, adaptive_cfg=SDEAdaptiveConfig(**cfg)))


@pytest.fixture(scope="module", params=list(CKPT))
def winner(request):
    """(name, JAX model, port model) holding a stochastic-pendulum
    checkpoint's weights."""
    jd, td = dynamics(request.param)
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), 784, jd)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    path = os.path.join(ARTIFACTS, CKPT[request.param][0])
    tree, _ = jload(path, {"key": jax.random.PRNGKey(0), "model": jm,
                           "opt_state": joptim.adamw(
                               1e-3, 0.9, 0.999, 1e-3).init(jm)})
    tm = LatentDiffEqModel.build(
        GOKUBasic(), *goku_default_layers(784, td, device="cpu"))
    load_checkpoint(path, tm)
    return request.param, tree["model"], tm


@pytest.fixture(scope="module")
def video():
    """Four 20-frame pendulum videos (the port's renderer) and their grid."""
    _, _, _, frames = pendulum_data.generate_dataset(
        n_traj=4, seed=3, tspan=(0.0, 0.95), device="cpu")
    x = frames.reshape(4, 20, 784).numpy()
    return x, (np.arange(20) * 0.05).astype(np.float32)


def noise(key, mu_j):
    """JAX's reparameterisation noise and Brownian key for ``key``, as the
    port's eps and key."""
    skey, dkey = jax.random.split(key)
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, m.shape)))
                for k, m in zip(jax.random.split(skey), mu_j))
    dk = jr.split(torch.from_numpy(np.asarray(key).astype(np.int64)))[1]
    np.testing.assert_array_equal(dk.numpy(), np.asarray(dkey))
    return eps, dk


def close(t, a, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol)


def test_spendulum_forward_matches_jax_on_winner(winner, video):
    which, jm, tm = winner
    x, t = video
    key = jax.random.PRNGKey(7)
    (xh_j, z_j, _), mu_j, _, aux_j = jm(jnp.asarray(x), jnp.asarray(t),
                                        variational=True, key=key)
    eps, dk = noise(key, mu_j)
    with torch.no_grad():
        (xh, z, _), mu, _, aux = tm(torch.from_numpy(x), torch.from_numpy(t),
                                    variational=True, eps=eps, key=dk)
    for a, b in zip(mu, mu_j):
        close(a, b, 1e-4)
    assert xh.shape == (4, 20, 784)
    close(z, z_j, 1e-4)
    close(xh, xh_j, 1e-4)
    assert aux["success"].tolist() == np.asarray(aux_j["success"]).tolist()
    assert set(aux["stats"]) == set(aux_j["stats"])
    for k, v in aux_j["stats"].items():
        assert int(aux["stats"][k]) == int(v), k
    if which == "adaptive-tight":
        assert bool(aux["success"].all())
        assert int(aux["stats"]["n_rejected"]) > 0
        assert int(aux["stats"]["n_accepted"]) > 4 * 19


def port_loss_grads(tm, x, t, eps, key, dtype=torch.float32):
    """The port's ELBO (beta 0.5, variational, failed rows masked) and its
    gradients by JAX path, the model, inputs and noise in ``dtype``."""
    tm.zero_grad()
    loss, metrics = losses.loss_batch(
        tm, torch.from_numpy(x).to(dtype), torch.from_numpy(t).to(dtype),
        0.5, variational=True, eps=tuple(e.to(dtype) for e in eps), key=key,
        mask_failures=True)
    loss.backward()
    return loss.detach(), metrics, {
        path: p.grad.double().numpy()
        for path, p in zip(jax_param_paths(tm), tm.parameters())}


def jax_loss_grads(jm, x, t, key, dtype=jnp.float32):
    """JAX's ELBO gradients (beta 0.5, variational, failed rows masked) by
    leaf path, the model and inputs in ``dtype``."""
    def jloss(m):
        return jlosses.loss_batch(m, jnp.asarray(x, dtype),
                                  jnp.asarray(t, dtype), 0.5,
                                  variational=True, key=key,
                                  mask_failures=True)

    m = jax.tree_util.tree_map(lambda l: l.astype(dtype), jm)
    (l, metrics), g = jax.value_and_grad(jloss, has_aux=True)(m)
    return l, metrics, {_path_str(p): np.asarray(v, np.float64) for p, v in
                        jax.tree_util.tree_flatten_with_path(g)[0]}


def test_spendulum_elbo_and_gradients_match_jax(winner, video, monkeypatch):
    """The ELBO 1e-4; each gradient within 1e-4 of its size of JAX's.

    Referee: both packages in float64 on the same path (JAX's float32
    normals, cast), which must agree to 1e-9 of each gradient's size. A
    gradient whose JAX float32 value lies at least half the tolerance from
    that referee is float32-limited, and two float32 results on either
    side of it may be the tolerance apart: at most one such gradient a
    checkpoint may instead be within 1e-4 of its size of the referee. That
    is the adaptive winner's theta-head bias gradient, which sums rows
    that cancel (JAX 5.7e-5 and the port 6.8e-5 from float64)."""
    which, jm, tm = winner
    x, t = video
    key = jax.random.PRNGKey(11)
    l_j, m_j, g_j = jax_loss_grads(jm, x, t, key)
    mu_j = jm.encoder(jnp.asarray(x))[0]
    eps, dk = noise(key, mu_j)
    l_t, m_t, g_t = port_loss_grads(tm, x, t, eps, dk)
    assert np.isfinite(float(l_t))
    np.testing.assert_allclose(float(l_t), float(l_j), rtol=0, atol=1e-4)
    assert int(m_t["n_failed"]) == int(m_j["n_failed"])
    for k in ("rec", "kl"):
        np.testing.assert_allclose(float(m_t[k].detach()), float(m_j[k]), rtol=0,
                                   atol=1e-4)
    assert int(m_t["n_rhs_evals"]) == int(m_j["n_rhs_evals"])
    # the float64 referee: both packages on one path, JAX's float32
    # normals cast (eps is made so already); the JAX GOKU casts the solve to
    # float32 (latentdiffeq/models/goku.py:102-108), which it lifts
    jnormal = jax.random.normal

    def normals32(k, shape, dtype):
        z = jax.vmap(lambda kk: jnormal(kk, (2,) + tuple(shape)))(
            jnp.asarray(k.reshape(-1, 2).numpy().astype(np.uint32)))
        z = torch.from_numpy(np.array(z, np.float32)).to(dtype)
        return z.reshape(k.shape[:-1] + z.shape[1:]).unbind(k.dim() - 1)

    monkeypatch.setattr(tb, "_normals", normals32)
    g64 = port_loss_grads(copy.deepcopy(tm).double(), x, t, eps, dk,
                          torch.float64)[2]
    monkeypatch.setattr(jax.random, "normal", lambda k, shape=(), dtype=None:
                        jnormal(k, shape, jnp.float32).astype(jnp.float64))
    monkeypatch.setattr(jgoku, "jnp", types.SimpleNamespace(
        **{n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
        | {"float32": jnp.float64}))
    with jax.enable_x64(True):
        j64 = jax_loss_grads(jm, x, t, key, jnp.float64)[2]
    limited = []
    for path, a in g_t.items():
        b, ref = g_j[path], j64[path]
        assert np.isfinite(a).all(), (which, path)
        size = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(g64[path], ref, rtol=0, atol=1e-9 * size,
                                   err_msg=f"{which} {path}")
        if np.abs(a - b).max() <= 1e-4 * size:
            continue
        e_port, e_jax = (np.abs(a - ref).max() / size,
                         np.abs(b - ref).max() / size)
        assert e_jax >= 0.5e-4 and e_port <= 1e-4, (which, path, e_port,
                                                     e_jax)
        limited.append(path)
    assert len(limited) <= 1, (which, limited)


def small_pair(jd, td, seed=0, scale=0.3, d_in=24):
    """A small GOKU (input 24, widths 16/32) in both packages on the same
    random weights."""
    small = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    enc, dec = jdefault_layers(jax.random.PRNGKey(seed), JGOKUBasic(), d_in,
                               jd, **small)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    tm = LatentDiffEqModel.build(
        GOKUBasic(), *goku_default_layers(d_in, td, device="cpu", **small))
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


@pytest.mark.parametrize("adaptive", [True, False])
def test_goku_stochastic_vdp_matches_jax(adaptive):
    jm, tm = small_pair(custom.StochasticVanDerPol(adaptive=adaptive,
                                                   substeps=2),
                        cdyn.StochasticVanDerPol(adaptive=adaptive,
                                                 substeps=2))
    x = np.random.default_rng(1).uniform(0, 1, (5, 16, 24)).astype(
        np.float32)
    t = (np.arange(16) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    (xh_j, z_j, _), _, _, aux_j = jm(jnp.asarray(x), jnp.asarray(t),
                                     variational=False, key=key)
    with torch.no_grad():
        (xh, z, _), _, _, aux = tm(torch.from_numpy(x), torch.from_numpy(t),
                                   key=jr.as_key(np.asarray(key)))
    close(z, z_j, 1e-4)
    close(xh, xh_j, 1e-4)
    for k, v in aux_j["stats"].items():
        assert int(aux["stats"][k]) == int(v), k


def test_sde_goku_without_key_raises():
    jm, tm = small_pair(JSPendulum(), SPendulum())
    x = torch.rand(2, 6, 24)
    t = torch.arange(6) * 0.05
    for kw in (dict(), dict(variational=True)):
        with pytest.raises(ValueError, match="PRNG `key`"):
            tm(x, t, **kw)
    with pytest.raises(ValueError, match="PRNG `key`"):
        jm(jnp.asarray(x.numpy()), jnp.asarray(t.numpy()))
    # the RK kernel switch does not apply to SDE dynamics: same result
    tk = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(24, SPendulum(), device="cpu",
                             hidden_dim_resnet=16, latent_to_diffeq_dim=16))
    tk.load_state_dict(tm.state_dict())
    key = jr.PRNGKey(5)
    with torch.no_grad():
        torch.testing.assert_close(tk(x, t, key=key)[0][0],
                                   tm(x, t, key=key)[0][0], rtol=0, atol=0)


def test_trainer_sde_goku_descends():
    """A small stochastic-pendulum GOKU trains through the Trainer and the
    loss descends (tests/test_train.py:315): pathwise gradients through the
    bridge increments, a fresh Brownian key each step."""
    _, _, _, frames = pendulum_data.generate_dataset(
        n_traj=8, seed=0, tspan=(0.0, 1.45), device="cpu")
    x = frames.reshape(8, frames.shape[1], -1)
    tm = LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        784, SPendulum(), device="cpu", hidden_dim_resnet=64,
        latent_to_diffeq_dim=64))
    cfg = TrainConfig(batch_size=8, seq_len=20, epochs=60, seed=0,
                      variational=True, val_every_batch=False,
                      save_best=False, n_cycle=1, start_beta=0.0,
                      end_beta=0.0)
    tr = Trainer(tm, cfg, device="cpu")
    hist = tr.fit(x, x[:2], verbose=False)
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert hist[-1]["train_loss"] < 0.6 * hist[0]["train_loss"]
