"""The port's population selectors, its pixel-angle observable and its warm
starts against the JAX package, on the CPU.

- ``pixel_observable``: the pixel readout (``pearson_rows``,
  ``pixel_angles``, ``pendulum_pixel_estimates``) in float64 (1e-9; the
  estimates float32, 1e-6), the per-model and population pixel scores and
  the composite law, on a population of three committed checkpoints
  (``goku_best_model.npz``, ``goku_pop8_winner.npz``, ``ttg_px_winner.npz``)
  and eight validation videos (scores 1e-4: correlations of float32
  trajectories);
- ``train.selectors``: ``temporal_agreement``, the forecast, composite and
  consensus scores and ``combine_composite`` (1e-4);
- ``latent_warm_start`` and ``warm_start_pendulum`` for a few steps, on one
  model and on a stacked population (one vmapped regression), against JAX
  (and ``jax.vmap`` of it): the loss trace 1e-4, the weights 1e-5 (3e-5
  for the full-width pendulum warm start, whose population weights are
  held to the port's solo warm start of each replica: see there).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

import pixel_observable as jpx  # noqa: E402
from pendulum import Pendulum as JPendulum  # noqa: E402

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import latent_warm_start as jwarm  # noqa: E402
from latentdiffeq.train import selectors as jsel  # noqa: E402
from latentdiffeq_torch import pendulum_data  # noqa: E402
from latentdiffeq_torch import pixel_observable as px  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.train import (StackedModels, latent_warm_start,  # noqa: E402
                                      load_checkpoint, selectors)
from torch.func import stack_module_state  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
CKPTS = ["goku_best_model.npz", "goku_pop8_winner.npz", "ttg_px_winner.npz"]
DT = 0.05
CTX = 40


def port_model(path=None, width=784, seed=0):
    kw = {} if width == 784 else dict(hidden_dim_resnet=16,
                                      latent_to_diffeq_dim=16)
    m = LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        width, Pendulum(options=SolveOptions(adaptive=False, substeps=1)),
        generator=torch.Generator().manual_seed(seed), device="cpu", **kw))
    if path is not None:
        load_checkpoint(os.path.join(ARTIFACTS, path), m)
    return m


def to_jax(tm, width=784):
    kw = {} if width == 784 else dict(hidden_dim_resnet=16,
                                      latent_to_diffeq_dim=16)
    enc, dec = jdefault_layers(
        jax.random.PRNGKey(0), JGOKUBasic(), width,
        JPendulum(options=make_options(adaptive=False, substeps=1)), **kw)
    _, treedef = jax.tree_util.tree_flatten(JModel.build(JGOKUBasic(), enc,
                                                         dec))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(p.detach().numpy()) for p in tm.parameters()])


def stacked(models, width=784):
    """The port's and JAX's stacked populations of ``models``."""
    st = StackedModels(models[0], *stack_module_state(models))
    jst = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                 *[to_jax(m, width) for m in models])
    return st, jst


@pytest.fixture(scope="module")
def val():
    """Eight 100-frame validation videos (the port's renderer)."""
    _, _, _, frames = pendulum_data.generate_dataset(
        n_traj=8, seed=11, device="cpu")
    return frames.reshape(8, 100, 784).numpy()


@pytest.fixture(scope="module")
def population():
    return stacked([port_model(p) for p in CKPTS])


def test_pixel_readout_matches_jax(val):
    th_j = jpx.pixel_angles(val)
    th = px.pixel_angles(torch.from_numpy(val))
    np.testing.assert_allclose(th.numpy(), th_j, rtol=0, atol=1e-9)
    a, b = th_j[:, :50], th_j[:, 50:]
    np.testing.assert_allclose(px.pearson_rows(a, b).numpy(),
                               jpx.pearson_rows(a, b), rtol=0, atol=1e-12)
    for got, want in zip(px.pendulum_pixel_estimates(val, DT),
                         jpx.pendulum_pixel_estimates(val, DT)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_population_pixel_scores_match_jax(val, population):
    st, jst = population
    th_obs = jpx.pixel_angles(val)
    th_t = px.pixel_angles(torch.from_numpy(val))
    cases = [(px.population_pixel_scores(st, val, th_t, DT),
              jpx.population_pixel_scores(jst, val, th_obs, DT)),
             (px.population_pixel_forecast_scores(st, val, th_t, DT, CTX),
              jpx.population_pixel_forecast_scores(jst, val, th_obs, DT,
                                                   CTX)),
             (px.population_pixel_composite_scores(st, val, th_t, DT, CTX,
                                                   incontext_bar=0.5),
              jpx.population_pixel_composite_scores(jst, val, th_obs, DT,
                                                    CTX, incontext_bar=0.5))]
    for got, want in cases:
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # one model at a time: the same numbers
    m1 = st.replica(1)
    j1 = jax.tree_util.tree_map(lambda a: a[1], jst)
    np.testing.assert_allclose(
        px.pixel_angle_corr(m1, val, th_t, DT),
        jpx.pixel_angle_corr(j1, val, th_obs, DT), rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        px.pixel_forecast_corr(m1, val, th_t, DT, CTX),
        jpx.pixel_forecast_corr(j1, val, th_obs, DT, CTX), rtol=0, atol=1e-4)


def test_composite_laws_equal_jax():
    rng = np.random.default_rng(0)
    in_ctx = np.concatenate([rng.uniform(0.5, 1.0, 6), [np.nan, -np.inf]])
    fc = np.concatenate([rng.uniform(-1, 1, 5), [-np.inf, 0.3, 0.2]])
    for bar in (0.9, 0.7):
        np.testing.assert_array_equal(px.composite_scores(in_ctx, fc, bar),
                                      jpx.composite_scores(in_ctx, fc, bar))
    for bar in ("rel", 0.8):
        np.testing.assert_array_equal(
            selectors.combine_composite(in_ctx, fc, bar, 0.05),
            jsel.combine_composite(in_ctx, fc, bar, 0.05))


def test_observation_selectors_match_jax(val, population):
    st, jst = population
    rng = np.random.default_rng(1)
    pred = val + rng.normal(size=val.shape).astype(np.float32) * 0.1
    pred[2, 5] = np.nan
    for start in (0, CTX):
        np.testing.assert_allclose(
            selectors.temporal_agreement(torch.from_numpy(pred), val, start),
            jsel.temporal_agreement(pred, val, start), rtol=0, atol=1e-12)
    cases = [
        (selectors.observation_forecast_scores(st, val, DT, CTX),
         jsel.observation_forecast_scores(jst, val, DT, CTX)),
        (selectors.observation_composite_scores(st, val, DT, CTX),
         jsel.observation_composite_scores(jst, val, DT, CTX)),
        (selectors.observation_consensus_scores(st, val, DT, CTX),
         jsel.observation_consensus_scores(jst, val, DT, CTX)),
        (selectors.observation_consensus_scores(
            st, val, DT, CTX, condition_in_ctx=True),
         jsel.observation_consensus_scores(jst, val, DT, CTX,
                                           condition_in_ctx=True))]
    for got, want in cases:
        assert got.shape == (3,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _targets(B):
    rng = np.random.default_rng(2)
    return (rng.normal(size=(B, 2)).astype(np.float32),
            rng.uniform(0.5, 2.0, size=B).astype(np.float32))


def test_latent_warm_start_matches_jax():
    """Five Adam steps of the latent regression on a narrow GOKU, alone
    and as a 2-replica population (one vmapped regression, against
    jax.vmap of JAX's), with the moments term."""
    x = np.random.default_rng(3).random((6, 10, 24), dtype=np.float32)
    z0t, Lt = _targets(6)

    def jloss(l_hat, mu, logvar):
        return (jnp.mean((l_hat[0] - z0t) ** 2)
                + jnp.mean((l_hat[1][:, 0] - Lt) ** 2)
                + 0.1 * sum(jnp.mean((lv + 6.0) ** 2) for lv in logvar))

    zt, lt_ = torch.from_numpy(z0t), torch.from_numpy(Lt)

    def tloss(l_hat, mu, logvar):
        return (torch.mean((l_hat[0] - zt) ** 2)
                + torch.mean((l_hat[1][:, 0] - lt_) ** 2)
                + 0.1 * sum(torch.mean((lv + 6.0) ** 2) for lv in logvar))

    models = [port_model(width=24, seed=s) for s in (1, 2)]
    st, jst = stacked(models, 24)
    kw = dict(steps=5, lr=1e-2, with_moments=True)
    jm = jax.tree_util.tree_map(lambda a: a[0], jst)
    jw, jl = jwarm(jm, jnp.asarray(x), jloss, **kw)
    tw, tl = latent_warm_start(port_model(width=24, seed=1), torch.from_numpy(x), tloss, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    for p, a in zip(tw.parameters(), jax.tree_util.tree_leaves(jw)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5)
    jw2, jl2 = jax.vmap(lambda m: jwarm(m, jnp.asarray(x), jloss, **kw))(
        jst)
    st, tl2 = latent_warm_start(st, torch.from_numpy(x), tloss, **kw)
    assert tl2.shape == (5, 2)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2).T, rtol=0,
                               atol=1e-4)
    for p, a in zip(st.params.values(), jax.tree_util.tree_leaves(jw2)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5)


def test_warm_start_pendulum_matches_jax(val):
    """Three steps of the pixel warm start on goku_best_model.npz, and on
    a stacked pair with goku_pop8_winner.npz, against JAX. Three Adam steps
    at lr 1e-3 move a weight by up to 3e-3, and Adam's early steps turn
    the rounding of a near-zero gradient into a sizeable share of lr: the
    weights are held to 3e-5, 1 % of that movement."""
    kw = dict(window=30, offsets=(0, 40), steps=3, lr=1e-3)
    est = px.pendulum_pixel_estimates(val, DT)
    jest = jpx.pendulum_pixel_estimates(val, DT)
    one = port_model(CKPTS[0])
    jm = to_jax(one)
    jw, jl = jpx.warm_start_pendulum(jm, val, DT, estimates=jest, **kw)
    tw, tl = px.warm_start_pendulum(one, val, DT, estimates=est, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    for p, a in zip(tw.parameters(), jax.tree_util.tree_leaves(jw)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=3e-5)
    st, jst = stacked([port_model(p) for p in CKPTS[:2]])
    jw2, jl2 = jax.vmap(lambda m: jpx.warm_start_pendulum(
        m, val, DT, estimates=jest, **kw))(jst)
    st, tl2 = px.warm_start_pendulum(st, val, DT, **kw)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2).T, rtol=0,
                               atol=1e-4)
    # the population's weights against each replica's solo warm start (the
    # vmapped regression is the solo one, batched); JAX's vmapped weights
    # part from JAX's solo ones by O(lr) where a gradient is rounding noise
    for i, path in enumerate(CKPTS[:2]):
        solo, _ = px.warm_start_pendulum(port_model(path), val, DT,
                                         estimates=est, **kw)
        for (k, p), q in zip(solo.named_parameters(), st.params.values()):
            np.testing.assert_allclose(q[i].detach().numpy(),
                                       p.detach().numpy(), rtol=0,
                                       atol=3e-5, err_msg=k)
