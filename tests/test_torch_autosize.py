"""The port's adaptive-budget autosize probe against the JAX package's
(``latentdiffeq.train.trainer._autosize_probe``), on the CPU.

The sized ``max_steps`` (and for SDE dynamics ``depth_cap``) must EQUAL
JAX's: adaptive Tsit5 on ``goku_best_model.npz`` and the adaptive
stochastic pendulum on ``spendulum_adaptive_winner.npz`` (the probe keys are
``split(PRNGKey(0), B)`` in both packages, drawn bit for bit), at the
default safety and on the quantile path; then the errors and warnings, the
swap that keeps the parameters and the optimizer state, the probe at the
start of ``Trainer.fit``, and the population's probe on replica 0.
"""
import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

from pendulum import Pendulum as JPendulum  # noqa: E402
from pendulum import SPendulum as JSPendulum  # noqa: E402

from latentdiffeq import make_options as jmake_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.solve.sde import SDEAdaptiveConfig as JSDECfg  # noqa: E402
from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train.trainer import (  # noqa: E402
    _autosize_probe as jprobe)
from latentdiffeq_torch import make_options, pendulum_data  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig  # noqa: E402
from latentdiffeq_torch.train import (MultiSeedTrainer,  # noqa: E402
                                      TrainConfig, Trainer, load_checkpoint)
from latentdiffeq_torch.train.trainer import _autosize_probe  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
ODE_KW = dict(adaptive=True, rtol=1e-3, atol=1e-6, max_steps=256)
SDE_KW = dict(max_steps=256, depth_cap=6, max_steps_per_interval=6)


def pair(kind):
    """(JAX model, port model) on a checkpoint's weights, with adaptive
    dynamics: Tsit5 on goku_best_model.npz, or SRA1 on
    spendulum_adaptive_winner.npz."""
    if kind == "ode":
        jd = JPendulum(options=jmake_options(**ODE_KW))
        td = Pendulum(options=make_options(**ODE_KW))
        path = "goku_best_model.npz"
    else:
        jd = JSPendulum(adaptive=True, adaptive_cfg=JSDECfg(**SDE_KW))
        td = SPendulum(adaptive=True,
                       adaptive_cfg=SDEAdaptiveConfig(**SDE_KW))
        path = "spendulum_adaptive_winner.npz"
    tm = LatentDiffEqModel.build(
        GOKUBasic(), *goku_default_layers(784, td, device="cpu"))
    load_checkpoint(os.path.join(ARTIFACTS, path), tm)
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), 784, jd)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(p.detach().numpy()) for p in tm.parameters()])
    return jm, tm


@pytest.fixture(scope="module")
def video():
    """Eight 30-frame pendulum videos (the port's renderer)."""
    _, _, _, frames = pendulum_data.generate_dataset(
        n_traj=8, seed=5, tspan=(0.0, 1.45), device="cpu")
    return frames.reshape(8, 30, 784).numpy()


@pytest.fixture(scope="module", params=["ode", "sde"])
def models(request):
    return (request.param,) + pair(request.param)


def _cfgs(**kw):
    base = dict(batch_size=8, seq_len=30, mask_failures=True)
    base.update(kw)
    return JTrainConfig(**base), TrainConfig(**base)


def _acfg(kind, de):
    return de.options.adaptive_cfg if kind == "ode" else de.adaptive_cfg


@pytest.mark.parametrize("kw", [{}, {"autosize_safety": 1.0},
                                {"autosize_quantile": 0.5},
                                {"autosize_depth_margin": 0}],
                         ids=["default", "safety1", "quantile", "margin0"])
def test_probe_sizes_equal_jax(models, video, kw):
    kind, jm, tm = models
    jcfg, tcfg = _cfgs(**kw)
    js, jde = jprobe(jm, jcfg, video)
    ts, tde = _autosize_probe(tm, tcfg, video)
    assert js is not None and ts == js
    ja, ta = _acfg(kind, jde), _acfg(kind, tde)
    assert ta.max_steps == ja.max_steps == ts
    if kind == "sde":
        assert ta.depth_cap == ja.depth_cap
        assert ta.max_steps_per_interval == ja.max_steps_per_interval == 0
        assert ta.depth_cap < SDE_KW["depth_cap"]
    else:
        assert ts < ODE_KW["max_steps"]


def test_quantile_without_mask_failures_raises(models, video):
    _, _, tm = models
    _, tcfg = _cfgs(autosize_quantile=0.5, mask_failures=False)
    with pytest.raises(ValueError, match="mask_failures"):
        _autosize_probe(tm, tcfg, video)


def test_worst_case_sizing_without_mask_failures_warns(models, video):
    _, _, tm = models
    _, tcfg = _cfgs(mask_failures=False)
    with pytest.warns(UserWarning, match="mask_failures=False"):
        sized, _ = _autosize_probe(tm, tcfg, video)
    assert sized is not None


def test_trainer_swap_keeps_parameters_and_optimizer(models, video):
    """Trainer.autosize_adaptive_budget swaps the dynamics for the sized
    ones and leaves the weights and Adam's state as they were."""
    kind, _, tm = models
    _, tcfg = _cfgs()
    tr = Trainer(tm, tcfg, device="cpu")
    old = tm.decoder.diffeq
    before = [p.detach().clone() for p in tm.parameters()]
    opt_before = tr.opt.state_dict()
    sized = tr.autosize_adaptive_budget(video)
    assert _acfg(kind, tm.decoder.diffeq).max_steps == sized
    assert tr.opt.params[0] is next(tm.parameters())
    for a, b in zip(before, tm.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tr.opt.state_dict()["t"] == opt_before["t"]
    # the dynamics were swapped on the module-scoped model: restore them
    tm.decoder.diffeq = old


def test_fixed_grid_dynamics_are_not_sized(video):
    tm = LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        784, Pendulum(options=SolveOptions(adaptive=False)), device="cpu"))
    _, tcfg = _cfgs()
    assert _autosize_probe(tm, tcfg, video) == (None, None)
    assert Trainer(tm, tcfg, device="cpu").autosize_adaptive_budget(
        video) is None


def test_failed_probe_row_leaves_the_budget(video):
    """A probe whose budget cannot finish a row gives no evidence that it
    shrinks: nothing is sized."""
    tm = LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        784, Pendulum(options=make_options(adaptive=True, max_steps=3)),
        device="cpu"))
    _, tcfg = _cfgs()
    assert _autosize_probe(tm, tcfg, video) == (None, None)


def _small(diffeq, seed):
    return LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        784, diffeq, hidden_dim_resnet=16, latent_to_diffeq_dim=16,
        generator=torch.Generator().manual_seed(seed), device="cpu"))


def test_fit_probes_at_the_start_and_population_probes_replica_0(video):
    """autosize_adaptive=True: Trainer.fit sizes the budget before its
    first epoch; MultiSeedTrainer sizes it from replica 0 for all, the
    same budget a solo probe of that replica gives."""
    acfg = SDEAdaptiveConfig(**SDE_KW)
    cfg = TrainConfig(batch_size=4, seq_len=10, epochs=1, save_best=False,
                      autosize_adaptive=True, mask_failures=True,
                      jit_epoch=False)
    x = video[:, :12]
    solo = _small(SPendulum(adaptive=True, adaptive_cfg=acfg), 11)
    want, want_de = _autosize_probe(solo, cfg, x)
    tr = Trainer(_small(SPendulum(adaptive=True, adaptive_cfg=acfg), 11),
                 dataclasses.replace(cfg, seed=11), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.fit(x, x[:2], verbose=False)
    assert tr.model.decoder.diffeq.adaptive_cfg == want_de.adaptive_cfg
    ms = MultiSeedTrainer(
        lambda s: _small(SPendulum(adaptive=True, adaptive_cfg=acfg), s),
        cfg, [11, 12], device="cpu")
    assert ms.autosize_adaptive_budget(x) == want
    assert ms.base.decoder.diffeq.adaptive_cfg == want_de.adaptive_cfg
