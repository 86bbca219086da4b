"""Block mode for SDE dynamics and adaptive solves (eager on the CPU; the
CUDA graphs in tests/test_torch_cuda_blocks.py).

- GOKU on the stochastic pendulum (SRA1 on the grid, and adaptive) and on
  the adaptive pendulum: ``Trainer.fit`` in blocks of 2 equals the
  per-step loop (``jit_epoch=False``) bit for bit over 2 blocks (each
  epoch's summaries, the weights, the optimizer, the best and the three
  random streams; the Brownian keys are drawn from the noise generator
  inside the epoch in both), with no warning; a run saved at the block
  boundary and resumed equals the uninterrupted one.
- The port's ``make_block_fn`` on an SDE GOKU against JAX's
  ``make_block_fn`` on the same bridged weights, with the windows, noise
  and Brownian keys JAX's ``step_body`` derives from its epoch keys
  (trainer.py:330-358; the decoder's key ``split(kvar)[1]``, a validation
  pass's ``fold_in(k, 7)``): losses rtol 1e-5, weights atol 1e-5, the same
  best epoch."""
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

from pendulum import SPendulum as JSPendulum  # noqa: E402

from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train import trainer as jtrainer  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch import random as jr  # noqa: E402
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.solve import make_options  # noqa: E402
from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig  # noqa: E402
from latentdiffeq_torch.train import (Trainer, load_jax_params,  # noqa: E402
                                      loss_batch, make_block_fn, optim)
from latentdiffeq_torch.train.trainer import block_best  # noqa: E402
from test_torch_block import (D_IN, SMALL, assert_same_run,  # noqa: E402
                              cfg_of, goku, jax_draws)

ADAPTIVE_SDE = dict(max_steps=40, depth_cap=3)
DYNAMICS = {
    "sde": lambda: SPendulum(),
    "sde_adaptive": lambda: SPendulum(
        adaptive=True, adaptive_cfg=SDEAdaptiveConfig(**ADAPTIVE_SDE)),
    "adaptive": lambda: Pendulum(options=make_options(adaptive=True,
                                                      max_steps=64)),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets():
    x = np.random.default_rng(0).uniform(0, 1, (20, 12, D_IN)).astype(
        np.float32)
    return x[:16], x[16:]          # 16 training videos: 2 steps of 8


def fit(which, sets, epochs, **kw):
    tr = Trainer(goku(6, DYNAMICS[which]()), cfg_of(epochs=4, **kw),
                 device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tr.fit(*sets, epochs=epochs, verbose=False)
    return tr


@pytest.fixture(scope="module")
def per_step(sets):
    return {w: fit(w, sets, 4, jit_epoch=False) for w in DYNAMICS}


@pytest.mark.parametrize("which", list(DYNAMICS))
def test_blocks_equal_the_per_step_loop(which, sets, per_step):
    blk = fit(which, sets, 4, epochs_per_dispatch=2)
    assert set(blk._block_fns) == {(8, 2, 12)}
    assert_same_run(per_step[which], blk)
    assert all(np.isfinite(h["val_loss"]) for h in blk.history)


@pytest.mark.parametrize("which", list(DYNAMICS))
def test_resume_across_the_block_boundary(which, sets, per_step, tmp_path):
    first = fit(which, sets, 2, epochs_per_dispatch=2)
    path = str(tmp_path / "mid.npz")
    first.save(path)
    second = Trainer(goku(7, DYNAMICS[which]()),
                     cfg_of(epochs=4, epochs_per_dispatch=2),
                     device="cpu").restore(path)
    assert second.epoch == 2
    second.fit(*sets, verbose=False)
    second.history = first.history + second.history
    assert_same_run(per_step[which], second, best=False)


def bridged_sde(seed=3, scale=0.2):
    """(JAX model, port model) of a small SDE GOKU on the same random
    weights."""
    enc, dec = jdefault_layers(jax.random.PRNGKey(seed), JGOKUBasic(), D_IN,
                               JSPendulum(), **SMALL)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    tm = goku(0, SPendulum())
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


def jax_sde_keys(keys, steps):
    """The decoder keys JAX's step_body hands an SDE GOKU, as the port's
    (train (E, steps, 2): split(kvar)[1]; validation (E, steps, 2):
    fold_in(k, 7), taken whole by the non-variational pass)."""
    train, val = [], []
    for key in keys:
        t_row, v_row = [], []
        for k in jax.random.split(key, steps):
            kvar = jax.random.split(k)[1]
            t_row.append(np.asarray(jax.random.split(kvar)[1]))
            v_row.append(np.asarray(jax.random.fold_in(k, 7)))
        train.append(t_row)
        val.append(v_row)
    return (np.array(train).astype(np.int64), np.array(val).astype(np.int64))


def test_make_block_fn_sde_matches_jax(sets):
    """Three epochs of two steps of the SRA1 GOKU through both programs:
    each epoch's train and validation loss and KL (rtol 1e-5), the weights
    after the block and the best weights (atol 1e-5), the best epoch and
    validation loss, the solves' evaluations."""
    jm, tm = bridged_sde()
    tr_set, va_set = sets
    E, steps, B, seq_len = 3, 2, 8, 8
    jcfg = JTrainConfig(batch_size=B, seq_len=seq_len, decay=1e-4)
    cfg = cfg_of(seq_len=seq_len, decay=1e-4)
    jopt = joptim.adamw(jcfg.lr, 0.9, 0.999, jcfg.decay)
    jblock = jax.jit(jtrainer.make_block_fn(jcfg, jopt, jlosses.loss_batch,
                                            seq_len, steps, va_set.shape[1]))
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(16)[:steps * B].reshape(steps, B)
                    for _ in range(E)])
    keys = jax.random.split(jax.random.PRNGKey(5), E)
    betas = np.array([0.0, 0.5, 1.0], np.float32)
    ids = np.arange(2, 2 + E, dtype=np.int32)
    jbest = {"model": jm, "opt_state": jopt.init(jm),
             "val": jnp.float32(np.inf), "epoch": jnp.int32(0)}
    (jm2, _, jbest), jsumm = jblock(
        jm, jopt.init(jm), jbest, jnp.asarray(tr_set), jnp.asarray(va_set),
        jnp.asarray(idx), keys, jnp.asarray(betas), jnp.asarray(ids))

    opt = optim.adamw(tm.parameters(), cfg.lr, 0.9, 0.999, cfg.decay)
    fn = make_block_fn(cfg, opt, loss_batch, seq_len, steps,
                       va_set.shape[1])
    best = block_best(tm, opt)
    starts, eps = jax_draws("goku", keys, steps, B, tr_set.shape[1],
                            seq_len)
    summ = fn(tm, best, torch.from_numpy(tr_set), torch.from_numpy(va_set),
              idx, starts, betas, ids, eps=eps,
              keys=jax_sde_keys(keys, steps))
    # the keys are JAX's own words
    np.testing.assert_array_equal(
        jr.split(jr.as_key(np.asarray(keys[0])), steps).numpy(),
        np.asarray(jax.random.split(keys[0], steps)))
    for k in ("train_loss", "val_loss", "kl"):
        np.testing.assert_allclose(summ[k].numpy(), np.asarray(jsumm[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(summ["rhs_evals"].numpy(),
                                  np.asarray(jsumm["rhs_evals"]))
    for p, leaf in zip(tm.parameters(), jax.tree_util.tree_leaves(jm2)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                   rtol=0, atol=1e-5)
    assert int(best["epoch"]) == int(jbest["epoch"])
    np.testing.assert_allclose(float(best["val"]), float(jbest["val"]),
                               rtol=1e-5)
    for b, leaf in zip(best["model"],
                       jax.tree_util.tree_leaves(jbest["model"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(leaf), rtol=0,
                                   atol=1e-5)
