"""MultiSeedTrainer in block mode (eager on the CPU; the CUDA graphs in
tests/test_torch_cuda_blocks.py).

- ``fit`` in blocks equals its per-step loop (``jit_epoch=False``) bit for
  bit: each epoch's per-replica losses and failures, the stacked weights,
  Adam's state, each replica's best (weights, moments, validation loss,
  epoch) and every random stream, for GOKU in float32 and with bf16 NN
  stages, LatentODE, GOKU on the stochastic pendulum and the masked
  curriculum (whose blocks span the lengths, one graph a length); fit
  warns neither way.
- A NaN validation loss of one replica inside a block never becomes that
  replica's best; the others' bests go on.
- The progress line, ``save_best`` / ``save_population`` and the callbacks
  run once a block, on its last record (once an epoch per step).
- The vmapped block against JAX's ``jax.vmap(make_block_fn)`` on 2
  replicas with JAX's windows and noise fed: losses rtol 1e-5, weights
  atol 1e-5, the same best epochs."""
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

from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train import trainer as jtrainer  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.train import MultiSeedTrainer  # noqa: E402
from test_torch_block import (CURRICULUM, D_IN, SMALL, bridged,  # noqa: E402
                              cfg_of, goku, jax_draws, latent_ode)

SEEDS = [1, 2]


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


def goku_bf16(seed):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(D_IN, diffeq, **SMALL, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu"))


CASES = {
    "goku": (goku, {}),
    "goku_bf16": (goku_bf16, {}),
    "latent_ode": (latent_ode, {}),
    "spendulum": (lambda s: goku(s, SPendulum()), {}),
    "masked": (goku, dict(masked_curriculum=True, **CURRICULUM)),
}


def population(which, **kw):
    init, extra = CASES[which]
    return MultiSeedTrainer(init, cfg_of(epochs=5, **dict(extra, **kw)),
                            SEEDS, device="cpu")


def fitted(ms, sets, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ms.fit(*sets, verbose=False, **kw)
    return ms


def assert_same_population(a, b):
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        for k in ("epoch", "train_loss", "val_loss", "n_failed", "beta",
                  "seq_len"):
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a._best["params"][k], b._best["params"][k]), k
    assert a.opt.t == b.opt.t
    for p, q in zip(a.opt.state_tensors() + a._best["m"] + a._best["v"],
                    b.opt.state_tensors() + b._best["m"] + b._best["v"]):
        assert torch.equal(p, q)
    np.testing.assert_array_equal(a._best["val"], b._best["val"])
    np.testing.assert_array_equal(a._best["epoch"], b._best["epoch"])
    for ga, gb in zip(a.noise_gens + a.window_gens,
                      b.noise_gens + b.window_gens):
        assert torch.equal(ga.get_state(), gb.get_state())
    assert [r.bit_generator.state for r in a.np_rngs] == \
        [r.bit_generator.state for r in b.np_rngs]


@pytest.mark.parametrize("which", list(CASES))
def test_population_blocks_equal_the_per_step_loop(which, sets):
    ref = fitted(population(which, jit_epoch=False), sets)
    blk = fitted(population(which, epochs_per_dispatch=3), sets)
    assert blk._block_fns and not ref._block_fns
    assert_same_population(ref, blk)
    if which == "masked":
        # the blocks span the lengths 4, 6, 8 (one block function each)
        assert sorted(k[0] for k in blk._block_fns) == [4, 6, 8]
        assert [h["seq_len"] for h in blk.history] == [4, 6, 8, 8, 8]


def test_nan_epoch_inside_a_block_never_becomes_a_replicas_best(sets):
    """Replica 0's validation loss of epoch 1 is NaN (the last pass of
    the epoch, which it reports): in blocks and per step alike its best
    stays a finite epoch's, and replica 1's best is untouched."""
    runs = []
    for kw in (dict(jit_epoch=False), dict(epochs_per_dispatch=5)):
        ms = population("goku", **kw)
        plain, calls = ms.val_step, {"n": 0}

        def val_step(val, beta, *, keys=None, plain=plain, calls=calls):
            calls["n"] += 1
            m = plain(val, beta, keys=keys)
            if calls["n"] == 2 * 2:
                loss = m["loss"].clone()
                loss[0] = float("nan")
                m = dict(m, loss=loss)
            return m

        ms.val_step = val_step
        runs.append(fitted(ms, sets))
    ref, blk = runs
    assert_same_population(ref, blk)
    vals = np.array([h["val_loss"] for h in blk.history])
    assert np.isnan(vals[1, 0]) and np.isfinite(vals[:, 1]).all()
    best = blk._best
    assert int(best["epoch"][0]) != 1 and np.isfinite(best["val"][0])
    for r in range(2):
        assert best["val"][r] == np.nanmin(vals[:, r])
        assert int(best["epoch"][r]) == int(np.nanargmin(vals[:, r]))


def test_callbacks_and_checkpoints_once_a_block(sets, tmp_path, capsys):
    """Blocks of 2 over 5 epochs: the callbacks, the progress line and
    the checkpoints after epochs 1, 3 and 4; the per-step loop after every
    epoch. The files hold the same best either way."""
    seen = {}
    for mode, kw in (("block", dict(epochs_per_dispatch=2)),
                     ("per-step", dict(jit_epoch=False))):
        ms = population("goku", save_best=True,
                        checkpoint_dir=str(tmp_path / mode), **kw)
        writes = []
        plain = ms.save_best
        ms.save_best = lambda path, plain=plain, writes=writes: (
            writes.append(ms.epoch), plain(path))
        got = []
        ms.fit(*sets, verbose=True,
               callbacks=[lambda t, rec, got=got: got.append(rec["epoch"])])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "seeds]" in ln]
        seen[mode] = (got, writes, len(lines), ms)
    assert seen["block"][:3] == ([1, 3, 4], [2, 4, 5], 3)
    assert seen["per-step"][:3] == ([0, 1, 2, 3, 4], [1, 2, 3, 4, 5], 5)
    a = seen["block"][3].best_seed_model(0).state_dict()
    b = seen["per-step"][3].best_seed_model(0).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for mode in seen:
        assert os.path.exists(tmp_path / mode / "best_model.npz")
        assert os.path.exists(tmp_path / mode / "population.npz")


def test_vmapped_block_matches_jax(sets):
    """Three epochs of two steps of 2 replicas through the port's block
    (the population's steps, tables with a replica axis) and JAX's
    jax.vmap(make_block_fn), on bridged weights with JAX's windows and
    noise: each replica's train and validation loss and KL (rtol 1e-5),
    its weights after the block and its best weights (atol 1e-5), its best
    epoch."""
    pairs = [bridged("goku", seed=3 + r) for r in range(2)]
    jms = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                 *[j for j, _ in pairs])
    tr_set, va_set = sets
    E, steps, B, seq_len = 3, 2, 8, 8
    jcfg = JTrainConfig(batch_size=B, seq_len=seq_len, decay=1e-4)
    jopt = joptim.adamw(jcfg.lr, 0.9, 0.999, jcfg.decay)
    raw = jtrainer.make_block_fn(jcfg, jopt, jlosses.loss_batch, seq_len,
                                 steps, va_set.shape[1])
    jblock = jax.jit(jax.vmap(raw, in_axes=(0, 0, 0, None, None, 0, 0,
                                            None, None)))
    rng = np.random.default_rng(4)
    idx = np.stack([np.stack([rng.permutation(16)[:steps * B]
                              .reshape(steps, B) for _ in range(E)])
                    for _ in range(2)])                    # (S, E, steps, B)
    keys = jnp.stack([jax.random.split(jax.random.PRNGKey(5 + r), E)
                      for r in range(2)])                   # (S, E, 2)
    betas = np.array([0.0, 0.5, 1.0], np.float32)
    ids = np.arange(2, 2 + E, dtype=np.int32)
    st0 = jax.vmap(jopt.init)(jms)
    jbest = {"model": jms, "opt_state": st0,
             "val": jnp.full((2,), jnp.inf, jnp.float32),
             "epoch": jnp.zeros((2,), jnp.int32)}
    (jm2, _, jbest), jsumm = jblock(
        jms, st0, jbest, jnp.asarray(tr_set), jnp.asarray(va_set),
        jnp.asarray(idx), keys, jnp.asarray(betas), jnp.asarray(ids))

    models = [t for _, t in pairs]
    ms = MultiSeedTrainer(lambda s: models[s], cfg_of(seq_len=seq_len,
                                                      decay=1e-4),
                          [0, 1], device="cpu")
    ms._best = ms._init_best()
    draws = [jax_draws("goku", keys[r], steps, B, tr_set.shape[1], seq_len)
             for r in range(2)]
    starts = np.stack([d[0] for d in draws], axis=2)        # (E, steps, S)
    eps = tuple(torch.stack([d[1][g] for d in draws], dim=2)
                for g in range(2))                   # (E, steps, S, B, w)
    best = ms._device_best()
    fn = ms._block_fn(seq_len, steps, va_set.shape[1])
    summ = fn(ms.stacked_models, best, torch.from_numpy(tr_set),
              torch.from_numpy(va_set), idx.transpose(1, 2, 0, 3), starts,
              betas, ids, eps=eps)
    for k in ("train_loss", "val_loss", "kl"):
        np.testing.assert_allclose(summ[k].numpy(),
                                   np.asarray(jsumm[k]).T, rtol=1e-5,
                                   err_msg=k)
    leaves = jax.tree_util.tree_leaves(jm2)
    bleaves = jax.tree_util.tree_leaves(jbest["model"])
    for (name, p), leaf, bleaf, b in zip(ms.params.items(), leaves, bleaves,
                                         best["model"]):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                   rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(bleaf), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(best["epoch"].numpy(),
                                  np.asarray(jbest["epoch"]))
    np.testing.assert_allclose(best["val"].numpy(),
                               np.asarray(jbest["val"]), rtol=1e-5)
    assert ms.opt.t == E * steps
