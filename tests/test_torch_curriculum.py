"""The port's training curricula and the loss's anchor terms against the JAX
package, on the CPU.

- ``_prog_seq_lengths`` equals JAX's on a grid of configurations;
- the masked recurrence and encoder equal the sliced prefix;
- ``loss_batch`` and its gradients at ``cur_len`` equal JAX's on the
  committed ``goku_best_model.npz`` with the same noise (atol 1e-4: 784
  outputs through a 200-wide resnet), and equal the port's own loss on the
  sliced prefix;
- a masked-curriculum Trainer trains the sliced windows: at full length
  the unmasked run, at short lengths the sliced curriculum, bit for bit;
- the anchor terms (``anchor``, ``anchor_weight``, ``anchor_frames``) and
  their gradients against JAX (atol 1e-4).
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

from pendulum import Pendulum as JPendulum  # noqa: E402

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train.trainer import (  # noqa: E402
    _prog_seq_lengths as jprog)
from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.train import (TrainConfig, Trainer,  # noqa: E402
                                      load_checkpoint, losses)
from latentdiffeq_torch.train.trainer import _prog_seq_lengths  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
BEST = os.path.join(ARTIFACTS, "goku_best_model.npz")


def port_goku(width=None, seed=0):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    kw = {} if width is None else dict(hidden_dim_resnet=16,
                                       latent_to_diffeq_dim=16)
    enc, dec = goku_default_layers(
        width or 784, diffeq, generator=torch.Generator().manual_seed(seed),
        device="cpu", **kw)
    return LatentDiffEqModel.build(GOKUBasic(), enc, dec)


def to_jax(tm, width=784, **kw):
    """A JAX GOKU holding the port model's weights (the flatten orders are
    the same)."""
    diffeq = JPendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), width,
                               diffeq, **kw)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    assert len(leaves) == len(list(tm.parameters()))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(p.detach().numpy()) for p in tm.parameters()])


@pytest.fixture(scope="module")
def best():
    tm = port_goku()
    load_checkpoint(BEST, tm)
    return to_jax(tm), tm


def noise(key, lv_j):
    """The reparameterisation noise JAX's model draws for ``key``."""
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, lv.shape)))
                 for k, lv in zip((k1, k2), lv_j))


GRID = [dict(progressive_training=False),
        dict(progressive_training=True),
        dict(progressive_training=True, prog_seq_len_step=None),
        dict(progressive_training=True, prog_seq_len_step=1),
        dict(progressive_training=True, start_seq_len=20,
             prog_training_duration=300),
        dict(progressive_training=True, start_seq_len=7, seq_len=23,
             prog_training_duration=11, prog_seq_len_step=4),
        dict(progressive_training=True, start_seq_len=50, seq_len=50,
             prog_training_duration=5),
        dict(progressive_training=True, start_seq_len=3, seq_len=100,
             prog_training_duration=1000, prog_seq_len_step=7)]


@pytest.mark.parametrize("kw", GRID, ids=[str(i) for i in range(len(GRID))])
def test_prog_seq_lengths_equal_jax(kw):
    np.testing.assert_array_equal(_prog_seq_lengths(TrainConfig(**kw)),
                                  jprog(JTrainConfig(**kw)))


@pytest.mark.parametrize("kind", ["rnn", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
def test_masked_recurrence_equals_sliced_prefix(kind, reverse):
    g = torch.Generator().manual_seed(0)
    make = tnn.Recurrent.rnn if kind == "rnn" else tnn.Recurrent.lstm
    rec = make(8, (6, 6), generator=g)
    xs = torch.randn(3, 10, 8, generator=g)
    L = 6
    mask = torch.arange(10) < L
    with torch.no_grad():
        masked = rec(xs, reverse=reverse, mask=mask)
        sliced = rec(xs[:, :L], reverse=reverse)
        full = rec(xs, reverse=reverse, mask=torch.ones(10, dtype=bool))
        plain = rec(xs, reverse=reverse)
    torch.testing.assert_close(masked, sliced, rtol=0, atol=0)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)


def test_encoder_cur_len_equals_sliced_prefix():
    tm = port_goku(width=24)
    x = torch.rand(4, 10, 24, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mu_m, lv_m = tm.encoder(x, cur_len=6)
        mu_s, lv_s = tm.encoder(x[:, :6])
    for a, b in zip(mu_m + lv_m, mu_s + lv_s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cur_len", [4, 9])
def test_loss_and_grads_at_cur_len_match_jax(best, cur_len):
    """On goku_best_model.npz: the masked loss on a 12-frame buffer with
    cur_len real frames, and its gradients, against JAX's with the same
    noise (atol 1e-4), and against the port's loss on the sliced prefix."""
    jm, tm = best
    B, T = 6, 12
    x = np.random.default_rng(2).uniform(0, 1, (B, T, 784)).astype(
        np.float32)
    t = (np.arange(T) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jloss(m):
        return jlosses.loss_batch(m, jnp.asarray(x), jnp.asarray(t), 0.6,
                                  variational=True, key=key,
                                  cur_len=jnp.int32(cur_len))

    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(jm)
    _, _, lv_j, _ = jm(jnp.asarray(x), jnp.asarray(t), variational=True,
                       key=key, cur_len=jnp.int32(cur_len))
    eps = noise(key, lv_j)
    tm.zero_grad()
    lt, mt = losses.loss_batch(tm, torch.from_numpy(x), torch.from_numpy(t),
                               0.6, variational=True, eps=eps,
                               cur_len=cur_len)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(mt["rec"].detach()), float(mj["rec"]),
                               rtol=0, atol=1e-4)
    for p, g in zip(tm.parameters(), jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4)
    with torch.no_grad():
        ls, _ = losses.loss_batch(tm, torch.from_numpy(x[:, :cur_len]),
                                  torch.from_numpy(t[:cur_len]), 0.6,
                                  variational=True, eps=eps)
    np.testing.assert_allclose(float(lt.detach()), float(ls), rtol=1e-6)


def _fit(masked, start_seq_len, seed=4):
    cfg = TrainConfig(batch_size=8, seq_len=8, epochs=3, seed=seed,
                      save_best=False, n_cycle=1, start_beta=0.5,
                      end_beta=0.5, progressive_training=True,
                      start_seq_len=start_seq_len, prog_training_duration=3,
                      prog_seq_len_step=2, masked_curriculum=masked)
    x = np.random.default_rng(0).random((16, 12, 24), dtype=np.float32)
    tr = Trainer(port_goku(width=24, seed=seed), cfg, device="cpu")
    hist = tr.fit(x, x[:3], verbose=False)
    return tr, hist


@pytest.mark.parametrize("start_seq_len", [8, 4],
                         ids=["full_length", "short"])
def test_masked_trainer_equals_sliced(start_seq_len):
    """``masked_curriculum`` trains the sliced windows (JAX's masked steps
    equal its sliced ones: test_loss_and_grads_at_cur_len_match_jax): at
    full length (every epoch seq_len) the unmasked run, at short lengths
    (4, 6, 8) the sliced curriculum; the same lengths, losses and trained
    weights, bit for bit."""
    tm, hm = _fit(True, start_seq_len)
    ts, hs = _fit(False, start_seq_len)
    assert [h["seq_len"] for h in hm] == [h["seq_len"] for h in hs]
    if start_seq_len == 4:
        assert [h["seq_len"] for h in hm] == [4, 6, 8]
    for a, b in zip(hm, hs):
        assert a["train_loss"] == b["train_loss"]
        assert a["val_loss"] == b["val_loss"]
    for p, q in zip(tm.model.parameters(), ts.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


ANCHOR_CASES = {"plain": {}, "frames": {"anchor_frames": 3},
                "cur_len": {"cur_len": 7},
                "mask_failures": {"mask_failures": True},
                "deterministic": {"variational": False, "anchor_frames": 4},
                "all": {"anchor_frames": 9, "cur_len": 7,
                        "mask_failures": True}}


@pytest.mark.parametrize("case", list(ANCHOR_CASES))
def test_anchor_terms_match_jax(best, case):
    """The latent-chart anchor (a fixed linear readout of the frames as the
    chart) on goku_best_model.npz: loss, the anchor metric and the
    gradients against JAX with the same noise (atol 1e-4). At the posterior
    mean ("deterministic") the gradients reach ~20, so there they are held
    to 1e-4 of each tensor's size (float32 rounding of the larger sums)."""
    jm, tm = best
    kw = dict(ANCHOR_CASES[case])
    B, T = 5, 10
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (B, T, 784)).astype(np.float32)
    t = (np.arange(T) * 0.05).astype(np.float32)
    A = (rng.normal(size=(784, 2)) * 0.01).astype(np.float32)
    key = jax.random.PRNGKey(9)
    cur = kw.pop("cur_len", None)
    variational = kw.pop("variational", True)

    def jloss(m):
        return jlosses.loss_batch(
            m, jnp.asarray(x), jnp.asarray(t), 0.3, variational=variational,
            key=key, anchor=lambda a: a @ jnp.asarray(A), anchor_weight=0.7,
            cur_len=None if cur is None else jnp.int32(cur), **kw)

    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(jm)
    _, _, lv_j, _ = jm(jnp.asarray(x), jnp.asarray(t), variational=True,
                       key=key)
    tm.zero_grad()
    At = torch.from_numpy(A)
    lt, mt = losses.loss_batch(
        tm, torch.from_numpy(x), torch.from_numpy(t), 0.3,
        variational=variational, eps=noise(key, lv_j),
        anchor=lambda a: a @ At, anchor_weight=0.7,
        cur_len=cur, **kw)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(mt["anchor"].detach()),
                               float(mj["anchor"]),
                               rtol=0, atol=1e-4)
    for p, g in zip(tm.parameters(), jax.tree_util.tree_leaves(gj)):
        g = np.asarray(g)
        tol = 1e-4 * (1.0 if variational else max(1.0, np.abs(g).max()))
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=tol)
