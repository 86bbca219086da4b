"""Population training (``latentdiffeq_torch.train.MultiSeedTrainer``)
against the JAX package and against solo port Trainers, on the CPU.

- a population of three committed checkpoints (``goku_best_model.npz``,
  ``goku_pop8_winner.npz``, ``ttg_px_winner.npz``): per-replica loss,
  gradients and one Flux ADAMW update against JAX's vmapped ``loss_batch``
  and ``optim`` on the same windows and noise (loss atol 1e-4; gradients
  1e-4 of each gradient's size, as test_torch_sde_goku.py holds them: 784
  outputs through a 200-wide resnet; the update 1e-6 against JAX's ADAMW
  on the same gradients);
- the same population through JAX's vmapped Pallas kernels (interpret
  mode) against the port's population route (the plain versions on CPU
  tensors), and the port's kernel Functions under ``torch.func.vmap`` with
  the kernels' plain versions standing in for the launches: one launch of
  each for all replicas, equal to the solo plain route;
- a 3-seed population against 3 solo port Trainers (rtol 2e-4, as JAX's
  tests/test_multiseed.py holds its population to its solo Trainers), with
  and without the curricula;
- prune, a NaN replica losing selection, ``select``, ``save_replica`` into a
  Trainer, resume from ``save_population``, ``elbo_rank`` against JAX, and
  a 2-replica stochastic-pendulum population step against JAX (same noise,
  same Brownian keys).
"""
import dataclasses
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
from pendulum import SPendulum as JSPendulum  # noqa: E402

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch import random as jr  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.models import goku as goku_mod  # noqa: E402
from latentdiffeq_torch.ops import ode_cuda as oc  # noqa: E402
from latentdiffeq_torch.ops import recurrent_cuda as rc  # noqa: E402
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.train import (MultiSeedTrainer,  # noqa: E402
                                      TrainConfig, Trainer, load_checkpoint,
                                      losses)

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
CKPTS = ["goku_best_model.npz", "goku_pop8_winner.npz", "ttg_px_winner.npz"]
BETA = 0.4


def full(i, kernels=False, sde=False):
    """Full-width GOKU holding checkpoint ``i`` (of CKPTS, or with ``sde``
    the two stochastic-pendulum winners on the fixed-grid SPendulum)."""
    diffeq = (SPendulum() if sde else
              Pendulum(options=SolveOptions(adaptive=False, substeps=1)))
    tm = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=kernels, use_kernel_solver=kernels),
        *goku_default_layers(784, diffeq, device="cpu"))
    name = (["spendulum_pop4_winner.npz", "spendulum_adaptive_winner.npz"][i]
            if sde else CKPTS[i])
    load_checkpoint(os.path.join(ARTIFACTS, name), tm)
    return tm


def to_jax(tm, sde=False, pallas=False):
    diffeq = (JSPendulum() if sde else
              JPendulum(options=make_options(adaptive=False, substeps=1)))
    mt = JGOKUBasic(use_pallas_encoder=pallas, use_pallas_solver=pallas)
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), mt, 784, diffeq)
    jm = JModel.build(mt, enc, dec)
    _, treedef = jax.tree_util.tree_flatten(jm)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(p.detach().numpy()) for p in tm.parameters()])


def stack(models):
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *models)


def cfg_of(**kw):
    base = dict(lr=1e-3, decay=1e-3, batch_size=4, seq_len=10,
                save_best=False)
    base.update(kw)
    return TrainConfig(**base)


def jax_noise(key, B):
    """JAX's reparameterisation noise for ``key`` and the decoder's key:
    ((z0 eps, theta eps), dkey)."""
    skey, dkey = jax.random.split(key)
    k1, k2 = jax.random.split(skey)
    return (tuple(np.array(jax.random.normal(k, (B, 16))) for k in (k1, k2)),
            dkey)


def windows(S, B, T, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (S, B, T, 784))
    return x.astype(np.float32), (np.arange(T) * 0.05).astype(np.float32)


def jax_step(jms, x, t, keys):
    """JAX's vmapped loss and gradients."""
    def lf(m, xx, k):
        return jlosses.loss_batch(m, xx, jnp.asarray(t), BETA,
                                  variational=True, key=k)

    (loss, _), g = jax.jit(jax.vmap(jax.value_and_grad(lf, has_aux=True)))(
        jms, jnp.asarray(x), keys)
    return loss, g


def jax_adamw(jms, grads):
    """One step of JAX's ADAMW on every replica (vmapped)."""
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    st = jax.vmap(opt.init)(jms)
    upd, _ = jax.vmap(opt.update)(grads, st, jms)
    return joptim.apply_updates(jms, upd)


def port_noise(keys, B):
    eps = [jax_noise(k, B)[0] for k in keys]
    return tuple(torch.from_numpy(np.stack([e[j] for e in eps]))
                 for j in range(2))


def close(t, a, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol)


def close_grad(t, a, atol=1e-4):
    """Within ``atol`` of the gradient's size (at least 1): the trained
    checkpoints' gradients reach ~6, where float32 sums taken in another
    order part by more than 1e-4 absolute."""
    a = np.asarray(a)
    scale = max(float(np.abs(a).max()), 1.0)
    np.testing.assert_allclose(t.detach().numpy() / scale, a / scale,
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def population():
    ms = MultiSeedTrainer(full, cfg_of(), [0, 1, 2], device="cpu")
    return ms, stack([to_jax(ms.seed_model(i)) for i in range(3)])


def test_population_step_on_checkpoints_matches_jax(population):
    """One population step of the three checkpoints: each replica's loss,
    gradients and ADAMW update against JAX's vmapped step, same windows
    and noise."""
    _, jms = population
    ms = MultiSeedTrainer(full, cfg_of(), [0, 1, 2], device="cpu")
    S, B, T = 3, 4, 10
    x, t = windows(S, B, T, 0)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    lj, gj = jax_step(jms, x, t, keys)
    m = ms.train_step(torch.from_numpy(x), BETA, eps=port_noise(keys, B))
    close(m["loss"], lj)
    for p, g in zip(ms.params.values(), jax.tree_util.tree_leaves(gj)):
        close_grad(p.grad, g)
    # the update: JAX's ADAMW on the same (the port's) gradients. Where a
    # gradient is ~0, Adam's first step lr * g / (|g| + eps) turns its
    # rounding into an O(lr) change, so the two packages' own gradients
    # cannot be compared through it
    _, treedef = jax.tree_util.tree_flatten(jms)
    newj = jax_adamw(jms, jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(p.grad.numpy()) for p in ms.params.values()]))
    for p, a in zip(ms.params.values(), jax.tree_util.tree_leaves(newj)):
        close(p, a, 1e-6)
    assert ms.opt.t == 1


def test_population_route_matches_jax_vmapped_pallas_kernels(population):
    """JAX's Pallas kernels (interpret mode) under jax.vmap over the three
    checkpoints, against the port's population route on CPU tensors (the
    kernels' plain versions, one vmapped call): loss and gradients."""
    ms, _ = population
    jms = stack([to_jax(ms.seed_model(i), pallas=True) for i in range(3)])
    S, B, T = 3, 3, 8
    x, t = windows(S, B, T, 1)

    def lf(m, xx):
        return jlosses.loss_batch(m, xx, jnp.asarray(t), BETA,
                                  variational=False)

    (lj, _), gj = jax.jit(jax.vmap(jax.value_and_grad(lf, has_aux=True)))(
        jms, jnp.asarray(x))
    kern = MultiSeedTrainer(lambda i: full(i, kernels=True),
                            cfg_of(variational=False), [0, 1, 2],
                            device="cpu")
    rc.goku_heads_reference.calls = 0
    oc.solve_fixed_grid_batched_reference.calls = 0
    m = kern.train_step(torch.from_numpy(x), BETA)
    # one plain call each for the whole population (the CPU route)
    assert rc.goku_heads_reference.calls == 1
    assert oc.solve_fixed_grid_batched_reference.calls == 1
    close(m["loss"], lj)
    for p, g in zip(kern.params.values(), jax.tree_util.tree_leaves(gj)):
        close_grad(p.grad, g)


# -- the kernels' Functions under vmap, the plain versions standing in for
#    the launches -----------------------------------------------------------

ACTS = {0: tnn.identity, 1: tnn.relu, 2: tnn.tanh}
LAUNCHES = {}


def _heads_from_packed(buf, spec):
    heads = (tnn.Recurrent.rnn(spec.Dk, (spec.Hk,) * spec.L,
                               ACTS[spec.act]),
             tnn.Recurrent.lstm(spec.Dk, (spec.Hk,) * spec.L),
             tnn.Recurrent.lstm(spec.Dk, (spec.Hk,) * spec.L))
    off = 0
    with torch.no_grad():
        for p in rc._heads_params(*heads):
            p.copy_(buf[off:off + p.numel()].view(p.shape))
            off += p.numel()
    assert off == buf.numel()
    return heads


def _per_replica(fn, *args):
    pop = args[0].dim() == 4
    outs = [fn(*[a[s] for a in args]) for s in
            range(args[0].shape[0] if pop else 1)] if pop else [fn(*args)]
    return [torch.stack(o) if pop else o for o in zip(*outs)]


def _fake_fwd(spec, xs, wts, tape):
    assert spec.Dk == xs.shape[-1] and spec.Hk == spec.H
    LAUNCHES["fwd"] += 1
    z0, th, tp = _per_replica(
        lambda x, w: rc.goku_heads_taped_reference(
            *_heads_from_packed(w, spec), x), xs, wts)
    return z0, th, tp if tape else None


def _fake_bwd(spec, tape, g_z0, g_th, wts):
    LAUNCHES["bwd"] += 1
    return tuple(_per_replica(
        lambda tp, gz, gt, w: rc.goku_heads_sweep_reference(
            *_heads_from_packed(w, spec), tp, gz, gt), tape, g_z0, g_th,
        wts))


def _fake_rk(f, solver, u0s, ps, saveat, substeps=1):
    LAUNCHES["rk"] += 1
    with torch.no_grad():
        ys, ok, _ = oc.solve_fixed_grid_batched_reference(
            f, solver, u0s, ps, saveat, substeps=substeps)
    return ys, ok


def _fake_rk_bwd(f, solver, saveat, ys, ps, g, substeps=1):
    LAUNCHES["rk_bwd"] += 1
    return oc.solve_fixed_grid_batched_backward_reference(
        f, solver, saveat, ys, ps, g, substeps=substeps)


def _heads_route(pe_z0, pe_f, pe_b, xs):
    """goku_heads' card route, with a spec that takes CPU tensors."""
    heads = (pe_z0, pe_f, pe_b)
    params = rc._heads_params(*heads)
    H, L, act = rc.check_goku_heads(*heads, xs)
    spec = rc._Spec(L, xs.shape[-1], H, act, *rc.kernel_widths(
        xs.shape[-1], H))
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in [xs] + params)
    return rc._GokuHeadsFn.apply(spec, keep, xs, *params)[:2]


def _rk_route(f, solver, u0s, ps, saveat, *, substeps=1):
    ys, ok = oc._RKSolveFn.apply(f, solver, substeps, u0s, ps, saveat)
    stats = oc.fixed_grid_stats((u0s.shape[0],), saveat.shape[0] - 1,
                                substeps, oc.n_solution_stages(
                                    solver.tableau), device=u0s.device)
    return ys, ok, stats


def _small(seed, kernels=False):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=kernels, use_kernel_solver=kernels),
        *goku_default_layers(24, diffeq, hidden_dim_resnet=16,
                             latent_to_diffeq_dim=16,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu"))


def test_kernel_functions_under_vmap_launch_once_for_all_replicas(
        monkeypatch):
    """The goku_heads and RK Functions' vmap rules, with the plain versions
    standing in for the launches (the kernels need the card): a
    population step of three replicas makes one forward and one backward
    launch of each, the heads' packed weights carry the replica axis, and
    the losses and gradients equal the solo plain route's."""
    monkeypatch.setattr(rc, "_fwd_launch", _fake_fwd)
    monkeypatch.setattr(rc, "_bwd_launch", _fake_bwd)
    monkeypatch.setattr(oc, "solve_fixed_grid_batched_cuda", _fake_rk)
    monkeypatch.setattr(oc, "solve_fixed_grid_batched_bwd_cuda",
                        _fake_rk_bwd)
    monkeypatch.setattr(goku_mod, "goku_heads", _heads_route)
    monkeypatch.setattr(goku_mod, "solve_fixed_grid_batched", _rk_route)
    LAUNCHES.update(fwd=0, bwd=0, rk=0, rk_bwd=0)
    S, B, T = 3, 4, 6
    ms = MultiSeedTrainer(lambda s: _small(s, kernels=True),
                          cfg_of(batch_size=B, seq_len=T), [3, 5, 7],
                          device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = torch.rand(S, B, T, 24, generator=g)
    eps = tuple(torch.randn(S, B, 16, generator=g) for _ in range(2))
    m = ms.train_step(xs, BETA, eps=eps)
    assert LAUNCHES == dict(fwd=1, bwd=1, rk=1, rk_bwd=1)
    with torch.no_grad():
        ms.val_step(xs[0], BETA)
    assert LAUNCHES == dict(fwd=2, bwd=1, rk=2, rk_bwd=1)
    t = torch.arange(T) * 0.05
    for s, seed in enumerate((3, 5, 7)):
        solo = _small(seed)
        loss, _ = losses.loss_batch(solo, xs[s], t, BETA, eps=(eps[0][s],
                                                                eps[1][s]))
        loss.backward()
        np.testing.assert_allclose(float(m["loss"][s]), float(loss.detach()),
                                   rtol=1e-6)
        for (k, p), q in zip(solo.named_parameters(), ms.params.values()):
            torch.testing.assert_close(q.grad[s], p.grad, rtol=1e-4,
                                       atol=1e-6, msg=k)


# -- the population against solo Trainers --------------------------------

def _data():
    x = np.random.default_rng(0).random((16, 12, 24), dtype=np.float32)
    return x, x[:3]


CURRICULA = {"plain": {},
             "sliced": dict(progressive_training=True, start_seq_len=4,
                            prog_training_duration=3, prog_seq_len_step=2),
             "masked": dict(progressive_training=True, start_seq_len=4,
                            prog_training_duration=3, prog_seq_len_step=2,
                            masked_curriculum=True)}


def _small_cfg(**kw):
    base = dict(batch_size=8, seq_len=8, epochs=4, seed=0, save_best=False,
                n_cycle=1, start_beta=0.5, end_beta=0.5)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_population_equals_solo_trainers(curriculum):
    """Replica s of a 3-seed population trains like Trainer(init(s),
    replace(cfg, seed=s)): per-epoch validation losses and the best
    tracking within rtol 2e-4."""
    cfg = _small_cfg(**CURRICULA[curriculum])
    x, v = _data()
    seeds = [3, 5, 7]
    ms = MultiSeedTrainer(_small, cfg, seeds, device="cpu")
    ms.fit(x, v, verbose=False)
    pop = np.stack([r["val_loss"] for r in ms.history])
    for j, s in enumerate(seeds):
        tr = Trainer(_small(s), dataclasses.replace(cfg, seed=s),
                     device="cpu")
        solo = np.array([r["val_loss"] for r in tr.fit(x, v,
                                                       verbose=False)])
        np.testing.assert_allclose(pop[:, j], solo, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(ms.per_seed_best_vals[j],
                                   tr.best_val_loss, rtol=2e-4)
        assert [r["seq_len"] for r in ms.history] == [
            r["seq_len"] for r in tr.history]


def test_prune_continues_survivors():
    """Pruning to seeds (3, 7) after 2 epochs, then 2 more, equals a
    population of (3, 7) trained 4 epochs."""
    cfg = _small_cfg()
    x, v = _data()
    ms = MultiSeedTrainer(_small, cfg, [3, 5, 7], device="cpu")
    ms.fit(x, v, epochs=2, verbose=False)
    ms.prune([0, 2])
    assert ms.seeds == [3, 7] and ms.n_seeds == 2
    ms.fit(x, v, verbose=False)
    ref = MultiSeedTrainer(_small, cfg, [3, 7], device="cpu")
    ref.fit(x, v, verbose=False)
    for a, b in zip(ms.history[2:], ref.history[2:]):
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=1e-6)
    np.testing.assert_allclose(ms.per_seed_best_vals,
                               ref.per_seed_best_vals, rtol=1e-6)
    with pytest.raises(ValueError):
        ms.prune([])
    with pytest.raises(ValueError):
        ms.prune([5])


def test_nan_replica_loses_selection():
    cfg = _small_cfg(epochs=2)
    x, v = _data()
    ms = MultiSeedTrainer(_small, cfg, [3, 5, 7], device="cpu")
    with torch.no_grad():
        for p in ms.params.values():
            p[1].fill_(float("nan"))
    ms.fit(x, v, verbose=False)
    vals = ms.per_seed_best_vals
    assert vals[1] == float("inf") and np.isfinite(vals[0] + vals[2])
    assert ms.best_seed_index != 1
    assert ms.best_val_loss == min(vals[0], vals[2])
    _, info = ms.select(lambda st: np.array([0.1, np.nan, 0.2]))
    assert info["index"] == 2 and info["seed"] == 7


def test_select_and_save_replica_into_trainer(tmp_path):
    """select returns the argmax replica (best carry or live weights,
    whichever scored higher), and save_replica writes a checkpoint a
    Trainer restores: its validation loss matches the replica's (1e-6)."""
    cfg = _small_cfg(epochs=3)
    x, v = _data()
    ms = MultiSeedTrainer(_small, cfg, [3, 5, 7], device="cpu")
    ms.fit(x, v, verbose=False)
    calls = []

    def score(st):
        calls.append(st)
        return np.array([0.0, 0.9, 0.3]) if len(calls) == 1 else np.array(
            [0.5, 0.1, 0.95])

    model, info = ms.select(score)
    assert len(calls) == 2 and len(calls[0]) == 3
    assert info["index"] == 2 and info["from_best"] is True
    for p, q in zip(model.parameters(), ms.best_seed_model(2).parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    model, info = ms.select(score, include_best=False)
    assert info["index"] == 2 and info["from_best"] is False
    i = ms.best_seed_index
    path = str(tmp_path / "rep.npz")
    ms.save_replica(path, i)
    tr = Trainer(_small(0), dataclasses.replace(cfg, seed=ms.seeds[i]),
                 device="cpu")
    tr.restore(path)
    assert tr.best_val_loss == ms.per_seed_best_vals[i]
    val = float(tr.val_step(torch.from_numpy(v), ms.history[-1]["beta"])[
        "loss"])
    best_epoch = int(ms._best["epoch"][i])
    assert tr.epoch == best_epoch + 1
    np.testing.assert_allclose(val, ms.history[best_epoch]["val_loss"][i],
                               rtol=0, atol=1e-6)
    assert tr.opt.t == ms.opt.t
    ms.save_best(str(tmp_path / "best.npz"))
    tr.restore(str(tmp_path / "best.npz"))
    assert tr.best_val_loss == ms.best_val_loss


def test_resume_equals_uninterrupted(tmp_path):
    cfg = _small_cfg(**CURRICULA["sliced"])
    x, v = _data()
    ref = MultiSeedTrainer(_small, cfg, [3, 5], device="cpu")
    ref.fit(x, v, verbose=False)
    a = MultiSeedTrainer(_small, cfg, [3, 5], device="cpu")
    a.fit(x, v, epochs=2, verbose=False)
    path = str(tmp_path / "population.npz")
    a.save_population(path)
    b = MultiSeedTrainer(_small, cfg, [3, 5], device="cpu").restore(path)
    assert b.epoch == 2
    b.fit(x, v, verbose=False)
    for r, s in zip(ref.history[2:], b.history):
        np.testing.assert_array_equal(r["val_loss"], s["val_loss"])
    for p, q in zip(ref.params.values(), b.params.values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert ref.per_seed_best_vals == b.per_seed_best_vals
    with pytest.raises(ValueError, match="seeds"):
        MultiSeedTrainer(_small, cfg, [3, 6], device="cpu").restore(path)


def test_elbo_rank_matches_jax(population):
    ms, jms = population
    B, T = 5, 12
    x = np.random.default_rng(4).uniform(0, 1, (B, T, 784)).astype(
        np.float32)
    t = (np.arange(T) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(0)

    def one(m):
        return jlosses.loss_batch(m, jnp.asarray(x), jnp.asarray(t), 1.0,
                                  variational=True, key=key)[0]

    want = np.asarray(jax.vmap(one)(jms))
    eps, _ = jax_noise(key, B)
    got = ms.elbo_rank(x, t, eps=tuple(map(torch.from_numpy, eps)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_spendulum_population_step_matches_jax():
    """A 2-replica stochastic-pendulum population (the two committed
    SPendulum winners' weights on SRA1 over the grid): per-replica loss
    and gradients against JAX's vmapped step with the same noise and
    Brownian keys (atol 1e-4 of each gradient's size, as
    test_torch_sde_goku.py holds a solo step)."""
    ms = MultiSeedTrainer(lambda i: full(i, sde=True), cfg_of(), [0, 1],
                          device="cpu")
    jms = stack([to_jax(ms.seed_model(i), sde=True) for i in range(2)])
    S, B, T = 2, 4, 10
    x, t = windows(S, B, T, 5)
    keys = jax.random.split(jax.random.PRNGKey(6), S)

    def lf(m, xx, k):
        return jlosses.loss_batch(m, xx, jnp.asarray(t), BETA,
                                  variational=True, key=k)

    (lj, _), gj = jax.jit(jax.vmap(jax.value_and_grad(lf, has_aux=True)))(
        jms, jnp.asarray(x), keys)
    dkeys = torch.stack([jr.split(torch.from_numpy(
        np.asarray(k).astype(np.int64)))[1] for k in keys])
    m = ms.train_step(torch.from_numpy(x), BETA, eps=port_noise(keys, B),
                      keys=dkeys)
    close(m["loss"], lj)
    for p, g in zip(ms.params.values(), jax.tree_util.tree_leaves(gj)):
        close_grad(p.grad, g)


@pytest.mark.parametrize("kind", ["ode", "sde"])
def test_adaptive_population_equals_solo_trainers(kind):
    """Adaptive dynamics under the population's vmap: the masked step loop
    cannot stop early on batched flags (solve/adaptive.py::all_inactive),
    so it runs its whole budget of no-op steps, and each replica still
    trains like its solo Trainer (rtol 2e-4)."""
    from latentdiffeq_torch.solve import AdaptiveConfig
    from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig

    def init(seed):
        diffeq = (Pendulum(options=SolveOptions(
            adaptive=True, adaptive_cfg=AdaptiveConfig(max_steps=64)))
            if kind == "ode" else SPendulum(
                adaptive=True, adaptive_cfg=SDEAdaptiveConfig(
                    max_steps=64, depth_cap=4, max_steps_per_interval=6)))
        return LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
            24, diffeq, hidden_dim_resnet=16, latent_to_diffeq_dim=16,
            generator=torch.Generator().manual_seed(seed), device="cpu"))

    cfg = _small_cfg(epochs=1)
    x, v = _data()
    ms = MultiSeedTrainer(init, cfg, [3, 5], device="cpu")
    ms.fit(x, v, verbose=False)
    for j, s in enumerate([3, 5]):
        tr = Trainer(init(s), dataclasses.replace(cfg, seed=s), device="cpu")
        solo = [r["val_loss"] for r in tr.fit(x, v, verbose=False)]
        np.testing.assert_allclose([r["val_loss"][j] for r in ms.history],
                                   solo, rtol=2e-4)
