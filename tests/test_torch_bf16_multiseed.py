"""A bfloat16 population (``MultiSeedTrainer`` over bf16 GOKU replicas, the
recipe of ``ttg_bf16_px_winner.npz``: ``train_goku.py --seeds 8 --masked
--dtype bf16 --select-by pixel``) against the JAX package and against solo
bf16 Trainers, on the CPU.

- one population step of the three committed bf16 checkpoints against
  JAX's vmapped step on the same windows and bf16 noise: the loss, and each
  gradient, per replica, at most twice as far (in the 2-norm) from JAX's
  float32 evaluation of the same bf16 weights as JAX's bf16 gradient is,
  plus 2^-8 of its norm (tests/test_torch_bf16.py holds the heads so in
  the largest element; through the whole model, the LSTMs' h0 gradients,
  ~5e-3 at the end of the backward recursion, part from JAX_f32 by up to
  2.8x JAX's own gap in their largest element: PyTorch rounds every
  operation of the bf16 backward, XLA keeps fused ones in float32); the
  ADAMW update on the same gradients within one bf16 step;
- 3 bf16 seeds against 3 solo bf16 Trainers: the noise is drawn in bf16 by
  both, so replica s draws what its Trainer draws; validation losses within
  rtol 2^-7 (one bf16 step of relative size: the batched products round in
  another order than the solo ones, and a bf16 rounding flip moves a
  weight by a step);
- the heads kernel's Function under vmap in bf16 with the plain versions
  standing in for the launches: one launch each, bf16 tapes and gradients;
- bf16 population and replica checkpoints round trip bit for bit; the
  pixel selection and the warm start run on a bf16 population.
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

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq_torch import pixel_observable as px  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (  # noqa: E402
    GOKUBasic, LatentDiffEqModel, goku_default_layers)
from latentdiffeq_torch.models import goku as goku_mod  # noqa: E402
from latentdiffeq_torch.ops import recurrent_cuda as rc  # noqa: E402
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.pendulum_data import generate_dataset  # noqa: E402
from latentdiffeq_torch.train import (  # noqa: E402
    MultiSeedTrainer, TrainConfig, Trainer, load_checkpoint)
from test_torch_multiseed import _heads_route  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
CKPTS = ["goku_bf16_gate.npz", "goku_bf16_winner.npz",
         "ttg_bf16_px_winner.npz"]
BETA = 0.4
BF = torch.bfloat16


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def bf16_step(x) -> float:
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def full(i):
    """Full-width bf16 GOKU holding checkpoint CKPTS[i]."""
    tm = LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
        784, Pendulum(options=SolveOptions(adaptive=False, substeps=1)),
        device="cpu", dtype=BF))
    load_checkpoint(os.path.join(ARTIFACTS, CKPTS[i]), tm)
    return tm


def jax_stack(models, dtype):
    """JAX GOKU models holding the port models' weights in ``dtype``,
    stacked on a leading replica axis."""
    mt = JGOKUBasic()
    enc, dec = jdefault_layers(
        jax.random.PRNGKey(0), mt, 784,
        JPendulum(options=make_options(adaptive=False, substeps=1)),
        dtype=dtype)
    treedef = jax.tree_util.tree_structure(JModel.build(mt, enc, dec))
    jms = [jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(f32(p)).astype(dtype) for p in m.parameters()])
        for m in models]
    return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jms)


def cfg_of(**kw):
    base = dict(lr=1e-3, decay=1e-3, batch_size=4, seq_len=10,
                save_best=False)
    base.update(kw)
    return TrainConfig(**base)


def test_bf16_population_step_matches_jax_vmapped_step():
    """One population step of the three bf16 checkpoints: loss and
    gradients against JAX's vmapped bf16 step (same windows, same bf16
    noise), then one ADAMW update on the port's gradients against JAX's."""
    ms = MultiSeedTrainer(full, cfg_of(), [0, 1, 2], device="cpu")
    assert all(p.dtype == BF for p in ms.params.values())
    S, B, T = 3, 4, 10
    x = np.random.default_rng(0).uniform(0, 1, (S, B, T, 784)).astype(
        np.float32)
    t = (np.arange(T) * 0.05).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    models = [ms.seed_model(i) for i in range(S)]
    jb, jf = jax_stack(models, jnp.bfloat16), jax_stack(models, jnp.float32)

    def step(jms):
        def lf(m, xx, k):
            return jlosses.loss_batch(m, xx, jnp.asarray(t), BETA,
                                      variational=True, key=k)

        (loss, _), g = jax.jit(jax.vmap(jax.value_and_grad(
            lf, has_aux=True)))(jms, jnp.asarray(x), keys)
        return f32(loss), [f32(a) for a in jax.tree_util.tree_leaves(g)]

    def normals(key):
        k1, k2 = jax.random.split(jax.random.split(key)[0])
        return [f32(jax.random.normal(k, (B, 16), jnp.bfloat16))
                for k in (k1, k2)]

    eps = [normals(k) for k in keys]
    eps = tuple(torch.from_numpy(np.stack([e[j] for e in eps])).to(BF)
                for j in range(2))
    (lb, gb), (lf_, gf) = step(jb), step(jf)
    m = ms.train_step(torch.from_numpy(x), BETA, eps=eps)
    assert m["loss"].dtype == torch.float32     # x - x_hat promotes
    lp = f32(m["loss"])
    assert np.abs(lp - lf_).max() <= 2 * np.abs(lb - lf_).max() + 1e-3, (
        lp, lb, lf_)
    n = np.linalg.norm
    for (name, p), b, f in zip(ms.params.items(), gb, gf):
        g = f32(p.grad)
        assert p.grad.dtype == BF, name
        for r in range(S):
            assert n(g[r] - f[r]) <= 2 * n(b[r] - f[r]) + n(f[r]) / 256, (
                name, r, n(g[r] - f[r]), n(b[r] - f[r]), n(f[r]))
    # the update: JAX's ADAMW on the port's own bf16 gradients
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    _, treedef = jax.tree_util.tree_flatten(jb)
    jg = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(f32(p.grad)).astype(jnp.bfloat16)
        for p in ms.params.values()])
    jm0 = jax_stack(models, jnp.bfloat16)
    upd, _ = jax.vmap(opt.update)(jg, jax.vmap(opt.init)(jm0), jm0)
    new = jax.tree_util.tree_leaves(joptim.apply_updates(jm0, upd))
    for p, a in zip(ms.params.values(), new):
        ref = f32(a)
        assert np.abs(f32(p) - ref).max() <= bf16_step(ref)


def small(seed, kernels=False):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=kernels, use_kernel_solver=kernels),
        *goku_default_layers(24, diffeq, hidden_dim_resnet=16,
                             latent_to_diffeq_dim=16,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu", dtype=BF))


def small_cfg(**kw):
    base = dict(batch_size=8, seq_len=8, epochs=3, seed=0, save_best=False,
                n_cycle=1, start_beta=0.5, end_beta=0.5)
    base.update(kw)
    return TrainConfig(**base)


def data():
    x = np.random.default_rng(0).random((16, 12, 24), dtype=np.float32)
    return x, x[:3]


def test_bf16_population_equals_solo_trainers():
    """Replica s of a 3-seed bf16 population trains like Trainer(init(s),
    replace(cfg, seed=s)): the noise is drawn in bf16 by both (the
    population's draws equal the Trainer's bit for bit), and the
    validation losses agree within rtol 2^-7."""
    cfg = small_cfg()
    x, v = data()
    seeds = [3, 5, 7]
    ms = MultiSeedTrainer(small, cfg, seeds, device="cpu")
    eps = ms._eps(8)
    assert all(e.dtype == BF for e in eps)
    ms = MultiSeedTrainer(small, cfg, seeds, device="cpu")
    ms.fit(x, v, verbose=False)
    pop = np.stack([r["val_loss"] for r in ms.history])
    for j, s in enumerate(seeds):
        tr = Trainer(small(s), dataclasses.replace(cfg, seed=s),
                     device="cpu")
        g = torch.Generator().manual_seed(s)
        solo_eps = tuple(torch.randn((8, 16), generator=g, dtype=BF)
                         for _ in range(2))
        for a, b in zip(solo_eps, eps):
            torch.testing.assert_close(a, b[j], rtol=0, atol=0)
        solo = np.array([r["val_loss"] for r in tr.fit(x, v,
                                                       verbose=False)])
        np.testing.assert_allclose(pop[:, j], solo, rtol=2 ** -7)


LAUNCHES = {}


def _fake_fwd(spec, xs, wts, tape):
    """The forward launch, run by the plain tape-writing version per
    replica on the heads rebuilt from each replica's packed weights."""
    from latentdiffeq_torch import nn as tnn
    assert wts.dtype == torch.float32 and xs.dtype == BF
    if xs.dim() == 3:                      # one replica: no replica axis
        z0, th, tp = _fake_fwd(spec, xs[None], wts[None], tape)
        return z0[0], th[0], None if tp is None else tp[0]
    LAUNCHES["fwd"] += 1
    outs = []
    for s in range(xs.shape[0]):
        heads = (tnn.Recurrent.rnn(spec.Dk, (spec.Hk,) * spec.L, tnn.relu,
                                   dtype=BF),
                 tnn.Recurrent.lstm(spec.Dk, (spec.Hk,) * spec.L, dtype=BF),
                 tnn.Recurrent.lstm(spec.Dk, (spec.Hk,) * spec.L, dtype=BF))
        off = 0
        with torch.no_grad():
            for p in rc._heads_params(*heads):
                p.copy_(wts[s, off:off + p.numel()].view(p.shape))
                off += p.numel()
        outs.append(rc.goku_heads_taped_reference(*heads, xs[s]) + (heads,))
    LAUNCHES["heads"] = [o[3] for o in outs]
    z0, th, tp = (torch.stack([o[k] for o in outs]) for k in range(3))
    return z0, th, tp if tape else None


def _fake_bwd(spec, tape, g_z0, g_th, wts):
    assert tape.dtype == g_z0.dtype == BF
    if tape.dim() == 3:
        return tuple(a[0] for a in _fake_bwd(spec, tape[None], g_z0[None],
                                             g_th[None], wts[None]))
    LAUNCHES["bwd"] += 1
    res = [rc.goku_heads_sweep_reference(*LAUNCHES["heads"][s], tape[s],
                                         g_z0[s], g_th[s])
           for s in range(tape.shape[0])]
    return tuple(torch.stack([r[k] for r in res]) for k in range(3))


def test_bf16_heads_function_under_vmap_launches_once(monkeypatch):
    """The heads' Function under the population's vmap in bf16, the plain
    versions standing in for the launches: one forward and one sweep
    launch for all replicas, on float32 packed weights and bf16 tapes;
    every gradient in bf16 and, against each replica's solo call of the
    same Function, within 2^-6 of its size (the batched products round in
    another order)."""
    monkeypatch.setattr(rc, "_fwd_launch", _fake_fwd)
    monkeypatch.setattr(rc, "_bwd_launch", _fake_bwd)
    monkeypatch.setattr(goku_mod, "goku_heads", _heads_route)
    LAUNCHES.update(fwd=0, bwd=0)
    S, B, T = 3, 4, 6
    ms = MultiSeedTrainer(lambda s: small(s, kernels=True),
                          small_cfg(batch_size=B, seq_len=T), [3, 5, 7],
                          device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = torch.rand(S, B, T, 24, generator=g)
    eps = tuple(torch.randn(S, B, 16, generator=g).to(BF) for _ in range(2))
    m = ms.train_step(xs, BETA, eps=eps)
    assert (LAUNCHES["fwd"], LAUNCHES["bwd"]) == (1, 1)
    assert bool(torch.isfinite(m["loss"]).all())
    from latentdiffeq_torch.train import losses
    t = torch.arange(T) * 0.05
    for s, seed in enumerate((3, 5, 7)):
        solo = small(seed, kernels=True)
        loss, _ = losses.loss_batch(solo, xs[s], t, BETA,
                                    eps=(eps[0][s], eps[1][s]))
        loss.backward()
        np.testing.assert_allclose(float(m["loss"][s]), float(loss.detach()),
                                   rtol=2 ** -6)
        for (k, p), q in zip(solo.named_parameters(), ms.params.values()):
            assert q.grad.dtype == BF, k
            a, b = f32(q.grad[s]), f32(p.grad)
            assert np.abs(a - b).max() <= max(np.abs(b).max(), 1e-2) / 64, k


def test_bf16_population_checkpoints_round_trip(tmp_path):
    """save_population -> restore (live and best weights, moments) and
    save_replica -> Trainer.restore keep every bf16 tensor bit for bit."""
    cfg = small_cfg(epochs=2)
    x, v = data()
    ms = MultiSeedTrainer(small, cfg, [3, 5], device="cpu")
    ms.fit(x, v, verbose=False)
    path = str(tmp_path / "pop.npz")
    ms.save_population(path)
    back = MultiSeedTrainer(small, cfg, [3, 5], device="cpu").restore(path)
    for a, b in zip(list(ms.params.values()) + ms.opt.m + ms.opt.v,
                    list(back.params.values()) + back.opt.m + back.opt.v):
        assert b.dtype == BF
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ms._best["params"]:
        torch.testing.assert_close(ms._best["params"][k],
                                   back._best["params"][k], rtol=0, atol=0)
    rp = str(tmp_path / "replica.npz")
    ms.save_replica(rp, 1)
    tr = Trainer(small(5), cfg, device="cpu").restore(rp)
    best = ms.best_seed_model(1)
    for a, b in zip(tr.model.parameters(), best.parameters()):
        assert a.dtype == BF
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def video():
    _, _, _, frames = generate_dataset(n_traj=6, device="cpu")
    return frames.reshape(6, 100, 784)[:, :30].numpy()


def test_bf16_population_pixel_selection_and_warm_start_run(video):
    """A bf16 population of full-input GOKUs (784 pixels, narrow widths):
    the pixel warm start (its loss in float32) and the selection by the
    pixel score run; the scores read in float64 are finite and equal each
    replica's solo pixel_angle_corr within 1e-2."""
    def init(seed):
        diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
        return LatentDiffEqModel.build(GOKUBasic(), *goku_default_layers(
            784, diffeq, hidden_dim_resnet=16, latent_to_diffeq_dim=16,
            generator=torch.Generator().manual_seed(seed), device="cpu",
            dtype=BF))

    ms = MultiSeedTrainer(init, small_cfg(), [3, 5], device="cpu")
    _, losses = px.warm_start_pendulum(ms.stacked_models, video, 0.05,
                                       window=20, offsets=(0, 10), steps=3)
    assert losses.dtype == torch.float32 and losses.shape == (3, 2)
    assert bool(torch.isfinite(losses).all())
    assert all(p.dtype == BF for p in ms.params.values())
    th_obs = px.pixel_angles(video)
    model, info = ms.select(lambda st: px.population_pixel_scores(
        st, video, th_obs, 0.05))
    assert np.isfinite(info["scores_live"]).all()
    for i in range(2):
        solo = px.pixel_angle_corr(ms.seed_model(i), video, th_obs, 0.05)
        assert abs(solo - info["scores_live"][i]) <= 1e-2
    assert info["score"] == max(info["scores_live"] + (
        info["scores_best"] or []))
