"""Parity of the PyTorch port's training pieces against the JAX package, on
the CPU: losses, the KL schedule, Flux ADAMW over three GOKU training
steps and two variational LatentODE steps, the pendulum renderer and data
generator, the trainer loop for both model types, and the rule that the
port never imports JAX or the JAX package."""
import ast
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
from latentdiffeq.models import LatentODE as JLatentODE  # noqa: E402
from latentdiffeq.models import NODE as JNODE  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import annealing as jann  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch import pendulum_data  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       LatentODE, NODE, default_layers,
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.train import (DataLoader, TrainConfig,  # noqa: E402
                                      Trainer, annealing, losses,
                                      sample_window, splitobs)
from latentdiffeq_torch.train.checkpoint import load_jax_params  # noqa: E402

SMALL = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
D_IN = 24


def small_pair(seed=0, scale=0.3):
    """A small GOKU (input 24, widths 16/32) in both packages, the same
    random weights (biases and initial states included)."""
    diffeq = JPendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(jax.random.PRNGKey(seed), JGOKUBasic(),
                               D_IN, diffeq, **SMALL)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    tdiffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    tenc, tdec = goku_default_layers(D_IN, tdiffeq, device="cpu", **SMALL)
    tm = LatentDiffEqModel.build(GOKUBasic(), tenc, tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


def data(B=6, T=10, seed=1):
    x = np.random.default_rng(seed).uniform(0, 1, (B, T, D_IN))
    return x.astype(np.float32), (np.arange(T) * 0.05).astype(np.float32)


@pytest.mark.parametrize("free_bits", [0.0, 0.1])
def test_kl_terms_match_jax(free_bits):
    rng = np.random.default_rng(0)
    mu = tuple(rng.normal(size=(5, k)).astype(np.float32) for k in (3, 4))
    lv = tuple(rng.normal(size=(5, k)).astype(np.float32) for k in (3, 4))
    a = losses.vector_kl(tuple(map(torch.from_numpy, mu)),
                         tuple(map(torch.from_numpy, lv)), free_bits)
    b = jlosses.vector_kl(tuple(map(jnp.asarray, mu)),
                          tuple(map(jnp.asarray, lv)), free_bits)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    x, y = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.vector_mse(torch.from_numpy(x), torch.from_numpy(y))),
        float(jlosses.vector_mse(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["plain", "mask_failures", "cur_len",
                                  "free_bits"])
def test_loss_batch_matches_jax(mode):
    jm, tm = small_pair()
    x, t = data()
    kw = {"mask_failures": mode == "mask_failures",
          "free_bits": 0.05 if mode == "free_bits" else 0.0}
    cur = 6 if mode == "cur_len" else None
    lj, mj = jlosses.loss_batch(
        jm, jnp.asarray(x), jnp.asarray(t), 0.7, variational=False,
        cur_len=None if cur is None else jnp.int32(cur), **kw)
    lt, mt = losses.loss_batch(tm, torch.from_numpy(x), torch.from_numpy(t),
                               0.7, variational=False, cur_len=cur, **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for k in ("rec", "kl"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5)
    assert int(mt["n_failed"]) == int(mj["n_failed"]) == 0
    assert int(mt["n_rhs_evals"]) == int(mj["n_rhs_evals"])


@pytest.mark.parametrize("args", [(1500, 0.0, 1.0, 4, 0.9), (37, 0.1, 0.8,
                                                            3, 0.5),
                                  (10, 0.0, 1.0, 4, 0.5)])
def test_frange_cycle_linear_equals_jax(args):
    np.testing.assert_array_equal(annealing.frange_cycle_linear(*args),
                                  jann.frange_cycle_linear(*args))


def test_split_window_and_loader():
    x = torch.arange(10 * 8 * 2, dtype=torch.float32).reshape(10, 8, 2)
    tr, va = splitobs(x, 0.9)
    assert tr.shape[0] == 9 and va.shape[0] == 1
    w = sample_window(x, 5, generator=torch.Generator().manual_seed(0))
    assert w.shape == (10, 5, 2)
    start = int(w[0, 0, 0]) // 2
    assert 0 <= start < 3
    torch.testing.assert_close(w, x[:, start:start + 5])
    assert sample_window(x, 8).shape == (10, 8, 2)
    dl = DataLoader(x, 3, generator=torch.Generator().manual_seed(0))
    batches = list(dl)
    assert len(dl) == 3 and all(b.shape == (3, 8, 2) for b in batches)
    rows = torch.cat([b[:, 0, 0] for b in batches])
    assert len(set(rows.tolist())) == 9


def test_adamw_three_training_steps_track_jax():
    """Three deterministic (variational=False) GOKU training steps with
    Flux ADAMW on fixed windows: the parameters track the JAX package at
    atol 1e-5."""
    jm, tm = small_pair(seed=3, scale=0.2)
    cfg = TrainConfig(lr=1e-3, decay=1e-3, batch_size=6, seq_len=8,
                      variational=False, save_best=False)
    trainer = Trainer(tm, cfg, device="cpu")
    jopt = joptim.adamw(cfg.lr, 0.9, 0.999, cfg.decay)
    jstate = jopt.init(jm)
    t = jnp.arange(cfg.seq_len, dtype=jnp.float32) * cfg.dt

    @jax.jit
    def jstep(m, st, x, beta):
        def lf(mm):
            return jlosses.loss_batch(mm, x, t, beta, variational=False)
        (loss, _), g = jax.value_and_grad(lf, has_aux=True)(m)
        upd, st = jopt.update(g, st, m)
        return joptim.apply_updates(m, upd), st, loss

    full, _ = data(B=6, T=20, seed=4)
    for step, (start, beta) in enumerate(((0, 0.0), (5, 0.3), (11, 1.0))):
        x = full[:, start:start + cfg.seq_len]
        jm, jstate, lj = jstep(jm, jstate, jnp.asarray(x), beta)
        mt = trainer.train_step(torch.from_numpy(x), beta)
        np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-5)
        for p, leaf in zip(tm.parameters(), jax.tree_util.tree_leaves(jm)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {step}")
    assert trainer.opt.t == int(jstate["t"]) == 3


LODE = dict(hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8)


def latent_ode_pair(seed=0, scale=0.2, use_kernel_solve=False):
    """A narrow LatentODE (input 24, latent 6, field 6-16-16-6) in both
    packages, the same random weights."""
    kn, kl = jax.random.split(jax.random.PRNGKey(seed))
    jnode = JNODE(kn, 6, hidden_dim=16,
                  options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(kl, JLatentODE(), D_IN, jnode, **LODE)
    jm = JModel.build(JLatentODE(), enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    mt = LatentODE(use_kernel_solve=use_kernel_solve)
    node = NODE(6, hidden_dim=16, device="cpu",
                options=SolveOptions(adaptive=False, substeps=1))
    tenc, tdec = default_layers(mt, D_IN, node, device="cpu", **LODE)
    tm = LatentDiffEqModel.build(mt, tenc, tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


@pytest.mark.parametrize("use_kernel_solve", [False, True])
def test_latent_ode_two_adamw_steps_track_jax(use_kernel_solve):
    """Two variational LatentODE steps with Flux ADAMW (decay 1e-4), the
    reparameterisation noise fixed to what the JAX model draws from its
    key: loss and KL agree to rtol 1e-5 and every parameter to atol 1e-5
    (one Adam step moves a weight by lr = 1e-3, so 1e-5 is 1 % of a step).
    With the switch on, CPU tensors take the gradient of the solve with
    the hand-written reverse sweep of the backward kernel."""
    jm, tm = latent_ode_pair(seed=3, use_kernel_solve=use_kernel_solve)
    cfg = TrainConfig(lr=1e-3, decay=1e-4, batch_size=6, seq_len=8, seed=1,
                      save_best=False)
    trainer = Trainer(tm, cfg, device="cpu")
    jopt = joptim.adamw(cfg.lr, 0.9, 0.999, cfg.decay)
    jstate = jopt.init(jm)
    t = jnp.arange(cfg.seq_len, dtype=jnp.float32) * cfg.dt

    @jax.jit
    def jstep(m, st, x, beta, key):
        def lf(mm):
            return jlosses.loss_batch(mm, x, t, beta, variational=True,
                                      key=key)
        (loss, metrics), g = jax.value_and_grad(lf, has_aux=True)(m)
        upd, st = jopt.update(g, st, m)
        return joptim.apply_updates(m, upd), st, loss, metrics["kl"]

    full, _ = data(B=6, T=20, seed=4)
    for step, (start, beta) in enumerate(((2, 0.3), (9, 1.0))):
        x = full[:, start:start + cfg.seq_len]
        key = jax.random.PRNGKey(10 + step)
        eps = torch.from_numpy(np.array(jax.random.normal(
            jax.random.split(key)[0], (6, 6))))
        jm, jstate, lj, klj = jstep(jm, jstate, jnp.asarray(x), beta, key)
        mt = trainer.train_step(torch.from_numpy(x), beta, eps=eps)
        np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-5)
        np.testing.assert_allclose(float(mt["kl"]), float(klj), rtol=1e-5)
        assert int(mt["n_rhs_evals"]) == 6 * 7 * 6
        for p, leaf in zip(tm.parameters(), jax.tree_util.tree_leaves(jm)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"step {step}")
    assert trainer.opt.t == int(jstate["t"]) == 2


@pytest.mark.parametrize("use_kernel_solve", [False, True])
def test_latent_ode_trainer_save_restore_round_trip(tmp_path,
                                                    use_kernel_solve):
    """Trainer.fit on a LatentODE (single-tensor latent, parameters in the
    diffeq slot): finite losses, a best snapshot, and a checkpoint that
    restores the weights, Adam moments and epoch into a fresh trainer,
    which then steps exactly as the first one does."""
    _, tm = latent_ode_pair(seed=5, use_kernel_solve=use_kernel_solve)
    x = np.random.default_rng(6).uniform(0, 1, (20, 12, D_IN)).astype(
        np.float32)
    tr, va = splitobs(x, 0.8)
    cfg = TrainConfig(decay=1e-4, seed=1, batch_size=8, seq_len=8, epochs=10,
                      checkpoint_dir=str(tmp_path))
    trainer = Trainer(tm, cfg, device="cpu")
    hist = trainer.fit(tr, va, epochs=2, verbose=False)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               and np.isfinite(h["kl"]) for h in hist)
    assert trainer.best_val_loss == min(h["val_loss"] for h in hist)
    assert set(trainer.best["model"]) == set(tm.state_dict())
    assert "decoder.diffeq.dudt.layers.1.W" in trainer.best["model"]
    path = str(tmp_path / "latent_ode.npz")
    trainer.save(path)
    with np.load(path) as d:
        assert "leaf::model/decoder/diffeq/dudt/layers/2/b" in d.files
        assert "leaf::opt_state/v/decoder/diffeq/dudt/layers/0/W" in d.files
    _, other = latent_ode_pair(seed=7, use_kernel_solve=use_kernel_solve)
    trainer2 = Trainer(other, cfg, device="cpu").restore(path)
    assert trainer2.epoch == 2 and trainer2.opt.t == trainer.opt.t
    assert trainer2.best_val_loss == trainer.best_val_loss
    for a, b in zip(trainer.model.parameters(), trainer2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(trainer.opt.m + trainer.opt.v,
                    trainer2.opt.m + trainer2.opt.v):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    eps = torch.from_numpy(np.random.default_rng(8).normal(
        size=(8, 6)).astype(np.float32))
    xb = torch.from_numpy(tr[:8, :8])
    la = trainer.train_step(xb, 0.5, eps=eps)["loss"]
    lb = trainer2.train_step(xb, 0.5, eps=eps)["loss"]
    assert float(la) == float(lb)
    for a, b in zip(trainer.model.parameters(), trainer2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_render_frames_match_jax():
    from create_data import render_frame
    angles = np.array([-1.2, -0.3, 0.0, 0.4, 1.0, 2.9], np.float32)
    ref = np.stack([np.asarray(render_frame(jnp.float32(a)))
                    for a in angles])
    got = pendulum_data.render_frames(torch.from_numpy(angles))
    assert got.shape == (6, 28, 28)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_dataset_matches_jax_generator():
    """Initial conditions are identical, and both generators integrate
    with adaptive Tsit5 at rtol 1e-3, atol 1e-6 and emit the frames by
    dense output. The angles, which the frames are drawn from, agree to
    1e-4 on these rows, the velocities to 5e-4 (5e-3 for both with the
    fixed grid the port used before, whose angles were up to 2.7e-3 off).
    What is left is float32 rounding read by the step controller: the
    first step's error estimate is at rounding level, so any two float32
    evaluations choose different next steps and their dense outputs differ
    by the solve's own error. The JAX solve jitted and run eagerly differ
    from each other by as much as the two packages do, and in float64 the
    two packages agree to 1e-10 with equal step counts on every row
    (scripts/dataset_vs_jax.py; the "pendulum-dataset" case of
    test_solve_adaptive_matches_jax)."""
    from create_data import generate_dataset as jgen
    lat_j, u0_j, ps_j, _ = jgen(n_traj=6)
    lat, u0s, ps, frames = pendulum_data.generate_dataset(n_traj=6,
                                                          device="cpu")
    np.testing.assert_array_equal(u0s.numpy(), u0_j)
    np.testing.assert_array_equal(ps.numpy(), ps_j)
    assert lat.shape == (6, 100, 2) and frames.shape == (6, 100, 28, 28)
    np.testing.assert_allclose(lat[..., 0].numpy(), lat_j[..., 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(lat[..., 1].numpy(), lat_j[..., 1], rtol=0,
                               atol=5e-4)
    assert float(frames.min()) >= 0 and float(frames.max()) <= 1


def test_trainer_fit_tracks_best_nan_safely(tmp_path):
    _, tm = small_pair(seed=5, scale=0.2)
    x = np.random.default_rng(6).uniform(0, 1, (20, 12, D_IN)).astype(
        np.float32)
    tr, va = splitobs(x, 0.8)
    cfg = TrainConfig(batch_size=8, seq_len=8, epochs=10,
                      checkpoint_dir=str(tmp_path))
    trainer = Trainer(tm, cfg, device="cpu")
    hist = trainer.fit(tr, va, epochs=2, verbose=False)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
               for h in hist)
    assert trainer.best_val_loss == min(h["val_loss"] for h in hist)
    assert os.path.exists(tmp_path / "best_model.npz")
    best = trainer.best

    def nan_val(val, beta):
        return {"loss": torch.tensor(float("nan"))}

    trainer.val_step = nan_val
    trainer.fit(tr, va, epochs=3, verbose=False)
    assert np.isnan(trainer.history[-1]["val_loss"])
    assert trainer.best is best and np.isfinite(trainer.best_val_loss)
    trainer2 = Trainer(small_pair(seed=7)[1], cfg, device="cpu")
    trainer2.restore(str(tmp_path / "best_model.npz"))
    assert trainer2.epoch == best["epoch"] + 1
    for k, v in best["model"].items():
        torch.testing.assert_close(trainer2.model.state_dict()[k], v)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "latentdiffeq_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "latentdiffeq", "examples", "bench",
                       "flax", "optax"):
                bad.append(f"{os.path.relpath(f, ROOT)}: {mod}")
        src = open(f).read()
        if "__import__(" in src or "importlib" in src:
            bad.append(f"{os.path.relpath(f, ROOT)}: dynamic import")
    assert not bad, bad
