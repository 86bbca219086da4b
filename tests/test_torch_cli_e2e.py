"""The port's training CLIs run end to end on the CPU (``--device cpu``,
one epoch, batch 4, windows of 8 frames, tiny synthetic data through a
patched loader, outputs under ``tmp_path``), and their numbers against the
JAX package's: ``forecast.py`` against JAX's ``model.forecast`` on
``benchmarks/artifacts/goku_best_model.npz`` (four validation videos,
per-frame error rtol 1e-4), ``visualize_val_image``'s plotted numbers
against JAX's forward on carried weights with the same numpy draws
(1e-5), and ``train_vdp.py``'s data against JAX's ``make_data``.

The figures never touch the training streams: a run with ``--no-viz``
trains the same weights bit for bit; ``--resume`` from a run's checkpoint
equals the uninterrupted run bit for bit."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "custom_dynamics"))

import train_vdp as jtv  # noqa: E402

from latentdiffeq.train.visualize import (  # noqa: E402
    visualize_val_image as jvisualize)
from latentdiffeq_torch.custom_dynamics import Kuramoto, VanDerPol, vdp_f  # noqa: E402
from latentdiffeq_torch.examples.custom_dynamics import (  # noqa: E402
    train_kuramoto as ptk, train_vdp as ptv)
from latentdiffeq_torch.examples.pendulum import (  # noqa: E402
    forecast as pfc, train_goku as ptg, train_latent_ode as ptl,
    train_original_data as pto)
from latentdiffeq_torch.pendulum_data import generate_dataset  # noqa: E402
from latentdiffeq_torch.solve import (ODEProblem, make_options,  # noqa: E402
                                      solve_ensemble)
from latentdiffeq_torch.train.visualize import (  # noqa: E402
    val_image_data, visualize_val_image)
from test_torch_goku import best  # noqa: E402,F401
from test_torch_train import D_IN, small_pair  # noqa: E402

SMALL = ["--device", "cpu", "--epochs", "1", "--batch-size", "4",
         "--seq-len", "8"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_video(n=20, T=12, seed=0):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, T, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (n, 1)).astype(np.float32)
    frames = rng.uniform(0, 1, (n, T, 28, 28)).astype(np.float32)
    return latent, latent[:, 0].copy(), ps, frames


@pytest.fixture
def video(monkeypatch, tmp_path):
    data = synthetic_video()
    for mod in (ptg, ptl, pfc):
        monkeypatch.setattr(mod, "load_or_generate", lambda *a, **k: data)
    return data


def out(monkeypatch, mod, tmp_path, name):
    d = str(tmp_path / name)
    monkeypatch.setattr(mod, "OUTPUT_DIR", d)
    return d


def finite(history):
    assert history and all(np.isfinite(h["train_loss"]).all()
                           and np.isfinite(h["val_loss"]).all()
                           for h in history)


def same_weights(a, b):
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_train_goku_figures_no_viz_and_resume(video, monkeypatch,
                                              tmp_path):
    a_dir = out(monkeypatch, ptg, tmp_path, "viz")
    a = ptg.main(SMALL)
    finite(a.history)
    assert os.path.exists(os.path.join(a_dir, "best_model.npz"))
    assert os.path.exists(os.path.join(a_dir, "visualization", "fig_0.png"))
    b_dir = out(monkeypatch, ptg, tmp_path, "noviz")
    b = ptg.main(SMALL + ["--no-viz"])
    assert not os.path.exists(os.path.join(b_dir, "visualization"))
    same_weights(a.model, b.model)
    # two epochs straight, against a 2-epoch run interrupted after its
    # first epoch (the KL schedule spans --epochs) and resumed from its
    # checkpoint by --resume
    out(monkeypatch, ptg, tmp_path, "straight")
    c = ptg.main(SMALL + ["--no-viz", "--epochs", "2"])

    class Interrupted(ptg.Trainer):
        def fit(self, *args, **kw):
            return super().fit(*args, epochs=1, **kw)

    i_dir = out(monkeypatch, ptg, tmp_path, "interrupted")
    with monkeypatch.context() as m:
        m.setattr(ptg, "Trainer", Interrupted)
        ptg.main(SMALL + ["--no-viz", "--epochs", "2"])
    out(monkeypatch, ptg, tmp_path, "resumed")
    d = ptg.main(SMALL + ["--no-viz", "--epochs", "2", "--resume",
                          os.path.join(i_dir, "best_model.npz")])
    assert [h["epoch"] for h in d.history] == [1]
    assert d.history[0]["train_loss"] == c.history[1]["train_loss"]
    same_weights(c.model, d.model)


@pytest.mark.parametrize("argv", [
    ["--seeds", "2", "--masked", "--select-by", "pixel", "--warm-start",
     "--warm-steps", "2"],
    ["--seeds", "2", "--epochs", "2", "--prune-at", "1", "--prune-keep",
     "1"],
    ["--dtype", "bf16", "--no-viz"],
], ids=["population-recipe", "population-prune", "bf16"])
def test_train_goku_recipe_flags_run(argv, video, monkeypatch, tmp_path,
                                     capsys):
    d = out(monkeypatch, ptg, tmp_path, "run")
    if "--warm-start" in argv:    # its windows start at frames 0, 25, 50
        long = synthetic_video(T=100)
        monkeypatch.setattr(ptg, "load_or_generate", lambda *a, **k: long)
    res = ptg.main(SMALL + argv)
    finite(res.history)
    assert os.path.exists(os.path.join(d, "best_model.npz"))
    if "--seeds" in argv:
        printed = capsys.readouterr().out
        assert "winner: seed" in printed
        if "--prune-at" in argv:
            assert res.n_seeds == 1 and "pruned to seeds" in printed
            assert [h["epoch"] for h in res.history] == [0, 1]
        else:
            assert res.n_seeds == 2
    else:
        assert next(res.model.parameters()).dtype == torch.bfloat16


@pytest.mark.parametrize("argv", [["--pallas-solve"],
                                  ["--pallas-solve", "--seeds", "2"]],
                         ids=["solo", "seeds2"])
def test_train_latent_ode_runs(argv, video, monkeypatch, tmp_path):
    d = out(monkeypatch, ptl, tmp_path, "lode")
    res = ptl.main(SMALL + ["--latent-dim", "4"] + argv)
    finite(res.history)
    assert res.base.model_type.use_kernel_solve if "--seeds" in argv \
        else res.model.model_type.use_kernel_solve
    assert os.path.exists(os.path.join(d, "best_model.npz"))


@pytest.mark.parametrize("which", ["vdp", "kuramoto"])
def test_custom_dynamics_scripts_run(which, monkeypatch, tmp_path):
    mod = {"vdp": ptv, "kuramoto": ptk}[which]
    de = (VanDerPol(options=make_options(adaptive=False, substeps=4))
          if which == "vdp" else
          Kuramoto(n_oscillators=10,
                   options=make_options(adaptive=False, substeps=4)))
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (72, 50, 8)).astype(np.float32))
    monkeypatch.setattr(mod, "make_data",
                        lambda **kw: (x, None, None, de))
    d = out(monkeypatch, mod, tmp_path, which)
    res = mod.main(["--device", "cpu", "--epochs", "1", "--input-dim", "8"])
    finite(res.history)
    assert os.path.exists(os.path.join(d, "best_model.npz"))


def test_train_original_data_runs(monkeypatch, tmp_path):
    path = str(tmp_path / "processed_data.npz")
    np.savez(path, train_data=np.random.default_rng(2).uniform(
        0, 1, (20, 12, 28, 28)).astype(np.float32))
    d = out(monkeypatch, pto, tmp_path, "orig")
    res = pto.main(SMALL + ["--data", path])
    finite(res.history)
    assert res.opt.wd == 0.0 and res.opt.t == 4
    assert os.path.exists(os.path.join(d, "best_model.npz"))


# -- numbers against JAX ---------------------------------------------------

def test_forecast_numbers_match_jax(best, monkeypatch, capsys):  # noqa: F811
    """forecast.py restores goku_best_model.npz (the JAX Trainer's file)
    and prints the errors inside and beyond the 50-frame context; on the
    last four of 40 generated videos (its validation split) the per-frame
    errors equal JAX's model.forecast's within rtol 1e-4."""
    jm, _ = best
    lat, u0s, ps, frames = (a.numpy() for a in
                            generate_dataset(n_traj=40, device="cpu"))
    monkeypatch.setattr(pfc, "load_or_generate",
                        lambda *a, **k: (lat, u0s, ps, frames))
    res = pfc.main(["--device", "cpu", "--ckpt",
                    os.path.join(ROOT, "benchmarks", "artifacts",
                                 "goku_best_model.npz")])
    printed = capsys.readouterr().out
    assert "beyond context" in printed and "degradation factor" in printed
    xv = frames[36:].reshape(4, 100, 784)
    t = jnp.arange(100, dtype=jnp.float32) * 0.05
    xh_j, _, _ = jm.forecast(jnp.asarray(xv[:, :50]), t)
    err_j = np.asarray(jnp.mean((jnp.asarray(xv) - xh_j) ** 2, axis=(0, 2)))
    np.testing.assert_allclose(res["err"], err_j, rtol=1e-4)
    np.testing.assert_allclose(res["inside"], err_j[:50].mean(), rtol=1e-4)
    np.testing.assert_allclose(res["beyond"], err_j[50:].mean(), rtol=1e-4)


def test_visualize_numbers_match_jax(tmp_path):
    """The sample, the window and the plotted numbers of
    visualize_val_image against JAX's function on carried weights: the
    same two draws from the same numpy generator (its state after both
    calls is equal), z, x_hat and the inferred length within 1e-5; both
    write a PNG."""
    jm, tm = small_pair(seed=3, scale=0.2)
    rng = np.random.default_rng(9)
    val = rng.uniform(0, 1, (5, 30, D_IN)).astype(np.float32)
    lat = rng.normal(size=(5, 30, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (5, 1)).astype(np.float32)
    r_j, r_p = np.random.default_rng(4), np.random.default_rng(4)
    jvisualize(jm, val, lat, ps, vis_len=12, dt=0.05, h=4, w=6,
               path=str(tmp_path / "jax.png"), rng=r_j)
    d = visualize_val_image(tm, val, lat, ps, vis_len=12, dt=0.05, h=4,
                            w=6, path=str(tmp_path / "port.png"), rng=r_p)
    assert r_j.bit_generator.state == r_p.bit_generator.state
    assert (tmp_path / "jax.png").exists() and (tmp_path / "port.png").exists()
    r = np.random.default_rng(4)
    j = int(r.integers(0, 5))
    s = int(r.integers(0, 30 - 12))
    assert (d["j"], d["s"]) == (j, s)
    x = jnp.asarray(val[j:j + 1, s:s + 12])
    (xh, zh, lh), _, _, _ = jm(x, jnp.arange(12, dtype=jnp.float32) * 0.05,
                               variational=False,
                               key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(d["z"], np.asarray(zh)[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d["x_hat"], np.asarray(xh)[0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(d["theta_hat"], float(lh[1].ravel()[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(d["true_latent"], lat[j, s:s + 12])
    assert d["true_p"] == float(ps[j, 0])
    again = val_image_data(tm, val, lat, ps, vis_len=12, dt=0.05,
                           rng=np.random.default_rng(4))
    np.testing.assert_array_equal(again["z"], d["z"])


def test_vdp_data_matches_jax_make_data():
    """train_vdp.make_data(n_traj=8) against JAX's: the draws (mu, the
    lift) are identical; the trajectories come from two float32 adaptive
    solves at rtol 1e-3, atol 1e-6, whose step controllers read rounding
    and choose other steps, so they differ by the solve's own error (up to
    0.25 on a row here, in states of size ~4). Each row must be as close
    to a float64 solve at rtol 1e-10 as JAX's row is: within twice JAX's
    distance plus 0.02."""
    xj, zj, mj, vj = jtv.make_data(n_traj=8)
    x, z, m, v = ptv.make_data(n_traj=8, device="cpu")
    np.testing.assert_array_equal(m.numpy(), mj)
    assert tuple(x.shape) == xj.shape == (8, 100, 64)
    assert v.options.adaptive is False and v.options.substeps == 4
    rng = np.random.default_rng(0)
    u0s = torch.from_numpy(rng.uniform(-2.0, 2.0, (8, 2)).astype(
        np.float32)).double()
    mus = torch.from_numpy(rng.uniform(0.5, 2.0, (8, 1)).astype(
        np.float32)).double()
    t = torch.arange(100, dtype=torch.float64) * 0.1
    ref = solve_ensemble(
        ODEProblem(f=vdp_f, u0=u0s[0], tspan=(0.0, 9.9), p=mus[0]),
        u0s=u0s, ps=mus, saveat=t,
        options=make_options(rtol=1e-10, atol=1e-12,
                             max_steps=20000)).ys.numpy()
    d_port = np.abs(z.numpy() - ref).max(axis=(1, 2))
    d_jax = np.abs(zj - ref).max(axis=(1, 2))
    assert np.all(d_port <= 2 * d_jax + 0.02), (d_port, d_jax)
    assert np.abs(z.numpy() - zj).max() < 0.3
