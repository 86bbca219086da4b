"""An exact resume for the port's solo Trainer, on the CPU.

``Trainer.save`` writes the three random streams (the permutation
generator's state in the meta under JAX's name ``np_rng``, the window and
noise generators' states as arrays) and ``restore`` reads them back, so a
run fitted to 2 epochs, saved, restored into a fresh Trainer (other
initial weights) and fitted on to 4 equals the uninterrupted 4-epoch run
bit for bit (without the streams the resumed run replays epoch 0's
draws). Checkpoints without the streams (the earlier format, and JAX's
files) still restore, with the streams seeded from ``cfg.seed``.
``Trainer.best_model`` is the best snapshot's weights as a model."""
import os

import numpy as np
import pytest
import torch

from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       LatentODE, NODE, goku_default_layers,
                                       latent_ode_default_layers)
from latentdiffeq_torch.pendulum import Pendulum
from latentdiffeq_torch.train import (TrainConfig, Trainer,
                                      jax_param_paths, save_checkpoint,
                                      splitobs)

ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "benchmarks", "artifacts")
D_IN = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def goku(seed):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(D_IN, diffeq, hidden_dim_resnet=16,
                             latent_to_diffeq_dim=16,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu"))


def latent_ode(seed):
    g = torch.Generator().manual_seed(seed)
    de = NODE(6, hidden_dim=16, generator=g, device="cpu",
              options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        LatentODE(use_kernel_solve=True),
        *latent_ode_default_layers(D_IN, de, hidden_dim_resnet=16,
                                   rnn_input_dim=8, rnn_output_dim=8,
                                   generator=g, device="cpu"))


BUILD = {"goku": goku, "latent_ode": latent_ode}


@pytest.fixture(scope="module")
def sets():
    x = np.random.default_rng(0).uniform(0, 1, (20, 12, D_IN)).astype(
        np.float32)
    return splitobs(x, 0.8)


def cfg_for(tmp_path, **kw):
    base = dict(batch_size=8, seq_len=8, epochs=4, seed=0, decay=1e-3,
                checkpoint_dir=str(tmp_path))
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("which", list(BUILD))
def test_resumed_fit_equals_uninterrupted_fit_bit_for_bit(which, sets,
                                                          tmp_path):
    tr_set, va_set = sets
    build = BUILD[which]
    cfg = cfg_for(tmp_path, save_best=False)
    ref = Trainer(build(1), cfg, device="cpu")
    ref.fit(tr_set, va_set, verbose=False)

    first = Trainer(build(1), cfg, device="cpu")
    first.fit(tr_set, va_set, epochs=2, verbose=False)
    path = str(tmp_path / "mid.npz")
    first.save(path)
    second = Trainer(build(2), cfg, device="cpu").restore(path)
    assert second.epoch == 2
    second.fit(tr_set, va_set, verbose=False)
    for a, b in zip(ref.history[2:], second.history):
        assert a["epoch"] == b["epoch"]
        assert a["train_loss"] == b["train_loss"]
        assert a["val_loss"] == b["val_loss"]
    for a, b in zip(ref.model.parameters(), second.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ref.opt.m + ref.opt.v, second.opt.m + second.opt.v):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ref.opt.t == second.opt.t


def test_best_checkpoint_written_by_fit_resumes_exactly(sets, tmp_path):
    """The best checkpoint that ``fit`` writes holds the streams of its
    epoch: resuming from it and fitting to the end gives the weights of
    the run that wrote it (epochs_per_dispatch=1: written after each
    epoch, JAX's per-epoch cadence)."""
    tr_set, va_set = sets
    cfg = cfg_for(tmp_path, epochs=3, epochs_per_dispatch=1)
    ref = Trainer(goku(3), cfg, device="cpu")
    ref.fit(tr_set, va_set, verbose=False)
    best_epoch = int(np.argmin([h["val_loss"] for h in ref.history]))
    back = Trainer(goku(4), cfg, device="cpu").restore(
        str(tmp_path / "best_model.npz"))
    assert back.epoch == best_epoch + 1
    for a, b in zip(ref.best_model.parameters(), back.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    back.fit(tr_set, va_set, verbose=False)
    for a, b in zip(ref.model.parameters(), back.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoints_without_streams_restore_with_seeded_streams(sets,
                                                                 tmp_path):
    """A checkpoint in the earlier format (weights, ADAMW state, epoch, no
    streams) restores, and the streams are the fresh seeded ones."""
    cfg = cfg_for(tmp_path)
    src = Trainer(goku(5), cfg, device="cpu")
    src.fit(*sets, epochs=1, verbose=False)
    old = str(tmp_path / "old_format.npz")
    save_checkpoint(old, src.model, src.opt,
                    meta={"epoch": src.epoch,
                          "best_val_loss": src.best_val_loss})
    back = Trainer(goku(6), cfg, device="cpu").restore(old)
    fresh = Trainer(goku(6), cfg, device="cpu")
    assert back.epoch == 1 and back.opt.t == src.opt.t
    for a, b in zip(src.model.parameters(), back.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (back.np_rng.bit_generator.state
            == fresh.np_rng.bit_generator.state)
    assert torch.equal(back.window_gen.get_state(),
                       fresh.window_gen.get_state())
    assert torch.equal(back.noise_gen.get_state(),
                       fresh.noise_gen.get_state())


def test_jax_trainer_file_restores_with_seeded_streams():
    """benchmarks/artifacts/goku_best_model.npz (JAX's Trainer, format v1:
    key, model, ADAMW state, ``np_rng`` in the meta) restores into a
    full-width GOKU; the port's streams stay seeded (the file holds none
    of theirs)."""
    path = os.path.join(ARTIFACTS, "goku_best_model.npz")
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    model = LatentDiffEqModel.build(
        GOKUBasic(), *goku_default_layers(784, diffeq, device="cpu"))
    cfg = TrainConfig(save_best=False)
    tr = Trainer(model, cfg, device="cpu").restore(path)
    fresh = Trainer(model, cfg, device="cpu")
    assert tr.epoch > 0 and tr.opt.t > 0
    with np.load(path) as d:         # format v1: key, model, opt_state
        n = len(jax_param_paths(model))
        for i, p in enumerate(model.parameters()):
            np.testing.assert_array_equal(p.detach().numpy(),
                                          d[f"leaf_{1 + i}"])
        assert tr.opt.t == int(d[f"leaf_{1 + 2 * n}"])
    assert (tr.np_rng.bit_generator.state
            == fresh.np_rng.bit_generator.state)
    assert torch.equal(tr.window_gen.get_state(),
                       fresh.window_gen.get_state())


def test_best_model_is_the_snapshot_or_the_live_model(sets, tmp_path):
    tr = Trainer(goku(7), cfg_for(tmp_path, save_best=False), device="cpu")
    assert tr.best_model is tr.model
    tr.fit(*sets, epochs=2, verbose=False)
    best = tr.best_model
    assert best is not tr.model
    for k, v in tr.best["model"].items():
        torch.testing.assert_close(best.state_dict()[k], v, rtol=0, atol=0)


def test_noise_stream_from_another_device_type_is_reseeded(sets, tmp_path):
    """A checkpoint whose noise stream was saved on the card (a 16-byte
    Philox state) restores on the CPU: the permutation and window streams
    are set from the file, the noise stream is reseeded from ``cfg.seed``
    with a warning (the CPU generator cannot take a card's state)."""
    cfg = cfg_for(tmp_path, save_best=False)
    src = Trainer(goku(8), cfg, device="cpu")
    src.fit(*sets, epochs=1, verbose=False)
    path = str(tmp_path / "card.npz")
    save_checkpoint(
        path, src.model, src.opt,
        meta={"epoch": src.epoch, "best_val_loss": src.best_val_loss,
              "np_rng": src.np_rng.bit_generator.state,
              "noise_gen_device": "cuda"},
        arrays={"window_gen": src.window_gen.get_state().numpy(),
                "noise_gen": np.arange(16, dtype=np.uint8)})
    with pytest.warns(UserWarning, match="reseeded"):
        back = Trainer(goku(9), cfg, device="cpu").restore(path)
    fresh = Trainer(goku(9), cfg, device="cpu")
    assert back.epoch == 1
    assert (back.np_rng.bit_generator.state
            == src.np_rng.bit_generator.state)
    assert torch.equal(back.window_gen.get_state(),
                       src.window_gen.get_state())
    assert torch.equal(back.noise_gen.get_state(),
                       fresh.noise_gen.get_state())
    back.fit(*sets, epochs=2, verbose=False)
    assert np.isfinite(back.history[-1]["train_loss"])


def test_checkpoint_names_its_noise_stream_s_device_type(sets, tmp_path):
    """``save`` writes the noise generator's device type beside its state,
    and a CPU checkpoint restores its noise stream on the CPU without a
    warning."""
    import json
    import warnings
    cfg = cfg_for(tmp_path, save_best=False)
    src = Trainer(goku(10), cfg, device="cpu")
    src.fit(*sets, epochs=1, verbose=False)
    path = str(tmp_path / "cpu.npz")
    src.save(path)
    with np.load(path) as d:
        meta = json.loads(bytes(d["__meta__"]).decode())["meta"]
    assert meta["noise_gen_device"] == "cpu"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = Trainer(goku(11), cfg, device="cpu").restore(path)
    assert torch.equal(back.noise_gen.get_state(), src.noise_gen.get_state())


def test_population_noise_streams_from_another_device_type(sets, tmp_path):
    """``MultiSeedTrainer.restore`` treats a card's noise streams as
    ``Trainer.restore`` does: it reseeds them from the seeds, with a
    warning, and restores the weights and the other streams."""
    from latentdiffeq_torch.train import MultiSeedTrainer
    from latentdiffeq_torch.train.checkpoint import load_arrays, save_arrays
    cfg = cfg_for(tmp_path, save_best=False)
    src = MultiSeedTrainer(goku, cfg, [3, 5], device="cpu")
    src.fit(*sets, epochs=1, verbose=False)
    path = str(tmp_path / "population.npz")
    src.save_population(path)
    arrays, meta = load_arrays(path)
    assert meta["noise_gen_device"] == "cpu"
    arrays["noise_gens"] = np.zeros((2, 16), np.uint8)
    save_arrays(path, arrays, dict(meta, noise_gen_device="cuda"))
    with pytest.warns(UserWarning, match="reseeded"):
        back = MultiSeedTrainer(goku, cfg, [3, 5], device="cpu").restore(
            path)
    fresh = MultiSeedTrainer(goku, cfg, [3, 5], device="cpu")
    assert back.epoch == 1
    for p, q in zip(src.params.values(), back.params.values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    for a, b in zip(src.window_gens, back.window_gens):
        assert torch.equal(a.get_state(), b.get_state())
    for f, b in zip(fresh.noise_gens, back.noise_gens):
        assert torch.equal(f.get_state(), b.get_state())
    assert ([r.bit_generator.state for r in back.np_rngs]
            == [r.bit_generator.state for r in src.np_rngs])
