"""Block mode (``TrainConfig.jit_epoch``, ``epochs_per_dispatch``): the
port's fused epoch block (``make_block_fn``, ``Trainer.run_block``), eager
on the CPU, against its per-step loop and against JAX's ``make_block_fn``.

- The block path equals the per-step loop (``jit_epoch=False``) bit for
  bit at ``epochs_per_dispatch`` 1, 2 and 3, with a progressive curriculum
  that breaks the blocks, for a small GOKU and a small LatentODE: each
  epoch's summaries, the weights, the optimizer's state, the best (weights,
  validation loss, epoch) and the three random streams; callbacks fire at
  JAX's block ends (the CLI's ``figure_epochs``).
- The port's ``make_block_fn`` against JAX's on the same bridged weights,
  the same ``idx_blocks`` and the windows and noise JAX draws from its
  keys (trainer.py:331-335): losses rtol 1e-5, weights atol 1e-5, the same
  best epoch.
- A NaN validation loss inside a block never becomes the best, and later
  epochs still do.
- A run saved at a block boundary and resumed equals the uninterrupted
  run bit for bit; the best checkpoint of block mode holds JAX's fields
  (the best weights and optimizer state, epoch + 1, its validation loss)
  and equals the per-step loop's checkpoint of that epoch.
- SDE dynamics, adaptive solves, MultiSeedTrainer and a one-rank gloo
  mesh on the CPU run blocks with no warning, bit for bit with their
  per-step loops; a gloo mesh over CUDA tensors (ranks sharing a card)
  warns and runs the per-step loop; the masked curriculum without block
  mode raises JAX's ValueError.
The CUDA graphs themselves run only on the card (tests/test_torch_cuda.py,
``test_block_graphs_*``)."""
import dataclasses
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

from pendulum import Pendulum as JPendulum  # noqa: E402

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentODE as JLatentODE  # noqa: E402
from latentdiffeq.models import NODE as JNODE  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train import trainer as jtrainer  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.examples.pendulum import (  # noqa: E402
    train_goku as ptg)
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       LatentODE, NODE, default_layers,
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.solve import make_options as tmake_options  # noqa: E402
from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig,  # noqa: E402
                                      Trainer, load_checkpoint,
                                      load_jax_params, loss_batch,
                                      make_block_fn, optim, splitobs)
from latentdiffeq_torch.train.checkpoint import load_arrays  # noqa: E402
from latentdiffeq_torch.train.trainer import block_best  # noqa: E402

D_IN = 24
SMALL = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
LODE = dict(hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8)
# lengths 4, 6, 8, 8, ...: the curriculum breaks the blocks at epochs 1 and 2
CURRICULUM = dict(progressive_training=True, start_seq_len=4, seq_len=8,
                  prog_training_duration=4, prog_seq_len_step=2)
EPOCHS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def goku(seed, diffeq=None):
    diffeq = diffeq or Pendulum(options=SolveOptions(adaptive=False,
                                                     substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(D_IN, diffeq, **SMALL,
                             generator=torch.Generator().manual_seed(seed),
                             device="cpu"))


def latent_ode(seed):
    g = torch.Generator().manual_seed(seed)
    de = NODE(6, hidden_dim=16, generator=g, device="cpu",
              options=SolveOptions(adaptive=False, substeps=1))
    mt = LatentODE(use_kernel_solve=True)
    return LatentDiffEqModel.build(
        mt, *default_layers(mt, D_IN, de, generator=g, device="cpu", **LODE))


BUILD = {"goku": goku, "latent_ode": latent_ode}


@pytest.fixture(scope="module")
def sets():
    x = np.random.default_rng(0).uniform(0, 1, (20, 12, D_IN)).astype(
        np.float32)
    return splitobs(x, 0.8)           # 16 training videos: 2 steps of 8


def cfg_of(tmp=None, **kw):
    base = dict(batch_size=8, seq_len=8, epochs=EPOCHS, seed=0, decay=1e-3,
                save_best=tmp is not None,
                checkpoint_dir=str(tmp) if tmp is not None else "output")
    base.update(kw)
    return TrainConfig(**base)


def assert_same_run(a, b, best=True):
    """Two Trainers bit for bit: summaries, weights, optimizer, best (with
    ``best``) and the three random streams."""
    keys = ("epoch", "train_loss", "val_loss", "kl", "n_failed", "beta",
            "seq_len")
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        for k in keys:
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.opt.t == b.opt.t
    for p, q in zip(a.opt.state_tensors(), b.opt.state_tensors()):
        assert torch.equal(p, q)
    assert a.best_val_loss == b.best_val_loss
    if best:
        assert_same_best(a.best, b.best)
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state
    assert torch.equal(a.window_gen.get_state(), b.window_gen.get_state())
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())


def assert_same_best(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a["epoch"] == b["epoch"]
        assert a["val"] == b["val"]
        assert set(a["model"]) == set(b["model"])
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), k


@pytest.fixture(scope="module")
def per_step(sets):
    """The per-step loop's run of each model, with the curriculum."""
    out = {}
    for name, build in BUILD.items():
        tr = Trainer(build(1), cfg_of(jit_epoch=False, **CURRICULUM),
                     device="cpu")
        tr.fit(*sets, verbose=False)
        out[name] = tr
    return out


@pytest.mark.parametrize("per_dispatch", [1, 2, 3])
@pytest.mark.parametrize("which", list(BUILD))
def test_block_path_equals_per_step_loop_bit_for_bit(which, per_dispatch,
                                                     sets, per_step):
    cfg = cfg_of(epochs_per_dispatch=per_dispatch, **CURRICULUM)
    tr = Trainer(BUILD[which](1), cfg, device="cpu")
    seen = []
    tr.fit(*sets, verbose=False,
           callbacks=[lambda t, rec: seen.append(rec["epoch"])])
    assert_same_run(per_step[which], tr)
    assert [h["seq_len"] for h in tr.history] == [4, 6, 8, 8, 8, 8]
    # once a block, on its last record: JAX's block ends
    assert seen == ptg.figure_epochs(cfg)
    if per_dispatch == 3:
        assert seen == [0, 1, 4, 5]


def test_masked_curriculum_blocks_equal_the_sliced_run(sets, per_step):
    """The masked curriculum keeps JAX's cadence (its blocks span the
    lengths) and trains the sliced windows: the same run."""
    cfg = cfg_of(epochs_per_dispatch=4, masked_curriculum=True,
                 **CURRICULUM)
    tr = Trainer(goku(1), cfg, device="cpu")
    seen = []
    tr.fit(*sets, verbose=False,
           callbacks=[lambda t, rec: seen.append(rec["epoch"])])
    assert_same_run(per_step["goku"], tr)
    assert seen == [3, 5] == ptg.figure_epochs(cfg)


# -- against JAX's make_block_fn ---------------------------------------------

def bridged(which, seed=3, scale=0.2):
    """(JAX model, port model) with the same random weights."""
    if which == "goku":
        diffeq = JPendulum(options=make_options(adaptive=False, substeps=1))
        enc, dec = jdefault_layers(jax.random.PRNGKey(seed), JGOKUBasic(),
                                   D_IN, diffeq, **SMALL)
        jm = JModel.build(JGOKUBasic(), enc, dec)
        tm = goku(0)
    else:
        kn, kl = jax.random.split(jax.random.PRNGKey(seed))
        jnode = JNODE(kn, 6, hidden_dim=16,
                      options=make_options(adaptive=False, substeps=1))
        enc, dec = jdefault_layers(kl, JLatentODE(), D_IN, jnode, **LODE)
        jm = JModel.build(JLatentODE(), enc, dec)
        tm = latent_ode(0)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


def jax_draws(which, keys, steps, B, full, seq_len):
    """The window starts and the reparameterisation noise JAX's block
    draws from its epoch keys (trainer.py:331-335; the model's sample from
    split(kvar)[0])."""
    starts, eps = [], []
    for key in keys:
        s_row, e_row = [], []
        for k in jax.random.split(key, steps):
            kwin, kvar = jax.random.split(k)
            s_row.append(int(jax.random.randint(
                kwin, (), 0, max(full - seq_len, 1))))
            skey = jax.random.split(kvar)[0]
            if which == "goku":
                k1, k2 = jax.random.split(skey)
                e_row.append([np.asarray(jax.random.normal(k, (B, 16)))
                              for k in (k1, k2)])
            else:
                e_row.append([np.asarray(jax.random.normal(skey, (B, 6)))])
        starts.append(s_row)
        eps.append(e_row)
    groups = len(eps[0][0])
    return np.array(starts), tuple(
        torch.from_numpy(np.array([[e[g] for e in row] for row in eps]))
        for g in range(groups))


@pytest.mark.parametrize("which", list(BUILD))
def test_make_block_fn_matches_jax(which, sets):
    """Three epochs of two steps through both programs: each epoch's
    train and validation loss and KL (rtol 1e-5), the weights after every
    epoch's updates and the best weights (atol 1e-5: 1 % of an Adam step),
    the best epoch and validation loss."""
    jm, tm = bridged(which)
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
    starts, eps = jax_draws(which, keys, steps, B, tr_set.shape[1], seq_len)
    summ = fn(tm, best, torch.from_numpy(tr_set), torch.from_numpy(va_set),
              idx, starts, betas, ids, eps=eps)
    for k in ("train_loss", "val_loss", "kl"):
        np.testing.assert_allclose(summ[k].numpy(), np.asarray(jsumm[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(summ["beta"].numpy(),
                                  np.asarray(jsumm["beta"]))
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
    assert opt.t == E * steps


# -- the best, the checkpoints and resume ------------------------------------

def with_nan_at(tr, epoch, steps):
    """Make the validation loss of ``epoch`` NaN (the last of its
    ``steps`` passes, which the epoch reports)."""
    calls = {"n": 0}
    plain = tr.val_step

    def val_step(val, beta):
        calls["n"] += 1
        m = plain(val, beta)
        if calls["n"] == (epoch + 1) * steps:
            m = dict(m, loss=m["loss"] * float("nan"))
        return m

    tr.val_step = val_step
    return tr


@pytest.mark.parametrize("nan_epoch", [0, 2])
def test_nan_epoch_inside_a_block_never_becomes_the_best(nan_epoch, sets):
    runs = []
    for kw in (dict(jit_epoch=False), dict(epochs_per_dispatch=5)):
        tr = with_nan_at(Trainer(goku(2), cfg_of(epochs=5, **kw),
                                 device="cpu"), nan_epoch, 2)
        tr.fit(*sets, verbose=False)
        runs.append(tr)
    ref, blk = runs
    assert_same_run(ref, blk)
    vals = [h["val_loss"] for h in blk.history]
    assert np.isnan(vals[nan_epoch]) and np.isfinite(blk.best_val_loss)
    assert blk.best["epoch"] != nan_epoch
    assert blk.best_val_loss == np.nanmin(vals)
    assert blk.best["epoch"] == int(np.nanargmin(vals))


@pytest.mark.parametrize("which", list(BUILD))
def test_resume_across_a_block_boundary_bit_for_bit(which, sets, tmp_path):
    """Blocks of 2: 6 epochs straight against 3 epochs (a block and a
    block of 1), saved, restored into a fresh Trainer of other weights and
    fitted on to 6."""
    cfg = cfg_of(epochs_per_dispatch=2)
    ref = Trainer(BUILD[which](1), cfg, device="cpu")
    ref.fit(*sets, verbose=False)
    first = Trainer(BUILD[which](1), cfg, device="cpu")
    first.fit(*sets, epochs=3, verbose=False)
    path = str(tmp_path / "mid.npz")
    first.save(path)
    second = Trainer(BUILD[which](2), cfg, device="cpu").restore(path)
    assert second.epoch == 3
    second.fit(*sets, verbose=False)
    second.history = first.history + second.history
    assert_same_run(ref, second, best=False)
    # the resumed run tracks the best from the restored best loss: it holds
    # the uninterrupted run's best where that came after the boundary
    assert_same_best(ref.best if ref.best["epoch"] >= 3 else None,
                     second.best)


def test_best_checkpoint_holds_jax_fields(sets, tmp_path):
    """Block mode's best_model.npz (JAX's _save_best): the best epoch's
    weights and optimizer state (ADAMW moments and step count), epoch + 1
    and the best validation loss, with the streams of the block's end; the
    weights and optimizer state equal the per-step loop's checkpoint of
    that epoch bit for bit."""
    d_blk, d_ref = tmp_path / "block", tmp_path / "per_step"
    blk = Trainer(goku(3), cfg_of(d_blk, epochs=5, epochs_per_dispatch=5),
                  device="cpu")
    blk.fit(*sets, verbose=False)
    vals = [h["val_loss"] for h in blk.history]
    best_ep = int(np.argmin(vals))
    assert blk.best["epoch"] == best_ep
    # the per-step loop writes at its best epoch; stop it there
    ref = Trainer(goku(3), cfg_of(d_ref, epochs=5, jit_epoch=False),
                  device="cpu")
    ref.fit(*sets, verbose=False)
    a, ma = load_arrays(str(d_blk / "best_model.npz"))
    b, mb = load_arrays(str(d_ref / "best_model.npz"))
    assert ma["epoch"] == mb["epoch"] == best_ep + 1
    assert ma["best_val_loss"] == mb["best_val_loss"] == min(vals)
    assert ma["np_rng"] == blk.np_rng.bit_generator.state
    model_keys = [k for k in a if k.startswith("model/")]
    opt_keys = [k for k in a if k.startswith("opt_state/")]
    assert set(a) == set(b) and model_keys and "opt_state/t" in opt_keys
    assert int(a["opt_state/t"]) == 2 * (best_ep + 1)
    for k in model_keys + opt_keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the live state is back after the write
    assert blk.opt.t == 2 * 5
    back = Trainer(goku(4), cfg_of(epochs=5), device="cpu").restore(
        str(d_blk / "best_model.npz"))
    assert back.epoch == best_ep + 1
    for k, v in blk.best["model"].items():
        assert torch.equal(back.model.state_dict()[k], v)
    assert load_checkpoint(str(d_blk / "best_model.npz"),
                           goku(5))["epoch"] == best_ep + 1


# -- what runs per step ------------------------------------------------------

def per_step_cases():
    return {
        "sde": lambda: goku(6, SPendulum()),
        "adaptive": lambda: goku(6, Pendulum(options=tmake_options(
            adaptive=True, max_steps=64))),
    }


@pytest.mark.parametrize("case", ["sde", "adaptive", "mesh"])
def test_out_of_scope_configurations_warn_and_run_per_step(case, sets):
    """SDE dynamics, an adaptive solve and a one-rank gloo mesh on the CPU:
    fit runs blocks with no warning (the mesh's eagerly), each bit for bit
    with jit_epoch=False."""
    import torch.distributed as dist

    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    build = per_step_cases().get(case, lambda: goku(6))
    started = False
    mesh = None
    if case == "mesh":
        started = not dist.is_initialized()
        initialize_distributed(device="cpu")
        mesh = make_mesh(1)
    try:
        runs = []
        for kw in (dict(jit_epoch=False), {}):
            tr = Trainer(build(), cfg_of(epochs=2, **kw), device="cpu",
                         mesh=mesh)
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                tr.fit(*sets, verbose=False)
            said = [str(w.message) for w in got
                    if "per-step loop" in str(w.message)]
            runs.append((tr, said))
    finally:
        if started:
            dist.destroy_process_group()
    (ref, none), (tr, said) = runs
    assert none == [] and said == []
    assert tr._block_fns and not ref._block_fns
    assert_same_run(ref, tr)


def test_gloo_mesh_over_cuda_tensors_warns_and_runs_per_step(monkeypatch):
    """The one mesh left on the per-step loop: a gloo group over CUDA
    tensors (ranks that share a card), whose collectives a CUDA graph
    cannot capture; fit warns. A gloo mesh on the CPU and an NCCL mesh on
    the card run blocks (the backend and device monkeypatched: no card
    here)."""
    import torch.distributed as dist

    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    started = not dist.is_initialized()
    initialize_distributed(device="cpu")
    try:
        tr = Trainer(goku(6), cfg_of(epochs=2), device="cpu",
                     mesh=make_mesh(1))
        cases = (("cpu", "gloo", False), ("cuda", "gloo", True),
                 ("cuda", "nccl", False))
        for device, backend, per_step in cases:
            monkeypatch.setattr(tr, "device", torch.device(device))
            monkeypatch.setattr(dist, "get_backend",
                                lambda group=None, b=backend: b)
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                blocks = tr._use_blocks()
            said = [str(w.message) for w in got
                    if "per-step loop" in str(w.message)]
            why = tr._per_step_only()
            assert (why is not None) == per_step, (device, backend)
            assert blocks != per_step and len(said) == per_step
            if per_step:
                assert "gloo group over CUDA tensors" in why
                assert why in said[0]
    finally:
        monkeypatch.undo()
        if started:
            dist.destroy_process_group()


def test_population_warns_and_runs_per_step(sets):
    """A population fits in blocks with no warning, bit for bit with its
    per-step loop (jit_epoch=False), which warns neither."""
    runs = []
    for kw in ({}, dict(jit_epoch=False)):
        ms = MultiSeedTrainer(goku, cfg_of(epochs=2, **kw), [1, 2],
                              device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            ms.fit(*sets, verbose=False)
        runs.append(ms)
    blk, ref = runs
    assert blk._block_fns and not ref._block_fns
    for a, b in zip(blk.history, ref.history):
        for k in ("train_loss", "val_loss", "n_failed"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in blk.params:
        assert torch.equal(blk.params[k], ref.params[k]), k
        assert torch.equal(blk._best["params"][k], ref._best["params"][k])
    np.testing.assert_array_equal(blk._best["val"], ref._best["val"])


@pytest.mark.parametrize("kw", [dict(jit_epoch=False),
                                dict(epochs_per_dispatch=1)])
def test_masked_curriculum_without_blocks_raises_jax_error(kw, sets):
    cfg = dict(masked_curriculum=True, epochs=2, **CURRICULUM, **kw)
    with pytest.raises(ValueError) as port:
        Trainer(goku(1), cfg_of(**cfg), device="cpu").fit(*sets,
                                                          verbose=False)
    jtr = jtrainer.Trainer({"w": jnp.zeros(1)},
                           JTrainConfig(batch_size=8, save_best=False,
                                        **cfg))
    with pytest.raises(ValueError) as jax_err:
        jtr.fit(*sets, verbose=False)
    assert str(port.value) == str(jax_err.value)


def test_train_config_block_fields_are_jax_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    for k in ("jit_epoch", "epochs_per_dispatch"):
        assert ours[k] == theirs[k]
    assert ours["jit_epoch"] is True and ours["epochs_per_dispatch"] == 25


def test_step_scalars_are_the_per_step_corrections():
    """ADAMW's table of bias corrections equals what its steps compute on
    the host, and advance / use_step_scalars leave its count where a
    per-step run would."""
    p = [torch.zeros(3)]
    a, b = optim.adamw(p, 1e-3, 0.9, 0.999, 1e-3), optim.chain(
        optim.clip_by_global_norm(1.0), optim.adamw(None, 1e-3))
    b.bind(p)
    a.t = 7
    tab = a.step_scalars(4)
    for i in range(4):
        c1, c2 = a._corrections(8 + i)
        assert tab["c1"][i] == c1 and tab["c2"][i] == c2
    assert set(b.step_scalars(2)) == {"1/c1", "1/c2"}
    a.advance(5)
    assert a.t == 12
    a.use_step_scalars({"c1": torch.tensor(1.0), "c2": torch.tensor(1.0)})
    p[0].grad = torch.ones(3)
    a.step()
    assert a.t == 13 and len(a.state_tensors()) == 2
    a.use_step_scalars(None)
    assert len(b.state_tensors()) == 2
