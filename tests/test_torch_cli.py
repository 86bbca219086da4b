"""The port's training CLIs (latentdiffeq_torch/examples/) against the JAX
package's example scripts (examples/), on the CPU, without training: both
scripts run on the same argv with their data loaders, ``Trainer`` and
``MultiSeedTrainer`` replaced by stubs that record what they are given,
so nothing compiles. For every argv set the two must build the same
``TrainConfig`` (every field both have; the checkpoint folder by name, the
port's lies under its own package), the same dynamics (type, vector
field, solver, options) and the same parameter tree (paths, shapes and
dtypes), with the port's kernel switches on. Also: one ELBO with the JAX
weights carried into the port's default GOKU and LatentODE builds
(rtol 1e-5), the figure epochs against JAX's ``Trainer.fit`` (its
``run_block`` stubbed), the keyed dataset cache, the Kuramoto readout
helpers (1e-6), and each script as a file and as a module."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))
sys.path.insert(0, os.path.join(ROOT, "examples", "custom_dynamics"))

import create_data as jcreate  # noqa: E402
import train_goku as jtg  # noqa: E402
import train_kuramoto as jtk  # noqa: E402
import train_latent_ode as jtl  # noqa: E402
import train_original_data as jto  # noqa: E402
import train_vdp as jtv  # noqa: E402
import custom as jcustom  # noqa: E402

import latentdiffeq.train as jtrain  # noqa: E402
from latentdiffeq import make_options as jmake_options  # noqa: E402
from latentdiffeq.train import TrainConfig as JTrainConfig  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train import trainer as jtrainer_mod  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch.custom_dynamics import Kuramoto, VanDerPol  # noqa: E402
from latentdiffeq_torch.examples.custom_dynamics import (  # noqa: E402
    train_kuramoto as ptk, train_vdp as ptv)
from latentdiffeq_torch.examples.pendulum import (  # noqa: E402
    create_data as pcreate, train_goku as ptg, train_latent_ode as ptl,
    train_original_data as pto)
from latentdiffeq_torch.solve import make_options  # noqa: E402
from latentdiffeq_torch.train import (FluxAdam, TrainConfig,  # noqa: E402
                                      load_jax_params, losses)
from latentdiffeq_torch.train.checkpoint import jax_param_paths  # noqa: E402

N, T = 20, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_video(n=N, T_=T, seed=0):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, T_, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (n, 1)).astype(np.float32)
    frames = rng.uniform(0, 1, (n, T_, 28, 28)).astype(np.float32)
    return latent, latent[:, 0].copy(), ps, frames


class Record:
    """What a script handed to the stubs."""

    def __init__(self):
        self.model = self.cfg = self.optimizer = self.seeds = None
        self.data_calls = []


def stubs(rec, make_model):
    """Stub Trainer and MultiSeedTrainer classes writing into ``rec``;
    ``make_model(init_fn, seed)`` builds a population's first replica."""

    class Trainer:
        def __init__(self, model, cfg, optimizer=None, **kw):
            rec.model, rec.cfg, rec.optimizer = model, cfg, optimizer
            self.model, self.cfg, self.epoch = model, cfg, 0
            self.np_rng = np.random.default_rng(0)

        def restore(self, path):
            return self

        def fit(self, *a, **k):
            return []

    class MultiSeedTrainer:
        def __init__(self, init_fn, cfg, seeds, **kw):
            rec.model = make_model(init_fn, seeds[0])
            rec.cfg, rec.seeds = cfg, list(seeds)
            self.seeds = list(seeds)
            self.per_seed_best_vals = [0.0] * len(seeds)
            self.best_seed, self.best_val_loss = self.seeds[0], 0.0

        def warm_start(self, fn):
            return self

        def fit(self, *a, **k):
            return []

        def prune(self, keep):
            self.seeds = [self.seeds[i] for i in keep]

        def select(self, score_fn):
            return None, {"index": 0, "seed": self.seeds[0], "score": 0.0,
                          "from_best": True}

        def save_replica(self, *a, **k):
            pass

        def save_best(self, *a, **k):
            pass

    return Trainer, MultiSeedTrainer


def loader(rec, data):
    def load(*a, **k):
        rec.data_calls.append((a, k))
        return data
    return load


def run_jax(monkeypatch, mod, argv, data=None, extra=()):
    rec = Record()
    trainer, ms = stubs(rec, lambda f, s: f(jax.random.PRNGKey(s)))
    monkeypatch.setattr(mod, "Trainer", trainer, raising=False)
    monkeypatch.setattr(jtrain, "MultiSeedTrainer", ms)
    if data is not None:
        monkeypatch.setattr(mod, "load_or_generate", loader(rec, data))
    for name, fn in extra:
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    with monkeypatch.context() as m:    # the JAX scripts' output folders
        m.setattr(os, "makedirs", lambda *a, **k: None)
        mod.main()
    return rec


def run_port(monkeypatch, tmp_path, mod, argv, data=None, extra=()):
    rec = Record()
    trainer, ms = stubs(rec, lambda f, s: f(s))
    monkeypatch.setattr(mod, "OUTPUT_DIR",
                        str(tmp_path / os.path.basename(mod.OUTPUT_DIR)))
    monkeypatch.setattr(mod, "Trainer", trainer)
    monkeypatch.setattr(mod, "MultiSeedTrainer", ms, raising=False)
    if data is not None:
        monkeypatch.setattr(mod, "load_or_generate", loader(rec, data))
    for name, fn in extra:
        monkeypatch.setattr(mod, name, fn)
    mod.main(list(argv) + ["--device", "cpu"])
    return rec


def same_config(jcfg, pcfg):
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    pf = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)}
    shared = sorted(set(jf) & set(pf))
    assert len(shared) >= 25
    for name in shared:
        if name == "checkpoint_dir":      # the port's lies in its package
            assert os.path.basename(jf[name]) == os.path.basename(pf[name])
        else:
            assert jf[name] == pf[name], name


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _norm(name):
    return re.sub(r"[_\d]", "", name)


def same_dynamics(jde, pde):
    assert type(jde).__name__ == type(pde).__name__
    if hasattr(pde, "f"):
        assert _norm(jde.f.__name__) == _norm(pde.f.__name__)
    for name in ("z_dim", "theta_dim", "latent_dim_in", "augment_dim"):
        if hasattr(jde, name):
            assert getattr(jde, name) == getattr(pde, name), name
    assert type(jde.solver).__name__ == type(pde.solver).__name__
    for opt in ("options", "adaptive_cfg"):
        if hasattr(jde, opt):
            jo, po = _fields(getattr(jde, opt)), _fields(getattr(pde, opt))
            for k in sorted(set(jo) & set(po)):
                if dataclasses.is_dataclass(jo[k]):
                    jk, pk = _fields(jo[k]), _fields(po[k])
                    for kk in sorted(set(jk) & set(pk)):
                        assert jk[kk] == pk[kk], (opt, k, kk)
                else:
                    assert jo[k] == po[k], (opt, k)
    for name in ("adaptive", "substeps"):
        if hasattr(jde, name) and not hasattr(jde, "options"):
            assert getattr(jde, name) == getattr(pde, name), name
    assert (getattr(jde, "transform", None) is None) == (
        getattr(pde, "transform", None) is None)


def param_tree(model, jax_side):
    if jax_side:
        return [(_path_str(p), tuple(l.shape), jnp.dtype(l.dtype).name)
                for p, l in jax.tree_util.tree_flatten_with_path(model)[0]]
    return [(n, tuple(p.shape), str(p.dtype).replace("torch.", ""))
            for n, p in zip(jax_param_paths(model), model.parameters())]


def same_model(jrec, prec):
    assert param_tree(jrec.model, True) == param_tree(prec.model, False)
    same_dynamics(jrec.model.decoder.diffeq, prec.model.decoder.diffeq)


GOKU_ARGVS = {
    "default": [],
    "friction": ["--diffeq", "friction"],
    "spendulum-adaptive": ["--diffeq", "spendulum", "--adaptive"],
    "masked-seeds3-composite": ["--masked", "--seeds", "3", "--select-by",
                                "pixel-composite"],
    "bf16": ["--dtype", "bf16"],
    "free-bits-0": ["--free-bits", "0"],
}


@pytest.mark.parametrize("case", list(GOKU_ARGVS))
def test_train_goku_builds_what_jax_builds(case, monkeypatch, tmp_path):
    argv = GOKU_ARGVS[case]
    data = synthetic_video()
    jrec = run_jax(monkeypatch, jtg, argv, data)
    prec = run_port(monkeypatch, tmp_path, ptg, argv, data)
    same_config(jrec.cfg, prec.cfg)
    same_model(jrec, prec)
    mt = prec.model.model_type
    assert mt.use_kernel_encoder and mt.use_kernel_solver
    assert jrec.seeds == prec.seeds
    (ja, jk), = jrec.data_calls
    (pa, pk), = prec.data_calls
    assert [os.path.basename(a) for a in ja] == [os.path.basename(a)
                                                for a in pa]
    assert ("diffeq" in jk) == ("diffeq" in pk)
    if "diffeq" in jk:
        same_dynamics(jk["diffeq"], pk["diffeq"])
    if case == "friction":
        assert prec.cfg.free_bits == 0.1


def test_train_latent_ode_builds_what_jax_builds(monkeypatch, tmp_path):
    argv = ["--augment-dim", "2", "--pallas-solve"]
    data = synthetic_video()
    jrec = run_jax(monkeypatch, jtl, argv, data)
    prec = run_port(monkeypatch, tmp_path, ptl, argv, data)
    same_config(jrec.cfg, prec.cfg)
    same_model(jrec, prec)
    assert jrec.model.model_type.use_pallas_solve
    assert prec.model.model_type.use_kernel_solve
    assert prec.model.decoder.diffeq.augment_dim == 2


def vdp_data(jax_side):
    """What make_data returns, the dynamics built as it builds them."""
    x = np.random.default_rng(1).uniform(0, 1, (72, 50, 64)).astype(
        np.float32)
    z = np.zeros((72, 50, 2), np.float32)
    mus = np.ones((72, 1), np.float32)
    de = (jcustom.VanDerPol(options=jmake_options(adaptive=False,
                                                  substeps=4))
          if jax_side else VanDerPol(options=make_options(adaptive=False,
                                                          substeps=4)))
    return lambda **kw: (x, z, mus, de)


def kuramoto_data(jax_side):
    x = np.random.default_rng(2).uniform(0, 1, (72, 50, 64)).astype(
        np.float32)
    de = (jcustom.Kuramoto(n_oscillators=10,
                           options=jmake_options(adaptive=False,
                                                 substeps=4))
          if jax_side else Kuramoto(n_oscillators=10,
                                    options=make_options(adaptive=False,
                                                         substeps=4)))
    return lambda **kw: (x, None, None, de)


@pytest.mark.parametrize("which", ["vdp", "kuramoto"])
def test_custom_dynamics_scripts_build_what_jax_builds(which, monkeypatch,
                                                       tmp_path):
    jmod, pmod, data = {"vdp": (jtv, ptv, vdp_data),
                        "kuramoto": (jtk, ptk, kuramoto_data)}[which]
    jrec = run_jax(monkeypatch, jmod, [],
                   extra=[("make_data", data(True))])
    prec = run_port(monkeypatch, tmp_path, pmod, [],
                    extra=[("make_data", data(False))])
    same_config(jrec.cfg, prec.cfg)
    same_model(jrec, prec)
    mt = prec.model.model_type
    assert mt.use_kernel_encoder and mt.use_kernel_solver


def test_kuramoto_make_data_returns_the_jax_spec():
    """The spec of the port's make_data (2 rows, solved on the CPU) is the
    one JAX's make_data builds (train_kuramoto.py:74-77)."""
    x, z_sin, th, kur = ptk.make_data(n_traj=2, T=5, device="cpu")
    same_dynamics(jcustom.Kuramoto(n_oscillators=10, options=jmake_options(
        adaptive=False, substeps=4)), kur)
    assert tuple(x.shape) == (2, 5, 64)


def test_train_original_data_builds_what_jax_builds(monkeypatch, tmp_path):
    path = str(tmp_path / "orig.npz")
    np.savez(path, train_data=np.random.default_rng(3).uniform(
        0, 1, (10, 12, 28, 28)).astype(np.float32))
    argv = ["--data", path]
    jrec = run_jax(monkeypatch, jto, argv)
    prec = run_port(monkeypatch, tmp_path, pto, argv)
    same_config(jrec.cfg, prec.cfg)
    same_model(jrec, prec)
    assert prec.cfg.seq_len == 12 and prec.cfg.start_beta == 1e-5
    assert isinstance(prec.optimizer, FluxAdam)
    assert prec.optimizer.lr == 1e-3 and prec.optimizer.wd == 0.0


@pytest.mark.parametrize("which", ["goku", "latent_ode"])
def test_one_loss_with_carried_weights(which, monkeypatch, tmp_path):
    """The default builds of train_goku.py and train_latent_ode.py: JAX's
    weights carried into the port's model give the same deterministic ELBO
    on a batch of 2 (rtol 1e-5)."""
    data = synthetic_video()
    jmod, pmod = {"goku": (jtg, ptg), "latent_ode": (jtl, ptl)}[which]
    jm = run_jax(monkeypatch, jmod, [], data).model
    tm = run_port(monkeypatch, tmp_path, pmod, [], data).model
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    x = data[3][:2].reshape(2, T, 784)
    t = (np.arange(T) * 0.05).astype(np.float32)
    lj, _ = jlosses.loss_batch(jm, jnp.asarray(x), jnp.asarray(t), 0.5,
                               variational=False)
    with torch.no_grad():
        lt, _ = losses.loss_batch(tm, torch.from_numpy(x),
                                  torch.from_numpy(t), 0.5,
                                  variational=False)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


# -- the figure cadence --------------------------------------------------

CADENCE = {
    "plain": dict(epochs=60),
    "sliced": dict(epochs=70, progressive_training=True, start_seq_len=20,
                   seq_len=50, prog_training_duration=40,
                   prog_seq_len_step=5),
    "masked": dict(epochs=60, progressive_training=True, start_seq_len=20,
                   seq_len=50, prog_training_duration=40,
                   prog_seq_len_step=1, masked_curriculum=True),
}


def jax_callback_epochs(kw, start=0):
    """The epochs at which JAX's Trainer.fit calls its callbacks, with the
    block program stubbed (no compile)."""
    cfg = JTrainConfig(save_best=False, batch_size=1, **kw)
    tr = jtrainer_mod.Trainer({"w": jnp.zeros(1)}, cfg)
    tr.epoch = start

    def run_block(data, val, betas, seq_len, cur_lens):
        tr._best_dev = {"val": jnp.float32(1.0)}
        n = len(betas)
        return {"train_loss": np.zeros(n), "val_loss": np.zeros(n),
                "rhs_evals": np.ones(n)}

    tr.run_block = run_block
    seen = []
    x = np.zeros((4, cfg.seq_len, 1), np.float32)
    tr.fit(x, x, callbacks=[lambda t, rec: seen.append(rec["epoch"])],
           verbose=False)
    return seen


@pytest.mark.parametrize("case", list(CADENCE))
def test_figure_epochs_are_jax_callback_epochs(case):
    kw = CADENCE[case]
    cfg = TrainConfig(**kw)
    for start in (0, 7):
        assert ptg.figure_epochs(cfg, start) == jax_callback_epochs(kw,
                                                                    start)
    assert len(ptg.figure_epochs(TrainConfig(epochs=1500))) == 60


# -- the dataset cache ---------------------------------------------------

def test_cache_is_keyed_on_arguments_and_device(monkeypatch, tmp_path):
    made = []

    def gen(**kw):
        made.append(kw)
        n = kw.get("n_traj")
        d = synthetic_video(n=n, T_=3, seed=kw.get("seed", 1))
        return tuple(torch.from_numpy(a) for a in d)

    monkeypatch.setattr(pcreate, "generate_dataset", gen)
    monkeypatch.setattr(pcreate, "DATA_DIR", str(tmp_path))
    a = pcreate.load_or_generate(n_traj=3, device="cpu")
    b = pcreate.load_or_generate(n_traj=3, device="cpu")
    assert len(made) == 1 and (tmp_path / "pendulum_data.npz").exists()
    for u, v in zip(a, b):
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(u, v)
    c = pcreate.load_or_generate(n_traj=3, seed=2, device="cpu")
    assert len(made) == 2 and not np.array_equal(a[3], c[3])
    # a file made on the card is not returned to a CPU caller
    key = pcreate.cache_key(n_traj=3, device="cpu")
    key["device"] = "cuda"
    path = str(tmp_path / "card.npz")
    pcreate.write_cache(path, c, key)
    d = pcreate.load_or_generate(path, n_traj=3, device="cpu")
    assert len(made) == 3
    np.testing.assert_array_equal(d[3], a[3])
    assert pcreate._stored_key(path)["device"] == "cpu"
    # another dynamics is another key
    from latentdiffeq_torch.pendulum import PendulumFriction
    assert (pcreate.cache_key(diffeq=PendulumFriction(),
                              device="cpu")["diffeq"]
            != pcreate.cache_key(device="cpu")["diffeq"])


def test_train_goku_caches_follow_a_redirected_data_dir(monkeypatch,
                                                        tmp_path):
    """Both of train_goku's caches (the default and ``--diffeq friction``'s
    own file) are written into ``create_data.DATA_DIR`` as it is at call
    time, so a redirect keeps them out of the package folder."""
    made = []

    def gen(**kw):
        made.append(kw)
        return tuple(torch.from_numpy(a)
                     for a in synthetic_video(n=2, T_=3, seed=1))

    monkeypatch.setattr(pcreate, "generate_dataset", gen)
    monkeypatch.setattr(pcreate, "DATA_DIR", str(tmp_path))
    ptg.load_data("friction", "cpu")
    ptg.load_data("pendulum", "cpu")
    assert len(made) == 2
    assert sorted(os.listdir(tmp_path)) == ["pendulum_data.npz",
                                            "pendulum_friction_data.npz"]


def test_cache_and_outputs_lie_under_the_port_package():
    """The data cache and every script's output folder lie beside the
    port's scripts, never in the JAX examples' folders."""
    assert os.path.abspath(pcreate.DATA_DIR) != os.path.abspath(
        os.path.join(os.path.dirname(jcreate.__file__), "data"))
    here = os.path.join(os.path.abspath(ROOT), "latentdiffeq_torch",
                        "examples")
    for d in [pcreate.DATA_DIR] + [m.OUTPUT_DIR for m in (ptg, ptl, pto,
                                                          ptv, ptk)]:
        assert os.path.abspath(d).startswith(here), d


# -- the Kuramoto readout helpers ----------------------------------------

def test_kuramoto_readout_helpers_match_jax():
    rng = np.random.default_rng(5)
    n_osc, d_in = 10, 16
    lift = {"W": rng.normal(0, 1, (n_osc, d_in)).astype(np.float32),
            "b": rng.normal(0, 0.3, (d_in,)).astype(np.float32)}
    phi = np.cumsum(rng.uniform(0.1, 0.3, (2, 20, n_osc)), axis=1)
    y = np.maximum(np.sin(phi) @ lift["W"] + lift["b"], 0.0)
    lift["mn"], lift["mx"] = float(y.min()), float(y.max())
    x = ((y - lift["mn"]) / (lift["mx"] - lift["mn"])).astype(np.float32)
    for a, b in zip(ptk.invert_lift_phases(x, lift),
                    jtk.invert_lift_phases(x, lift)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for a, b in zip(ptk.fit_lift_readout(lift, n_samples=512),
                    jtk.fit_lift_readout(lift, n_samples=512)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    deltas = np.linspace(-0.5, 0.5, n_osc)
    for a, b in zip(ptk.estimate_omega_k(phi, deltas),
                    jtk.estimate_omega_k(phi, deltas)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# -- as a module and as a file --------------------------------------------

def test_scripts_run_as_module_and_as_file():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    mod = subprocess.run(
        [sys.executable, "-m",
         "latentdiffeq_torch.examples.pendulum.train_goku", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert mod.returncode == 0 and "--select-by" in mod.stdout
    path = os.path.join(ROOT, "latentdiffeq_torch", "examples",
                        "custom_dynamics", "train_vdp.py")
    f = subprocess.run([sys.executable, path, "--help"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert f.returncode == 0 and "--input-dim" in f.stdout
