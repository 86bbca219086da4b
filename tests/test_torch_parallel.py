"""Data parallelism of the port (``latentdiffeq_torch.parallel``,
``Trainer(mesh=)``, ``MultiSeedTrainer(mesh=)``, ``train_goku.py
--data-parallel``) on the CPU, two gloo ranks, against the JAX package and
against the port's one-process runs.

Every two-rank case runs in ONE launch, from a module fixture: ``python -m
torch.distributed.run --standalone --nproc-per-node 2 tests/
test_torch_parallel.py DIR`` starts this file's worker (``__main__``) on
two ranks, each on one torch thread, their group on a ``file://`` store in
DIR; each rank writes what it computed into DIR, and the tests read it.
The launch has a timeout: on expiry the ranks are killed and the tests
fail. The cases, on a small GOKU (D 32, hidden_dim_resnet 16,
latent_to_diffeq_dim 16, weights from JAX through the weight bridge where
JAX is the reference):

- ``replicate`` of each rank's own weights: rank 0's on both;
- one step of ``make_dp_train_step`` and of ``make_shardmap_train_step``
  against JAX's two steps on ``make_mesh(2)`` (same key, same x): weights
  rtol 1e-5 / atol 1e-6 as JAX's own test holds its steps, the loss rtol
  1e-5, the ``n_*`` metrics equal; the GSPMD step plain and with
  ``mask_failures``, the shard_map step with it, failing rows on rank 1
  only (a row fails when its first pixel exceeds ``FAIL_AT``: JAX's GSPMD
  step divides by the global count of good rows, its shard_map step by
  each rank's);
- ``Trainer(mesh)`` in block mode, 2 blocks of 2 epochs, against the
  same mesh's per-step loop (``jit_epoch=False``) bit for bit (weights,
  optimizer state, every history record, the best epoch and weights) and
  against the solo block Trainer (rtol 2e-4), plain and with
  ``mask_failures`` on rows that fall unevenly on the ranks; the ranks'
  weights equal bit for bit, the checkpoint written once and restored on
  both ranks; GOKU on ``SPendulum`` (each rank's cut of the global batch's
  Brownian keys) bit for bit with its per-step loop;
- ``MultiSeedTrainer(mesh)``, 4 seeds on 2 ranks, against the unsharded
  population: replica for replica (rtol 2e-4), the same best seed and
  selection, the population file, a prune to 2 survivors and one more
  epoch; the refusals of seeds and survivors that do not divide the mesh;
- ``train_goku.py --data-parallel 2 --device cpu`` (1 epoch on a
  synthetic npz cache) against the one-process run, solo and ``--seeds
  2``.
In-process: ``random.randint`` bit for bit against ``jax.random.randint``,
``--data-parallel 1`` without a launcher against the solo run (1e-6, as
``chip_smoke.py`` holds it on the card), and the refusals.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.abspath(ROOT))

from latentdiffeq_torch import random as jr  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.examples.pendulum import (  # noqa: E402
    create_data as pcreate, train_goku as ptg)
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum, SPendulum  # noqa: E402
from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig,  # noqa: E402
                                      Trainer, jax_param_paths,
                                      load_jax_params, loss_batch, optim)

D, SEQ, DT = 32, 8, 0.05
SMALL = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
FAIL_AT = 0.95
LAUNCH_TIMEOUT = 240
CLI = ["--device", "cpu", "--epochs", "1", "--batch-size", "4",
       "--seq-len", "8", "--no-viz"]


# -- shared by the worker and the tests ----------------------------------

class _FailRows:
    """The model with the rows whose first pixel exceeds FAIL_AT marked as
    failed solves (aux["success"] False), the failure mask_failures drops."""

    def __init__(self, m):
        self.m = m

    def __call__(self, x, t, **kw):
        out, mu, lv, aux = self.m(x, t, **kw)
        return out, mu, lv, dict(aux, success=aux["success"]
                                 & (x[:, 0, 0] <= FAIL_AT))


def fail_rows_loss(m, x, t, beta, **kw):
    return loss_batch(_FailRows(m), x, t, beta, **kw)


def port_model(seed=0, diffeq=None):
    diffeq = diffeq or Pendulum(options=SolveOptions(adaptive=False,
                                                     substeps=1))
    enc, dec = goku_default_layers(
        D, diffeq, device="cpu", generator=torch.Generator().manual_seed(seed),
        **SMALL)
    return LatentDiffEqModel.build(GOKUBasic(), enc, dec)


def step_data():
    """The global minibatch of the step cases: 16 rows, rows 9-11 (rank
    1's) failing."""
    x = np.random.default_rng(0).random((16, 12, D)).astype(np.float32)
    x[:, :, 0] *= 0.9
    x[9:12, :, 0] = 0.99
    return x


def fit_data():
    """40 training rows (7 of them failing, spread by the shuffles) and 6
    validation rows."""
    rng = np.random.default_rng(1)
    x = rng.random((46, 12, D)).astype(np.float32)
    x[:, :, 0] *= 0.9
    x[[2, 5, 11, 17, 23, 31, 37], :, 0] = 0.99
    return x[:40], x[40:]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as the ranks run: the suite's parallel workers
    would oversubscribe the CPU otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the shard_map step unmasked adds nothing its masked case does not check
STEP_CASES = [("dp", False), ("dp", True), ("shardmap", True)]
FIT_CFG = dict(batch_size=8, seq_len=SEQ, epochs=2, seed=3, lr=3e-3)
# Trainer(mesh)'s cases: two blocks
MESH_CFG = dict(FIT_CFG, epochs=4, epochs_per_dispatch=2)
MESH_CASES = {"fit": {}, "fit_masked": {"mask_failures": True},
              "fit_sde": {}}


def synthetic_video(n=20, T=12, seed=0):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, T, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (n, 1)).astype(np.float32)
    frames = rng.uniform(0, 1, (n, T, 28, 28)).astype(np.float32)
    return latent, latent[:, 0].copy(), ps, frames


def seed_cache(data_dir):
    pcreate.write_cache(os.path.join(data_dir, pcreate.DEFAULT_FILE),
                        synthetic_video(), pcreate.cache_key(device="cpu"))


def params_of(model):
    return {p: v.detach().numpy().copy()
            for p, v in zip(jax_param_paths(model), model.parameters())}


def run_state(tr):
    """A Trainer's state that block mode must reproduce bit for bit:
    (arrays: weights, optimizer state, best weights; info: history,
    optimizer step, best epoch and validation loss)."""
    arrays = {f"w/{p}": a for p, a in params_of(tr.model).items()}
    arrays.update({f"opt/{i}": t.numpy().copy()
                   for i, t in enumerate(tr.opt.state_tensors())})
    arrays.update({f"best/{k}": v.numpy().copy()
                   for k, v in tr.best["model"].items()})
    keys = ("epoch", "train_loss", "val_loss", "kl", "n_failed", "beta",
            "seq_len")
    return arrays, {"history": [[h[k] for k in keys] for h in tr.history],
                    "t": tr.opt.t, "best_epoch": tr.best["epoch"],
                    "best_val": tr.best_val_loss}


def score_fn(stacked):
    """A selection score from the weights alone (one per replica)."""
    w = stacked.params["decoder.reconstructor.layers.0.W"]
    return (-(w.detach() ** 2).sum(dim=(1, 2))).numpy()


# -- the worker: one rank of the launch -------------------------------------

def worker(out):
    from latentdiffeq_torch.parallel import (
        initialize_distributed, make_dp_train_step, make_mesh,
        make_shardmap_train_step, replicate, shard_batch)

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    initialize_distributed(f"file://{os.path.join(out, 'store')}", 2, rank,
                           device="cpu")
    mesh = make_mesh()
    res, info = {}, {"rank": rank}
    # each rank's own weights, then rank 0's everywhere
    res.update({f"replicated/{p}": a for p, a in params_of(
        replicate(port_model(rank), mesh)).items()})

    # one step of each data-parallel step, on JAX's weights
    with np.load(os.path.join(out, "jax_weights.npz")) as f:
        weights = dict(f)
    x = torch.from_numpy(shard_batch(step_data(), mesh))
    makers = {"dp": make_dp_train_step, "shardmap": make_shardmap_train_step}
    for kind, masked in STEP_CASES:
        m = port_model()
        load_jax_params(m, weights)
        opt = optim.adamw(m.parameters(), 1e-3, 0.9, 0.999, 1e-3)
        lf = (functools.partial(fail_rows_loss, mask_failures=True)
              if masked else loss_batch)
        step = makers[kind](opt, mesh, seq_len=SEQ, dt=DT, loss_fn=lf)
        _, _, met = step(m, opt, x, jr.PRNGKey(5), 0.5)
        case = f"{kind}{'_masked' if masked else ''}"
        res.update({f"{case}/{p}": a for p, a in params_of(m).items()})
        info[case] = {k: float(v) for k, v in met.items()}

    # Trainer(mesh) in blocks and per step: plain, with failing rows, SDE
    train, val = fit_data()
    for case, kw in MESH_CASES.items():
        sde = case == "fit_sde"
        for mode, jit in (("", True), ("_per_step", False)):
            cfg = TrainConfig(**MESH_CFG, jit_epoch=jit, **kw,
                              checkpoint_dir=os.path.join(out, case + mode))
            tr = Trainer(port_model(7, SPendulum() if sde else None), cfg,
                         device="cpu", mesh=mesh,
                         loss_fn=loss_batch if sde else fail_rows_loss)
            tr.fit(train, val, verbose=False)
            arrays, info[case + mode] = run_state(tr)
            info[case + mode]["blocks"] = bool(tr._block_fns)
            res.update({f"{case}{mode}/{k}": a for k, a in arrays.items()})
        if sde:
            continue
        again = Trainer(port_model(8), cfg, device="cpu", mesh=mesh)
        again.restore(os.path.join(out, case, "best_model.npz"))
        res.update({f"{case}_restored/{p}": a
                    for p, a in params_of(again.model).items()})
        info[f"{case}_restored_epoch"] = again.epoch

    try:
        Trainer(port_model(), TrainConfig(batch_size=5), device="cpu",
                mesh=mesh)
        info["refused_batch"] = False
    except ValueError:
        info["refused_batch"] = True

    # a population of 4 seeds sharded over the 2 ranks
    cfg = TrainConfig(**FIT_CFG, save_best=False)
    ms = MultiSeedTrainer(port_model, cfg, [1, 2, 3, 4], device="cpu",
                          mesh=mesh)
    ms.fit(train, val, verbose=False)
    _, sel = ms.select(score_fn)
    ms.save_population(os.path.join(out, "population.npz"))
    info["pop"] = {"local_seeds": ms.local_seeds, "best_seed": ms.best_seed,
                   "vals": ms.per_seed_best_vals, "select": sel,
                   "history": [h["val_loss"].tolist() for h in ms.history],
                   "elbo": ms.elbo_rank(val, np.arange(12) * DT)}
    res.update({f"pop_best/{p}": a
                for p, a in params_of(ms.best_model).items()})
    for name, bad in (
            ("prune", lambda: ms.prune([0, 1, 2])),
            ("seeds", lambda: MultiSeedTrainer(port_model, cfg, [1, 2, 3],
                                               device="cpu", mesh=mesh))):
        try:
            bad()
            info[f"refused_{name}"] = False
        except ValueError:
            info[f"refused_{name}"] = True
    ms.prune([1, 2])
    ms.fit(train, val, epochs=3, verbose=False)
    info["pruned"] = {"seeds": ms.seeds, "local_seeds": ms.local_seeds,
                      "vals": ms.per_seed_best_vals}
    for i in range(2):
        res.update({f"pruned{i}/{p}": a
                    for p, a in params_of(ms.seed_model(i)).items()})

    # the CLI on the launcher's two ranks
    pcreate.DATA_DIR = os.path.join(out, "data")
    if rank == 0:
        seed_cache(pcreate.DATA_DIR)
    torch.distributed.barrier()
    for case, argv in (("cli", []), ("cli_seeds", ["--seeds", "2"])):
        ptg.OUTPUT_DIR = os.path.join(out, case)
        got = ptg.main(CLI + argv + ["--data-parallel", "2"])
        model = got.best_model if argv else got.model
        res.update({f"{case}/{p}": a for p, a in params_of(model).items()})
        info[case] = [{k: np.asarray(h[k]).tolist()
                       for k in ("train_loss", "val_loss")}
                      for h in got.history]
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


# -- the tests -------------------------------------------------------------

def jax_pair():
    """JAX's small GOKU and its weights by path."""
    import jax

    from latentdiffeq import make_options
    from latentdiffeq.models import GOKUBasic as JGOKUBasic
    from latentdiffeq.models import LatentDiffEqModel as JModel
    from latentdiffeq.models import default_layers as jdefault_layers
    from latentdiffeq.train.checkpoint import _path_str
    sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))
    from pendulum import Pendulum as JPendulum

    diffeq = JPendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), D, diffeq,
                               **SMALL)
    jm = JModel.build(JGOKUBasic(), enc, dec)
    return jm, {_path_str(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(jm)[0]}


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """Runs the two ranks once, and JAX's steps (in threads, XLA compiles
    them at once) while they run; returns (out dir, {step case: JAX's
    weights and metrics}, [each rank's (arrays, info)])."""
    from concurrent.futures import ThreadPoolExecutor

    out = str(tmp_path_factory.mktemp("ranks"))
    jm, weights = jax_pair()
    np.savez(os.path.join(out, "jax_weights.npz"), **weights)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", os.path.abspath(__file__), out]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    with ThreadPoolExecutor(len(STEP_CASES)) as ex:
        refs = dict(zip(STEP_CASES, ex.map(lambda c: jax_step(jm, *c),
                                           STEP_CASES)))
    try:
        log, _ = proc.communicate(timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail(f"the two ranks did not finish in {LAUNCH_TIMEOUT} s")
    assert proc.returncode == 0, log[-4000:]
    ranks = []
    for r in (0, 1):
        with np.load(os.path.join(out, f"rank{r}.npz")) as f:
            arrays = dict(f)
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append((arrays, json.load(f)))
    return out, refs, ranks


def case(arrays, name):
    return {k.split("/", 1)[1]: v for k, v in arrays.items()
            if k.split("/", 1)[0] == name}


def close(got, want, rtol, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def close_but_few(got, want, rtol, atol, cap, frac=1e-4):
    """``close``, but for at most ``frac`` of the elements, which must lie
    within ``cap``: Adam scales each element's update by its gradient's
    size, so an element whose gradient is at the rounding level of the
    reduction can move by up to 2 lr a step in either run (weights of
    784-wide inputs over several steps)."""
    assert sorted(got) == sorted(want)
    n = bad = 0
    for k in want:
        off = ~np.isclose(got[k], want[k], rtol=rtol, atol=atol)
        n, bad = n + off.size, bad + int(off.sum())
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=cap,
                                   err_msg=k)
    assert bad <= frac * n, (bad, n)


def jax_step(jm, kind, masked):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from latentdiffeq.parallel import (make_dp_train_step, make_mesh,
                                       make_shardmap_train_step)
    from latentdiffeq.train import losses as jlosses
    from latentdiffeq.train import optim as joptim
    from latentdiffeq.train.checkpoint import _path_str

    class JFailRows:
        def __init__(self, m):
            self.m = m

        def __call__(self, x, t, **kw):
            out, mu, lv, aux = self.m(x, t, **kw)
            return out, mu, lv, dict(aux, success=aux["success"]
                                     & (x[:, 0, 0] <= FAIL_AT))

    def jloss(m, x, t, beta, **kw):
        return jlosses.loss_batch(JFailRows(m), x, t, beta,
                                  mask_failures=True, **kw)

    mesh = make_mesh(2)
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    make = make_dp_train_step if kind == "dp" else make_shardmap_train_step
    step = make(opt, mesh, seq_len=SEQ, dt=DT,
                loss_fn=jloss if masked else jlosses.loss_batch)
    xg = jax.device_put(step_data(), NamedSharding(mesh, P("data")))
    m2, _, met = step(jm, opt.init(jm), xg, jax.random.PRNGKey(5),
                      jnp.asarray(0.5))
    return ({_path_str(p): np.asarray(v) for p, v in
             jax.tree_util.tree_flatten_with_path(m2)[0]},
            {k: float(v) for k, v in met.items()})


def test_replicate_gives_every_rank_rank_0s_weights(launch):
    """replicate() on models drawn from each rank's own seed: both ranks
    hold rank 0's weights, bit for bit."""
    want = params_of(port_model(0))
    for arrays, _ in launch[2]:
        close(case(arrays, "replicated"), want, 0.0)


@pytest.mark.parametrize("kind,masked", STEP_CASES)
def test_step_matches_jax_on_two_ranks(launch, kind, masked):
    """One step on 2 gloo ranks against JAX's step on make_mesh(2): weights
    rtol 1e-5 / atol 1e-6 (JAX's own tolerance between its meshes), the
    loss, rec and kl rtol 1e-5, the counts equal; both ranks' weights
    equal bit for bit. With mask_failures the failing rows are rank 1's
    only, so the GSPMD step's global denominator and the shard_map step's
    local ones differ."""
    _, refs, ranks = launch
    name = f"{kind}{'_masked' if masked else ''}"
    want, jmet = refs[kind, masked]
    got = case(ranks[0][0], name)
    close(got, want, 1e-5, 1e-6)
    close(case(ranks[1][0], name), got, 0.0)
    met = ranks[0][1][name]
    assert met == ranks[1][1][name]
    for k in ("loss", "rec", "kl"):
        np.testing.assert_allclose(met[k], jmet[k], rtol=1e-5, err_msg=k)
    for k in ("n_failed", "n_rhs_evals"):
        assert met[k] == jmet[k], k
    assert met["n_failed"] == (3 if masked else 0)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_blocks_equal_the_mesh_per_step_loop_bit_for_bit(launch, name):
    """Trainer(mesh) on 2 ranks in block mode (2 blocks of 2 epochs, eager
    on the CPU) against the same mesh's per-step loop: the weights, the
    optimizer's state and step, every history record, the best epoch,
    validation loss and weights bit for bit on each rank; the ranks
    agree."""
    for arrays, info in launch[2]:
        blk, ref = info[name], info[name + "_per_step"]
        assert blk["blocks"] and not ref["blocks"]
        assert blk == dict(ref, blocks=True)
        close(case(arrays, name), case(arrays, name + "_per_step"), 0.0)
    assert launch[2][0][1][name] == launch[2][1][1][name]
    close(case(launch[2][1][0], name), case(launch[2][0][0], name), 0.0)


@pytest.mark.parametrize("masked", [False, True])
def test_trainer_on_two_ranks_equals_solo_trainer(launch, masked):
    """Trainer(mesh) on 2 ranks in block mode, 2 blocks of 2 epochs,
    against the solo block Trainer with the same seed: weights rtol 2e-4
    / atol 1e-6 and the history's losses rtol 2e-4 (the order of the
    gradient reduction), the failure counts equal; the ranks agree bit for bit;
    rank 0's best checkpoint restores its state on both."""
    out, _, ranks = launch
    name = "fit_masked" if masked else "fit"
    train, val = fit_data()
    cfg = TrainConfig(**MESH_CFG, save_best=False, mask_failures=masked)
    solo = Trainer(port_model(7), cfg, device="cpu", loss_fn=fail_rows_loss)
    solo.fit(train, val, verbose=False)
    got = {k[2:]: v for k, v in case(ranks[0][0], name).items()
           if k.startswith("w/")}
    close(got, params_of(solo.model), 2e-4, 1e-6)
    close(case(ranks[1][0], name), case(ranks[0][0], name), 0.0)
    for h, s in zip(ranks[0][1][name]["history"], solo.history):
        for i, k in ((1, "train_loss"), (2, "val_loss"), (3, "kl")):
            np.testing.assert_allclose(h[i], s[k], rtol=2e-4, err_msg=k)
        assert h[4] == s["n_failed"]
    assert ranks[1][1][name] == ranks[0][1][name]
    assert sum(h["n_failed"] for h in solo.history) > 0
    # the failing rows fall unevenly on the ranks in some step
    perm_rng, failing = np.random.default_rng(3), train[:, 0, 0] > FAIL_AT
    uneven = [int(failing[idx[:4]].sum()) != int(failing[idx[4:8]].sum())
              for _ in range(MESH_CFG["epochs"])
              for perm in [perm_rng.permutation(40)]
              for idx in perm[:40].reshape(5, 8)]
    assert any(uneven)
    assert os.listdir(os.path.join(out, name)) == ["best_model.npz"]
    assert ranks[0][1]["refused_batch"] and ranks[1][1]["refused_batch"]
    ckpt = Trainer(port_model(9), cfg, device="cpu").restore(
        os.path.join(out, name, "best_model.npz"))
    for arrays, info in ranks:
        close(case(arrays, f"{name}_restored"), params_of(ckpt.model), 0.0)
        assert info[f"{name}_restored_epoch"] == ckpt.epoch


def test_sharded_population_equals_unsharded(launch):
    """MultiSeedTrainer(mesh): seeds 1, 2 on rank 0 and 3, 4 on rank 1,
    against the unsharded population of the same 4 seeds: the best seed,
    the best losses and every epoch's validation losses (rtol 2e-4), the
    selection, elbo_rank, the population file replica for replica, the
    best model; after a prune to replicas 1 and 2 (one a rank) and a third
    epoch, the survivors. Survivor and seed counts that do not divide the
    mesh are refused."""
    out, _, ranks = launch
    train, val = fit_data()
    cfg = TrainConfig(**FIT_CFG, save_best=False)
    ms = MultiSeedTrainer(port_model, cfg, [1, 2, 3, 4], device="cpu")
    ms.fit(train, val, verbose=False)
    _, sel = ms.select(score_fn)
    ref_file = os.path.join(out, "population_unsharded.npz")
    ms.save_population(ref_file)
    info0, info1 = ranks[0][1], ranks[1][1]
    assert info0["pop"]["local_seeds"] == [1, 2]
    assert info1["pop"]["local_seeds"] == [3, 4]
    for info in (info0, info1):
        p = info["pop"]
        assert p["best_seed"] == ms.best_seed
        np.testing.assert_allclose(p["vals"], ms.per_seed_best_vals,
                                   rtol=2e-4)
        np.testing.assert_allclose(
            p["history"], [h["val_loss"] for h in ms.history], rtol=2e-4)
        for k in ("index", "seed", "from_best"):
            assert p["select"][k] == sel[k], k
        np.testing.assert_allclose(p["select"]["scores_live"],
                                   sel["scores_live"], rtol=2e-4)
        np.testing.assert_allclose(p["elbo"], ms.elbo_rank(
            val, np.arange(12) * DT), rtol=2e-4)
        assert info["refused_prune"] and info["refused_seeds"]
    with np.load(os.path.join(out, "population.npz")) as a, \
            np.load(ref_file) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k == "__meta__":
                continue
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6,
                                       err_msg=k)
    close(case(ranks[0][0], "pop_best"), params_of(ms.best_model), 2e-4,
          1e-6)
    ms.prune([1, 2])
    ms.fit(train, val, epochs=3, verbose=False)
    assert info0["pruned"]["seeds"] == ms.seeds == [2, 3]
    assert info0["pruned"]["local_seeds"] == [2]
    assert info1["pruned"]["local_seeds"] == [3]
    np.testing.assert_allclose(info0["pruned"]["vals"],
                               ms.per_seed_best_vals, rtol=2e-4)
    for i in range(2):
        close(case(ranks[1][0], f"pruned{i}"), params_of(ms.seed_model(i)),
              2e-4, 1e-6)


def test_train_goku_data_parallel_cli_equals_one_process(launch,
                                                         monkeypatch):
    """train_goku.py --data-parallel 2 --device cpu under
    torch.distributed.run, 1 epoch on a synthetic npz cache, against the
    one-process run with the same flags: the solo path's weights and the
    population's winner rtol 2e-4 / atol 1e-6 but for at most 1 in 10^4
    elements (``close_but_few``), the validation losses rtol 2e-4; the
    ranks agree bit for bit; rank 0 wrote the checkpoint."""
    out, _, ranks = launch
    monkeypatch.setattr(pcreate, "DATA_DIR", os.path.join(out, "data"))
    for name, argv in (("cli", []), ("cli_seeds", ["--seeds", "2"])):
        monkeypatch.setattr(ptg, "OUTPUT_DIR", os.path.join(out, name + "1"))
        got = ptg.main(CLI + argv)
        model = got.best_model if argv else got.model
        # lr 1e-3, 4 steps
        close_but_few(case(ranks[0][0], name), params_of(model), 2e-4, 1e-6,
                      cap=8e-3)
        close(case(ranks[1][0], name), case(ranks[0][0], name), 0.0)
        for h, s in zip(ranks[0][1][name], got.history):
            np.testing.assert_allclose(h["val_loss"], s["val_loss"],
                                       rtol=2e-4)
        assert os.path.exists(os.path.join(out, name, "best_model.npz"))


def test_data_parallel_one_rank_without_launcher(monkeypatch, tmp_path):
    """--data-parallel 1 with no launcher sets up (and ends) a one-rank
    group itself and trains what the solo run trains (within 1e-6, the
    gate chip_smoke.py holds on the card); a launcher's WORLD_SIZE other
    than N raises, and a mesh wider than the world."""
    import torch.distributed as dist

    monkeypatch.setattr(pcreate, "DATA_DIR", str(tmp_path / "data"))
    seed_cache(str(tmp_path / "data"))
    monkeypatch.setattr(ptg, "OUTPUT_DIR", str(tmp_path / "solo"))
    solo = ptg.main(CLI)
    monkeypatch.setattr(ptg, "OUTPUT_DIR", str(tmp_path / "dp1"))
    dp = ptg.main(CLI + ["--data-parallel", "1"])
    assert not dist.is_initialized()
    close(params_of(dp.model), params_of(solo.model), 0.0, 1e-6)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="2 were started"):
        ptg.main(CLI + ["--data-parallel", "1"])
    monkeypatch.delenv("WORLD_SIZE")
    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    assert initialize_distributed(device="cpu") == 1
    try:
        assert initialize_distributed(device="cpu") == 1   # a no-op
        with pytest.raises(ValueError, match="requested 2"):
            make_mesh(2)
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_picks_the_backend(monkeypatch):
    """NCCL for ranks with a card each, gloo on the CPU and where a host
    starts more ranks (LOCAL_WORLD_SIZE) than it has cards: they share a
    card, which NCCL refuses."""
    import torch.distributed as dist

    from latentdiffeq_torch.parallel import initialize_distributed
    got = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.append(backend))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cases = ((None, "cpu", "gloo"), (None, "cuda", "nccl"),
             ("2", "cuda", "nccl"), ("3", "cuda", "gloo"),
             ("3", "cpu", "gloo"))
    for local, device, _ in cases:
        if local is None:
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
        assert initialize_distributed(device=device) == 1
    assert got == [want for _, _, want in cases]


def test_randint_equals_jax_bit_for_bit():
    """random.randint against jax.random.randint (int32, under
    jax_threefry_partitionable, which tests/conftest.py sets) over many
    keys, ranges and shapes: narrow, wide, near the int32 bounds, empty
    (maxval <= minval returns minval), and the data-parallel window's
    [0, max(T - seq_len, 1)); per-element bounds as well as scalar ones."""
    import jax

    rng = np.random.default_rng(0)
    n = 60
    lo = np.empty(n, np.int64)
    hi = np.empty(n, np.int64)
    lo[:12] = rng.integers(-2**31, 2**31 - 100, 12)
    hi[:12] = lo[:12] + rng.integers(1, 100, 12)                 # narrow
    lo[12:24], hi[12:24] = rng.integers(-2**31, 2**31, (2, 12))  # any
    lo[24:36] = -2**31 + rng.integers(0, 5, 12)                  # wide
    hi[24:36] = 2**31 - 1 - rng.integers(0, 5, 12)
    lo[36:48] = 0                                               # windows
    hi[36:48] = np.maximum(rng.integers(1, 100, 12) - SEQ, 1)
    lo[48:] = rng.integers(-100, 100, 12)                       # empty
    hi[48:] = lo[48:] - rng.integers(0, 3, 12)
    lo32, hi32 = lo.astype(np.int32), hi.astype(np.int32)
    for i in range(24):
        kj = jax.random.fold_in(jax.random.PRNGKey(int(rng.integers(2**31))),
                                i)
        kt = jr.as_key(np.asarray(kj))
        want = np.asarray(jax.random.randint(kj, (n,), lo32, hi32))
        np.testing.assert_array_equal(jr.randint(kt, (n,), lo, hi).numpy(),
                                      want)
        j = i % n
        for shape in ((), (3, 4)):
            want = np.asarray(jax.random.randint(kj, shape, int(lo[j]),
                                                 int(hi[j])))
            np.testing.assert_array_equal(
                jr.randint(kt, shape, int(lo[j]), int(hi[j])).numpy(), want,
                err_msg=f"{lo[j]} {hi[j]}")


if __name__ == "__main__":
    worker(sys.argv[1])
