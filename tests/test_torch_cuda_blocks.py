"""Block mode on the card for the configurations that trained per step
before: SDE dynamics (SRA1 on the grid and adaptive), an adaptive ODE
solve, populations (MultiSeedTrainer) and a one-rank NCCL mesh
(Trainer(mesh=), DDP's all-reduces in the captured epochs after its
eager warm-up). Each fit runs blocks whose
first epoch is eager on a side stream and whose later epochs replay a
captured CUDA graph, under torch.cuda.set_sync_debug_mode("error"), and
must equal its per-step loop (jit_epoch=False, every epoch eager) from the
same seeds bit for bit: every epoch's losses, the weights, Adam's state,
the best and every random stream, with the same kernel launches. A
captured adaptive solve runs its whole step budget where the eager one
stops early (latentdiffeq_torch/solve/adaptive.py).

Every test needs a CUDA card and skips without one; the file imports torch
and the port only:

    python -m pytest tests/test_torch_cuda_blocks.py -m cuda --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       LatentODE, NODE, default_layers,
                                       goku_default_layers)
from latentdiffeq_torch.ops import launches
from latentdiffeq_torch.pendulum import Pendulum, SPendulum
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig
from latentdiffeq_torch.train import MultiSeedTrainer, TrainConfig, Trainer

EPOCHS = 5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


DYNAMICS = {
    "sde": lambda: SPendulum(),
    "sde_adaptive": lambda: SPendulum(adaptive=True,
                                      adaptive_cfg=SDEAdaptiveConfig(
                                          max_steps=40, depth_cap=3)),
    "adaptive": lambda: Pendulum(options=make_options(adaptive=True,
                                                      max_steps=48)),
    "pendulum": lambda: Pendulum(options=SolveOptions(adaptive=False,
                                                      substeps=1)),
}


def goku(dev, which, seed=3, dtype=torch.float32):
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
        *goku_default_layers(64, DYNAMICS[which](), hidden_dim_resnet=32,
                             latent_to_diffeq_dim=32, device=dev,
                             generator=torch.Generator().manual_seed(seed),
                             dtype=dtype))


def latent_ode(dev, seed):
    g = torch.Generator().manual_seed(seed)
    mt = LatentODE(use_kernel_solve=True)
    node = NODE(6, hidden_dim=32, generator=g, device=dev,
                options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        mt, *default_layers(mt, 64, node, generator=g, device=dev,
                            hidden_dim_resnet=32))


def data(dev):
    g = torch.Generator().manual_seed(4)
    x = torch.rand(20, 16, 64, generator=g).to(dev)
    return x[:16], x[16:]


CFG = TrainConfig(batch_size=8, seq_len=10, epochs=50, save_best=False)


def fit_both(make, epochs=EPOCHS):
    """``make(**cfg changes)`` -> trainer; the per-step run and the run in
    blocks of 2 (replays under sync debug mode "error"), with the launches
    each gained."""
    runs = []
    for kw in (dict(jit_epoch=False), dict(epochs_per_dispatch=2)):
        tr = make(**kw)
        tr.sync_debug = "error"
        before = launches.snapshot()
        tr.fit(*data(tr.device), epochs=epochs, verbose=False)
        torch.cuda.synchronize()
        runs.append((tr, launches.gained(before, launches.snapshot())))
    return runs


def assert_same_trainer(a, b):
    """Two Trainers bit for bit: losses, weights, Adam's state, the best
    and every random stream."""
    same_history(a, b, ("train_loss", "val_loss", "kl", "n_failed"))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.opt.t == b.opt.t
    for p, q in zip(a.opt.state_tensors(), b.opt.state_tensors()):
        assert torch.equal(p, q)
    assert a.best["epoch"] == b.best["epoch"]
    assert a.best_val_loss == b.best_val_loss
    for k, v in a.best["model"].items():
        assert torch.equal(v, b.best["model"][k]), k
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())
    assert torch.equal(a.window_gen.get_state(), b.window_gen.get_state())
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state


def same_history(a, b, keys):
    for ha, hb in zip(a.history, b.history):
        for k in keys:
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    assert len(a.history) == len(b.history)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["sde", "sde_adaptive", "adaptive"])
def test_captured_epochs_equal_the_per_step_loop(dev, which):
    """SDE GOKU on the grid and adaptive, and adaptive-ODE GOKU: blocks of
    2 (graphs captured and replayed) against the per-step loop, 5 epochs,
    bit for bit, the same launches, no plain call."""
    (a, na), (b, nb) = fit_both(lambda **kw: Trainer(
        goku(dev, which), dataclasses.replace(CFG, **kw), device=dev))
    assert b._block_fns and all(f._graph is not None
                                for f in b._block_fns.values())
    assert na == nb
    assert not na["plain goku_heads"] and na["goku_heads"] > 0
    assert_same_trainer(a, b)


@pytest.fixture
def nccl_mesh(dev):
    """A one-rank NCCL group and its mesh (this process's own)."""
    import torch.distributed as dist

    from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already set up")
    initialize_distributed(device=dev)
    try:
        assert dist.get_backend() == "nccl"
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["pendulum", "sde"])
def test_captured_mesh_epochs_equal_the_per_step_loop(dev, nccl_mesh, which):
    """Trainer(mesh=) on a one-rank NCCL mesh, 2 steps an epoch: blocks of
    2 (6 eager epochs of DDP's warm-up, then graphs captured and replayed
    with the all-reduces inside) against the mesh's per-step loop and
    against the solo block Trainer, 10 epochs, bit for bit (at one rank
    DDP's mean and the loss's sums are exact), the same launches."""
    def make(mesh, **kw):
        return Trainer(goku(dev, which), dataclasses.replace(CFG, **kw),
                       device=dev, mesh=mesh)

    (a, na), (b, nb) = fit_both(lambda **kw: make(nccl_mesh, **kw),
                                epochs=10)
    assert b._block_fns and all(f._graph is not None
                                for f in b._block_fns.values())
    assert na == nb and not na["plain goku_heads"] and na["goku_heads"] > 0
    assert_same_trainer(a, b)
    solo = make(None, epochs_per_dispatch=2)
    solo.fit(*data(dev), epochs=10, verbose=False)
    assert_same_trainer(solo, b)


POPULATIONS = {
    "goku": lambda dev: (lambda s: goku(dev, "pendulum", s)),
    "goku_bf16": lambda dev: (lambda s: goku(dev, "pendulum", s,
                                             torch.bfloat16)),
    "latent_ode": lambda dev: (lambda s: latent_ode(dev, s)),
    "spendulum": lambda dev: (lambda s: goku(dev, "sde", s)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(POPULATIONS))
def test_captured_population_epochs_equal_the_per_step_loop(dev, which):
    """A population of 3 seeds (every S noise generator registered with
    the graph): blocks of 2 against the per-step loop, 5 epochs, bit for
    bit (each replica's losses, weights, moments, best and streams), the
    same launches."""
    init = POPULATIONS[which](dev)
    (a, na), (b, nb) = fit_both(lambda **kw: MultiSeedTrainer(
        init, dataclasses.replace(CFG, **kw), [3, 4, 5], device=dev))
    assert b._block_fns and all(f._graph is not None
                                for f in b._block_fns.values())
    assert na == nb and not na["plain goku_heads"]
    same_history(a, b, ("train_loss", "val_loss", "n_failed"))
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a._best["params"][k], b._best["params"][k]), k
    for p, q in zip(a.opt.state_tensors(), b.opt.state_tensors()):
        assert torch.equal(p, q)
    np.testing.assert_array_equal(a._best["val"], b._best["val"])
    np.testing.assert_array_equal(a._best["epoch"], b._best["epoch"])
    for ga, gb in zip(a.noise_gens + a.window_gens,
                      b.noise_gens + b.window_gens):
        assert torch.equal(ga.get_state(), gb.get_state())
    assert [r.bit_generator.state for r in a.np_rngs] == \
        [r.bit_generator.state for r in b.np_rngs]
