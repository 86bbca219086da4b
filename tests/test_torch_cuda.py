"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and skips
without one. The file imports torch and the port only, never JAX, so it
runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Float32 with TF32 off; kernel vs plain version atol 1e-5 (the same
arithmetic, summed in another order).
"""
import pytest
import torch

from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.ops import ode_cuda, recurrent_cuda
from latentdiffeq_torch.pendulum import (Pendulum, pendulum_f,
                                         pendulum_friction_f)
from latentdiffeq_torch.solve import rk as trk

ATOL = 1e-5
SOLVERS = ["Euler", "Midpoint", "RK4", "Tsit5", "Dopri5"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def heads_on(dev, D=32, H=16, seed=0):
    """The three GOKU heads with every weight (biases and initial states
    too) drawn from N(0, 0.15^2): small enough that the ReLU RNN's state
    stays O(1) over 100 steps (its recurrent matrix has spectral radius
    about 0.15 * sqrt(H) = 0.6), so an absolute tolerance means what it
    says."""
    g = torch.Generator().manual_seed(seed)
    heads = (tnn.Recurrent.rnn(D, (H, H), tnn.relu),
             tnn.Recurrent.lstm(D, (H, H)), tnn.Recurrent.lstm(D, (H, H)))
    with torch.no_grad():
        for p in (p for h in heads for p in h.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    return tuple(h.to(dev) for h in heads)


def rk_inputs(dev, B, T, seed=0):
    g = torch.Generator().manual_seed(seed)
    u0s = torch.rand(B, 2, generator=g) * 2 - 1
    ps = 1 + torch.rand(B, 1, generator=g)
    saveat = torch.arange(T, dtype=torch.float32) * 0.05
    return u0s.to(dev), ps.to(dev), saveat.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (45, 100), (37, 21)])
def test_goku_heads_kernel_matches_plain_on_card(dev, B, T):
    heads = heads_on(dev)
    xs = torch.randn(B, T, 32, device=dev)
    with torch.no_grad():
        got = recurrent_cuda.goku_heads_cuda(*heads, xs)
        ref = recurrent_cuda.goku_heads_reference(*heads, xs)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("solver", SOLVERS)
def test_rk_kernel_matches_plain_on_card(dev, solver):
    u0s, ps, saveat = rk_inputs(dev, B=70, T=40, seed=6)
    s = getattr(trk, solver)()
    for f in (pendulum_f, pendulum_friction_f):
        got = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                     substeps=2)
        ref, _, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=2)
        assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.cuda
def test_kernel_gradients_match_plain_autograd_on_card(dev):
    """Each autograd.Function's backward recomputes through the plain
    version, so its gradients equal plain autograd's (to 1e-5 relative to
    the gradient's size)."""
    heads = heads_on(dev, seed=1)
    params = [p for h in heads for p in h.parameters()]
    xs = torch.randn(16, 12, 32, device=dev, requires_grad=True)

    def heads_grads(fn):
        z0, th = fn(*heads, xs)
        return torch.autograd.grad((z0 ** 2).sum() + torch.sin(th).sum(),
                                   [xs] + params)

    for a, b in zip(heads_grads(recurrent_cuda.goku_heads),
                    heads_grads(recurrent_cuda.goku_heads_reference)):
        assert float((a - b).abs().max()) <= ATOL * (1 + float(b.abs().max()))

    u0s, ps, saveat = rk_inputs(dev, B=16, T=20, seed=2)
    u0s.requires_grad_()
    ps.requires_grad_()

    def rk_grads(fn):
        ys = fn(pendulum_f, trk.Tsit5(), u0s, ps, saveat)[0]
        return torch.autograd.grad((ys ** 2).sum(), [u0s, ps])

    for a, b in zip(rk_grads(ode_cuda.solve_fixed_grid_batched),
                    rk_grads(ode_cuda.solve_fixed_grid_batched_reference)):
        assert float((a - b).abs().max()) <= ATOL * (1 + float(b.abs().max()))


@pytest.mark.cuda
def test_goku_kernel_path_matches_plain_path_on_card(dev):
    """A small GOKU with both kernel switches on launches each kernel once
    per forward and agrees with the same weights run plainly."""
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    layers = goku_default_layers(24, diffeq, hidden_dim_resnet=16,
                                 latent_to_diffeq_dim=16, device=dev)
    km = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    pm = LatentDiffEqModel.build(GOKUBasic(), *layers)
    x = torch.rand(6, 10, 24, device=dev)
    t = torch.arange(10, dtype=torch.float32, device=dev) * 0.05
    counters = (recurrent_cuda.goku_heads_cuda,
                ode_cuda.solve_fixed_grid_batched_cuda)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        xk = km(x, t)[0][0]
        xp = pm(x, t)[0][0]
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1]
    assert xk.shape == (6, 10, 24) and bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= 1e-4
