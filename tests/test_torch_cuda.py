"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card (a CUDA kernel has no CPU mode) and skips
without one. The file imports torch and the port only, never JAX, so it
runs on a machine that has no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Float32 with TF32 off; kernel vs plain version atol 1e-5 (the same
arithmetic, summed in another order). The GOKU heads' tape and their sweep
kernel (dgates, dh0, dc0 on the same tape), and the RK backward kernel
(its interval maps against the plain maps, its gradients against the
two-phase plain version and the plain reverse sweep over the same
trajectory) are held to 1e-5 of each tensor's size, and their whole
backwards to 1e-5 of each gradient's size against plain autograd (a relu
RNN to 1e-2 when one of its units flips between the kernel's and the plain
forward, as below). The RK kernels' baked tableau instances must equal the
generic one bit for bit, and their branch-free sine lie within 2.4e-7 of
float64 over the range they use it in. The
neural-field forward's tape, its
sweep kernel and its weight-gradient kernel are each held to 1e-5 of each
tensor's size against their plain versions on the same inputs; the whole
backward to 1e-5 of each gradient's size against the plain reverse sweep
that recomputes from the saved trajectory, in float32 and in float64, and
against plain autograd, for smooth fields (tanh, sigmoid, softplus). A relu
field's
gradient jumps when a unit's pre-activation lies within rounding of zero,
on in one evaluation and off in the other, however close the two are; the
plain float32 versions are then as far from float64 as the kernel is, so
relu fields get 1e-2 against the float64 sweep and against autograd.
"""
import copy
import ctypes

import pytest
import torch

from latentdiffeq_torch import custom_dynamics as cdyn
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       LatentODE, NODE, ODEDynamics,
                                       default_layers, goku_default_layers)
from latentdiffeq_torch.ops import (node_cuda, ode_cuda, recurrent_cuda,
                                    rhs_codegen)
from latentdiffeq_torch.pendulum import (Pendulum, pendulum_f,
                                         pendulum_friction_f)
from latentdiffeq_torch.solve import rk as trk

import rhs_zoo  # tests/rhs_zoo.py: user fields for the generated functors

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
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=2)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=2)
        assert float((got - ref).abs().max()) <= ATOL
        assert torch.equal(ok, ok_p)


@pytest.mark.cuda
def test_kernel_gradients_match_plain_autograd_on_card(dev):
    """Each autograd.Function's backward (the backward kernels by default)
    gives plain autograd's gradients (to 1e-5 relative to the gradient's
    size)."""
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


def heads_with(dev, act, D=32, H=16, L=2, seed=0):
    """GOKU-shaped heads with an RNN activation ``act``, weights as in
    ``heads_on``."""
    g = torch.Generator().manual_seed(seed)
    heads = (tnn.Recurrent.rnn(D, (H,) * L, act),
             tnn.Recurrent.lstm(D, (H,) * L), tnn.Recurrent.lstm(D, (H,) * L))
    with torch.no_grad():
        for p in (p for h in heads for p in h.parameters()):
            p.copy_(torch.randn(p.shape, generator=g) * 0.15)
    return tuple(h.to(dev) for h in heads)


def rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def launches(fn):
    """A kernel wrapper's launches so far (the RK launchers count theirs by
    kernel instance)."""
    n = fn.launches
    return sum(n.values()) if isinstance(n, dict) else n


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (45, 100), (37, 21)])
@pytest.mark.parametrize("D,H,L", [(32, 16, 2), (32, 16, 1), (32, 16, 4),
                                   (10, 8, 2), (64, 32, 2), (40, 20, 3),
                                   (24, 40, 1)])
def test_goku_heads_tape_variant_matches_plain_on_card(dev, B, T, D, H, L):
    """The forward kernel at every layer count it takes, with narrow heads
    (run at the compiled widths) and wide ones (run at their own widths),
    with and without a tape: the same outputs, within 1e-5 of the plain
    version, the tape (at the kernel's hidden width) within 1e-5 of the
    plain tape's size."""
    heads = heads_with(dev, tnn.relu, D, H, L)
    xs = torch.randn(B, T, D, device=dev)
    with torch.no_grad():
        z, th = recurrent_cuda.goku_heads_cuda(*heads, xs)
        zt, tht, tape = recurrent_cuda.goku_heads_cuda(*heads, xs, tape=True)
        zp, thp, tape_p = recurrent_cuda.goku_heads_taped_reference(*heads,
                                                                    xs)
    assert torch.equal(z, zt) and torch.equal(th, tht)
    assert float((z - zp).abs().max()) <= ATOL
    assert float((th - thp).abs().max()) <= ATOL
    Hk = recurrent_cuda.kernel_widths(D, H)[1]
    assert tape.shape == (B, T, 13 * Hk * L)
    if H == Hk:
        assert rel_err(tape, tape_p) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("act", [tnn.relu, tnn.tanh, tnn.identity],
                         ids=["relu", "tanh", "identity"])
@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("D,H", [(32, 16), (64, 32), (24, 40)])
def test_goku_heads_bwd_kernel_matches_plain_sweep_on_card(dev, act, L, D,
                                                           H):
    """The sweep kernel (the compiled widths, and heads wider than them at
    their own) against the plain sweep on the same tape: dgates, dh0 and
    dc0 within 1e-5 of each tensor's size."""
    heads = heads_with(dev, act, D, H, L=L, seed=L)
    B, T = 45, 30
    xs = torch.randn(B, T, D, device=dev)
    gz = torch.randn(B, H, device=dev)
    gt = torch.randn(B, 2 * H, device=dev)
    with torch.no_grad():
        _, _, tape = recurrent_cuda.goku_heads_cuda(*heads, xs, tape=True)
    got = recurrent_cuda.goku_heads_bwd_cuda(*heads, tape, gz, gt)
    ref = recurrent_cuda.goku_heads_sweep_reference(*heads, tape, gz, gt)
    for a, b in zip(got, ref):
        assert rel_err(a, b) <= ATOL


def heads_whole_backward_check(dev, act, D, H, seed):
    """The whole backward (tape forward, sweep kernel, products) against
    plain autograd on inputs drawn from ``seed``: within 1e-5 of each
    gradient's size, or 1e-2 for a relu RNN when a unit is on in the
    kernel's forward and off in the plain one (a pre-activation within
    rounding of zero moves the gradient by a finite amount). A vanishing
    gradient (below 1e-6 of the largest one's size: the initial states'
    decay through 50 steps to ~1e-12) that misses this is held to float64
    autograd on the same inputs instead, where plain float32 autograd is
    itself past the tolerance from float64: the kernel within 1e-4 of its
    size of float64, and no farther than plain float32 is (both float32
    routes' rounding shows at 1e-5 of such a size;
    scripts/heads_bwd_sweep.py)."""
    heads = heads_with(dev, act, D, H, seed=7)
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(64, 50, D, generator=g).to(dev)
    gz = torch.randn(64, H, generator=g).to(dev)
    gt = torch.randn(64, 2 * H, generator=g).to(dev)

    def grads(fn, hs, dtype=torch.float32):
        params = [p for h in hs for p in h.parameters()]
        x = xs.to(dtype).requires_grad_()
        z0, th = fn(*hs, x)
        return torch.autograd.grad((z0, th), [x] + params,
                                   (gz.to(dtype), gt.to(dtype)))

    k = grads(recurrent_cuda.goku_heads, heads)
    p = grads(recurrent_cuda.goku_heads_reference, heads)
    tol = ATOL
    if act is tnn.relu:
        with torch.no_grad():
            tape = recurrent_cuda.goku_heads_cuda(*heads, xs, tape=True)[2]
            tape_p = recurrent_cuda.goku_heads_taped_reference(*heads,
                                                               xs)[2]
        Hk = recurrent_cuda.kernel_widths(D, H)[1]
        on = tape[..., :2 * Hk] > 0
        on_p = torch.zeros_like(on)
        for l in range(2):
            on_p[..., l * Hk:l * Hk + H] = tape_p[..., l * H:(l + 1) * H] > 0
        if bool((on != on_p).any()):
            tol = 1e-2
    largest = max(float(b.abs().max()) for b in p)
    ref = None
    for i, (a, b) in enumerate(zip(k, p)):
        if rel_err(a, b) <= tol:
            continue
        assert float(b.abs().max()) < 1e-6 * largest, i
        if ref is None:
            ref = grads(recurrent_cuda.goku_heads_reference,
                        tuple(copy.deepcopy(h).double() for h in heads),
                        torch.float64)
        c = ref[i]
        e_kernel, e_plain = rel_err(a.double(), c), rel_err(b.double(), c)
        assert e_plain > tol, i
        assert e_kernel <= min(e_plain, 1e-4), (i, e_kernel, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [tnn.tanh, tnn.relu], ids=["tanh", "relu"])
@pytest.mark.parametrize("D,H", [(32, 16), (10, 8), (64, 32)])
def test_goku_heads_whole_backward_matches_autograd_on_card(dev, act, D, H):
    """The whole backward against plain autograd (heads_whole_backward_check)
    on inputs from a seeded generator, the same in every run."""
    heads_whole_backward_check(dev, act, D, H, seed=0)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,seed", [(10, 8, 74), (64, 32, 24)])
def test_goku_heads_whole_backward_on_float32_limited_draws_on_card(dev, D,
                                                                    H, seed):
    """Relu-RNN draws on which plain float32 autograd misses float64 by
    more than the tolerance on a vanishing gradient, the only draws of the
    sweep that take heads_whole_backward_check's float64 path
    (scripts/heads_bwd_sweep.py over seeds 0-99 on an NVIDIA H100):
    (10, 8) seed 74, an LSTM initial state's gradient of size 4.9e-12
    (largest 9.1), plain 3.8e-5 and the kernel 1.6e-5 from float64, no
    unit flipped; (64, 32) seed 24, both RNN initial states (1.2e-10 and
    5.1e-10, largest 42), a unit flipped, plain 2.0e-2 and 1.3e-2 and the
    kernel 7.5e-7 and 5.7e-7 from float64."""
    heads_whole_backward_check(dev, tnn.relu, D, H, seed=seed)


@pytest.mark.cuda
def test_goku_heads_refuses_heads_too_wide_for_a_block_on_card(dev):
    """Heads whose any-width kernels would need more shared memory than a
    block may have raise ValueError and launch nothing."""
    heads = heads_with(dev, tnn.relu, D=16384, H=16, L=1)
    xs = torch.zeros(2, 3, 16384, device=dev)
    before = recurrent_cuda.goku_heads_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        recurrent_cuda.goku_heads(*heads, xs)
    assert recurrent_cuda.goku_heads_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("substeps", [1, 3])
def test_rk_bwd_kernel_matches_plain_sweep_on_card(dev, solver, substeps):
    """The RK backward kernel against the plain reverse sweep over the same
    trajectory, and the whole backward against plain autograd, within
    1e-5 of each gradient's size, for both pendulum RHSs."""
    u0s, ps, saveat = rk_inputs(dev, B=70, T=40, seed=8)
    s = getattr(trk, solver)()
    for f in (pendulum_f, pendulum_friction_f):
        w = torch.randn(70, 40, 2, device=dev)
        with torch.no_grad():
            ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(
                f, s, u0s, ps, saveat, substeps=substeps)
        got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys, ps, w, substeps=substeps)
        ref = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w, substeps=substeps)
        u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
        y = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u, p, saveat, substeps=substeps)[0]
        auto = torch.autograd.grad(y, [u, p], w)
        for a, b, c in zip(got, ref, auto):
            assert rel_err(a, b) <= ATOL and rel_err(a, c) <= ATOL


RK_SHAPES = [(64, 50), (45, 100), (70, 40)]


def rk_cotangent(dev, B, T, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, T, 2, generator=g).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", RK_SHAPES)
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
def test_rk_baked_instance_equals_generic_on_card(dev, B, T, substeps,
                                                  solver):
    """Tsit5 and RK4 with their float32 coefficients compiled in give the
    same bits as the instance that reads the same tableau at run time,
    forward (ys, success) and backward (gradients and interval maps): the
    same operations in the same order on the same values."""
    u0s, ps, saveat = rk_inputs(dev, B, T, seed=20)
    s = getattr(trk, solver)()
    assert ode_cuda.tableau_instance(s) != 0
    for f in (pendulum_f, pendulum_friction_f):
        baked = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=substeps)
        generic = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=substeps, generic=True)
        w = rk_cotangent(dev, B, T, 21)
        baked += ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, baked[0], ps, w, substeps=substeps, maps=True)
        generic += ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, baked[0], ps, w, substeps=substeps, maps=True,
            generic=True)
        for a, b in zip(baked, generic):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", SOLVERS)
def test_rk_kernel_success_flags_on_card(dev, solver):
    """The forward kernel's success flag is isfinite(ys).all over each row,
    and the plain version's flag: rows 1 (a NaN angle), 3 (L = 0) and 5 (an
    infinite velocity) fail; row 6 (L = 1e-30) runs to huge but finite
    values through the accurate rerun."""
    u0s, ps, saveat = rk_inputs(dev, 8, 30, seed=22)
    u0s[1, 0] = float("nan")
    ps[3, 0] = 0.0
    u0s[5, 1] = float("inf")
    ps[6, 0] = 1e-30
    s = getattr(trk, solver)()
    for f in (pendulum_f, pendulum_friction_f):
        ys, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                        saveat)
        _, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat)
        assert ok.dtype == torch.bool and ok.shape == (8,)
        assert torch.equal(ok, torch.isfinite(ys).all(dim=2).all(dim=1))
        assert torch.equal(ok, ok_p)
        assert ok.tolist() == [True, False, True, False, True, False, True,
                               True]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", RK_SHAPES)
@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("solver", SOLVERS)
def test_rk_bwd_kernel_matches_two_phase_plain_on_card(dev, B, T, substeps,
                                                       solver):
    """The backward kernel's interval maps against the plain maps over the
    same trajectory, and its gradients against the two-phase plain version
    (plain maps, then the plain affine sweep), the plain step-by-step
    reverse sweep over the same trajectory and plain autograd, each within
    1e-5 of the tensor's size, for both pendulum RHSs; without the maps
    output the kernel gives the same bits."""
    u0s, ps, saveat = rk_inputs(dev, B, T, seed=23)
    s = getattr(trk, solver)()
    for f in (pendulum_f, pendulum_friction_f):
        w = rk_cotangent(dev, B, T, 24)
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=substeps)
        du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys, ps, w, substeps=substeps, maps=True)
        J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
            f, s, saveat, ys, ps, substeps=substeps)
        assert rel_err(J, J_p) <= ATOL and rel_err(r, r_p) <= ATOL
        two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(
            J_p, r_p, w)
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w, substeps=substeps)
        u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
        y = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u, p, saveat, substeps=substeps)[0]
        auto = torch.autograd.grad(y, [u, p], w)
        for a, b, c, d in zip((du0, dp), two, sweep, auto):
            assert rel_err(a, b) <= ATOL and rel_err(a, c) <= ATOL
            assert rel_err(a, d) <= ATOL
        plain_out = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys, ps, w, substeps=substeps)
        assert torch.equal(plain_out[0], du0)
        assert torch.equal(plain_out[1], dp)


@pytest.mark.cuda
def test_rk_kernels_on_a_grid_of_several_chunks_on_card(dev):
    """T = 1100: the forward computes its step sizes in two tables of 1024,
    the backward takes its 1099 intervals in five chunks of 256 threads,
    the last first. The backward against the plain maps and the two plain
    sweeps over the same trajectory (1e-5 of each tensor's size). Over 1099
    steps the kernel's and the plain float32 trajectories part by more than
    rounding (the phase drifts), so the forward is held as the neural-field
    forward is: at most twice as far from a float64 plain solve as the
    plain float32 solve is, plus 1e-6."""
    B, T = 16, 1100
    u0s, ps, saveat = rk_inputs(dev, B, T, seed=26)
    s = trk.Tsit5()
    for f in (pendulum_f, pendulum_friction_f):
        ys, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                        saveat)
        ref = ode_cuda.solve_fixed_grid_batched_reference(f, s, u0s, ps,
                                                          saveat)[0]
        ref64 = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s.double(), ps.double(), saveat.double())[0]
        e_k = float((ys.double() - ref64).abs().max())
        e_p = float((ref.double() - ref64).abs().max())
        assert bool(ok.all()) and e_k <= 2 * e_p + 1e-6
        w = rk_cotangent(dev, B, T, 27)
        du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys, ps, w, maps=True)
        J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
            f, s, saveat, ys, ps)
        assert rel_err(J, J_p) <= ATOL and rel_err(r, r_p) <= ATOL
        two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(
            J_p, r_p, w)
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w)
        for a, b, c in zip((du0, dp), two, sweep):
            assert rel_err(a, b) <= ATOL and rel_err(a, c) <= ATOL


# Angles past the branch-free sine's bound (|x| > 105615): from 2e5, where
# the fast path is still close, to 1e9, where its reduction is meaningless.
BIG_ANGLES = [2e5, -3e6, 4.5e7, 1e9, -2.5e8]


@pytest.mark.cuda
def test_rk_kernels_rerun_large_angles_accurately_on_card(dev):
    """Rows whose stage angles pass the bound rerun their steps with sinf,
    as the plain version computes every sine, while the other rows of the
    same warp stay on the fast path: the forward agrees with the plain
    version (each state component within 1e-5 of its size over the rows,
    the fast rows within 1e-5 abs) and the backward with the plain sweep
    over the same trajectory. The fast sine alone is far off at these
    angles, so a missing rerun would show."""
    B, T = 40, 30
    u0s, ps, saveat = rk_inputs(dev, B, T, seed=25)
    big = torch.arange(0, B, 8, device=dev)
    x = torch.tensor(BIG_ANGLES, device=dev)
    u0s[big, 0] = x
    fast, _ = ode_cuda.sincos_cuda(x)
    assert float((fast - torch.sin(x)).abs().max()) > 1e-3
    small = torch.ones(B, dtype=torch.bool, device=dev)
    small[big] = False
    for solver in ("Tsit5", "RK4", "Dopri5"):
        s = getattr(trk, solver)()
        for f in (pendulum_f, pendulum_friction_f):
            ys, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                            saveat)
            ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
                f, s, u0s, ps, saveat)
            assert bool(ok.all()) and bool(ok_p.all())
            assert float((ys[small] - ref[small]).abs().max()) <= ATOL
            for d in range(2):
                assert rel_err(ys[big, :, d], ref[big, :, d]) <= ATOL
            w = rk_cotangent(dev, B, T, 28)
            got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(f, s, saveat,
                                                             ys, ps, w)
            sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
                f, s, saveat, ys, ps, w)
            for a, b in zip(got, sweep):
                assert rel_err(a, b) <= ATOL


@pytest.mark.cuda
def test_rk_branch_free_sine_matches_sincosf_on_card(dev):
    """The kernels' branch-free sine and cosine against sincosf and against
    float64 over |x| <= 105615, the range in which the kernels use them: a
    uniform grid of 2^24 points, a dense grid on [-8, 8], and the floats
    nearest to each multiple of pi/2 in the range and their neighbours (the
    hardest arguments for the reduction). Within 2.4e-7 abs of float64
    (4 units in the last place of values in [0.5, 1)), as sincosf is."""
    k = torch.arange(-67237, 67238, dtype=torch.float64, device=dev)
    near = (k * (torch.pi / 2)).float()
    steps = torch.arange(-3, 4, device=dev, dtype=torch.int32)
    near = (near.view(torch.int32)[:, None] + steps).view(torch.float32)
    x = torch.cat([torch.linspace(-105615.0, 105615.0, 1 << 24, device=dev),
                   torch.linspace(-8.0, 8.0, 1 << 22, device=dev),
                   near.flatten()])
    x = x[x.abs() <= 105615.0]
    s, c = ode_cuda.sincos_cuda(x)
    s_acc, c_acc = ode_cuda.sincos_cuda(x, accurate=True)
    s64, c64 = torch.sin(x.double()), torch.cos(x.double())
    for got, ref in ((s, s64), (c, c64), (s_acc, s64), (c_acc, c64)):
        assert float((got.double() - ref).abs().max()) <= 2.4e-7


@pytest.mark.cuda
def test_rk_kuramoto_sine_copies_equal_the_library_on_card(dev):
    """The Kuramoto kernels' branch-free copies of the fast paths of sinf
    and sincosf equal torch.sin (the plain version's sine) and sincosf bit
    for bit below 105615, where the kernels use them: a uniform grid of
    2^24 points, a dense grid on [-8, 8], the floats nearest to each
    multiple of pi/2 and their neighbours, zeros, subnormals and NaN."""
    k = torch.arange(-67237, 67238, dtype=torch.float64, device=dev)
    near = (k * (torch.pi / 2)).float()
    steps = torch.arange(-3, 4, device=dev, dtype=torch.int32)
    near = (near.view(torch.int32)[:, None] + steps).view(torch.float32)
    x = torch.cat([torch.linspace(-105615.0, 105615.0, 1 << 24, device=dev),
                   torch.linspace(-8.0, 8.0, 1 << 22, device=dev),
                   near.flatten(),
                   torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1e-45,
                                 float("nan")], device=dev)])
    x = x[~(x.abs() >= 105615.0)]
    s_acc, c_acc = ode_cuda.sincos_cuda(x, accurate=True)
    s, c = ode_cuda.sincos_cuda(x, copy="sinf")
    s_sc, c_sc = ode_cuda.sincos_cuda(x, copy="sincosf")
    for got, ref in ((s, torch.sin(x)), (c, c_acc), (s_sc, s_acc),
                     (c_sc, c_acc)):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
def test_rk_library_refuses_a_tableau_not_its_baked_one_on_card(dev):
    """The C interface runs a baked instance only for exactly its
    coefficients: RK4's tableau under Tsit5's index is refused with
    cudaErrorInvalidValue (1), and nothing is written."""
    u0s, ps, saveat = rk_inputs(dev, 4, 5)
    n, a, b, c = trk.tableau_f32(trk.RK4())
    ys = torch.zeros(4, 5, 2, device=dev)
    ok = torch.zeros(4, dtype=torch.bool, device=dev)
    lib = ode_cuda._lib()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ldq_rk_fixed_grid(0, 1, n, a.data_ptr(), b.data_ptr(),
                                c.data_ptr(), saveat.data_ptr(),
                                u0s.data_ptr(), ps.data_ptr(), None,
                                ys.data_ptr(), ok.data_ptr(), 4, 5, 1,
                                stream)
    torch.cuda.synchronize()
    assert err == 1 and not bool(ys.any()) and not bool(ok.any())


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
                ode_cuda.solve_fixed_grid_batched_cuda,
                recurrent_cuda.goku_heads_bwd_cuda,
                ode_cuda.solve_fixed_grid_batched_bwd_cuda)
    before = [launches(fn) for fn in counters]
    with torch.no_grad():
        xk = km(x, t)[0][0]
        xp = pm(x, t)[0][0]
    assert [launches(fn) - n for fn, n in zip(counters, before)] == [1, 1, 0,
                                                                     0]
    km(x, t)[0][0].square().sum().backward()
    assert [launches(fn) - n for fn, n in zip(counters, before)] == [2, 2, 1,
                                                                     1]
    assert xk.shape == (6, 10, 24) and bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The RK kernels with the Van der Pol and Kuramoto functors.

CUSTOM_RHS = {
    "vdp": lambda: cdyn.vdp_f,
    "kuramoto4": lambda: cdyn.kuramoto_f(4),
    "kuramoto10": lambda: cdyn.kuramoto_f(10),
    "kuramoto10-spread": lambda: cdyn.Kuramoto(10, omega_spread=0.5).f,
}


def custom_inputs(dev, rhs, B, T, seed=0):
    """The examples' draws: VdP u0 ~ U(-2, 2), mu ~ U(0.5, 4); Kuramoto
    phases ~ U(-pi, pi), omega ~ U(1, 3), K ~ U(0.2, 2); dt 0.1."""
    g = torch.Generator().manual_seed(seed)
    if rhs == "vdp":
        u0s = torch.rand(B, 2, generator=g) * 4 - 2
        ps = 0.5 + 3.5 * torch.rand(B, 1, generator=g)
    else:
        n = 4 if rhs == "kuramoto4" else 10
        u0s = (torch.rand(B, n, generator=g) * 2 - 1) * torch.pi
        ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                          0.2 + 1.8 * torch.rand(B, generator=g)], dim=1)
    saveat = torch.arange(T, dtype=torch.float32) * 0.1
    w = torch.randn(B, T, u0s.shape[1], generator=g)
    return u0s.to(dev), ps.to(dev), saveat.to(dev), w.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (26, 100), (37, 21), (1, 21),
                                 (3, 21), (65, 21)])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("rhs", sorted(CUSTOM_RHS))
def test_rk_custom_rhs_kernel_matches_plain_on_card(dev, rhs, solver, B, T):
    """The forward kernel with the Van der Pol and Kuramoto functors against
    the plain version, 4 sub-steps (atol 1e-5; Kuramoto, whose kernels take
    a trajectory on a group of lanes, bit for bit, also on batches that
    leave a warp's last groups empty: 3 trajectories a warp at N 10, 8 at
    N 4); success flags as the plain flags; a baked tableau instance equals
    the run-time one bit for bit."""
    f = CUSTOM_RHS[rhs]()
    u0s, ps, saveat, _ = custom_inputs(dev, rhs, B, T, seed=30)
    s = getattr(trk, solver)()
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=4)
        assert float((got - ref).abs().max()) <= ATOL
        if rhs.startswith("kuramoto"):
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(ok, ok_p) and bool(ok.all())
        if ode_cuda.tableau_instance(s) != 0:
            gen = ode_cuda.solve_fixed_grid_batched_cuda(
                f, s, u0s, ps, saveat, substeps=4, generic=True)
            assert torch.equal(got.view(torch.int32),
                               gen[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (26, 100), (16, 300), (3, 21)])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("rhs", sorted(CUSTOM_RHS))
def test_rk_custom_rhs_bwd_kernel_matches_plain_on_card(dev, rhs, solver, B,
                                                        T):
    """The backward kernel with the new functors: its interval maps against
    the plain maps over the same trajectory, its gradients against the
    two-phase plain version, the plain reverse sweep and plain autograd,
    each within 1e-5 of the tensor's size. Kuramoto spreads a row's
    intervals over a cluster of blocks (2 at B 64, 5 at B 26, 7 at B 3, 8
    at B 16 on 132 SMs). T 300 (more dynamic shared memory than a launch
    gets by default for Kuramoto-10):
    1196 steps, over which the maps' products and the step-by-step sweep,
    two float32 orders of the same sums, part by more than 1e-5 (for
    Kuramoto, float32 interval maps, the kernel's and the plain ones alike,
    end farther from float64 than the step-by-step sweep); there the kernel
    is held to the two-phase plain version, its own order, and to a float64
    sweep over the same trajectory, at most twice as far from it as the
    two-phase plain version is."""
    f = CUSTOM_RHS[rhs]()
    u0s, ps, saveat, w = custom_inputs(dev, rhs, B, T, seed=31)
    s = getattr(trk, solver)()
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=4)
    du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, s, saveat, ys, ps, w, substeps=4, maps=True)
    J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, ys, ps, substeps=4)
    assert rel_err(J, J_p) <= ATOL and rel_err(r, r_p) <= ATOL
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J_p, r_p,
                                                                   w)
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, saveat, ys, ps, w, substeps=4)
    if T > 100:
        sweep64 = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat.double(), ys.double(), ps.double(), w.double(),
            substeps=4)
    for i, (a, b, c) in enumerate(zip((du0, dp), two, sweep)):
        assert rel_err(a, b) <= ATOL
        if T <= 100:
            assert rel_err(a, c) <= ATOL
        else:
            ref = sweep64[i]
            assert rel_err(a.double(), ref) <= 2 * rel_err(b.double(), ref)
    if T <= 100:
        u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
        y = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u, p, saveat, substeps=4)[0]
        for a, d in zip((du0, dp), torch.autograd.grad(y, [u, p], w)):
            assert rel_err(a, d) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("rhs", ["kuramoto4", "kuramoto10",
                                 "kuramoto10-spread"])
def test_rk_kuramoto_bwd_one_block_a_row_equals_clusters_on_card(dev, rhs,
                                                                 solver):
    """With more rows than the card has SMs the Kuramoto backward runs one
    block a row, its intervals in chunks, not a cluster of blocks a row;
    the per-interval arithmetic and the sweep's order are the same, so the
    maps and gradients of each row equal those of the same rows run alone
    (as clusters) bit for bit. The wide batch is also held to the plain
    maps and the two-phase plain version (1e-5 of each tensor's size)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, T = sms + 8, 100
    f = CUSTOM_RHS[rhs]()
    u0s, ps, saveat, w = custom_inputs(dev, rhs, B, T, seed=33)
    s = getattr(trk, solver)()
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=4)
    wide = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, s, saveat, ys, ps, w, substeps=4, maps=True)
    J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, ys, ps, substeps=4)
    assert rel_err(wide[2], J_p) <= ATOL and rel_err(wide[3], r_p) <= ATOL
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J_p, r_p,
                                                                   w)
    for a, b in zip(wide[:2], two):
        assert rel_err(a, b) <= ATOL
    for lo, hi in ((0, 26), (B - 3, B)):
        part = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys[lo:hi], ps[lo:hi], w[lo:hi], substeps=4,
            maps=True)
        for a, b in zip(wide, part):
            assert torch.equal(a[lo:hi].view(torch.int32),
                               b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3, 26])
@pytest.mark.parametrize("rhs", ["kuramoto4", "kuramoto10",
                                 "kuramoto10-spread"])
def test_rk_kuramoto_non_finite_rows_keep_plain_flags_on_card(dev, rhs, B):
    """Rows that start from a NaN or infinite phase, or carry a NaN
    coupling, fail as in the plain version, and only they: a group's flag
    is the AND over its lanes. The other rows equal the plain version bit
    for bit."""
    f = CUSTOM_RHS[rhs]()
    u0s, ps, saveat, _ = custom_inputs(dev, rhs, B, 21, seed=32)
    u0s[1, 0], u0s[2, -1] = float("nan"), float("inf")
    ps[B - 1, 1] = float("nan")
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, trk.Tsit5(), u0s, ps, saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, trk.Tsit5(), u0s, ps, saveat, substeps=4)
    assert torch.equal(ok, ok_p)
    assert torch.equal(ok, torch.isfinite(got).all(dim=2).all(dim=1))
    assert sorted((~ok).nonzero().flatten().tolist()) == sorted({1, 2, B - 1})
    assert torch.equal(got[ok].view(torch.int32), ref[ok].view(torch.int32))


@pytest.mark.cuda
def test_rk_kuramoto_width_not_compiled_raises_on_card(dev):
    """Kuramoto at a width without a compiled instance (7 oscillators) runs
    on the lane-group kernels built for it at first use: one launch each
    way, counted as ``kuramoto7``, the forward equal to the plain version
    bit for bit (as at 4 and 10), the gradients within 1e-5 of their size
    of the plain reverse sweep; a width past the lane groups' 31 runs on the
    block kernels built for it (``kuramoto32``) with the same checks."""
    f = cdyn.kuramoto_f(7)
    g = torch.Generator().manual_seed(33)
    u0s = ((torch.rand(9, 7, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(9, generator=g),
                      0.2 + 1.8 * torch.rand(9, generator=g)], 1).to(dev)
    saveat = torch.arange(21, dtype=torch.float32, device=dev) * 0.1
    w = torch.randn(9, 21, 7, generator=g).to(dev)
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    before = (fwd.get("kuramoto7", 0), bwd.get("kuramoto7", 0))
    u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    ys = ode_cuda.solve_fixed_grid_batched(f, trk.Tsit5(), u, p, saveat,
                                           substeps=4)[0]
    du0, dp = torch.autograd.grad(ys, [u, p], w)
    assert (fwd["kuramoto7"] - before[0], bwd["kuramoto7"] - before[1]) \
        == (1, 1)
    with torch.no_grad():
        ref = ode_cuda.solve_fixed_grid_batched_reference(
            f, trk.Tsit5(), u0s, ps, saveat, substeps=4)[0]
    assert torch.equal(ys.detach().view(torch.int32), ref.view(torch.int32))
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, trk.Tsit5(), saveat, ys.detach(), ps, w, substeps=4)
    assert rel_err(du0, sweep[0]) <= ATOL and rel_err(dp, sweep[1]) <= ATOL
    wide = cdyn.kuramoto_f(32)
    u0w = ((torch.rand(3, 32, generator=g) * 2 - 1) * torch.pi).to(dev)
    pw = ps[:3].clone().requires_grad_()
    uw = u0w.clone().requires_grad_()
    before = (fwd.get("kuramoto32", 0), bwd.get("kuramoto32", 0))
    ysw = ode_cuda.solve_fixed_grid_batched(wide, trk.Tsit5(), uw, pw, saveat,
                                            substeps=4)[0]
    wb = torch.randn(3, 21, 32, generator=g).to(dev)
    du0w, dpw = torch.autograd.grad(ysw, [uw, pw], wb)
    assert (fwd["kuramoto32"] - before[0], bwd["kuramoto32"] - before[1]) \
        == (1, 1)
    assert ode_cuda.rhs_kernel(wide, 32).backward == "block"
    with torch.no_grad():
        refw = ode_cuda.solve_fixed_grid_batched_reference(
            wide, trk.Tsit5(), u0w, ps[:3], saveat, substeps=4)[0]
    assert torch.equal(ysw.detach().view(torch.int32), refw.view(torch.int32))
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        wide, trk.Tsit5(), saveat, ysw.detach(), ps[:3], wb, substeps=4)
    assert rel_err(du0w, sweep[0]) <= ATOL and rel_err(dpw, sweep[1]) <= ATOL


# Fields without a hand-written functor: the RK kernels run them on a device
# functor generated from their trace (ops/rhs_codegen.py), one library each,
# built at first use (the fixture builds them all at once).
def pendulum_untagged(u, p, t):
    return pendulum_f(u, p, t)


def vdp_untagged(u, p, t):
    return cdyn.vdp_f(u, p, t)


def forced_oscillator(u, p, t):
    x, v = u[..., 0], u[..., 1]
    k, c, a = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([v, -k * x - c * v + a * torch.cos(2.0 * t)], dim=-1)


def lotka_volterra(u, p, t):
    x, y = u[..., 0], u[..., 1]
    a, b, c, d = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([a * x - b * x * y, d * x * y - c * y], dim=-1)


# name -> (field, pdim, substeps)
GEN_RHS = {"pendulum-untagged": (pendulum_untagged, 1, 1),
           "vdp-untagged": (vdp_untagged, 1, 4),
           "forced": (forced_oscillator, 3, 4),
           "lotka-volterra": (lotka_volterra, 4, 2)}


def lorenz96_40(u, p, t):
    return rhs_zoo.lorenz96(u, p, t)


# The zoo of tests/rhs_zoo.py (the ops the tracer lowers beyond elementwise
# arithmetic, writes through views, fields wide enough for the
# reverse-sweep backward rk_fixed_grid_sweep_bwd_kernel) and Lorenz-96 at
# its standard 40: name -> (field, dim, pdim, the zoo field its draws
# follow)
ZOO_RHS = {**{name: (f, dim, pdim, name)
              for name, (f, dim, pdim, _) in rhs_zoo.ZOO.items()},
           "lorenz96-40": (lorenz96_40, 40, 1, "lorenz96-12")}
# Kuramoto past the lane groups: the block kernels at 32 and 33 (one warp,
# and a second warp with one lane busy), 64 and 1100 (past the block's 512
# threads: a lane takes up to three oscillators); and a width on each side
# of each change in what the backward keeps in shared memory at 6 stages
# (Tsit5, Dopri5) and 4 sub-steps (ode_cuda.bwd_switches): the stages with
# the recompute spread to 227, without to 2,233, the sub-step starts to
# 4,840, nothing past that.
KURAMOTO_BLOCK_N = (32, 33, 64, 1100)
KURAMOTO_SWITCH_N = (227, 228, 2233, 2234, 4840, 4841)
# The block forward spreads a stage's sines over the block up to N 235 at 6
# stages (Tsit5, Dopri5) and 236 at RK4 (ode_cuda.fwd_switches): each side.
KURAMOTO_FWD_SWITCH_N = (235, 236, 237)
# A source built with the forwards before the sliced and the spread ones
# (the header's LDQ_RK_FWD_FLOATS at 1), whose plans then take the
# one-thread forward and the block forward's sines on the oscillators' own
# lanes; and Lorenz-96-40 built with LDQ_RK_FWD_FLOATS at the sliced
# forward's block at 6 stages (48 floats of tableau, 32 flags, a row of
# 481) and one float less: each side of its fit.
FWD_BEFORE = "#define LDQ_RK_FWD_FLOATS 1\n"
FWD_EDGE = {"fits": "#define LDQ_RK_FWD_FLOATS 561\n",
            "short": "#define LDQ_RK_FWD_FLOATS 560\n"}
# A source built to run the sliced forward for every sweep functor, also
# those whose stage inputs and slopes fit a thread's registers, for which
# the plan keeps the one-thread forward (the zoo's).
FWD_SLICED = "#define LDQ_RK_FWD_THREAD_FLOATS 0\n"
# the fields whose forward is held against its design before
SLICED_FWD = ("lorenz96-12", "lorenz96-40", "linear5", "mlp")
# The sliced sweep kernel against the one-thread sweep kernel it replaces:
# Lorenz-96-40's functor built with every row past the sliced kernel's
# shared memory (LDQ_RK_SWEEP_ROW_FLOATS 1), so that its backward runs
# rk_fixed_grid_sweep_bwd_thread_kernel at every tableau.
THREAD_SWEEP_LEVER = "#define LDQ_RK_SWEEP_ROW_FLOATS 1\n"


def thread_sweep_library():
    """(library name, typed library) of Lorenz-96-40 on the one-thread
    sweep kernel (THREAD_SWEEP_LEVER), registered and loaded."""
    from latentdiffeq_torch.ops import _build, rhs_codegen, rhs_trace
    prog = rhs_trace.trace_field(lorenz96_40, 40, 1)
    name = _build.register_generated(
        "rk_gen", THREAD_SWEEP_LEVER + rhs_codegen.kernel_source(prog))
    return name, ode_cuda.typed_library(_build.load_kernel(name))


def prefixed_library(prefix, name, n=None):
    """The registered library of ZOO_RHS field ``name`` (or, with ``n``,
    Kuramoto at n oscillators) built from its instance source with
    ``prefix`` before it."""
    from latentdiffeq_torch.ops import _build, rhs_trace
    if n is not None:
        return _build.register_generated(
            "rk_kuramoto", prefix + rhs_codegen.kuramoto_source(n))
    f, dim, pdim, _ = ZOO_RHS[name]
    return _build.register_generated("rk_gen", prefix + rhs_codegen
                                     .kernel_source(rhs_trace.trace_field(
                                         f, dim, pdim)))


def forward_of(library, f, s, u0s, ps, saveat, sub):
    """(ys, success, plan) from the forward entry point of ``library`` (a
    build of ``f``'s instance source), launched as
    solve_fixed_grid_batched_cuda launches its instance's; the plan
    (ldq_rk_fwd_plan: design, threads, rows, bytes) it launched by."""
    from latentdiffeq_torch.ops import _build
    B, dim = u0s.shape
    rk = ode_cuda.rhs_kernel(f, dim, ps.shape[1])
    lib = ode_cuda.typed_library(_build.load_kernel(library))
    n, a, b, c = trk.tableau_f32(s)
    cst = (f.rhs_consts(u0s.device, torch.float32).contiguous()
           if rk.ncst else None)
    ys = torch.empty(B, saveat.shape[0], dim, device=u0s.device)
    ok = torch.empty(B, dtype=torch.bool, device=u0s.device)
    err = lib.ldq_rk_fixed_grid(
        0, ode_cuda.tableau_instance(s), n, a.data_ptr(), b.data_ptr(),
        c.data_ptr(), saveat.data_ptr(), u0s.data_ptr(), ps.data_ptr(),
        None if cst is None else cst.data_ptr(), ys.data_ptr(),
        ok.data_ptr(), B, saveat.shape[0], sub,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    out = (ctypes.c_int * 4)()
    assert lib.ldq_rk_fwd_plan(n, B, out) == 0
    return ys, ok, ode_cuda.FWD_DESIGN[out[0]]


@pytest.fixture(scope="module")
def gen_built():
    """Every generated instance of these tests and the Kuramoto ones, the
    one-thread sweep library and the builds on the forwards before (and at
    the sliced forward's fit), built in parallel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    from latentdiffeq_torch.ops import _build, rhs_codegen, rhs_trace
    prog = rhs_trace.trace_field(lorenz96_40, 40, 1)
    lever = _build.register_generated(
        "rk_gen", THREAD_SWEEP_LEVER + rhs_codegen.kernel_source(prog))
    specs = ([(f, 2, pdim) for f, pdim, _ in GEN_RHS.values()]
             + [(f, dim, pdim) for f, dim, pdim, _ in ZOO_RHS.values()]
             + [(cdyn.kuramoto_f(n), n, 2)
                for n in ((7,) + KURAMOTO_BLOCK_N + KURAMOTO_SWITCH_N
                          + KURAMOTO_FWD_SWITCH_N)])
    extra = ([lever]
             + [prefixed_library(FWD_BEFORE, name) for name in SLICED_FWD]
             + [prefixed_library(FWD_SLICED, name) for name in SLICED_FWD
                if name != "lorenz96-40"]
             + [prefixed_library(FWD_BEFORE, None, n)
                for n in KURAMOTO_BLOCK_N[:3]]
             + [prefixed_library(p, "lorenz96-40") for p in FWD_EDGE.values()])
    _build.build_kernels(list(dict.fromkeys(
        list(_build.KERNEL_SOURCES)
        + [ode_cuda.rhs_kernel(*spec).library for spec in specs] + extra)))


def expected_plan(route, dim, solver, substeps):
    """(keep, spread) the header's plans choose on the H100 (227 KB a
    block), from ode_cuda's mirror of its formulas."""
    return ode_cuda.bwd_keep(route, dim, trk.n_solution_stages(
        solver.tableau), substeps, ode_cuda.SMEM_OPTIN)


def gen_inputs(dev, name, B, T, seed):
    """(f, dim, pdim, substeps, u0s, ps, saveat, w). GEN_RHS: states ~
    U(-1, 1) (Lotka-Volterra's populations ~ U(0.5, 1.5)), parameters ~
    U(0.5, 2), dt 0.05, its substeps; the zoo: rhs_zoo.draws (Lorenz-96 at
    40: states ~ U(-2, 2)), dt 0.05, 2 sub-steps."""
    if name in ZOO_RHS:
        f, dim, pdim, like = ZOO_RHS[name]
        u0s, ps = (torch.from_numpy(x) for x in rhs_zoo.draws(like, B, seed))
        if dim != u0s.shape[1]:  # Lorenz-96 at 40: the draws of 12, widened
            u0s = torch.rand(B, dim,
                             generator=torch.Generator().manual_seed(seed)) \
                * 4 - 2
        g = torch.Generator().manual_seed(seed + 1)
        sub = 2
    else:
        g = torch.Generator().manual_seed(seed)
        f, pdim, sub = GEN_RHS[name]
        dim = 2
        u0s = torch.rand(B, 2, generator=g) * 2 - 1
        if name == "lotka-volterra":
            u0s = u0s * 0.5 + 1.0
        ps = 0.5 + 1.5 * torch.rand(B, pdim, generator=g)
    saveat = torch.arange(T, dtype=torch.float32) * 0.05
    w = torch.randn(B, T, dim, generator=g)
    return (f, dim, pdim, sub, u0s.to(dev), ps.to(dev), saveat.to(dev),
            w.to(dev))


def forward_exact(prog):
    """Whether the forward's program fixes every order its plain version
    on the card fixes: no reduction past rhs_trace.EXACT_TERMS terms and no
    matrix product among the instructions the slope needs."""
    nodes = {i.node for i in prog.needed(prog.dy)}
    return not any(n.split(":")[0] in nodes for n in prog.inexact)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (45, 100), (37, 21)])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("name", sorted(GEN_RHS) + sorted(ZOO_RHS))
def test_rk_generated_functor_matches_plain_on_card(dev, gen_built, name,
                                                    solver, B, T):
    """The forward kernel on a generated functor against the plain version,
    launched and counted under its gen_<hash8> instance: within atol 1e-5,
    and bit for bit where the plain version fixes the order (each op
    printed as PyTorch's CUDA kernel computes it: the selects with their
    NaN rule, sigmoid, softplus, erf, gelu, expm1, log1p, sinh, cosh,
    atan2, rolls, flips, extrema, sums of two terms, a mean as the sum
    times the count's reciprocal, writes through views); a zoo field whose
    long sums and matrix products take another order than cuBLAS and the
    reduction kernels within atol 1e-5 or else at most twice as far from a
    float64 plain solve as the plain float32 solve (+1e-6); the success
    flags as the plain flags; a baked tableau instance equal to the
    run-time one bit for bit."""
    f, dim, pdim, sub, u0s, ps, saveat, _ = gen_inputs(dev, name, B, T,
                                                        seed=40)
    rk = ode_cuda.rhs_kernel(f, dim, pdim)
    assert rk.name.startswith("gen_")
    s = getattr(trk, solver)()
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    before = fwd.get(rk.name, 0)
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=sub)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=sub)
    assert fwd[rk.name] == before + 1
    assert torch.equal(ok, ok_p) and bool(ok.all())
    if forward_exact(rk.program):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    elif float((got - ref).abs().max()) > ATOL:
        assert name in ZOO_RHS
        with torch.no_grad():
            ref64 = ode_cuda.solve_fixed_grid_batched_reference(
                f, s, u0s.double(), ps.double(), saveat.double(),
                substeps=sub)[0]
        e_k = float((got.double() - ref64).abs().max())
        e_p = float((ref.double() - ref64).abs().max())
        assert e_k <= 2 * e_p + 1e-6
    if ode_cuda.tableau_instance(s) != 0:
        gen = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=sub, generic=True)
        assert torch.equal(got.view(torch.int32), gen[0].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (45, 100), (3, 21)])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("name", sorted(GEN_RHS) + sorted(ZOO_RHS))
def test_rk_generated_functor_bwd_matches_plain_on_card(dev, gen_built,
                                                        name, solver, B, T):
    """The backward kernel on a generated functor (its VJP traced from
    torch.func.vjp of the field), Tsit5 and RK4 baked and Dopri5 on the
    run-time tableau. A field whose interval maps fit MAX_MAP_FLOATS runs
    the two-phase kernel: the interval maps against the plain maps on the
    same trajectory and the gradients against the two-phase plain version,
    its own order, within 1e-5 of each tensor's size; against the plain
    reverse sweep and plain autograd, other float32 orders, within 1e-5 or
    else at most twice as far from a float64 referee as the two-phase plain
    version (the reverse sweep in float64 on the same trajectory; autograd
    through the float64 plain solve): the interval maps' float32 order can
    stand farther from float64 than the reverse sweep's (PERF.md, open
    questions). A wider field runs rk_fixed_grid_sweep_bwd_kernel, one
    launch of its slices' warps (more than one), keeping every sub-step's
    stage inputs, held to its plain version, the plain reverse sweep over
    the same trajectory, within 1e-5 of each gradient's size, and forms no
    maps."""
    f, dim, pdim, sub, u0s, ps, saveat, w = gen_inputs(dev, name, B, T,
                                                       seed=41)
    rk = ode_cuda.rhs_kernel(f, dim, pdim)
    s = getattr(trk, solver)()
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=sub)
    if rk.backward == "sweep":
        plan = ode_cuda.bwd_plan(f, s, dim, B, sub, pdim)
        slices = rhs_codegen.plan_slices(rk.program).count
        assert slices > 1 and plan["threads"] == 32 * slices
        assert (plan["keep"], False) == expected_plan("sweep", dim, s, sub)
        bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
        before = bwd.get(rk.name, 0)
        got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, ys, ps, w, substeps=sub)
        assert bwd[rk.name] == before + 1
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w, substeps=sub)
        for a, b in zip(got, sweep):
            assert rel_err(a, b) <= ATOL
        with pytest.raises(ValueError, match="no interval maps"):
            ode_cuda.solve_fixed_grid_batched_bwd_cuda(
                f, s, saveat, ys, ps, w, substeps=sub, maps=True)
        return
    du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, s, saveat, ys, ps, w, substeps=sub, maps=True)
    J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, ys, ps, substeps=sub)
    assert rel_err(J, J_p) <= ATOL and rel_err(r, r_p) <= ATOL
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J_p, r_p,
                                                                   w)
    for a, b in zip((du0, dp), two):
        assert rel_err(a, b) <= ATOL
    sweep_gate(f, s, sub, u0s, ps, saveat, ys, w, (du0, dp), two)


def sweep_gate(f, s, sub, u0s, ps, saveat, ys, w, got, two):
    """The backward kernel's gradients ``got`` against the plain reverse
    sweep over ``ys`` and plain autograd, other float32 orders: within
    1e-5 of each size, or else, as the long grids are held, at most twice
    as far from that version in float64 as ``two``, the two-phase plain
    version (the kernel's own algorithm: interval maps, then the affine
    sweep), is."""
    def auto(dtype):
        u = u0s.to(dtype).requires_grad_()
        p = ps.to(dtype).requires_grad_()
        y = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u, p, saveat.to(dtype), substeps=sub)[0]
        return torch.autograd.grad(y, [u, p], w.to(dtype))

    def sweep(dtype):
        return ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat.to(dtype), ys.to(dtype), ps.to(dtype), w.to(dtype),
            substeps=sub)

    for version in (sweep, auto):
        plain = version(torch.float32)
        if max(rel_err(a, b) for a, b in zip(got, plain)) > ATOL:
            ref = version(torch.float64)
            for a, b, c in zip(got, two, ref):
                assert rel_err(a.double(), c) <= 2 * rel_err(b.double(), c)


def thread_sweep_bwd(lib, s, saveat, ys, ps, g, substeps):
    """The one-thread sweep kernel's (du0, dp) from THREAD_SWEEP_LEVER's
    library, launched as solve_fixed_grid_batched_bwd_cuda launches its
    instance's."""
    from latentdiffeq_torch.solve.rk import tableau_f32
    n, a, b, c = tableau_f32(s)
    B, T, D = ys.shape
    du0 = torch.empty(B, D, device=ys.device)
    dp = torch.empty(B, ps.shape[1], device=ys.device)
    err = lib.ldq_rk_fixed_grid_bwd(
        0, ode_cuda.tableau_instance(s), n, a.data_ptr(), b.data_ptr(),
        c.data_ptr(), saveat.data_ptr(), ys.data_ptr(), ps.data_ptr(), None,
        g.data_ptr(), du0.data_ptr(), dp.data_ptr(), None, None, B, T,
        substeps, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return du0, dp


def sweep_switch_cases():
    """(solver, sub-steps): 4 under every tableau, and at Tsit5 and RK4 each
    side of each change in what a Lorenz-96-40 row keeps (the last count
    that keeps the stages, the starts, and the next)."""
    cases = [(name, 4) for name in ("Tsit5", "RK4", "Dopri5")]
    for name, stages in (("Tsit5", 6), ("RK4", 4)):
        for last, *_ in ode_cuda.bwd_switches("sweep", 40, stages, 4)[:2]:
            cases += [(name, last), (name, last + 1)]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("solver,sub", sweep_switch_cases())
def test_rk_generated_functor_sweep_keeps_what_fits_on_card(dev, gen_built,
                                                            solver, sub):
    """Lorenz-96-40's sliced sweep (16 warps a row) keeps every stage
    input, else the sub-step starts, else nothing, as its plan says and
    ode_cuda's mirror of the header's formulas predicts, on each side of
    each change (sweep_switch_cases); whatever it keeps, its gradients
    equal the one-thread sweep kernel's (the design before, built with
    THREAD_SWEEP_LEVER, whose plan says so) bit for bit: the same
    operations in the same order, only spread over warps. At 4 sub-steps
    also the plain reverse sweep within 1e-5 of each gradient's size. B 5,
    2 save points."""
    f, dim, pdim, _, u0s, ps, saveat, w = gen_inputs(dev, "lorenz96-40", 5,
                                                     2, seed=43)
    s = getattr(trk, solver)()
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=sub)
    plan = ode_cuda.bwd_plan(f, s, dim, 5, sub, pdim)
    assert (plan["keep"], False) == expected_plan("sweep", dim, s, sub)
    assert plan["threads"] == 32 * rhs_codegen.plan_slices(
        ode_cuda.rhs_kernel(f, dim, pdim).program).count
    got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(f, s, saveat, ys, ps, w,
                                                     substeps=sub)
    name, lib = thread_sweep_library()
    out = (ctypes.c_int * 5)()
    assert lib.ldq_rk_bwd_plan(trk.n_solution_stages(s.tableau), 5, sub,
                               out) == 0 and out[0] == -1
    ref = thread_sweep_bwd(lib, s, saveat, ys, ps, w, sub)
    for a, b in zip(got, ref):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if sub == 4:
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w, substeps=sub)
        for a, b in zip(got, sweep):
            assert rel_err(a, b) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 26, 37, 300])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("name", SLICED_FWD)
def test_rk_sliced_forward_equals_one_thread_forward_on_card(dev, gen_built,
                                                            name, solver, B):
    """rk_fixed_grid_sliced_kernel (a warp a slice, the rows spread over
    the SMs: one a block up to 132 rows, three at B 300, the warp's other
    lanes repeating a block's first row and storing nothing) against
    rk_fixed_grid_kernel, the one-thread forward it replaces (the source
    built with FWD_BEFORE), on the same inputs: states and success flags
    bit for bit. The sliced kernel is the instance's own where its plan
    takes it (Lorenz-96-40: its stage inputs and slopes pass a thread's
    registers), else the source built with FWD_SLICED (the zoo's sweep
    functors, whose plan keeps the one-thread forward, as ode_cuda's mirror
    of the header's formulas predicts). T 21, the field's sub-steps."""
    f, dim, pdim, sub, u0s, ps, saveat, _ = gen_inputs(dev, name, B, 21,
                                                       seed=44)
    s = getattr(trk, solver)()
    n_st = trk.n_solution_stages(s.tableau)
    plan = ode_cuda.fwd_plan(f, s, dim, B, pdim)
    assert plan["design"] == ode_cuda.fwd_design("sweep", dim, n_st)
    own = plan["design"] == "sliced"
    assert own == (name == "lorenz96-40")
    if own:
        slices = rhs_codegen.plan_slices(
            ode_cuda.rhs_kernel(f, dim, pdim).program).count
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert (plan["threads"], plan["rows"]) == (32 * slices,
                                                   min(32, -(-B // sms)))
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=sub)
        ref, ok_r, design = forward_of(prefixed_library(FWD_BEFORE, name), f,
                                       s, u0s, ps, saveat, sub)
        sliced = (ode_cuda.rhs_kernel(f, dim, pdim).library if own
                  else prefixed_library(FWD_SLICED, name))
        ys_s, ok_s, design_s = forward_of(sliced, f, s, u0s, ps, saveat, sub)
    assert design == "one-thread" and design_s == "sliced"
    for ys, flags in ((got, ok), (ys_s, ok_s)):
        assert torch.equal(ys.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(flags, ok_r)
    assert bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("edge", sorted(FWD_EDGE))
def test_rk_sliced_forward_fit_is_chosen_by_size_on_card(dev, gen_built,
                                                        edge, solver):
    """Lorenz-96-40 built with LDQ_RK_FWD_FLOATS at the sliced forward's
    block at 6 stages and one float less: at Tsit5 the first takes the
    sliced forward and the second the one-thread one, at RK4 (a smaller
    block) both the sliced, each plan as ode_cuda.fwd_floats says; every
    build's states and flags equal the library's own forward bit for bit.
    A row with a NaN and a row with an infinity fail, and only they, in
    blocks of one row and (B 300) of three."""
    B = 300 if edge == "fits" else 37
    f, dim, pdim, sub, u0s, ps, saveat, _ = gen_inputs(dev, "lorenz96-40",
                                                       B, 11, seed=45)
    u0s[1, 3], u0s[30, 0] = float("nan"), float("inf")
    s = getattr(trk, solver)()
    n_st = trk.n_solution_stages(s.tableau)
    fits = ode_cuda.fwd_floats("sliced", dim, n_st) <= int(
        FWD_EDGE[edge].split()[-1])
    assert fits == (edge == "fits" or solver == "RK4")
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=sub)
        ref, ok_r, design = forward_of(
            prefixed_library(FWD_EDGE[edge], "lorenz96-40"), f, s, u0s, ps,
            saveat, sub)
    assert design == ("sliced" if fits else "one-thread")
    assert sorted((~ok).nonzero().flatten().tolist()) == [1, 30]
    assert torch.equal(ok, ok_r)
    assert torch.equal(got[ok].view(torch.int32), ref[ok].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(64, 50), (26, 100), (37, 21), (3, 21)])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
def test_rk_kuramoto7_lane_groups_match_plain_on_card(dev, gen_built, solver,
                                                      B, T):
    """Kuramoto-7, the lane-group kernels built for 7 oscillators (4
    groups a warp, lanes 28-31 idle), with frequency offsets, 4 sub-steps:
    the forward equal to the plain version bit for bit and with its flags
    (as at 4 and 10), a baked tableau instance equal to the run-time one;
    the backward's interval maps and gradients as the generated functors'
    are held (two-phase plain within 1e-5; reverse sweep and autograd
    within 1e-5 or through float64)."""
    f = cdyn.Kuramoto(7, omega_spread=0.5).f
    g = torch.Generator().manual_seed(42)
    u0s = ((torch.rand(B, 7, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.1
    w = torch.randn(B, T, 7, generator=g).to(dev)
    s = getattr(trk, solver)()
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                         saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=4)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(ok, ok_p) and bool(ok.all())
    if ode_cuda.tableau_instance(s) != 0:
        gen = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=4, generic=True)
        assert torch.equal(got.view(torch.int32), gen[0].view(torch.int32))
    if solver == "Dopri5":
        return
    du0, dp, J, r = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, s, saveat, got, ps, w, substeps=4, maps=True)
    J_p, r_p = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, saveat, got, ps, substeps=4)
    assert rel_err(J, J_p) <= ATOL and rel_err(r, r_p) <= ATOL
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J_p, r_p,
                                                                   w)
    for a, b in zip((du0, dp), two):
        assert rel_err(a, b) <= ATOL
    sweep_gate(f, s, 4, u0s, ps, saveat, got, w, (du0, dp), two)


@pytest.mark.cuda
def test_goku_user_field_kernel_path_on_card(dev, gen_built):
    """A small GOKU on the forced oscillator (no device_rhs tag, reads t)
    with both kernel switches on: the generated instance launches once per
    forward and backward, the plain solve never runs, and the output agrees
    with the same weights run plainly (1e-4)."""
    opts = SolveOptions(adaptive=False, substeps=4)
    diffeq = ODEDynamics(f=forced_oscillator, z_dim=2, theta_dim=3,
                         solver=trk.Tsit5(), options=opts)
    layers = goku_default_layers(24, diffeq, hidden_dim_resnet=16,
                                 latent_to_diffeq_dim=16, device=dev)
    km = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    pm = LatentDiffEqModel.build(GOKUBasic(), *layers)
    x = torch.rand(6, 10, 24, device=dev)
    t = torch.arange(10, dtype=torch.float32, device=dev) * 0.1
    inst = ode_cuda.rhs_instance(forced_oscillator, 2, 3)
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    before = (fwd.get(inst, 0), bwd.get(inst, 0))
    calls = ode_cuda.solve_fixed_grid_batched_reference.calls
    with torch.no_grad():
        xk = km(x, t)[0][0]
    km(x, t)[0][0].square().sum().backward()
    assert (fwd[inst] - before[0], bwd[inst] - before[1]) == (2, 1)
    assert ode_cuda.solve_fixed_grid_batched_reference.calls == calls
    with torch.no_grad():
        xp = pm(x, t)[0][0]
    assert bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [1, 4])
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("n", KURAMOTO_BLOCK_N + KURAMOTO_SWITCH_N)
def test_rk_kuramoto_block_kernels_match_plain_on_card(dev, gen_built, n,
                                                       solver, sub):
    """Kuramoto at N >= 32 with frequency offsets, 1 and 4 sub-steps, B 26
    / T 21 (B 2 / T 4 past 512): rk_kuramoto_block_kernel equal to the
    plain version bit for bit with its flags, a baked tableau instance
    equal to the run-time one; rk_kuramoto_block_bwd_kernel keeping in
    shared memory what its plan says and ode_cuda's mirror of the header's
    formulas predicts (KURAMOTO_SWITCH_N: each side of each change), within
    1e-5 of each gradient's size of the plain reverse sweep over the same
    trajectory, its plain version (the baked tableaus and the run-time
    one), and no maps."""
    f = cdyn.Kuramoto(n, omega_spread=0.5).f
    B, T = (2, 4) if n > 512 else (26, 21)
    g = torch.Generator().manual_seed(60 + n)
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.1
    w = torch.randn(B, T, n, generator=g).to(dev)
    s = getattr(trk, solver)()
    assert ode_cuda.rhs_kernel(f, n).backward == "block"
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                         saveat, substeps=sub)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=sub)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(ok, ok_p) and bool(ok.all())
    if ode_cuda.tableau_instance(s) != 0:
        gen = ode_cuda.solve_fixed_grid_batched_cuda(
            f, s, u0s, ps, saveat, substeps=sub, generic=True)
        assert torch.equal(got.view(torch.int32), gen[0].view(torch.int32))
    plan = ode_cuda.bwd_plan(f, s, n, B, sub)
    assert (plan["keep"], plan["spread"]) == expected_plan("block", n, s, sub)
    du0, dp = ode_cuda.solve_fixed_grid_batched_bwd_cuda(
        f, s, saveat, got, ps, w, substeps=sub)
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, saveat, got, ps, w, substeps=sub)
    assert rel_err(du0, sweep[0]) <= ATOL and rel_err(dp, sweep[1]) <= ATOL
    with pytest.raises(ValueError, match="no interval maps"):
        ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            f, s, saveat, got, ps, w, substeps=sub, maps=True)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("n", KURAMOTO_BLOCK_N[:3] + KURAMOTO_FWD_SWITCH_N)
def test_rk_kuramoto_block_spread_forward_matches_plain_on_card(
        dev, gen_built, n, solver):
    """The block forward with a stage's sines spread over the block, where
    its plan takes it (N 32, 33, 64; 235 at every tableau and 236 at RK4),
    and with them on the oscillators' lanes past that (236 at 6 stages,
    237), as ode_cuda's mirror of the header's formulas predicts: equal to
    the plain version bit for bit with its flags, B 26, T 21, 4 sub-steps,
    frequency offsets; at 32, 33, 64 also to the design before (the same
    source built with FWD_BEFORE, whose plan keeps the sines on the
    oscillators' lanes) bit for bit, states and flags."""
    f = cdyn.Kuramoto(n, omega_spread=0.5).f
    B, T = 26, 21
    g = torch.Generator().manual_seed(80 + n)
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.1
    s = getattr(trk, solver)()
    n_st = trk.n_solution_stages(s.tableau)
    plan = ode_cuda.fwd_plan(f, s, n, B)
    assert plan["design"] == ode_cuda.fwd_design("block", n, n_st)
    assert plan["design"] == ("spread" if n <= 235 or (n == 236 and
                                                       solver == "RK4")
                              else "block")
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                         saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=4)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(ok, ok_p) and bool(ok.all())
    if n in KURAMOTO_BLOCK_N:
        with torch.no_grad():
            old, ok_o, design = forward_of(
                prefixed_library(FWD_BEFORE, None, n), f, s, u0s, ps, saveat,
                4)
        assert design == "block"
        assert torch.equal(got.view(torch.int32), old.view(torch.int32))
        assert torch.equal(ok, ok_o)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["Tsit5", "RK4", "Dopri5"])
@pytest.mark.parametrize("n", [33, 64])
def test_rk_kuramoto_block_spread_non_finite_rows_on_card(dev, gen_built, n,
                                                         solver):
    """The spread block forward on rows that start from a NaN or infinite
    phase, or carry a NaN coupling: the plain version's flags and the
    design before's, and only those rows fail; the others equal both bit for
    bit."""
    f = cdyn.kuramoto_f(n)
    g = torch.Generator().manual_seed(71)
    B = 5
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    u0s[1, 0], u0s[2, -1] = float("nan"), float("inf")
    ps[B - 1, 1] = float("nan")
    saveat = torch.arange(11, dtype=torch.float32, device=dev) * 0.1
    s = getattr(trk, solver)()
    assert ode_cuda.fwd_plan(f, s, n, B)["design"] == "spread"
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps,
                                                         saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, s, u0s, ps, saveat, substeps=4)
        old, ok_o, _ = forward_of(prefixed_library(FWD_BEFORE, None, n), f,
                                  s, u0s, ps, saveat, 4)
    assert torch.equal(ok, ok_p) and torch.equal(ok, ok_o)
    assert sorted((~ok).nonzero().flatten().tolist()) == [1, 2, B - 1]
    for other in (ref, old):
        assert torch.equal(got[ok].view(torch.int32),
                           other[ok].view(torch.int32))


@pytest.mark.cuda
def test_rk_kuramoto_block_bwd_long_grid_on_card(dev, gen_built):
    """The block backward over a long grid, Kuramoto-64, B 16, T 300, RK4,
    4 sub-steps (scripts/rk_bwd_sweep.py's case): within 1e-5 of each
    gradient's size of the plain reverse sweep, its plain version, or else
    at most twice as far from the float64 reverse sweep on the same
    trajectory as the plain float32 sweep is (the long grids' gate)."""
    n, B, T = 64, 16, 300
    f = cdyn.kuramoto_f(n)
    s = trk.RK4()
    g = torch.Generator().manual_seed(60 + n)
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.1
    w = torch.randn(B, T, n, generator=g).to(dev)
    with torch.no_grad():
        ys, _ = ode_cuda.solve_fixed_grid_batched_cuda(f, s, u0s, ps, saveat,
                                                       substeps=4)
    got = ode_cuda.solve_fixed_grid_batched_bwd_cuda(f, s, saveat, ys, ps, w,
                                                     substeps=4)
    plain = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, saveat, ys, ps, w, substeps=4)
    if max(rel_err(a, b) for a, b in zip(got, plain)) > ATOL:
        ref = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat.double(), ys.double(), ps.double(), w.double(),
            substeps=4)
        for a, b, c in zip(got, plain, ref):
            assert rel_err(a.double(), c) <= 2 * rel_err(b.double(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64])
def test_rk_kuramoto_block_non_finite_rows_keep_plain_flags_on_card(
        dev, gen_built, n):
    """Rows that start from a NaN or infinite phase, or carry a NaN
    coupling, fail as in the plain version, and only they (a block's AND
    over its oscillators); the other rows equal the plain version bit for
    bit."""
    f = cdyn.kuramoto_f(n)
    g = torch.Generator().manual_seed(70)
    B = 5
    u0s = ((torch.rand(B, n, generator=g) * 2 - 1) * torch.pi).to(dev)
    ps = torch.stack([1 + 2 * torch.rand(B, generator=g),
                      0.2 + 1.8 * torch.rand(B, generator=g)], 1).to(dev)
    u0s[1, 0], u0s[2, -1] = float("nan"), float("inf")
    ps[B - 1, 1] = float("nan")
    saveat = torch.arange(11, dtype=torch.float32, device=dev) * 0.1
    with torch.no_grad():
        got, ok = ode_cuda.solve_fixed_grid_batched_cuda(
            f, trk.Tsit5(), u0s, ps, saveat, substeps=4)
        ref, ok_p, _ = ode_cuda.solve_fixed_grid_batched_reference(
            f, trk.Tsit5(), u0s, ps, saveat, substeps=4)
    assert torch.equal(ok, ok_p)
    assert sorted((~ok).nonzero().flatten().tolist()) == [1, 2, B - 1]
    assert torch.equal(got[ok].view(torch.int32), ref[ok].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["vdp", "kuramoto10"])
def test_goku_custom_kernel_path_matches_plain_path_on_card(dev, which):
    """A small GOKU on Van der Pol or Kuramoto-10 with both kernel switches
    on launches the RK kernels' instance for that RHS once per forward and
    backward, and agrees with the same weights run plainly (1e-4)."""
    opts = SolveOptions(adaptive=False, substeps=4)
    diffeq = (cdyn.VanDerPol(options=opts) if which == "vdp"
              else cdyn.Kuramoto(10, options=opts))
    layers = goku_default_layers(24, diffeq, hidden_dim_resnet=16,
                                 latent_to_diffeq_dim=16, device=dev)
    km = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    pm = LatentDiffEqModel.build(GOKUBasic(), *layers)
    x = torch.rand(6, 10, 24, device=dev)
    t = torch.arange(10, dtype=torch.float32, device=dev) * 0.1
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    before = (fwd.get(which, 0), bwd.get(which, 0))
    with torch.no_grad():
        xk = km(x, t)[0][0]
        xp = pm(x, t)[0][0]
    km(x, t)[0][0].square().sum().backward()
    assert (fwd[which] - before[0], bwd[which] - before[1]) == (2, 1)
    assert bool(torch.isfinite(xk).all())
    assert float((xk - xp).abs().max()) <= 1e-4


# ---------------------------------------------------------------------------
# The neural-field solve (csrc/node_field.cu).

def field_on(dev, widths, act=tnn.relu, seed=0):
    g = torch.Generator().manual_seed(seed)
    m = tnn.mlp(widths, act, tnn.identity, generator=g)
    with torch.no_grad():
        for lyr in m.layers:
            lyr.b.copy_(torch.randn(lyr.b.shape, generator=g) * 0.1)
    return m.to(dev)


def field_inputs(dev, widths, B, T, seed=1):
    g = torch.Generator().manual_seed(seed)
    u0s = (torch.randn(B, widths[0], generator=g) * 0.5).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
    w = torch.randn(B, T, widths[0], generator=g).to(dev)
    return u0s, saveat, w


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


FIELD_CASES = [
    ("train", (16, 200, 200, 16), 64, 50, "Tsit5", 1, tnn.relu),
    ("val", (16, 200, 200, 16), 45, 100, "Tsit5", 1, tnn.relu),
    ("ragged", (16, 200, 200, 16), 37, 21, "Tsit5", 1, tnn.relu),
    ("rk4-substeps3", (16, 200, 200, 16), 64, 50, "RK4", 3, tnn.relu),
    ("d8", (8, 200, 200, 8), 64, 50, "Tsit5", 1, tnn.relu),
    ("small", (8, 16, 16, 8), 20, 7, "Tsit5", 1, tnn.relu),
    ("wide", (128, 256, 256, 128), 256, 50, "Tsit5", 1, tnn.relu),
    ("tanh", (16, 200, 200, 16), 64, 50, "Tsit5", 1, tnn.tanh),
    ("val-softplus", (16, 200, 200, 16), 45, 100, "Tsit5", 1, tnn.softplus),
    ("wide-tanh", (128, 256, 256, 128), 256, 50, "Tsit5", 1, tnn.tanh),
    ("odd-softplus", (5, 7, 9, 5), 11, 6, "Dopri5", 2, tnn.softplus),
    ("one-layer-sigmoid", (3, 3), 5, 6, "Euler", 1, tnn.sigmoid),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,widths,B,T,solver,substeps,act", FIELD_CASES,
                         ids=[c[0] for c in FIELD_CASES])
def test_neural_field_kernels_match_plain_on_card(dev, label, widths, B, T,
                                                  solver, substeps, act):
    """Forward kernel vs the plain solve (atol 1e-5, and no more than twice
    as far from a float64 plain solve as the float32 plain solve is, plus
    1e-6); the tape-writing variant gives the same ys and the plain
    version's tape; the sweep and weight-gradient kernels vs their plain
    versions on the same tape and Delta (1e-5 of each tensor's size, relu
    too: both read the same activations); the backward vs the plain
    reverse sweep that recomputes from the same trajectory in float64
    (1e-5 of each gradient's size, relu 1e-2) and, for a smooth field, in
    float32 (1e-5)."""
    s = getattr(trk, solver)()
    m = field_on(dev, widths, act)
    if len(widths) == 2:      # a single layer keeps its activation
        m.layers[0].activation = act
    u0s, saveat, w = field_inputs(dev, widths, B, T)
    with torch.no_grad():
        ys = node_cuda.solve_neural_field_cuda(m, s, u0s, saveat,
                                               substeps=substeps)
        ref = node_cuda.solve_neural_field_reference(
            m, s, u0s, saveat, substeps=substeps)[0]
        ref64 = node_cuda.solve_neural_field_reference(
            copy.deepcopy(m).double(), s, u0s.double(), saveat.double(),
            substeps=substeps)[0]
    assert ys.shape == (B, T, widths[0])
    assert float((ys - ref).abs().max()) <= ATOL
    assert float((ys - ref64).abs().max()) <= 2 * float(
        (ref - ref64).abs().max()) + 1e-6
    with torch.no_grad():
        ys_t, tape = node_cuda.solve_neural_field_cuda(
            m, s, u0s, saveat, substeps=substeps, tape=True)
    assert torch.equal(ys_t, ys)
    _, tape_p = node_cuda.solve_neural_field_taped_reference(
        m, s, u0s, saveat, substeps=substeps)
    hp, _, dp, _ = node_cuda.tape_layout(widths)
    for off, wd in zip(hp, widths):
        assert rel(tape[..., off:off + wd], tape_p[..., off:off + wd]) <= 1e-5
    du0_s, delta = node_cuda.neural_field_sweep_cuda(m, s, saveat, tape, w,
                                                     substeps=substeps)
    du0_r, delta_r = node_cuda.neural_field_sweep_reference(
        m, s, saveat, tape, w, substeps=substeps)
    assert rel(du0_s, du0_r) <= 1e-5
    for off, wd in zip(dp, widths[1:]):
        assert rel(delta[..., off:off + wd], delta_r[..., off:off + wd]) <= 1e-5
    dWk, dbk = node_cuda.neural_field_dw_cuda(m, tape, delta)
    dWr, dbr = node_cuda.neural_field_dw_reference(m, tape, delta)
    for a, b in zip(dWk + dbk, dWr + dbr):
        assert rel(a, b) <= 1e-5
    du0, dWs, dbs = node_cuda.solve_neural_field_backward_cuda(
        m, s, saveat, tape, w, substeps=substeps)
    ru0, rWs, rbs = node_cuda.solve_neural_field_backward_reference(
        m, s, saveat, ys, w, substeps=substeps)
    du0_64, dWs_64, dbs_64 = node_cuda.solve_neural_field_backward_reference(
        copy.deepcopy(m).double(), s, saveat.double(), ys.double(),
        w.double(), substeps=substeps)
    tol = 1e-2 if act is tnn.relu else 1e-5
    for a, b, c in zip([du0, *dWs, *dbs], [ru0, *rWs, *rbs],
                       [du0_64, *dWs_64, *dbs_64]):
        assert a.shape == b.shape
        assert rel(a.double(), c) <= tol
        if act is not tnn.relu:
            assert rel(a, b) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2])
def test_neural_field_kernels_at_every_tile_size_on_card(dev, rows):
    """A ragged batch (37 rows) with the default tile, 1 and 2 rows a
    block: rows past the batch end add nothing to the weight gradients."""
    s = trk.Tsit5()
    widths = (8, 16, 16, 8)
    m = field_on(dev, widths, tnn.tanh, seed=3)
    u0s, saveat, w = field_inputs(dev, widths, 37, 9, seed=4)
    with torch.no_grad():
        ys, tape = node_cuda.solve_neural_field_cuda(
            m, s, u0s, saveat, rows_per_block=rows, tape=True)
        ref = node_cuda.solve_neural_field_reference(m, s, u0s, saveat)[0]
    assert float((ys - ref).abs().max()) <= ATOL
    got = node_cuda.solve_neural_field_backward_cuda(
        m, s, saveat, tape, w, rows_per_block=rows)
    want = node_cuda.solve_neural_field_backward_reference(m, s, saveat, ys,
                                                           w)
    for a, b in zip([got[0], *got[1], *got[2]],
                    [want[0], *want[1], *want[2]]):
        assert rel(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("act,tol", [(tnn.tanh, 1e-5), (tnn.relu, 1e-2)],
                         ids=["tanh", "relu"])
def test_neural_field_gradients_match_plain_autograd_on_card(dev, act, tol):
    """d sum(w * ys) / d (u0s, W, b) through the backward kernel against
    plain autograd through the plain solve and against
    backward="autograd", at the training shape."""
    s = trk.Tsit5()
    widths = (16, 200, 200, 16)
    m = field_on(dev, widths, act, seed=5)
    u0s, saveat, w = field_inputs(dev, widths, 64, 50, seed=6)

    def grads(fn, **kw):
        u = u0s.clone().requires_grad_()
        ys = fn(m, s, u, saveat, **kw)[0]
        return torch.autograd.grad((ys * w).sum(), [u] + list(m.parameters()))

    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda,
                node_cuda.neural_field_dw_cuda)
    before = [fn.launches for fn in counters]
    k = grads(node_cuda.solve_neural_field)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 1]
    r = grads(node_cuda.solve_neural_field, backward="autograd")
    p = grads(node_cuda.solve_neural_field_reference)
    for a, b, c in zip(k, r, p):
        assert rel(a, c) <= tol and rel(a, b) <= tol


@pytest.mark.cuda
def test_neural_field_kernel_refuses_what_it_does_not_take_on_card(dev):
    """No fallback on CUDA tensors: an unknown activation, a field deeper
    than MAX_LAYERS, one too wide for a block's shared memory and a
    non-float32 state raise, and nothing launches."""
    s = trk.Tsit5()
    u0s, saveat, _ = field_inputs(dev, (8, 8), 4, 5)
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda,
                node_cuda.neural_field_dw_cuda)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="activations"):
        node_cuda.solve_neural_field(
            tnn.mlp((8, 16, 8), torch.nn.functional.gelu).to(dev), s, u0s,
            saveat)
    with pytest.raises(ValueError, match="layers"):
        node_cuda.solve_neural_field(
            tnn.mlp((8,) * (node_cuda.MAX_LAYERS + 2), tnn.relu).to(dev), s,
            u0s, saveat)
    with pytest.raises(ValueError, match="too wide"):
        node_cuda.kernel_plan((4096, 4096, 4096), 6, 64, backward=True)
    with pytest.raises(ValueError, match="float32"):
        node_cuda.solve_neural_field(field_on(dev, (8, 16, 8)), s,
                                     u0s.double(), saveat)
    with pytest.raises(ValueError, match="invalid"):
        node_cuda.kernel_plan((16, 200, 200, 16), 6, 64, backward=False,
                              rows_per_block=4)
    assert before == [fn.launches for fn in counters]


@pytest.mark.cuda
def test_neural_field_plan_keeps_the_hidden_layer_in_registers_on_card(dev):
    """The main path's field keeps its 200 x 200 layer in registers (416
    threads, one row a block) in both passes; the wide field reads its
    weights through the cache, two rows a block at B 256."""
    for backward in (False, True):
        rows, place, reg, threads, _ = node_cuda.kernel_plan(
            (16, 200, 200, 16), 6, 64, backward=backward)
        assert (rows, place, reg, threads) == (1, "registers", 1, 416)
        rows, place, reg, threads, _ = node_cuda.kernel_plan(
            (128, 256, 256, 128), 6, 256, backward=backward)
        assert (rows, place, reg, threads) == (2, "global", -1, 512)


@pytest.mark.cuda
def test_neural_field_plan_counts_every_replicas_rows_on_card(dev):
    """The default rows a block counts S * B rows against the card's SMs
    (132 on an H100 SXM): one row while they fit one wave, two past it;
    the main path's sweep still keeps its 200 x 200 layer in registers at
    two rows."""
    w = (16, 200, 200, 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for S, B in ((1, 64), (2, 64), (3, 64), (4, 45), (1, 133), (8, 64)):
        want = 1 if S * B <= sms else 2
        for backward in (False, True):
            rows, place, reg, threads, _ = node_cuda.kernel_plan(
                w, 6, B, backward=backward, replicas=S)
            assert (rows, place, reg, threads) == (want, "registers", 1, 416)
    with pytest.raises(ValueError, match="invalid"):
        node_cuda.kernel_plan(w, 6, 64, backward=False, replicas=0)


@pytest.mark.cuda
def test_latent_ode_kernel_path_matches_plain_path_on_card(dev):
    """A small LatentODE with the kernel solve launches the forward kernel
    once per forward and the sweep and weight-gradient kernels once per
    backward, and agrees with the same weights run plainly, outputs and
    gradients."""
    node = NODE(6, hidden_dim=16, augment_dim=2, activation=tnn.tanh,
                device=dev, options=SolveOptions(adaptive=False, substeps=1))
    layers = default_layers(LatentODE(), 24, node, hidden_dim_resnet=16,
                            rnn_input_dim=8, rnn_output_dim=8, device=dev)
    km = LatentDiffEqModel.build(LatentODE(use_kernel_solve=True), *layers)
    pm = LatentDiffEqModel.build(LatentODE(), *layers)
    x = torch.rand(6, 10, 24, device=dev)
    t = torch.arange(10, dtype=torch.float32, device=dev) * 0.05
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda,
                node_cuda.neural_field_dw_cuda)
    before = [fn.launches for fn in counters]
    params = list(km.parameters())
    eps = torch.randn(6, 6, device=dev)
    (xk, zk, _), _, _, aux = km(x, t, variational=True, eps=eps)
    gk = torch.autograd.grad((xk ** 2).sum(), params)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 1]
    (xp, zp, _), _, _, _ = pm(x, t, variational=True, eps=eps)
    gp = torch.autograd.grad((xp ** 2).sum(), params)
    assert xk.shape == (6, 10, 24) and zk.shape == (6, 10, 8)
    assert bool(aux["success"].all())
    assert int(aux["stats"]["n_rhs_evals"]) == 6 * 9 * 6
    assert float((xk - xp).abs().max()) <= 1e-4
    assert float((zk - zp).abs().max()) <= 1e-4
    for a, b in zip(gk, gp):
        assert rel(a, b) <= 1e-4


# The weight-gradient kernel (node_field_dw_kernel): 3xTF32 on the tensor
# cores, split-K added inside the kernel in a fixed order, a replica axis.

DW_CASES = [("train", (16, 200, 200, 16), 64, 50),
            ("wide", (128, 256, 256, 128), 256, 50),
            ("ragged", (16, 200, 200, 16), 37, 21)]


def tape_and_delta(dev, widths, B, T, seed):
    """A real tape and Delta at a shape: the forward and sweep kernels on
    a tanh field."""
    s = trk.Tsit5()
    m = field_on(dev, widths, tnn.tanh, seed=seed)
    u0s, saveat, w = field_inputs(dev, widths, B, T, seed=seed + 1)
    with torch.no_grad():
        _, tape = node_cuda.solve_neural_field_cuda(m, s, u0s, saveat,
                                                    tape=True)
    _, delta = node_cuda.neural_field_sweep_cuda(m, s, saveat, tape, w)
    return m, tape, delta


@pytest.mark.cuda
@pytest.mark.parametrize("label,widths,B,T", DW_CASES,
                         ids=[c[0] for c in DW_CASES])
def test_node_field_dw_matches_plain_on_card(dev, label, widths, B, T):
    """The weight gradients against the plain product on the same tape and
    Delta, 1e-5 of each tensor's size; one launch; two calls bit for bit."""
    m, tape, delta = tape_and_delta(dev, widths, B, T, seed=7)
    n0 = node_cuda.neural_field_dw_cuda.launches
    dWk, dbk = node_cuda.neural_field_dw_cuda(m, tape, delta)
    assert node_cuda.neural_field_dw_cuda.launches == n0 + 1
    dWr, dbr = node_cuda.neural_field_dw_reference(m, tape, delta)
    for a, b in zip(dWk + dbk, dWr + dbr):
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-5
    again = node_cuda.neural_field_dw_cuda(m, tape, delta)
    assert all(torch.equal(a, b) for a, b in zip(dWk + dbk,
                                                 again[0] + again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("label,widths,B,T", DW_CASES[::2],
                         ids=[c[0] for c in DW_CASES[::2]])
def test_node_field_dw_replica_axis_bit_for_bit_on_card(dev, label, widths,
                                                        B, T):
    """Four replicas' tapes in one launch: each replica bit for bit its own
    launch (the split plan does not depend on the replicas), and within
    1e-5 of each tensor's size of the plain product with the replica
    axis."""
    parts = [tape_and_delta(dev, widths, B, T, seed=20 + 2 * i)
             for i in range(4)]
    tape = torch.stack([p[1] for p in parts])
    delta = torch.stack([p[2] for p in parts])
    n0 = node_cuda.neural_field_dw_cuda.launches
    dWs, dbs = node_cuda.neural_field_dw_cuda(parts[0][0], tape, delta)
    assert node_cuda.neural_field_dw_cuda.launches == n0 + 1
    assert dWs[1].shape == (4, widths[1], widths[2])
    for i, (m, tp, dl) in enumerate(parts):
        solo = node_cuda.neural_field_dw_cuda(m, tp, dl)
        assert all(torch.equal(a[i], b) for a, b in zip(dWs + dbs,
                                                        solo[0] + solo[1]))
    ref = node_cuda.neural_field_dw_reference(parts[0][0], tape, delta)
    for a, b in zip(dWs + dbs, ref[0] + ref[1]):
        for i in range(4):
            assert rel(a[i], b[i]) <= 1e-5


@pytest.mark.cuda
def test_node_field_dw_refuses_a_field_too_wide_for_its_tiles_on_card(dev):
    """A field whose tiles overflow the kernel's table raises ValueError and
    launches nothing."""
    widths = (4096, 4096, 4096)
    m = tnn.mlp(widths, tnn.relu, tnn.identity).to(dev)
    rec, drec = node_cuda.tape_layout(widths)[1::2]
    tape = torch.zeros(1, 1, 1, rec, device=dev)
    delta = torch.zeros(1, 1, 1, drec, device=dev)
    n0 = node_cuda.neural_field_dw_cuda.launches
    with pytest.raises(ValueError, match="too wide"):
        node_cuda.neural_field_dw_cuda(m, tape, delta)
    with pytest.raises(ValueError, match="too wide"):
        node_cuda.neural_field_dw_plan(widths, 1)
    assert node_cuda.neural_field_dw_cuda.launches == n0


def field_population(dev, widths, S, act=tnn.relu, seed=0):
    """S fields and the _Field of their weights stacked on a replica
    axis."""
    ms = [field_on(dev, widths, act, seed=seed + i) for i in range(S)]
    f = node_cuda.dense_stack(ms[0])
    return ms, f._replace(
        Ws=[torch.stack([m.layers[l].W.detach() for m in ms])
            for l in range(len(ms[0].layers))],
        bs=[torch.stack([m.layers[l].b.detach() for m in ms])
            for l in range(len(ms[0].layers))])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [0, 1, 2])
@pytest.mark.parametrize("B", [5, 45, 64])
@pytest.mark.parametrize("S", [1, 3, 5])
def test_neural_field_replica_axis_bit_for_bit_on_card(dev, S, B, rows):
    """The forward (with and without its tape) and the sweep on S fields in
    one launch each (grid z the replica) against S solo launches at the
    same rows a block: ys, the tape, du0 and Delta bit for bit. B 5 puts a
    ragged tile at each replica's batch end at two rows a block. With the
    default plan (rows 0) the launch may take two rows a block where each
    solo launch takes one (S * B > 132): a row's arithmetic does not
    depend on the rows a block, so that is bit for bit too."""
    s = trk.Tsit5()
    widths = (16, 200, 200, 16)
    T = 100 if B == 45 else 50
    ms, pop = field_population(dev, widths, S, seed=30 + S)
    ins = [field_inputs(dev, widths, B, T, seed=50 + i) for i in range(S)]
    u0s = torch.stack([i[0] for i in ins])
    saveat = ins[0][1]
    w = torch.stack([i[2] for i in ins])
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda)
    before = [fn.launches for fn in counters]
    with torch.no_grad():
        ys, tape = node_cuda.solve_neural_field_cuda(
            pop, s, u0s, saveat, tape=True, rows_per_block=rows)
        ys0 = node_cuda.solve_neural_field_cuda(pop, s, u0s, saveat,
                                                rows_per_block=rows)
    du0, delta = node_cuda.neural_field_sweep_cuda(pop, s, saveat, tape, w,
                                                   rows_per_block=rows)
    assert [fn.launches - n for fn, n in zip(counters, before)] == [2, 1]
    assert ys.shape == (S, B, T, 16) and du0.shape == (S, B, 16)
    for i, m in enumerate(ms):
        with torch.no_grad():
            ys_i, tape_i = node_cuda.solve_neural_field_cuda(
                m, s, u0s[i], saveat, tape=True, rows_per_block=rows)
        du0_i, delta_i = node_cuda.neural_field_sweep_cuda(
            m, s, saveat, tape_i, w[i], rows_per_block=rows)
        assert torch.equal(ys[i], ys_i) and torch.equal(ys0[i], ys_i)
        assert torch.equal(tape[i], tape_i)
        assert torch.equal(du0[i], du0_i) and torch.equal(delta[i], delta_i)


@pytest.mark.cuda
def test_neural_field_replica_axis_checks_on_card(dev):
    """Weights without the data's replica axis, or with another count of
    replicas, raise and launch nothing."""
    s = trk.Tsit5()
    widths = (8, 16, 16, 8)
    ms, pop = field_population(dev, widths, 3)
    u0s, saveat, w = field_inputs(dev, widths, 4, 6)
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="replica axis"):
        node_cuda.solve_neural_field_cuda(ms[0], s, u0s.expand(3, -1, -1),
                                          saveat)
    with pytest.raises(ValueError, match="replica axis"):
        node_cuda.solve_neural_field_cuda(pop, s, u0s.expand(2, -1, -1),
                                          saveat)
    with pytest.raises(ValueError, match="replica axis"):
        node_cuda.solve_neural_field_cuda(pop, s, u0s, saveat)
    rec = node_cuda.tape_layout(widths)[1]
    tape = torch.zeros(2, 4, 5, 6, rec, device=dev)
    with pytest.raises(ValueError, match="replica axis"):
        node_cuda.neural_field_sweep_cuda(pop, s, saveat, tape,
                                          w.expand(2, -1, -1, -1))
    assert before == [fn.launches for fn in counters]


@pytest.mark.cuda
def test_latent_ode_population_launches_on_card(dev):
    """A 3-seed LatentODE(use_kernel_solve=True) population: a train step
    launches the forward, the sweep and the weight gradients once each for
    all replicas; a validation pass the forward once; losses and gradients
    against the same population on the plain route (1e-4 of each
    gradient's size)."""
    from latentdiffeq_torch.train import MultiSeedTrainer, TrainConfig

    def build(kernels):
        def init(seed):
            g = torch.Generator().manual_seed(seed)
            node = NODE(4, hidden_dim=32, generator=g, device=dev,
                        options=SolveOptions(adaptive=False, substeps=1))
            mt = LatentODE(use_kernel_solve=kernels)
            return LatentDiffEqModel.build(mt, *default_layers(
                mt, 24, node, hidden_dim_resnet=16, rnn_input_dim=8,
                rnn_output_dim=8, generator=g, device=dev))
        return MultiSeedTrainer(init, TrainConfig(batch_size=6, seq_len=10,
                                                  save_best=False),
                                [1, 2, 3], device=dev)

    g = torch.Generator().manual_seed(8)
    xs = torch.rand(3, 6, 10, 24, generator=g).to(dev)
    eps = torch.randn(3, 6, 4, generator=g).to(dev)
    counters = (node_cuda.solve_neural_field_cuda,
                node_cuda.neural_field_sweep_cuda,
                node_cuda.neural_field_dw_cuda)
    out = []
    for kernels in (True, False):
        ms = build(kernels)
        before = [fn.launches for fn in counters]
        m = ms.train_step(xs, 0.5, eps=eps)
        steps = [fn.launches - n for fn, n in zip(counters, before)]
        with torch.no_grad():
            ms.val_step(xs[0], 0.5)
        vals = [fn.launches - n for fn, n in zip(counters, before)]
        if kernels:
            assert steps == [1, 1, 1] and vals == [2, 1, 1]
        else:
            assert steps == [0, 0, 0] and vals == [0, 0, 0]
        out.append((m["loss"], [p.grad for p in ms.params.values()]))
    (lk, gk), (lp, gp) = out
    assert float((lk - lp).abs().max()) <= 1e-4 * max(
        float(lp.abs().max()), 1.0)
    for a, b in zip(gk, gp):
        assert rel(a, b) <= 1e-4


# ---------------------------------------------------------------------------
# GOKU on the stochastic pendulum: the goku_heads kernels, the SDE solve in
# plain PyTorch.


@pytest.mark.cuda
def test_sde_goku_kernel_encoder_and_brownian_path_on_card(dev):
    """Full-width GOKU on SPendulum: with both kernel switches on, a forward
    and its backward launch goku_heads and goku_heads_bwd once each and no
    RK kernel, and agree with the plain route on the same weights, eps and
    Brownian key (outputs 1e-4, gradients 1e-4 of each gradient's size);
    the forward's Brownian path on the card matches the CPU's: the keys bit
    for bit, the normals within 2 units in the last place."""
    from latentdiffeq_torch import random as jr
    from latentdiffeq_torch.pendulum import SPendulum
    from latentdiffeq_torch.solve.brownian import bridge_increments

    layers = goku_default_layers(
        784, SPendulum(), generator=torch.Generator().manual_seed(3),
        device=dev)
    km = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), *layers)
    pm = LatentDiffEqModel.build(GOKUBasic(), *layers)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(16, 30, 784, generator=g).to(dev)
    t = torch.arange(30, dtype=torch.float32, device=dev) * 0.05
    eps = tuple(torch.randn(16, 16, generator=g).to(dev) for _ in range(2))
    key = jr.PRNGKey(9, device=dev)
    counters = (recurrent_cuda.goku_heads_cuda,
                recurrent_cuda.goku_heads_bwd_cuda,
                ode_cuda.solve_fixed_grid_batched_cuda,
                ode_cuda.solve_fixed_grid_batched_bwd_cuda)
    before = [launches(fn) for fn in counters]
    params = list(km.parameters())
    out = []
    for m in (km, pm):
        (xh, z, _), _, _, aux = m(x, t, variational=True, eps=eps, key=key)
        out.append((xh, z, torch.autograd.grad((xh ** 2).sum(), params)))
        if m is km:
            assert [launches(fn) - n for fn, n in
                    zip(counters, before)] == [1, 1, 0, 0]
    (xk, zk, gk), (xp, zp, gp) = out
    assert bool(aux["success"].all()) and xk.shape == x.shape
    assert float((xk - xp).abs().max().detach()) <= 1e-4
    assert float((zk - zp).abs().max().detach()) <= 1e-4
    for a, b in zip(gk, gp):
        assert rel_err(a, b) <= 1e-4

    keys = jr.split(key, 16)
    assert torch.equal(keys.cpu(), jr.split(key.cpu(), 16))
    cells = torch.arange(29, device=dev)
    ik = jr.fold_in(keys[:, None, :], cells)
    ik_cpu = jr.fold_in(keys.cpu()[:, None, :], cells.cpu())
    assert torch.equal(ik.cpu(), ik_cpu)
    z, z_cpu = jr.normal(ik, (2, 2)).cpu(), jr.normal(ik_cpu, (2, 2))
    m_ = z_cpu.abs()
    ulp = torch.nextafter(m_, torch.full_like(m_, float("inf"))) - m_
    assert float(((z - z_cpu).abs() / ulp).max()) <= 2   # 0 expected
    w, i = bridge_increments(keys, t, 1, (2,))
    w_cpu, i_cpu = bridge_increments(keys.cpu(), t.cpu(), 1, (2,))
    assert float((w.cpu() - w_cpu).abs().max()) <= 1e-6
    assert float((i.cpu() - i_cpu).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_normal_stages_match_cpu_bit_for_bit_on_card(dev):
    """Each stage of a float32 threefry normal, on the card against the
    CPU bit for bit: log1p_exact, sqrt_rn and erfinv_xla on uniforms in
    (-1, 1) with both tails (w = -log1p(-u^2) past 5 takes erfinv's second
    polynomial), and the normals of chip_smoke.py phase 4f's interval keys
    (torch.log1p and the card's float32 sqrt each miss the CPU by an ulp)."""
    from latentdiffeq_torch import random as jr

    g = torch.Generator().manual_seed(8)
    u = torch.cat([torch.rand(20000, generator=g) * 2 - 1,
                   1 - torch.arange(1, 200) * 2.0 ** -24,
                   torch.arange(1, 200) * 2.0 ** -24 - 1])
    y = -(u * u)
    w = -jr.log1p_exact(y)
    assert bool((w >= 5).any())
    for fn, x in ((jr.log1p_exact, y), (jr.sqrt_rn, w), (jr.erfinv_xla, u)):
        assert torch.equal(fn(x.to(dev)).cpu(), fn(x)), fn.__name__
    ik = jr.fold_in(jr.split(jr.PRNGKey(7), 45)[:, None, :], torch.arange(99))
    assert torch.equal(jr.normal(ik.to(dev), (2, 2)).cpu(),
                       jr.normal(ik, (2, 2)))


# -- a population of weight sets: one launch for every replica ---------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
@pytest.mark.parametrize("width", ["compiled", "narrow", "wide"])
def test_goku_heads_replica_axis_bit_for_bit_on_card(dev, S, width):
    """goku_heads and goku_heads_bwd on S weight sets in one launch each,
    (B, S) grid, against S solo launches on the replicas' weights: the
    outputs, the tape and the sweep's dgates, dh0, dc0 bit for bit (the
    narrow heads run zero-padded at the compiled widths, the wide ones in
    the any-width pair)."""
    D, H = {"compiled": (32, 16), "narrow": (10, 8), "wide": (64, 32)}[width]
    heads = [heads_on(dev, D, H, seed=s) for s in range(S)]
    wts = torch.stack([recurrent_cuda.pack_goku_heads(
        *h, *recurrent_cuda.kernel_widths(D, H)) for h in heads])
    g = torch.Generator().manual_seed(S)
    B, T = 5, 13
    xs = torch.randn(S, B, T, D, generator=g).to(dev)
    gz = torch.randn(S, B, H, generator=g).to(dev)
    gt = torch.randn(S, B, 2 * H, generator=g).to(dev)
    n0 = (recurrent_cuda.goku_heads_cuda.launches,
          recurrent_cuda.goku_heads_bwd_cuda.launches)
    z, th, tape = recurrent_cuda.goku_heads_cuda(*heads[0], xs, tape=True,
                                                 wts=wts)
    dg, dh0, dc0 = recurrent_cuda.goku_heads_bwd_cuda(*heads[0], tape, gz,
                                                      gt, wts=wts)
    assert (recurrent_cuda.goku_heads_cuda.launches - n0[0],
            recurrent_cuda.goku_heads_bwd_cuda.launches - n0[1]) == (1, 1)
    for s in range(S):
        zs, ths, tps = recurrent_cuda.goku_heads_cuda(*heads[s], xs[s],
                                                      tape=True)
        solo = recurrent_cuda.goku_heads_bwd_cuda(*heads[s], tps, gz[s],
                                                  gt[s])
        for a, b in zip((z[s], th[s], tape[s], dg[s], dh0[s], dc0[s]),
                        (zs, ths, tps) + solo):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_rk_solve_under_vmap_is_one_launch_on_card(dev):
    """torch.func.vmap over replicas of the batched RK solve: one forward
    and one backward launch on S * B rows, equal bit for bit to the solve
    of those rows (ys, success and both gradients)."""
    from torch.func import vmap

    S, B, T = 4, 6, 20
    g = torch.Generator().manual_seed(2)
    u0s = (torch.rand(S, B, 2, generator=g) * 2 - 1).to(dev)
    ps = (1 + torch.rand(S, B, 1, generator=g)).to(dev)
    w = torch.randn(S, B, T, 2, generator=g).to(dev)
    saveat = torch.arange(T, dtype=torch.float32, device=dev) * 0.05
    solver = trk.Tsit5()
    fwd = ode_cuda.solve_fixed_grid_batched_cuda.launches
    bwd = ode_cuda.solve_fixed_grid_batched_bwd_cuda.launches
    n0 = (sum(fwd.values()), sum(bwd.values()))
    u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    ys, ok = vmap(lambda a, b: ode_cuda.solve_fixed_grid_batched(
        pendulum_f, solver, a, b, saveat)[:2])(u, p)
    (ys * w).sum().backward()
    assert (sum(fwd.values()) - n0[0], sum(bwd.values()) - n0[1]) == (1, 1)
    u2 = u0s.reshape(S * B, 2).clone().requires_grad_()
    p2 = ps.reshape(S * B, 1).clone().requires_grad_()
    ys2, ok2, _ = ode_cuda.solve_fixed_grid_batched(pendulum_f, solver, u2,
                                                    p2, saveat)
    (ys2 * w.reshape(S * B, T, 2)).sum().backward()
    assert torch.equal(ys, ys2.reshape(S, B, T, 2).detach())
    assert torch.equal(ok, ok2.reshape(S, B))
    assert torch.equal(u.grad, u2.grad.reshape(S, B, 2))
    assert torch.equal(p.grad, p2.grad.reshape(S, B, 1))


@pytest.mark.cuda
def test_population_step_kernel_route_matches_plain_route_on_card(dev):
    """A 3-seed GOKU population step with both kernel switches on: one
    launch of each kernel for all replicas (forward and backward) and no
    plain-version call; losses and gradients against the same population
    on the plain route (1e-4 of each gradient's size)."""
    from latentdiffeq_torch.train import MultiSeedTrainer, TrainConfig

    def build(kernels):
        def init(seed):
            diffeq = Pendulum(options=SolveOptions(adaptive=False))
            return LatentDiffEqModel.build(
                GOKUBasic(use_kernel_encoder=kernels,
                          use_kernel_solver=kernels),
                *goku_default_layers(
                    64, diffeq, hidden_dim_resnet=32,
                    latent_to_diffeq_dim=32,
                    generator=torch.Generator().manual_seed(seed),
                    device=dev))
        return MultiSeedTrainer(init, TrainConfig(batch_size=8, seq_len=12,
                                                  save_best=False),
                                [3, 4, 5], device=dev)

    g = torch.Generator().manual_seed(4)
    xs = torch.rand(3, 8, 12, 64, generator=g).to(dev)
    eps = tuple(torch.randn(3, 8, 16, generator=g).to(dev) for _ in range(2))
    counters = (recurrent_cuda.goku_heads_cuda,
                recurrent_cuda.goku_heads_bwd_cuda,
                ode_cuda.solve_fixed_grid_batched_cuda,
                ode_cuda.solve_fixed_grid_batched_bwd_cuda)
    plain_calls = (recurrent_cuda.goku_heads_reference.calls,
                   ode_cuda.solve_fixed_grid_batched_reference.calls)
    out = []
    for kernels in (True, False):
        ms = build(kernels)
        before = [launches(fn) for fn in counters]
        m = ms.train_step(xs, 0.5, eps=eps)
        if kernels:
            assert [launches(fn) - n for fn, n in
                    zip(counters, before)] == [1, 1, 1, 1]
            assert (recurrent_cuda.goku_heads_reference.calls,
                    ode_cuda.solve_fixed_grid_batched_reference.calls
                    ) == plain_calls
        out.append((m["loss"], [p.grad for p in ms.params.values()]))
    (lk, gk), (lp, gp) = out
    assert float((lk - lp).abs().max()) <= 1e-4
    for a, b in zip(gk, gp):
        assert rel_err(a, b) <= 1e-4


# -- the bf16 instances of the heads kernels ----------------------------------
# Each bf16 result is held against a float32 evaluation of the same bf16
# weights and inputs upcast (the plain float32 version): at most twice as far
# from it as the plain bf16 version is, plus 2^-8 of its size (bf16 rounds at
# other places in the kernel and in PyTorch; chip_smoke.py's bf16_gate).

def bf16_close(k, p, f):
    f = f.float()
    d_k = float((k.float() - f).abs().max())
    d_p = float((p.float() - f).abs().max())
    return d_k <= 2 * d_p + float(f.abs().max()) / 256


def bf16_heads(dev, D=32, H=16, seed=0):
    hb = tuple(h.to(torch.bfloat16) for h in heads_on(dev, D, H, seed))
    return hb, tuple(copy.deepcopy(h).float() for h in hb)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(64, 50, 32, 16), (45, 100, 32, 16),
                                     (37, 21, 32, 16), (64, 50, 64, 32),
                                     (20, 30, 10, 8)])
def test_goku_heads_bf16_forward_and_sweep_on_card(dev, B, T, D, H):
    """The bf16 forward (outputs and tape) and sweep (dgates, dh0, dc0 on
    the same bf16 tape) against the plain bf16 versions, which round where
    the kernel rounds, by the bf16 rule; every result bf16."""
    hb, h32 = bf16_heads(dev, D, H)
    g = torch.Generator().manual_seed(B + T)
    xs = torch.randn(B, T, D, generator=g).to(dev, torch.bfloat16)
    gz = torch.randn(B, H, generator=g).to(dev, torch.bfloat16)
    gt = torch.randn(B, 2 * H, generator=g).to(dev, torch.bfloat16)
    rc = recurrent_cuda
    with torch.no_grad():
        z, th, tape = rc.goku_heads_cuda(*hb, xs, tape=True)
        ref = rc.goku_heads_taped_reference(*hb, xs)
        r32 = rc.goku_heads_taped_reference(*h32, xs.float())
        sw = rc.goku_heads_bwd_cuda(*hb, tape, gz, gt)
        sp = rc.goku_heads_sweep_reference(*hb, tape, gz, gt)
        sf = rc.goku_heads_sweep_reference(*h32, tape.float(), gz.float(),
                                           gt.float())
    Hk = rc.kernel_widths(D, H)[1]
    for k, p, f in zip((z, th), ref, r32):
        assert k.dtype == torch.bfloat16 and bf16_close(k, p, f)
    # the tape at the kernel's hidden width: compare where the heads' own
    # layout lines up (the compiled widths pad narrower heads)
    if Hk == H:
        assert bf16_close(tape, ref[2], r32[2])
        for k, p, f in zip(sw, sp, sf):
            assert k.dtype == torch.bfloat16 and bf16_close(k, p, f)
    else:
        assert tape.dtype == sw[0].dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8])
def test_goku_heads_bf16_replica_axis_bit_for_bit_on_card(dev, S):
    """S bf16 weight sets in one launch of each kernel equal S solo
    launches bit for bit."""
    rc = recurrent_cuda
    hb, _ = bf16_heads(dev)
    g = torch.Generator().manual_seed(S)
    params = [(p.detach().float().cpu() + 0.05 * torch.randn(
        (S,) + tuple(p.shape), generator=g)).to(dev, torch.bfloat16)
        for p in rc._heads_params(*hb)]
    wts = rc.pack_goku_heads(*hb, params=params)
    xs = torch.randn(S, 16, 20, 32, generator=g).to(dev, torch.bfloat16)
    gz = torch.randn(S, 16, 16, generator=g).to(dev, torch.bfloat16)
    gt = torch.randn(S, 16, 32, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        z, th, tape = rc.goku_heads_cuda(*hb, xs, tape=True, wts=wts)
        sw = rc.goku_heads_bwd_cuda(*hb, tape, gz, gt, wts=wts)
        for i in range(S):
            solo = copy.deepcopy(hb)
            for p, q in zip(rc._heads_params(*solo), params):
                p.copy_(q[i])
            zs, ths, tps = rc.goku_heads_cuda(*solo, xs[i], tape=True)
            ss = rc.goku_heads_bwd_cuda(*solo, tps, gz[i], gt[i])
            for a, b in zip((z[i], th[i], tape[i]) + tuple(x[i] for x in sw),
                            (zs, ths, tps) + ss):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_goku_step_runs_the_bf16_kernels_on_card(dev):
    """A bf16 GOKU with both kernel switches: one step launches the heads'
    bf16 instances (forward and sweep) and the float32 RK kernel, no plain
    version; the loss and every gradient (bf16) against the plain bf16
    route and the float32 route on the upcast weights, by the bf16 rule."""
    from latentdiffeq_torch.train import loss_batch
    diffeq = Pendulum(options=SolveOptions(adaptive=False))

    def build(kernels, dtype=torch.bfloat16):
        return LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=kernels, use_kernel_solver=kernels),
            *goku_default_layers(64, diffeq, hidden_dim_resnet=32,
                                 latent_to_diffeq_dim=32, device=dev,
                                 dtype=dtype))

    g = torch.Generator().manual_seed(1)
    x = torch.rand(16, 12, 64, generator=g).to(dev)
    t = torch.arange(12, dtype=torch.float32, device=dev) * 0.05
    eps = tuple(torch.randn(16, 16, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
    km, pm = build(True), build(False)
    fm = copy.deepcopy(pm).float()
    n0 = (recurrent_cuda.goku_heads_cuda.bf16_launches,
          recurrent_cuda.goku_heads_bwd_cuda.bf16_launches,
          launches(ode_cuda.solve_fixed_grid_batched_cuda),
          launches(ode_cuda.solve_fixed_grid_batched_bwd_cuda),
          recurrent_cuda.goku_heads_reference.calls)
    out = []
    for m in (km, pm, fm):
        e = tuple(a.to(next(m.parameters()).dtype) for a in eps)
        loss = loss_batch(m, x, t, 0.5, eps=e)[0]
        loss.backward()
        out.append((loss.detach().reshape(1),
                    [p.grad for p in m.parameters()]))
        if m is km:
            n1 = (recurrent_cuda.goku_heads_cuda.bf16_launches,
                  recurrent_cuda.goku_heads_bwd_cuda.bf16_launches,
                  launches(ode_cuda.solve_fixed_grid_batched_cuda),
                  launches(ode_cuda.solve_fixed_grid_batched_bwd_cuda),
                  recurrent_cuda.goku_heads_reference.calls)
            assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1, 0]
    (lk, gk), (lp, gp), (lf, gf) = out
    assert bf16_close(lk, lp, lf)
    for a, b, c in zip(gk, gp, gf):
        assert a.dtype == torch.bfloat16 and bf16_close(a, b, c)


# -- block mode: the epochs as CUDA graphs (train/trainer.py, BlockFn) -------

def block_trainers(dev, which, dtype=torch.float32, **kw):
    """A small GOKU (the heads and RK kernels; bf16 NN stages with
    ``dtype``) or LatentODE (the neural-field kernels) in a Trainer on the
    card, seed 3, 2 steps of 8 an epoch."""
    from latentdiffeq_torch.train import TrainConfig, Trainer
    g = torch.Generator().manual_seed(3)
    if which == "goku":
        diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
        model = LatentDiffEqModel.build(
            GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True),
            *goku_default_layers(64, diffeq, hidden_dim_resnet=32,
                                 latent_to_diffeq_dim=32, generator=g,
                                 device=dev, dtype=dtype))
    else:
        mt = LatentODE(use_kernel_solve=True)
        node = NODE(6, hidden_dim=32, generator=g, device=dev,
                    options=SolveOptions(adaptive=False, substeps=1))
        model = LatentDiffEqModel.build(
            mt, *default_layers(mt, 64, node, generator=g, device=dev,
                                hidden_dim_resnet=32))
    cfg = TrainConfig(batch_size=8, seq_len=10, epochs=50, save_best=False,
                      **kw)
    return Trainer(model, cfg, device=dev)


def block_data(dev):
    g = torch.Generator().manual_seed(4)
    x = torch.rand(20, 16, 64, generator=g).to(dev)
    return x[:16], x[16:]


def launch_counts():
    from latentdiffeq_torch.ops import launches
    return launches.snapshot()


@pytest.mark.cuda
@pytest.mark.parametrize("which,dtype", [("goku", torch.float32),
                                         ("goku", torch.bfloat16),
                                         ("latent_ode", torch.float32)])
def test_block_graphs_equal_the_eager_epochs(dev, which, dtype):
    """Blocks of 2 epochs (the first epoch eager on the side stream, every
    later one a replay of the captured graph, under sync debug mode
    "error") against the per-step loop from the same seed, 5 epochs: every
    epoch's losses, the weights, Adam's state and step count, the best and
    the three streams bit for bit, and the same kernel launches."""
    tr_set, va_set = block_data(dev)
    runs = []
    for kw in (dict(jit_epoch=False), dict(epochs_per_dispatch=2)):
        tr = block_trainers(dev, which, dtype, **kw)
        tr.sync_debug = "error"
        before = launch_counts()
        tr.fit(tr_set, va_set, epochs=5, verbose=False)
        torch.cuda.synchronize()
        from latentdiffeq_torch.ops import launches
        runs.append((tr, launches.gained(before, launch_counts())))
    (a, na), (b, nb) = runs
    assert na == nb
    assert not na["plain goku_heads"] and not na["plain rk_fixed_grid"]
    assert sum(v if isinstance(v, int) else sum(v.values())
               for v in na.values()) > 0
    keys = ("train_loss", "val_loss", "kl", "n_failed")
    assert [[h[k] for k in keys] for h in a.history] == \
        [[h[k] for k in keys] for h in b.history]
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.opt.t == b.opt.t == 10
    for p, q in zip(a.opt.state_tensors(), b.opt.state_tensors()):
        assert torch.equal(p, q)
    assert a.best["epoch"] == b.best["epoch"]
    for k, v in a.best["model"].items():
        assert torch.equal(v, b.best["model"][k]), k
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())
    assert torch.equal(a.window_gen.get_state(), b.window_gen.get_state())
    assert a.np_rng.bit_generator.state == b.np_rng.bit_generator.state


@pytest.mark.cuda
def test_block_graphs_recapture_for_new_tensors(dev):
    """A second fit on another copy of the data starts over (an eager
    epoch, then a new capture) and still equals the per-step loop."""
    tr_set, va_set = block_data(dev)
    a = block_trainers(dev, "goku", jit_epoch=False)
    b = block_trainers(dev, "goku", epochs_per_dispatch=3)
    for n, data in ((3, tr_set), (6, tr_set.clone())):
        a.fit(data, va_set, epochs=n, verbose=False)
        b.fit(data, va_set, epochs=n, verbose=False)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert [h["val_loss"] for h in a.history] == \
        [h["val_loss"] for h in b.history]
    assert torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state())
