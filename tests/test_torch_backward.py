"""The plain versions of the GOKU kernels' backward passes against the JAX
package, on the CPU at small sizes: the heads' tape-writing forward, the
reverse sweep over the tape and the whole backward against ``jax.vjp`` of
``pallas_goku_heads(..., interpret=True)``; the RK reverse sweep against
``jax.vjp`` of ``pallas_solve_fixed_grid_batched(..., interpret=True)``.
Inputs, weights and cotangents from numpy. The CUDA kernels follow these
plain versions step for step (tests/test_torch_cuda.py holds them to it on
the card).

Tolerances: float32 results within 1e-5 of each tensor's size (max |ref|)
of the JAX result (the same arithmetic, summed in another order); float64
results within 1e-12 of each tensor's size of PyTorch autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq import nn as jnn
from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched
from latentdiffeq.ops.recurrent_pallas import pallas_goku_heads
from latentdiffeq.solve import rk as jrk
from latentdiffeq.train.checkpoint import _path_str
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.ops import ode_cuda
from latentdiffeq_torch.ops import recurrent_cuda as rc
from latentdiffeq_torch.pendulum import pendulum_f, pendulum_friction_f
from latentdiffeq_torch.solve import rk as trk
from latentdiffeq_torch.train.checkpoint import load_jax_params

REL32 = 1e-5
REL64 = 1e-12
ACTS = {"relu": (jnn.relu, tnn.relu), "tanh": (jnn.tanh, tnn.tanh)}


def close_rel(got, ref, rel):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * scale


def heads_pair(act, D=6, H=4, L=2, seed=0):
    """JAX heads with every leaf from N(0, 0.4^2) (numpy), and the port's
    heads with the same weights."""
    ja, ta = ACTS[act]
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    jheads = (jnn.Recurrent.rnn(ks[0], D, (H,) * L, ja),
              jnn.Recurrent.lstm(ks[1], D, (H,) * L),
              jnn.Recurrent.lstm(ks[2], D, (H,) * L))
    leaves, treedef = jax.tree_util.tree_flatten(jheads)
    rng = np.random.default_rng(seed)
    jheads = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * 0.4).astype(np.float32))
        for l in leaves])
    theads = (tnn.Recurrent.rnn(D, (H,) * L, ta),
              tnn.Recurrent.lstm(D, (H,) * L),
              tnn.Recurrent.lstm(D, (H,) * L))
    for jh, th in zip(jheads, theads):
        load_jax_params(th, {_path_str(p): np.asarray(l) for p, l in
                             jax.tree_util.tree_flatten_with_path(jh)[0]})
    return jheads, theads


def heads_inputs(B, T, D, H, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, D)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32),
            rng.normal(size=(B, 2 * H)).astype(np.float32))


def jax_heads_vjp(jheads, xs, g_z0, g_th):
    """(z0, theta, dxs, [d leaf]) of the JAX Pallas kernel in interpret
    mode, through its custom_vjp."""
    leaves, treedef = jax.tree_util.tree_flatten(jheads)

    def run(x, lv):
        return pallas_goku_heads(*jax.tree_util.tree_unflatten(treedef, lv),
                                 x, interpret=True)

    (z0, th), vjp = jax.vjp(run, jnp.asarray(xs), leaves)
    dxs, dleaves = vjp((jnp.asarray(g_z0), jnp.asarray(g_th)))
    return z0, th, dxs, dleaves


@pytest.mark.parametrize("act", sorted(ACTS))
def test_goku_heads_taped_forward_matches_pallas(act):
    """The tape-writing forward gives the Pallas kernel's outputs, and its
    tape is the cells' recursion: c = f c_prev + i g, h = o tanh(c), the
    top layer's last h is the output."""
    D, H, L, B, T = 6, 4, 2, 3, 7
    jheads, theads = heads_pair(act, D, H, L)
    xs, _, _ = heads_inputs(B, T, D, H)
    z0j, thj = pallas_goku_heads(*jheads, jnp.asarray(xs), interpret=True)
    z0, th, tape = rc.goku_heads_taped_reference(*theads, torch.from_numpy(xs))
    close_rel(z0, z0j, REL32)
    close_rel(th, thj, REL32)
    toff, rec, _, _ = rc.heads_layout(H, L)
    assert tape.shape == (B, T, rec) == (B, T, 13 * H * L)
    torch.testing.assert_close(tape[:, -1, toff[0][L - 1]:][:, :H], z0,
                               rtol=0, atol=0)
    for s in (1, 2):
        cell = theads[s].cells[0]
        i, f, g, o, c, h = (tape[..., toff[s][0] + k * H:
                                 toff[s][0] + (k + 1) * H] for k in range(6))
        c_prev = torch.cat([cell.c0.detach().expand(B, 1, H), c[:, :-1]], 1)
        torch.testing.assert_close(c, f * c_prev + i * g, rtol=0, atol=1e-6)
        torch.testing.assert_close(h, o * torch.tanh(c), rtol=0, atol=1e-6)
        top = tape[:, -1, toff[s][L - 1] + 5 * H:toff[s][L - 1] + 6 * H]
        torch.testing.assert_close(top, th[:, (s - 1) * H:s * H], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("act", sorted(ACTS))
def test_goku_heads_sweep_matches_jax_vjp(act):
    """The plain sweep over the tape: its dgates summed over rows and steps
    are the biases' gradients, its carries at t = -1 summed over rows the
    initial states' gradients, as jax.vjp of the Pallas kernel gives them."""
    D, H, L, B, T = 6, 4, 2, 3, 7
    jheads, theads = heads_pair(act, D, H, L, seed=2)
    xs, gz, gt = heads_inputs(B, T, D, H, seed=3)
    _, _, _, dleaves = jax_heads_vjp(jheads, xs, gz, gt)
    tape = rc.goku_heads_taped_reference(*theads, torch.from_numpy(xs))[2]
    dg, dh0, dc0 = rc.goku_heads_sweep_reference(
        *theads, tape, torch.from_numpy(gz), torch.from_numpy(gt))
    _, _, goff, grec = rc.heads_layout(H, L)
    assert dg.shape == (B, T, grec) and dh0.shape == (B, 3, L, H)
    params = rc._heads_params(*theads)
    ref = dict(zip([id(p) for p in params], dleaves))
    for s, head in enumerate(theads):
        G = H if s == 0 else 4 * H
        for l, cell in enumerate(head.cells):
            close_rel(dg[..., goff[s][l]:goff[s][l] + G].sum(dim=(0, 1)),
                      ref[id(cell.b)], REL32)
            close_rel(dh0[:, s, l].sum(dim=0), ref[id(cell.h0)], REL32)
            if s:
                close_rel(dc0[:, s, l].sum(dim=0), ref[id(cell.c0)], REL32)
    assert float(dc0[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("L", [1, 2])
def test_goku_heads_backward_matches_jax_vjp(act, L):
    """The whole plain backward (sweep + products) against jax.vjp of the
    Pallas kernel, for xs and every head tensor."""
    D, H, B, T = 6, 4, 3, 7
    jheads, theads = heads_pair(act, D, H, L, seed=4)
    xs, gz, gt = heads_inputs(B, T, D, H, seed=5)
    _, _, dxs_j, dleaves = jax_heads_vjp(jheads, xs, gz, gt)
    xt = torch.from_numpy(xs)
    tape = rc.goku_heads_taped_reference(*theads, xt)[2]
    dxs, dparams = rc.goku_heads_backward_reference(
        *theads, xt, tape, torch.from_numpy(gz), torch.from_numpy(gt))
    close_rel(dxs, dxs_j, REL32)
    assert len(dparams) == len(dleaves)
    for got, ref in zip(dparams, dleaves):
        close_rel(got, ref, REL32)


@pytest.mark.parametrize("act", ["relu", "tanh", "identity"])
@pytest.mark.parametrize("L", [1, 3])
def test_goku_heads_backward_float64_matches_autograd(act, L):
    D, H, B, T = 5, 3, 4, 6
    g = torch.Generator().manual_seed(L)
    a = getattr(tnn, act)
    heads = tuple(h.double() for h in (tnn.Recurrent.rnn(D, (H,) * L, a),
                                       tnn.Recurrent.lstm(D, (H,) * L),
                                       tnn.Recurrent.lstm(D, (H,) * L)))
    params = rc._heads_params(*heads)
    with torch.no_grad():
        for p in params:
            p.copy_(torch.randn(p.shape, generator=g, dtype=p.dtype) * 0.5)
    xs = torch.randn(B, T, D, generator=g, dtype=torch.float64)
    gz = torch.randn(B, H, generator=g, dtype=torch.float64)
    gt = torch.randn(B, 2 * H, generator=g, dtype=torch.float64)
    tape = rc.goku_heads_taped_reference(*heads, xs)[2]
    got = rc.goku_heads_backward_reference(*heads, xs, tape, gz, gt)
    x = xs.clone().requires_grad_()
    z0, th = rc.goku_heads_reference(*heads, x)
    ref = torch.autograd.grad((z0, th), [x] + params, (gz, gt))
    for a_, b_ in zip([got[0]] + got[1], ref):
        close_rel(a_, b_.numpy(), REL64)


def _heads_from_packed(buf, D, H, L, act):
    """Heads at widths (D, H) whose parameters are read from a packed
    buffer in the order of ``_heads_params``."""
    heads = (tnn.Recurrent.rnn(D, (H,) * L, act),
             tnn.Recurrent.lstm(D, (H,) * L),
             tnn.Recurrent.lstm(D, (H,) * L))
    off = 0
    with torch.no_grad():
        for p in rc._heads_params(*heads):
            p.copy_(buf[off:off + p.numel()].view(p.shape))
            off += p.numel()
    assert off == buf.numel()
    return heads


def test_goku_heads_narrow_heads_run_at_the_kernel_widths():
    """Heads narrower than the kernels' compiled widths (32, 16) run in them
    with zero-padded weights: the padded heads give the same outputs, their
    extra units stay 0, and the products read the gradients of the real
    heads out of the padded tape and dgates."""
    D, H, L, B, T = 10, 8, 2, 3, 6
    _, theads = heads_pair("relu", D, H, L, seed=6)
    buf = rc.pack_goku_heads(*theads, rc.KERNEL_D, rc.KERNEL_H)
    wide = _heads_from_packed(buf, rc.KERNEL_D, rc.KERNEL_H, L, tnn.relu)
    xs, gz, gt = (torch.from_numpy(a) for a in heads_inputs(B, T, D, H, 7))
    xs_wide = torch.cat([xs, xs.new_zeros(B, T, rc.KERNEL_D - D)], dim=-1)
    z0w, thw, tape_w = rc.goku_heads_taped_reference(*wide, xs_wide)
    z0, th, tape = rc.goku_heads_taped_reference(*theads, xs)
    Hk = rc.KERNEL_H
    torch.testing.assert_close(z0w[:, :H], z0, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        torch.cat([thw[:, :H], thw[:, Hk:Hk + H]], -1), th, rtol=0,
        atol=1e-6)
    assert float(z0w[:, H:].abs().max()) == 0.0
    pad = gz.new_zeros(B, Hk - H)
    dg, dh0, dc0 = rc.goku_heads_sweep_reference(
        *wide, tape_w, torch.cat([gz, pad], -1),
        torch.cat([gt[:, :H], pad, gt[:, H:], pad], -1))
    got = rc.goku_heads_param_grads(*theads, xs, tape_w, dg, dh0, dc0)
    ref = rc.goku_heads_backward_reference(*theads, xs, tape, gz, gt)
    for a, b in zip([got[0]] + got[1], [ref[0]] + ref[1]):
        close_rel(a, b.numpy(), REL32)


@pytest.mark.parametrize("D,H,want", [(10, 8, (32, 16)), (32, 16, (32, 16)),
                                      (64, 16, (64, 16)), (24, 40, (24, 40)),
                                      (64, 32, (64, 32))])
def test_kernel_widths(D, H, want):
    """Heads that fit the compiled widths run there zero-padded; any wider
    input or hidden width runs at the heads' own widths."""
    assert rc.kernel_widths(D, H) == want


def test_backward_kernel_entry_points_refuse_cpu():
    _, theads = heads_pair("relu", 6, 4, 2)
    with pytest.raises(ValueError):      # a CPU tensor never reaches them
        rc.goku_heads_bwd_cuda(*theads, torch.zeros(2, 3, 416),
                               torch.zeros(2, 4), torch.zeros(2, 8))
    u0s, ps, saveat = torch.zeros(2, 2), torch.ones(2, 1), torch.arange(3.)
    with pytest.raises(ValueError):
        ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            pendulum_f, trk.Tsit5(), saveat, torch.zeros(2, 3, 2), ps,
            torch.zeros(2, 3, 2))


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def jpend_friction(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0]) - 0.7 * u[1]])


RHS = {"pendulum": (jpend, pendulum_f),
       "friction": (jpend_friction, pendulum_friction_f)}


@pytest.mark.parametrize("rhs", sorted(RHS))
@pytest.mark.parametrize("solver", ["Tsit5", "RK4"])
@pytest.mark.parametrize("substeps", [1, 3])
def test_rk_reverse_sweep_matches_jax_vjp(rhs, solver, substeps):
    """The plain RK reverse sweep, from the plain forward's trajectory,
    against jax.vjp of the Pallas kernel (its custom_vjp)."""
    rng = np.random.default_rng(8)
    B, T = 5, 12
    u0s = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (B, 1)).astype(np.float32)
    saveat = (np.arange(T) * 0.05).astype(np.float32)
    g = rng.normal(size=(B, T, 2)).astype(np.float32)
    jf, tf = RHS[rhs]

    def run(u, p):
        return pallas_solve_fixed_grid_batched(
            jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
            substeps=substeps, interpret=True)[0]

    _, vjp = jax.vjp(run, jnp.asarray(u0s), jnp.asarray(ps))
    du0_j, dp_j = vjp(jnp.asarray(g))
    s = getattr(trk, solver)()
    ys = ode_cuda.solve_fixed_grid_batched_reference(
        tf, s, torch.from_numpy(u0s), torch.from_numpy(ps),
        torch.from_numpy(saveat), substeps=substeps)[0]
    du0, dp = ode_cuda.solve_fixed_grid_batched_backward_reference(
        tf, s, torch.from_numpy(saveat), ys, torch.from_numpy(ps),
        torch.from_numpy(g), substeps=substeps)
    close_rel(du0, du0_j, REL32)
    close_rel(dp, dp_j, REL32)


@pytest.mark.parametrize("solver", ["Euler", "Midpoint", "RK4", "Tsit5",
                                    "Dopri5"])
def test_rk_reverse_sweep_float64_matches_autograd(solver):
    g = torch.Generator().manual_seed(9)
    u0s = torch.rand(4, 2, generator=g, dtype=torch.float64) * 2 - 1
    ps = 1 + torch.rand(4, 1, generator=g, dtype=torch.float64)
    saveat = torch.arange(9, dtype=torch.float64) * 0.05
    s = getattr(trk, solver)()
    for f in (pendulum_f, pendulum_friction_f):
        u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
        ys = ode_cuda.solve_fixed_grid_batched_reference(f, s, u, p, saveat,
                                                         substeps=2)[0]
        w = torch.randn(ys.shape, generator=g, dtype=torch.float64)
        ref = torch.autograd.grad(ys, [u, p], w)
        got = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, saveat, ys, ps, w, substeps=2)
        for a, b in zip(got, ref):
            close_rel(a, b.numpy(), REL64)
