"""The port's gradient modes against the JAX package's, on the CPU:
``InterpolatingAdjoint`` and ``BacksolveAdjoint`` (with and without the
state reset) over fixed-grid and adaptive forwards, with adaptive and fixed
backward re-solves, a per-row parameter tensor and a neural field (an
``nn.Module``, as the port's LatentODE passes ``de.dudt``) as ``p``; the
batched rows against JAX's vmapped per-trajectory adjoint; and NaN
isolation between rows.

In float64, where both packages take the same adaptive steps, every
gradient agrees with JAX's to 1e-9 of its size: the backward re-solves and
the augmented backsolve, whose error norms run over each row's (y, a, a_p),
step exactly as the JAX solves do only if each row keeps its own parameter
adjoint. The float32 fixed-grid cases hold the checkpointed modes to the
unrolled gradients exactly and the backsolve to JAX at 1e-5 of each
gradient's size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import latentdiffeq as ldq
from latentdiffeq import nn as jnn
import latentdiffeq_torch as ldt
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.models import NODE
from latentdiffeq_torch.pendulum import pendulum_f


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jpend(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def t_(a):
    return torch.from_numpy(np.array(a))


FIXED = dict(adaptive=False, substeps=4)
ADAPTIVE = dict(rtol=1e-6, atol=1e-9)
MODES = {
    "interp": (ldq.InterpolatingAdjoint(), ldt.InterpolatingAdjoint()),
    "interp-fixed-bwd": (ldq.InterpolatingAdjoint(adaptive=False),
                         ldt.InterpolatingAdjoint(adaptive=False)),
    "backsolve": (ldq.BacksolveAdjoint(), ldt.BacksolveAdjoint()),
    "backsolve-fixed-bwd": (ldq.BacksolveAdjoint(adaptive=False),
                            ldt.BacksolveAdjoint(adaptive=False)),
    "backsolve-no-reset": (ldq.BacksolveAdjoint(checkpointing=False),
                           ldt.BacksolveAdjoint(checkpointing=False)),
}


def pendulum_inputs(B=3, T=25, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, 2)).astype(dtype),
            rng.uniform(1, 2, (B, 1)).astype(dtype),
            (np.arange(T) * 0.05).astype(dtype),
            rng.normal(size=(B, T, 2)).astype(dtype))


def jax_grads(jf, u0s, p, saveat, w, opts, sensealg, p_axis=0):
    def loss(u, pp):
        ys, _, _ = jax.vmap(lambda a, b: ldq.odeint(
            jf, ldq.Tsit5(), a, b, jnp.asarray(saveat), opts, sensealg),
            in_axes=(0, p_axis))(u, pp)
        return jnp.sum(ys * w), ys

    (_, ys), g = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u0s), p)
    return np.asarray(ys), g


def rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.detach().numpy() - b).max()) / max(
        float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("forward", ["fixed", "adaptive"])
@pytest.mark.parametrize("mode", list(MODES))
def test_adjoint_gradients_match_jax(mode, forward):
    """Per-row parameters (B, 1), float64: ys and the gradients of a
    weighted sum with respect to u0s and ps, against jax.grad through the
    vmapped JAX odeint with the same mode."""
    jsa, tsa = MODES[mode]
    kw = FIXED if forward == "fixed" else ADAPTIVE
    u0s, ps, saveat, w = pendulum_inputs()
    with jax.enable_x64(True):
        ys_j, (gu_j, gp_j) = jax_grads(jpend, u0s, jnp.asarray(ps), saveat,
                                       w, ldq.make_options(**kw), jsa)
        gu_j, gp_j = np.asarray(gu_j), np.asarray(gp_j)
    u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
    ys, ok, _ = ldt.odeint(pendulum_f, ldt.Tsit5(), u, p, t_(saveat),
                           ldt.make_options(**kw), tsa)
    assert bool(ok.all())
    assert rel(ys, ys_j) <= 1e-12
    gu, gp = torch.autograd.grad((ys * t_(w)).sum(), [u, p])
    assert rel(gu, gu_j) <= 1e-9 and rel(gp, gp_j) <= 1e-9


@pytest.mark.parametrize("mode", ["unrolled-checkpoint", "interp",
                                  "backsolve"])
def test_fixed_grid_float32_modes(mode):
    """Float32 on the fixed grid: the checkpointed unrolled solve and the
    interpolating adjoint (which is that solve, odeint.py:233-237) give the
    unrolled gradients bit for bit; the backsolve matches JAX's backsolve
    to 1e-5 of each gradient's size."""
    u0s, ps, saveat, w = pendulum_inputs(dtype=np.float32)
    opts = ldt.make_options(**FIXED)

    def grads(sa):
        u, p = t_(u0s).requires_grad_(), t_(ps).requires_grad_()
        ys = ldt.odeint(pendulum_f, ldt.Tsit5(), u, p, t_(saveat), opts,
                        sa)[0]
        return torch.autograd.grad((ys * t_(w)).sum(), [u, p])

    ref = grads(ldt.Unrolled())
    if mode == "backsolve":
        _, gj = jax_grads(jpend, u0s, jnp.asarray(ps), saveat, w,
                          ldq.make_options(**FIXED), ldq.BacksolveAdjoint())
        for a, b in zip(grads(ldt.BacksolveAdjoint()), gj):
            assert rel(a, b) <= 1e-5
        return
    sa = (ldt.Unrolled(checkpoint=True) if mode == "unrolled-checkpoint"
          else ldt.InterpolatingAdjoint())
    for a, b in zip(grads(sa), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def field_pair(dim=3, hidden=8, seed=0):
    """A NODE field (tanh, float64) in the port and the same weights in a
    JAX nn.mlp (made under jax.enable_x64, which the caller holds)."""
    node = NODE(dim, hidden_dim=hidden, activation=tnn.tanh, device="cpu",
                dtype=torch.float64,
                generator=torch.Generator().manual_seed(seed))
    net = jnn.mlp(jax.random.PRNGKey(0), (dim, hidden, hidden, dim),
                  jnn.tanh, dtype=jnp.float64)
    leaves, treedef = jax.tree_util.tree_flatten(net)
    net = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(q.detach().numpy()) for q in node.dudt.parameters()])
    assert len(leaves) == len(list(node.dudt.parameters()))
    assert all(x.dtype == jnp.float64 for x in jax.tree_util.tree_leaves(net))
    return node.dudt, net


@pytest.mark.parametrize("forward", ["fixed", "adaptive"])
@pytest.mark.parametrize("mode", ["interp", "backsolve",
                                  "backsolve-fixed-bwd"])
def test_neural_field_parameters_match_jax(mode, forward):
    """``p`` a neural field shared by the rows, as the port's LatentODE
    passes ``de.dudt``: the gradients reach the module's parameters (the
    Function takes them as inputs) and equal JAX's, whose vmap sums the
    rows' parameter adjoints; the backsolve integrates each row's own."""
    jsa, tsa = MODES[mode]
    kw = FIXED if forward == "fixed" else ADAPTIVE
    rng = np.random.default_rng(1)
    u0s = rng.normal(size=(3, 3))
    saveat = np.arange(12) * 0.1
    w = rng.normal(size=(3, 12, 3))
    with jax.enable_x64(True):
        dudt, net = field_pair()
        _, (gu_j, gp_j) = jax_grads(lambda u, p, t: p(u[None, :])[0], u0s,
                                    net, saveat, w, ldq.make_options(**kw),
                                    jsa, p_axis=None)
        gu_j = np.asarray(gu_j)
        gp_j = [np.asarray(g) for g in jax.tree_util.tree_leaves(gp_j)]
    u = t_(u0s).requires_grad_()
    ys, ok, _ = ldt.odeint(lambda y, p, t: p(y), ldt.Tsit5(), u, dudt,
                           t_(saveat), ldt.make_options(**kw), tsa)
    g = torch.autograd.grad((ys * t_(w)).sum(), [u] + list(dudt.parameters()))
    assert rel(g[0], gu_j) <= 1e-9
    for a, b in zip(g[1:], gp_j):
        assert rel(a, b) <= 1e-9


def blowup_f(u, p, t):
    return u * u * p[..., 0:1]


@pytest.mark.parametrize("mode", ["interp", "backsolve"])
def test_nan_in_one_row_does_not_reach_the_others(mode):
    """Row 1 blows up (u' = 3 u^2 from 2, at t = 1/6) and fails; with a
    masked loss the other rows' gradients are finite and equal those of a
    batch without the failing row, and JAX's for the same rows."""
    jsa, tsa = MODES[mode]
    u0s = np.array([[0.1], [2.0], [0.15]])
    ps = np.full((3, 1), 3.0)
    saveat = np.linspace(0.0, 2.0, 10)
    opts = dict(max_steps=64, rtol=1e-6, atol=1e-9)

    def grads(rows):
        u, p = t_(u0s[rows]).requires_grad_(), t_(ps[rows]).requires_grad_()
        ys, ok, _ = ldt.odeint(blowup_f, ldt.Tsit5(), u, p, t_(saveat),
                               ldt.make_options(**opts), tsa)
        per = torch.where(ok, (ys ** 2).mean(dim=(1, 2)),
                          torch.zeros_like(ok, dtype=ys.dtype))
        return ok, torch.autograd.grad(per.sum(), [u, p])

    ok, (gu, gp) = grads([0, 1, 2])
    assert ok.tolist() == [True, False, True]
    _, (gu2, gp2) = grads([0, 2])
    good = [0, 2]
    assert bool(torch.isfinite(gu[good]).all())
    assert bool(torch.isfinite(gp[good]).all())
    torch.testing.assert_close(gu[good], gu2, rtol=1e-12, atol=0)
    torch.testing.assert_close(gp[good], gp2, rtol=1e-12, atol=0)

    def jloss(u, p):
        ys, ok, _ = jax.vmap(lambda a, b: ldq.odeint(
            lambda y, q, t: y * y * q[0], ldq.Tsit5(), a, b,
            jnp.asarray(saveat), ldq.make_options(**opts), jsa))(u, p)
        per = jnp.where(ok, jnp.mean(ys ** 2, axis=(1, 2)), 0.0)
        return jnp.sum(per)

    with jax.enable_x64(True):
        gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0s[good]),
                                             jnp.asarray(ps[good]))
        gj = [np.asarray(g) for g in gj]
    assert rel(gu2, gj[0]) <= 1e-9 and rel(gp2, gj[1]) <= 1e-9


def test_adjoints_take_a_single_trajectory_and_refuse_other_parameters():
    """A u0 without a batch axis (as the JAX odeint takes it), and p of a
    type the adjoint cannot differentiate raises."""
    u0s, ps, saveat, w = pendulum_inputs(B=1)
    u, p = t_(u0s[0]).requires_grad_(), t_(ps[0]).requires_grad_()
    ys = ldt.odeint(pendulum_f, ldt.Tsit5(), u, p, t_(saveat),
                    ldt.make_options(**ADAPTIVE), ldt.BacksolveAdjoint())[0]
    assert ys.shape == (25, 2)
    gu, gp = torch.autograd.grad((ys * t_(w[0])).sum(), [u, p])
    with jax.enable_x64(True):
        gj = jax.grad(lambda a, b: jnp.sum(ldq.odeint(
            jpend, ldq.Tsit5(), a, b, jnp.asarray(saveat),
            ldq.make_options(**ADAPTIVE), ldq.BacksolveAdjoint())[0] * w[0]),
            argnums=(0, 1))(jnp.asarray(u0s[0]), jnp.asarray(ps[0]))
    assert rel(gu, gj[0]) <= 1e-9 and rel(gp, gj[1]) <= 1e-9
    with pytest.raises(TypeError):
        ldt.odeint(pendulum_f, ldt.Tsit5(), u, (p,), t_(saveat),
                   ldt.make_options(**ADAPTIVE), ldt.BacksolveAdjoint())
