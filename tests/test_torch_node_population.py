"""LatentODE populations through the neural-field solve's Function
(``latentdiffeq_torch.ops.node_cuda._NodeSolveFn``) under
``torch.func.vmap``, on the CPU, where the Function runs the kernels'
plain versions.

- a ``MultiSeedTrainer`` step of three tiny ``LatentODE(use_kernel_solve=
  True)`` models (NODE(4), field 4-16-16-4, 24 pixels; B 3, T 8) against
  JAX's ``jax.vmap`` of ``loss_batch`` over the same three weight sets with
  ``LatentODE(use_pallas_solve=True)``, the Pallas kernels in interpret
  mode: each replica's loss within 1e-5 (float32 sums of 24 pixels x 3 x 8
  frames through a 16-wide resnet, in another order) and every gradient
  within 1e-5 of its size (at least 1), the pins of
  tests/test_torch_multiseed.py's population test tightened to this model's
  size; the Function's vmap rule makes one call of each plain version (the
  taped forward, the sweep and the weight-gradient product) with the
  replica axis, where the card launches the weight-gradient kernel once;
- the plain versions with a replica axis against one call a replica, bit
  for bit (they loop over the replicas);
- a solo call unchanged: the Function's result and gradients equal the
  plain versions' chain bit for bit, as they did before the vmap rule;
- replicas with a grid each raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from latentdiffeq import make_options
from latentdiffeq.models import LatentDiffEqModel as JModel
from latentdiffeq.models import LatentODE as JLatentODE
from latentdiffeq.models import NODE as JNODE
from latentdiffeq.models import default_layers as jdefault_layers
from latentdiffeq.train import losses as jlosses
from latentdiffeq.train.checkpoint import _path_str
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.models import (LatentDiffEqModel, LatentODE, NODE,
                                       latent_ode_default_layers)
from latentdiffeq_torch.ops import node_cuda
from latentdiffeq_torch.solve import rk as trk
from latentdiffeq_torch.train import MultiSeedTrainer, TrainConfig
from latentdiffeq_torch.train.checkpoint import load_jax_params

S, B, T, PIX = 3, 3, 8, 24
BETA = 0.4
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5   # of each gradient's size (at least 1)


def pair(seed):
    """The same tiny LatentODE in both packages, every weight drawn from
    N(0, 0.25^2) with numpy; both on their kernel solve."""
    k = jax.random.PRNGKey(seed)
    kn, kl = jax.random.split(k)
    jmt = JLatentODE(use_pallas_solve=True)
    jnode = JNODE(kn, 4, hidden_dim=16,
                  options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(kl, jmt, PIX, jnode, hidden_dim_resnet=16,
                               rnn_input_dim=8, rnn_output_dim=8)
    jm = JModel.build(jmt, enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * 0.25).astype(np.float32))
        for l in leaves])
    node = NODE(4, hidden_dim=16,
                options=SolveOptions(adaptive=False, substeps=1),
                device="cpu")
    tenc, tdec = latent_ode_default_layers(
        PIX, node, hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8,
        device="cpu")
    tm = LatentDiffEqModel.build(LatentODE(use_kernel_solve=True), tenc,
                                 tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


def spy(monkeypatch, name, calls):
    """Record, for each call of node_cuda.``name``, whether its first
    tensor argument carries a replica axis."""
    fn = getattr(node_cuda, name)
    # the argument that carries the replica axis, and its dimensions then
    arg, dims = {"solve_neural_field_taped_reference": (2, 3),
                 "neural_field_sweep_reference": (4, 4),
                 "neural_field_dw_reference": (1, 5)}[name]

    def wrapped(*args, **kw):
        calls.setdefault(name, []).append(args[arg].dim() == dims)
        return fn(*args, **kw)

    monkeypatch.setattr(node_cuda, name, wrapped)


@pytest.fixture(scope="module")
def population():
    """(JAX's vmapped losses and gradients, the port's population, its
    inputs): one JAX compile for the module."""
    pairs = [pair(s) for s in range(S)]
    jms = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                 *[p[0] for p in pairs])
    x = np.random.default_rng(5).uniform(0, 1, (S, B, T, PIX)).astype(
        np.float32)
    t = (np.arange(T) * 0.05).astype(np.float32)

    def lf(m, xx):
        return jlosses.loss_batch(m, xx, jnp.asarray(t), BETA,
                                  variational=False)

    (lj, _), gj = jax.jit(jax.vmap(jax.value_and_grad(lf, has_aux=True)))(
        jms, jnp.asarray(x))
    return (np.asarray(lj), [np.asarray(g) for g in
                             jax.tree_util.tree_leaves(gj)],
            [p[1] for p in pairs], x)


def test_population_step_matches_jax_vmapped_pallas_kernels(population,
                                                            monkeypatch):
    """A population step of three LatentODE(use_kernel_solve=True)
    replicas: the Function's vmap rule (one call of each plain version for
    all replicas) against JAX's vmapped Pallas route: loss and every
    gradient."""
    lj, gj, models, x = population
    calls = {}
    for name in ("solve_neural_field_taped_reference",
                 "neural_field_sweep_reference", "neural_field_dw_reference"):
        spy(monkeypatch, name, calls)
    ms = MultiSeedTrainer(lambda s: models[s], TrainConfig(
        lr=1e-3, decay=1e-4, batch_size=B, seq_len=T, save_best=False,
        variational=False), list(range(S)), device="cpu")
    m = ms.train_step(torch.from_numpy(x), BETA)
    # one call with the replica axis each (it runs the replicas in turn)
    assert {k: v.count(True) for k, v in calls.items()} == {
        "solve_neural_field_taped_reference": 1,
        "neural_field_sweep_reference": 1, "neural_field_dw_reference": 1}
    assert all(v[0] for v in calls.values())
    np.testing.assert_allclose(m["loss"].numpy(), lj, rtol=0,
                               atol=LOSS_ATOL)
    grads = [p.grad for p in ms.params.values()]
    assert len(grads) == len(gj)
    for got, ref in zip(grads, gj):
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0,
                                   atol=GRAD_ATOL)
    # validation runs the untaped forward once for the population
    calls.clear()
    val = ms.val_step(torch.from_numpy(x[0]), BETA)
    assert calls == {} and bool(torch.isfinite(val["loss"]).all())


def fields(S_, dims=(4, 16, 16, 4), act=tnn.tanh):
    out = []
    for s in range(S_):
        m = tnn.mlp(dims, act, tnn.identity,
                    generator=torch.Generator().manual_seed(s))
        with torch.no_grad():
            for lyr in m.layers:
                lyr.b.copy_(torch.randn(lyr.b.shape, generator=torch
                                        .Generator().manual_seed(10 + s)))
        out.append(m)
    return out


def stacked(ms):
    """A _Field whose tensors carry the replica axis."""
    f = node_cuda.dense_stack(ms[0])
    L = len(f.Ws)
    return f._replace(
        Ws=[torch.stack([m.layers[i].W.detach() for m in ms])
            for i in range(L)],
        bs=[torch.stack([m.layers[i].b.detach() for m in ms])
            for i in range(L)])


@pytest.mark.parametrize("solver,substeps", [("Tsit5", 1), ("RK4", 2)])
def test_plain_versions_with_replica_axis_equal_per_replica_calls(
        solver, substeps):
    ms = fields(3)
    f = stacked(ms)
    sv = getattr(trk, solver)()
    g = torch.Generator().manual_seed(1)
    u0s = torch.randn(3, 5, 4, generator=g) * 0.4
    saveat = torch.arange(6, dtype=torch.float32) * 0.1
    w = torch.randn(3, 5, 6, 4, generator=g)
    ys, tape = node_cuda.solve_neural_field_taped_reference(
        f, sv, u0s, saveat, substeps=substeps)
    du0, delta = node_cuda.neural_field_sweep_reference(
        f, sv, saveat, tape, w, substeps=substeps)
    dWs, dbs = node_cuda.neural_field_dw_reference(f, tape, delta)
    ys_u = node_cuda.solve_neural_field_reference(f, sv, u0s, saveat,
                                                  substeps=substeps)[0]
    assert tape.shape[:2] == (3, 5) and delta.shape[:2] == (3, 5)
    assert dWs[1].shape == (3, 16, 16) and dbs[2].shape == (3, 4)
    for s, m in enumerate(ms):
        y1, t1 = node_cuda.solve_neural_field_taped_reference(
            m, sv, u0s[s], saveat, substeps=substeps)
        d1, de1 = node_cuda.neural_field_sweep_reference(
            m, sv, saveat, t1, w[s], substeps=substeps)
        W1, b1 = node_cuda.neural_field_dw_reference(m, t1, de1)
        assert torch.equal(ys[s], y1) and torch.equal(tape[s], t1)
        assert torch.equal(ys_u[s], y1)
        assert torch.equal(du0[s], d1) and torch.equal(delta[s], de1)
        assert all(torch.equal(a[s], b) for a, b in zip(dWs + dbs, W1 + b1))


@pytest.mark.parametrize("backward", ["kernel", "autograd"])
def test_field_under_vmap_equals_solo_calls(backward):
    """torch.func.vmap of solve_neural_field over three fields: ys and
    every gradient equal three solo calls bit for bit, for both backward
    routes."""
    ms = fields(3)
    f = stacked(ms)
    g = torch.Generator().manual_seed(2)
    u0s = torch.randn(3, 5, 4, generator=g) * 0.4
    saveat = torch.arange(7, dtype=torch.float32) * 0.1
    w = torch.randn(3, 5, 7, 4, generator=g)
    wb = [t.clone().requires_grad_() for pair in zip(f.Ws, f.bs)
          for t in pair]
    u = u0s.clone().requires_grad_()
    base = node_cuda.dense_stack(ms[0])

    def one(u0, *ts):
        fld = base._replace(Ws=list(ts[0::2]), bs=list(ts[1::2]))
        return node_cuda.solve_neural_field(fld, trk.Tsit5(), u0, saveat,
                                            backward=backward)[0]

    ys = vmap(one)(u, *wb)
    (ys * w).sum().backward()
    for s, m in enumerate(ms):
        us = u0s[s].clone().requires_grad_()
        y = node_cuda.solve_neural_field(m, trk.Tsit5(), us, saveat,
                                         backward=backward)[0]
        (y * w[s]).sum().backward()
        assert torch.equal(ys[s].detach(), y.detach())
        assert torch.equal(u.grad[s], us.grad)
        mine = [t for lyr in m.layers for t in (lyr.W, lyr.b)]
        assert all(torch.equal(a.grad[s], b.grad) for a, b in zip(wb, mine))


def test_solo_call_is_the_plain_versions_chain():
    """A solo call's ys and gradients are the taped forward, the sweep and
    the weight-gradient product of the plain versions, bit for bit."""
    m = fields(1, act=tnn.relu)[0]
    g = torch.Generator().manual_seed(3)
    u0s = torch.randn(6, 4, generator=g) * 0.4
    saveat = torch.arange(9, dtype=torch.float32) * 0.05
    w = torch.randn(6, 9, 4, generator=g)
    u = u0s.clone().requires_grad_()
    ys, ok, st = node_cuda.solve_neural_field(m, trk.Tsit5(), u, saveat)
    (ys * w).sum().backward()
    ys_p, tape = node_cuda.solve_neural_field_taped_reference(
        m, trk.Tsit5(), u0s, saveat)
    du0, delta = node_cuda.neural_field_sweep_reference(m, trk.Tsit5(),
                                                        saveat, tape, w)
    dWs, dbs = node_cuda.neural_field_dw_reference(m, tape, delta)
    assert torch.equal(ys.detach(), ys_p) and bool(ok.all())
    assert torch.equal(u.grad, du0)
    for lyr, dW, db in zip(m.layers, dWs, dbs):
        assert torch.equal(lyr.W.grad, dW) and torch.equal(lyr.b.grad, db)
    assert int(st["n_rhs_evals"][0]) == 8 * 6
    # without a gradient the untaped plain solve runs
    with torch.no_grad():
        ys_n = node_cuda.solve_neural_field(m, trk.Tsit5(), u0s, saveat)[0]
    assert torch.equal(ys_n, node_cuda.solve_neural_field_reference(
        m, trk.Tsit5(), u0s, saveat)[0])


def test_a_grid_per_replica_raises():
    ms = fields(2)
    f = stacked(ms)
    base = node_cuda.dense_stack(ms[0])
    u0s = torch.zeros(2, 3, 4)
    grids = torch.arange(10, dtype=torch.float32).reshape(2, 5) * 0.1

    def one(u0, sv, *ts):
        fld = base._replace(Ws=list(ts[0::2]), bs=list(ts[1::2]))
        return node_cuda.solve_neural_field(fld, trk.Tsit5(), u0, sv)[0]

    wb = [t for pair in zip(f.Ws, f.bs) for t in pair]
    with pytest.raises(ValueError, match="share one saveat"):
        vmap(one)(u0s, grids, *wb)
