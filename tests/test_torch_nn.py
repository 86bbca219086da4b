"""Parity of the PyTorch port's nn layers and the GOKU-heads kernel's plain
version against the JAX package, on the CPU at small sizes. Weights are
drawn with numpy, placed in the JAX modules, and copied into the port
through its weight bridge (`load_jax_params`). Tolerances: float32, atol
1e-5 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq import nn as jnn
from latentdiffeq.ops.recurrent_pallas import pallas_goku_heads
from latentdiffeq.train.checkpoint import _path_str
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.ops import recurrent_cuda
from latentdiffeq_torch.train.checkpoint import load_jax_params

ATOL = 1e-5


def randomize(tree, rng, scale=0.4):
    """The same tree with every leaf redrawn from N(0, scale^2)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])


def jax_arrays(tree):
    return {_path_str(p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(t, a, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol)


ACTS = {"relu": (jnn.relu, tnn.relu), "softplus": (jnn.softplus, tnn.softplus),
        "sigmoid": (jnn.sigmoid, tnn.sigmoid), "tanh": (jnn.tanh, tnn.tanh),
        "identity": (jnn.identity, tnn.identity)}


def test_kaiming_uniform_flux_bound():
    g = torch.Generator().manual_seed(0)
    w = tnn.default_init((400, 50), generator=g)
    bound = 1 / np.sqrt(400)          # sqrt(3) * (1/sqrt(3)) / sqrt(fan_in)
    assert w.shape == (400, 50) and w.dtype == torch.float32
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.99 * bound
    assert abs(float(w.mean())) < 0.05 * bound
    d = tnn.Dense(7, 3, generator=g)
    assert d.W.shape == (7, 3) and bool((d.b == 0).all())


@pytest.mark.parametrize("act", sorted(ACTS))
def test_dense_matches_jax(act):
    rng = np.random.default_rng(0)
    ja, ta = ACTS[act]
    jd = randomize(jnn.Dense.init(jax.random.PRNGKey(0), 6, 5, ja), rng)
    td = load_jax_params(tnn.Dense(6, 5, ta), jax_arrays(jd))
    x = rng.normal(size=(3, 4, 6)).astype(np.float32)
    close(td(torch.from_numpy(x)), jd(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlp", "resnet_mlp"])
def test_mlp_and_resnet_match_jax(kind):
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(1)
    if kind == "mlp":
        jm = jnn.mlp(key, (6, 12, 12, 3), jnn.relu, jnn.softplus)
        tm = tnn.mlp((6, 12, 12, 3), tnn.relu, tnn.softplus)
    else:
        jm = jnn.resnet_mlp(key, 6, 12, 3, jnn.relu, jnn.sigmoid)
        tm = tnn.resnet_mlp(6, 12, 3, tnn.relu, tnn.sigmoid)
    jm = randomize(jm, rng)
    load_jax_params(tm, jax_arrays(jm))
    x = rng.normal(size=(5, 6)).astype(np.float32)
    close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))


def _stacks(D=10, H=8):
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    jheads = (jnn.Recurrent.rnn(ks[0], D, (H, H), jnn.relu),
              jnn.Recurrent.lstm(ks[1], D, (H, H)),
              jnn.Recurrent.lstm(ks[2], D, (H, H)))
    theads = (tnn.Recurrent.rnn(D, (H, H), tnn.relu),
              tnn.Recurrent.lstm(D, (H, H)),
              tnn.Recurrent.lstm(D, (H, H)))
    return jheads, theads


@pytest.mark.parametrize("cell", ["rnn", "lstm"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_recurrent_matches_jax(cell, reverse, masked):
    rng = np.random.default_rng(3)
    jheads, theads = _stacks()
    i = 0 if cell == "rnn" else 1
    jr = randomize(jheads[i], rng)
    tr = load_jax_params(theads[i], jax_arrays(jr))
    xs = rng.normal(size=(4, 9, 10)).astype(np.float32)
    mask = np.arange(9) < 6 if masked else None
    out_j = jr(jnp.asarray(xs), reverse=reverse,
               mask=None if mask is None else jnp.asarray(mask))
    out_t = tr(torch.from_numpy(xs), reverse=reverse,
               mask=None if mask is None else torch.from_numpy(mask))
    close(out_t, out_j)
    if not masked:
        close(tr(torch.from_numpy(xs), reverse=reverse,
                 return_sequence=True),
              jr(jnp.asarray(xs), reverse=reverse, return_sequence=True))


def test_lstm_cell_gate_order_matches_jax():
    rng = np.random.default_rng(4)
    jc = randomize(jnn.LSTMCell.init(jax.random.PRNGKey(4), 5, 3), rng)
    tc = load_jax_params(tnn.LSTMCell(5, 3), jax_arrays(jc))
    h, c, x = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 3), (2, 3), (2, 5)))
    (hj, cj), _ = jc((jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x))
    (ht, ct), _ = tc((torch.from_numpy(h), torch.from_numpy(c)),
                     torch.from_numpy(x))
    close(ht, hj)
    close(ct, cj)


def test_goku_heads_plain_matches_pallas_interpret_and_fused():
    """The kernel's plain version against the JAX Pallas kernel (interpret
    mode on the CPU, as tests/test_pallas_ops.py runs it) and against JAX
    fused_goku_heads; the CPU dispatch goes to the plain version."""
    rng = np.random.default_rng(5)
    jheads, theads = _stacks()
    jheads = randomize(jheads, rng)
    for jh, th in zip(jheads, theads):
        load_jax_params(th, jax_arrays(jh))
    xs = rng.normal(size=(5, 7, 10)).astype(np.float32)
    z0p, thp = pallas_goku_heads(*jheads, jnp.asarray(xs), interpret=True)
    z0f, thf = jnn.fused_goku_heads(*jheads, jnp.asarray(xs))
    xt = torch.from_numpy(xs)
    for fn in (recurrent_cuda.goku_heads_reference, tnn.fused_goku_heads,
               recurrent_cuda.goku_heads):
        z0, th = fn(*theads, xt)
        assert z0.shape == (5, 8) and th.shape == (5, 16)
        close(z0, z0p)
        close(th, thp)
        close(z0, z0f)
        close(th, thf)


def test_goku_heads_grads_match_jax():
    rng = np.random.default_rng(6)
    jheads, theads = _stacks(D=6, H=4)
    jheads = randomize(jheads, rng)
    for jh, th in zip(jheads, theads):
        load_jax_params(th, jax_arrays(jh))
    xs = rng.normal(size=(3, 5, 6)).astype(np.float32)

    def lj(heads, x):
        z0, th = jnn.fused_goku_heads(*heads, x)
        return jnp.sum(z0 ** 2) + jnp.sum(jnp.sin(th))

    gh, gx = jax.grad(lj, argnums=(0, 1))(jheads, jnp.asarray(xs))
    xt = torch.from_numpy(xs).requires_grad_()
    z0, th = recurrent_cuda.goku_heads(*theads, xt)
    (z0 ** 2).sum().add(torch.sin(th).sum()).backward()
    close(xt.grad, gx)
    tparams = [p for h in theads for p in h.parameters()]
    for p, g in zip(tparams, jax.tree_util.tree_leaves(gh)):
        close(p.grad, g)


def test_goku_heads_rejects_what_the_kernel_does_not_take():
    _, (z0, f, b) = _stacks()
    xs = torch.zeros(2, 3, 10)
    wide = tnn.Recurrent.lstm(10, (8, 12))
    with pytest.raises(ValueError):
        recurrent_cuda.goku_heads(z0, f, wide, xs)
    soft = tnn.Recurrent.rnn(10, (8, 8), tnn.softplus)
    with pytest.raises(ValueError):
        recurrent_cuda.goku_heads(soft, f, b, xs)
    with pytest.raises(ValueError):        # a CPU tensor never reaches it
        recurrent_cuda.goku_heads_cuda(z0, f, b, xs)


def test_pack_goku_heads_layout():
    """The packed buffer follows csrc/goku_heads.cu's documented layout:
    per stack and layer Wi, Wh, b, h0 (+ c0 for LSTM)."""
    _, heads = _stacks(D=10, H=8)
    buf = recurrent_cuda.pack_goku_heads(*heads)
    H, D = 8, 10
    rnn = (D * H + H * H + 2 * H) + (H * H + H * H + 2 * H)
    lstm = (D * 4 * H + H * 4 * H + 4 * H + 2 * H) + (
        H * 4 * H + H * 4 * H + 4 * H + 2 * H)
    assert buf.numel() == rnn + 2 * lstm
    first = heads[0].cells[0]
    np.testing.assert_array_equal(buf[:D * H].numpy(),
                                  first.Wi.detach().reshape(-1).numpy())
    off = rnn
    np.testing.assert_array_equal(
        buf[off:off + D * 4 * H].numpy(),
        heads[1].cells[0].Wi.detach().reshape(-1).numpy())
