"""Parity of the PyTorch port's LatentODE against the JAX package, on
the CPU: the neural-field solve and its gradients (plain autograd, the
tape-reading reverse sweep and weight-gradient product that the CUDA
backward kernels follow, and the sweep that recomputes from ys) against
`pallas_solve_neural_field` in interpret mode and the vmapped
`solve_fixed_grid`; the full-width model on the committed
`benchmarks/artifacts/latent_ode_d8_winner.npz` weights; augmentation; the
guards; and the parameter paths.

Inputs and weights are made with numpy from a seed and given to both sides.
Tolerances: the solve atol 1e-5 (float32, seven save points, states of
order 1); its gradients rtol 2e-5 / atol 2e-6, the pins of
tests/test_pallas_ops.py for the JAX kernel's own backward; model outputs
atol 1e-4 (784 outputs through 200-wide resnets and a 9- to 99-step
solve)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq import make_options
from latentdiffeq import nn as jnn
from latentdiffeq.models import LatentDiffEqModel as JModel
from latentdiffeq.models import LatentODE as JLatentODE
from latentdiffeq.models import NODE as JNODE
from latentdiffeq.models import default_layers as jdefault_layers
from latentdiffeq.ops.node_pallas import pallas_solve_neural_field
from latentdiffeq.solve import fixed as jfixed
from latentdiffeq.solve import rk as jrk
from latentdiffeq.train.checkpoint import _path_str
from latentdiffeq.train.checkpoint import load_checkpoint as jload
from latentdiffeq.train import optim as joptim
from latentdiffeq_torch import nn as tnn
from latentdiffeq_torch.adjoint import SolveOptions
from latentdiffeq_torch.core import Identity
from latentdiffeq_torch.models import (LatentDiffEqModel, LatentODE, NODE,
                                       NeuralODEDynamics, default_layers,
                                       latent_ode_default_layers)
from latentdiffeq_torch.ops import node_cuda
from latentdiffeq_torch.solve import rk as trk
from latentdiffeq_torch.train import optim as toptim
from latentdiffeq_torch.train.checkpoint import (jax_param_paths,
                                                 load_checkpoint,
                                                 load_jax_params)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
D8 = os.path.join(ROOT, "benchmarks", "artifacts",
                  "latent_ode_d8_winner.npz")
ACTS = {"relu": (jnn.relu, tnn.relu), "tanh": (jnn.tanh, tnn.tanh),
        "sigmoid": (jnn.sigmoid, tnn.sigmoid),
        "softplus": (jnn.softplus, tnn.softplus)}
CASES = [("Tsit5", 1), ("RK4", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def field_pair(dims=(8, 16, 16, 8), act="relu", seed=0, scale=0.3):
    """The same Chain-of-Dense field in both packages: every W and b drawn
    from N(0, scale^2) with numpy."""
    jact, tact = ACTS[act]
    rng = np.random.default_rng(seed)
    jm = jnn.mlp(jax.random.PRNGKey(0), dims, jact, jnn.identity)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    arrays = [(rng.normal(size=l.shape) * scale).astype(np.float32)
              for l in leaves]
    jm = jax.tree_util.tree_unflatten(treedef, list(map(jnp.asarray,
                                                        arrays)))
    tm = tnn.mlp(dims, tact, tnn.identity)
    with torch.no_grad():
        for p, a in zip(tm.parameters(), arrays):
            p.copy_(torch.from_numpy(a))
    return jm, tm


def solve_inputs(B=20, dim=8, T=7, seed=1):
    rng = np.random.default_rng(seed)
    u0s = (rng.normal(size=(B, dim)) * 0.3).astype(np.float32)
    saveat = (np.arange(T) * 0.1).astype(np.float32)
    return u0s, saveat


def jax_vmapped(jm, solver, u0s, saveat, substeps):
    def f(u, p, t):
        return p(u)
    return jax.vmap(lambda u0: jfixed.solve_fixed_grid(
        f, solver, u0, jm, saveat, substeps=substeps))(u0s)


@pytest.mark.parametrize("solver,substeps", CASES)
def test_neural_field_solve_matches_jax(solver, substeps):
    jm, tm = field_pair()
    u0s, saveat = solve_inputs()
    js, ts = getattr(jrk, solver)(), getattr(trk, solver)()
    ys_p, ok_p, st_p = pallas_solve_neural_field(
        jm, js, jnp.asarray(u0s), jnp.asarray(saveat), substeps=substeps,
        interpret=True)
    ys_v, _, st_v = jax_vmapped(jm, js, jnp.asarray(u0s),
                                jnp.asarray(saveat), substeps)
    with torch.no_grad():
        ys, ok, st = node_cuda.solve_neural_field_reference(
            tm, ts, torch.from_numpy(u0s), torch.from_numpy(saveat),
            substeps=substeps)
        ys_w, ok_w, st_w = node_cuda.solve_neural_field(
            tm, ts, torch.from_numpy(u0s), torch.from_numpy(saveat),
            substeps=substeps)
    assert ys.shape == (20, 7, 8)
    for ref in (ys_p, ys_v):
        np.testing.assert_allclose(ys.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
    # on CPU tensors the wrapper runs the plain version
    torch.testing.assert_close(ys_w, ys, rtol=0, atol=0)
    assert bool(ok.all()) and bool(ok_w.all()) and bool(ok_p.all())
    # per-trajectory counters, like the vmapped solve; their sum is the
    # Pallas wrapper's batch total
    n = 6 * substeps * trk.n_solution_stages(ts.tableau)
    assert st["n_rhs_evals"].shape == (20,) and st_w[
        "n_rhs_evals"].dtype == torch.int32
    np.testing.assert_array_equal(st["n_rhs_evals"].numpy(),
                                  np.asarray(st_v["n_rhs_evals"]))
    assert int(st_w["n_rhs_evals"].sum()) == int(st_p["n_rhs_evals"]) == 20 * n
    assert int(st_w["n_accepted"].sum()) == int(st_p["n_accepted"])


def jax_grads(jm, solver, u0s, saveat, substeps, mode):
    """d sum(ys^2) / d (u0s, every W and b) through the JAX kernel wrapper
    with the given backward mode ("pallas" or "xla")."""
    def loss(m, u):
        ys, _, _ = pallas_solve_neural_field(m, solver, u, saveat,
                                             substeps=substeps,
                                             backward=mode, interpret=True)
        return jnp.sum(ys ** 2)
    gm, gu = jax.grad(loss, argnums=(0, 1))(jm, u0s)
    return [np.asarray(gu)] + [np.asarray(l)
                               for l in jax.tree_util.tree_leaves(gm)]


def torch_grads(tm, solver, u0s, saveat, substeps, how):
    u = torch.from_numpy(u0s).requires_grad_()
    sv = torch.from_numpy(saveat)
    if how == "plain":
        ys = node_cuda.solve_neural_field_reference(tm, solver, u, sv,
                                                    substeps=substeps)[0]
    else:
        ys = node_cuda.solve_neural_field(tm, solver, u, sv,
                                          substeps=substeps,
                                          backward=how)[0]
    grads = torch.autograd.grad((ys ** 2).sum(), [u] + list(tm.parameters()))
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("solver,substeps", CASES)
@pytest.mark.parametrize("how", ["plain", "kernel", "autograd"])
def test_neural_field_gradients_match_jax(solver, substeps, how):
    """Plain autograd, the hand-written reverse sweep ("kernel" on CPU
    tensors runs `solve_neural_field_backward_reference`, the recursion of
    the CUDA backward kernel) and the recompute mode, each against both JAX
    backward modes."""
    jm, tm = field_pair()
    u0s, saveat = solve_inputs()
    js, ts = getattr(jrk, solver)(), getattr(trk, solver)()
    got = torch_grads(tm, ts, u0s, saveat, substeps, how)
    assert len(got) == 7
    for mode in ("xla", "pallas"):
        ref = jax_grads(jm, js, jnp.asarray(u0s), jnp.asarray(saveat),
                        substeps, mode)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6,
                                       err_msg=f"{how} vs jax {mode}")


@pytest.mark.parametrize("act", ["tanh", "sigmoid", "softplus"])
def test_reverse_sweep_reads_activation_derivatives_from_outputs(act):
    """The sweep takes act' from the activation's output (tanh: 1 - h^2,
    sigmoid: h (1 - h), softplus: 1 - exp(-h)); each agrees with the JAX
    package's autodiff."""
    jm, tm = field_pair(dims=(5, 7, 9, 5), act=act, seed=3)
    u0s, saveat = solve_inputs(B=6, dim=5, T=5, seed=4)
    got = torch_grads(tm, trk.Tsit5(), u0s, saveat, 1, "kernel")
    ref = jax_grads(jm, jrk.Tsit5(), jnp.asarray(u0s), jnp.asarray(saveat),
                    1, "xla")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


def test_reverse_sweep_function_returns_the_pulled_back_cotangent():
    """`solve_neural_field_backward_reference` alone, with a random
    cotangent: (du0, dWs, dbs) equal autograd's."""
    _, tm = field_pair(seed=5)
    u0s, saveat = solve_inputs(seed=6)
    u = torch.from_numpy(u0s).requires_grad_()
    sv = torch.from_numpy(saveat)
    ys = node_cuda.solve_neural_field_reference(tm, trk.RK4(), u, sv,
                                                substeps=3)[0]
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=tuple(ys.shape)).astype(np.float32))
    ref = torch.autograd.grad(ys, [u] + list(tm.parameters()), g)
    du0, dWs, dbs = node_cuda.solve_neural_field_backward_reference(
        tm, trk.RK4(), sv, ys.detach(), g, substeps=3)
    got = [du0] + [t for pair in zip(dWs, dbs) for t in pair]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("B", [20, 13], ids=["B20", "ragged-B13"])
@pytest.mark.parametrize("substeps", [1, 2])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_taped_sweep_and_weight_gradients_match_jax(act, substeps, B):
    """The new backward's plain versions: the forward that keeps the tape
    (ys equal the plain solve's), the sweep over it and the (H, Delta) ->
    dW product, against the sweep that recomputes from ys (1e-5 relative:
    the same recursion, dW summed in another order) and against both JAX
    backward modes (rtol 2e-5, atol 2e-6)."""
    jm, tm = field_pair(act=act, seed=11)
    u0s, saveat = solve_inputs(B=B, seed=12)
    js, ts = jrk.Tsit5(), trk.Tsit5()
    u, sv = torch.from_numpy(u0s), torch.from_numpy(saveat)
    ys, tape = node_cuda.solve_neural_field_taped_reference(
        tm, ts, u, sv, substeps=substeps)
    plain = node_cuda.solve_neural_field_reference(tm, ts, u, sv,
                                                   substeps=substeps)[0]
    torch.testing.assert_close(ys, plain.detach(), rtol=0, atol=0)
    hp, rec, dp, drec = node_cuda.tape_layout((8, 16, 16, 8))
    assert (hp, rec, dp, drec) == ([0, 8, 24, 40], 48, [0, 16, 32], 40)
    assert tape.shape == (B, 6 * substeps, 6, rec)
    g = 2 * ys                                  # d sum(ys^2) / d ys
    du0, delta = node_cuda.neural_field_sweep_reference(
        tm, ts, sv, tape, g, substeps=substeps)
    assert delta.shape == (B, 6 * substeps, 6, drec)
    dWs, dbs = node_cuda.neural_field_dw_reference(tm, tape, delta)
    got = [du0] + [t for pair in zip(dWs, dbs) for t in pair]
    r0, rWs, rbs = node_cuda.solve_neural_field_backward_reference(
        tm, ts, sv, ys, g, substeps=substeps)
    for a, b in zip(got, [r0] + [t for pair in zip(rWs, rbs) for t in pair]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for mode in ("xla", "pallas"):
        ref = jax_grads(jm, js, jnp.asarray(u0s), jnp.asarray(saveat),
                        substeps, mode)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-6,
                                       err_msg=f"vs jax {mode}")


def test_relu_derivative_at_zero_is_zero():
    """Zero biases and a zero state give exact-zero pre-activations; both
    sides use relu'(0) = 0, so the gradients still agree."""
    jm, tm = field_pair(seed=8)
    with torch.no_grad():
        for lyr in tm.layers:
            lyr.b.zero_()
    jm = jax.tree_util.tree_map(
        lambda l: jnp.zeros_like(l) if l.ndim == 1 else l, jm)
    u0s, saveat = solve_inputs(B=4, seed=9)
    u0s[0] = 0.0
    u0s[1, 4:] = 0.0
    got = torch_grads(tm, trk.Tsit5(), u0s, saveat, 1, "kernel")
    ref = jax_grads(jm, jrk.Tsit5(), jnp.asarray(u0s), jnp.asarray(saveat),
                    1, "pallas")
    assert np.all(got[0][0] == 0.0)      # the all-zero row stays at zero
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# The full model on the committed checkpoint.

def jax_d8(use_pallas_solve=False):
    k = jax.random.PRNGKey(0)
    kn, kl = jax.random.split(k)
    node = JNODE(kn, 8, options=make_options(adaptive=False, substeps=1))
    mt = JLatentODE(use_pallas_solve=use_pallas_solve)
    enc, dec = jdefault_layers(kl, mt, 784, node)
    return JModel.build(mt, enc, dec)


def torch_d8(use_kernel_solve=False, **node_kw):
    node = NODE(8, options=SolveOptions(adaptive=False, substeps=1),
                device="cpu", **node_kw)
    mt = LatentODE(use_kernel_solve=use_kernel_solve)
    enc, dec = default_layers(mt, 784, node, device="cpu")
    return LatentDiffEqModel.build(mt, enc, dec)


@pytest.fixture(scope="module")
def d8():
    """(JAX params tree, port model) holding latent_ode_d8_winner.npz."""
    jm = jax_d8()
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-4)
    tree, _ = jload(D8, {"key": jax.random.PRNGKey(0), "model": jm,
                         "opt_state": opt.init(jm)})
    tm = torch_d8()
    load_checkpoint(D8, tm)
    return tree["model"], tm


def frames(B=3, T=10, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (B, T, 784))
    return x.astype(np.float32), (np.arange(T) * 0.05).astype(np.float32)


def close(t, a, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol)


def with_type(jm, **kw):
    """The same JAX weights under another model-type tag."""
    mt = JLatentODE(**kw)
    leaves = jax.tree_util.tree_leaves(jm)
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_d8(**kw)), leaves), mt


def test_parameter_paths_equal_the_checkpoint_keys_in_order():
    tm = torch_d8()
    with np.load(D8) as data:
        blob = json.loads(bytes(data["__meta__"]).decode())
    keys = [p[len("model/"):] for p in blob["paths"]
            if p.startswith("model/")]
    assert jax_param_paths(tm) == keys
    assert len(keys) == 34
    assert keys[20:26] == [f"decoder/diffeq/dudt/layers/{i}/{n}"
                           for i in range(3) for n in ("W", "b")]
    jpaths = [_path_str(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jax_d8())[0]]
    assert jpaths == keys


def test_checkpoint_loads_with_adam_moments():
    tm = torch_d8()
    opt = toptim.adamw(tm.parameters(), 1e-3, decay=1e-4)
    meta = load_checkpoint(D8, tm, opt)
    assert meta["epoch"] == 2264
    with np.load(D8) as d:
        np.testing.assert_array_equal(
            tm.decoder.diffeq.dudt.layers[1].W.detach().numpy(),
            d["leaf::model/decoder/diffeq/dudt/layers/1/W"])
        np.testing.assert_array_equal(
            opt.m[20].numpy(),
            d["leaf::opt_state/m/decoder/diffeq/dudt/layers/0/W"])
        np.testing.assert_array_equal(
            opt.v[-1].numpy(),
            d["leaf::opt_state/v/decoder/reconstructor/layers/3/b"])
        assert opt.t == int(d["leaf::opt_state/t"])


@pytest.mark.parametrize("use_pallas_solve", [False, True])
@pytest.mark.parametrize("use_kernel_solve", [False, True])
def test_latent_ode_forward_matches_jax_on_d8_weights(d8, use_pallas_solve,
                                                      use_kernel_solve):
    jm, tm = d8
    jm, _ = with_type(jm, use_pallas_solve=use_pallas_solve)
    tk = torch_d8(use_kernel_solve=use_kernel_solve)
    tk.load_state_dict(tm.state_dict())
    x, t = frames()
    (xh_j, z_j, l_j), mu_j, lv_j, aux_j = jax.jit(
        lambda m, a, b: m(a, b))(jm, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        (xh, z, l_hat), mu, lv, aux = tk(torch.from_numpy(x),
                                         torch.from_numpy(t))
    assert xh.shape == (3, 10, 784) and z.shape == (3, 10, 8)
    close(xh, xh_j, 1e-4)
    close(z, z_j, 1e-4)
    close(l_hat, l_j, 1e-4)
    close(mu, mu_j, 1e-4)
    close(lv, lv_j, 1e-4)
    assert bool(aux["success"].all())
    assert int(aux["stats"]["n_rhs_evals"]) == int(
        aux_j["stats"]["n_rhs_evals"]) == 3 * 9 * 6


def test_latent_ode_sample_with_same_noise_matches_jax(d8):
    jm, tm = d8
    x, t = frames(B=2, T=8, seed=1)
    key = jax.random.PRNGKey(7)
    (xh_j, _, l_j), _, lv_j, _ = jm(jnp.asarray(x), jnp.asarray(t),
                                   variational=True, key=key)
    eps = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key)[0], lv_j.shape)))
    with torch.no_grad():
        (xh, _, l_hat), _, _, _ = tm(torch.from_numpy(x),
                                     torch.from_numpy(t), variational=True,
                                     eps=eps)
        drawn = tm(torch.from_numpy(x), torch.from_numpy(t),
                   variational=True,
                   generator=torch.Generator().manual_seed(0))[0][2]
    close(l_hat, l_j, 1e-4)
    close(xh, xh_j, 1e-4)
    assert drawn.shape == l_hat.shape and not torch.equal(drawn, l_hat)


@pytest.mark.parametrize("use_kernel_solve", [False, True])
def test_latent_ode_forecast_matches_jax(d8, use_kernel_solve):
    """A 50-frame context decoded over a 100-frame grid."""
    jm, tm = d8
    tk = torch_d8(use_kernel_solve=use_kernel_solve)
    tk.load_state_dict(tm.state_dict())
    x, _ = frames(B=2, T=50, seed=2)
    t_long = (np.arange(100) * 0.05).astype(np.float32)
    xh_j, z_j, _ = jax.jit(lambda m, a, b: m.forecast(a, b))(
        jm, jnp.asarray(x), jnp.asarray(t_long))
    with torch.no_grad():
        xh, z, _ = tk.forecast(torch.from_numpy(x),
                               torch.from_numpy(t_long))
    assert xh.shape == (2, 100, 784)
    close(z, z_j, 1e-4)
    close(xh, xh_j, 1e-4)


def test_masked_curriculum_path_matches_jax(d8):
    jm, tm = d8
    x, t = frames(B=2, T=12, seed=3)
    (xh_j, _, _), mu_j, _, _ = jm(jnp.asarray(x), jnp.asarray(t),
                                  cur_len=jnp.int32(7))
    with torch.no_grad():
        (xh, _, _), mu, _, _ = tm(torch.from_numpy(x), torch.from_numpy(t),
                                  cur_len=7)
        mus = tm(torch.from_numpy(x[:, :7]), torch.from_numpy(t))[1]
    close(xh, xh_j, 1e-4)
    close(mu, mu_j, 1e-4)
    torch.testing.assert_close(mu, mus, rtol=0, atol=1e-6)


def small_pair(augment_dim=0, seed=0, scale=0.25, **mt_kw):
    """A narrow LatentODE (input 24, latent 6, hidden 16) in both packages
    with the same random weights."""
    k = jax.random.PRNGKey(seed)
    kn, kl = jax.random.split(k)
    jnode = JNODE(kn, 6, hidden_dim=16, augment_dim=augment_dim,
                  options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(kl, JLatentODE(), 24, jnode,
                               hidden_dim_resnet=16, rnn_input_dim=8,
                               rnn_output_dim=8)
    jm = JModel.build(JLatentODE(), enc, dec)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    jm = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.normal(size=l.shape) * scale).astype(np.float32))
        for l in leaves])
    node = NODE(6, hidden_dim=16, augment_dim=augment_dim,
                options=SolveOptions(adaptive=False, substeps=1),
                device="cpu")
    mt = LatentODE(**mt_kw)
    tenc, tdec = latent_ode_default_layers(
        24, node, hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8,
        device="cpu")
    tm = LatentDiffEqModel.build(mt, tenc, tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(l) for p, l in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


@pytest.mark.parametrize("use_kernel_solve", [False, True])
def test_augmented_latent_ode_matches_jax(use_kernel_solve):
    """augment_dim=2: the state is padded with exact zeros, the field and
    the reconstructor take latent 6 + 2."""
    jm, tm = small_pair(augment_dim=2, use_kernel_solve=use_kernel_solve)
    assert tm.decoder.diffeq.latent_dim_out == 8
    assert tm.decoder.diffeq.dudt.layers[0].W.shape == (8, 16)
    x = np.random.default_rng(1).uniform(0, 1, (4, 9, 24)).astype(np.float32)
    t = (np.arange(9) * 0.05).astype(np.float32)
    (xh_j, z_j, l_j), _, _, _ = jm(jnp.asarray(x), jnp.asarray(t))
    (xh, z, l_hat), _, _, aux = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert z.shape == (4, 9, 8) and l_hat.shape == (4, 6)
    close(z, z_j, 1e-5)
    close(xh, xh_j, 1e-5)
    # gradients reach every parameter through either solve route
    eps = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 6)).astype(np.float32))
    tm(torch.from_numpy(x), torch.from_numpy(t), variational=True,
       eps=eps)[0][0].sum().backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in tm.parameters())


def test_failed_solves_are_nan_filled_and_transform_applies():
    _, tm = small_pair(seed=2)
    de = tm.decoder.diffeq
    z0 = torch.full((3, 6), 0.1)
    z0[1, 0] = float("inf")
    t = torch.arange(5) * 0.05
    ys, aux = tm.model_type.diffeq_layer(tm.decoder, z0, t)
    assert aux["success"].tolist() == [True, False, True]
    assert bool(torch.isnan(ys[1]).all()) and bool(
        torch.isfinite(ys[0]).all())
    assert int(aux["stats"]["n_rhs_evals"]) == 3 * 4 * 6
    de.transform = lambda y: 2 * y
    ys2, _ = tm.model_type.diffeq_layer(tm.decoder, z0, t)
    torch.testing.assert_close(ys2[0], 2 * ys[0])


def test_kernel_solve_refuses_a_grid_that_is_not_fixed():
    x, t = torch.rand(2, 6, 24), torch.arange(6) * 0.05
    for options in (SolveOptions(adaptive=True),
                    SolveOptions(adaptive=False, interp_stride=2)):
        node = NODE(6, hidden_dim=16, options=options, device="cpu")
        enc, dec = latent_ode_default_layers(
            24, node, hidden_dim_resnet=16, rnn_input_dim=8,
            rnn_output_dim=8, device="cpu")
        m = LatentDiffEqModel.build(LatentODE(use_kernel_solve=True), enc,
                                    dec)
        with pytest.raises(ValueError, match="fixed-grid"):
            m(x, t)
    # RK4 has no error estimate, so adaptive=True still means the fixed grid
    node = NODE(6, hidden_dim=16, solver=trk.RK4(),
                options=SolveOptions(adaptive=True), device="cpu")
    enc, dec = latent_ode_default_layers(
        24, node, hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8,
        device="cpu")
    m = LatentDiffEqModel.build(LatentODE(use_kernel_solve=True), enc, dec)
    assert m(x, t)[0][0].shape == (2, 6, 24)


def test_kernel_solve_refuses_a_model_that_is_not_float32():
    node = NODE(6, hidden_dim=16, dtype=torch.float64, device="cpu",
                options=SolveOptions(adaptive=False))
    enc, dec = latent_ode_default_layers(
        24, node, hidden_dim_resnet=16, rnn_input_dim=8, rnn_output_dim=8,
        dtype=torch.float64, device="cpu")
    x = torch.rand(2, 6, 24, dtype=torch.float64)
    t = torch.arange(6, dtype=torch.float32) * 0.05
    m = LatentDiffEqModel.build(LatentODE(use_kernel_solve=True), enc, dec)
    with pytest.raises(ValueError, match="float32"):
        m(x, t)
    # the plain path takes it: the field runs in float64, the solve in
    # float32
    out = LatentDiffEqModel.build(LatentODE(), enc, dec)(x, t)[0][0]
    assert out.dtype == torch.float64 and bool(torch.isfinite(out).all())


def test_unsupported_fields_raise():
    u0s, saveat = map(torch.from_numpy, solve_inputs(B=3))
    solver = trk.Tsit5()
    skip = tnn.Chain([tnn.Dense(8, 8, tnn.relu),
                      tnn.SkipConnection(tnn.Dense(8, 8))])
    with pytest.raises(TypeError, match="Chain-of-Dense"):
        node_cuda.solve_neural_field(skip, solver, u0s, saveat)
    gelu = tnn.mlp((8, 16, 8), torch.nn.functional.gelu)
    with pytest.raises(ValueError, match="activations"):
        node_cuda.solve_neural_field(gelu, solver, u0s, saveat)
    deep = tnn.mlp((8,) * (node_cuda.MAX_LAYERS + 2), tnn.relu)
    with pytest.raises(ValueError, match="layers"):
        node_cuda.solve_neural_field(deep, solver, u0s, saveat)
    assert len(tnn.mlp((8,) * (node_cuda.MAX_LAYERS + 1),
                       tnn.relu).layers) == node_cuda.MAX_LAYERS
    narrow = tnn.mlp((8, 16, 4), tnn.relu)
    with pytest.raises(ValueError, match="width"):
        node_cuda.solve_neural_field(narrow, solver, u0s, saveat)
    _, ok = field_pair()
    with pytest.raises(ValueError, match="backward"):
        node_cuda.solve_neural_field(ok, solver, u0s, saveat,
                                     backward="xla")
    with pytest.raises(ValueError, match="CUDA"):
        node_cuda.solve_neural_field_cuda(ok, solver, u0s, saveat)
    with pytest.raises(ValueError, match="CUDA"):
        node_cuda.solve_neural_field_backward_cuda(
            ok, solver, saveat, torch.zeros(3, 7, 8), torch.zeros(3, 7, 8))


def test_neural_dynamics_is_a_module_and_identity_has_no_parameters():
    node = NODE(16, device="cpu")
    assert isinstance(node, NeuralODEDynamics)
    assert isinstance(node, torch.nn.Module)
    assert node.latent_dim_out == 16 and NODE(
        2, augment_dim=2, device="cpu").latent_dim_out == 4
    assert [tuple(p.shape) for p in node.parameters()] == [
        (16, 200), (200,), (200, 200), (200,), (200, 16), (16,)]
    assert node.solver == trk.Tsit5() and node.options == SolveOptions()
    assert list(Identity().parameters()) == []
    x = torch.rand(2, 3)
    assert Identity()(x) is x
    # the same generator seed gives the same weights
    a = NODE(4, generator=torch.Generator().manual_seed(5), device="cpu")
    b = NODE(4, generator=torch.Generator().manual_seed(5), device="cpu")
    for p, q in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_default_layers_dispatch_and_default_device():
    node = NODE(6, hidden_dim=16, device="cpu")
    enc, dec = default_layers(LatentODE(), 24, node, hidden_dim_resnet=16,
                              device="cpu")
    assert isinstance(dec[0], Identity) and dec[1] is node
    assert len(enc[2]) == 2 and enc[2][0].W.shape == (32, 6)
    with pytest.raises(ValueError, match="no default layers"):
        default_layers(object(), 24, node)
    if torch.cuda.is_available():
        pytest.skip("the rest checks the error raised without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NODE(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        latent_ode_default_layers(24, node)
