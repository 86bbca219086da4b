"""bfloat16 NN stages in the port against the JAX package, on the CPU.

The JAX package's bf16 recipe (``train_goku.py --dtype bf16``): every NN
weight bfloat16, Dense and the recurrent cells computing in it, the solve
integrating in float32 (GOKU casts in and back), ADAMW keeping bfloat16
moments with a float32 update, checkpoints storing bfloat16 as float32.

bf16 rounds at other places in PyTorch and in XLA (which keeps fused
elementwise work in float32), so no bit-for-bit parity is possible. Each
gate measures the port against JAX's bf16 result and against a float32
evaluation of the SAME bf16 weights upcast (JAX_f32):
- the forward (``fwd_rule``): max|port - JAX_bf16| <= max|JAX_bf16 -
  JAX_f32| (JAX's own gap) for x_hat and z_hat, which carry the solve
  (before the float32 solve was repaired x_hat was 0.242 from JAX's on
  goku_bf16_gate.npz, against a gap of 0.118), and <= twice the gap for
  mu and logvar; each output at most 1.5x as far from JAX_f32 as JAX_bf16
  is. On goku_bf16_gate.npz every output holds the one-gap rule. On
  goku_bf16_winner.npz the theta head's mu and logvar do not (0.00586
  against a gap of 0.00506, and 0.03125, one bf16 step at |logvar| ~ 5,
  against 0.0239): the theta LSTMs' output parts from JAX's by 0.0186
  (its gap 0.0239; the two round at other places) and a Dense carries that
  into a rounding flip; both are closer to JAX_f32 than JAX_bf16 is;
- the heads against JAX's Pallas kernel in interpret mode in bf16: outputs
  within 2^-6 of their size; outputs and gradients (``jax.vjp``) at most
  twice as far from JAX_f32 as JAX_bf16 is, plus 2^-8 of the size (the card
  gate of chip_smoke.py);
- ADAMW, checkpoints: see each test.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

from pendulum import Pendulum as JPendulum  # noqa: E402

from latentdiffeq import make_options  # noqa: E402
from latentdiffeq import nn as jnn  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import LatentODE as JLatentODE  # noqa: E402
from latentdiffeq.models import NODE as JNODE  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa
from latentdiffeq.ops.recurrent_pallas import pallas_goku_heads  # noqa
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train.checkpoint import (  # noqa: E402
    load_checkpoint as jload, save_checkpoint as jsave)
from latentdiffeq_torch import nn as tnn  # noqa: E402
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (  # noqa: E402
    GOKUBasic, LatentDiffEqModel, LatentODE, NODE, default_layers,
    goku_default_layers)
from latentdiffeq_torch.models import goku as goku_mod  # noqa: E402
from latentdiffeq_torch.ops import recurrent_cuda as rc  # noqa: E402
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.train import (TrainConfig, Trainer,  # noqa: E402
                                      load_checkpoint, save_checkpoint)
from latentdiffeq_torch.train import optim as toptim  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
BF16_CKPTS = ["goku_bf16_gate.npz", "goku_bf16_winner.npz"]
BF = torch.bfloat16


def f32(a) -> np.ndarray:
    """Any tensor or array as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def bf16_step(x) -> float:
    """The spacing of bfloat16 values at the magnitude max|x| (8 bits of
    significand)."""
    m = float(np.abs(x).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def jax_goku(dtype, pallas=False):
    mt = JGOKUBasic(use_pallas_encoder=pallas, use_pallas_solver=pallas)
    enc, dec = jdefault_layers(
        jax.random.PRNGKey(0), mt, 784,
        JPendulum(options=make_options(adaptive=False, substeps=1)),
        dtype=dtype)
    return JModel.build(mt, enc, dec)


def port_goku(kernels=False):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=kernels, use_kernel_solver=kernels),
        *goku_default_layers(784, diffeq, device="cpu", dtype=BF))


def jax_pair(name):
    """JAX's bf16 GOKU holding checkpoint ``name``, and the same bf16
    weights upcast to float32."""
    jb = jload(os.path.join(ARTIFACTS, name), {"model": jax_goku(
        jnp.bfloat16)})[0]["model"]
    leaves = [a.astype(jnp.float32) for a in jax.tree_util.tree_leaves(jb)]
    jf = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_goku(jnp.float32)), leaves)
    return jb, jf


def frames(B=8, T=50, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (B, T, 784))
    return x.astype(np.float32), (np.arange(T) * 0.05).astype(np.float32)


_jax_call = jax.jit(lambda m, a, b: m(a, b))


def outputs(res):
    (xh, z, _), mu, lv, _ = res
    return {"x_hat": xh, "z_hat": z, "mu_z0": mu[0], "mu_theta": mu[1],
            "logvar_z0": lv[0], "logvar_theta": lv[1]}


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("name", BF16_CKPTS)
def test_goku_bf16_forward_matches_jax(name, kernels):
    """The forward on a committed bf16 checkpoint (FWD_RULE in the module
    docstring); with the kernel switches the CPU tensors run the kernels'
    plain versions. Fails without the float32 solve (x_hat 0.242 from
    JAX's on goku_bf16_gate.npz, JAX's gap 0.118)."""
    jb, jf = jax_pair(name)
    tm = port_goku(kernels)
    load_checkpoint(os.path.join(ARTIFACTS, name), tm)
    assert all(p.dtype == BF for p in tm.parameters())
    x, t = frames()
    ob = outputs(_jax_call(jb, jnp.asarray(x), jnp.asarray(t)))
    of = outputs(_jax_call(jf, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        res = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert bool(res[3]["success"].all())
    for k, v in outputs(res).items():
        assert v.dtype == BF, k
        p, b, f = f32(v), f32(ob[k]), f32(of[k])
        fwd_rule(k, p, b, f, name)


def fwd_rule(k, p, b, f, what=""):
    """The forward's gate (module docstring) on output ``k``: the port
    ``p`` against JAX's bf16 ``b`` and float32 ``f``."""
    gap = np.abs(b - f).max()
    d_jb, d_jf = np.abs(p - b).max(), np.abs(p - f).max()
    allow = gap if k in ("x_hat", "z_hat") else 2 * gap
    assert d_jb <= allow, (what, k, d_jb, gap)
    assert d_jf <= 1.5 * gap, (what, k, d_jf, gap)


def test_goku_bf16_solves_in_float32(monkeypatch):
    """The solve takes float32 (z0_hat, theta_hat) and its trajectories
    come back in bfloat16, on both the plain and the kernel route."""
    seen = []
    for mod, fn in ((goku_mod, "odeint"),
                    (goku_mod, "solve_fixed_grid_batched")):
        orig = getattr(mod, fn)

        def spy(f, solver, u0, p, *a, _orig=orig, **kw):
            seen.append((u0.dtype, p.dtype))
            return _orig(f, solver, u0, p, *a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    x, t = frames(B=3, T=6)
    for kernels in (False, True):
        tm = port_goku(kernels)
        with torch.no_grad():
            (_, z, _), _, _, _ = tm(torch.from_numpy(x), torch.from_numpy(t))
        assert z.dtype == BF
    assert seen == [(torch.float32, torch.float32)] * 2


def test_goku_bf16_sample_with_same_noise_matches_jax():
    """The reparameterised sample with JAX's bf16 noise: mu + eps *
    exp(logvar / 2) in bf16 on the same mu and logvar, within one bf16 step
    of each sample's size (XLA fuses the three operations, PyTorch rounds
    after each); the forward decodes exactly that sample."""
    jb, _ = jax_pair(BF16_CKPTS[0])
    tm = port_goku()
    load_checkpoint(os.path.join(ARTIFACTS, BF16_CKPTS[0]), tm)
    x, t = frames(B=4, T=12, seed=1)
    key = jax.random.PRNGKey(7)
    mu_j, lv_j = jb.encoder(jnp.asarray(x))
    skey = jax.random.split(key)[0]
    z0_j, th_j = jb.model_type.sample(mu_j, lv_j, skey)
    k1, k2 = jax.random.split(skey)
    eps = tuple(torch.from_numpy(f32(jax.random.normal(k, lv.shape,
                                                       lv.dtype))).to(BF)
                for k, lv in zip((k1, k2), lv_j))
    mu = tuple(torch.from_numpy(f32(a)).to(BF) for a in mu_j)
    lv = tuple(torch.from_numpy(f32(a)).to(BF) for a in lv_j)
    z0_s, th_s = tm.model_type.sample(mu, lv, eps=eps)
    assert z0_s.dtype == th_s.dtype == BF
    for got, ref in ((z0_s, z0_j), (th_s, th_j)):
        r = f32(ref)
        assert np.abs(f32(got) - r).max() <= bf16_step(r)
    with torch.no_grad():
        (_, _, l_hat), mu_t, lv_t, _ = tm(torch.from_numpy(x),
                                          torch.from_numpy(t),
                                          variational=True, eps=eps)
        lo = tm.model_type.apply_latent_out(
            tm.decoder, tm.model_type.sample(mu_t, lv_t, eps=eps))
    for got, ref in zip(lo, l_hat):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


# -- the heads' plain bf16 versions against JAX's Pallas kernel --------------

def heads_pair(act, scale, seed=0, D=32, H=16, L=2):
    """The GOKU heads in bf16 in both packages (and JAX's upcast to
    float32), every leaf N(0, scale^2) rounded to bf16."""
    ja, ta = getattr(jnn, act), getattr(tnn, act)
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    jh = (jnn.Recurrent.rnn(ks[0], D, (H,) * L, ja),
          jnn.Recurrent.lstm(ks[1], D, (H,) * L),
          jnn.Recurrent.lstm(ks[2], D, (H,) * L))
    leaves, treedef = jax.tree_util.tree_flatten(jh)
    rng = np.random.default_rng(seed)
    vals = [jnp.asarray((rng.normal(size=l.shape) * scale).astype(
        np.float32)).astype(jnp.bfloat16) for l in leaves]
    jb = jax.tree_util.tree_unflatten(treedef, vals)
    jf = jax.tree_util.tree_unflatten(
        treedef, [v.astype(jnp.float32) for v in vals])
    th = (tnn.Recurrent.rnn(D, (H,) * L, ta, dtype=BF),
          tnn.Recurrent.lstm(D, (H,) * L, dtype=BF),
          tnn.Recurrent.lstm(D, (H,) * L, dtype=BF))
    with torch.no_grad():
        for p, v in zip(rc._heads_params(*th), vals):
            p.copy_(torch.from_numpy(f32(v)))
    return jb, jf, th, rng


def bf16_inputs(rng, *shapes):
    return [f32(jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(
        jnp.bfloat16)) for s in shapes]


def jax_heads(jh, x, g, dtype):
    """Pallas heads (interpret mode) and jax.vjp of them in ``dtype``:
    [z0, theta, dxs, d leaf...] as float32 numpy."""
    leaves, treedef = jax.tree_util.tree_flatten(jh)

    def fn(xs, lv):
        return pallas_goku_heads(*jax.tree_util.tree_unflatten(treedef, lv),
                                 xs, interpret=True)

    (z, th), vjp = jax.vjp(fn, jnp.asarray(x).astype(dtype), leaves)
    dx, dl = vjp(tuple(jnp.asarray(a).astype(dtype) for a in g))
    return [f32(a) for a in [z, th, dx] + list(dl)]


def twice_as_far(got, b, f) -> bool:
    """At most twice as far from the float32 evaluation as JAX's bf16 is,
    plus 2^-8 of the size."""
    return (np.abs(got - f).max()
            <= 2 * np.abs(b - f).max() + np.abs(f).max() / 256)


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_heads_plain_bf16_forward_matches_pallas_kernel(act):
    """goku_heads_reference (the CPU route: cells in bf16, rounding after
    every operation) and goku_heads_taped_reference (the kernel's plain
    version: float32 arithmetic, h and c rounded each step) against
    pallas_goku_heads in interpret mode in bf16 (B 8, T 20, the GOKU
    widths, weights N(0, 0.3^2)): within 2^-6 of each output's size, and
    the twice-as-far rule."""
    jb, jf, th, rng = heads_pair(act, 0.3)
    x, gz, gt = bf16_inputs(rng, (8, 20, 32), (8, 16), (8, 32))
    ref_b = jax_heads(jb, x, (gz, gt), jnp.bfloat16)[:2]
    ref_f = jax_heads(jf, x, (gz, gt), jnp.float32)[:2]
    xt = torch.from_numpy(x).to(BF)
    with torch.no_grad():
        routes = {"reference": rc.goku_heads_reference(*th, xt),
                  "taped": rc.goku_heads_taped_reference(*th, xt)[:2]}
    for route, got in routes.items():
        for name, a, b, f in zip(("z0", "theta"), got, ref_b, ref_f):
            assert a.dtype == BF
            a = f32(a)
            assert np.abs(a - b).max() <= np.abs(b).max() / 64, (route, name)
            assert twice_as_far(a, b, f), (route, name)


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_heads_plain_bf16_gradients_match_jax_vjp(act):
    """The kernel route's plain backward (the sweep over the bf16 tape, then
    the products in bf16) and autograd of goku_heads_reference against
    jax.vjp of the Pallas kernel in bf16: every gradient in bf16, at most
    twice as far from JAX_f32 as JAX's bf16 gradient is, plus 2^-8 of its
    size (weights N(0, 0.15^2): at 0.3 the relu recursion's gains reach
    1e2, where two bf16 evaluations part by relu units that flip)."""
    jb, jf, th, rng = heads_pair(act, 0.15, seed=1)
    x, gz, gt = bf16_inputs(rng, (8, 20, 32), (8, 16), (8, 32))
    ref_b = jax_heads(jb, x, (gz, gt), jnp.bfloat16)[2:]
    ref_f = jax_heads(jf, x, (gz, gt), jnp.float32)[2:]
    xt, g = torch.from_numpy(x).to(BF), (torch.from_numpy(gz).to(BF),
                                         torch.from_numpy(gt).to(BF))
    params = rc._heads_params(*th)
    with torch.no_grad():
        tape = rc.goku_heads_taped_reference(*th, xt)[2]
        dxs, dps = rc.goku_heads_backward_reference(*th, xt, tape, *g)
    xr = xt.clone().requires_grad_()
    auto = torch.autograd.grad(rc.goku_heads_reference(*th, xr), [xr] + params,
                               g)
    for route, got in (("kernel plain", [dxs] + dps), ("autograd", auto)):
        assert len(got) == len(ref_b)
        for i, (a, b, f) in enumerate(zip(got, ref_b, ref_f)):
            assert a.dtype == BF, (route, i)
            assert twice_as_far(f32(a), b, f), (route, i)


# -- the optimizer and checkpoints -------------------------------------------

def test_adamw_bf16_update_is_float32_with_bf16_moments():
    """Three ADAMW steps on bf16 parameters with the same bf16 gradients as
    JAX's: JAX computes the update in float32 (its c1, c2 are float32
    arrays) and keeps bf16 moments; the port's moments stay bf16 and its
    parameters and moments are within one bf16 step of JAX's (XLA fuses
    the moment updates)."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (5,), (3, 4)]
    p0 = [jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(
        jnp.bfloat16) for s in shapes]
    grads = [[jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.1)
              .astype(jnp.bfloat16) for s in shapes] for _ in range(3)]
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    jp, st = p0, opt.init(p0)
    tp = [torch.from_numpy(f32(a)).to(BF) for a in p0]
    topt = toptim.adamw(tp, 1e-3, 0.9, 0.999, 1e-3)
    for g in grads:
        upd, st = opt.update(g, st, jp)
        assert all(u.dtype == jnp.float32 for u in upd)
        jp = joptim.apply_updates(jp, upd)
        for p, gg in zip(tp, g):
            p.grad = torch.from_numpy(f32(gg)).to(BF)
        before = [p.clone() for p in tp]
        topt.step()
        # the port's step is the float32 update rounded once
        for p, q, u in zip(tp, before, upd):
            np.testing.assert_array_equal(
                f32(p), f32((q - torch.from_numpy(f32(u)).to(BF))))
    assert all(m.dtype == jnp.bfloat16 for m in st["m"] + st["v"])
    assert all(m.dtype == BF for m in topt.m + topt.v)
    for a, b in zip(tp + topt.m + topt.v, jp + st["m"] + st["v"]):
        ref = f32(b)
        assert np.abs(f32(a) - ref).max() <= bf16_step(ref)


def test_adamw_float32_unchanged():
    """float32 parameters take the update as before, in float32."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    ref = p.clone()
    opt = toptim.adamw([p], 1e-3, 0.9, 0.999, 1e-3)
    p.grad = g
    opt.step()
    m = 0.1 * g
    v = 0.001 * g * g
    c1 = float(np.float32(1) - np.float32(0.9))
    c2 = float(np.float32(1) - np.float32(0.999))
    upd = 1e-3 * (m / c1) / (torch.sqrt(v / c2) + 1e-8) + 1e-3 * ref
    torch.testing.assert_close(p, ref - upd, rtol=0, atol=0)


def test_bf16_checkpoints_round_trip_with_jax_bit_for_bit(tmp_path):
    """A port bf16 model and its ADAMW state, saved (bf16 stored as
    float32), load into JAX's load_checkpoint with a bf16 template bit for
    bit; a JAX bf16 tree saved by JAX loads into the port bit for bit."""
    tm = port_goku()
    load_checkpoint(os.path.join(ARTIFACTS, BF16_CKPTS[1]), tm)
    opt = toptim.adamw(tm.parameters(), 1e-3, decay=1e-3)
    for p in tm.parameters():
        p.grad = torch.full_like(p, 0.01)
    opt.step()
    out = str(tmp_path / "port_bf16.npz")
    save_checkpoint(out, tm, opt, meta={"epoch": 1})
    jm = jax_goku(jnp.bfloat16)
    jopt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    tree, meta = jload(out, {"model": jm, "opt_state": jopt.init(jm)})
    assert meta == {"epoch": 1}
    leaves = jax.tree_util.tree_leaves(tree["model"])
    for p, leaf in zip(tm.parameters(), leaves):
        assert leaf.dtype == jnp.bfloat16
        np.testing.assert_array_equal(f32(p), f32(leaf))
    for a, b in zip(opt.m + opt.v, jax.tree_util.tree_leaves(
            tree["opt_state"]["m"]) + jax.tree_util.tree_leaves(
            tree["opt_state"]["v"])):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(f32(a), f32(b))
    # JAX writes, the port reads
    back = str(tmp_path / "jax_bf16.npz")
    jsave(back, {"model": tree["model"]}, meta={"from": "jax"})
    tm2 = port_goku()
    assert load_checkpoint(back, tm2) == {"from": "jax"}
    for a, b in zip(tm2.parameters(), leaves):
        assert a.dtype == BF
        np.testing.assert_array_equal(f32(a), f32(b))


def test_ttg_bf16_winner_restores_into_a_trainer():
    """ttg_bf16_px_winner.npz (JAX's Trainer file: key, model, ADAMW
    state) restores into a port Trainer of a bf16 GOKU: weights and
    moments equal the file's values in bf16, step and epoch as stored."""
    path = os.path.join(ARTIFACTS, "ttg_bf16_px_winner.npz")
    tr = Trainer(port_goku(), TrainConfig(save_best=False), device="cpu")
    tr.restore(path)
    assert tr.epoch == 380 and tr.opt.t > 0
    with np.load(path) as d:
        for (name, p), m in zip(tr.model.named_parameters(), tr.opt.m):
            key = name.replace(".", "/")
            assert p.dtype == m.dtype == BF
            np.testing.assert_array_equal(f32(p), d[f"leaf::model/{key}"])
            np.testing.assert_array_equal(f32(m),
                                          d[f"leaf::opt_state/m/{key}"])
        assert tr.opt.t == int(d["leaf::opt_state/t"])


# -- LatentODE's plain bf16 path ---------------------------------------------

def latent_ode_pair(seed=0, scale=0.25):
    """A narrow LatentODE (input 24, latent 6, hidden 16) with N(0, scale^2)
    weights rounded to bf16: JAX's in bf16 and upcast, the port's in
    bf16."""
    kn, kl = jax.random.split(jax.random.PRNGKey(seed))
    jnode = JNODE(kn, 6, hidden_dim=16,
                  options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(kl, JLatentODE(), 24, jnode,
                               hidden_dim_resnet=16, rnn_input_dim=8,
                               rnn_output_dim=8)
    jm = JModel.build(JLatentODE(), enc, dec)
    leaves, treedef = jax.tree_util.tree_flatten(jm)
    rng = np.random.default_rng(seed)
    vals = [jnp.asarray((rng.normal(size=l.shape) * scale).astype(
        np.float32)).astype(jnp.bfloat16) for l in leaves]
    jb = jax.tree_util.tree_unflatten(treedef, vals)
    jf = jax.tree_util.tree_unflatten(
        treedef, [v.astype(jnp.float32) for v in vals])

    def port(use_kernel_solve=False):
        node = NODE(6, hidden_dim=16, device="cpu", dtype=BF,
                    options=SolveOptions(adaptive=False, substeps=1))
        tm = LatentDiffEqModel.build(
            LatentODE(use_kernel_solve=use_kernel_solve),
            *default_layers(LatentODE(), 24, node, hidden_dim_resnet=16,
                            rnn_input_dim=8, rnn_output_dim=8, device="cpu",
                            dtype=BF))
        with torch.no_grad():
            for p, v in zip(tm.parameters(), vals):
                p.copy_(torch.from_numpy(f32(v)))
        return tm

    return jb, jf, port


def test_latent_ode_bf16_plain_path_matches_jax_and_kernel_refuses():
    """The plain bf16 path (the field evaluated in bf16, integrated in
    float32) against JAX's under ``fwd_rule``; the kernel route
    refuses a bf16 model, as JAX's does."""
    jb, jf, port = latent_ode_pair()
    x = np.random.default_rng(2).uniform(0, 1, (5, 10, 24)).astype(np.float32)
    t = (np.arange(10) * 0.05).astype(np.float32)
    def named(res):
        (xh, z, _), mu, lv, _ = res
        return {"x_hat": xh, "z_hat": z, "mu": mu, "logvar": lv}

    ob = named(_jax_call(jb, jnp.asarray(x), jnp.asarray(t)))
    of = named(_jax_call(jf, jnp.asarray(x), jnp.asarray(t)))
    tm = port()
    with torch.no_grad():
        got = named(tm(torch.from_numpy(x), torch.from_numpy(t)))
    for k, v in got.items():
        assert v.dtype == BF and v.shape == ob[k].shape, k
        fwd_rule(k, f32(v), f32(ob[k]), f32(of[k]), "LatentODE")
    with pytest.raises(ValueError, match="float32 models only"):
        with torch.no_grad():
            port(use_kernel_solve=True)(torch.from_numpy(x),
                                        torch.from_numpy(t))


# -- what the bf16 kernels refuse, checked before any launch -----------------

def test_heads_kernel_dtype_checks_raise_on_the_cpu():
    """The card entry points raise ValueError for a dtype without an
    instance, weights and input of different dtypes, packed weights of a
    third dtype, and a CPU tensor; they never fall back to the plain
    version."""
    _, _, th, rng = heads_pair("relu", 0.3)
    x = torch.from_numpy(bf16_inputs(rng, (2, 5, 32))[0])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rc.goku_heads_cuda(*th, x.half())
    with pytest.raises(ValueError, match="share a dtype"):
        rc.goku_heads_cuda(*th, x.float())
    with pytest.raises(ValueError, match="CUDA tensor"):
        rc.goku_heads_cuda(*th, x.to(BF))
    with pytest.raises(ValueError, match="packed weights"):
        rc._kernel_weights(torch.zeros(3, dtype=torch.float16), BF)
    tape = torch.zeros(2, 5, 416, dtype=BF)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rc.goku_heads_bwd_cuda(*th, tape.half(), torch.zeros(2, 16),
                               torch.zeros(2, 32))
    with pytest.raises(ValueError, match="share a dtype"):
        rc.goku_heads_bwd_cuda(*th, tape.float(), torch.zeros(2, 16),
                               torch.zeros(2, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rc.goku_heads_bwd_cuda(*th, tape, torch.zeros(2, 16, dtype=BF),
                               torch.zeros(2, 32, dtype=BF))
    assert rc.goku_heads_cuda.launches == 0
    # the entry point takes the plain route on CPU tensors, in bf16
    z, theta = rc.goku_heads(*th, x.to(BF))
    assert z.dtype == theta.dtype == BF


def test_packed_bf16_weights_are_exact_in_float32():
    """The kernels read the bf16 heads' weights packed in float32: the same
    values, at the compiled widths and at the heads' own."""
    _, _, th, _ = heads_pair("tanh", 0.3, D=10, H=8)
    spec = rc._Spec(2, 10, 8, 2, *rc.kernel_widths(10, 8))
    wts = rc._packed(spec, rc._heads_params(*th), torch.device("cpu"), BF)
    assert wts.dtype == torch.float32
    ref = rc.pack_goku_heads(*th, D=spec.Dk, H=spec.Hk)
    assert ref.dtype == BF
    np.testing.assert_array_equal(wts.numpy(), f32(ref))
    with pytest.raises(ValueError, match="share a dtype"):
        rc._packed(spec, rc._heads_params(*th), torch.device("cpu"),
                   torch.float32)
