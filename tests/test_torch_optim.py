"""The port's optimizers against the JAX package's (latentdiffeq/train/
optim.py) on the CPU: ``sgd``, ``adam``, ``adamw``, ``adabelief``,
``clip_by_global_norm`` and ``chain(clip_by_global_norm, adabelief)``,
five steps on the same parameters and gradients, in float32 and bfloat16;
optimizer state in checkpoints under JAX's pytree paths, both ways; and
unbound optimizers bound by the Trainer.

Tolerances. float32: rtol 1e-6 (atol 1e-9) on the parameters after each
step: the same operations in the same order, the global norm's sums aside
(another reduction order). bfloat16: after step k each parameter within k
bfloat16 roundings (k * 2^-7) of the largest of its two values and its
displacement from the start. The port computes every update in float32
and rounds it once into the parameter (its rule for bfloat16 parameters,
which for ADAM(W) is JAX's own arithmetic) and scales its bfloat16
moments by float32 constants; JAX rounds the constants to bfloat16 (0.999
becomes 1) and computes SGD's, AdaBelief's and the clipping's arithmetic
in bfloat16, so each step's deltas differ by bfloat16 roundings, which
move the rounded parameter by a unit or two, and the steps add up.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentdiffeq.train import optim as joptim
from latentdiffeq.train.checkpoint import load_checkpoint as jload
from latentdiffeq_torch.train import (Optimizer, TrainConfig, Trainer,
                                      adabelief, adam, adamw, apply_updates,
                                      chain, clip_by_global_norm,
                                      load_checkpoint, save_checkpoint, sgd,
                                      splitobs)
from test_torch_train import D_IN, small_pair

SHAPES = ((3, 4), (5,), (2, 3, 2))
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's tests: with the suite's
    parallel workers, torch's default of one thread a core oversubscribes
    the CPU and its synchronising threads slow small ops by up to ~70x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (port factory over params, JAX optimizer); clipping at 0.5 so that it
# scales (the gradients' global norm is ~3)
CASES = {
    "sgd": (lambda p: sgd(p, 0.1), joptim.sgd(0.1)),
    "adam": (lambda p: adam(p, 1e-2), joptim.adam(1e-2)),
    "adamw": (lambda p: adamw(p, 1e-2, decay=1e-2),
              joptim.adamw(1e-2, decay=1e-2)),
    "adabelief": (lambda p: adabelief(p, 1e-2), joptim.adabelief(1e-2)),
    "clip": (lambda p: clip_by_global_norm(0.5, p),
             joptim.clip_by_global_norm(0.5)),
    "chain": (lambda p: chain(clip_by_global_norm(0.5), adabelief(lr=1e-2),
                              params=p),
              joptim.chain(joptim.clip_by_global_norm(0.5),
                           joptim.adabelief(1e-2))),
}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _draws(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax_over_five_steps(case, dtype):
    make, jopt = CASES[case]
    tdt, jdt = DTYPES[dtype]
    params0, grads = _draws()
    tp = [torch.tensor(a).to(tdt) for a in params0]   # no aliasing
    jp = [jnp.asarray(a).astype(jdt) for a in params0]
    p0 = [_f32(a) for a in jp]
    opt = make(tp)
    state = jopt.init(jp)
    for k, g in enumerate(grads, 1):
        for p, gi in zip(tp, g):
            p.grad = torch.from_numpy(gi).to(tdt)
        opt.step()
        upd, state = jopt.update([jnp.asarray(gi).astype(jdt) for gi in g],
                                 state, jp)
        jp = joptim.apply_updates(jp, upd)
        for i, (a, b) in enumerate(zip(tp, jp)):
            assert a.dtype == tdt and b.dtype == jdt
            got, want = a.float().numpy(), _f32(b)
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
            else:
                scale = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                                   np.abs(want - p0[i]))
                tol = k * 2.0 ** -7 * scale
                assert np.all(np.abs(got - want) <= tol), (
                    case, k, np.max(np.abs(got - want) / tol))


def test_update_returns_deltas_and_apply_updates_subtracts():
    params0, grads = _draws(1)
    tp = [torch.tensor(a) for a in params0]
    deltas = adabelief(tp, 1e-2).update([torch.from_numpy(g)
                                         for g in grads[0]])
    ref = [p.clone() for p in tp]
    apply_updates(tp, deltas)
    for p, r, d in zip(tp, ref, deltas):
        torch.testing.assert_close(p, r - d, rtol=0, atol=0)


def test_unbound_optimizer_refuses_to_step_and_binds():
    opt = chain(clip_by_global_norm(1.0), adabelief(lr=1e-3))
    assert isinstance(opt, Optimizer) and opt.params is None
    with pytest.raises(ValueError, match="not bound"):
        opt.zero_grad()
    p = torch.ones(3, requires_grad=True)
    opt.bind([p])
    assert all(o.params == [p] for o in opt.opts)
    with pytest.raises(ValueError, match="learning rate"):
        sgd()


@pytest.fixture(scope="module")
def pair():
    return small_pair(seed=2, scale=0.2)


def test_chain_state_uses_jax_paths_both_ways(pair, tmp_path):
    """A chain(clip, adabelief) state after two steps, saved by the port,
    loads into JAX's load_checkpoint with the template {"model",
    "opt_state": chain.init(model)} bit for bit (``opt_state/1/m/...``,
    ``opt_state/1/s/...``), and back into a fresh port optimizer."""
    jm, tm = pair
    opt = chain(clip_by_global_norm(1.0), adabelief(lr=1e-3),
                params=tm.parameters())
    rng = np.random.default_rng(3)
    for _ in range(2):
        for p in tm.parameters():
            p.grad = torch.from_numpy(rng.normal(
                size=tuple(p.shape)).astype(np.float32))
        opt.step()
    out = str(tmp_path / "chain.npz")
    save_checkpoint(out, tm, opt, meta={"epoch": 2})
    with np.load(out) as d:
        assert "leaf::opt_state/1/s/decoder/reconstructor/layers/3/b" in d
    jopt = joptim.chain(joptim.clip_by_global_norm(1.0),
                        joptim.adabelief(1e-3))
    tree, meta = jload(out, {"model": jm, "opt_state": jopt.init(jm)})
    assert meta == {"epoch": 2}
    for a, b in zip(opt.opts[1].m + opt.opts[1].s,
                    jax.tree_util.tree_leaves(tree["opt_state"][1]["m"])
                    + jax.tree_util.tree_leaves(tree["opt_state"][1]["s"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = chain(clip_by_global_norm(1.0), adabelief(lr=1e-3),
                 params=tm.parameters())
    load_checkpoint(out, tm, back)
    for a, b in zip(opt.opts[1].m + opt.opts[1].s,
                    back.opts[1].m + back.opts[1].s):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(out, tm, adamw(tm.parameters(), 1e-3))


def test_trainer_with_adabelief_checkpoint_restores(pair, tmp_path):
    """Trainer(model, cfg, optimizer=chain(clip, adabelief)) binds the
    unbound chain, trains, saves; a fresh Trainer with the same optimizer
    restores the weights and both moments bit for bit, and both then take
    the same step."""
    _, tm = pair
    x = np.random.default_rng(4).uniform(0, 1, (20, 10, D_IN)).astype(
        np.float32)
    tr_set, va_set = splitobs(x, 0.8)
    cfg = TrainConfig(batch_size=8, seq_len=8, epochs=3, save_best=False,
                      checkpoint_dir=str(tmp_path))

    def make():
        return chain(clip_by_global_norm(1.0), adabelief(lr=1e-3))

    a = Trainer(small_pair(seed=2, scale=0.2)[1], cfg, optimizer=make(),
                device="cpu")
    assert a.opt.params[0] is next(a.model.parameters())
    a.fit(tr_set, va_set, epochs=2, verbose=False)
    path = str(tmp_path / "ab.npz")
    a.save(path)
    b = Trainer(small_pair(seed=5, scale=0.2)[1], cfg, optimizer=make(),
                device="cpu").restore(path)
    for x1, x2 in zip(a.opt.opts[1].m + a.opt.opts[1].s,
                      b.opt.opts[1].m + b.opt.opts[1].s):
        torch.testing.assert_close(x1, x2, rtol=0, atol=0)
    a.fit(tr_set, va_set, verbose=False)
    b.fit(tr_set, va_set, verbose=False)
    for p1, p2 in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(p1, p2, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(200, 300), (500,), (40, 3, 60)])
def test_glorot_uniform_draws_from_jax_s_distribution(shape):
    """nn.glorot_uniform (init.py:34-42): U(-b, b), b = sqrt(6 / (fan_in +
    fan_out)), fan_in the first axis and fan_out the last (1 for a vector).
    The draws come from torch's generator, not threefry, so the test holds
    the distribution: both packages' samples lie in [-b, b], reach past
    0.99 b, and their variances are within 5 % of b^2 / 3."""
    from latentdiffeq.nn import init as jinit
    from latentdiffeq_torch import nn as tnn
    fan_in, fan_out = shape[0], (shape[-1] if len(shape) >= 2 else 1)
    b = np.sqrt(6.0 / (fan_in + fan_out))
    t = tnn.glorot_uniform()(shape, torch.Generator().manual_seed(0)).numpy()
    j = np.asarray(jinit.glorot_uniform()(jax.random.PRNGKey(0), shape))
    for a in (t, j):
        assert a.shape == shape and a.dtype == np.float32
        assert np.abs(a).max() <= b and np.abs(a).max() > 0.99 * b
        np.testing.assert_allclose(a.var(), b * b / 3, rtol=0.05)
