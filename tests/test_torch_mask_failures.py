"""``loss_batch(mask_failures=True)`` on rows whose solve really fails: a
small adaptive SPendulum GOKU whose step budget (9 steps, depth cap 2) 3 of
8 rows outrun, their trajectories NaN-filled, in both packages on the same
weights, noise and Brownian key.

- The loss and its metrics equal JAX's (1e-5).
- Every gradient of the port is finite: the decoder reconstructs zeros for
  a failed row and adds the NaNs after it, and the loss masks the row's
  reconstruction before the squared error, so the mask's zero cotangent
  never meets a NaN. JAX's single ``where`` (losses.py:115-119) gives the
  reconstructor NaN gradients there; wherever JAX's gradient is finite the
  port's equals it within 1e-4 of its size.
- Unmasked, both losses are NaN and the NaNs reach the port's gradients,
  as they reach JAX's (the reference lets them flow).
- The model's outputs are JAX's, NaN where JAX's are.
These run in the Trainer's block mode too (a captured epoch whose rows
fail; ``chip_smoke.py`` phase 4n (b))."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

from pendulum import SPendulum as JSPendulum  # noqa: E402

from latentdiffeq.solve.sde import SDEAdaptiveConfig as JCfg  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch.pendulum import SPendulum  # noqa: E402
from latentdiffeq_torch.solve.sde import SDEAdaptiveConfig  # noqa: E402
from latentdiffeq_torch.train import jax_param_paths, loss_batch  # noqa: E402
from test_torch_sde_goku import noise, small_pair  # noqa: E402

CFG = dict(max_steps=9, depth_cap=2, rtol=1e-2, atol=1e-2)


@pytest.fixture(scope="module")
def case():
    jm, tm = small_pair(JSPendulum(adaptive=True, adaptive_cfg=JCfg(**CFG)),
                        SPendulum(adaptive=True,
                                  adaptive_cfg=SDEAdaptiveConfig(**CFG)))
    x = np.random.default_rng(1).uniform(0, 1, (8, 8, 24)).astype(
        np.float32)
    t = (np.arange(8) * 0.05).astype(np.float32)
    key = jax.random.PRNGKey(11)
    eps, dk = noise(key, jm.encoder(jnp.asarray(x))[0])
    return jm, tm, x, t, key, eps, dk


def port(tm, x, t, eps, dk, masked):
    tm.zero_grad()
    loss, m = loss_batch(tm, torch.from_numpy(x), torch.from_numpy(t), 0.5,
                         variational=True, eps=eps, key=dk,
                         mask_failures=masked)
    loss.backward()
    return loss.detach(), m, {p: q.grad.numpy() for p, q in
                              zip(jax_param_paths(tm), tm.parameters())}


def jax_side(jm, x, t, key, masked):
    def f(m):
        return jlosses.loss_batch(m, jnp.asarray(x), jnp.asarray(t), 0.5,
                                  variational=True, key=key,
                                  mask_failures=masked)
    (loss, m), g = jax.value_and_grad(f, has_aux=True)(jm)
    return loss, m, {_path_str(p): np.asarray(v) for p, v in
                     jax.tree_util.tree_flatten_with_path(g)[0]}


def test_masked_failures_keep_the_gradients_finite(case):
    jm, tm, x, t, key, eps, dk = case
    loss, m, g = port(tm, x, t, eps, dk, True)
    jloss, jm_, jg = jax_side(jm, x, t, key, True)
    assert int(m["n_failed"]) == int(jm_["n_failed"]) == 3
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("rec", "kl"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm_[k]),
                                   rtol=1e-5, err_msg=k)
    nan_in_jax = []
    for path, a in g.items():
        assert np.isfinite(a).all(), path
        b = jg[path]
        if not np.isfinite(b).all():
            nan_in_jax.append(path)
            continue
        size = max(np.abs(b).max(), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * size,
                                   err_msg=path)
    # JAX's NaN gradients are the reconstructor's alone
    assert nan_in_jax and all("reconstructor" in p for p in nan_in_jax)


def test_unmasked_failures_let_the_nans_flow(case):
    jm, tm, x, t, key, eps, dk = case
    loss, _, g = port(tm, x, t, eps, dk, False)
    jloss, _, jg = jax_side(jm, x, t, key, False)
    assert np.isnan(float(loss)) and np.isnan(float(jloss))
    assert any(not np.isfinite(a).all() for a in g.values())


def test_outputs_are_jax_nan_fill(case):
    jm, tm, x, t, key, eps, dk = case
    (xh_j, z_j, _), _, _, aux_j = jm(jnp.asarray(x), jnp.asarray(t),
                                     variational=True, key=key)
    with torch.no_grad():
        (xh, z, _), _, _, aux = tm(torch.from_numpy(x), torch.from_numpy(t),
                                   variational=True, eps=eps, key=dk)
    ok = aux["success"].numpy()
    np.testing.assert_array_equal(ok, np.asarray(aux_j["success"]))
    assert not ok.all() and ok.any()
    for a, b in ((xh, xh_j), (z, z_j)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[ok], b[ok], rtol=0, atol=1e-4)
