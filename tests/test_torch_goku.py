"""Parity of the PyTorch port's GOKU model and checkpoint loaders against
the JAX package, on the CPU: the full-width GOKU forward with the committed
`benchmarks/artifacts/goku_best_model.npz` weights (x_hat atol 1e-4: 784
outputs through a 200-wide resnet and a 20-step solve), the variational
sample given the same noise, the masked path, NaN-fill, and both .npz
formats."""
import dataclasses
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
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.train import optim as joptim  # noqa: E402
from latentdiffeq.train.checkpoint import (_path_str,  # noqa: E402
                                           load_checkpoint as jload)
from latentdiffeq_torch.adjoint import SolveOptions  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum  # noqa: E402
from latentdiffeq_torch.train import optim as toptim  # noqa: E402
from latentdiffeq_torch.train.checkpoint import (jax_param_paths,  # noqa: E402
                                                 load_checkpoint,
                                                 load_jax_params,
                                                 save_checkpoint)

ARTIFACTS = os.path.join(ROOT, "benchmarks", "artifacts")
V1 = os.path.join(ARTIFACTS, "goku_best_model.npz")
V2 = os.path.join(ARTIFACTS, "ttg_px_winner.npz")


def jax_model(**kw):
    diffeq = JPendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = jdefault_layers(jax.random.PRNGKey(0), JGOKUBasic(), 784,
                               diffeq, **kw)
    return JModel.build(JGOKUBasic(), enc, dec)


def torch_model(use_kernels=False, **kw):
    diffeq = Pendulum(options=SolveOptions(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(784, diffeq, device="cpu", **kw)
    return LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=use_kernels,
                  use_kernel_solver=use_kernels), enc, dec)


@pytest.fixture(scope="module")
def best():
    """(JAX model, port model) holding goku_best_model.npz's weights."""
    jm = jax_model()
    opt = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    tree, _ = jload(V1, {"key": jax.random.PRNGKey(0), "model": jm,
                         "opt_state": opt.init(jm)})
    tm = torch_model()
    load_checkpoint(V1, tm)
    return tree["model"], tm


def frames(B=4, T=20, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (B, T, 784))
    return x.astype(np.float32), (np.arange(T) * 0.05).astype(np.float32)


def close(t, a, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), rtol=0,
                               atol=atol)


def test_flatten_order_matches_jax():
    jm, tm = jax_model(), torch_model()
    jpaths = [_path_str(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jm)[0]]
    assert jax_param_paths(tm) == jpaths
    assert len(jpaths) == 60


def test_goku_forward_matches_jax_on_best_weights(best):
    jm, tm = best
    x, t = frames()
    (xh_j, z_j, (z0_j, th_j)), mu_j, lv_j, aux_j = jax.jit(
        lambda m, a, b: m(a, b))(jm, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        (xh, z, (z0, th)), mu, lv, aux = tm(torch.from_numpy(x),
                                            torch.from_numpy(t))
    assert xh.shape == (4, 20, 784)
    close(xh, xh_j, 1e-4)
    close(z, z_j, 1e-4)
    close(th, th_j, 1e-4)
    for a, b in zip(mu + lv, tuple(mu_j) + tuple(lv_j)):
        close(a, b, 1e-4)
    assert bool(aux["success"].all())
    assert int(aux["stats"]["n_rhs_evals"]) == int(
        aux_j["stats"]["n_rhs_evals"]) == 4 * 19 * 6


def test_goku_sample_with_same_noise_matches_jax(best):
    jm, tm = best
    x, t = frames(B=3, T=12, seed=1)
    key = jax.random.PRNGKey(7)
    (xh_j, _, (z0_j, th_j)), mu_j, lv_j, _ = jm(
        jnp.asarray(x), jnp.asarray(t), variational=True, key=key)
    # the noise the JAX model drew: key -> (skey, dkey); skey -> (k1, k2)
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, lv.shape)))
                for k, lv in zip((k1, k2), lv_j))
    with torch.no_grad():
        (xh, _, (z0, th)), _, _, _ = tm(torch.from_numpy(x),
                                        torch.from_numpy(t),
                                        variational=True, eps=eps)
    close(z0, z0_j, 1e-4)
    close(th, th_j, 1e-4)
    close(xh, xh_j, 1e-4)


def test_kernel_switches_on_cpu_run_the_plain_path(best):
    _, tm = best
    tk = torch_model(use_kernels=True)
    tk.load_state_dict(tm.state_dict())
    x, t = frames(B=2, T=10, seed=2)
    with torch.no_grad():
        a = tm(torch.from_numpy(x), torch.from_numpy(t))[0][0]
        b = tk(torch.from_numpy(x), torch.from_numpy(t))[0][0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_masked_path_matches_jax(best):
    """cur_len (masked curriculum) bypasses the encoder kernel in both
    packages and encodes only the first cur_len frames."""
    jm, tm = best
    x, t = frames(B=2, T=12, seed=3)
    (xh_j, _, _), mu_j, _, _ = jm(jnp.asarray(x), jnp.asarray(t),
                                  cur_len=jnp.int32(7))
    tk = torch_model(use_kernels=True)
    tk.load_state_dict(tm.state_dict())
    with torch.no_grad():
        (xh, _, _), mu, _, _ = tk(torch.from_numpy(x), torch.from_numpy(t),
                                  cur_len=7)
        (xs, _, _), mus, _, _ = tm(torch.from_numpy(x[:, :7]),
                                   torch.from_numpy(t))
    close(xh, xh_j, 1e-4)
    close(mu[1], mu_j[1], 1e-5)
    torch.testing.assert_close(mu[0], mus[0], rtol=0, atol=1e-6)


def test_forecast_matches_jax(best):
    jm, tm = best
    x, _ = frames(B=2, T=10, seed=4)
    t_long = (np.arange(30) * 0.05).astype(np.float32)
    xh_j, _, _ = jm.forecast(jnp.asarray(x), jnp.asarray(t_long))
    with torch.no_grad():
        xh, _, _ = tm.forecast(torch.from_numpy(x), torch.from_numpy(t_long))
    assert xh.shape == (2, 30, 784)
    close(xh, xh_j, 1e-4)


def test_failed_solves_are_nan_filled():
    tm = torch_model(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    z0 = torch.zeros(3, 2) + 0.3
    th = torch.tensor([[1.5], [0.0], [1.2]])       # L = 0 fails
    t = torch.arange(8) * 0.05
    ys, aux = tm.model_type.diffeq_layer(tm.decoder, (z0, th), t)
    assert aux["success"].tolist() == [True, False, True]
    assert bool(torch.isnan(ys[1]).all()) and bool(
        torch.isfinite(ys[0]).all())
    assert int(aux["stats"]["n_rhs_evals"]) == 3 * 7 * 6


def test_kernel_solver_refuses_unported_interp_stride(best):
    """interp_stride > 1: the plain route solves strided and matches JAX's
    plain route on the same weights (1e-4); the kernel route still raises,
    for the kernel has no strided mode (JAX's kernel route ignores the
    option, which would change results), and is never silently ignored."""
    jm, tm = best
    x, t = frames(B=3, T=11, seed=3)
    jdiffeq = JPendulum(options=make_options(adaptive=False, interp_stride=2))
    jm2 = dataclasses.replace(
        jm, decoder=dataclasses.replace(jm.decoder, diffeq=jdiffeq))
    diffeq = Pendulum(options=SolveOptions(adaptive=False, interp_stride=2))
    for use_kernels in (True, False):
        tk = torch_model(use_kernels=use_kernels)
        tk.load_state_dict(tm.state_dict())
        tk.decoder.diffeq = diffeq
        if use_kernels:
            with pytest.raises(NotImplementedError):
                tk(torch.from_numpy(x), torch.from_numpy(t))
            continue
        (xh_j, z_j, _), _, _, aux_j = jm2(jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            (xh, z, _), _, _, aux = tk(torch.from_numpy(x),
                                       torch.from_numpy(t))
        close(z, z_j, 1e-4)
        close(xh, xh_j, 1e-4)
        assert int(aux["stats"]["n_rhs_evals"]) == int(
            aux_j["stats"]["n_rhs_evals"]) == 3 * (1 + 5 * 6)


def test_v1_loader_reads_model_and_adam_state(best):
    jm, _ = best
    tm = torch_model()
    opt = toptim.adamw(tm.parameters(), 1e-3, decay=1e-3)
    meta = load_checkpoint(V1, tm, opt)
    assert meta["epoch"] == 785
    jarrays = {_path_str(p): np.asarray(l)
               for p, l in jax.tree_util.tree_flatten_with_path(jm)[0]}
    for path, p in zip(jax_param_paths(tm), tm.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), jarrays[path])
    with np.load(V1) as d:
        n = len(jarrays)
        assert opt.t == int(d[f"leaf_{1 + 2 * n}"])
        np.testing.assert_array_equal(opt.m[0].numpy(), d[f"leaf_{1 + n}"])
        np.testing.assert_array_equal(opt.v[-1].numpy(),
                                      d[f"leaf_{1 + 3 * n}"])


def test_v2_loader_and_round_trip_through_jax(tmp_path):
    tm = torch_model()
    opt = toptim.adamw(tm.parameters(), 1e-3, decay=1e-3)
    meta = load_checkpoint(V2, tm, opt)
    assert meta["epoch"] == 300
    with np.load(V2) as d:
        np.testing.assert_array_equal(
            tm.encoder.pattern_extractor[1].cells[0].Wi.detach().numpy(),
            d["leaf::model/encoder/pattern_extractor/1/cells/0/Wi"])
        np.testing.assert_array_equal(
            opt.v[3].numpy(),
            d["leaf::opt_state/v/encoder/feature_extractor/layers/1/layer/b"])
        assert opt.t == int(d["leaf::opt_state/t"])
    # the port's own v2 file loads back into the JAX package
    out = str(tmp_path / "port.npz")
    save_checkpoint(out, tm, opt, meta={"epoch": 3})
    jm = jax_model()
    jo = joptim.adamw(1e-3, 0.9, 0.999, 1e-3)
    tree, jmeta = jload(out, {"model": jm, "opt_state": jo.init(jm)})
    assert jmeta == {"epoch": 3}
    leaves = jax.tree_util.tree_leaves(tree["model"])
    for p, leaf in zip(tm.parameters(), leaves):
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(leaf))
    assert int(tree["opt_state"]["t"]) == opt.t
    tm2 = torch_model()
    load_checkpoint(out, tm2)
    for a, b in zip(tm.parameters(), tm2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_load_jax_params_rejects_mismatch():
    tm = torch_model(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    arrays = {p: t.detach().numpy() for p, t in
              zip(jax_param_paths(tm), tm.parameters())}
    bad = dict(arrays)
    bad.pop("decoder/reconstructor/layers/3/b")
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)
    bad = dict(arrays)
    bad["encoder/latent_in/0/W"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(tm, bad)


def test_default_device_is_the_card():
    diffeq = Pendulum()
    if torch.cuda.is_available():
        pytest.skip("this test checks the error raised without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        goku_default_layers(784, diffeq)
