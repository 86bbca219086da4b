"""The port's tutorial (latentdiffeq_torch/examples/tutorial/) on the CPU.

The tutorial's ``main(["--epochs", "1", "--device", "cpu"])`` runs every
section on a small synthetic video (80 trajectories of 100 28x28 frames,
through a patched loader, figures under ``tmp_path``): the shape checks,
the manual forward, the loss, one epoch of training with finite losses,
and section 14's decode of ``benchmarks/artifacts/goku_best_model.npz``,
held against JAX's model on the same weights, the same validation sample
and window (the same ``default_rng(4)`` draws) and the decoder key
``PRNGKey(0)``: the latent trajectory, the frames and the inferred length
within 1e-5. ``make_notebook.split_sections`` gives the port's tutorial
the JAX tutorial's section banners (their numbers and first sentences,
in order), with code between them.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

from latentdiffeq_torch.examples.tutorial import (  # noqa: E402
    make_notebook as pmn, tutorial as ptut)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's parallel workers would
    oversubscribe the CPU otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_video(n=80, T=100, seed=0):
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(n, T, 2)).astype(np.float32)
    ps = rng.uniform(1, 2, (n, 1)).astype(np.float32)
    frames = rng.uniform(0, 1, (n, T, 28, 28)).astype(np.float32)
    return latent, latent[:, 0].copy(), ps, frames


def jax_best():
    """JAX's default GOKU holding goku_best_model.npz."""
    import jax

    from latentdiffeq import make_options
    from latentdiffeq.models import GOKUBasic, LatentDiffEqModel
    from latentdiffeq.models import default_layers
    from latentdiffeq.train import optim
    from latentdiffeq.train.checkpoint import load_checkpoint
    sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))
    from pendulum import Pendulum

    diffeq = Pendulum(options=make_options(adaptive=False, substeps=1))
    opt = optim.adamw(1e-3, 0.9, 0.999, 1e-3)

    def template():
        enc, dec = default_layers(jax.random.PRNGKey(0), GOKUBasic(), 784,
                                  diffeq)
        jm = LatentDiffEqModel.build(GOKUBasic(), enc, dec)
        return {"key": jax.random.PRNGKey(0), "model": jm,
                "opt_state": opt.init(jm)}

    # the structure alone (no weights drawn): the file fills the leaves
    tree, _ = load_checkpoint(ptut.CHECKPOINT, jax.eval_shape(template))
    return tree["model"]


def test_tutorial_runs_and_decodes_the_checkpoint_as_jax(monkeypatch,
                                                         tmp_path):
    import jax
    import jax.numpy as jnp

    data = synthetic_video()
    monkeypatch.setattr(ptut, "load_or_generate", lambda **kw: data)
    monkeypatch.setattr(ptut, "OUTPUT_DIR", str(tmp_path))
    res = ptut.main(["--epochs", "1", "--device", "cpu"])
    hist = res["trainer"].history
    assert len(hist) == 1
    assert np.isfinite(hist[0]["train_loss"]) and np.isfinite(
        hist[0]["val_loss"])
    assert all(os.path.exists(p) for p in res["figures"])
    assert len(res["figures"]) == 5
    d = res["decoded"]
    val = data[3].reshape(80, 100, 784)[72:]
    r = np.random.default_rng(4)
    j = int(r.integers(0, 8))
    s = int(r.integers(0, 100 - 60))
    assert (d["j"], d["s"]) == (j, s)
    (xh, zh, lh), _, _, _ = jax_best()(
        jnp.asarray(val[j:j + 1, s:s + 60]),
        jnp.arange(60, dtype=jnp.float32) * 0.05, variational=False,
        key=jax.random.PRNGKey(0))
    np.testing.assert_allclose(d["z"], np.asarray(zh)[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d["x_hat"], np.asarray(xh)[0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(d["theta_hat"], float(lh[1].ravel()[0]),
                               rtol=0, atol=1e-5)


def _headings(chunks):
    """Each section banner's number and first sentence."""
    out = []
    for kind, src in chunks[1:]:
        if kind == "md":
            num, rest = " ".join(src[3:].split()).split(" ", 1)
            out.append(f"{num} {rest.split('. ')[0]}")
    return out


def test_notebook_sections_match_the_jax_tutorial():
    """The port's tutorial splits into the JAX tutorial's 15 section
    banners (1-14 and 2b: their numbers and first sentences, in order),
    each followed by code."""
    sys.path.insert(0, os.path.join(ROOT, "examples", "tutorial"))
    import make_notebook as jmn

    with open(os.path.join(ROOT, "examples", "tutorial",
                           "tutorial.py")) as f:
        jchunks = jmn.split_sections(f.read())
    with open(pmn.SRC) as f:
        pchunks = pmn.split_sections(f.read())
    assert _headings(pchunks) == _headings(jchunks)
    assert len(_headings(pchunks)) == 15
    assert pchunks[0][1].startswith("# GOKU-net pendulum tutorial")
    kinds = [k for k, _ in pchunks]
    assert kinds[:2] == ["md", "code"]
    for a, b in zip(kinds[1:], kinds[2:]):
        assert a != b
    compile("\n".join(src for k, src in pchunks if k == "code"), "t", "exec")
