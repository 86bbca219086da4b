"""The port's utilities (latentdiffeq_torch/utils/) against the JAX
package's, on the CPU.

- ``PhaseTimer``: the same phases give ``summary()``s of the same keys,
  value types and rounding as JAX's; ``block_on`` accepts nested results;
- ``trace_profile`` writes a Chrome trace naming the region's operations;
  ``device_profile`` records its region from the step after its warm-up;
  ``lost_kernel_records`` counts launches that have no kernel record,
  the region's apart from those of ``device_profile``'s pads;
- ``enable_debug_nans``: the same inputs through both packages, a NaN made
  in the forward (the KL of an infinite log-variance, a log of a negative
  number) raises ``FloatingPointError`` in both, clean inputs in neither,
  and the mode is off again after ``enable_debug_nans(False)``;
- the native rasterizer (the port's own copy of the C++ source, built into
  ``build/native/``) equal to JAX's ``native_render_trajectories`` and
  within JAX's tolerance of JAX's renderer (atol 2e-6 with
  ``assert_allclose``'s rtol 1e-7, tests/test_native.py:27),
  and against the port's torch renderer within 1e-5 (that renderer's
  tolerance against JAX's, tests/test_torch_train.py); and
  ``create_data.load_or_generate(renderer="native")``: the trajectories
  equal and the frames within 1e-5 of the torch-rendered cache's, the
  renderer in the cache key. Skipped without ``g++``, as the JAX test is.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from latentdiffeq import utils as jutils  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq_torch import utils  # noqa: E402
from latentdiffeq_torch.examples.pendulum import create_data as pcreate  # noqa: E402
from latentdiffeq_torch.train import losses  # noqa: E402

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ toolchain")


def test_phase_timer_summary_equals_jax_shape():
    pt, jt = utils.PhaseTimer(), jutils.PhaseTimer()
    for timer, block in ((pt, {"a": [torch.ones(3)], "b": torch.zeros(1)}),
                         (jt, {"a": [jnp.ones(3)], "b": jnp.zeros(1)})):
        for phase in ("solve", "solve", "loss"):
            with timer(phase, block_on=block):
                sum(range(1000))
    ps, js = pt.summary(), jt.summary()
    assert list(ps) == list(js) == ["solve", "loss"]
    for k in js:
        assert list(ps[k]) == list(js[k])
        assert {n: type(v) for n, v in ps[k].items()} == {
            n: type(v) for n, v in js[k].items()}
        assert ps[k]["count"] == js[k]["count"]
        assert ps[k]["total_s"] == round(pt.totals[k], 4)
        assert ps[k]["mean_ms"] == round(1e3 * pt.totals[k] / pt.counts[k], 3)
    pt.reset()
    assert pt.summary() == {}


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with utils.trace_profile(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_device_profile_records_the_region_after_its_warm_up():
    with utils.device_profile() as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof.step_num == 1
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2.0, "args": {"correlation": corr}}


def _kernel(corr, ts):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": 1.0,
            "args": {"correlation": corr}}


LOSS_CASES = {
    # the first two launches of the window have no kernel record
    "a prefix": ([1, 2], [], {"launches": 5, "lost": 2,
                              "lost_are_a_prefix": True,
                              "lost_span_us": 10.0}),
    "one inside": ([3], [], {"launches": 5, "lost": 1,
                             "lost_are_a_prefix": False,
                             "lost_span_us": 20.0}),
    "none": ([], [], {"launches": 5, "lost": 0, "lost_are_a_prefix": True,
                      "lost_span_us": 0.0}),
    # device_profile's pads span 5-25 us and 45-60 us: launches 1, 2 and 5
    # are theirs (1 lost), the region's are 3 and 4 (4 lost)
    "between pads": ([1, 4], [(5.0, 25.0), (45.0, 60.0)],
                     {"launches": 2, "lost": 1, "lost_are_a_prefix": False,
                      "lost_span_us": 10.0, "pad_launches": 3,
                      "pad_lost": 1}),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_lost_kernel_records(tmp_path, case):
    lost, pads, want = LOSS_CASES[case]
    want = {"pad_launches": 0, "pad_lost": 0, **want}
    ev = [{"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 50.0,
           "args": {}}, {"cat": "cuda_driver", "name": "cuGetProcAddress",
                         "ts": 1.0, "dur": 1.0, "args": {}}]
    ev += [{"cat": "user_annotation", "name": utils.PAD, "ts": lo,
            "dur": hi - lo, "args": {}} for lo, hi in pads]
    for c in range(1, 6):
        ev.append(_launch(c, 10.0 * c))
        if c not in lost:
            ev.append(_kernel(c, 10.0 * c + 5.0))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev[::-1]}))
    assert utils.lost_kernel_records(str(path)) == want


DEBUG_CASES = {
    "kl of an infinite log-variance": (np.array([[0.5, -1.0]]),
                                       np.array([[np.inf, 0.0]]), True),
    "clean": (np.array([[0.5, -1.0]]), np.array([[0.3, -2.0]]), False),
}


@pytest.mark.parametrize("name", list(DEBUG_CASES))
def test_debug_nans_raises_where_jax_raises(name):
    mu, lv, raises = (np.asarray(a, np.float32) if i < 2 else a
                      for i, a in enumerate(DEBUG_CASES[name]))
    jfn = jax.jit(lambda m, v: jlosses.vector_kl(m, v))
    outcomes = []
    for enable, fn, arr in ((jutils.enable_debug_nans, jfn, jnp.asarray),
                            (utils.enable_debug_nans, losses.vector_kl,
                             torch.from_numpy)):
        enable(True)
        try:
            float(fn(arr(mu), arr(lv)))
            outcomes.append(False)
        except FloatingPointError:
            outcomes.append(True)
        finally:
            enable(False)
    assert outcomes == [raises, raises]
    # switched off: the NaN flows through, as without the mode
    assert np.isnan(float(losses.vector_kl(torch.from_numpy(mu),
                                           torch.from_numpy(lv)))) == raises


def test_debug_nans_catches_a_forward_nan_and_ignores_nan_fills():
    utils.enable_debug_nans(True)
    try:
        with pytest.raises(FloatingPointError, match="aten::log"):
            torch.log(torch.tensor([1.0, -1.0]))
        # a NaN fill that no row takes (GOKU's failed-row convention)
        ys = torch.ones(2, 3)
        ok = torch.tensor([True, True])
        out = torch.where(ok[:, None], ys, torch.full_like(ys, float("nan")))
        (out * 2).sum()
    finally:
        utils.enable_debug_nans(False)
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


@needs_gxx
def test_native_rasterizer_matches_jax_and_torch():
    from create_data import render_trajectory

    from latentdiffeq.utils.native import native_render_trajectories as jnat
    from latentdiffeq_torch.pendulum_data import render_frames
    from latentdiffeq_torch.utils.native import (
        BUILD_DIR, native_render_trajectories)

    angles = np.random.default_rng(0).uniform(-0.7, 0.7, (3, 8)) \
        .astype(np.float32)
    out = native_render_trajectories(angles)
    assert out.shape == (3, 8, 28, 28) and out.dtype == np.float32
    assert os.path.exists(os.path.join(BUILD_DIR, "librasterizer.so"))
    np.testing.assert_array_equal(out, jnat(angles))
    out_j = np.stack([np.asarray(render_trajectory(jnp.asarray(a)))
                      for a in angles])
    # JAX's assertion (its default rtol 1e-7 beside atol 2e-6)
    np.testing.assert_allclose(out, out_j, atol=2e-6)
    # the port's torch renderer is 1e-5 from JAX's renderer
    # (test_torch_train.py::test_render_frames_match_jax); here 2.03e-6
    np.testing.assert_allclose(
        out, render_frames(torch.from_numpy(angles)).numpy(), rtol=0,
        atol=1e-5)


@needs_gxx
def test_load_or_generate_native_renderer(monkeypatch, tmp_path):
    monkeypatch.setattr(pcreate, "DATA_DIR", str(tmp_path))
    kw = dict(n_traj=3, seed=0, tspan=(0.0, 0.45), device="cpu")
    torch_made = pcreate.load_or_generate(**kw)
    native = pcreate.load_or_generate(renderer="native", **kw)
    for a, b in zip(native[:3], torch_made[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(native[3], torch_made[3], rtol=0, atol=1e-5)
    # the cache now holds the native frames, keyed as such
    path = os.path.join(str(tmp_path), pcreate.DEFAULT_FILE)
    assert pcreate._stored_key(path)["renderer"] == "native"
    assert (pcreate.cache_key(renderer="native", **kw)
            != pcreate.cache_key(**kw))
    with pytest.raises(ValueError, match="renderer"):
        pcreate.load_or_generate(renderer="jax", **kw)
