"""Any user-written field on the batched RK kernel: the tracer
(ops/rhs_trace.py), the functor it generates (ops/rhs_codegen.py) and the
dispatch (ops/ode_cuda.py), on the CPU.

The generated CUDA source builds only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 4l); here the lowered programs are interpreted op by op
against the field and ``torch.func.vjp`` (bit for bit), the functor's text
is compiled as host C++ with ``g++`` and held against torch, and the plain
versions the kernel is held to on the card are held against JAX's Pallas
solve (interpret mode) and its ``custom_vjp``, on the same fields written
in jnp. Inputs come from numpy generators with fixed seeds.
"""
import ctypes
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import latentdiffeq as ldq  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import ODEDynamics as JODEDynamics  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched  # noqa: E402
from latentdiffeq.solve import rk as jrk  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
import latentdiffeq_torch as ldt  # noqa: E402
from latentdiffeq_torch import custom_dynamics as cdyn  # noqa: E402
from latentdiffeq_torch import make_options  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       ODEDynamics, goku_default_layers)
from latentdiffeq_torch.ops import (_build, ode_cuda, rhs_codegen,  # noqa: E402
                                    rhs_trace)
from latentdiffeq_torch.pendulum import pendulum_f  # noqa: E402
from latentdiffeq_torch.solve import rk as trk  # noqa: E402
from latentdiffeq_torch.train import Trainer, TrainConfig, losses  # noqa: E402
from latentdiffeq_torch.train.checkpoint import load_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as the other heavy port files run (the bit for
    bit checks hold at any thread count: every op here is elementwise or
    a sum of at most three terms)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The fields, each in torch and in jnp (one row, as JAX's Pallas solve
# vmaps it)

def tutorial_field():
    """The tutorial's own pendulum_f: the code of section 1 of
    tutorial.main, as the notebook runs it."""
    from latentdiffeq_torch.examples.tutorial import make_notebook, tutorial
    with open(tutorial.__file__) as fh:
        text = fh.read()
    code = next(src for kind, src in make_notebook.split_sections(text)
                if kind == "code" and "def pendulum_f" in src)
    ns = {"ldq": ldt, "torch": torch}
    exec(code, ns)
    return ns["pendulum_f"]


def pendulum_untagged(u, p, t):
    return pendulum_f(u, p, t)


def vdp_untagged(u, p, t):
    return cdyn.vdp_f(u, p, t)


def forced(u, p, t):
    """A forced damped oscillator: x'' = -k x - c x' + a cos(2 t), p = (k,
    c, a): it reads t."""
    x, v = u[..., 0], u[..., 1]
    k, c, a = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([v, -k * x - c * v + a * torch.cos(2.0 * t)], dim=-1)


def lotka_volterra(u, p, t):
    x, y = u[..., 0], u[..., 1]
    a, b, c, d = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([a * x - b * x * y, d * x * y - c * y], dim=-1)


def kuramoto3(u, p, t):
    """Kuramoto on 3 phases as a user writes it: p = (omega, K)."""
    s = torch.sin(u[..., None, :] - u[..., :, None])
    return p[..., 0:1] + p[..., 1:2] / 3 * s.sum(-1)


def j_pendulum(u, p, t):
    return jnp.stack([u[1], -10.0 / p[0] * jnp.sin(u[0])])


def j_vdp(u, p, t):
    return jnp.stack([u[1], p[0] * (1.0 - u[0] * u[0]) * u[1] - u[0]])


def j_forced(u, p, t):
    return jnp.stack([u[1], -p[0] * u[0] - p[1] * u[1]
                      + p[2] * jnp.cos(2.0 * t)])


def j_lotka_volterra(u, p, t):
    return jnp.stack([p[0] * u[0] - p[1] * u[0] * u[1],
                      p[3] * u[0] * u[1] - p[2] * u[1]])


def j_kuramoto3(u, p, t):
    s = jnp.sin(u[None, :] - u[:, None])
    return p[0] + p[1] / 3 * s.sum(-1)


# name -> (torch field, jnp field, dim, pdim)
FIELDS = {
    "tutorial": (None, j_pendulum, 2, 1),
    "pendulum-untagged": (pendulum_untagged, j_pendulum, 2, 1),
    "vdp-untagged": (vdp_untagged, j_vdp, 2, 1),
    "forced": (forced, j_forced, 2, 3),
    "lotka-volterra": (lotka_volterra, j_lotka_volterra, 2, 4),
    "kuramoto3": (kuramoto3, j_kuramoto3, 3, 2),
}


@pytest.fixture(scope="module")
def tut():
    return tutorial_field()


def field(name, tut):
    f, jf, dim, pdim = FIELDS[name]
    return (tut if f is None else f), jf, dim, pdim


def draws(name, R, seed):
    """Rows the fields meet on a solve: states ~ U(-2, 2) (phases ~
    U(-pi, pi)), parameters ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    _, _, dim, pdim = FIELDS[name]
    span = np.pi if name == "kuramoto3" else 2.0
    u = rng.uniform(-span, span, (R, dim)).astype(np.float32)
    p = rng.uniform(0.5, 2.0, (R, pdim)).astype(np.float32)
    return torch.from_numpy(u), torch.from_numpy(p)


def bits(a):
    return a.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# The tracer

@pytest.mark.parametrize("name", list(FIELDS))
def test_tracer_accepts_user_fields(name, tut):
    """Each field traces on one row into a program of the right widths;
    t is an input only where the field reads it; the per-row values depend
    on p alone; Kuramoto-3's divisions by 3 are recorded as the card's
    product by the reciprocal; the dispatch names a generated instance."""
    f, _, dim, pdim = field(name, tut)
    prog = rhs_trace.trace_field(f, dim, pdim)
    assert (prog.dim, prog.pdim, prog.ncst) == (dim, pdim, 0)
    assert len(prog.dy) == len(prog.ubar) == dim and len(prog.pbar) == pdim
    assert prog.uses_t == (name == "forced")
    assert all(i not in prog.per_row for i in prog.u_ids + [prog.t_id])
    assert set(prog.p_ids) <= prog.per_row
    if name == "kuramoto3":
        assert prog.card_rounding and all(
            "x / 3 runs as x * 0.3333333432674408" in c
            for c in prog.card_rounding)
    else:
        assert prog.card_rounding == []
    rk = ode_cuda.rhs_kernel(f, dim, pdim)
    assert rk.name.startswith("gen_") and len(rk.name) == 12
    assert (rk.kind, rk.pdim, rk.program.name) == (0, pdim, f.__name__)
    src = _build._GENERATED[rk.library]
    assert "LDQ_RK_ENTRY_POINTS(GenRhs, false)" in src
    assert '#include "rk_fixed_grid.cuh"' in src


captured = torch.tensor([1.0, 2.0])


def f_captured(u, p, t):
    return u * captured


def f_branch(u, p, t):
    if u[0] > 0:
        return -u
    return u


def f_unlisted(u, p, t):
    return torch.lgamma(u) * p


@pytest.mark.parametrize("f,node,why", [
    (f_captured, "_tensor_constant0", "a tensor the field captures"),
    (f_branch, "gt", "control flow that depends on data"),
    (f_unlisted, "lgamma", "aten.lgamma is not lowerable")],
    ids=["captured-tensor", "data-branch", "unlisted-op"])
def test_tracer_refusals_name_the_node(f, node, why):
    """A captured tensor, a branch on data and an op outside the list each
    raise ValueError naming the graph node, from the tracer and from the
    solve on CPU tensors (before any device is looked at), and nothing is
    solved on the plain path instead."""
    with pytest.raises(ValueError, match=f"node '{node}': {why}"):
        rhs_trace.trace_field(f, 2, 1)
    before = ode_cuda.solve_fixed_grid_batched_reference.calls
    with pytest.raises(ValueError, match=f"node '{node}'"):
        ode_cuda.solve_fixed_grid_batched(
            f, trk.Tsit5(), torch.zeros(3, 2), torch.ones(3, 1),
            torch.arange(4) * 0.1)
    assert ode_cuda.solve_fixed_grid_batched_reference.calls == before


def test_field_with_rhs_consts_reads_them_as_the_cst_vector():
    """A field's rhs_consts tensor, captured by the field, is the kernel's
    run-time constant vector (``cst``), not a refused capture; the
    lane-group instance serves Kuramoto at any width up to the limit."""
    deltas = torch.tensor([0.25, -0.5])

    def consts(device, dtype):
        return deltas

    def shifted(u, p, t):
        return p[..., 0:1] * u + consts(u.device, u.dtype)

    shifted.rhs_consts = consts
    prog = rhs_trace.trace_field(shifted, 2, 1)
    assert prog.ncst == 2 and len(prog.cst_ids) == 2
    u, p = draws("pendulum-untagged", 50, 3)
    got = rhs_trace.interpret(prog, u, p, 0.0, cst=deltas)
    assert torch.equal(bits(got), bits(shifted(u, p, 0.0)))
    rk = ode_cuda.rhs_kernel(shifted, 2, 1)
    assert rk.ncst == 2
    assert "LDQ_RK_ENTRY_POINTS(GenRhs, true)" in _build._GENERATED[
        rk.library]
    assert "cst[1]" in _build._GENERATED[rk.library]


def test_instances_cache_hash_and_width_limit():
    """The generated instance is cached by the field object and (dim,
    pdim), named by the hash of its source (an identical field elsewhere
    gets the same library); a field past the two-phase backward's register
    maps takes the reverse-sweep route, a field within them the two-phase
    one; the generated builds keep --fmad=false; the library's digest
    covers the header its source includes."""
    a = ode_cuda.rhs_kernel(lotka_volterra, 2, 4)
    assert ode_cuda.rhs_kernel(lotka_volterra, 2, 4) is a

    def lotka_volterra_copy(u, p, t):
        return lotka_volterra(u, p, t)
    lotka_volterra_copy.__name__ = "lotka_volterra"
    b = ode_cuda.rhs_kernel(lotka_volterra_copy, 2, 4)
    assert b is not a and (b.library, b.name) == (a.library, a.name)
    assert ode_cuda.rhs_instance(lotka_volterra, 2, 4) == a.name

    def wide(u, p, t):
        return u * p[..., 0:1]
    assert 11 * 11 + 11 * 8 > rhs_codegen.MAX_MAP_FLOATS
    assert ode_cuda.rhs_kernel(wide, 11, 8).backward == "sweep"
    assert ode_cuda.rhs_kernel(wide, 8, 8).backward == "maps"
    assert a.backward == "maps"
    assert "--fmad=false" in _build.GEN_FLAGS
    with open(os.path.join(_build.CSRC_DIR, "rk_fixed_grid.cu")) as fh:
        assert _build._headers(fh.read()) == ["rk_fixed_grid.cuh"]
    with pytest.raises(ValueError, match="parameter width"):
        ode_cuda.rhs_kernel(wide, 2)


# ---------------------------------------------------------------------------
# The lowered programs and the generated functor

@pytest.mark.parametrize("name", list(FIELDS))
def test_lowered_programs_equal_field_and_vjp_bit_for_bit(name, tut):
    """The forward and VJP programs, interpreted op by op in float32, equal
    f and torch.func.vjp bit for bit on 1,000 seeded rows (ten times t, a
    hundred rows each)."""
    f, _, dim, pdim = field(name, tut)
    prog = rhs_trace.trace_field(f, dim, pdim)
    u, p = draws(name, 1000, 0)
    kb = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1000, dim)).astype(np.float32))
    for i in range(10):
        rows = slice(100 * i, 100 * (i + 1))
        t = torch.tensor(0.37 * i)
        got = rhs_trace.interpret(prog, u[rows], p[rows], t)
        assert torch.equal(bits(got), bits(f(u[rows], p[rows], t)))
        gu, gp = rhs_trace.interpret(prog, u[rows], p[rows], t, kb=kb[rows])
        _, pull = torch.func.vjp(lambda a, b: f(a, b, t), u[rows], p[rows])
        ru, rp = pull(kb[rows])
        assert torch.equal(bits(gu), bits(ru))
        assert torch.equal(bits(gp), bits(rp))


@pytest.fixture(scope="module")
def host_cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the functor with")
    return cxx


# The host functor against torch: sinf and cosf come from libm (torch's
# CPU kernels take SLEEF's, within 1 ulp of each other), and a division by
# a number is the card's product by the reciprocal (within 1 ulp of the
# CPU's division), so the two agree to a few units in the last place of
# the outputs' size: 4 * eps * max(1, max |output|). A program with neither
# agrees exactly.
HOST_ULPS = 4


@pytest.mark.parametrize("name", list(FIELDS))
def test_generated_functor_compiled_on_the_host_matches_torch(name, tut,
                                                              host_cxx,
                                                              tmp_path):
    f, _, dim, pdim = field(name, tut)
    prog = rhs_trace.trace_field(f, dim, pdim)
    src = tmp_path / "functor.cpp"
    src.write_text(rhs_codegen.host_source(prog))
    lib_path = tmp_path / "functor.so"
    out = subprocess.run([host_cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                          "-shared", "-fPIC", str(src), "-o", str(lib_path)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(lib_path))
    R = 1000
    u, p = draws(name, R, 2)
    kb = torch.from_numpy(np.random.default_rng(3).normal(
        size=(R, dim)).astype(np.float32))
    t = torch.full((R,), 0.61)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())  # noqa: E731
    dy, ub, pb = torch.empty(R, dim), torch.empty(R, dim), torch.zeros(R, pdim)
    cst = torch.zeros(1)
    lib.ldq_gen_eval(ctypes.c_int(R), ptr(u), ptr(p), ptr(t), ptr(cst),
                     ptr(dy))
    lib.ldq_gen_vjp(ctypes.c_int(R), ptr(u), ptr(p), ptr(t), ptr(cst),
                    ptr(kb), ptr(ub), ptr(pb))
    tt = torch.tensor(0.61)
    _, pull = torch.func.vjp(lambda a, b: f(a, b, tt), u, p)
    refs = (f(u, p, tt),) + tuple(pull(kb))
    exact = not any(i.op in ("sin", "cos", "divs") for i in prog.instrs)
    eps = float(torch.finfo(torch.float32).eps)
    for got, ref in zip((dy, ub, pb), refs):
        if exact:
            assert torch.equal(bits(got), bits(ref))
        else:
            tol = HOST_ULPS * eps * max(1.0, float(ref.abs().max()))
            assert float((got - ref).abs().max()) <= tol


# ---------------------------------------------------------------------------
# The plain versions against JAX's Pallas solve and its custom_vjp

def pallas_case(name, solver, substeps, tut, B=4, T=8):
    f, jf, dim, pdim = field(name, tut)
    rng = np.random.default_rng(4)
    u0s, ps = (x.numpy() for x in draws(name, B, 5))
    saveat = (np.arange(T) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, T, dim)).astype(np.float32)

    def run(u, p):
        return pallas_solve_fixed_grid_batched(
            jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
            substeps=substeps, interpret=True)[0]

    ys_j, pull = jax.vjp(run, jnp.asarray(u0s), jnp.asarray(ps))
    return f, (u0s, ps, saveat, g), ys_j, pull(jnp.asarray(g))


def rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


@pytest.mark.parametrize("solver,substeps", [("Tsit5", 1), ("RK4", 2)])
@pytest.mark.parametrize("name", ["tutorial", "forced", "lotka-volterra",
                                  "kuramoto3"])
def test_plain_solve_and_vjp_references_match_pallas(name, solver, substeps,
                                                     tut):
    """The kernel's plain versions for a generated functor: the batched
    solve (through the dispatch, on CPU tensors) against
    pallas_solve_fixed_grid_batched in interpret mode (atol 1e-5), and the
    backward's (interval maps with the affine sweep, and the step-by-step
    reverse sweep over the same trajectory, both taking the VJP from
    torch.func.vjp) against jax.vjp of it, its custom_vjp (1e-5 of each
    gradient's size: float32 in other orders)."""
    f, (u0s, ps, saveat, g), ys_j, (du0_j, dp_j) = pallas_case(
        name, solver, substeps, tut)
    t_ = torch.from_numpy
    s = getattr(trk, solver)()
    ys, ok, _ = ode_cuda.solve_fixed_grid_batched(
        f, s, t_(u0s), t_(ps), t_(saveat), substeps=substeps)
    assert bool(ok.all())
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        f, s, t_(saveat), ys, t_(ps), substeps=substeps)
    two = ode_cuda.solve_fixed_grid_batched_affine_sweep_reference(J, r,
                                                                   t_(g))
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, t_(saveat), ys, t_(ps), t_(g), substeps=substeps)
    for got in (two, sweep):
        assert rel(got[0], du0_j) <= 1e-5
        assert rel(got[1], dp_j) <= 1e-5


def test_interval_maps_of_a_generated_field_match_autograd():
    """The interval maps of a field that reads t (vmapped over the
    intervals, each seeing t as a number) against autograd's Jacobian of
    one interval's plain solve."""
    u0s, ps = draws("forced", 3, 6)
    saveat = torch.arange(6) * 0.2
    s = trk.Tsit5()
    ys = ode_cuda.solve_fixed_grid_batched_reference(forced, s, u0s, ps,
                                                     saveat, substeps=2)[0]
    J, r = ode_cuda.solve_fixed_grid_batched_interval_maps_reference(
        forced, s, saveat, ys, ps, substeps=2)
    for n in (0, 3):
        def step(y, p):
            return ode_cuda.solve_fixed_grid_batched_reference(
                forced, s, y[None], p[None], saveat[n:n + 2],
                substeps=2)[0][0, 1]
        for b in range(3):
            Jb, rb = torch.autograd.functional.jacobian(step,
                                                        (ys[b, n], ps[b]))
            torch.testing.assert_close(J[b, n], Jb, rtol=0, atol=1e-6)
            torch.testing.assert_close(r[b, n], rb, rtol=0, atol=1e-6)


def test_solve_under_vmap_traces_a_new_field():
    """A field first met under torch.func.vmap (a population step) traces
    outside the transform and solves on the plain route per replica."""
    def damped(u, p, t):
        return torch.stack([u[..., 1], -p[..., 0] * u[..., 0]
                            - 0.1 * u[..., 1]], dim=-1)
    u0s = torch.rand(3, 5, 2, generator=torch.Generator().manual_seed(0))
    ps = 1 + torch.rand(3, 5, 1, generator=torch.Generator().manual_seed(1))
    saveat = torch.arange(4) * 0.1
    ys = torch.func.vmap(lambda u, p: ode_cuda.solve_fixed_grid_batched(
        damped, trk.Tsit5(), u, p, saveat)[0])(u0s, ps)
    for i in range(3):
        assert torch.equal(ys[i], ode_cuda.solve_fixed_grid_batched_reference(
            damped, trk.Tsit5(), u0s[i], ps[i], saveat)[0])
    assert ode_cuda.rhs_instance(damped, 2, 1).startswith("gen_")


# ---------------------------------------------------------------------------
# GOKU with a user field on the kernel route against JAX's Pallas route

def goku_pair(name, tut, width=24):
    f, jf, dim, pdim = field(name, tut)
    kw = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    jde = JODEDynamics(f=jf, z_dim=dim, theta_dim=pdim, solver=jrk.Tsit5(),
                       options=ldq.make_options(adaptive=False, substeps=2))
    enc, dec = jdefault_layers(jax.random.PRNGKey(3),
                               JGOKUBasic(use_pallas_solver=True), width,
                               jde, **kw)
    jm = JModel.build(JGOKUBasic(use_pallas_solver=True), enc, dec)
    tde = ODEDynamics(f=f, z_dim=dim, theta_dim=pdim, solver=trk.Tsit5(),
                      options=make_options(adaptive=False, substeps=2))
    tenc, tdec = goku_default_layers(width, tde, device="cpu", **kw)
    tm = LatentDiffEqModel.build(GOKUBasic(use_kernel_solver=True), tenc,
                                 tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(leaf) for p, leaf in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    return jm, tm


def noise_for(key, lv_j):
    """The (z0, theta) noise the JAX model draws from ``key``."""
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, lv.shape)))
                 for k, lv in zip((k1, k2), lv_j))


@pytest.mark.parametrize("name", ["tutorial", "forced"])
def test_goku_user_field_kernel_route_matches_jax_pallas_route(name, tut):
    """A small GOKU whose field has no device_rhs tag, use_kernel_solver on
    CPU tensors (the dispatch traces the field, then runs the kernel's
    plain version), against JAX's GOKUBasic(use_pallas_solver=True) (the
    field traced into its Pallas kernel, interpret mode) on the same
    weights and noise: the forward, the loss and every gradient (atol
    1e-4, as the other GOKU parities)."""
    jm, tm = goku_pair(name, tut)
    x = np.random.default_rng(8).uniform(0, 1, (4, 10, 24)).astype(
        np.float32)
    t = (np.arange(10) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jloss(m):
        return jlosses.loss_batch(m, jnp.asarray(x), jnp.asarray(t), 0.5,
                                  variational=True, key=key)

    (lj, _), gj = jax.value_and_grad(jloss, has_aux=True)(jm)
    (xh_j, z_j, _), _, lv_j, _ = jm(jnp.asarray(x), jnp.asarray(t),
                                    variational=True, key=key)
    eps = noise_for(key, lv_j)
    (xh, z, _), _, _, _ = tm(torch.from_numpy(x), torch.from_numpy(t),
                             variational=True, eps=eps)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(xh.detach().numpy(), np.asarray(xh_j),
                               rtol=0, atol=1e-4)
    tm.zero_grad()
    lt, _ = losses.loss_batch(tm, torch.from_numpy(x), torch.from_numpy(t),
                              0.5, variational=True, eps=eps)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=1e-4)
    leaves = jax.tree_util.tree_leaves(gj)
    params = list(tm.parameters())
    assert len(params) == len(leaves)
    for prm, g in zip(params, leaves):
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4)
    f = field(name, tut)[0]
    assert ode_cuda.rhs_instance(f, *FIELDS[name][2:]).startswith("gen_")


def test_goku_user_field_trains_on_the_kernel_route(tut):
    """GOKUBasic(use_kernel_solver=True) on the tutorial's field trains on
    CPU tensors: two epochs of finite losses, equal to the same Trainer's
    on the plain route (use_kernel_solver=False) on the same weights."""
    x = np.random.default_rng(10).uniform(0, 1, (24, 12, 24)).astype(
        np.float32)
    cfg = TrainConfig(batch_size=8, seq_len=8, epochs=2, seed=3,
                      save_best=False)
    hists = []
    for kernel in (True, False):
        _, tm = goku_pair("tutorial", tut)
        if not kernel:
            tm.model_type = tm.encoder.model_type = \
                tm.decoder.model_type = GOKUBasic()
        hists.append(Trainer(tm, cfg, device="cpu").fit(x[:16], x[16:],
                                                        verbose=False))
    assert len(hists[0]) == 2
    for hk, hp in zip(*hists):
        assert np.isfinite(hk["train_loss"]) and np.isfinite(hk["val_loss"])
        np.testing.assert_allclose([hk["train_loss"], hk["val_loss"]],
                                   [hp["train_loss"], hp["val_loss"]],
                                   rtol=1e-6)
