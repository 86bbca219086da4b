"""Every field JAX's Pallas solve runs, on the batched RK kernel's route:
the ops the tracer lowers beyond the elementwise arithmetic (selects,
functions and their backward ops, rolls, reductions, matrix products,
in-place forms), fields whose interval maps pass the two-phase backward
(the reverse-sweep route), and Kuramoto past a warp's lanes (the block
kernels), on the CPU.

Each field of the zoo is written twice, in torch and in jnp, the way a user
writes it. Its lowered programs are interpreted op by op against the field
and ``torch.func.vjp``; its functor text is compiled as host C++ with
``g++``; the plain versions the kernel is held to on the card (the batched
solve and the step-by-step reverse sweep, the plain version of the sweep
kernel) are held against JAX's Pallas solve in interpret mode and its
``custom_vjp``. Inputs come from numpy generators with fixed seeds.
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
sys.path.insert(0, os.path.join(ROOT, "examples", "custom_dynamics"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import custom  # noqa: E402
import latentdiffeq as ldq  # noqa: E402
from latentdiffeq.models import GOKUBasic as JGOKUBasic  # noqa: E402
from latentdiffeq.models import LatentDiffEqModel as JModel  # noqa: E402
from latentdiffeq.models import ODEDynamics as JODEDynamics  # noqa: E402
from latentdiffeq.models import default_layers as jdefault_layers  # noqa: E402
from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched  # noqa: E402
from latentdiffeq.solve import rk as jrk  # noqa: E402
from latentdiffeq.train import losses as jlosses  # noqa: E402
from latentdiffeq.train.checkpoint import _path_str  # noqa: E402
from latentdiffeq_torch import custom_dynamics as cdyn  # noqa: E402
from latentdiffeq_torch import make_options  # noqa: E402
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,  # noqa: E402
                                       ODEDynamics, goku_default_layers)
from latentdiffeq_torch.ops import (_build, ode_cuda, rhs_codegen,  # noqa: E402
                                    rhs_trace)
from latentdiffeq_torch.solve import rk as trk  # noqa: E402
from latentdiffeq_torch.train import losses  # noqa: E402
from latentdiffeq_torch.train.checkpoint import load_jax_params  # noqa: E402
import rhs_zoo  # noqa: E402
from rhs_zoo import ZOO, clamp_friction, lorenz96, mlp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as the other heavy port files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The zoo (tests/rhs_zoo.py), each field also in jnp (one row, as JAX's
# Pallas solve vmaps it)

def j_lorenz96(u, p, t):
    return (jnp.roll(u, -1) - jnp.roll(u, 2)) * jnp.roll(u, 1) - u + p[0]


def j_hill(u, p, t):
    return p[0] * jax.nn.sigmoid(-p[1] * jnp.roll(u, 1)) - p[2] * u


def j_lv_softplus(u, p, t):
    return jnp.stack([jax.nn.softplus(p[0]) * u[0] - p[1] * u[0] * u[1],
                      p[3] * u[0] * u[1]
                      - jax.nn.softplus(2.0 * p[2]) / 2.0 * u[1]])


def j_clamp_friction(u, p, t):
    return jnp.stack([u[1], -p[0] * u[0] - p[1] * jnp.clip(u[1] * 10.0, -1.0,
                                                             1.0)
                      + jax.nn.relu(-u[0]) - jnp.maximum(u[0], u[1]) * 0.1])


def j_kuramoto_mean(u, p, t):
    return p[0] + p[1] * jnp.mean(jnp.sin(u[None, :] - u[:, None]), axis=1)


def j_linear5(u, p, t):
    return p.reshape(5, 5) @ u - 0.01 * jnp.linalg.norm(u) * u


def j_mlp(u, p, t):
    h = jnp.tanh(p[:32].reshape(8, 4) @ u + p[32:40])
    return p[40:72].reshape(4, 8) @ h + p[72:76]


def j_selects(u, p, t):
    lo = jnp.maximum(u * 0.5, -0.25)
    head = jnp.cumsum(u[:2])
    return (0.5 * jnp.flip(u) * p[0] - 2.0 * u - 0.1 * (jnp.max(u) - jnp.min(u))
            + 0.1 * jnp.prod(jnp.tanh(u[:2])) + 0.1 * jnp.concatenate([head, head])
            + jnp.clip(u, -p[1], p[1]) + 0.1 * jnp.minimum(u, lo)
            + 0.1 * jnp.mean(u[:2]))


def j_gelu_field(u, p, t):
    return (jax.nn.gelu(u, approximate=False) * p[0]
            - jax.scipy.special.erf(u) * p[1]
            + jax.nn.gelu(u, approximate=True) - 4.0 * u)


def j_atan_field(u, p, t):
    return jnp.stack([jnp.arctan2(u[1], u[0]) * p[0] - jnp.expm1(u[0] * 0.1),
                      jnp.log1p(u[0] * u[0]) - jnp.sinh(u[1])
                      + jnp.cosh(u[0]) * 0.01])


def j_inplace(u, p, t):
    du = (-p[0] * u).at[1:].add(u[:-1])
    du = du.at[0].multiply(2.0)
    return du + 0.1 * du[:2].sum()


# name -> (torch field, jnp field, dim, pdim, the route of its backward)
FIELDS = {name: (f, globals()["j_" + f.__name__], dim, pdim, route)
          for name, (f, dim, pdim, route) in ZOO.items()}


def draws(name, R, seed):
    return tuple(torch.from_numpy(x) for x in rhs_zoo.draws(name, R, seed))


def bits(a):
    return a.contiguous().view(torch.int32)


# The functions whose CPU kernels take SLEEF in their vectorised loop and
# libm in their scalar one (a strided operand, a loop's tail): a program
# interpreted on contiguous columns meets them in other loops than the
# field's own call, within a unit in the last place.
LIBM_SPLIT = frozenset({"sigmoid", "softplus", "softplusb", "erf", "gelu",
                        "gelut", "gelub", "gelubt", "expm1", "log1p", "sinh",
                        "cosh", "atan2"})
# Where a program is not exact against torch on the CPU (its ``inexact``
# reductions, or a LIBM_SPLIT function), it is held within CPU_ULPS units
# in the last place of the outputs' size: 4 * eps * max(1, max |output|).
CPU_ULPS = 4


def cpu_exact(prog):
    return not prog.inexact and not ({i.op for i in prog.instrs}
                                     & LIBM_SPLIT)


def close(got, ref, ulps):
    eps = float(torch.finfo(torch.float32).eps)
    tol = ulps * eps * max(1.0, float(ref.abs().max()))
    return float((got - ref).abs().max()) <= tol


@pytest.fixture(scope="module")
def programs():
    return {name: rhs_trace.trace_field(f, dim, pdim)
            for name, (f, _, dim, pdim, _) in FIELDS.items()}


# ---------------------------------------------------------------------------
# The tracer and the dispatch

@pytest.mark.parametrize("name", list(FIELDS))
def test_zoo_traces_and_takes_its_route(name, programs):
    """Each field of the zoo traces with no ValueError into a program of
    the right widths; the dispatch names a generated instance whose
    backward takes the two-phase kernel while dim * dim + dim * pdim <=
    MAX_MAP_FLOATS and the reverse sweep past it; the notes name the
    reductions and products whose plain versions take another order (none
    in the forwards of the fields without long sums)."""
    f, _, dim, pdim, route = FIELDS[name]
    prog = programs[name]
    assert (prog.dim, prog.pdim) == (dim, pdim)
    assert len(prog.dy) == len(prog.ubar) == dim and len(prog.pbar) == pdim
    rk = ode_cuda.rhs_kernel(f, dim, pdim)
    assert rk.name.startswith("gen_") and rk.backward == route
    assert (route == "maps") == rhs_codegen.maps_fit(dim, pdim)
    sweep = "true" if route == "sweep" else "false"
    assert f"static constexpr bool SWEEP = {sweep};" in \
        rhs_codegen.kernel_source(prog)
    if name in ("linear5", "mlp"):
        assert any("BLAS" in n for n in prog.inexact)
    if name in ("kuramoto-mean", "lorenz96-12"):
        assert any("terms" in n for n in prog.inexact)
    if name in ("clamp-friction", "hill", "atan", "selects", "inplace"):
        nodes = {i.node for i in prog.needed(prog.dy)}
        assert not any(n.split(":")[0] in nodes for n in prog.inexact)


def test_wide_fields_and_wide_kuramoto_return_kernel_instances():
    """No field is refused for its width: Lorenz-96 at its standard 40, the
    dim-4 / pdim-76 weight field and a dim-11 / pdim-8 field run on
    generated instances with the reverse-sweep backward; Kuramoto at 32,
    33, 64 and 1100 oscillators on the block kernels (a one-line source per
    width); the lane groups keep 2 to 31; past the block kernels' shared
    memory, Kuramoto raises naming the limit."""
    assert ode_cuda.rhs_kernel(lorenz96, 40, 1).backward == "sweep"
    assert ode_cuda.rhs_kernel(mlp, 4, 76).backward == "sweep"

    def wide(u, p, t):
        return u * p[..., 0:1]
    assert ode_cuda.rhs_kernel(wide, 11, 8).backward == "sweep"
    assert ode_cuda.rhs_kernel(wide, 8, 8).backward == "maps"
    for n in (32, 33, 64, 1100):
        rk = ode_cuda.rhs_kernel(cdyn.kuramoto_f(n), n)
        assert (rk.name, rk.backward, rk.ncst) == (f"kuramoto{n}", "block", n)
        assert f"KuramotoBlock<{n}>" in _build._GENERATED[rk.library]
    rk = ode_cuda.rhs_kernel(cdyn.kuramoto_f(31), 31)
    assert rk.backward == "lanes"
    assert "KuramotoLanes<31>" in _build._GENERATED[rk.library]
    big = rhs_codegen.KURAMOTO_MAX_N + 1
    with pytest.raises(ValueError, match=f"1 to {big - 1} oscillators"):
        ode_cuda.rhs_kernel(cdyn.kuramoto_f(big), big)
    with pytest.raises(ValueError, match="no interval maps"):
        ode_cuda.solve_fixed_grid_batched_bwd_cuda(
            lorenz96, trk.Tsit5(), torch.arange(3.0), torch.zeros(2, 3, 40),
            torch.ones(2, 1), torch.zeros(2, 3, 40), maps=True)


def f_lgamma(u, p, t):
    return torch.lgamma(u + 2.0) * p


def f_sort(u, p, t):
    return torch.sort(u, -1)[0] * p


index = torch.tensor([1, 0])


def f_gather(u, p, t):
    return u[..., index] * p


@pytest.mark.parametrize("f,node,why", [
    (f_lgamma, "lgamma", "aten.lgamma is not lowerable"),
    (f_sort, "sort", "aten.sort is not lowerable"),
    (f_gather, "_tensor_constant0", "a tensor the field captures")],
    ids=["lgamma", "sort", "captured-index"])
def test_ops_still_outside_the_list_are_refused(f, node, why):
    """What the lowering still does not take raises ValueError naming the
    node, from the tracer and from the solve on CPU tensors, and nothing is
    solved on the plain path instead."""
    with pytest.raises(ValueError, match=f"node '{node}': {why}"):
        rhs_trace.trace_field(f, 2, 1)
    before = ode_cuda.solve_fixed_grid_batched_reference.calls
    with pytest.raises(ValueError, match=f"node '{node}'"):
        ode_cuda.solve_fixed_grid_batched(
            f, trk.Tsit5(), torch.zeros(3, 2), torch.ones(3, 1),
            torch.arange(4) * 0.1)
    assert ode_cuda.solve_fixed_grid_batched_reference.calls == before


# ---------------------------------------------------------------------------
# The lowered programs and the generated functor

@pytest.mark.parametrize("name", list(FIELDS))
def test_zoo_programs_equal_field_and_vjp(name, programs):
    """The forward and VJP programs, interpreted op by op in float32, on
    512 seeded rows at two times: bit for bit with f and torch.func.vjp
    where the program is exact on the CPU (selects, rolls, short sums,
    elementwise arithmetic), else within CPU_ULPS of the outputs' size
    (long sums and matrix products in index order against the CPU's
    partial sums and BLAS; SLEEF against libm)."""
    f, _, dim, pdim, _ = FIELDS[name]
    prog = programs[name]
    u, p = draws(name, 512, 0)
    kb = torch.from_numpy(np.random.default_rng(1).normal(
        size=(512, dim)).astype(np.float32))
    exact = cpu_exact(prog)
    for t in (torch.tensor(0.0), torch.tensor(0.61)):
        got = rhs_trace.interpret(prog, u, p, t)
        gu, gp = rhs_trace.interpret(prog, u, p, t, kb=kb)
        _, pull = torch.func.vjp(lambda a, b: f(a, b, t), u, p)
        for g, r in zip((got, gu, gp), (f(u, p, t),) + tuple(pull(kb))):
            if exact:
                assert torch.equal(bits(g), bits(r))
            else:
                assert close(g, r, CPU_ULPS)
    if name == "clamp-friction":  # selects and elementwise arithmetic
        assert exact


def test_selects_keep_nan_and_tie_rules():
    """relu, clamp and maximum return a NaN operand as PyTorch does, and
    maximum's gradient splits a tie in halves (its VJP graph's where and
    masked_fill, lowered as selects): interpreted programs equal torch on
    NaNs and ties."""
    prog = rhs_trace.trace_field(clamp_friction, 2, 2)
    u = torch.tensor([[float("nan"), 0.5], [0.3, 0.3], [-0.2, float("nan")],
                      [0.7, -0.1]])
    p = torch.ones(4, 2)
    kb = torch.tensor([[1.0, 2.0]] * 4)
    t = torch.tensor(0.0)
    got = rhs_trace.interpret(prog, u, p, t)
    ref = clamp_friction(u, p, t)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    gu, _ = rhs_trace.interpret(prog, u, p, t, kb=kb)
    _, pull = torch.func.vjp(lambda a, b: clamp_friction(a, b, t), u, p)
    ru = pull(kb)[0]
    assert torch.equal(torch.nan_to_num(gu), torch.nan_to_num(ru))
    assert float(gu[1, 0]) == float(ru[1, 0])  # the tie's half


@pytest.fixture(scope="module")
def host_cxx():
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the functor with")
    return cxx


# The host functor against torch: the functions from libm (torch's CPU
# kernels take SLEEF's in their vectorised loops), sums in index order, a
# division by a number as the card's product by the reciprocal: within
# HOST_ULPS units in the last place of the outputs' size, as
# tests/test_torch_rhs_codegen.py holds PR 15's fields.
HOST_ULPS = 4


@pytest.mark.parametrize("name", list(FIELDS))
def test_zoo_functor_compiled_on_the_host_matches_torch(name, programs,
                                                        host_cxx, tmp_path):
    f, _, dim, pdim, _ = FIELDS[name]
    prog = programs[name]
    src = tmp_path / "functor.cpp"
    src.write_text(rhs_codegen.host_source(prog))
    lib_path = tmp_path / "functor.so"
    out = subprocess.run([host_cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                          "-shared", "-fPIC", str(src), "-o", str(lib_path)],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    lib = ctypes.CDLL(str(lib_path))
    R = 500
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
    for got, ref in zip((dy, ub, pb), (f(u, p, tt),) + tuple(pull(kb))):
        assert close(got, ref, HOST_ULPS)


# ---------------------------------------------------------------------------
# The plain versions against JAX's Pallas solve and its custom_vjp

def t_(x):
    return torch.from_numpy(np.asarray(x))


def rel(got, ref):
    ref = torch.from_numpy(np.array(ref))
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def pallas_pair(f, jf, u0s, ps, saveat, g, solver, substeps):
    """JAX's Pallas solve (interpret mode) and jax.vjp of it against the
    port's plain solve and its plain reverse sweep over that trajectory."""
    def run(u, p):
        return pallas_solve_fixed_grid_batched(
            jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
            substeps=substeps, interpret=True)[0]

    @jax.jit
    def value_and_vjp(u, p, g):
        y, pull = jax.vjp(run, u, p)
        return (y,) + pull(g)

    ys_j, du0_j, dp_j = value_and_vjp(jnp.asarray(u0s), jnp.asarray(ps),
                                      jnp.asarray(g))
    s = getattr(trk, solver)()
    ys, ok, _ = ode_cuda.solve_fixed_grid_batched(
        f, s, t_(u0s), t_(ps), t_(saveat), substeps=substeps)
    sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
        f, s, t_(saveat), ys, t_(ps), t_(g), substeps=substeps)
    return ys, ok, sweep, ys_j, (du0_j, dp_j)


@pytest.mark.parametrize("name", list(FIELDS))
def test_zoo_plain_solve_and_sweep_match_pallas(name):
    """The kernel's plain versions for each zoo field (the batched solve
    through the dispatch on CPU tensors; the step-by-step reverse sweep,
    the plain version of the sweep kernel and of the two-phase kernel's
    result) against pallas_solve_fixed_grid_batched in interpret mode (atol
    1e-5) and jax.vjp of it, its custom_vjp (1e-5 of each gradient's size:
    float32 in other orders). Tsit5 on 3 rows, 6 save points, 2 sub-steps
    (RK4 for the polar field)."""
    f, jf, dim, _, _ = FIELDS[name]
    u0s, ps = (x.numpy() for x in draws(name, 3, 5))
    saveat = (np.arange(6) * 0.1).astype(np.float32)
    g = np.random.default_rng(4).normal(size=(3, 6, dim)).astype(np.float32)
    solver = "RK4" if name == "atan" else "Tsit5"
    ys, ok, sweep, ys_j, grads_j = pallas_pair(f, jf, u0s, ps, saveat, g,
                                               solver, 2)
    assert bool(ok.all())
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)
    for got, ref in zip(sweep, grads_j):
        assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize("n", [33, 64])
def test_kuramoto_past_the_lanes_matches_pallas(n):
    """The port's plain Kuramoto at 33 and 64 oscillators (the block
    kernels' plain versions: the solve, and the reverse sweep over its
    trajectory with the hand-written VJP) against JAX's _kuramoto_f
    through pallas_solve_fixed_grid_batched (interpret mode) and jax.vjp
    of it (atol 1e-5 on ys; 1e-5 of each gradient's size)."""
    rng = np.random.default_rng(n)
    u0s = rng.uniform(-np.pi, np.pi, (2, n)).astype(np.float32)
    ps = np.stack([rng.uniform(1, 3, 2), rng.uniform(0.2, 2, 2)],
                  1).astype(np.float32)
    saveat = (np.arange(5) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 5, n)).astype(np.float32)
    f = cdyn.kuramoto_f(n)
    assert ode_cuda.rhs_kernel(f, n).backward == "block"
    ys, ok, sweep, ys_j, grads_j = pallas_pair(
        f, custom._kuramoto_f, u0s, ps, saveat, g, "Tsit5", 2)
    assert bool(ok.all())
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)
    for got, ref in zip(sweep, grads_j):
        assert rel(got, ref) <= 1e-5


# ---------------------------------------------------------------------------
# GOKU with a wide field on the kernel route against JAX's Pallas route

def test_goku_wide_field_kernel_route_matches_jax_pallas_route():
    """A small GOKU on Lorenz-96 at 12 (the reverse-sweep route),
    use_kernel_solver on CPU tensors (the dispatch traces the field, then
    runs the kernel's plain versions), against JAX's
    GOKUBasic(use_pallas_solver=True) (the field traced into its Pallas
    kernel, interpret mode) on weights carried across by the bridge and the
    same noise: the forward, the loss and every gradient (atol 1e-4, as the
    other GOKU parities)."""
    kw = dict(hidden_dim_resnet=16, latent_to_diffeq_dim=16)
    jde = JODEDynamics(f=j_lorenz96, z_dim=12, theta_dim=1,
                       solver=jrk.Tsit5(),
                       options=ldq.make_options(adaptive=False, substeps=2))
    enc, dec = jdefault_layers(jax.random.PRNGKey(3),
                               JGOKUBasic(use_pallas_solver=True), 16, jde,
                               **kw)
    jm = JModel.build(JGOKUBasic(use_pallas_solver=True), enc, dec)
    tde = ODEDynamics(f=lorenz96, z_dim=12, theta_dim=1, solver=trk.Tsit5(),
                      options=make_options(adaptive=False, substeps=2))
    tenc, tdec = goku_default_layers(16, tde, device="cpu", **kw)
    tm = LatentDiffEqModel.build(GOKUBasic(use_kernel_solver=True), tenc,
                                 tdec)
    load_jax_params(tm, {_path_str(p): np.asarray(leaf) for p, leaf in
                         jax.tree_util.tree_flatten_with_path(jm)[0]})
    x = np.random.default_rng(8).uniform(0, 1, (2, 5, 16)).astype(
        np.float32)
    t = (np.arange(5) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def jloss(m):
        return jlosses.loss_batch(m, jnp.asarray(x), jnp.asarray(t), 0.5,
                                  variational=True, key=key)

    (lj, _), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jm)
    (xh_j, z_j, _), _, lv_j, _ = jax.jit(lambda m: m(
        jnp.asarray(x), jnp.asarray(t), variational=True, key=key))(jm)
    k1, k2 = jax.random.split(jax.random.split(key)[0])
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, lv.shape)))
                for k, lv in zip((k1, k2), lv_j))
    (xh, z, _), _, _, _ = tm(t_(x), t_(t), variational=True, eps=eps)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(xh.detach().numpy(), np.asarray(xh_j),
                               rtol=0, atol=1e-4)
    tm.zero_grad()
    lt, _ = losses.loss_batch(tm, t_(x), t_(t), 0.5, variational=True,
                              eps=eps)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=0,
                               atol=1e-4)
    leaves = jax.tree_util.tree_leaves(gj)
    params = list(tm.parameters())
    assert len(params) == len(leaves)
    for prm, g in zip(params, leaves):
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4)
    assert ode_cuda.rhs_kernel(lorenz96, 12, 1).backward == "sweep"
