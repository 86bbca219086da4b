"""The sliced programs of a reverse-sweep functor, on the CPU.

A generated functor whose interval maps pass ``rhs_codegen.MAX_MAP_FLOATS``
takes the reverse-sweep backward, which runs its programs cut into slices,
one warp a slice (``rhs_codegen.plan_slices``). Each output must come from
exactly one slice and from the statements the whole program computes it
with, so the slices together equal the whole program bit for bit: here
the functor text is compiled as host C++ with ``g++`` and its slices are
held against its whole ``eval`` and ``vjp`` on seeded numpy rows. The plain
reverse sweep, the sweep kernel's plain version, is held against JAX's
Pallas solve's ``custom_vjp`` on Lorenz-96-12 at the tolerance of
tests/test_torch_rhs_wide.py. Where the backward kernels change what they
keep in shared memory (``ode_cuda.bwd_switches``) is checked against the
header's formulas.

The same functors can run forward on the sliced forward kernel
(``rk_fixed_grid_sliced_kernel``, which the plan takes for the wide ones
such as Lorenz-96-40): a float32 emulation of its sub-step, each
slice forming the stage inputs of the entries it owns and evaluating its
slice of the program, equals the one-thread forward's (the whole program a
row) bit for bit, and is held against JAX's Pallas solve; which forward
design each instance takes (``ode_cuda.fwd_design``, ``fwd_switches``) is
checked against the header's formulas.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from latentdiffeq.ops.ode_pallas import pallas_solve_fixed_grid_batched  # noqa: E402
from latentdiffeq.solve import rk as jrk  # noqa: E402
from latentdiffeq_torch.ops import ode_cuda, rhs_codegen, rhs_trace  # noqa: E402
from latentdiffeq_torch.solve import rk as trk  # noqa: E402
import rhs_zoo  # noqa: E402

# name -> (field, dim, pdim, the rhs_zoo.draws recipe): the zoo's sweep
# fields and Lorenz-96 at its standard 40
FIELDS = {**{name: (f, dim, pdim, name)
             for name, (f, dim, pdim, route) in rhs_zoo.ZOO.items()
             if route == "sweep"},
          "lorenz96-40": (rhs_zoo.lorenz96, 40, 1, "lorenz96-12")}
ROWS = 300


@pytest.fixture(scope="module")
def programs():
    return {name: rhs_trace.trace_field(f, dim, pdim)
            for name, (f, dim, pdim, _) in FIELDS.items()}


@pytest.fixture(scope="module")
def libs(programs, tmp_path_factory):
    """Each field's host functor, built once with g++."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the functor with")
    out = {}
    for name, prog in programs.items():
        d = tmp_path_factory.mktemp(name)
        src, lib = d / "functor.cpp", d / "functor.so"
        src.write_text(rhs_codegen.host_source(prog))
        res = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off",
                              "-shared", "-fPIC", str(src), "-o", str(lib)],
                             capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
        out[name] = ctypes.CDLL(str(lib))
    return out


def rows(name, seed):
    """(u, p, t, kb) as float32 tensors: rhs_zoo.draws' rows (Lorenz-96-40:
    states ~ U(-2, 2), F as at 12), times ~ U(0, 2), cotangents ~ N(0, 1)."""
    _, dim, pdim, like = FIELDS[name]
    u, p = rhs_zoo.draws(like, ROWS, seed)
    rng = np.random.default_rng(seed + 100)
    if u.shape[1] != dim:
        u = rng.uniform(-2.0, 2.0, (ROWS, dim)).astype(np.float32)
    t = rng.uniform(0.0, 2.0, ROWS).astype(np.float32)
    kb = rng.normal(size=(ROWS, dim)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (u, p, t, kb))


def ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def bits(a):
    return a.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", list(FIELDS))
def test_every_output_comes_from_exactly_one_slice(name, programs, libs):
    """The plan partitions dy, ubar and pbar: every index in exactly one
    slice; the compiled owner functions agree with the plan; slice g, run
    on rows whose outputs start as NaN, writes its own outputs and no
    other (and adds only into its own pbar entries)."""
    prog, lib = programs[name], libs[name]
    plan = rhs_codegen.plan_slices(prog)
    G, dim, pdim = plan.count, prog.dim, prog.pdim
    assert lib.ldq_gen_slices() == G > 1
    for parts, n, which in ((plan.eval_parts, dim, 0),
                            (plan.vjp_ubar, dim, 1),
                            (plan.vjp_pbar, pdim, 2)):
        assert len(parts) == G
        assert sorted(i for part in parts for i in part) == list(range(n))
        for g, part in enumerate(parts):
            for i in part:
                assert lib.ldq_gen_owner(which, i) == g
    u, p, t, kb = rows(name, 0)
    cst = torch.zeros(1)
    for g in range(G):
        dy = torch.full((ROWS, dim), float("nan"))
        ub = torch.full((ROWS, dim), float("nan"))
        pb = torch.full((ROWS, pdim), float("nan"))
        pb[:, list(plan.vjp_pbar[g])] = 0.0
        lib.ldq_gen_eval_slice(g, ROWS, ptr(u), ptr(p), ptr(t), ptr(cst),
                               ptr(dy))
        lib.ldq_gen_vjp_slice(g, ROWS, ptr(u), ptr(p), ptr(t), ptr(cst),
                              ptr(kb), ptr(ub), ptr(pb))
        for x, part in ((dy, plan.eval_parts[g]), (ub, plan.vjp_ubar[g]),
                        (pb, plan.vjp_pbar[g])):
            written = ~torch.isnan(x).all(0)
            assert written.nonzero().flatten().tolist() == sorted(part)


@pytest.mark.parametrize("name", list(FIELDS))
def test_slices_together_equal_the_whole_program_bit_for_bit(name, libs):
    """On seeded rows at several times, the outputs of all slices, each
    from the slice that owns it, equal the whole functor's eval and vjp bit
    for bit (pbar accumulated into the same starting values)."""
    lib = libs[name]
    _, dim, pdim, _ = FIELDS[name]
    G = lib.ldq_gen_slices()
    cst = torch.zeros(1)
    for seed in (1, 2):
        u, p, t, kb = rows(name, seed)
        start = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(ROWS, pdim)).astype(np.float32))
        dy, ub, pb = torch.empty(ROWS, dim), torch.empty(ROWS, dim), \
            start.clone()
        lib.ldq_gen_eval(ROWS, ptr(u), ptr(p), ptr(t), ptr(cst), ptr(dy))
        lib.ldq_gen_vjp(ROWS, ptr(u), ptr(p), ptr(t), ptr(cst), ptr(kb),
                        ptr(ub), ptr(pb))
        sdy, sub, spb = torch.empty(ROWS, dim), torch.empty(ROWS, dim), \
            start.clone()
        for g in range(G):
            lib.ldq_gen_eval_slice(g, ROWS, ptr(u), ptr(p), ptr(t), ptr(cst),
                                   ptr(sdy))
            lib.ldq_gen_vjp_slice(g, ROWS, ptr(u), ptr(p), ptr(t), ptr(cst),
                                  ptr(kb), ptr(sub), ptr(spb))
        for got, ref in ((sdy, dy), (sub, ub), (spb, pb)):
            assert torch.equal(bits(got), bits(ref))
        assert bool(torch.isfinite(dy).all()) and bool(
            torch.isfinite(ub).all())


@pytest.mark.parametrize("name", list(FIELDS))
def test_generated_source_states_slices_and_their_statements(name,
                                                             programs):
    """The kernel source of a sweep functor states its slice count and
    each slice's statements a stage, eval and vjp, beside the whole
    programs'; each count is the slice's own: the statements (per-row ones
    left out) its outputs need. The plan takes the fewest slices within
    SLICE_SLACK of the cheapest count, and cuts Lorenz-96 (local cones)
    into more than one."""
    prog = programs[name]
    plan = rhs_codegen.plan_slices(prog)
    src = rhs_codegen.kernel_source(prog)
    assert f"static constexpr int SLICES = {plan.count};" in src
    m = re.search(r"statements a stage: eval \[([\d, ]*)\] \(whole (\d+)\), "
                  r"vjp \[([\d, ]*)\] \(whole (\d+)\)", src)
    assert m is not None
    assert [int(x) for x in m.group(1).split(", ")] == list(plan.eval_cost)
    assert [int(x) for x in m.group(3).split(", ")] == list(plan.vjp_cost)

    def stmts(outputs):
        return sum(1 for i in prog.needed(outputs)
                   if i.out not in prog.per_row)
    assert (int(m.group(2)), int(m.group(4))) == plan.whole == (
        stmts(prog.dy), stmts(list(prog.ubar) + list(prog.pbar)))
    for g in range(plan.count):
        assert plan.eval_cost[g] == stmts(
            [prog.dy[i] for i in plan.eval_parts[g]])
        assert plan.vjp_cost[g] == stmts(
            [prog.ubar[i] for i in plan.vjp_ubar[g]]
            + [prog.pbar[q] for q in plan.vjp_pbar[g]])
        assert f"static void vjp_s{g}(" in src
    assert plan.count in rhs_codegen.SLICE_COUNTS
    if name.startswith("lorenz96"):
        assert plan.count > 1
        assert max(plan.eval_cost) < plan.whole[0]
        assert max(plan.vjp_cost) < plan.whole[1]


def test_narrow_functors_carry_no_slices():
    """A functor whose maps fit the two-phase backward is printed without
    slices (its backward never runs them)."""
    prog = rhs_trace.trace_field(rhs_zoo.hill, 3, 3)
    assert rhs_codegen.maps_fit(3, 3)
    src = rhs_codegen.kernel_source(prog)
    assert "SWEEP = false" in src and "SLICES" not in src
    assert 'ldq_gen_slices() { return 0; }' in rhs_codegen.host_source(prog)


# csrc/rk_fixed_grid.cuh's switches at 227 KB a block. Kuramoto's block
# backward at Tsit5 (6 stages), 4 sub-steps keeps every stage input with
# its recompute spread to N 227 ((4 x 6 + 2) N + 32 + N (N + 1) floats),
# without to 2,233, the sub-step starts to 4,840 ((4 + 6 + 2) N + 32) and
# nothing to 7,260 ((6 + 2) N + 32); a Lorenz-96-40 row of the sliced sweep
# (6 x 8 floats of tableau, then (u x 6 + 2 x 6) 40 floats) keeps the
# stages to 239 sub-steps, the starts ((u + 3 x 6) 40) to 1,433; a row past
# 227 KB at its leanest (7 x 9 + 3 x 7 x 2,765 floats) runs the one-thread
# kernel.
@pytest.mark.parametrize("route,dim,n_stages,substeps,want", [
    ("block", 0, 6, 4, [(227, "stages", True), (2233, "stages", False),
                        (4840, "starts", False), (7260, "nothing", False)]),
    ("block", 0, 7, 4, [(225, "stages", True), (1936, "stages", False),
                        (4467, "starts", False), (6453, "nothing", False)]),
    ("block", 0, 4, 1, [(237, "stages", True), (9680, "stages", False)]),
    ("sweep", 40, 6, 4, [(239, "stages", False), (1433, "starts", False),
                         (1434, "nothing", False)]),
    ("sweep", 2764, 7, 1, [(1, "stages", False), (2, "nothing", False)]),
    ("sweep", 2765, 7, 1, [(1, "one-thread", False)])])
def test_bwd_switches_follow_the_header_formulas(route, dim, n_stages,
                                                 substeps, want):
    """bwd_switches against the header's formulas (above): each run's last
    width (or sub-step count) fits its plan and the next does not;
    Kuramoto's widest instance, 6,144, keeps nothing at 7 stages and
    fits."""
    got = ode_cuda.bwd_switches(route, dim, n_stages, substeps)
    assert got == want
    cap = ode_cuda.SMEM_OPTIN // 4
    keep_of = {v: k for k, v in ode_cuda.BWD_KEEP.items()}
    for last, name, spread in got:
        keep = keep_of[name]
        if keep < 0:
            assert n_stages * (n_stages + 2) + 3 * n_stages * dim + 1 > cap
            continue
        if route == "block":
            floats = [ode_cuda.bwd_floats(route, keep, n, n_stages, substeps,
                                          spread) for n in (last, last + 1)]
        else:
            floats = [ode_cuda.bwd_floats(route, keep, dim, n_stages, u)
                      for u in (last, last + 1)]
        assert floats[0] <= cap
        if keep:
            assert floats[1] > cap
    assert ode_cuda.bwd_floats("block", 0, rhs_codegen.KURAMOTO_MAX_N, 7,
                               4) <= cap


def test_plain_reverse_sweep_matches_pallas_custom_vjp_lorenz96_12():
    """The sweep kernel's plain version, the step-by-step reverse sweep
    over the port's plain solve of Lorenz-96-12, against jax.vjp of JAX's
    Pallas solve (interpret mode), its custom_vjp, at
    tests/test_torch_rhs_wide.py's tolerances (ys atol 1e-5, gradients 1e-5
    of each size): Tsit5 and RK4, 3 and 1 sub-steps, 4 rows, 7 save
    points."""
    f, dim, pdim, _ = rhs_zoo.ZOO["lorenz96-12"]

    def jf(u, p, t):
        return (jnp.roll(u, -1) - jnp.roll(u, 2)) * jnp.roll(u, 1) - u + p[0]
    u0s, ps = rhs_zoo.draws("lorenz96-12", 4, 11)
    saveat = (np.arange(7) * 0.05).astype(np.float32)
    g = np.random.default_rng(12).normal(size=(4, 7, dim)).astype(np.float32)
    for solver, sub in (("Tsit5", 3), ("RK4", 1)):
        def run(u, p):
            return pallas_solve_fixed_grid_batched(
                jf, getattr(jrk, solver)(), u, p, jnp.asarray(saveat),
                substeps=sub, interpret=True)[0]
        ys_j, pull = jax.vjp(run, jnp.asarray(u0s), jnp.asarray(ps))
        grads_j = pull(jnp.asarray(g))
        s = getattr(trk, solver)()
        ys, ok, _ = ode_cuda.solve_fixed_grid_batched(
            f, s, torch.from_numpy(u0s), torch.from_numpy(ps),
            torch.from_numpy(saveat), substeps=sub)
        assert bool(ok.all())
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                                   atol=1e-5)
        sweep = ode_cuda.solve_fixed_grid_batched_backward_reference(
            f, s, torch.from_numpy(saveat), ys, torch.from_numpy(ps),
            torch.from_numpy(g), substeps=sub)
        for got, ref in zip(sweep, grads_j):
            ref = np.asarray(ref)
            assert (np.abs(got.numpy() - ref).max()
                    <= 1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# The forward kernels' designs


def jf_linear5(u, p, t):
    return p.reshape(5, 5) @ u - 0.01 * jnp.linalg.norm(u) * u


def jf_mlp(u, p, t):
    h = jnp.tanh(p[:32].reshape(8, 4) @ u + p[32:40])
    return p[40:72].reshape(4, 8) @ h + p[72:76]


def jf_lorenz96(u, p, t):
    return (jnp.roll(u, -1) - jnp.roll(u, 2)) * jnp.roll(u, 1) - u + p[0]


# the zoo's sweep fields in jnp (one row, as JAX's Pallas solve vmaps it)
JNP = {"lorenz96-12": jf_lorenz96, "linear5": jf_linear5, "mlp": jf_mlp}


def forward_emulated(lib, plan, solver, u0s, ps, saveat, substeps):
    """The batched RK forward in float32, stage by stage as the kernels run
    it: with ``plan`` (rhs_codegen.plan_slices) as the sliced forward runs a
    sub-step, slice g forming the stage inputs of the entries it owns,
    y + sum_q (dt a_sq) k_q in q order, into a row shared by the slices
    (each entry written once), then, after that row is complete, taking the
    slopes it owns from the whole row with ``ldq_gen_eval_slice``, and
    updating its own entries, y + sum_s (dt b_s) k_s; with ``plan`` None as
    the one-thread forward runs it, the whole program a row
    (``ldq_gen_eval``). Returns (ys (R, T, dim), success (R,))."""
    n, a, b, c = trk.tableau_f32(solver)
    R, dim = u0s.shape
    cst = torch.zeros(1)
    parts = ([list(range(dim))] if plan is None
             else [list(x) for x in plan.eval_parts])
    y = u0s.clone()
    ys = [y.clone()]
    sub = torch.tensor(float(substeps))
    for m in range(saveat.shape[0] - 1):
        ta = saveat[m]
        dt = (saveat[m + 1] - ta) / sub
        for u in range(substeps):
            t = ta + torch.tensor(float(u)) * dt
            ks = torch.full((n, R, dim), float("nan"))
            for st in range(n):
                row = torch.full((R, dim), float("nan"))
                written = torch.zeros(dim, dtype=torch.int64)
                for own in parts:
                    Y = y[:, own]
                    for q in range(st):
                        if a[st, q] != 0.0:
                            Y = Y + (dt * a[st, q]) * ks[q][:, own]
                    row[:, own] = Y
                    written[own] += 1
                assert bool((written == 1).all())  # one slice an entry
                ts = (t + c[st] * dt).expand(R).contiguous()
                k = torch.full((R, dim), float("nan"))
                if plan is None:
                    lib.ldq_gen_eval(R, ptr(row), ptr(ps), ptr(ts), ptr(cst),
                                     ptr(k))
                else:
                    for g in range(plan.count):
                        lib.ldq_gen_eval_slice(g, R, ptr(row), ptr(ps),
                                               ptr(ts), ptr(cst), ptr(k))
                ks[st] = k
            for own in parts:
                for st in range(n):
                    if b[st] != 0.0:
                        y[:, own] = y[:, own] + (dt * b[st]) * ks[st][:, own]
        ys.append(y.clone())
    ys = torch.stack(ys, 1)
    return ys, torch.isfinite(ys).flatten(1).all(1)


@pytest.mark.parametrize("solver,sub", [("Tsit5", 3), ("RK4", 1)])
@pytest.mark.parametrize("name", [k for k in FIELDS if k in JNP])
def test_sliced_forward_equals_one_thread_forward_and_pallas(name, solver,
                                                             sub, programs,
                                                             libs):
    """The sliced forward's sub-steps, emulated in float32 with the
    functor's compiled slices (forward_emulated), equal the one-thread
    forward's over the same rows bit for bit, states and flags (the slices
    compute every slope with the whole program's statements, and each
    entry's stage inputs and update take the same terms in the same
    order); that trajectory against JAX's Pallas solve in interpret mode at
    tests/test_torch_rhs_wide.py's tolerance (atol 1e-5). 4 rows, 7 save
    points, dt 0.05."""
    lib, plan = libs[name], rhs_codegen.plan_slices(programs[name])
    assert plan.count > 1
    u0s, ps = rhs_zoo.draws(name, 4, 21)
    saveat = (np.arange(7) * 0.05).astype(np.float32)
    s = getattr(trk, solver)()
    args = (s, torch.from_numpy(u0s), torch.from_numpy(ps),
            torch.from_numpy(saveat), sub)
    ys, ok = forward_emulated(lib, plan, *args)
    ys1, ok1 = forward_emulated(lib, None, *args)
    assert torch.equal(bits(ys), bits(ys1)) and torch.equal(ok, ok1)
    assert bool(ok.all())
    ys_j = pallas_solve_fixed_grid_batched(
        JNP[name], getattr(jrk, solver)(), jnp.asarray(u0s),
        jnp.asarray(ps), jnp.asarray(saveat), substeps=sub,
        interpret=True)[0]
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=0,
                               atol=1e-5)


def test_sliced_forward_keeps_the_flags_of_non_finite_rows(libs):
    """A row that starts from a NaN or an infinity fails, and only it, as
    the one-thread forward's AND over every stored value fails it (each
    slice ANDs its own entries; the kernel ANDs the slices)."""
    name = "lorenz96-12"
    lib, plan = libs[name], rhs_codegen.plan_slices(
        rhs_trace.trace_field(*FIELDS[name][:3]))
    u0s, ps = (torch.from_numpy(x) for x in rhs_zoo.draws(name, 4, 22))
    u0s[1, 3], u0s[2, 0] = float("nan"), float("inf")
    saveat = torch.arange(4, dtype=torch.float32) * 0.05
    ys, ok = forward_emulated(lib, plan, trk.Tsit5(), u0s, ps, saveat, 2)
    ys1, ok1 = forward_emulated(lib, None, trk.Tsit5(), u0s, ps, saveat, 2)
    assert ok.tolist() == ok1.tolist() == [True, False, False, True]
    assert torch.equal(bits(ys[ok]), bits(ys1[ok1]))


HEADER = os.path.join(ROOT, "latentdiffeq_torch", "csrc",
                      "rk_fixed_grid.cuh")


def test_fwd_plan_constants_are_the_headers():
    """ode_cuda's mirror of the forward plans reads the header's sizes:
    the 227 KB a forward block may take, the sliced forward's row flags and
    row floats, the block forward's table of step sizes."""
    text = open(HEADER).read()
    assert f"#define LDQ_RK_FWD_FLOATS {ode_cuda.SMEM_OPTIN // 4}" in text
    assert f"constexpr int kFwdFlags = {ode_cuda.FWD_FLAGS};" in text
    assert f"constexpr int kDtChunk = {ode_cuda.DT_TABLE};" in text
    assert (f"#define LDQ_RK_FWD_THREAD_FLOATS {ode_cuda.FWD_THREAD_FLOATS}"
            in text)
    assert "return (2 * NS * D) | 1;" in text
    assert ode_cuda.fwd_floats("sliced", 40, 6) == 6 * 8 + 32 + (480 | 1)
    assert ode_cuda.fwd_floats("spread", 64, 6) == 1024 + 6 * 64 + 64 * 65
    assert ode_cuda.fwd_floats("block", 64, 6) == 1024 + 6 * 64


# csrc/rk_fixed_grid.cuh's forward plans at 227 KB a block. The Kuramoto
# block forward spreads a stage's sines over the block while the block has
# lanes to spread over (N <= 256) and the step sizes' table, the stage
# inputs and the pairs fit (1,024 + NS N + N (N + 1) floats): at Tsit5 to N
# 235, RK4 236, 7 stages 234, one stage 237; past that the sines stay on the
# oscillators' lanes, to 6,144. A sweep functor runs the sliced forward
# where the one-thread forward's stage inputs and slopes (2 NS DIM floats)
# pass a thread's 255 registers and the sliced sweep runs (its leanest row,
# 3 NS DIM floats and the tableau, fits): DIM 22 to 3,225 at 6 stages, 19
# to 2,764 at 7, 128 to 19,369 at one.
@pytest.mark.parametrize("route,n_stages,want", [
    ("block", 6, [(235, "spread"), (6144, "block")]),
    ("block", 4, [(236, "spread"), (6144, "block")]),
    ("block", 7, [(234, "spread"), (6144, "block")]),
    ("block", 1, [(237, "spread"), (6144, "block")]),
    ("sweep", 6, [(21, "one-thread"), (3225, "sliced"),
                  (3226, "one-thread")]),
    ("sweep", 7, [(18, "one-thread"), (2764, "sliced"),
                  (2765, "one-thread")]),
    ("sweep", 1, [(127, "one-thread"), (19369, "sliced"),
                  (19370, "one-thread")])])
def test_fwd_switches_follow_the_header_formulas(route, n_stages, want):
    """fwd_switches against the header's formulas (above): the last width
    of each new design fits it and the next does not (a sweep functor's
    first sliced width passes the thread's registers and the one before
    does not); the lanes rule alone decides past the fit (256 spread, 257
    not, whatever the shared memory)."""
    assert ode_cuda.fwd_switches(route, n_stages) == want
    cap = ode_cuda.SMEM_OPTIN // 4
    if route == "sweep":
        first = want[0][0] + 1
        assert (2 * n_stages * (first - 1) <= ode_cuda.FWD_THREAD_FLOATS
                < 2 * n_stages * first)
        want = want[1:]
    last = want[0][0]
    if route == "block":
        floats = [ode_cuda.fwd_floats("spread", n, n_stages)
                  for n in (last, last + 1)]
        assert floats[0] <= cap < floats[1]
        assert ode_cuda.fwd_floats("block", rhs_codegen.KURAMOTO_MAX_N,
                                   n_stages) <= cap
        big = 1 << 30
        assert ode_cuda.fwd_design(route, 256, n_stages, big) == "spread"
        assert ode_cuda.fwd_design(route, 257, n_stages, big) == "block"
    else:
        rows = [n_stages * (n_stages + 2) + (3 * n_stages * d | 1)
                for d in (last, last + 1)]
        assert rows[0] <= cap < rows[1]
        assert ode_cuda.fwd_floats("sliced", last, n_stages) <= cap


@pytest.mark.parametrize("n_stages", [4, 6, 7])
def test_which_instances_take_the_new_forwards(n_stages):
    """Lorenz-96-40 takes the sliced forward; the zoo's sweep functors
    (at most 2 x 7 x 12 floats of stage inputs and slopes) and the
    functors whose maps fit keep the one-thread forward and Kuramoto's lane
    groups theirs; Kuramoto-64 spreads its sines, and Kuramoto past the fit
    keeps them on the oscillators' lanes."""
    from latentdiffeq_torch import custom_dynamics as cdyn
    for f, dim, pdim, route in rhs_zoo.ZOO.values():
        rk = ode_cuda.rhs_kernel(f, dim, pdim)
        assert rk.backward == route
        assert ode_cuda.fwd_design(rk.backward, dim, n_stages) \
            == "one-thread"
    rk = ode_cuda.rhs_kernel(FIELDS["lorenz96-40"][0], 40, 1)
    assert ode_cuda.fwd_design(rk.backward, 40, n_stages) == "sliced"
    for n, design in ((7, "lanes"), (33, "spread"), (64, "spread"),
                      (300, "block"), (1100, "block")):
        rk = ode_cuda.rhs_kernel(cdyn.kuramoto_f(n), n)
        assert ode_cuda.fwd_design(rk.backward, n, n_stages) == design
