"""Emit a device functor for the batched RK kernels from a traced field.

``rhs_trace.trace_field`` lowers a user-written ``f(u, p, t)`` and its VJP
into one scalar program; this module prints it as a C++ struct with the
interface csrc/rk_fixed_grid.cuh takes from its hand-written functors
(``DIM``, ``PDIM``, ``NTRIG = 0``, ``FAST_TRIG = false``, ``Row``,
``row``, ``angles``, ``eval``, ``vjp``), and the source that instantiates
the forward and backward kernels on it (Tsit5, RK4 and the run-time
tableau, through the header's ``dispatch``) behind ``extern "C"`` entry
points of the hand-written library's signature (``LDQ_RK_ENTRY_POINTS``).

Every scalar of the program is a ``float`` (or ``bool``) local, one
statement per operation, in program order; the values that depend on the
parameters and run-time constants alone are computed once a row into
``Row``. Rounding follows the plain version on the card: ``sinf``,
``cosf``, ``expf``, ``logf``, ``tanhf``, ``sqrtf``, ``rsqrtf``, ``powf``
(PyTorch's CUDA kernels call the same functions), a division by a number as
the product with its float32 reciprocal, constants as hexadecimal float32
literals, and the library is built with ``--fmad=false`` so no product and
sum fuse (``_build.GEN_FLAGS``).

The forward is one thread a trajectory at any width (past 255 registers
its arrays spill to local memory). The backward is the two-phase kernel,
one thread an interval holding the interval's maps J (dim x dim) and r
(dim x pdim) in registers, while the maps fit ``MAX_MAP_FLOATS`` floats
(``maps_fit``), and the reverse-sweep kernel past that; the functor's
``SWEEP`` member, printed from ``maps_fit``, tells the header which. A
sweep functor also carries its programs cut into ``SLICES`` slices
(``plan_slices``): slice g computes the outputs it owns (``dy`` entries of
``eval``; ``ubar`` and ``pbar`` entries of ``vjp``) with the statements the
whole program computes them with, each output in exactly one slice, so the
sweep kernel runs slice g on warp g and every value stays the whole
program's bit for bit. Kuramoto gets a one-line source instead
(``kuramoto_source``): the hand-written lane-group kernels up to
``KURAMOTO_LANES_MAX_N`` oscillators, the block kernels past that.

``host_source`` wraps the same functor text for a host compiler (``g++``),
so the CPU tests can call it, and its slices, through ``ctypes``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from .rhs_trace import Const, FieldProgram, Instr

__all__ = ["MAX_MAP_FLOATS", "KURAMOTO_LANES_MAX_N", "KURAMOTO_MAX_N",
           "SLICE_COUNTS", "SLICE_SLACK", "SlicePlan", "maps_fit",
           "plan_slices", "functor_source", "kernel_source",
           "kuramoto_source", "host_source"]

# The two-phase backward keeps an interval's maps J and r in a thread's
# registers (and the step's Js, Rs beside them): at dim*dim + dim*pdim <= 128
# floats they take at most half of a thread's 255 registers (Kuramoto-10's
# 120 fit). A generated functor past it takes the reverse-sweep backward,
# which forms no maps (its ``SWEEP`` member, which the header reads: the
# route is decided here alone).
MAX_MAP_FLOATS = 128
# The lane-group Kuramoto kernels put one oscillator on a lane of a warp
# and mask the group with (1 << N) - 1; wider fields (and one oscillator)
# take the block kernels, whose backward keeps a row's stage inputs and
# two rows of cotangents in shared memory: (7 + 2) N floats at 7 stages fit
# the card's 227 KB a block up to N 6,144.
KURAMOTO_LANES_MAX_N = 31
KURAMOTO_MAX_N = 6144


def maps_fit(dim: int, pdim: int) -> bool:
    """Whether a functor's interval maps fit the two-phase backward."""
    return dim * dim + dim * pdim <= MAX_MAP_FLOATS


# The slice counts a sweep functor may take (warps a block of the sweep
# kernel, at most 512 threads), and how much dearer than the cheapest
# count's a smaller count's cost may be and still be taken (fewer warps,
# fewer statements repeated).
SLICE_COUNTS = (1, 2, 4, 8, 16)
SLICE_SLACK = 1.1


@dataclasses.dataclass(frozen=True)
class SlicePlan:
    """A sweep functor's slices: ``count`` of them; ``eval_parts[g]`` the
    ``dy`` indices slice g owns, ``vjp_ubar[g]`` / ``vjp_pbar[g]`` its
    ``ubar`` and ``pbar`` indices; ``eval_cost[g]`` / ``vjp_cost[g]`` the
    statements it runs a stage (those it repeats included; per-row values
    are computed once a row and not counted); ``whole`` the (eval, vjp)
    statements of the whole programs."""
    count: int
    eval_parts: tuple
    vjp_ubar: tuple
    vjp_pbar: tuple
    eval_cost: tuple
    vjp_cost: tuple
    whole: tuple


def _cones(prog: FieldProgram, outputs):
    """The per-stage statements (instruction ids, per-row ones left out)
    each output needs."""
    by_id = {ins.out: ins for ins in prog.instrs}
    memo = {}

    def cone(r):
        if not isinstance(r, int) or r not in by_id or r in prog.per_row:
            return frozenset()
        hit = memo.get(r)
        if hit is None:
            stack, seen = [r], set()
            while stack:
                x = stack.pop()
                if x in seen or x not in by_id or x in prog.per_row:
                    continue
                seen.add(x)
                stack.extend(a for a in by_id[x].args if isinstance(a, int))
            hit = memo[r] = frozenset(seen)
        return hit
    return [cone(r) for r in outputs]


def _partition(cones, count):
    """Greedy: the outputs by falling cone size (then index), each to the
    slice whose statements grow least with it, ties to the lower slice.
    Returns (owner of each output, statements of each slice)."""
    owner = [0] * len(cones)
    sets = [set() for _ in range(count)]
    for o in sorted(range(len(cones)), key=lambda o: (-len(cones[o]), o)):
        g = min(range(count), key=lambda g: (len(sets[g] | cones[o]), g))
        owner[o] = g
        sets[g] |= cones[o]
    return owner, [len(x) for x in sets]


def plan_slices(prog: FieldProgram) -> SlicePlan:
    """Cut ``eval`` and ``vjp`` into slices (module docstring). For each
    count of ``SLICE_COUNTS``, both programs' outputs are partitioned
    (``_partition``); a count costs the longest eval slice plus the longest
    vjp slice, in statements; the plan takes the smallest count within
    ``SLICE_SLACK`` of the cheapest."""
    ev_cones = _cones(prog, prog.dy)
    vj_cones = _cones(prog, list(prog.ubar) + list(prog.pbar))
    cands = {}
    for count in SLICE_COUNTS:
        ev = _partition(ev_cones, count)
        vj = _partition(vj_cones, count)
        cands[count] = (max(ev[1]) + max(vj[1]), ev, vj)
    best = min(c[0] for c in cands.values())
    count = min(c for c in SLICE_COUNTS if cands[c][0] <= SLICE_SLACK * best)
    _, (ev_own, ev_cost), (vj_own, vj_cost) = cands[count]
    dim = prog.dim
    whole = tuple(len(frozenset().union(*c)) for c in (ev_cones, vj_cones))
    return SlicePlan(
        count,
        tuple(tuple(i for i, o in enumerate(ev_own) if o == g)
              for g in range(count)),
        tuple(tuple(i for i, o in enumerate(vj_own[:dim]) if o == g)
              for g in range(count)),
        tuple(tuple(q for q, o in enumerate(vj_own[dim:]) if o == g)
              for g in range(count)),
        tuple(ev_cost), tuple(vj_cost), whole)


def _lit(v: float) -> str:
    if math.isnan(v):
        return '__builtin_nanf("")'
    if math.isinf(v):
        return "__builtin_huge_valf()" if v > 0 else "(-__builtin_huge_valf())"
    return f"({float.hex(float(v))}f)"


def _recip(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "lt": "<",
          "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
          "and": "&&", "or": "||"}
_CALL = {"sin": "sinf", "cos": "cosf", "exp": "expf", "log": "logf",
         "tanh": "tanhf", "sqrt": "sqrtf", "rsqrt": "rsqrtf",
         "abs": "fabsf", "pow": "powf", "erf": "erff", "expm1": "expm1f",
         "log1p": "log1pf", "sinh": "sinhf", "cosh": "coshf",
         "atan2": "atan2f", "gelu": "ldq_gelu", "gelut": "ldq_gelu_tanh",
         "gelub": "ldq_gelu_bwd", "gelubt": "ldq_gelu_tanh_bwd",
         "softplus": "ldq_softplus", "softplusb": "ldq_softplus_bwd"}


def _f32lit(v: float) -> str:
    return _lit(float(np.float32(v)))


# PyTorch's CUDA kernels' constants (ActivationGeluKernel.cu), each a
# constexpr float rounded once from its double expression.
_SQRT1_2 = _f32lit(0.70710678118654752440)
_GELU_TANH_BETA = _f32lit(1.41421356237309504880 * 1.12837916709551257390
                          * 0.5)
_GELU_KAPPA = _f32lit(0.044715)
_GELU_3KAPPA = _f32lit(np.float32(3.0) * np.float32(0.044715))
_GELU_PDF_BETA = _f32lit(1.12837916709551257390 * 0.70710678118654752440
                         * 0.5)

# The functions that print as a helper (defined once in a source that uses
# them): PyTorch's CUDA formula of each, in its operation order, with fmaf
# where nvcc contracted a multiply and add in PyTorch's build (its default
# --fmad=true; the library is built without contraction). Which ones it
# contracted was read off the card: tests/test_torch_cuda.py holds the
# generated forwards that use them to the plain ones bit for bit.
_HELPERS = {
    "gelu": f"""LDQ_GEN_FN float ldq_gelu(float x) {{
  return x * 0.5f * (1.0f + erff(x * {_SQRT1_2}));
}}""",
    "gelut": f"""LDQ_GEN_FN float ldq_gelu_tanh(float x) {{
  const float inner = {_GELU_TANH_BETA} * fmaf({_GELU_KAPPA}, x * x * x, x);
  return 0.5f * x * (1.0f + tanhf(inner));
}}""",
    "gelub": f"""LDQ_GEN_FN float ldq_gelu_bwd(float g, float x) {{
  const float cdf = 0.5f * (1.0f + erff(x * {_SQRT1_2}));
  const float pdf = expf(-0.5f * x * x) * {_GELU_PDF_BETA};
  return g * (cdf + x * pdf);
}}""",
    "gelubt": f"""LDQ_GEN_FN float ldq_gelu_tanh_bwd(float g, float x) {{
  const float x_sq = x * x;
  const float inner = {_GELU_TANH_BETA} * fmaf({_GELU_KAPPA}, x_sq * x, x);
  const float t = tanhf(inner);
  const float left = 0.5f * x;
  const float left_d = 0.5f * (1.0f + t);
  const float tanh_d = fmaf(-t, t, 1.0f);
  const float inner_d = {_GELU_TANH_BETA} * fmaf({_GELU_3KAPPA}, x_sq, 1.0f);
  return g * (left_d + left * tanh_d * inner_d);
}}""",
    "softplus": """LDQ_GEN_FN float ldq_softplus(float x, float beta, float thr) {
  return (x * beta) > thr ? x : log1pf(expf(x * beta)) / beta;
}""",
    "softplusb": """LDQ_GEN_FN float ldq_softplus_bwd(float g, float x, float beta,
                                 float thr) {
  const float z = expf(x * beta);
  return (x * beta) > thr ? g : g * z / (z + 1.0f);
}""",
}


def _expr(ins: Instr, a: List[str]) -> str:
    op = ins.op
    if op in _INFIX:
        return f"{a[0]} {_INFIX[op]} {a[1]}"
    if op in _CALL:
        return f"{_CALL[op]}({', '.join(a)})"
    if op == "divs":  # the card's x / c: x * (1/c) rounded to float32
        return f"{a[0]} * {_lit(_recip(ins.args[1].value))}"
    if op == "tanhb":  # PyTorch's a * (1 - b * b), 1 - b * b one FMA on the card
        return f"{a[0]} * fmaf(-{a[1]}, {a[1]}, 1.0f)"
    if op == "neg":
        return f"-{a[0]}"
    if op == "recip":
        return f"1.0f / {a[0]}"
    if op == "sgn":
        return f"(float)(({a[0]} > 0.0f) - ({a[0]} < 0.0f))"
    if op == "not":
        return f"!{a[0]}"
    if op == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    if op == "sigmoid":  # one / (one + exp(-a))
        return f"1.0f / (1.0f + expf(-{a[0]}))"
    if op == "sigmoidb":  # a * (one - b) * b
        return f"{a[0]} * (1.0f - {a[1]}) * {a[1]}"
    # the selects return a NaN operand, as PyTorch's kernels do (fmaxf and
    # fminf alone would return the other one)
    if op in ("max2", "min2"):
        fn = "fmaxf" if op == "max2" else "fminf"
        return (f"{a[0]} != {a[0]} ? {a[0]} : ({a[1]} != {a[1]} ? {a[1]} : "
                f"{fn}({a[0]}, {a[1]}))")
    if op in ("clampmin", "clampmax"):
        fn = "fmaxf" if op == "clampmin" else "fminf"
        return f"{a[0]} != {a[0]} ? {a[0]} : {fn}({a[0]}, {a[1]})"
    if op == "clamp":
        return (f"{a[0]} != {a[0]} ? {a[0]} : fminf(fmaxf({a[0]}, {a[1]}), "
                f"{a[2]})")
    if op == "clamp3":
        return (f"{a[0]} != {a[0]} ? {a[0]} : ({a[1]} != {a[1]} ? {a[1]} : "
                f"({a[2]} != {a[2]} ? {a[2]} : fminf(fmaxf({a[0]}, {a[1]}), "
                f"{a[2]})))")
    if op == "tofloat":
        return f"({a[0]} ? 1.0f : 0.0f)"
    if op == "tobool":
        return f"({a[0]} != 0.0f)"
    raise AssertionError(op)


class _Printer:
    def __init__(self, prog: FieldProgram):
        self.prog = prog
        inputs = {}
        for i, r in enumerate(prog.u_ids):
            inputs[r] = f"y[{i}]"
        for i, r in enumerate(prog.kb_ids):
            inputs[r] = f"kb[{i}]"
        inputs[prog.t_id] = "t"
        self.inputs = inputs
        self.row_in = {r: f"p[{q}]" for q, r in enumerate(prog.p_ids)}
        self.row_in.update({r: f"cst[{i}]"
                            for i, r in enumerate(prog.cst_ids)})

    def ctype(self, r) -> str:
        return "bool" if self.prog.kinds[r] == "b" else "float"

    def ref(self, r, in_row: bool) -> str:
        if isinstance(r, float):  # pow's exponent: powf takes its float32
            return _lit(float(np.float32(r)))
        if isinstance(r, Const):
            return ("true" if r.value else "false") if r.kind == "b" \
                else _lit(r.value)
        if in_row:
            return self.row_in.get(r, f"v{r}")
        if r in self.prog.per_row:
            return f"r.v{r}"
        return self.inputs.get(r, f"v{r}")

    def body(self, outputs) -> (List[str], set):
        """The statements of a function computing ``outputs``, and the
        per-row ids it reads."""
        lines, fields = [], set()
        for ins in self.prog.needed(outputs):
            if ins.out in self.prog.per_row:
                continue
            for a in ins.args:
                if isinstance(a, int) and a in self.prog.per_row:
                    fields.add(a)
            args = [self.ref(a, False) for a in ins.args]
            lines.append(f"    const {self.ctype(ins.out)} v{ins.out} = "
                         f"{_expr(ins, args)};  // {ins.node}")
        fields |= {r for r in outputs
                   if isinstance(r, int) and r in self.prog.per_row}
        return lines, fields


def functor_source(prog: FieldProgram, name: str = "GenRhs") -> str:
    """The functor text (host- and device-compilable with the preludes of
    ``kernel_source`` and ``host_source``)."""
    pr = _Printer(prog)
    ev, f_ev = pr.body(prog.dy)
    vj, f_vj = pr.body(prog.ubar + prog.pbar)
    fields = sorted(f_ev | f_vj)
    row_lines = []
    for ins in prog.needed(fields):
        args = [pr.ref(a, True) for a in ins.args]
        row_lines.append(f"    const {pr.ctype(ins.out)} v{ins.out} = "
                         f"{_expr(ins, args)};  // {ins.node}")
    row_lines += [f"    r.v{f} = {pr.ref(f, True)};" for f in fields]
    ev += [f"    dy[{i}] = {pr.ref(r, False)};" for i, r in enumerate(prog.dy)]
    vj += [f"    ubar[{i}] = {pr.ref(r, False)};"
           for i, r in enumerate(prog.ubar)]
    vj += [f"    pbar[{q}] = pbar[{q}] + {pr.ref(r, False)};"
           for q, r in enumerate(prog.pbar)]
    notes = "".join(f"//   {c}\n" for c in prog.card_rounding)
    members = "".join(f" {pr.ctype(f)} v{f};" for f in fields)
    used = {i.op for i in prog.instrs}
    helpers = "".join(text + "\n" for op, text in _HELPERS.items()
                      if op in used)
    sweep = not maps_fit(prog.dim, prog.pdim)
    sliced = _slices_source(pr, prog) if sweep else ""
    return f"""// The field {prog.name!r} (dim {prog.dim}, pdim {prog.pdim}, {prog.ncst} run-time
// constants), lowered by latentdiffeq_torch/ops/rhs_trace.py: {len(prog.instrs)} scalar
// operations, {len(fields)} of them kept a row.
{notes}{helpers}struct {name} {{
  static constexpr int DIM = {prog.dim};
  static constexpr int PDIM = {prog.pdim};
  static constexpr int NTRIG = 0;
  static constexpr bool FAST_TRIG = false;
  static constexpr bool SWEEP = {"true" if sweep else "false"};
  struct Row {{{members} }};
  LDQ_GEN_FN static Row row(const float* p, const float* cst) {{
    Row r;
{chr(10).join(row_lines)}
    (void)p;
    (void)cst;
    return r;
  }}
  LDQ_GEN_FN static void angles(const float* y, float* x) {{}}
  LDQ_GEN_FN static void eval(const Row& r, const float* y, float t,
                              const float* s, const float* c, float* dy) {{
{chr(10).join(ev)}
    (void)r;
    (void)t;
  }}
  LDQ_GEN_FN static void vjp(const Row& r, const float* y, float t,
                             const float* s, const float* c,
                             const float* kb, float* ubar, float* pbar) {{
{chr(10).join(vj)}
    (void)r;
    (void)y;
    (void)t;
  }}
{sliced}}};
"""


def _index_fns(name: str, parts) -> str:
    """``<name>_count(g)`` and ``<name>_index(g, a)``: how many outputs of
    one kind slice g owns, and the a-th of them."""
    width = max(1, max(len(p) for p in parts))
    rows = ", ".join("{" + ", ".join(map(str, list(p) or [0])) + "}"
                     for p in parts)
    return (f"  LDQ_GEN_CX static constexpr int {name}_count(int g) {{\n"
            f"    constexpr short n[{len(parts)}] = "
            f"{{{', '.join(str(len(p)) for p in parts)}}};\n"
            f"    return n[g];\n  }}\n"
            f"  LDQ_GEN_CX static constexpr int {name}_index(int g, int a) {{\n"
            f"    constexpr short i[{len(parts)}][{width}] = {{{rows}}};\n"
            f"    return i[g][a];\n  }}\n")


def _slices_source(pr: _Printer, prog: FieldProgram) -> str:
    """The members of a sweep functor that carry its slices (plan_slices):
    ``SLICES``; the outputs each slice owns (``ev_*`` the dy entries,
    ``ub_*`` the ubar entries, ``pb_*`` the pbar entries: ``_count(g)``,
    ``_index(g, a)``); each slice's ``eval_s<g>`` and ``vjp_s<g>`` (the
    whole programs' statements for the outputs it owns, in program order,
    its outputs packed: dy[a], ubar[a] and pbar[b] are its a-th / b-th
    owned entries, pbar added into); and the ``eval_slice<g>`` /
    ``vjp_slice<g>`` templates the kernel calls."""
    plan = plan_slices(prog)
    out = [f"  // {plan.count} slices (of {', '.join(map(str, SLICE_COUNTS))}:"
           f" the fewest within {SLICE_SLACK} x the cheapest, longest eval "
           f"slice + longest vjp slice);\n"
           f"  // statements a stage: eval {list(plan.eval_cost)} (whole "
           f"{plan.whole[0]}), vjp {list(plan.vjp_cost)} (whole "
           f"{plan.whole[1]})\n",
           f"  static constexpr int SLICES = {plan.count};\n",
           _index_fns("ev", plan.eval_parts),
           _index_fns("ub", plan.vjp_ubar),
           _index_fns("pb", plan.vjp_pbar)]
    for g in range(plan.count):
        ev, _ = pr.body([prog.dy[i] for i in plan.eval_parts[g]])
        ev += [f"    dy[{a}] = {pr.ref(prog.dy[i], False)};"
               for a, i in enumerate(plan.eval_parts[g])]
        vj, _ = pr.body([prog.ubar[i] for i in plan.vjp_ubar[g]]
                        + [prog.pbar[q] for q in plan.vjp_pbar[g]])
        vj += [f"    ubar[{a}] = {pr.ref(prog.ubar[i], False)};"
               for a, i in enumerate(plan.vjp_ubar[g])]
        vj += [f"    pbar[{b}] = pbar[{b}] + {pr.ref(prog.pbar[q], False)};"
               for b, q in enumerate(plan.vjp_pbar[g])]
        unused = "".join(f"    (void){v};\n" for v in ("r", "y", "t"))
        out.append(
            f"  LDQ_GEN_FN static void eval_s{g}(const Row& r, const float* y,"
            f" float t, float* dy) {{\n" + "".join(x + "\n" for x in ev)
            + unused + "    (void)dy;\n  }\n"
            f"  LDQ_GEN_FN static void vjp_s{g}(const Row& r, const float* y, "
            f"float t, const float* kb, float* ubar, float* pbar) {{\n"
            + "".join(x + "\n" for x in vj) + unused
            + "    (void)kb;\n    (void)ubar;\n    (void)pbar;\n  }\n")
    for fn, args, call in (
            ("eval_slice", "const float* y, float t, float* dy", "y, t, dy"),
            ("vjp_slice", "const float* y, float t, const float* kb, "
             "float* ubar, float* pbar", "y, t, kb, ubar, pbar")):
        short = fn.split("_")[0] + "_s"
        cases = "\n    else ".join(
            f"if constexpr (g == {g}) {short}{g}(r, {call});"
            for g in range(plan.count))
        out.append(f"  template <int g>\n  LDQ_GEN_FN static void {fn}("
                   f"const Row& r, {args}) {{\n    {cases}\n  }}\n")
    return "".join(out)


def kernel_source(prog: FieldProgram) -> str:
    """The CUDA source of a generated instance: the header, the functor and
    the entry points (``ldq_rk_fixed_grid``, ``ldq_rk_fixed_grid_bwd``,
    ``rhs_kind`` 0)."""
    return f"""// Generated by latentdiffeq_torch/ops/rhs_codegen.py: the batched RK kernels
// of rk_fixed_grid.cuh on a device functor lowered from a Python field.
#include "rk_fixed_grid.cuh"

#define LDQ_GEN_FN __device__ __forceinline__
#define LDQ_GEN_CX __host__ __device__

namespace {{
{functor_source(prog)}}}  // namespace

LDQ_RK_ENTRY_POINTS(GenRhs, {"true" if prog.ncst else "false"})
"""


def kuramoto_source(n: int) -> str:
    """The one-line source of the Kuramoto kernels at N oscillators (the
    offsets their run-time constants): the lane groups up to
    ``KURAMOTO_LANES_MAX_N``, a block a trajectory past it (and at 1)."""
    tag = "KuramotoLanes" if 2 <= n <= KURAMOTO_LANES_MAX_N \
        else "KuramotoBlock"
    return (f'#include "rk_fixed_grid.cuh"\n'
            f"LDQ_RK_ENTRY_POINTS({tag}<{n}>, true)\n")


def host_source(prog: FieldProgram) -> str:
    """The functor for a host compiler, with C entry points over rows:
    ``ldq_gen_eval(n, y, p, t, cst, dy)`` and ``ldq_gen_vjp(n, y, p, t,
    cst, kb, ubar, pbar)`` (pbar accumulated into, as the kernel does);
    ``ldq_gen_slices()`` (0 unless a sweep functor) and a sweep functor's
    slices (``_host_slices``)."""
    D, P = prog.dim, prog.pdim
    return f"""#include <math.h>
static inline float rsqrtf(float x) {{ return 1.0f / sqrtf(x); }}
#define LDQ_GEN_FN inline
#define LDQ_GEN_CX

namespace {{
{functor_source(prog)}}}  // namespace

extern "C" void ldq_gen_eval(int n, const float* y, const float* p,
                             const float* t, const float* cst, float* dy) {{
  for (int i = 0; i < n; ++i) {{
    const GenRhs::Row r = GenRhs::row(p + i * {P}, cst);
    GenRhs::eval(r, y + i * {D}, t[i], nullptr, nullptr, dy + i * {D});
  }}
}}

extern "C" void ldq_gen_vjp(int n, const float* y, const float* p,
                            const float* t, const float* cst,
                            const float* kb, float* ubar, float* pbar) {{
  for (int i = 0; i < n; ++i) {{
    const GenRhs::Row r = GenRhs::row(p + i * {P}, cst);
    GenRhs::vjp(r, y + i * {D}, t[i], nullptr, nullptr, kb + i * {D},
                ubar + i * {D}, pbar + i * {P});
  }}
}}
{_host_slices(prog) if not maps_fit(D, P) else _NO_SLICES}
"""


_NO_SLICES = 'extern "C" int ldq_gen_slices() { return 0; }\n'


def _host_slices(prog: FieldProgram) -> str:
    """host_source's entry points for a sweep functor's slices:
    ``ldq_gen_slices()``, ``ldq_gen_owner(which, i)`` (which 0: dy, 1:
    ubar, 2: pbar) and ``ldq_gen_eval_slice(g, ...)`` /
    ``ldq_gen_vjp_slice(g, ...)``, ``ldq_gen_eval`` / ``ldq_gen_vjp``'s
    arguments after the slice, writing only the outputs slice g owns (its
    packed outputs put back at their indices)."""
    D, P = prog.dim, prog.pdim
    plan = plan_slices(prog)
    count = plan.count
    width = max(1, max(len(p) for p in plan.eval_parts + plan.vjp_ubar
                       + plan.vjp_pbar))

    def switch(call):
        return "".join(f"      case {g}: GenRhs::{call.format(g=g)}; break;\n"
                       for g in range(count))
    vjp_call = (f"vjp_slice<{{g}}>(r, y + i * {D}, t[i], kb + i * {D}, ub, "
                f"pb)")
    return f"""extern "C" int ldq_gen_slices() {{ return GenRhs::SLICES; }}

extern "C" int ldq_gen_owner(int which, int i) {{
  for (int g = 0; g < GenRhs::SLICES; ++g) {{
    const int n = which == 0 ? GenRhs::ev_count(g)
                  : which == 1 ? GenRhs::ub_count(g) : GenRhs::pb_count(g);
    for (int a = 0; a < n; ++a) {{
      const int at = which == 0 ? GenRhs::ev_index(g, a)
                     : which == 1 ? GenRhs::ub_index(g, a)
                                  : GenRhs::pb_index(g, a);
      if (at == i) return g;
    }}
  }}
  return -1;
}}

extern "C" void ldq_gen_eval_slice(int g, int n, const float* y,
                                   const float* p, const float* t,
                                   const float* cst, float* dy) {{
  for (int i = 0; i < n; ++i) {{
    const GenRhs::Row r = GenRhs::row(p + i * {P}, cst);
    float out[{width}];
    switch (g) {{
{switch(f"eval_slice<{{g}}>(r, y + i * {D}, t[i], out)")}    }}
    for (int a = 0; a < GenRhs::ev_count(g); ++a)
      dy[i * {D} + GenRhs::ev_index(g, a)] = out[a];
  }}
}}

extern "C" void ldq_gen_vjp_slice(int g, int n, const float* y,
                                  const float* p, const float* t,
                                  const float* cst, const float* kb,
                                  float* ubar, float* pbar) {{
  for (int i = 0; i < n; ++i) {{
    const GenRhs::Row r = GenRhs::row(p + i * {P}, cst);
    float ub[{width}], pb[{width}];
    for (int b = 0; b < GenRhs::pb_count(g); ++b)
      pb[b] = pbar[i * {P} + GenRhs::pb_index(g, b)];
    switch (g) {{
{switch(vjp_call)}    }}
    for (int a = 0; a < GenRhs::ub_count(g); ++a)
      ubar[i * {D} + GenRhs::ub_index(g, a)] = ub[a];
    for (int b = 0; b < GenRhs::pb_count(g); ++b)
      pbar[i * {P} + GenRhs::pb_index(g, b)] = pb[b];
  }}
}}
"""
