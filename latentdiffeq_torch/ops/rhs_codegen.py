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
``SWEEP`` member, printed from ``maps_fit``, tells the header which. Kuramoto gets a one-line source instead
(``kuramoto_source``): the hand-written lane-group kernels up to
``KURAMOTO_LANES_MAX_N`` oscillators, the block kernels past that.

``host_source`` wraps the same functor text for a host compiler (``g++``),
so the CPU tests can call it through ``ctypes``.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .rhs_trace import Const, FieldProgram, Instr

__all__ = ["MAX_MAP_FLOATS", "KURAMOTO_LANES_MAX_N", "KURAMOTO_MAX_N",
           "maps_fit", "functor_source", "kernel_source", "kuramoto_source",
           "host_source"]

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
    sweep = "false" if maps_fit(prog.dim, prog.pdim) else "true"
    return f"""// The field {prog.name!r} (dim {prog.dim}, pdim {prog.pdim}, {prog.ncst} run-time
// constants), lowered by latentdiffeq_torch/ops/rhs_trace.py: {len(prog.instrs)} scalar
// operations, {len(fields)} of them kept a row.
{notes}{helpers}struct {name} {{
  static constexpr int DIM = {prog.dim};
  static constexpr int PDIM = {prog.pdim};
  static constexpr int NTRIG = 0;
  static constexpr bool FAST_TRIG = false;
  static constexpr bool SWEEP = {sweep};
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
}};
"""


def kernel_source(prog: FieldProgram) -> str:
    """The CUDA source of a generated instance: the header, the functor and
    the entry points (``ldq_rk_fixed_grid``, ``ldq_rk_fixed_grid_bwd``,
    ``rhs_kind`` 0)."""
    return f"""// Generated by latentdiffeq_torch/ops/rhs_codegen.py: the batched RK kernels
// of rk_fixed_grid.cuh on a device functor lowered from a Python field.
#include "rk_fixed_grid.cuh"

#define LDQ_GEN_FN __device__ __forceinline__

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
    cst, kb, ubar, pbar)`` (pbar accumulated into, as the kernel does)."""
    D, P = prog.dim, prog.pdim
    return f"""#include <math.h>
static inline float rsqrtf(float x) {{ return 1.0f / sqrtf(x); }}
#define LDQ_GEN_FN inline

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
"""
