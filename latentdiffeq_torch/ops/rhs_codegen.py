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

The backward kernel gives each interval to one thread, which holds the
interval's maps J (dim x dim) and r (dim x pdim) in registers; a field
whose maps pass ``MAX_MAP_FLOATS`` floats is refused (``check_width``).
Kuramoto, whose hand-written lane-group kernels take any width up to
``KURAMOTO_MAX_N`` oscillators, gets a one-line source instead
(``kuramoto_source``).

``host_source`` wraps the same functor text for a host compiler (``g++``),
so the CPU tests can call it through ``ctypes``.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .rhs_trace import Const, FieldProgram, Instr

__all__ = ["MAX_MAP_FLOATS", "KURAMOTO_MAX_N", "check_width",
           "functor_source", "kernel_source", "kuramoto_source",
           "host_source"]

# The one-thread backward keeps J and r of an interval in registers (and
# the step's Js, Rs beside them): at dim*dim + dim*pdim <= 128 floats they
# take at most half of a thread's 255 registers (Kuramoto-10's 120 fit).
MAX_MAP_FLOATS = 128
# The lane-group Kuramoto kernels put one oscillator on a lane of a warp
# and mask the group with (1 << N) - 1.
KURAMOTO_MAX_N = 31


def check_width(name: str, dim: int, pdim: int):
    """ValueError when the one-thread backward cannot hold the maps."""
    if dim * dim + dim * pdim > MAX_MAP_FLOATS:
        raise ValueError(
            f"the field {name!r} has dim {dim}, pdim {pdim}: the batched-solve "
            f"kernel's backward holds each interval's maps J (dim x dim) and "
            f"r (dim x pdim) in a thread's registers, dim*dim + dim*pdim <= "
            f"{MAX_MAP_FLOATS} floats, here {dim * dim + dim * pdim}; set "
            f"use_kernel_solver=False to solve it with the plain PyTorch path")


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
         "abs": "fabsf", "pow": "powf"}


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
    return f"""// The field {prog.name!r} (dim {prog.dim}, pdim {prog.pdim}, {prog.ncst} run-time
// constants), lowered by latentdiffeq_torch/ops/rhs_trace.py: {len(prog.instrs)} scalar
// operations, {len(fields)} of them kept a row.
{notes}struct {name} {{
  static constexpr int DIM = {prog.dim};
  static constexpr int PDIM = {prog.pdim};
  static constexpr int NTRIG = 0;
  static constexpr bool FAST_TRIG = false;
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
    """The one-line source of the lane-group Kuramoto kernels at N
    oscillators (the offsets their run-time constants)."""
    return (f'#include "rk_fixed_grid.cuh"\n'
            f"LDQ_RK_ENTRY_POINTS(KuramotoLanes<{n}>, true)\n")


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
