"""Trace one row of a user-written vector field into a checked scalar
program that the batched RK kernel can run.

JAX's Pallas solve traces the user's ``f(u, p, t)`` into its kernel body
(latentdiffeq/ops/ode_pallas.py:40-70: ``_batched_rk_step`` vmaps ``f``
over the batch tile and ``_solve_kernel`` loops it over the grid) and takes
its gradient from ``jax.vjp`` of the plain solve of the same ``f``
(:156-170). The port does the same in two steps: this module traces ``f``
on one row with ``make_fx`` (``u`` (dim,), ``p`` (pdim,), ``t`` a 0-d
tensor) and ``torch.func.vjp(f, u, p)`` applied to a cotangent ``kb`` into
two aten graphs (functionalized: an in-place op is its functional form,
a write through a view a scatter into its base), and lowers both into one
straight-line program of float32 scalar operations; ``rhs_codegen`` prints
that program as a device functor for csrc/rk_fixed_grid.cuh.

Lowering. Every tensor of a graph is a small array of scalar references
(numpy object arrays): an elementwise aten op becomes one scalar operation
per element, in graph order; views (select, slice, unsqueeze, expand,
view, permute, ...) only rearrange references; ``stack`` and ``cat`` join
them; ``sum`` over a static axis adds in index order (longer than two
terms, torch's sums take other orders on either device, so they agree to
rounding). Identical operations on identical operands are
one value (the VJP graph recomputes the forward), and a value that depends
on ``p`` and the field's run-time constants alone is a per-row value: the
kernel computes it once a row (the functor's ``Row``), with the same
operation on the same operands, so no bit changes.

Rounding follows the plain version on the card. A tensor divided by a
Python number is a product with the number's float32 reciprocal there
(PyTorch's CUDA division by a CPU scalar) and a division on the CPU: the
program keeps the division (op ``divs``), records it in
``FieldProgram.card_rounding``, and the functor multiplies by the
reciprocal. ``pow`` by a scalar takes PyTorch's special cases (0.5 sqrt,
-0.5 rsqrt, -1 reciprocal, 2 and 3 products, -2 the reciprocal of the
square, 0 and 1 constants), the rest ``powf``. The functions
(``sigmoid``, ``softplus``, ``erf``, ``gelu``, ``expm1``, ``log1p``,
``sinh``, ``cosh``, ``atan2``) and their backward ops are one scalar
operation each, which ``rhs_codegen`` prints as the formula of PyTorch's
CUDA kernel; the selects keep PyTorch's NaN rule (``relu``, ``clamp``,
``maximum`` and ``minimum`` return a NaN operand) and the gradients'
own tie rules (``maximum``'s and ``amax``'s are in their VJP graphs as
``where`` and ``masked_fill``). ``roll`` and ``flip`` only rearrange
references; ``mean`` is a sum divided by the count (on the card: times its
float32 reciprocal), ``prod``, ``cumsum``, ``cumprod``, the 2-norm and the
matrix products (``dot``, ``mv``, ``mm``, ``bmm``, ``addmv``, ``addmm``)
are sums and products in index order. A reduction or scan of more than
``EXACT_TERMS`` terms, and any matrix product, agrees with either device's
plain version to rounding only (``FieldProgram.inexact`` names each).

Refusals, each a ``ValueError`` naming the graph node, raised while
tracing, before any device is looked at (the caller never solves with the
plain path instead):
- a tensor the field captures (JAX's Pallas solve refuses a captured array
  too); the field's ``rhs_consts(device, dtype)`` is the one sanctioned
  way to pass constants, and its tensor becomes the kernel's ``cst``;
- control flow that depends on data (a tensor read as a Python value);
- an op outside ``LOWERABLE``, or a value that is neither float32 nor bool.

``interpret`` runs a program op by op in float32 on the CPU, each scalar
operation as the torch op it came from over all rows at once: on the same
rows it equals ``f`` and ``torch.func.vjp`` bit for bit where the program
has no ``inexact`` reduction and the CPU's vectorised and scalar loops of
its functions agree (the tests hold it so, and the rest to a few units in
the last place).
"""
from __future__ import annotations

import dataclasses
import operator
import struct
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["LOWERABLE", "Const", "Instr", "FieldProgram", "trace_field",
           "interpret", "field_name"]

aten = torch.ops.aten

# The aten ops the lowering takes (by op name; the VJP graphs' own ops, the
# adjoints of these, included).
LOWERABLE = frozenset({
    # elementwise arithmetic with tensors and scalars
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sin", "cos",
    "exp", "log", "tanh", "sqrt", "rsqrt", "abs", "sgn", "sign", "pow",
    "tanh_backward",
    # functions and their backward ops
    "sigmoid", "sigmoid_backward", "softplus", "softplus_backward", "erf",
    "gelu", "gelu_backward", "expm1", "log1p", "sinh", "cosh", "atan2",
    # selects: where, comparisons, clamps and extrema
    "where", "gt", "lt", "ge", "le", "eq", "ne", "logical_not",
    "logical_and", "logical_or", "bitwise_not", "bitwise_and", "bitwise_or",
    "masked_fill", "relu", "threshold_backward", "clamp", "clamp_min",
    "clamp_max", "maximum", "minimum",
    # views and indexing
    "select", "slice", "unsqueeze", "squeeze", "expand", "view",
    "_unsafe_view", "reshape", "permute", "transpose", "t", "clone", "alias",
    "detach", "_to_copy", "unbind", "split", "split_with_sizes",
    "select_backward", "slice_backward", "select_scatter", "slice_scatter",
    "as_strided", "as_strided_scatter", "copy", "new_empty_strided",
    "roll", "flip",
    # joins, reductions, products, constants
    "stack", "cat", "sum", "mean", "prod", "cumsum", "cumprod", "amax",
    "amin", "linalg_vector_norm", "dot", "mv", "mm", "bmm", "addmv", "addmm",
    "scalar_tensor", "full", "full_like", "zeros",
    "zeros_like", "ones", "ones_like", "new_zeros", "new_ones", "new_full",
})

# The graphs are traced functionalized: an in-place op (the field's own,
# ``x[1:].add_(y)`` included, or ``masked_fill_``, ``logical_and_``,
# ``squeeze_``, ... of the VJP graphs) is its functional form there, and a
# write through a view is a ``slice_scatter`` / ``select_scatter`` /
# ``as_strided_scatter`` into its base, so every later read of the base or
# of a view taken before the write sees the written value.

# Reductions longer than this run in index order here and in other orders
# on the plain versions (the card's reduction kernel splits a row over its
# threads and joins them by a shuffle tree, its order set by the launch's
# shape: sums of 3 and 4 terms came out of index order on the H100; the
# CPU takes several partial sums past 4; matrix products at any length:
# BLAS and cuBLAS fix no order), so the two agree to rounding, not bit for
# bit (``FieldProgram.inexact``). Two terms are one commutative operation.
EXACT_TERMS = 2


def field_name(f: Callable) -> str:
    return getattr(f, "__name__", type(f).__name__)


@dataclasses.dataclass(frozen=True)
class Const:
    """A constant operand: a float32 value (``kind`` "f") or a bool ("b")."""
    value: float
    kind: str = "f"


@dataclasses.dataclass(frozen=True)
class Instr:
    """One scalar operation: ``out`` = ``op``(``args``), ``args`` scalar ids
    (int) or ``Const``; ``node`` the aten node it lowers."""
    out: int
    op: str
    args: tuple
    node: str


# scalar ops -> result kind; every other op gives a float
_BOOL_OPS = frozenset({"lt", "le", "gt", "ge", "eq", "ne", "not", "and",
                       "or", "tobool"})


@dataclasses.dataclass
class FieldProgram:
    """A field lowered to scalar operations. Scalar ids: ``u_ids`` (dim,),
    ``p_ids`` (pdim,), ``t_id``, ``kb_ids`` (dim,), ``cst_ids`` (ncst,),
    then one id per ``Instr`` (``instrs`` in id order). Outputs are lists
    of ids or ``Const``: ``dy`` (dim,) = f(u, p, t), ``ubar`` (dim,) =
    J_f^T kb and ``pbar`` (pdim,) = (df/dp)^T kb. ``per_row`` holds the ids
    that depend on ``p`` and the constants alone. ``card_rounding`` lists
    the divisions by a number that the card computes as products with the
    reciprocal. ``uses_t``: whether an output depends on ``t``.
    ``inexact`` names the reductions, scans and matrix products whose plain
    versions take another order of the same sums (``EXACT_TERMS``)."""
    name: str
    dim: int
    pdim: int
    ncst: int
    u_ids: List[int]
    p_ids: List[int]
    t_id: int
    kb_ids: List[int]
    cst_ids: List[int]
    instrs: List[Instr]
    kinds: Dict[int, str]
    per_row: frozenset
    dy: list
    ubar: list
    pbar: list
    card_rounding: List[str]
    uses_t: bool
    inexact: List[str] = dataclasses.field(default_factory=list)

    def needed(self, outputs: Sequence) -> List[Instr]:
        """The instructions ``outputs`` reach, in id order."""
        by_id = {ins.out: ins for ins in self.instrs}
        seen, stack = set(), [r for r in outputs if isinstance(r, int)]
        while stack:
            r = stack.pop()
            if r in seen:
                continue
            seen.add(r)
            ins = by_id.get(r)
            if ins is not None:
                stack.extend(a for a in ins.args if isinstance(a, int))
        return [ins for ins in self.instrs if ins.out in seen]


def _f32(v) -> float:
    return float(np.float32(v))


def _key(r):
    if isinstance(r, float):  # pow's exponent, kept as the graph had it
        return ("n", float.hex(r))
    if isinstance(r, Const):
        bits = (struct.pack("<f", r.value) if r.kind == "f"
                else bytes([bool(r.value)]))
        return ("c", r.kind, bits)
    return ("v", r)


class _ScalarSSA:
    """Hash-consed SSA of scalar operations with dependency tracking."""

    def __init__(self):
        self.instrs: List[Instr] = []
        self.kinds: Dict[int, str] = {}
        self.deps: Dict[int, frozenset] = {}
        self.cse: Dict[tuple, int] = {}
        self.n = 0
        self.card_rounding: List[str] = []
        self.inexact: List[str] = []

    def note_inexact(self, note: str):
        if note not in self.inexact:
            self.inexact.append(note)

    def new_input(self, dep: str) -> int:
        i = self.n
        self.n += 1
        self.kinds[i] = "f"
        self.deps[i] = frozenset({dep})
        return i

    def kind(self, r) -> str:
        return r.kind if isinstance(r, Const) else self.kinds[r]

    def emit(self, op: str, args: tuple, node: str) -> int:
        key = (op,) + tuple(_key(a) for a in args)
        hit = self.cse.get(key)
        if hit is not None:
            return hit
        i = self.n
        self.n += 1
        self.instrs.append(Instr(i, op, args, node))
        self.kinds[i] = "b" if op in _BOOL_OPS else "f"
        deps = frozenset()
        for a in args:
            if isinstance(a, int):
                deps = deps | self.deps[a]
        self.deps[i] = deps
        self.cse[key] = i
        return i

    def as_float(self, r, node):
        if self.kind(r) == "f":
            return r
        if isinstance(r, Const):
            return Const(1.0 if r.value else 0.0)
        return self.emit("tofloat", (r,), node)

    def as_bool(self, r, node):
        if self.kind(r) == "b":
            return r
        if isinstance(r, Const):
            return Const(bool(r.value != 0.0), "b")
        return self.emit("tobool", (r,), node)


def _arr(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    a = np.empty((), dtype=object)
    a[()] = x
    return a


def _map(shape, fn) -> np.ndarray:
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        out[idx] = fn(idx)
    return out


def _take(x: np.ndarray, d: int, i: int) -> np.ndarray:
    """x indexed by i along axis d, as an array (0-d for a 1-D x)."""
    r = x[(slice(None),) * d + (i,)]
    return r if isinstance(r, np.ndarray) else _arr(r)


def _const_array(shape, value, kind="f") -> np.ndarray:
    c = Const(_f32(value) if kind == "f" else bool(value), kind)
    return _map(tuple(shape), lambda _: c)


class _RefusedError(ValueError):
    pass


def _refuse(fname: str, node: str, why: str):
    raise _RefusedError(f"the field {fname!r} cannot run on the batched-solve "
                        f"kernel: node {node!r}: {why}")


def _dim(d: int, n: int) -> int:
    return d + n if d < 0 else d


class _Lowering:
    """Lowers one aten graph into the scalar program ``b`` holds."""

    def __init__(self, b: _ScalarSSA, fname: str, cst_arr, cst_tensor):
        self.b = b
        self.fname = fname
        self.cst_arr = cst_arr
        self.cst_tensor = cst_tensor

    # -- operand helpers ----------------------------------------------------
    def operand(self, x):
        """A lowered operand: an array of refs (tensors) or a Const array
        (Python numbers, float32 or bool)."""
        if isinstance(x, np.ndarray):
            return x
        if isinstance(x, bool):
            return _arr(Const(x, "b"))
        if isinstance(x, (int, float)):
            return _arr(Const(_f32(x)))
        raise TypeError(type(x))

    def elementwise(self, op, operands, node, kind_in="f"):
        arrs = np.broadcast_arrays(*[self.operand(x) for x in operands])
        b = self.b
        conv = b.as_float if kind_in == "f" else b.as_bool

        def one(idx):
            args = tuple(conv(a[idx], node) for a in arrs)
            return b.emit(op, args, node)
        return _map(arrs[0].shape, one)

    # -- the lowering of one node ---------------------------------------------
    def lower_node(self, node, env):
        args = torch.fx.node.map_arg(node.args, lambda n: env[n])
        kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
        name = node.target.overloadpacket.__name__
        ov = node.target._overloadname
        b, nm = self.b, node.name
        ew = lambda op, *xs: self.elementwise(op, xs, nm)  # noqa: E731

        if name in ("add", "sub"):
            alpha = kwargs.get("alpha", 1)
            if alpha != 1:
                _refuse(self.fname, nm, f"aten.{name} with alpha={alpha} "
                        f"(only alpha 1 is lowered)")
            return ew(name, args[0], args[1])
        if name == "rsub":
            if kwargs.get("alpha", 1) != 1:
                _refuse(self.fname, nm, "aten.rsub with alpha != 1")
            return ew("sub", args[1], args[0])
        if name == "mul":
            return ew("mul", args[0], args[1])
        if name == "div":
            if "rounding_mode" in kwargs or ov == "Tensor_mode":
                _refuse(self.fname, nm, "aten.div with a rounding mode")
            if not isinstance(args[1], np.ndarray):
                x = self.operand(args[0])
                return _map(x.shape, lambda i: self.divs(x[i], args[1], nm))
            return ew("div", args[0], args[1])
        unary = {"neg": "neg", "reciprocal": "recip", "sin": "sin",
                 "cos": "cos", "exp": "exp", "log": "log", "tanh": "tanh",
                 "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs",
                 "sgn": "sgn", "sign": "sgn", "sigmoid": "sigmoid",
                 "erf": "erf", "expm1": "expm1", "log1p": "log1p",
                 "sinh": "sinh", "cosh": "cosh"}
        if name in unary:
            return ew(unary[name], args[0])
        binary = {"atan2": "atan2", "sigmoid_backward": "sigmoidb",
                  "maximum": "max2", "minimum": "min2"}
        if name in binary:
            return ew(binary[name], args[0], args[1])
        if name == "pow":
            if ov != "Tensor_Scalar":
                _refuse(self.fname, nm, f"aten.pow.{ov} (only a tensor to a "
                        f"scalar power is lowered)")
            return self.pow(args[0], args[1], nm)
        if name == "tanh_backward":
            # g * (1 - y * y), one op: both devices' kernels fuse 1 - y * y
            # into one multiply-add (the functor writes the fmaf)
            return ew("tanhb", args[0], args[1])
        if name in ("gt", "lt", "ge", "le", "eq", "ne"):
            return ew(name, args[0], args[1])
        if name in ("logical_not", "bitwise_not"):
            self.need_bool(args[0], nm, name)
            return self.elementwise("not", (args[0],), nm, "b")
        if name in ("logical_and", "bitwise_and", "logical_or",
                    "bitwise_or"):
            for a in args[:2]:
                self.need_bool(a, nm, name)
            op = "and" if name.endswith("and") else "or"
            return self.elementwise(op, (args[0], args[1]), nm, "b")
        if name == "where":
            return self.where(args[0], args[1], args[2], nm)
        if name in ("softplus", "softplus_backward"):
            lead = 1 if name == "softplus" else 2
            beta = args[lead] if len(args) > lead else kwargs.get("beta", 1)
            thr = (args[lead + 1] if len(args) > lead + 1
                   else kwargs.get("threshold", 20))
            x = [self.operand(a) for a in args[:lead]]
            if isinstance(beta, np.ndarray) or isinstance(thr, np.ndarray):
                _refuse(self.fname, nm, f"aten.{name} with a tensor beta or "
                        f"threshold")
            return self.with_numbers("softplus" if lead == 1 else "softplusb",
                                     x, (_f32(beta), _f32(thr)), nm)
        if name in ("gelu", "gelu_backward"):
            approx = kwargs.get("approximate", args[-1] if isinstance(
                args[-1], str) else "none")
            if approx not in ("none", "tanh"):
                _refuse(self.fname, nm, f"aten.{name} approximate={approx!r}")
            op = {"gelu": "gelu", "gelu_backward": "gelub"}[name]
            op += "t" if approx == "tanh" else ""
            return ew(op, *(args[:1] if name == "gelu" else args[:2]))
        if name == "relu":
            return self.with_numbers("clampmin", [self.operand(args[0])],
                                     (0.0,), nm)
        if name == "threshold_backward":
            # PyTorch's threshold: self <= threshold ? 0 : grad (a NaN self
            # passes the gradient)
            le = self.elementwise("le", (args[1], args[2]), nm)
            return self.where(le, 0.0, args[0], nm)
        if name == "masked_fill":
            return self.where(args[1], args[2], args[0], nm)
        if name in ("clamp", "clamp_min", "clamp_max"):
            return self.clamp(name, args, kwargs, nm)
        return self.lower_structural(name, ov, args, kwargs, node)

    def where(self, cond, a, b_, nm):
        b = self.b
        arrs = np.broadcast_arrays(*[self.operand(x) for x in (cond, a, b_)])
        return _map(arrs[0].shape, lambda i: b.emit(
            "where", (b.as_bool(arrs[0][i], nm), b.as_float(arrs[1][i], nm),
                      b.as_float(arrs[2][i], nm)), nm))

    def with_numbers(self, op, tensors, numbers, nm):
        """One scalar ``op`` per element of the broadcast ``tensors``, with
        Python numbers (a float32 value each) as its last arguments."""
        b = self.b
        arrs = np.broadcast_arrays(*tensors)
        return _map(arrs[0].shape, lambda i: b.emit(
            op, tuple(b.as_float(a[i], nm) for a in arrs) + tuple(numbers),
            nm))

    def clamp(self, name, args, kwargs, nm):
        """PyTorch's clamps: scalar bounds as one op that returns a NaN x
        (its CUDA kernel's ``isnan(v) ? v : min(max(v, lo), hi)``); tensor
        bounds as ``maximum`` / ``minimum``, or the three-tensor clamp, as
        PyTorch routes them."""
        x = args[0]
        if name == "clamp":
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
        elif name == "clamp_min":
            lo, hi = args[1], None
        else:
            lo, hi = None, args[1]
        tensor = isinstance(lo, np.ndarray) or isinstance(hi, np.ndarray)
        ew = lambda op, *xs: self.elementwise(op, xs, nm)  # noqa: E731
        if not tensor:
            bounds = tuple(_f32(v) for v in (lo, hi) if v is not None)
            op = ("clamp" if lo is not None and hi is not None
                  else "clampmin" if lo is not None else "clampmax")
            return self.with_numbers(op, [self.operand(x)], bounds, nm)
        if lo is not None and hi is not None:
            return ew("clamp3", x, lo, hi)
        return ew("max2", x, lo) if lo is not None else ew("min2", x, hi)

    def kind_of(self, a) -> str:
        a = self.operand(a)
        return self.b.kind(a.flat[0]) if a.size else "f"

    def need_bool(self, a, nm, name):
        if self.kind_of(a) != "b":
            _refuse(self.fname, nm, f"aten.{name} on a float tensor")

    def pow(self, x, e, nm):
        """PyTorch's pow by a scalar: its special cases, as on both
        devices, else powf."""
        ew = lambda op, *xs: self.elementwise(op, xs, nm)  # noqa: E731
        e = float(e)
        x = self.operand(x)
        if e == 0.0:
            return _const_array(x.shape, 1.0)
        if e == 1.0:
            return x
        if e == 0.5:
            return ew("sqrt", x)
        if e == -0.5:
            return ew("rsqrt", x)
        if e == -1.0:
            return ew("recip", x)
        if e == 2.0:
            return ew("mul", x, x)
        if e == 3.0:
            return ew("mul", ew("mul", x, x), x)
        if e == -2.0:
            return ew("recip", ew("mul", x, x))
        # the exponent stays the Python number: the CPU raises to it in
        # double, the card to its float32 rounding (powf)
        b = self.b
        return _map(x.shape, lambda i: b.emit(
            "pow", (b.as_float(x[i], nm), e), nm))

    def lower_structural(self, name, ov, args, kwargs, node):
        nm = node.name
        val = node.meta.get("val")
        shape = tuple(val.shape) if isinstance(val, torch.Tensor) else None
        kind = "b" if (isinstance(val, torch.Tensor)
                       and val.dtype == torch.bool) else "f"
        if name == "select":
            x, d, i = args
            d = _dim(d, x.ndim)
            return _take(x, d, i + x.shape[d] if i < 0 else i)
        if name == "slice":
            x, d = args[0], _dim(args[1] if len(args) > 1 else 0, args[0].ndim)
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            sl = [slice(None)] * x.ndim
            sl[d] = slice(start, end, step)
            return x[tuple(sl)]
        if name == "unsqueeze":
            x, d = args
            return np.expand_dims(x, _dim(d, x.ndim + 1))
        if name == "squeeze":
            x = args[0]
            if ov == "default":
                dims = [i for i, s in enumerate(x.shape) if s == 1]
            else:
                dims = args[1] if isinstance(args[1], (list, tuple)) \
                    else [args[1]]
                dims = [_dim(d, x.ndim) for d in dims if x.shape[
                    _dim(d, x.ndim)] == 1]
            return np.squeeze(x, axis=tuple(dims)) if dims else x
        if name == "expand":
            x, sizes = args[0], list(args[1])
            lead = len(sizes) - x.ndim
            full = [s if s != -1 else x.shape[i - lead]
                    for i, s in enumerate(sizes)]
            return np.broadcast_to(x, tuple(full))
        if name in ("view", "_unsafe_view", "reshape"):
            return np.reshape(args[0], tuple(args[1]))
        if name == "permute":
            return np.transpose(args[0], tuple(_dim(d, args[0].ndim)
                                               for d in args[1]))
        if name == "transpose":
            x = args[0]
            return np.swapaxes(x, _dim(args[1], x.ndim), _dim(args[2], x.ndim))
        if name == "t":
            return args[0].T
        if name in ("clone", "alias", "detach"):
            return args[0]
        if name == "_to_copy":
            dt = kwargs.get("dtype", None)
            if dt not in (None, torch.float32, torch.bool):
                _refuse(self.fname, nm, f"a cast to {dt}")
            conv = self.b.as_bool if dt == torch.bool else self.b.as_float
            x = args[0]
            return _map(x.shape, lambda i: conv(x[i], nm))
        if name == "unbind":
            x, d = args[0], _dim(args[1] if len(args) > 1 else 0, args[0].ndim)
            return tuple(_take(x, d, i) for i in range(x.shape[d]))
        if name in ("split", "split_with_sizes"):
            x = args[0]
            d = _dim(args[2] if len(args) > 2 else kwargs.get("dim", 0),
                     x.ndim)
            if name == "split":
                n = args[1]
                sizes = [min(n, x.shape[d] - s)
                         for s in range(0, x.shape[d], n)]
            else:
                sizes = list(args[1])
            cuts = np.cumsum(sizes)[:-1]
            return tuple(np.split(x, cuts, axis=d))
        if name in ("select_backward", "slice_backward"):
            g, sizes = args[0], tuple(args[1])
            base = _const_array(sizes, 0.0)
            if name == "select_backward":
                return self.scatter(base, g, args[2], args[3], None, None)
            return self.scatter(base, g, args[2], args[3], args[4], args[5])
        if name == "select_scatter":
            return self.scatter(args[0], args[1], args[2], args[3], None,
                                None)
        if name == "slice_scatter":
            x, src = args[0], args[1]
            d = args[2] if len(args) > 2 else 0
            start = args[3] if len(args) > 3 else None
            end = args[4] if len(args) > 4 else None
            step = args[5] if len(args) > 5 else 1
            return self.scatter(x, src, d, start, end, step)
        if name in ("as_strided", "as_strided_scatter"):
            return self.strided(name, args, kwargs, node)
        if name == "copy":
            # (the functionalized form of ``x.copy_(src)``)
            conv = self.b.as_bool if kind == "b" else self.b.as_float
            src = np.broadcast_to(self.operand(args[1]), shape)
            return _map(shape, lambda i: conv(src[i], nm))
        if name == "new_empty_strided":
            # uninitialized: the functionalized graph copies into it first
            return _const_array(tuple(args[1]), 0.0)
        if name == "stack":
            xs, d = args[0], args[1] if len(args) > 1 else 0
            return np.stack(xs, axis=_dim(d, xs[0].ndim + 1))
        if name == "cat":
            xs = [x for x in args[0] if not (x.ndim == 1 and x.shape[0] == 0)]
            d = args[1] if len(args) > 1 else 0
            return np.concatenate(xs, axis=_dim(d, xs[0].ndim))
        if name in ("sum", "mean", "prod", "amax", "amin",
                    "linalg_vector_norm"):
            return self.reduce(name, ov, args, kwargs, nm)
        if name in ("cumsum", "cumprod"):
            return self.scan(name, args, kwargs, nm)
        if name == "roll":
            x, shifts = args[0], args[1]
            dims = args[2] if len(args) > 2 else kwargs.get("dims", [])
            if not dims:  # over the flattened tensor
                return np.reshape(np.roll(np.reshape(x, -1), shifts),
                                  x.shape)
            return np.roll(x, tuple(shifts), tuple(_dim(d, x.ndim)
                                                   for d in dims))
        if name == "flip":
            x = args[0]
            return np.flip(x, tuple(_dim(d, x.ndim) for d in args[1]))
        if name in ("dot", "mv", "mm", "bmm", "addmv", "addmm"):
            return self.matmul(name, args, kwargs, nm)
        if name in ("scalar_tensor", "full", "full_like", "zeros",
                    "zeros_like", "ones", "ones_like", "new_zeros",
                    "new_ones", "new_full"):
            if shape is None:
                _refuse(self.fname, nm, f"aten.{name} without a shape")
            value = {"scalar_tensor": lambda: args[0],
                     "full": lambda: args[1], "full_like": lambda: args[1],
                     "new_full": lambda: args[2]}.get(name, lambda: (
                         1.0 if "ones" in name else 0.0))()
            return _const_array(shape, value, kind)
        _refuse(self.fname, nm, f"aten.{name}.{ov} is not lowerable")

    def strided(self, name, args, kwargs, node):
        """as_strided (a view of the base's memory) and as_strided_scatter
        (src written into it), over a base laid out contiguously from its
        first element, as the functionalized writes through a view leave
        it; else refused."""
        nm = node.name
        x = args[0]
        rest = list(args[1 if name == "as_strided" else 2:])
        size, stride = tuple(rest[0]), tuple(rest[1])
        offset = rest[2] if len(rest) > 2 else kwargs.get("storage_offset")
        offset = offset or 0
        base = node.args[0].meta.get("val")
        if not (isinstance(base, torch.Tensor) and base.is_contiguous()
                and base.storage_offset() == 0):
            _refuse(self.fname, nm, f"aten.{name} over a base that is not "
                    f"contiguous from its first element")
        flat = np.reshape(x, -1)
        at = _map(size, lambda i: offset + sum(
            k * st for k, st in zip(i, stride)))
        if any(j >= flat.shape[0] for j in at.flat):
            _refuse(self.fname, nm, f"aten.{name} past its base")
        if name == "as_strided":
            return _map(size, lambda i: flat[at[i]])
        out = np.array(flat, dtype=object, copy=True)
        src = np.broadcast_to(self.operand(args[1]), size)
        for i in np.ndindex(*size):
            out[at[i]] = src[i]
        return np.reshape(out, x.shape)

    def scatter(self, base, src, d, start, end, step):
        out = np.array(base, dtype=object, copy=True)
        d = _dim(d, out.ndim)
        sl = [slice(None)] * out.ndim
        if end is None and step is None:  # one index: src has one axis less
            i = start + out.shape[d] if start < 0 else start
            for idx in np.ndindex(*src.shape):
                out[idx[:d] + (i,) + idx[d:]] = src[idx]
            return out
        sl[d] = slice(start, end, step)
        view = out[tuple(sl)]
        for idx in np.ndindex(*view.shape):
            view[idx] = src[idx]
        return out

    def chain(self, op, terms, nm):
        """``op`` over ``terms`` in index order (a sum, product, maximum or
        minimum)."""
        acc = terms[0]
        for v in terms[1:]:
            acc = self.b.emit(op, (acc, v), nm)
        return acc

    def reduce(self, name, ov, args, kwargs, nm):
        """sum, mean (the sum divided by the count), prod, amax, amin and
        the 2-norm (the root of the sum of squares) over static axes, each
        in index order."""
        x = args[0]
        if kwargs.get("dtype") not in (None, torch.float32):
            _refuse(self.fname, nm, f"a {name} in another dtype")
        if name == "linalg_vector_norm":
            order = args[1] if len(args) > 1 else kwargs.get("ord", 2)
            if order != 2:
                _refuse(self.fname, nm, f"aten.linalg_vector_norm of ord "
                        f"{order} (only the 2-norm is lowered)")
            dims = args[2] if len(args) > 2 else kwargs.get("dim")
            keep = args[3] if len(args) > 3 else kwargs.get("keepdim", False)
        elif name == "prod" and ov == "default":
            dims, keep = None, False
        else:
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            dims = list(range(x.ndim))
        dims = sorted({_dim(d, x.ndim) for d in (
            dims if isinstance(dims, (list, tuple)) else [dims])})
        rest = [i for i in range(x.ndim) if i not in dims]
        xt = np.transpose(x, rest + dims)
        red = int(np.prod([x.shape[d] for d in dims]))
        xt = np.reshape(xt, tuple(x.shape[i] for i in rest) + (red,))
        b = self.b
        if (red > EXACT_TERMS and name in ("sum", "mean", "prod")) or (
                name == "linalg_vector_norm" and red > 1):
            # (the 2-norm's plain versions fuse or widen its squares' sum)
            b.note_inexact(f"{nm}: aten.{name} of {red} terms")
        op = {"sum": "add", "mean": "add", "prod": "mul", "amax": "max2",
              "amin": "min2", "linalg_vector_norm": "add"}[name]

        def one(idx):
            terms = [b.as_float(v, nm) for v in xt[idx]]
            if not terms:
                if name in ("amax", "amin"):
                    _refuse(self.fname, nm, f"aten.{name} of no terms")
                return Const(1.0 if name == "prod" else 0.0)
            if name == "linalg_vector_norm":
                terms = [b.emit("mul", (v, v), nm) for v in terms]
            acc = self.chain(op, terms, nm)
            if name == "mean":
                return self.divs(acc, red, nm)
            if name == "linalg_vector_norm":
                return b.emit("sqrt", (acc,), nm)
            return acc
        out = _map(xt.shape[:-1], one)
        if keep:
            for d in dims:
                out = np.expand_dims(out, d)
        return out

    def divs(self, x, c, nm):
        """x / c for a Python number c, as aten.div by a scalar lowers it:
        the division on the CPU, the product with its float32 reciprocal
        on the card (recorded in ``card_rounding``)."""
        b = self.b
        note = (f"{nm}: x / {c!r} runs as x * "
                f"{_f32(np.float32(1) / np.float32(_f32(c)))!r} (the card's "
                f"product by the reciprocal)")
        c = _f32(c)
        if note not in b.card_rounding:
            b.card_rounding.append(note)
        return b.emit("divs", (b.as_float(x, nm), Const(c)), nm)

    def scan(self, name, args, kwargs, nm):
        x = args[0]
        d = _dim(args[1] if len(args) > 1 else kwargs["dim"], x.ndim)
        if kwargs.get("dtype") not in (None, torch.float32):
            _refuse(self.fname, nm, f"a {name} in another dtype")
        if x.shape[d] > 2:  # the CPU's scan accumulates in double
            self.b.note_inexact(f"{nm}: aten.{name} of {x.shape[d]} terms")
        op = "add" if name == "cumsum" else "mul"
        b = self.b
        out = np.empty(x.shape, dtype=object)
        for idx in np.ndindex(*(x.shape[:d] + x.shape[d + 1:])):
            acc = None
            for k in range(x.shape[d]):
                at = idx[:d] + (k,) + idx[d:]
                v = b.as_float(x[at], nm)
                acc = v if acc is None else b.emit(op, (acc, v), nm)
                out[at] = acc
        return out

    def matmul(self, name, args, kwargs, nm):
        """dot, mv, mm, bmm and the addmv / addmm with beta and alpha 1 as
        sums of products in index order, the bias added last."""
        if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
            _refuse(self.fname, nm, f"aten.{name} with beta or alpha != 1")
        bias = None
        if name in ("addmv", "addmm"):
            bias, args = args[0], args[1:]
        a, c = args[0], args[1]
        if name in ("dot", "mv", "addmv"):  # a vector operand as a column
            c = c[:, None]
            a = a[None, :] if name == "dot" else a
        if name != "bmm":
            a, c = a[None], c[None]
        b = self.b
        K = a.shape[-1]
        self.b.note_inexact(f"{nm}: aten.{name}, {K} terms a sum (BLAS and "
                            f"cuBLAS fix no order)")

        def one(idx):
            i, r, k = idx
            terms = [b.emit("mul", (b.as_float(a[i, r, m], nm),
                                    b.as_float(c[i, m, k], nm)), nm)
                     for m in range(K)]
            return self.chain("add", terms, nm) if terms else Const(0.0)
        out = _map((a.shape[0], a.shape[1], c.shape[2]), one)
        if name != "bmm":
            out = out[0]
        if name == "dot":
            out = out[0, 0]
            out = _arr(out)
        elif name in ("mv", "addmv"):
            out = out[:, 0]
        if bias is not None:
            out = self.elementwise("add", (bias, out), nm)
        return out

    def run(self, gm, inputs: Sequence[np.ndarray]):
        env = {}
        ph = iter(inputs)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(ph)
            elif node.op == "get_attr":
                tensor = getattr(gm, node.target)
                if self.cst_tensor is not None and _same_tensor(
                        tensor, self.cst_tensor):
                    env[node] = self.cst_arr
                    continue
                _refuse(self.fname, node.name,
                        f"a tensor the field captures (shape "
                        f"{tuple(tensor.shape)}, {tensor.dtype}); pass "
                        f"numbers, or constants through the field's "
                        f"rhs_consts(device, dtype) (JAX's Pallas solve "
                        f"refuses a captured array too)")
            elif node.op == "call_function":
                if node.target is operator.getitem:
                    env[node] = env[node.args[0]][node.args[1]]
                    continue
                if not isinstance(node.target, torch._ops.OpOverload):
                    _refuse(self.fname, node.name,
                            f"{node.target} is not an aten op")
                name = node.target.overloadpacket.__name__
                if name not in LOWERABLE:
                    _refuse(self.fname, node.name,
                            f"aten.{name} is not lowerable (the kernel "
                            f"lowers: {', '.join(sorted(LOWERABLE))})")
                val = node.meta.get("val")
                for v in tree_leaves(val):
                    if isinstance(v, torch.Tensor) and v.dtype not in (
                            torch.float32, torch.bool) and not (
                            name == "sum" and v.dtype == torch.int64
                            and self.kind_of(env[node.args[0]]) == "b"):
                        # (a count of bools, as amax's VJP divides by, is
                        # exact in float32)
                        _refuse(self.fname, node.name,
                                f"a {v.dtype} value (the kernel computes "
                                f"in float32)")
                out = self.lower_node(node, env)
                if isinstance(val, torch.Tensor):
                    if not isinstance(out, np.ndarray) or \
                            tuple(out.shape) != tuple(val.shape):
                        raise AssertionError(
                            f"lowering of {node.name}: shape "
                            f"{getattr(out, 'shape', None)} against "
                            f"{tuple(val.shape)}")
                env[node] = out
            elif node.op == "output":
                return torch.fx.node.map_arg(node.args[0], lambda n: env[n])
            else:
                _refuse(self.fname, node.name, f"a {node.op} node")
        raise AssertionError("graph without output")


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.shape == b.shape and a.dtype == b.dtype
                      and a.data_ptr() == b.data_ptr())


class _DataDependent(Exception):
    def __init__(self, node):
        super().__init__(node)
        self.node = node


class _Recorder(TorchDispatchMode):
    """Reruns the field op by op and names the graph node whose value it
    reads as a Python value (make_fx raises there without naming it)."""

    _READS = ("_local_scalar_dense", "is_nonzero", "item")

    def __init__(self):
        super().__init__()
        self.graph = torch.fx.Graph()
        self.made: Dict[int, str] = {}
        self.keep = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self._READS:
            raise _DataDependent(self.made.get(id(args[0]),
                                               f"{func.overloadpacket.__name__}"))
        out = func(*args, **(kwargs or {}))
        node = self.graph.create_node(
            "call_function", func,
            name=self.graph._target_to_str(func.overloadpacket.__name__))
        for o in tree_leaves(out):
            if isinstance(o, torch.Tensor):
                self.made[id(o)] = node.name
                self.keep.append(o)
        return out


def _trace(fn, fname, example):
    """make_fx of ``fn``, functionalized, on ``example``; ValueError naming
    the node whose value the field reads as a Python value (data-dependent
    control flow)."""
    from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack
    with temporarily_clear_interpreter_stack():
        try:
            return make_fx(torch.func.functionalize(
                fn, remove="mutations"))(*example)
        except RuntimeError as e:
            if "_local_scalar_dense" not in str(e) and \
                    "data-dependent" not in str(e):
                raise
        node = "?"
        try:
            with _Recorder():
                fn(*[x.clone() for x in example])
        except _DataDependent as d:
            node = d.node
    _refuse(fname, node, "control flow that depends on data (the field "
            "reads this tensor as a Python value; write branches with "
            "torch.where)")


def trace_field(f: Callable, dim: int, pdim: int) -> FieldProgram:
    """Trace ``f(u, p, t)`` on one row (``u`` (dim,), ``p`` (pdim,), ``t``
    0-d, float32 on the CPU) and its VJP, and lower both. ValueError, naming
    the node, for what the kernel cannot run (module docstring)."""
    fname = field_name(f)
    consts = getattr(f, "rhs_consts", None)
    cst = None
    if consts is not None:
        cst = consts(torch.device("cpu"), torch.float32)
        if cst.dim() != 1:
            raise ValueError(f"{fname!r}: rhs_consts must be 1-D, got shape "
                             f"{tuple(cst.shape)}")
    u = torch.zeros(dim)
    p = torch.ones(pdim)
    t = torch.zeros(())
    kb = torch.ones(dim)

    def vjp(u, p, t, kb):
        _, pull = torch.func.vjp(lambda u_, p_: f(u_, p_, t), u, p)
        return pull(kb)

    try:
        fwd = _trace(f, fname, (u, p, t))
        bwd = _trace(vjp, fname, (u, p, t, kb))
    except _RefusedError:
        raise
    except Exception as e:  # the field does not run on one row
        raise ValueError(
            f"the field {fname!r} does not trace on one row (u ({dim},), p "
            f"({pdim},), t 0-d) for the batched-solve kernel: "
            f"{type(e).__name__}: {e}") from e

    b = _ScalarSSA()
    u_ids = [b.new_input("u") for _ in range(dim)]
    p_ids = [b.new_input("p") for _ in range(pdim)]
    t_id = b.new_input("t")
    kb_ids = [b.new_input("kb") for _ in range(dim)]
    ncst = 0 if cst is None else cst.shape[0]
    cst_ids = [b.new_input("cst") for _ in range(ncst)]

    def ids(x, shape):
        a = np.empty(shape, dtype=object)
        for i, v in enumerate(x):
            a[i] = v
        return a

    t_arr = _arr(t_id)
    cst_arr = ids(cst_ids, (ncst,)) if cst is not None else None
    low = _Lowering(b, fname, cst_arr, cst)
    dy = low.run(fwd, [ids(u_ids, (dim,)), ids(p_ids, (pdim,)), t_arr])
    ubar, pbar = low.run(bwd, [ids(u_ids, (dim,)), ids(p_ids, (pdim,)),
                               t_arr, ids(kb_ids, (dim,))])
    for what, out, n in (("f", dy, dim), ("its VJP's u-part", ubar, dim),
                         ("its VJP's p-part", pbar, pdim)):
        if not isinstance(out, np.ndarray) or out.shape != (n,):
            raise ValueError(f"the field {fname!r}: {what} has shape "
                             f"{getattr(out, 'shape', None)} on one row, "
                             f"not ({n},)")
    outs = [[b.as_float(r, "output") for r in o] for o in (dy, ubar, pbar)]
    per_row = frozenset(i for i, d in b.deps.items()
                        if d <= frozenset({"p", "cst"}))
    prog = FieldProgram(
        name=fname, dim=dim, pdim=pdim, ncst=ncst, u_ids=u_ids, p_ids=p_ids,
        t_id=t_id, kb_ids=kb_ids, cst_ids=cst_ids, instrs=b.instrs,
        kinds=b.kinds, per_row=per_row, dy=outs[0], ubar=outs[1],
        pbar=outs[2], card_rounding=b.card_rounding, uses_t=False,
        inexact=b.inexact)
    prog.uses_t = any("t" in b.deps[r] for o in outs for r in o
                      if isinstance(r, int))
    return prog


# ---------------------------------------------------------------------------
# The program op by op on the CPU.

_TORCH_OPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "divs": torch.div, "neg": torch.neg, "recip": torch.reciprocal,
    "sin": torch.sin, "cos": torch.cos, "exp": torch.exp, "log": torch.log,
    "tanh": torch.tanh, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "abs": torch.abs, "sgn": torch.sgn, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
    "not": torch.logical_not, "and": torch.logical_and,
    "or": torch.logical_or, "where": torch.where,
    "tofloat": lambda a: a.to(torch.float32), "tobool": lambda a: a != 0,
    "tanhb": aten.tanh_backward,
    "sigmoid": torch.sigmoid, "sigmoidb": aten.sigmoid_backward,
    "softplus": aten.softplus, "softplusb": aten.softplus_backward,
    "erf": torch.erf, "gelu": aten.gelu,
    "gelut": lambda x: aten.gelu(x, approximate="tanh"),
    "gelub": aten.gelu_backward,
    "gelubt": lambda g, x: aten.gelu_backward(g, x, approximate="tanh"),
    "expm1": torch.expm1, "log1p": torch.log1p, "sinh": torch.sinh,
    "cosh": torch.cosh, "atan2": torch.atan2,
    "clampmin": torch.clamp_min, "clampmax": torch.clamp_max,
    "clamp": torch.clamp, "clamp3": torch.clamp, "max2": torch.maximum,
    "min2": torch.minimum,
}


def interpret(prog: FieldProgram, u, p, t, kb=None, cst=None):
    """Run ``prog`` on rows: ``u`` (R, dim), ``p`` (R, pdim), ``t`` a
    number, 0-d or (R,), ``kb`` (R, dim) for the VJP, ``cst`` (ncst,).
    Each scalar operation is the torch op it lowers, over the R rows at
    once (a Python number where the graph had one). Returns ``dy`` (R,
    dim), or ``(ubar, pbar)`` when ``kb`` is given."""
    R = u.shape[0]
    env: Dict[int, torch.Tensor] = {}
    for i, r in enumerate(prog.u_ids):
        env[r] = u[:, i].contiguous()
    for i, r in enumerate(prog.p_ids):
        env[r] = p[:, i].contiguous()
    env[prog.t_id] = torch.as_tensor(t, dtype=torch.float32).expand(R) \
        .contiguous()
    if kb is not None:
        for i, r in enumerate(prog.kb_ids):
            env[r] = kb[:, i].contiguous()
    for i, r in enumerate(prog.cst_ids):
        env[r] = cst[i].expand(R).contiguous()
    outs = [prog.dy] if kb is None else [prog.ubar, prog.pbar]

    def val(a, number=False):
        if isinstance(a, int):
            return env[a]
        if isinstance(a, float):
            return a
        v = bool(a.value) if a.kind == "b" else a.value
        return v if number else torch.tensor(
            v, dtype=torch.bool if a.kind == "b" else torch.float32)

    for ins in prog.needed([r for o in outs for r in o]):
        # a divisor or exponent stays a Python number, as in the graph
        args = [val(a, number=k == 1 and ins.op == "divs")
                for k, a in enumerate(ins.args)]
        env[ins.out] = (torch.pow(*args) if ins.op == "pow"
                        else _TORCH_OPS[ins.op](*args))

    def col(refs):
        return torch.stack([env[r].expand(R) if isinstance(r, int)
                            else torch.full((R,), r.value,
                                            dtype=torch.float32)
                            for r in refs], dim=-1)
    if kb is None:
        return col(prog.dy)
    return col(prog.ubar), col(prog.pbar)
