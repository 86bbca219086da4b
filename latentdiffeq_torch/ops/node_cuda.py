"""CUDA kernels for the batched fixed-grid solve of a neural vector field
and its gradient (replace the Pallas TPU kernels of
latentdiffeq/ops/node_pallas.py::pallas_solve_neural_field: forward
``_node_kernel``, backward ``_node_bwd_kernel``).

``solve_neural_field`` integrates ``dy/dt = mlp(y)`` for a `Chain` of
`Dense` layers. On CUDA tensors the forward is one launch of
``node_field_fwd_kernel`` (csrc/node_field.cu); when a gradient will be
taken it also writes a tape of every layer output of every stage of every
step. The gradient is one launch of ``node_field_bwd_kernel``, a reverse
sweep over that tape that runs only the input-gradient products and
streams out each layer's pre-activation cotangent (Delta), then one launch
of ``node_field_dw_kernel``, the weight gradients as a product of the tape
and Delta over all rows, steps and stages on the tensor cores (3xTF32),
its split sums added inside the kernel in a fixed order. Neither route
calls a library matrix product. Every function takes a leading replica
axis too (a population of fields: u0s (S, B, dim), each W (S, in, out)),
and each kernel launches once for all replicas, a replica computed as
its own launch would compute it (``solve_neural_field`` gets the axis
under ``torch.func.vmap``).
On CPU tensors the same functions run their plain PyTorch versions
(``solve_neural_field_taped_reference``,
``neural_field_sweep_reference``, ``neural_field_dw_reference``);
``solve_neural_field_backward_reference`` is the same recursion
recomputing each interval's stages from the saved trajectory, as the JAX
kernel does. ``backward="autograd"`` (the JAX package's
``backward="xla"``) instead recomputes the plain solve with autograd.
``saveat`` gets no gradient. Nothing falls back: a field the kernels do
not take raises.

Shapes on the main path: u0s (64, 16), 50 save points in training; (45, 16),
100 points in validation; widths 16-200-200-16, relu; Tsit5 (6 stages),
substeps 1. Tape (64, 49, 6, 432) and Delta (64, 49, 6, 416) floats.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..nn.layers import (Chain, Dense, identity, relu, sigmoid, softplus,
                         tanh)
from ..solve.fixed import fixed_grid_stats, solve_fixed_grid
from ..solve.rk import AbstractSolver, n_solution_stages, tableau_f32
from ._build import load_kernel
from .recurrent_cuda import _stacked

__all__ = ["solve_neural_field", "solve_neural_field_cuda",
           "neural_field_sweep_cuda", "neural_field_dw_cuda",
           "neural_field_dw_plan",
           "solve_neural_field_backward_cuda",
           "solve_neural_field_reference",
           "solve_neural_field_taped_reference",
           "neural_field_sweep_reference", "neural_field_dw_reference",
           "solve_neural_field_backward_reference", "dense_stack",
           "tape_layout", "kernel_plan", "ACT_CODES", "MAX_LAYERS"]

# Activation codes understood by the kernels (csrc/node_field.cu).
ACT_CODES = {identity: 0, relu: 1, tanh: 2, sigmoid: 3, softplus: 4}
MAX_LAYERS = 8      # kMaxLayers in csrc/node_field.cu
PLACES = ("registers", "shared", "global")   # where a pass keeps weights
_ERRORS = {
    -1: f"the field has more than {MAX_LAYERS} layers",
    -2: "the field is too wide: one batch row's state does not fit in a "
        "block's shared memory",
    -3: "invalid argument",
    -4: "the field is too wide for the weight-gradient kernel's tile table",
}


class _Field(NamedTuple):
    """A Chain-of-Dense field taken apart: W_l (in, out), b_l (out,), the
    activations and their kernel codes, the widths (L + 1)."""
    Ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    acts: tuple
    codes: tuple
    widths: tuple


def dense_stack(mlp) -> _Field:
    """Take a `Chain` (or a sequence) of `Dense` layers apart. Raises
    TypeError for any other layer, ValueError for an activation the kernels
    have no code for, a field deeper than `MAX_LAYERS`, or one whose output
    width differs from its input width."""
    if isinstance(mlp, _Field):
        return mlp
    layers = list(mlp.layers) if isinstance(mlp, Chain) else list(mlp)
    for lyr in layers:
        if not isinstance(lyr, Dense):
            raise TypeError(
                "solve_neural_field supports Chain-of-Dense fields (nn.mlp); "
                f"got layer {type(lyr).__name__}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"solve_neural_field takes a field of 1 to "
                         f"{MAX_LAYERS} Dense layers, got {len(layers)}")
    for lyr in layers:
        if lyr.activation not in ACT_CODES:
            raise ValueError(
                "solve_neural_field knows the activations identity, relu, "
                "tanh, sigmoid and softplus of latentdiffeq_torch.nn; got "
                f"{getattr(lyr.activation, '__name__', lyr.activation)!r}")
    widths = (layers[0].in_dim,) + tuple(lyr.out_dim for lyr in layers)
    for lyr, w in zip(layers, widths):
        if lyr.in_dim != w:
            raise ValueError("solve_neural_field: layer widths do not chain")
    if widths[0] != widths[-1]:
        raise ValueError(f"solve_neural_field: the field maps width "
                         f"{widths[0]} to {widths[-1]}; dy/dt must have "
                         f"y's width")
    return _Field([lyr.W for lyr in layers], [lyr.b for lyr in layers],
                  tuple(lyr.activation for lyr in layers),
                  tuple(ACT_CODES[lyr.activation] for lyr in layers), widths)


def _apply_field(field: _Field, Ws: Sequence[torch.Tensor],
                 bs: Sequence[torch.Tensor], u):
    h = u
    for W, b, act in zip(Ws, bs, field.acts):
        h = act(h @ W + b)
    return h


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def tape_layout(widths):
    """``(hp_off, tape_floats, dp_off, delta_floats)``: the records of
    csrc/node_field.cu. A tape record (one row, step and stage) holds the
    stage input h_0, every layer output h_1 .. h_L at ``hp_off[l]``; a
    Delta record the cotangent of layer l's pre-activation at
    ``dp_off[l]``; every piece padded to a multiple of 4 floats."""
    hp, off = [], 0
    for w in widths:
        hp.append(off)
        off += _pad4(w)
    dp, doff = [], 0
    for w in widths[1:]:
        dp.append(doff)
        doff += _pad4(w)
    return hp, off, dp, doff


def _replica(field: _Field, s: int) -> _Field:
    """Replica ``s`` of a field whose tensors carry a leading replica
    axis."""
    return field._replace(Ws=[W[s] for W in field.Ws],
                          bs=[b[s] for b in field.bs])


def _stack(outs):
    """The outputs of several replicas (tensors, or tuples, lists and dicts
    of them) stacked on a new leading axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    return type(first)(_stack(list(parts)) for parts in zip(*outs))


def _over_replicas(fn, field: _Field, *xs):
    """``fn(replica s of field, xs[0][s], xs[1][s], ...)`` for every
    replica s, the outputs stacked: the plain versions' replica axis."""
    return _stack([fn(_replica(field, s), *[x[s] for x in xs])
                   for s in range(xs[0].shape[0])])


# ---------------------------------------------------------------------------
# Plain PyTorch versions. Each takes a leading replica axis S too (u0s (S,
# B, dim), g (S, B, T, dim), tape and Delta (S, B, steps, stages, record),
# every W (S, in, out) and b (S, out)), replica by replica.

def solve_neural_field_reference(mlp, solver: AbstractSolver, u0s, saveat,
                                 *, substeps: int = 1):
    """The plain forward: the batched `solve_fixed_grid` with the field as
    the parameter. Returns ``(ys (B, T, dim), success (B,), stats)``."""
    field = dense_stack(mlp)
    if u0s.dim() == 3:
        return _over_replicas(lambda fd, u: solve_neural_field_reference(
            fd, solver, u, saveat, substeps=substeps), field, u0s)

    def f(u, p, t):
        return _apply_field(field, field.Ws, field.bs, u)

    return solve_fixed_grid(f, solver, u0s, None, saveat, substeps=substeps)


def _act_grad(act, h):
    """d act / d pre-activation from the activation's output ``h``, as the
    backward kernel takes it (relu: 0 at 0)."""
    if act is relu:
        return (h > 0).to(h.dtype)
    if act is tanh:
        return 1 - h * h
    if act is sigmoid:
        return h * (1 - h)
    if act is softplus:
        return -torch.expm1(-h)
    return torch.ones_like(h)


def _stages(field: _Field, tab, S: int, y, dt):
    """One RK step's stages from y: tape[s][l] is layer l's input at stage
    s and tape[s][L] = k_s, in the arithmetic of `rk_step`."""
    L = len(field.Ws)
    tape = []
    for s in range(S):
        u = y
        for q, a in enumerate(tab.a[s]):
            if a != 0.0:
                u = u + (dt * a) * tape[q][L]
        hs = [u]
        for W, b, act in zip(field.Ws, field.bs, field.acts):
            hs.append(act(hs[-1] @ W + b))
        tape.append(hs)
    return tape


def _advance(tab, y, dt, tape):
    for b, hs in zip(tab.b, tape):
        if b != 0.0:
            y = y + (dt * b) * hs[-1]
    return y


def _detached(field: _Field) -> _Field:
    return field._replace(Ws=[W.detach() for W in field.Ws],
                          bs=[b.detach() for b in field.bs])


@torch.no_grad()
def solve_neural_field_taped_reference(mlp, solver: AbstractSolver, u0s,
                                       saveat, *, substeps: int = 1):
    """The plain forward that also keeps the tape, as the forward kernel
    writes it when a gradient will be taken. Returns ``(ys (B, T, dim),
    tape (B, (T-1) * substeps, stages, tape record))``; ys equal the plain
    solve's."""
    field = _detached(dense_stack(mlp))
    if u0s.dim() == 3:
        return _over_replicas(lambda fd, u: solve_neural_field_taped_reference(
            fd, solver, u, saveat, substeps=substeps), field, u0s)
    tab = solver.tableau
    S = n_solution_stages(tab)
    hp, rec, _, _ = tape_layout(field.widths)
    u0s, saveat = u0s.detach(), saveat.detach()
    B, T = u0s.shape[0], saveat.shape[0]
    tape = u0s.new_zeros(B, (T - 1) * substeps, S, rec)
    y, ys, step = u0s, [u0s], 0
    for i in range(T - 1):
        dt = (saveat[i + 1] - saveat[i]) / substeps
        for _ in range(substeps):
            stages = _stages(field, tab, S, y, dt)
            for s, hs in enumerate(stages):
                for off, h in zip(hp, hs):
                    tape[:, step, s, off:off + h.shape[-1]] = h
            y = _advance(tab, y, dt, stages)
            step += 1
        ys.append(y)
    return torch.stack(ys, dim=1), tape


@torch.no_grad()
def neural_field_sweep_reference(mlp, solver: AbstractSolver, saveat, tape,
                                 g, *, substeps: int = 1):
    """The plain reverse sweep over the tape, step for step the recursion
    of the sweep kernel: ``lam = g[:, T-1]``; for each step from the last,
    with u_s = y + dt sum_q a_sq k_q, k_s = F(u_s), y1 = y + dt sum_s b_s
    k_s: kbar_s = dt b_s lam, ybar = lam, and for s = S-1 .. 0: Delta_{L-1}
    = kbar_s act'(h_L), Delta_{l-1} = (Delta_l W_l^T) act'(h_l), ubar_s =
    Delta_0 W_0^T, ybar += ubar_s, kbar_q += dt a_sq ubar_s; lam = ybar,
    plus g[:, i] at the start of interval i. The activation derivatives
    come from the tape. Returns ``(du0 (B, dim), delta (B, steps, stages,
    Delta record))``."""
    field = _detached(dense_stack(mlp))
    if g.dim() == 4:
        return _over_replicas(lambda fd, tp, gg: neural_field_sweep_reference(
            fd, solver, saveat, tp, gg, substeps=substeps), field, tape, g)
    tab = solver.tableau
    S = n_solution_stages(tab)
    L, w = len(field.Ws), field.widths
    hp, _, dp, drec = tape_layout(w)
    g, saveat = g.detach(), saveat.detach()
    B, T = g.shape[0], g.shape[1]
    nsteps = (T - 1) * substeps
    delta = g.new_zeros(B, nsteps, S, drec)
    lam = g[:, T - 1]
    for step in range(nsteps - 1, -1, -1):
        i = step // substeps
        dt = (saveat[i + 1] - saveat[i]) / substeps

        def h(s, l):
            return tape[:, step, s, hp[l]:hp[l] + w[l]]

        ybar = lam
        kbar = [(dt * b) * lam if b != 0.0 else torch.zeros_like(lam)
                for b in tab.b[:S]]
        for s in range(S - 1, -1, -1):
            d = kbar[s] * _act_grad(field.acts[L - 1], h(s, L))
            for l in range(L - 1, -1, -1):
                delta[:, step, s, dp[l]:dp[l] + w[l + 1]] = d
                d = d @ field.Ws[l].t()
                if l > 0:
                    d = d * _act_grad(field.acts[l - 1], h(s, l))
            ybar = ybar + d
            for q, a in enumerate(tab.a[s]):
                if a != 0.0:
                    kbar[q] = kbar[q] + (dt * a) * d
        lam = ybar
        if step % substeps == 0:
            lam = lam + g[:, i]
    return lam, delta


@torch.no_grad()
def neural_field_dw_reference(mlp, tape, delta):
    """The plain weight gradients from the tape and Delta: dW_l = H_l^T
    Delta_l and db_l = sum Delta_l over every row, step and stage, H_l
    being layer l's input. Returns ``([dW_l], [db_l])``."""
    field = dense_stack(mlp)
    if tape.dim() == 5:
        return _over_replicas(neural_field_dw_reference, field, tape, delta)
    w = field.widths
    hp, rec, dp, drec = tape_layout(w)
    H, D = tape.reshape(-1, rec), delta.reshape(-1, drec)
    dWs, dbs = [], []
    for l in range(len(field.Ws)):
        Dl = D[:, dp[l]:dp[l] + w[l + 1]]
        dWs.append(H[:, hp[l]:hp[l] + w[l]].t() @ Dl)
        dbs.append(Dl.sum(dim=0))
    return dWs, dbs


@torch.no_grad()
def solve_neural_field_backward_reference(mlp, solver: AbstractSolver,
                                          saveat, ys, g, *,
                                          substeps: int = 1):
    """The plain reverse sweep that keeps no tape: for i = T-2 .. 0 it
    recomputes interval i's stages from the saved ``ys[:, i]`` keeping
    every layer output (as the JAX kernel does), pulls ``lam`` back through
    its RK steps with the recursion of `neural_field_sweep_reference`, adds
    ``g[:, i]``, and accumulates dW += h_in^T delta and db += sum_rows
    delta. Returns ``(du0 (B, dim), [dW_l], [db_l])``."""
    field = _detached(dense_stack(mlp))
    tab = solver.tableau
    S = n_solution_stages(tab)
    Ws, acts = field.Ws, field.acts
    L = len(Ws)
    dWs = [torch.zeros_like(W) for W in Ws]
    dbs = [torch.zeros_like(b) for b in field.bs]
    ys, g, saveat = ys.detach(), g.detach(), saveat.detach()
    T = ys.shape[1]
    lam = g[:, T - 1]
    for i in range(T - 2, -1, -1):
        dt = (saveat[i + 1] - saveat[i]) / substeps
        starts = [ys[:, i]]
        for _ in range(substeps - 1):
            starts.append(_advance(tab, starts[-1], dt,
                                   _stages(field, tab, S, starts[-1], dt)))
        for y in reversed(starts):
            tape = _stages(field, tab, S, y, dt)
            ybar = lam
            kbar = [(dt * b) * lam if b != 0.0 else torch.zeros_like(lam)
                    for b in tab.b[:S]]
            for s in range(S - 1, -1, -1):
                hs = tape[s]
                delta = kbar[s] * _act_grad(acts[L - 1], hs[L])
                for l in range(L - 1, -1, -1):
                    dWs[l] += hs[l].t() @ delta
                    dbs[l] += delta.sum(dim=0)
                    delta = delta @ Ws[l].t()
                    if l > 0:
                        delta = delta * _act_grad(acts[l - 1], hs[l])
                ybar = ybar + delta
                for q, a in enumerate(tab.a[s]):
                    if a != 0.0:
                        kbar[q] = kbar[q] + (dt * a) * delta
            lam = ybar
        lam = lam + g[:, i]
    return lam, dWs, dbs


# ---------------------------------------------------------------------------
# The kernels.

_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INTS = ctypes.POINTER(ctypes.c_int)


def _lib():
    lib = load_kernel("node_field")
    if not getattr(lib, "_ldq_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.ldq_node_field_max_layers.argtypes = []
        lib.ldq_node_field_max_layers.restype = ci
        lib.ldq_node_field_packed_size.argtypes = [ci, _INTS]
        lib.ldq_node_field_packed_size.restype = ci
        lib.ldq_node_field_records.argtypes = [ci, _INTS, _INTS, _INTS]
        lib.ldq_node_field_records.restype = ci
        lib.ldq_node_field_plan.argtypes = ([ci, _INTS, ci, ci, ci, ci]
                                            + [_INTS] * 5)
        lib.ldq_node_field_plan.restype = ci
        lib.ldq_node_field_fwd.argtypes = (
            [ci, _INTS, _INTS, _PTRS, _PTRS, ci] + [vp] * 6 + [ci] * 5
            + [vp])
        lib.ldq_node_field_fwd.restype = ci
        lib.ldq_node_field_bwd.argtypes = (
            [ci, _INTS, _INTS, _PTRS, ci] + [vp] * 7 + [ci] * 5 + [vp])
        lib.ldq_node_field_bwd.restype = ci
        lib.ldq_node_field_dw_plan.argtypes = [ci, _INTS, ci] + [_INTS] * 4
        lib.ldq_node_field_dw_plan.restype = ci
        lib.ldq_node_field_dw.argtypes = ([ci, _INTS] + [vp] * 5
                                          + [ci, ci, vp])
        lib.ldq_node_field_dw.restype = ci
        if lib.ldq_node_field_max_layers() != MAX_LAYERS:
            raise RuntimeError("csrc/node_field.cu and ops/node_cuda.py "
                               "disagree on the deepest field")
        lib._ldq_typed = True
    return lib


def _check(err: int, what: str):
    if err < 0:
        raise ValueError(f"{what}: {_ERRORS.get(err, f'error {err}')}")
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {err}")


def _ints(values):
    return (ctypes.c_int * len(values))(*values)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def kernel_plan(widths, n_stages: int, batch: int, *, backward: bool,
                rows_per_block: int = 0, replicas: int = 1):
    """``(rows per block, where the weights live, the register layer or
    -1, threads per block, shared-memory bytes)`` that the forward (or,
    with ``backward``, the sweep) would launch with for ``replicas``
    replicas of a batch of ``batch`` rows on the current CUDA device (the
    default rows a block counts all ``replicas * batch`` rows against the
    SMs); the weights live in "registers" (one layer, its rows past 160
    and the other layers in shared memory), "shared" memory or "global"
    memory, the first of these that fits. Raises ValueError for a field
    the kernels cannot take."""
    lib = _lib()
    outs = [ctypes.c_int(0) for _ in range(5)]
    outs[0].value = rows_per_block
    _check(lib.ldq_node_field_plan(
        len(widths) - 1, _ints(widths), n_stages, int(backward), batch,
        replicas, *[ctypes.byref(o) for o in outs]), "solve_neural_field")
    rows, place, reg, threads, nbytes = (o.value for o in outs)
    return rows, PLACES[place], reg, threads, nbytes


def _f32_cuda(name: str, t, device=None):
    """A contiguous, 16-byte aligned view or copy of a float32 CUDA tensor
    (the kernels load four floats at a time)."""
    if not t.is_cuda or t.dtype != torch.float32 or (
            device is not None and t.device != device):
        raise ValueError(f"solve_neural_field: {name} must be a float32 "
                         f"CUDA tensor on one device")
    t = t.detach().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(field: _Field, device):
    Ws = [_f32_cuda(f"W[{i}]", W, device) for i, W in enumerate(field.Ws)]
    bs = [_f32_cuda(f"b[{i}]", b, device) for i, b in enumerate(field.bs)]
    return Ws, bs


def _records(lib, widths):
    rec, drec = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib.ldq_node_field_records(len(widths) - 1, _ints(widths),
                                      ctypes.byref(rec), ctypes.byref(drec)),
           "solve_neural_field")
    if (rec.value, drec.value) != tape_layout(widths)[1::2]:
        raise RuntimeError("csrc/node_field.cu and ops/node_cuda.py "
                           "disagree on the tape layout")
    return rec.value, drec.value


def _replica_weights(field: _Field, lead: tuple):
    """Raises unless the field's tensors carry the replica axis ``lead``
    (S,) exactly when the data does."""
    want = (len(lead) + 2, len(lead) + 1)
    for W, b in zip(field.Ws, field.bs):
        if (W.dim(), b.dim()) != want or tuple(W.shape[:len(lead)]) != lead \
                or tuple(b.shape[:len(lead)]) != lead:
            raise ValueError(f"solve_neural_field: the weights must carry the "
                             f"data's replica axis {lead}; got W "
                             f"{tuple(W.shape)}, b {tuple(b.shape)}")


def _tape_shape(tape, shape: tuple, what: str):
    if tuple(tape.shape) != shape:
        raise ValueError(f"solve_neural_field backward: {what} must be "
                         f"{shape}, got {tuple(tape.shape)}")


def solve_neural_field_cuda(mlp, solver: AbstractSolver, u0s, saveat, *,
                            substeps: int = 1, rows_per_block: int = 0,
                            tape: bool = False):
    """Launch the forward kernel once (no autograd); returns ys (B, T,
    dim), or ``(ys, tape)`` with ``tape`` (the variant that writes every
    layer output of every stage: (B, (T-1) * substeps, stages, tape
    record)). ``rows_per_block`` 0 lets the kernel's host side choose (see
    `kernel_plan`). With a replica axis (u0s (S, B, dim), the field's
    tensors (S, ...)) the one launch takes every replica (grid z), each
    computed as its own launch at the same rows a block computes it."""
    field = dense_stack(mlp)
    dim = field.widths[0]
    u0s = _f32_cuda("u0s", u0s)
    saveat = _f32_cuda("saveat", saveat, u0s.device)
    if (u0s.dim() not in (2, 3) or u0s.shape[-1] != dim
            or saveat.dim() != 1):
        raise ValueError(f"solve_neural_field: expected u0s (B, {dim}) or "
                         f"(S, B, {dim}) and saveat (T,); got "
                         f"{tuple(u0s.shape)}, {tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    lead = tuple(u0s.shape[:-2])
    _replica_weights(field, lead)
    B, T = u0s.shape[-2], saveat.shape[0]
    S = lead[0] if lead else 1
    n_stages, a, b, _ = tableau_f32(solver)
    lib = _lib()
    dev = u0s.device
    ys = torch.empty(*lead, B, T, dim, device=dev, dtype=torch.float32)
    tp = None
    if tape:
        rec, _ = _records(lib, field.widths)
        tp = torch.empty(*lead, B, (T - 1) * substeps, n_stages, rec,
                         device=dev, dtype=torch.float32)
    Ws, bs = _prepare(field, dev)
    if S:   # an empty population launches nothing
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ldq_node_field_fwd(
                len(Ws), _ints(field.widths), _ints(field.codes), _ptrs(Ws),
                _ptrs(bs), n_stages, a.data_ptr(), b.data_ptr(),
                saveat.data_ptr(), u0s.data_ptr(), ys.data_ptr(),
                None if tp is None else tp.data_ptr(), B, S, T, substeps,
                rows_per_block, stream)
        _check(err, "solve_neural_field (forward)")
        solve_neural_field_cuda.launches += 1
    return (ys, tp) if tape else ys


solve_neural_field_cuda.launches = 0


def neural_field_sweep_cuda(mlp, solver: AbstractSolver, saveat, tape, g, *,
                            substeps: int = 1, rows_per_block: int = 0):
    """Launch the sweep kernel once over the forward's ``tape`` with the
    cotangent ``g`` (B, T, dim) of ys. Returns ``(du0 (B, dim), delta (B,
    steps, stages, Delta record))``. With a replica axis (g (S, B, T, dim),
    the tape and the field's tensors with a leading S) the one launch takes
    every replica, each computed as its own launch at the same rows a
    block computes it; the stacked weights are transposed in one copy."""
    field = dense_stack(mlp)
    dim = field.widths[0]
    g = _f32_cuda("g", g)
    dev = g.device
    tape = _f32_cuda("tape", tape, dev)
    saveat = _f32_cuda("saveat", saveat, dev)
    if (g.dim() not in (3, 4) or g.shape[-1] != dim
            or saveat.shape != (g.shape[-2],)):
        raise ValueError(f"solve_neural_field backward: expected g (B, T, "
                         f"{dim}) or (S, B, T, {dim}) and saveat (T,); got "
                         f"{tuple(g.shape)}, {tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    lead = tuple(g.shape[:-3])
    _replica_weights(field, lead)
    B, T = g.shape[-3], g.shape[-2]
    S = lead[0] if lead else 1
    n_stages, a, b, _ = tableau_f32(solver)
    lib = _lib()
    rec, drec = _records(lib, field.widths)
    nsteps = (T - 1) * substeps
    _tape_shape(tape, lead + (B, nsteps, n_stages, rec), "the tape")
    du0 = torch.empty(*lead, B, dim, device=dev, dtype=torch.float32)
    delta = torch.empty(*lead, B, nsteps, n_stages, drec, device=dev,
                        dtype=torch.float32)
    Wts = [W.transpose(-1, -2).contiguous()
           for W in _prepare(field, dev)[0]]
    if S:   # an empty population launches nothing
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            err = lib.ldq_node_field_bwd(
                len(Wts), _ints(field.widths), _ints(field.codes),
                _ptrs(Wts), n_stages, a.data_ptr(), b.data_ptr(),
                saveat.data_ptr(), tape.data_ptr(), g.data_ptr(),
                du0.data_ptr(), delta.data_ptr(), B, S, T, substeps,
                rows_per_block, stream)
        _check(err, "solve_neural_field (backward sweep)")
        neural_field_sweep_cuda.launches += 1
    return du0, delta


neural_field_sweep_cuda.launches = 0

# Integer semaphores of the weight-gradient kernel by (device, stream):
# zeroed once, left zero by every launch (csrc/node_field.cu,
# node_field_dw_kernel), so each call allocates nothing it must clear.
_DW_SEMS = {}


def _dw_semaphores(dev, stream: int, n: int):
    if torch.cuda.is_current_stream_capturing():
        # a CUDA graph's own: allocated in its pool and zeroed by each
        # replay, never cached (the pool may go before the cache would)
        return torch.zeros(max(n, 1024), device=dev, dtype=torch.int32)
    key = (dev, stream)
    sem = _DW_SEMS.get(key)
    if sem is None or sem.numel() < n:
        sem = torch.zeros(max(n, 1024), device=dev, dtype=torch.int32)
        _DW_SEMS[key] = sem
    return sem


def neural_field_dw_plan(widths, records: int):
    """``(blocks a replica, cluster size, workspace floats a replica,
    semaphores a replica)`` of the weight-gradient kernel for ``records``
    = B x steps x stages on the current CUDA device. Raises ValueError for
    a field it cannot take."""
    return _dw_plan(tuple(widths), records, torch.cuda.current_device())


@functools.lru_cache(maxsize=64)
def _dw_plan(widths: tuple, records: int, device: int):
    outs = [ctypes.c_int(0) for _ in range(4)]
    _check(_lib().ldq_node_field_dw_plan(
        len(widths) - 1, _ints(widths), records,
        *[ctypes.byref(o) for o in outs]),
        "solve_neural_field (weight gradients)")
    return tuple(o.value for o in outs)


def neural_field_dw_cuda(mlp, tape, delta):
    """Launch the weight-gradient kernel once: dW_l = H_l^T Delta_l, db_l =
    sum Delta_l over every row, step and stage of ``tape`` and ``delta``
    (as the forward and the sweep wrote them), the split sums added inside
    the kernel in a fixed order. With a replica axis (tape and delta (S, B,
    steps, stages, record)) one launch takes every replica, each as its own
    launch would. Returns ``([dW_l], [db_l])``, each (S, ...) with the
    replica axis."""
    field = dense_stack(mlp)
    dev = tape.device
    tape = _f32_cuda("tape", tape, dev)
    delta = _f32_cuda("delta", delta, dev)
    lib = _lib()
    rec, drec = _records(lib, field.widths)
    if tape.dim() not in (4, 5):
        raise ValueError(f"solve_neural_field backward: the tape must be "
                         f"(B, steps, stages, {rec}) or (S, B, steps, "
                         f"stages, {rec}), got {tuple(tape.shape)}")
    lead = tuple(tape.shape[:-4])
    B, nsteps, S = tape.shape[-4:-1]
    _tape_shape(tape, lead + (B, nsteps, S, rec), "the tape")
    _tape_shape(delta, lead + (B, nsteps, S, drec), "delta")
    widths = _ints(field.widths)
    L = len(field.Ws)
    total = lib.ldq_node_field_packed_size(L, widths)
    n_rep = lead[0] if lead else 1
    R = B * nsteps * S
    if R == 0 or n_rep == 0:   # a single save point: no step, no gradient
        flat = torch.zeros(n_rep, total, device=dev, dtype=torch.float32)
    else:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            _, _, ws_n, sem_n = neural_field_dw_plan(field.widths, R)
            flat = torch.empty(n_rep, total, device=dev, dtype=torch.float32)
            ws = (torch.empty(n_rep * ws_n, device=dev, dtype=torch.float32)
                  if ws_n else None)
            sem = _dw_semaphores(dev, stream, n_rep * sem_n) if sem_n else None
            err = lib.ldq_node_field_dw(
                L, widths, tape.data_ptr(), delta.data_ptr(),
                flat.data_ptr(), None if ws is None else ws.data_ptr(),
                None if sem is None else sem.data_ptr(), R, n_rep, stream)
        _check(err, "solve_neural_field (weight gradients)")
        neural_field_dw_cuda.launches += 1
    # the packed layout [W_0, b_0, W_1, b_1, ...], each piece padded to a
    # multiple of 4 floats
    dWs, dbs, off = [], [], 0
    for W, bias in zip(field.widths[:-1], field.widths[1:]):
        dW = flat[:, off:off + W * bias].view(n_rep, W, bias)
        off += _pad4(W * bias)
        db = flat[:, off:off + bias]
        off += _pad4(bias)
        dWs.append(dW if lead else dW[0])
        dbs.append(db if lead else db[0])
    if off != total:
        raise RuntimeError(f"solve_neural_field backward: the kernel's "
                           f"packed layout holds {total} floats, the "
                           f"wrapper's {off}")
    return dWs, dbs


neural_field_dw_cuda.launches = 0


def solve_neural_field_backward_cuda(mlp, solver: AbstractSolver, saveat,
                                     tape, g, *, substeps: int = 1,
                                     rows_per_block: int = 0):
    """The gradient on the card: the sweep kernel, then the
    weight-gradient kernel. ``tape``: from ``solve_neural_field_cuda(...,
    tape=True)``; ``g``: the cotangent of ys. Returns ``(du0, [dW_l],
    [db_l])``."""
    du0, delta = neural_field_sweep_cuda(mlp, solver, saveat, tape, g,
                                         substeps=substeps,
                                         rows_per_block=rows_per_block)
    dWs, dbs = neural_field_dw_cuda(mlp, tape, delta)
    return du0, dWs, dbs


# ---------------------------------------------------------------------------
# The differentiable entry point.

class _NodeSolveFn(torch.autograd.Function):
    """(ys, tape) = solve(u0s; W_0, b_0, ...), for one field (u0s (B,
    dim)) or S of them (u0s and every W, b with a leading replica axis).
    The kernels for CUDA tensors, the plain versions for CPU tensors;
    gradients come back in input order. With ``keep_tape`` (a gradient
    will be taken) and the kernel backward, the forward keeps the tape for
    the sweep; the tape is an output that takes no gradient. ``field``
    carries the widths and activations, not the tensors.

    Under ``torch.func.vmap`` over replicas (train/multiseed.py) the
    ``vmap`` rule moves every replica axis to the front and applies the
    function once to the whole population: the forward, the sweep and the
    weight-gradient kernel each launch once for all replicas. The tape is
    decided there, on the unbatched tensors (inside the transform the
    batched ones report no ``requires_grad``)."""

    @staticmethod
    def forward(field, solver, substeps, backward, keep_tape, u0s, saveat,
                *wb):
        live = field._replace(Ws=list(wb[0::2]), bs=list(wb[1::2]))
        taped = keep_tape and backward == "kernel"
        tape = None
        if u0s.is_cuda:
            out = solve_neural_field_cuda(live, solver, u0s, saveat,
                                          substeps=substeps, tape=taped)
            ys, tape = out if taped else (out, None)
        elif taped:
            ys, tape = solve_neural_field_taped_reference(
                live, solver, u0s, saveat, substeps=substeps)
        else:
            with torch.no_grad():
                ys = solve_neural_field_reference(
                    live, solver, u0s, saveat, substeps=substeps)[0]
        if tape is None:
            tape = u0s.new_zeros(u0s.shape[:-2] + (0,))
        return ys, tape

    @staticmethod
    def setup_context(ctx, inputs, output):
        field, solver, substeps, backward, _, u0s, saveat, *wb = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.set_materialize_grads(False)
        ctx.spec = (field, solver, substeps, backward)
        ctx.save_for_backward(u0s, saveat, output[1], *wb)

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _g_tape):
        field, solver, substeps, backward = ctx.spec
        u0s, saveat, tape, *wb = ctx.saved_tensors
        live = field._replace(Ws=list(wb[0::2]), bs=list(wb[1::2]))
        if g is None:
            return (None,) * (7 + len(wb))
        if backward == "kernel":
            if tape.shape[-1] == 0:
                raise RuntimeError("solve_neural_field: the forward ran "
                                   "without a gradient and kept no tape")
            if tape.is_cuda:
                du0, dWs, dbs = solve_neural_field_backward_cuda(
                    live, solver, saveat, tape, g.contiguous(),
                    substeps=substeps)
            else:
                du0, delta = neural_field_sweep_reference(
                    live, solver, saveat, tape, g, substeps=substeps)
                dWs, dbs = neural_field_dw_reference(live, tape, delta)
        elif u0s.dim() == 3:
            du0, dWs, dbs = _over_replicas(
                lambda fd, u, gg: _autograd_backward(fd, solver, u, saveat,
                                                     gg, substeps),
                live, u0s, g)
        else:
            du0, dWs, dbs = _autograd_backward(live, solver, u0s, saveat, g,
                                               substeps)
        dwb = [d for pair in zip(dWs, dbs) for d in pair]
        return (None, None, None, None, None, du0, None, *dwb)

    @staticmethod
    def vmap(info, in_dims, field, solver, substeps, backward, keep_tape,
             u0s, saveat, *wb):
        if in_dims[6] is not None:
            raise ValueError("solve_neural_field: replicas share one saveat "
                             "grid; got a grid per replica")
        S = info.batch_size
        u0s = _stacked(u0s, in_dims[5], S)
        if u0s.dim() != 3:
            raise ValueError("solve_neural_field: one replica axis is "
                             "supported")
        wb = [_stacked(t, d, S) for t, d in zip(wb, in_dims[7:])]
        keep = torch.is_grad_enabled() and any(
            t.requires_grad for t in [u0s] + wb)
        return (_NodeSolveFn.apply(field, solver, substeps, backward, keep,
                                   u0s, saveat, *wb), (0, 0))


def _autograd_backward(field: _Field, solver, u0s, saveat, g, substeps):
    """``backward="autograd"``: recompute the plain solve and differentiate
    it with autograd. Returns ``(du0, [dW_l], [db_l])``."""
    u0_ = u0s.detach().requires_grad_()
    Ws = [W.detach().requires_grad_() for W in field.Ws]
    bs = [b.detach().requires_grad_() for b in field.bs]
    with torch.enable_grad():
        ys_ = solve_neural_field_reference(
            field._replace(Ws=Ws, bs=bs), solver, u0_, saveat.detach(),
            substeps=substeps)[0]
    grads = torch.autograd.grad(ys_, [u0_] + Ws + bs, g)
    L = len(Ws)
    return grads[0], list(grads[1:1 + L]), list(grads[1 + L:])


def solve_neural_field(mlp, solver: AbstractSolver, u0s, saveat, *,
                       substeps: int = 1, backward: str = "kernel"):
    """Batched fixed-grid solve of ``dy/dt = mlp(y)``, differentiable in
    ``u0s`` and every weight of ``mlp`` (a `Chain` of `Dense`). ``u0s``
    (B, dim), ``saveat`` (T,). Returns ``(ys (B, T, dim), success (B,),
    stats)`` with per-trajectory analytic counters.

    ``backward``: "kernel" keeps the forward's tape and takes the gradient
    with the reverse sweep and the weight-gradient product over it (the
    kernels on the card, their plain versions on the CPU); "autograd"
    recomputes the plain solve and differentiates it with autograd.

    Under ``torch.func.vmap`` over the field's weights (a population of
    fields, train/multiseed.py) the forward, the sweep and the
    weight-gradient kernel each launch once for all replicas; the replicas
    share ``saveat``."""
    if backward not in ("kernel", "autograd"):
        raise ValueError(f"backward must be 'kernel' or 'autograd': "
                         f"{backward!r}")
    field = dense_stack(mlp)
    wb = [t for pair in zip(field.Ws, field.bs) for t in pair]
    keep_tape = torch.is_grad_enabled() and any(
        t.requires_grad for t in [u0s] + wb)
    ys, _ = _NodeSolveFn.apply(field._replace(Ws=None, bs=None), solver,
                               substeps, backward, keep_tape, u0s, saveat,
                               *wb)
    success = torch.isfinite(ys).all(dim=2).all(dim=1)
    stats = fixed_grid_stats((u0s.shape[0],), saveat.shape[0] - 1, substeps,
                             tableau_f32(solver)[0], device=u0s.device)
    return ys, success, stats
