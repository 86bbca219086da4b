"""CUDA kernels for the batched fixed-grid solve of a neural vector field
and its gradient (replace the Pallas TPU kernels of
latentdiffeq/ops/node_pallas.py::pallas_solve_neural_field: forward
``_node_kernel``, backward ``_node_bwd_kernel``).

``solve_neural_field`` integrates ``dy/dt = mlp(y)`` for a `Chain` of
`Dense` layers. On CUDA tensors the forward is one launch of
``node_field_fwd_kernel`` and the gradient one launch of
``node_field_bwd_kernel`` (csrc/node_field.cu): a reverse sweep over the
saved trajectory that recomputes each interval's stages, pulls the cotangent
back by hand and accumulates the weight gradients per block; the per-block
slices are summed here. Neither route calls a library matrix product. On
CPU tensors the same two functions run their plain PyTorch versions,
``solve_neural_field_reference`` and
``solve_neural_field_backward_reference``. ``backward="autograd"`` (the
JAX package's ``backward="xla"``) instead recomputes the plain solve with
autograd. ``saveat`` gets no gradient. Nothing falls back: a field the
kernel does not take raises.

Shapes on the main path: u0s (64, 16), 50 save points in training; (45, 16),
100 points in validation; widths 16-200-200-16, relu; Tsit5 (6 stages),
substeps 1.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import torch
from torch.autograd.function import once_differentiable

from ..nn.layers import (Chain, Dense, identity, relu, sigmoid, softplus,
                         tanh)
from ..solve.fixed import fixed_grid_stats, solve_fixed_grid
from ..solve.rk import AbstractSolver, n_solution_stages, tableau_f32
from ._build import load_kernel

__all__ = ["solve_neural_field", "solve_neural_field_cuda",
           "solve_neural_field_backward_cuda",
           "solve_neural_field_reference",
           "solve_neural_field_backward_reference", "dense_stack",
           "kernel_plan", "ACT_CODES", "MAX_LAYERS", "THREADS"]

# Activation codes understood by the kernels (csrc/node_field.cu).
ACT_CODES = {identity: 0, relu: 1, tanh: 2, sigmoid: 3, softplus: 4}
MAX_LAYERS = 8      # kMaxLayers in csrc/node_field.cu
THREADS = 512       # threads per block, the kernels' launch bound
_ERRORS = {
    -1: f"the field has more than {MAX_LAYERS} layers",
    -2: "the field is too wide: one batch row's state does not fit in a "
        "block's shared memory",
    -3: "invalid argument",
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


# ---------------------------------------------------------------------------
# Plain PyTorch versions.

def solve_neural_field_reference(mlp, solver: AbstractSolver, u0s, saveat,
                                 *, substeps: int = 1):
    """The plain forward: the batched `solve_fixed_grid` with the field as
    the parameter. Returns ``(ys (B, T, dim), success (B,), stats)``."""
    field = dense_stack(mlp)

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


@torch.no_grad()
def solve_neural_field_backward_reference(mlp, solver: AbstractSolver,
                                          saveat, ys, g, *,
                                          substeps: int = 1):
    """The plain reverse sweep, step for step the recursion of the
    backward kernel, with the VJP written out by hand: ``lam = g[:, T-1]``;
    for i = T-2 .. 0 recompute interval i's stages from the saved
    ``ys[:, i]`` keeping every layer output, pull ``lam`` back through its
    RK steps, add ``g[:, i]``, and accumulate the weight gradients. For one
    step with u_s = y + dt sum_q a_sq k_q, k_s = F(u_s),
    y1 = y + dt sum_s b_s k_s: kbar_s = dt b_s lam, ybar = lam, and for
    s = S-1 .. 0: ubar_s = J_F(u_s)^T kbar_s (the MLP's backward, which
    also gives dW += h_in^T delta and db += sum_rows delta), ybar += ubar_s,
    kbar_q += dt a_sq ubar_s. Returns ``(du0 (B, dim), [dW_l], [db_l])``."""
    field = dense_stack(mlp)
    tab = solver.tableau
    S = n_solution_stages(tab)
    Ws = [W.detach() for W in field.Ws]
    bs = [b.detach() for b in field.bs]
    acts = field.acts
    L = len(Ws)
    dWs = [torch.zeros_like(W) for W in Ws]
    dbs = [torch.zeros_like(b) for b in bs]

    def stages(y, dt):
        """tape[s][l]: layer l's input at stage s; tape[s][L] = k_s."""
        tape = []
        for s in range(S):
            u = y
            for q, a in enumerate(tab.a[s]):
                if a != 0.0:
                    u = u + (dt * a) * tape[q][L]
            hs = [u]
            for W, b, act in zip(Ws, bs, acts):
                hs.append(act(hs[-1] @ W + b))
            tape.append(hs)
        return tape

    def advance(y, dt, tape):
        for b, hs in zip(tab.b, tape):
            if b != 0.0:
                y = y + (dt * b) * hs[L]
        return y

    ys, g, saveat = ys.detach(), g.detach(), saveat.detach()
    T = ys.shape[1]
    lam = g[:, T - 1]
    for i in range(T - 2, -1, -1):
        dt = (saveat[i + 1] - saveat[i]) / substeps
        starts = [ys[:, i]]
        for _ in range(substeps - 1):
            starts.append(advance(starts[-1], dt, stages(starts[-1], dt)))
        for y in reversed(starts):
            tape = stages(y, dt)
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
        lib.ldq_node_field_plan.argtypes = [ci, _INTS, ci, ci, ci, ci,
                                            _INTS, _INTS, _INTS]
        lib.ldq_node_field_plan.restype = ci
        lib.ldq_node_field_fwd.argtypes = (
            [ci, _INTS, _INTS, _PTRS, _PTRS, ci] + [vp] * 5
            + [ci] * 5 + [vp])
        lib.ldq_node_field_fwd.restype = ci
        lib.ldq_node_field_bwd.argtypes = (
            [ci, _INTS, _INTS, _PTRS, _PTRS, _PTRS, ci] + [vp] * 8
            + [ci] * 5 + [vp])
        lib.ldq_node_field_bwd.restype = ci
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
                rows_per_block: int = 0):
    """``(rows per block, big array in shared memory, shared-memory
    bytes)`` the kernel would launch with for a batch of ``batch`` rows;
    the big array is the weights (forward) or the weight-gradient
    accumulators (backward). Raises ValueError for a field it cannot
    take."""
    lib = _lib()
    rows, big, nbytes = (ctypes.c_int(rows_per_block), ctypes.c_int(0),
                         ctypes.c_int(0))
    _check(lib.ldq_node_field_plan(
        len(widths) - 1, _ints(widths), n_stages, THREADS, int(backward),
        batch, ctypes.byref(rows), ctypes.byref(big), ctypes.byref(nbytes)),
        "solve_neural_field")
    return rows.value, bool(big.value), nbytes.value


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


def solve_neural_field_cuda(mlp, solver: AbstractSolver, u0s, saveat, *,
                            substeps: int = 1, rows_per_block: int = 0):
    """Launch the forward kernel once (no autograd); returns ys (B, T,
    dim). ``rows_per_block`` 0 lets the kernel's host side choose."""
    field = dense_stack(mlp)
    dim = field.widths[0]
    u0s = _f32_cuda("u0s", u0s)
    saveat = _f32_cuda("saveat", saveat, u0s.device)
    if u0s.dim() != 2 or u0s.shape[1] != dim or saveat.dim() != 1:
        raise ValueError(f"solve_neural_field: expected u0s (B, {dim}) and "
                         f"saveat (T,); got {tuple(u0s.shape)}, "
                         f"{tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    Ws, bs = _prepare(field, u0s.device)
    B, T = u0s.shape[0], saveat.shape[0]
    n_stages, a, b, _ = tableau_f32(solver)
    ys = torch.empty(B, T, dim, device=u0s.device, dtype=torch.float32)
    lib = _lib()
    stream = torch.cuda.current_stream(u0s.device).cuda_stream
    with torch.cuda.device(u0s.device):
        err = lib.ldq_node_field_fwd(
            len(Ws), _ints(field.widths), _ints(field.codes), _ptrs(Ws),
            _ptrs(bs), n_stages, a.data_ptr(), b.data_ptr(),
            saveat.data_ptr(), u0s.data_ptr(), ys.data_ptr(), B, T, substeps,
            rows_per_block, THREADS, stream)
    _check(err, "solve_neural_field (forward)")
    solve_neural_field_cuda.launches += 1
    return ys


solve_neural_field_cuda.launches = 0


def solve_neural_field_backward_cuda(mlp, solver: AbstractSolver, saveat,
                                     ys, g, *, substeps: int = 1,
                                     rows_per_block: int = 0):
    """Launch the backward kernel once. ``ys``: the forward trajectory
    (B, T, dim); ``g``: its cotangent. Returns ``(du0, [dW_l], [db_l])``;
    the per-block weight-gradient slices are summed over blocks here."""
    field = dense_stack(mlp)
    dim = field.widths[0]
    ys = _f32_cuda("ys", ys)
    g = _f32_cuda("g", g, ys.device)
    saveat = _f32_cuda("saveat", saveat, ys.device)
    if (ys.dim() != 3 or ys.shape[2] != dim or g.shape != ys.shape
            or saveat.shape != (ys.shape[1],)):
        raise ValueError(f"solve_neural_field backward: expected ys and g "
                         f"(B, T, {dim}) and saveat (T,); got "
                         f"{tuple(ys.shape)}, {tuple(g.shape)}, "
                         f"{tuple(saveat.shape)}")
    if substeps < 1:
        raise ValueError("substeps must be >= 1")
    dev = ys.device
    Ws, bs = _prepare(field, dev)
    Wts = [W.t().contiguous() for W in Ws]
    B, T = ys.shape[0], ys.shape[1]
    n_stages, a, b, _ = tableau_f32(solver)
    lib = _lib()
    widths = _ints(field.widths)
    with torch.cuda.device(dev):
        rows, _, _ = kernel_plan(field.widths, n_stages, B, backward=True,
                                 rows_per_block=rows_per_block)
        n_blocks = -(-B // rows)
        total = lib.ldq_node_field_packed_size(len(Ws), widths)
        # zeroed on the launch stream; every block adds into its own slice
        dwb = torch.zeros(n_blocks, total, device=dev, dtype=torch.float32)
        du0 = torch.empty(B, dim, device=dev, dtype=torch.float32)
        ysub = (torch.empty(n_blocks, substeps, dim * rows, device=dev,
                            dtype=torch.float32) if substeps > 1 else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ldq_node_field_bwd(
            len(Ws), widths, _ints(field.codes), _ptrs(Ws), _ptrs(Wts),
            _ptrs(bs), n_stages, a.data_ptr(), b.data_ptr(),
            saveat.data_ptr(), ys.data_ptr(), g.data_ptr(), du0.data_ptr(),
            dwb.data_ptr(), None if ysub is None else ysub.data_ptr(), B, T,
            substeps, rows, THREADS, stream)
    _check(err, "solve_neural_field (backward)")
    solve_neural_field_backward_cuda.launches += 1
    # the packed layout [W_0, b_0, W_1, b_1, ...], each piece padded to a
    # multiple of 4 floats
    flat = dwb.sum(dim=0)
    dWs, dbs, off = [], [], 0
    for W, bias in zip(Ws, bs):
        dWs.append(flat[off:off + W.numel()].view_as(W))
        off += -(-W.numel() // 4) * 4
        dbs.append(flat[off:off + bias.numel()])
        off += -(-bias.numel() // 4) * 4
    if off != total:
        raise RuntimeError(f"solve_neural_field backward: the kernel's "
                           f"packed layout holds {total} floats, the "
                           f"wrapper's {off}")
    return du0, dWs, dbs


solve_neural_field_backward_cuda.launches = 0


# ---------------------------------------------------------------------------
# The differentiable entry point.

class _NodeSolveFn(torch.autograd.Function):
    """ys = solve(u0s; W_0, b_0, ...). The kernels for CUDA tensors, the
    plain versions for CPU tensors; gradients come back in input order."""

    @staticmethod
    def forward(ctx, field, solver, substeps, backward, u0s, saveat, *wb):
        live = field._replace(Ws=list(wb[0::2]), bs=list(wb[1::2]))
        if u0s.is_cuda:
            ys = solve_neural_field_cuda(live, solver, u0s, saveat,
                                         substeps=substeps)
        else:
            ys = solve_neural_field_reference(live, solver, u0s, saveat,
                                              substeps=substeps)[0]
        ctx.spec = (field, solver, substeps, backward)
        ctx.save_for_backward(ys, u0s, saveat, *wb)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        field, solver, substeps, backward = ctx.spec
        ys, u0s, saveat, *wb = ctx.saved_tensors
        live = field._replace(Ws=list(wb[0::2]), bs=list(wb[1::2]))
        if backward == "kernel":
            sweep = (solve_neural_field_backward_cuda if ys.is_cuda
                     else solve_neural_field_backward_reference)
            du0, dWs, dbs = sweep(live, solver, saveat, ys, g.contiguous(),
                                  substeps=substeps)
        else:
            # recompute the plain solve and differentiate it with autograd
            u0_ = u0s.detach().requires_grad_()
            Ws = [W.detach().requires_grad_() for W in live.Ws]
            bs = [b.detach().requires_grad_() for b in live.bs]
            with torch.enable_grad():
                ys_ = solve_neural_field_reference(
                    live._replace(Ws=Ws, bs=bs), solver, u0_,
                    saveat.detach(), substeps=substeps)[0]
            grads = torch.autograd.grad(ys_, [u0_] + Ws + bs, g)
            L = len(Ws)
            du0, dWs, dbs = grads[0], grads[1:1 + L], grads[1 + L:]
        dwb = [d for pair in zip(dWs, dbs) for d in pair]
        return (None, None, None, None, du0, None, *dwb)


def solve_neural_field(mlp, solver: AbstractSolver, u0s, saveat, *,
                       substeps: int = 1, backward: str = "kernel"):
    """Batched fixed-grid solve of ``dy/dt = mlp(y)``, differentiable in
    ``u0s`` and every weight of ``mlp`` (a `Chain` of `Dense`). ``u0s``
    (B, dim), ``saveat`` (T,). Returns ``(ys (B, T, dim), success (B,),
    stats)`` with per-trajectory analytic counters.

    ``backward``: "kernel" takes the gradient with the reverse sweep over
    the saved trajectory (the backward kernel on the card, its plain
    version on the CPU); "autograd" recomputes the plain solve and
    differentiates it with autograd."""
    if backward not in ("kernel", "autograd"):
        raise ValueError(f"backward must be 'kernel' or 'autograd': "
                         f"{backward!r}")
    field = dense_stack(mlp)
    wb = [t for pair in zip(field.Ws, field.bs) for t in pair]
    ys = _NodeSolveFn.apply(field, solver, substeps, backward, u0s, saveat,
                            *wb)
    success = torch.isfinite(ys).all(dim=2).all(dim=1)
    stats = fixed_grid_stats((u0s.shape[0],), saveat.shape[0] - 1, substeps,
                             tableau_f32(solver)[0], device=u0s.device)
    return ys, success, stats
