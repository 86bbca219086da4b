"""CUDA kernels for the three GOKU encoder heads and their gradient
(replace the Pallas TPU kernel latentdiffeq/ops/recurrent_pallas.py::
pallas_goku_heads and the VJP its ``custom_vjp`` takes).

``goku_heads`` runs ``goku_heads_fwd_kernel`` (csrc/goku_heads.cu) on CUDA
tensors and the plain PyTorch version ``goku_heads_reference``, with
autograd, on CPU tensors. When a gradient will be taken the forward kernel
also writes a tape (per row, step, stack and layer: the RNN's h; the LSTM's
activated gates i, f, g, o, then c and h), and the gradient is one launch of
``goku_heads_bwd_kernel``, a reverse sweep over that tape that streams out
each cell's pre-activation cotangents (dgates) and leaves the carries of
the initial states, followed by the products of the tape and dgates that
give the weight and input gradients (``goku_heads_param_grads``: PyTorch
matrix products, as the JAX package leaves them to XLA). The plain
versions of the two kernels are ``goku_heads_taped_reference`` and
``goku_heads_sweep_reference``; ``goku_heads_backward_reference`` is the
whole plain backward.

The kernels are compiled for input width 32 and hidden width 16 (the GOKU
heads); narrower heads run in the same kernels with weights packed at those
widths (zero rows and columns), and the tape and dgates the kernels return
are laid out at hidden width 16 (``heads_layout``). Wider heads run at
their own widths in a second pair of kernels that reads the widths at run
time (``kernel_widths``). More than 4 layers, or heads too wide for a
block's shared memory, raise ValueError. Shapes on the main path: xs (64,
50, 32) in training, (45, 100, 32) in validation; H = 16; two layers per
stack; tape (B, T, 416), dgates (B, T, 288).

A population of S weight sets (train/multiseed.py, ``torch.func.vmap`` of
the model over stacked weights) runs as one launch of each kernel: every
tensor then has a leading replica axis, the packed weights are (S, n_w)
and the kernels run on a (B, S) grid. ``_GokuHeadsFn``'s ``vmap`` rule
takes that route, as JAX's vmap of a ``pallas_call`` adds a grid axis; the
products run batched over the replicas. On the population path of
chip_smoke.py phase 4g: S 8, xs (8, 64, 20, 32) in training, (8, 45, 100,
32) in validation.

The kernels run in float32 or bfloat16 (the heads of a bf16 GOKU,
``goku_default_layers(..., dtype=torch.bfloat16)``), as JAX's kernel runs
in xs's dtype: xs and the heads' weights must share that dtype. A bfloat16
instance keeps xs, the outputs, the tape, the cotangents and the dgates in
bfloat16, packs the weights in float32 (exact), computes in float32 and
rounds the forward's carried h and c to bfloat16 at every step (the
recurrence JAX's bf16 scan carries). The kernels' plain versions
(``goku_heads_taped_reference``, ``goku_heads_sweep_reference``) round at
the same places; the products of tape and dgates run in bfloat16, as JAX
leaves them to XLA. ``goku_heads_reference``, autograd's route on CPU
tensors, runs the cells in the parameters' dtype, rounding after every
operation as JAX's scan (and its Pallas kernel in interpret mode) does.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from ..nn.layers import identity, relu, tanh
from ..nn.recurrent import LSTMCell, Recurrent, RNNCell, fused_goku_heads
from ._build import load_kernel

__all__ = ["goku_heads", "goku_heads_cuda", "goku_heads_bwd_cuda",
           "goku_heads_backward_cuda", "goku_heads_reference",
           "goku_heads_taped_reference", "goku_heads_sweep_reference",
           "goku_heads_backward_reference", "goku_heads_param_grads",
           "pack_goku_heads", "check_goku_heads", "heads_layout",
           "kernel_widths", "KERNEL_D", "KERNEL_H", "MAX_LAYERS", "DTYPES"]

# RNN activation codes understood by the kernels.
_ACT_CODES = {identity: 0, relu: 1, tanh: 2}
# The storage types the kernels have instances for.
DTYPES = (torch.float32, torch.bfloat16)
# The widths csrc/goku_heads.cu is compiled for, and its deepest stack.
KERNEL_D, KERNEL_H, MAX_LAYERS = 32, 16, 4
# The most dynamic shared memory a block may take on the H100.
MAX_SMEM = 227 * 1024


def goku_heads_reference(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
                         pe_theta_bwd: Recurrent, xs):
    """The plain PyTorch version: `nn.fused_goku_heads`. ``calls`` counts
    its calls (the kernel path makes none, forward or backward)."""
    goku_heads_reference.calls += 1
    return fused_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs)


goku_heads_reference.calls = 0


def _heads_params(pe_z0, pe_theta_fwd, pe_theta_bwd):
    """The heads' tensors in the kernel's packing order: per stack, per
    layer, Wi, Wh, b, h0 (and c0 for LSTM cells), i.e. the order of
    ``parameters()``."""
    return [p for head in (pe_z0, pe_theta_fwd, pe_theta_bwd)
            for p in head.parameters()]


def check_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs):
    """Raise ValueError for heads or inputs the kernel does not take.
    Returns (H, L, activation code)."""
    if xs.dim() != 3:
        raise ValueError(f"goku_heads: xs must be (B, T, D), got "
                         f"{tuple(xs.shape)}")
    L = len(pe_z0.cells)
    H = pe_z0.cells[0].hidden_dim
    for head, kind in ((pe_z0, RNNCell), (pe_theta_fwd, LSTMCell),
                       (pe_theta_bwd, LSTMCell)):
        if len(head.cells) != L or not all(
                isinstance(c, kind) and c.hidden_dim == H
                for c in head.cells):
            raise ValueError(
                "goku_heads kernel takes an RNN stack and two LSTM stacks "
                "with the same number of layers and one hidden width")
    act = pe_z0.cells[0].activation
    if act not in _ACT_CODES or any(c.activation is not act
                                    for c in pe_z0.cells):
        raise ValueError("goku_heads kernel takes a relu, tanh or identity "
                         "RNN activation shared by all layers")
    if pe_z0.cells[0].Wi.shape[0] != xs.shape[-1]:
        raise ValueError("goku_heads: input width does not match the cells")
    return H, L, _ACT_CODES[act]


def heads_layout(H: int, L: int):
    """``(tape_off, tape_rec, dg_off, dg_rec)``: the records of
    csrc/goku_heads.cu at hidden width H. ``tape_off[s][l]`` is where stack
    s (0 z0 RNN, 1 forward LSTM, 2 backward LSTM), layer l starts in a
    row-step's tape record: H floats (h) for the RNN, 6H (i, f, g, o, c, h)
    for an LSTM; ``dg_off[s][l]`` the same in a dgates record: H or 4H
    pre-activation cotangents (gate order i, f, g, o)."""
    tape_off = [[l * H for l in range(L)]]
    dg_off = [[l * H for l in range(L)]]
    for s in (1, 2):
        tape_off.append([L * H + (s - 1) * 6 * H * L + l * 6 * H
                         for l in range(L)])
        dg_off.append([L * H + (s - 1) * 4 * H * L + l * 4 * H
                       for l in range(L)])
    return tape_off, 13 * H * L, dg_off, 9 * H * L


def kernel_widths(D: int, H: int):
    """``(D, H)`` at which the kernels run heads of input width D and
    hidden width H: the compiled ``(KERNEL_D, KERNEL_H)`` when the heads fit
    there (narrower ones zero-padded), else their own widths."""
    if D <= KERNEL_D and H <= KERNEL_H:
        return KERNEL_D, KERNEL_H
    return D, H


def pack_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, D: int = 0,
                    H: int = 0, params=None) -> torch.Tensor:
    """One contiguous buffer of every head weight, in the layout
    csrc/goku_heads.cu documents (the order of ``_heads_params``). With
    widths ``D`` and ``H`` larger than the heads', each tensor is laid out
    at those widths with zeros in the missing input rows and unit columns
    (of each gate). ``params``: the tensors to pack in place of the heads'
    own, in that order, each with the same leading replica dims (S, ...);
    the buffer is then (S, ..., n_w)."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    D0 = pe_z0.cells[0].Wi.shape[0]
    H0 = pe_z0.cells[0].hidden_dim
    return _pack(_heads_params(*heads) if params is None else params,
                 len(pe_z0.cells), D0, H0, D or D0, H or H0)


def _pack(params, L, D0, H0, D, H):
    """``pack_goku_heads`` from the tensors alone (heads of L layers, input
    width D0, hidden width H0, packed at D, H)."""
    params = list(params)
    lead = tuple(params[0].shape[:-2])       # Wi of the first cell is 2-D
    if (D, H) == (D0, H0):
        return torch.cat([p.detach().reshape(*lead, -1) for p in params],
                         dim=-1)
    pieces = []
    it = iter(params)
    for s in range(3):
        G = 1 if s == 0 else 4
        for l in range(L):
            din, dinp = (D0, D) if l == 0 else (H0, H)
            for rows, rows_p in ((din, dinp), (H0, H), (1, 1)):
                w = next(it).detach().reshape(*lead, rows, G, H0)
                z = w.new_zeros(*lead, rows_p, G, H)
                z[..., :rows, :, :H0] = w
                pieces.append(z.reshape(*lead, -1))
            for _ in ("h0", "c0") if s else ("h0",):
                w = next(it).detach()
                pieces.append(torch.cat([w, w.new_zeros(*lead, H - H0)],
                                        dim=-1))
    return torch.cat(pieces, dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions.

def _cells(heads):
    return [list(h.cells) for h in heads]


def _wide(w):
    """A tensor in the arithmetic type: float32 for bfloat16 (as the
    kernels compute), else its own (no copy)."""
    return w.detach().to(torch.promote_types(w.dtype, torch.float32))


@torch.no_grad()
def goku_heads_taped_reference(pe_z0, pe_theta_fwd, pe_theta_bwd, xs):
    """The plain forward that also keeps the tape, as the forward kernel
    writes it when a gradient will be taken (``heads_layout`` at the heads'
    own H). Returns ``(z0_out (B, H), theta_out (B, 2H), tape (B, T,
    13 H L))`` in the heads' dtype; in float32 the outputs equal
    ``goku_heads_reference``'s. In bfloat16 it computes as the kernel
    does: float32 arithmetic, h and c rounded to bfloat16 at every step,
    the gates where the tape stores them."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    H, L, _ = check_goku_heads(*heads, xs)
    toff, rec, _, _ = heads_layout(H, L)
    dtype = pe_z0.cells[0].Wi.dtype

    def carry(v):                          # the carried state as stored
        return _wide(v.to(dtype))

    xs = xs.detach().to(dtype)
    B, T = xs.shape[0], xs.shape[1]
    tape = xs.new_zeros(B, T, rec)
    cells = _cells(heads)
    hs = [[_wide(c.h0).expand(B, H) for c in cs] for cs in cells]
    cs_ = [[_wide(c.c0).expand(B, H) if s else None
            for c in cs] for s, cs in enumerate(cells)]
    for t in range(T):
        for s in range(3):
            inp = _wide(xs[:, t] if s == 1 else xs[:, T - 1 - t])
            for l, cell in enumerate(cells[s]):
                z = (inp @ _wide(cell.Wi) + hs[s][l] @ _wide(cell.Wh)
                     + _wide(cell.b))
                o = toff[s][l]
                if s == 0:
                    h = carry(cell.activation(z))
                    tape[:, t, o:o + H] = h
                else:
                    i, f, g, og = torch.chunk(z, 4, dim=-1)
                    gates = (torch.sigmoid(i), torch.sigmoid(f),
                             torch.tanh(g), torch.sigmoid(og))
                    c = carry(gates[1] * cs_[s][l] + gates[0] * gates[2])
                    h = carry(gates[3] * torch.tanh(c))
                    cs_[s][l] = c
                    for k, v in enumerate(gates + (c, h)):
                        tape[:, t, o + k * H:o + (k + 1) * H] = v
                hs[s][l] = h
                inp = h
    return (hs[0][-1].to(dtype),
            torch.cat([hs[1][-1], hs[2][-1]], dim=-1).to(dtype), tape)


def _act_grad(act, h):
    """d act / d pre-activation from the output ``h`` (relu: 0 at 0)."""
    if act is relu:
        return (h > 0).to(h.dtype)
    if act is tanh:
        return 1 - h * h
    return torch.ones_like(h)


@torch.no_grad()
def goku_heads_sweep_reference(pe_z0, pe_theta_fwd, pe_theta_bwd, tape,
                               g_z0, g_th):
    """The plain reverse sweep over the tape, step for step the recursion
    of the sweep kernel (csrc/goku_heads.cu), with the VJP written by hand.
    For t = T-1 .. 0 and each stack, from the top layer down, with dh =
    the carry from step t+1 (at t = T-1 the top layer's is the cotangent
    g_z0, g_th[:, :H] or g_th[:, H:]) plus, below the top, layer l+1's
    dgates Wi_{l+1}^T: LSTM dc = dc_carry + dh o (1 - tanh(c)^2), dgates =
    (dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh tanh(c) o(1-o)),
    dc_carry = dc f; RNN dgates = dh act'(h); dh_carry = dgates Wh^T.
    Returns ``(dgates (B, T, 9 H L), dh0 (B, 3, L, H), dc0 (B, 3, L, H))``,
    the carries left at t = -1 (dc0 of the RNN is 0), in the tape's dtype.
    A bfloat16 tape is read into float32, the carries stay float32 and
    dgates, dh0 and dc0 are rounded where they are stored, as the sweep
    kernel does."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    cells = _cells(heads)
    L, H = len(cells[0]), cells[0][0].hidden_dim
    toff, _, goff, grec = heads_layout(H, L)
    dgates = tape.new_zeros(tape.shape[0], tape.shape[1], grec)
    dtype = tape.dtype
    tape, g_z0, g_th = _wide(tape), _wide(g_z0), _wide(g_th)
    B, T = tape.shape[0], tape.shape[1]
    tops = (g_z0, g_th[:, :H], g_th[:, H:])
    dh = [[tops[s] if l == L - 1 else torch.zeros_like(g_z0)
           for l in range(L)] for s in range(3)]
    dc = [[torch.zeros_like(g_z0) for _ in range(L)] for _ in range(3)]
    act = cells[0][0].activation
    for t in range(T - 1, -1, -1):
        for s in range(3):
            down = None
            for l in range(L - 1, -1, -1):
                cell = cells[s][l]
                d = dh[s][l] if down is None else dh[s][l] + down
                o = toff[s][l]
                if s == 0:
                    dz = d * _act_grad(act, tape[:, t, o:o + H])
                else:
                    i, f, g, og, c = (tape[:, t, o + k * H:o + (k + 1) * H]
                                      for k in range(5))
                    cp = (tape[:, t - 1, o + 4 * H:o + 5 * H] if t > 0
                          else _wide(cell.c0).expand(B, H))
                    tc = torch.tanh(c)
                    dct = dc[s][l] + d * og * (1 - tc * tc)
                    dz = torch.cat([dct * g * i * (1 - i),
                                    dct * cp * f * (1 - f),
                                    dct * i * (1 - g * g),
                                    d * tc * og * (1 - og)], dim=-1)
                    dc[s][l] = dct * f
                dgates[:, t, goff[s][l]:goff[s][l] + dz.shape[-1]] = dz
                dh[s][l] = dz @ _wide(cell.Wh).t()
                down = dz @ _wide(cell.Wi).t() if l > 0 else None
    dh0 = torch.stack([torch.stack(r, dim=1) for r in dh], dim=1)
    dc0 = torch.stack([torch.stack(r, dim=1) for r in dc], dim=1)
    return dgates, dh0.to(dtype), dc0.to(dtype)


def goku_heads_param_grads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, tape,
                           dgates, dh0, dc0, params=None):
    """The gradients off the chain, from the tape and the sweep's output
    (laid out at hidden width ``tape.shape[-1] // (13 L)``, which may
    exceed the heads' H: the kernels' padded layout). Per cell, over all
    rows and steps: dWi = in^T dgates (in: x in the stack's time order at
    layer 0, else the layer below's h), dWh = h_{t-1}^T dgates (h_{-1} =
    h0), db = sum dgates; dh0 and dc0 summed over rows (the initial states
    are expanded); dxs = dgates_fwd0 Wi^T + flip(dgates_z0 Wi^T) +
    flip(dgates_bwd0 Wi^T), summed in that order. PyTorch matrix products.
    With a population (xs (S, B, T, D) and the tape, dgates, dh0, dc0 with
    the same leading S) the products are batched over the replicas and
    ``params`` gives each replica's tensors (S, ...) in the order of
    ``_heads_params``; without it the heads' own are used. Returns ``(dxs
    (..., B, T, D), [gradient of each tensor of _heads_params])``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    return _param_grads(
        _heads_params(*heads) if params is None else params,
        len(pe_z0.cells), pe_z0.cells[0].hidden_dim, xs, tape, dgates, dh0,
        dc0)


def _param_grads(params, L, H, xs, tape, dgates, dh0, dc0):
    """``goku_heads_param_grads`` from the tensors alone."""
    *lead, B, T, D = xs.shape
    Hl = tape.shape[-1] // (13 * L)
    toff, _, goff, _ = heads_layout(Hl, L)
    xs = xs.detach()
    xr = xs.flip(-2)

    def field(s, l, k):                      # (..., B, T, H)
        o = toff[s][l] + k * Hl
        return tape[..., o:o + H]

    def gates(s, l):                          # (..., B * T, G)
        G = 1 if s == 0 else 4
        o = goff[s][l]
        if Hl == H:
            d = dgates[..., o:o + G * H]
        else:
            d = torch.cat([dgates[..., o + q * Hl:o + q * Hl + H]
                           for q in range(G)], dim=-1)
        return d.reshape(*lead, B * T, G * H)

    grads, x_parts = [], []
    it = iter(params)
    for s in range(3):
        hfield = 0 if s == 0 else 5
        for l in range(L):
            Wi, _, _, h0 = (next(it).detach() for _ in range(4))
            if s:
                next(it)
            d = gates(s, l)
            inp = (xs if s == 1 else xr) if l == 0 else field(s, l - 1,
                                                              hfield)
            hs = field(s, l, hfield)
            hprev = torch.cat([h0[..., None, None, :].expand(*lead, B, 1, H),
                               hs[..., :-1, :]], dim=-2)
            grads += [inp.reshape(*lead, B * T, -1).transpose(-1, -2) @ d,
                      hprev.reshape(*lead, B * T, H).transpose(-1, -2) @ d,
                      d.sum(dim=-2), dh0[..., s, l, :H].sum(dim=-2)]
            if s:
                grads.append(dc0[..., s, l, :H].sum(dim=-2))
            if l == 0:
                x_parts.append((d @ Wi.transpose(-1, -2)).reshape(*lead, B,
                                                                  T, D))
    dxs = x_parts[1] + x_parts[0].flip(-2) + x_parts[2].flip(-2)
    return dxs, grads


@torch.no_grad()
def goku_heads_backward_reference(pe_z0, pe_theta_fwd, pe_theta_bwd, xs,
                                  tape, g_z0, g_th):
    """The whole plain backward: the sweep over ``tape`` and the products.
    Returns ``(dxs, [gradient of each tensor of _heads_params])``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    dgates, dh0, dc0 = goku_heads_sweep_reference(*heads, tape, g_z0, g_th)
    return goku_heads_param_grads(*heads, xs, tape, dgates, dh0, dc0)


# ---------------------------------------------------------------------------
# The kernels.

def _lib():
    lib = load_kernel("goku_heads")
    if not getattr(lib, "_ldq_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ldq_goku_heads, lib.ldq_goku_heads_bf16):
            fn.argtypes = [vp, vp, ci, vp, vp, vp] + [ci] * 8 + [vp]
            fn.restype = ci
        for fn in (lib.ldq_goku_heads_bwd, lib.ldq_goku_heads_bwd_bf16):
            fn.argtypes = [vp, ci] + [vp] * 6 + [ci] * 7 + [vp]
            fn.restype = ci
        lib.ldq_goku_heads_n_weights.argtypes = [ci] * 3
        lib.ldq_goku_heads_n_weights.restype = ci
        lib.ldq_goku_heads_smem.argtypes = [ci] * 3
        lib.ldq_goku_heads_smem.restype = ci
        lib.ldq_goku_heads_dims.argtypes = [ctypes.POINTER(ci)] * 3
        lib.ldq_goku_heads_dims.restype = ci
        dims = [ci(0) for _ in range(3)]
        lib.ldq_goku_heads_dims(*[ctypes.byref(d) for d in dims])
        if tuple(d.value for d in dims) != (KERNEL_D, KERNEL_H, MAX_LAYERS):
            raise RuntimeError("csrc/goku_heads.cu and ops/recurrent_cuda.py "
                               "disagree on the compiled widths")
        lib._ldq_typed = True
    return lib


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What the kernels need to know of the heads: L layers of input width
    D and hidden width H, the RNN activation code, and the widths (Dk, Hk)
    the kernels run at."""
    L: int
    D: int
    H: int
    act: int
    Dk: int
    Hk: int


def _kernel_spec(heads, xs) -> _Spec:
    """Check what the kernels take on the card (``xs`` (B, T, D), or (S, B,
    T, D) for S replicas); returns the heads' ``_Spec``."""
    if xs.dim() not in (3, 4):
        raise ValueError(f"goku_heads: xs must be (B, T, D) or (S, B, T, "
                         f"D), got {tuple(xs.shape)}")
    H, L, act = check_goku_heads(*heads, xs[0] if xs.dim() == 4 else xs)
    _check_dtype(xs.dtype, _heads_params(*heads))
    if not xs.is_cuda:
        raise ValueError("goku_heads_cuda takes a CUDA tensor")
    if L > MAX_LAYERS:
        raise ValueError(f"goku_heads kernel takes at most {MAX_LAYERS} "
                         f"layers; got {L}")
    Dk, Hk = kernel_widths(xs.shape[-1], H)
    if (Dk, Hk) != (KERNEL_D, KERNEL_H):
        need = _lib().ldq_goku_heads_smem(Dk, Hk, L)
        if need > MAX_SMEM:
            raise ValueError(f"goku_heads kernel: heads of widths {Dk}, {Hk}"
                             f" with {L} layers need {need} bytes of shared "
                             f"memory a block, more than {MAX_SMEM}")
    return _Spec(L, _input_width(heads), H, act, Dk, Hk)


def _input_width(heads) -> int:
    return heads[0].cells[0].Wi.shape[0]


def _check_dtype(dtype, params):
    """Raise ValueError unless the kernels have an instance for ``dtype``
    and every head tensor in ``params`` has it too."""
    if dtype not in DTYPES:
        raise ValueError(f"goku_heads kernel takes float32 or bfloat16 "
                         f"tensors, got {dtype}")
    if any(p.dtype != dtype for p in params):
        raise ValueError(f"goku_heads kernel: the heads' weights "
                         f"({sorted({str(p.dtype) for p in params})}) and "
                         f"the input ({dtype}) must share a dtype")


def _packed(spec: _Spec, params, device, dtype):
    """The packed weights of ``params`` (the order of ``_heads_params``, with
    an optional leading replica axis, all of ``dtype``): (n_w,) or (S,
    n_w), float32 (exact for bfloat16) on ``device``."""
    _check_dtype(dtype, params)
    wts = _pack(params, spec.L, spec.D, spec.H, spec.Dk,
                spec.Hk).float().contiguous()
    if wts.device != device:
        raise ValueError("goku_heads_cuda: weights must be on the input's "
                         "device")
    return wts


def _kernel_weights(wts, dtype):
    """Packed weights as the kernels read them: float32, from float32 or
    from the input's ``dtype`` (``pack_goku_heads`` of its tensors)."""
    if wts.dtype not in (torch.float32, dtype):
        raise ValueError(f"goku_heads: packed weights of {wts.dtype} for "
                         f"{dtype} inputs")
    return wts.float().contiguous()


def _replicas(x, lead: int):
    """S for an input with a leading replica axis (``x.dim() == lead +
    1``), else 1."""
    return x.shape[0] if x.dim() == lead + 1 else 1


def _fwd_launch(spec: _Spec, xs, wts, tape: bool):
    """One launch of the forward kernel on (B, T, D) or (S, B, T, D) rows
    with weights (n_w,) or (S, n_w); outputs at the kernel's widths."""
    S = _replicas(xs, 3)
    xs = xs.contiguous()
    wts = _kernel_weights(wts, xs.dtype)
    B, T, D = xs.shape[-3:]
    lead = xs.shape[:-3]
    lib = _lib()
    n_w = lib.ldq_goku_heads_n_weights(spec.Dk, spec.Hk, spec.L)
    if tuple(wts.shape) != (*lead, n_w):
        raise ValueError(f"goku_heads: packed weights {tuple(wts.shape)}, "
                         f"the kernel's layout expects {(*lead, n_w)}")
    Hk = spec.Hk
    z0 = torch.empty(*lead, B, Hk, device=xs.device, dtype=xs.dtype)
    th = torch.empty(*lead, B, 2 * Hk, device=xs.device, dtype=xs.dtype)
    tp = (torch.empty(*lead, B, T, heads_layout(Hk, spec.L)[1],
                      device=xs.device, dtype=xs.dtype) if tape else None)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    launch = (lib.ldq_goku_heads if xs.dtype == torch.float32
              else lib.ldq_goku_heads_bf16)
    with torch.cuda.device(xs.device):
        err = launch(xs.data_ptr(), wts.data_ptr(), n_w, z0.data_ptr(),
                     th.data_ptr(), None if tp is None else tp.data_ptr(), S,
                     B, T, D, spec.Dk, Hk, spec.L, spec.act, stream)
    if err != 0:
        raise RuntimeError(f"goku_heads kernel launch failed: CUDA error "
                           f"{err}")
    goku_heads_cuda.launches += 1
    if xs.dtype == torch.bfloat16:
        goku_heads_cuda.bf16_launches += 1
    H = spec.H
    if H < Hk:
        z0, th = z0[..., :H], torch.cat([th[..., :H], th[..., Hk:Hk + H]],
                                        dim=-1)
    return z0, th, tp


def goku_heads_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, *,
                    tape: bool = False, wts=None):
    """Launch the forward kernel once (no autograd). ``xs``: (B, T, D)
    float32 or bfloat16 (the heads' dtype) on the card, or (S, B, T, D) for
    S replicas with their packed weights ``wts`` (S, n_w)
    (``pack_goku_heads(..., params=)``, float32 or the heads' dtype; one
    launch for all of them). Returns (z0_out (..., B, H), theta_out (...,
    B, 2H)) in xs's dtype, and with ``tape`` also the tape (..., B, T, 13 *
    Hk * L) (``heads_layout(Hk, L)``, Hk from ``kernel_widths``). ``wts``:
    the packed weights, if the caller has them."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    spec = _kernel_spec(heads, xs)
    if wts is None:
        if xs.dim() == 4:
            raise ValueError("goku_heads_cuda: S replicas need their packed "
                             "weights (wts)")
        wts = _packed(spec, _heads_params(*heads), xs.device, xs.dtype)
    z0, th, tp = _fwd_launch(spec, xs, wts, tape)
    return (z0, th, tp) if tape else (z0, th)


goku_heads_cuda.launches = 0        # every launch of the forward kernel
goku_heads_cuda.bf16_launches = 0   # those of its bfloat16 instances


def _bwd_launch(spec: _Spec, tape, g_z0, g_th, wts):
    """One launch of the sweep kernel on (B, ...) or (S, B, ...) rows."""
    L, H, Hk = spec.L, spec.H, spec.Hk
    if tape.dtype not in DTYPES:
        raise ValueError(f"goku_heads_bwd_cuda takes a float32 or bfloat16 "
                         f"tape, got {tape.dtype}")
    for name, t in (("tape", tape), ("g_z0", g_z0), ("g_th", g_th)):
        if not t.is_cuda or t.dtype != tape.dtype:
            raise ValueError(f"goku_heads_bwd_cuda: {name} must be a CUDA "
                             f"tensor of the tape's dtype ({tape.dtype})")
    wts = _kernel_weights(wts, tape.dtype)
    S = _replicas(tape, 3)
    lead = tape.shape[:-3]
    B, T = tape.shape[-3], tape.shape[-2]
    _, rec, _, grec = heads_layout(Hk, L)
    if (tape.shape != (*lead, B, T, rec) or g_z0.shape != (*lead, B, H)
            or g_th.shape != (*lead, B, 2 * H)):
        raise ValueError(f"goku_heads_bwd_cuda: expected tape "
                         f"{(*lead, B, T, rec)}, g_z0 {(*lead, B, H)}, g_th "
                         f"{(*lead, B, 2 * H)}; got {tuple(tape.shape)}, "
                         f"{tuple(g_z0.shape)}, {tuple(g_th.shape)}")
    lib = _lib()
    n_w = lib.ldq_goku_heads_n_weights(spec.Dk, Hk, L)
    if tuple(wts.shape) != (*lead, n_w):
        raise ValueError(f"goku_heads_bwd_cuda: packed weights "
                         f"{tuple(wts.shape)}, expected {(*lead, n_w)}")
    if H < Hk:
        pad = g_z0.new_zeros(*lead, B, Hk - H)
        g_z0 = torch.cat([g_z0, pad], dim=-1)
        g_th = torch.cat([g_th[..., :H], pad, g_th[..., H:], pad], dim=-1)
    tape, g_z0, g_th = (t.detach().contiguous() for t in (tape, g_z0, g_th))
    dgates = torch.empty(*lead, B, T, grec, device=tape.device,
                         dtype=tape.dtype)
    dh0 = torch.empty(*lead, B, 3, L, Hk, device=tape.device,
                      dtype=tape.dtype)
    dc0 = torch.empty_like(dh0)
    stream = torch.cuda.current_stream(tape.device).cuda_stream
    launch = (lib.ldq_goku_heads_bwd if tape.dtype == torch.float32
              else lib.ldq_goku_heads_bwd_bf16)
    with torch.cuda.device(tape.device):
        err = launch(
            wts.data_ptr(), n_w, tape.data_ptr(), g_z0.data_ptr(),
            g_th.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), S, B, T, spec.Dk, Hk, L, spec.act, stream)
    if err != 0:
        raise RuntimeError(f"goku_heads backward kernel launch failed: CUDA "
                           f"error {err}")
    goku_heads_bwd_cuda.launches += 1
    if tape.dtype == torch.bfloat16:
        goku_heads_bwd_cuda.bf16_launches += 1
    return dgates, dh0, dc0


def goku_heads_bwd_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, tape, g_z0,
                        g_th, *, wts=None):
    """Launch the sweep kernel once over the forward kernel's ``tape``
    with the cotangents ``g_z0`` (B, H) and ``g_th`` (B, 2H); with a
    leading replica axis S on all three, the replicas' packed weights
    ``wts`` (S, n_w) and one launch for all of them. Returns ``(dgates
    (..., B, T, 9 * Hk * L), dh0 (..., B, 3, L, Hk), dc0 (..., B, 3, L,
    Hk))`` at the kernel's hidden width Hk (``kernel_widths``)."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    L, H = len(pe_z0.cells), pe_z0.cells[0].hidden_dim
    act = pe_z0.cells[0].activation
    if act not in _ACT_CODES:
        raise ValueError("goku_heads kernel takes a relu, tanh or identity "
                         "RNN activation")
    spec = _Spec(L, _input_width(heads), H, _ACT_CODES[act],
                 *kernel_widths(_input_width(heads), H))
    if wts is None:
        if tape.dim() == 4:
            raise ValueError("goku_heads_bwd_cuda: S replicas need their "
                             "packed weights (wts)")
        wts = _packed(spec, _heads_params(*heads), tape.device, tape.dtype)
    return _bwd_launch(spec, tape, g_z0, g_th, wts)


goku_heads_bwd_cuda.launches = 0
goku_heads_bwd_cuda.bf16_launches = 0


def goku_heads_backward_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, tape,
                             g_z0, g_th, *, wts=None, params=None):
    """The gradient on the card: the sweep kernel, then the products.
    With a replica axis, ``wts`` and ``params`` are the replicas' (S, ...).
    Returns ``(dxs, [gradient of each tensor of _heads_params])``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    dgates, dh0, dc0 = goku_heads_bwd_cuda(*heads, tape, g_z0, g_th,
                                           wts=wts)
    return goku_heads_param_grads(*heads, xs, tape, dgates, dh0, dc0,
                                  params=params)


# ---------------------------------------------------------------------------
# The differentiable entry point.

def _stacked(x, dim, S):
    """``x`` with its replica axis ``dim`` moved to the front (expanded
    to S when the input has none)."""
    return x.movedim(dim, 0) if dim is not None else x.expand(S, *x.shape)


class _GokuHeadsFn(torch.autograd.Function):
    """(z0, theta) = heads(xs; every head tensor), on the card, for one
    weight set (xs (B, T, D), each tensor its own shape) or S of them
    (every input with a leading replica axis). With ``keep_tape`` (a
    gradient will be taken) the forward keeps the tape for the sweep; the
    packed weights and the tape are extra outputs that take no gradient.

    Under ``torch.func.vmap`` over weight sets (train/multiseed.py) the
    ``vmap`` rule moves every replica axis to the front and applies the
    function once to the whole population: one launch of each kernel for
    all replicas, as JAX's vmap of a ``pallas_call`` adds a grid axis. The
    tape is decided there, on the unbatched tensors (inside the transform
    the batched ones report no ``requires_grad``)."""

    @staticmethod
    def forward(spec, keep_tape, xs, *params):
        wts = _packed(spec, params, xs.device, xs.dtype)
        z0, th, tp = _fwd_launch(spec, xs, wts, keep_tape)
        if tp is None:
            tp = xs.new_zeros(xs.shape[:-2] + (0,))
        return z0, th, wts, tp

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, _, xs, *params = inputs
        _, _, wts, tape = output
        ctx.spec = spec
        ctx.mark_non_differentiable(wts, tape)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xs, wts, tape, *params)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_z0, g_th, _g_wts, _g_tape):
        xs, wts, tape, *params = ctx.saved_tensors
        spec = ctx.spec
        if tape.shape[-1] == 0:
            raise RuntimeError("goku_heads: the forward kept no tape (it ran "
                               "without gradients)")
        lead = xs.shape[:-2]
        if g_z0 is None:
            g_z0 = xs.new_zeros(*lead, spec.H)
        if g_th is None:
            g_th = xs.new_zeros(*lead, 2 * spec.H)
        dgates, dh0, dc0 = _bwd_launch(spec, tape, g_z0, g_th, wts)
        dxs, dparams = _param_grads(params, spec.L, spec.H, xs, tape, dgates,
                                    dh0, dc0)
        want = ctx.needs_input_grad[2:]
        return (None, None,
                *[d if w else None for d, w in zip([dxs] + dparams, want)])

    @staticmethod
    def vmap(info, in_dims, spec, keep_tape, xs, *params):
        S = info.batch_size
        xs = _stacked(xs, in_dims[2], S)
        if xs.dim() != 4:
            raise ValueError("goku_heads: one replica axis is supported")
        params = [_stacked(p, d, S) for p, d in zip(params, in_dims[3:])]
        keep = torch.is_grad_enabled() and any(
            t.requires_grad for t in [xs] + params)
        return _GokuHeadsFn.apply(spec, keep, xs, *params), (0, 0, 0, 0)


def goku_heads(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
               pe_theta_bwd: Recurrent, xs):
    """All three GOKU heads: the CUDA kernels for a CUDA ``xs``, the plain
    version with autograd for a CPU ``xs``. Differentiable in ``xs`` and
    every head weight: on the card the forward keeps its tape and the
    gradient is the sweep kernel and the products over it. Under
    ``torch.func.vmap`` over the heads' weights (a population of weight
    sets) the kernels launch once for all replicas. Returns ``(z0_out,
    theta_out)``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    check_goku_heads(*heads, xs)
    if xs.device.type == "cpu":
        return goku_heads_reference(*heads, xs)
    params = _heads_params(*heads)
    spec = _kernel_spec(heads, xs)
    keep_tape = torch.is_grad_enabled() and any(
        t.requires_grad for t in [xs] + params)
    z0, th, _, _ = _GokuHeadsFn.apply(spec, keep_tape, xs, *params)
    return z0, th
