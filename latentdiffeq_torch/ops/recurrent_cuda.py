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
"""
from __future__ import annotations

import ctypes

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
           "kernel_widths", "KERNEL_D", "KERNEL_H", "MAX_LAYERS"]

# RNN activation codes understood by the kernels.
_ACT_CODES = {identity: 0, relu: 1, tanh: 2}
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
                    H: int = 0) -> torch.Tensor:
    """One contiguous buffer of every head weight, in the layout
    csrc/goku_heads.cu documents (the order of ``_heads_params``). With
    widths ``D`` and ``H`` larger than the heads', each tensor is laid out
    at those widths with zeros in the missing input rows and unit columns
    (of each gate)."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    params = _heads_params(*heads)
    D0 = pe_z0.cells[0].Wi.shape[0]
    H0 = pe_z0.cells[0].hidden_dim
    D, H = D or D0, H or H0
    if (D, H) == (D0, H0):
        return torch.cat([p.detach().reshape(-1) for p in params])
    pieces = []
    for s, head in enumerate(heads):
        G = 1 if s == 0 else 4
        for l, cell in enumerate(head.cells):
            din, dinp = (D0, D) if l == 0 else (H0, H)
            for name, rows, rows_p in (("Wi", din, dinp), ("Wh", H0, H),
                                       ("b", 1, 1)):
                w = getattr(cell, name).detach().reshape(rows, G, H0)
                z = w.new_zeros(rows_p, G, H)
                z[:rows, :, :H0] = w
                pieces.append(z.reshape(-1))
            for name in ("h0", "c0") if s else ("h0",):
                w = getattr(cell, name).detach()
                pieces.append(torch.cat([w, w.new_zeros(H - H0)]))
    return torch.cat(pieces)


# ---------------------------------------------------------------------------
# Plain PyTorch versions.

def _cells(heads):
    return [list(h.cells) for h in heads]


@torch.no_grad()
def goku_heads_taped_reference(pe_z0, pe_theta_fwd, pe_theta_bwd, xs):
    """The plain forward that also keeps the tape, as the forward kernel
    writes it when a gradient will be taken (``heads_layout`` at the heads'
    own H). Returns ``(z0_out (B, H), theta_out (B, 2H), tape (B, T,
    13 H L))``; the outputs equal ``goku_heads_reference``'s."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    H, L, _ = check_goku_heads(*heads, xs)
    toff, rec, _, _ = heads_layout(H, L)
    xs = xs.detach()
    B, T = xs.shape[0], xs.shape[1]
    tape = xs.new_zeros(B, T, rec)
    cells = _cells(heads)
    hs = [[c.h0.detach().expand(B, H) for c in cs] for cs in cells]
    cs_ = [[c.c0.detach().expand(B, H) if s else None
            for c in cs] for s, cs in enumerate(cells)]
    for t in range(T):
        for s in range(3):
            inp = xs[:, t] if s == 1 else xs[:, T - 1 - t]
            for l, cell in enumerate(cells[s]):
                z = (inp @ cell.Wi.detach() + hs[s][l] @ cell.Wh.detach()
                     + cell.b.detach())
                o = toff[s][l]
                if s == 0:
                    h = cell.activation(z)
                    tape[:, t, o:o + H] = h
                else:
                    i, f, g, og = torch.chunk(z, 4, dim=-1)
                    gates = (torch.sigmoid(i), torch.sigmoid(f),
                             torch.tanh(g), torch.sigmoid(og))
                    c = gates[1] * cs_[s][l] + gates[0] * gates[2]
                    h = gates[3] * torch.tanh(c)
                    cs_[s][l] = c
                    for k, v in enumerate(gates + (c, h)):
                        tape[:, t, o + k * H:o + (k + 1) * H] = v
                hs[s][l] = h
                inp = h
    return hs[0][-1], torch.cat([hs[1][-1], hs[2][-1]], dim=-1), tape


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
    the carries left at t = -1 (dc0 of the RNN is 0)."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    cells = _cells(heads)
    L, H = len(cells[0]), cells[0][0].hidden_dim
    toff, _, goff, grec = heads_layout(H, L)
    tape, g_z0, g_th = tape.detach(), g_z0.detach(), g_th.detach()
    B, T = tape.shape[0], tape.shape[1]
    dgates = tape.new_zeros(B, T, grec)
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
                          else cell.c0.detach().expand(B, H))
                    tc = torch.tanh(c)
                    dct = dc[s][l] + d * og * (1 - tc * tc)
                    dz = torch.cat([dct * g * i * (1 - i),
                                    dct * cp * f * (1 - f),
                                    dct * i * (1 - g * g),
                                    d * tc * og * (1 - og)], dim=-1)
                    dc[s][l] = dct * f
                dgates[:, t, goff[s][l]:goff[s][l] + dz.shape[-1]] = dz
                dh[s][l] = dz @ cell.Wh.detach().t()
                down = dz @ cell.Wi.detach().t() if l > 0 else None
    dh0 = torch.stack([torch.stack(r, dim=1) for r in dh], dim=1)
    dc0 = torch.stack([torch.stack(r, dim=1) for r in dc], dim=1)
    return dgates, dh0, dc0


def goku_heads_param_grads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, tape,
                           dgates, dh0, dc0):
    """The gradients off the chain, from the tape and the sweep's output
    (laid out at hidden width ``tape.shape[-1] // (13 L)``, which may
    exceed the heads' H: the kernels' padded layout). Per cell, over all
    rows and steps: dWi = in^T dgates (in: x in the stack's time order at
    layer 0, else the layer below's h), dWh = h_{t-1}^T dgates (h_{-1} =
    h0), db = sum dgates; dh0 and dc0 summed over rows (the initial states
    are expanded); dxs = dgates_fwd0 Wi^T + flip(dgates_z0 Wi^T) +
    flip(dgates_bwd0 Wi^T), summed in that order. PyTorch matrix products.
    Returns ``(dxs (B, T, D), [gradient of each tensor of
    _heads_params])``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    cells = _cells(heads)
    L, H = len(cells[0]), cells[0][0].hidden_dim
    B, T, D = xs.shape
    Hl = tape.shape[-1] // (13 * L)
    toff, _, goff, _ = heads_layout(Hl, L)
    xs = xs.detach()
    xr = xs.flip(1)

    def field(s, l, k):                      # (B, T, H)
        o = toff[s][l] + k * Hl
        return tape[..., o:o + H]

    def gates(s, l):                          # (B * T, G)
        G = 1 if s == 0 else 4
        o = goff[s][l]
        if Hl == H:
            d = dgates[..., o:o + G * H]
        else:
            d = torch.cat([dgates[..., o + q * Hl:o + q * Hl + H]
                           for q in range(G)], dim=-1)
        return d.reshape(B * T, G * H)

    grads, x_parts = [], []
    for s in range(3):
        hfield = 0 if s == 0 else 5
        for l, cell in enumerate(cells[s]):
            d = gates(s, l)
            inp = (xs if s == 1 else xr) if l == 0 else field(s, l - 1,
                                                              hfield)
            hs = field(s, l, hfield)
            hprev = torch.cat([cell.h0.detach().expand(B, 1, H),
                               hs[:, :-1]], dim=1)
            grads += [inp.reshape(B * T, -1).t() @ d,
                      hprev.reshape(B * T, H).t() @ d, d.sum(dim=0),
                      dh0[:, s, l, :H].sum(dim=0)]
            if s:
                grads.append(dc0[:, s, l, :H].sum(dim=0))
            if l == 0:
                x_parts.append((d @ cell.Wi.detach().t()).reshape(B, T, D))
    dxs = x_parts[1] + x_parts[0].flip(1) + x_parts[2].flip(1)
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
        lib.ldq_goku_heads.argtypes = [vp, vp, ci, vp, vp, vp] + [ci] * 7 + [
            vp]
        lib.ldq_goku_heads.restype = ci
        lib.ldq_goku_heads_bwd.argtypes = [vp, ci] + [vp] * 6 + [ci] * 6 + [
            vp]
        lib.ldq_goku_heads_bwd.restype = ci
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


def _check_kernel(heads, xs):
    """What the kernels take on the card; returns (H, L, act, Dk, Hk) with
    the widths the kernels run at."""
    H, L, act = check_goku_heads(*heads, xs)
    if not xs.is_cuda or xs.dtype != torch.float32:
        raise ValueError("goku_heads_cuda takes a float32 CUDA tensor")
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
    return H, L, act, Dk, Hk


def _packed(heads, device):
    wts = pack_goku_heads(*heads, *kernel_widths(
        heads[0].cells[0].Wi.shape[0], heads[0].cells[0].hidden_dim))
    wts = wts.contiguous()
    if wts.device != device or wts.dtype != torch.float32:
        raise ValueError("goku_heads_cuda: weights must be float32 on the "
                         "input's device")
    return wts


def goku_heads_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, *,
                    tape: bool = False, wts=None):
    """Launch the forward kernel once (no autograd). ``xs``: (B, T, D)
    float32 on the card. Returns (z0_out (B, H), theta_out (B, 2H)), and
    with ``tape`` also the tape (B, T, 13 * Hk * L) (``heads_layout(Hk,
    L)``, Hk from ``kernel_widths``). ``wts``: the packed weights, if the
    caller has them."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    H, L, act, Dk, Hk = _check_kernel(heads, xs)
    if wts is None:
        wts = _packed(heads, xs.device)
    xs = xs.contiguous()
    B, T, D = xs.shape
    lib = _lib()
    n_w = lib.ldq_goku_heads_n_weights(Dk, Hk, L)
    if n_w != wts.numel():
        raise ValueError(f"goku_heads: packed {wts.numel()} weights, the "
                         f"kernel's layout expects {n_w}")
    z0 = torch.empty(B, Hk, device=xs.device, dtype=xs.dtype)
    th = torch.empty(B, 2 * Hk, device=xs.device, dtype=xs.dtype)
    tp = (torch.empty(B, T, heads_layout(Hk, L)[1], device=xs.device,
                      dtype=xs.dtype) if tape else None)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = lib.ldq_goku_heads(xs.data_ptr(), wts.data_ptr(), n_w,
                                 z0.data_ptr(), th.data_ptr(),
                                 None if tp is None else tp.data_ptr(), B, T,
                                 D, Dk, Hk, L, act, stream)
    if err != 0:
        raise RuntimeError(f"goku_heads kernel launch failed: CUDA error "
                           f"{err}")
    goku_heads_cuda.launches += 1
    if H < Hk:
        z0, th = z0[:, :H], torch.cat([th[:, :H], th[:, Hk:Hk + H]], dim=-1)
    return (z0, th, tp) if tape else (z0, th)


goku_heads_cuda.launches = 0


def goku_heads_bwd_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, tape, g_z0,
                        g_th, *, wts=None):
    """Launch the sweep kernel once over the forward kernel's ``tape``
    with the cotangents ``g_z0`` (B, H) and ``g_th`` (B, 2H). Returns
    ``(dgates (B, T, 9 * Hk * L), dh0 (B, 3, L, Hk), dc0 (B, 3, L, Hk))``
    at the kernel's hidden width Hk (``kernel_widths``)."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    L, H = len(pe_z0.cells), pe_z0.cells[0].hidden_dim
    Dk, Hk = kernel_widths(pe_z0.cells[0].Wi.shape[0], H)
    for name, t in (("tape", tape), ("g_z0", g_z0), ("g_th", g_th)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"goku_heads_bwd_cuda: {name} must be a "
                             f"float32 CUDA tensor")
    B, T = tape.shape[0], tape.shape[1]
    _, rec, _, grec = heads_layout(Hk, L)
    if (tape.shape != (B, T, rec) or g_z0.shape != (B, H)
            or g_th.shape != (B, 2 * H)):
        raise ValueError(f"goku_heads_bwd_cuda: expected tape {(B, T, rec)}"
                         f", g_z0 {(B, H)}, g_th {(B, 2 * H)}; got "
                         f"{tuple(tape.shape)}, {tuple(g_z0.shape)}, "
                         f"{tuple(g_th.shape)}")
    if wts is None:
        wts = _packed(heads, tape.device)
    if H < Hk:
        pad = g_z0.new_zeros(B, Hk - H)
        g_z0 = torch.cat([g_z0, pad], dim=-1)
        g_th = torch.cat([g_th[:, :H], pad, g_th[:, H:], pad], dim=-1)
    tape, g_z0, g_th = (t.detach().contiguous() for t in (tape, g_z0, g_th))
    dgates = torch.empty(B, T, grec, device=tape.device, dtype=tape.dtype)
    dh0 = torch.empty(B, 3, L, Hk, device=tape.device, dtype=tape.dtype)
    dc0 = torch.empty_like(dh0)
    act = _ACT_CODES[pe_z0.cells[0].activation]
    lib = _lib()
    stream = torch.cuda.current_stream(tape.device).cuda_stream
    with torch.cuda.device(tape.device):
        err = lib.ldq_goku_heads_bwd(
            wts.data_ptr(), wts.numel(), tape.data_ptr(), g_z0.data_ptr(),
            g_th.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), B, T, Dk, Hk, L, act, stream)
    if err != 0:
        raise RuntimeError(f"goku_heads backward kernel launch failed: CUDA "
                           f"error {err}")
    goku_heads_bwd_cuda.launches += 1
    return dgates, dh0, dc0


goku_heads_bwd_cuda.launches = 0


def goku_heads_backward_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, xs, tape,
                             g_z0, g_th, *, wts=None):
    """The gradient on the card: the sweep kernel, then the products.
    Returns ``(dxs, [gradient of each tensor of _heads_params])``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    dgates, dh0, dc0 = goku_heads_bwd_cuda(*heads, tape, g_z0, g_th,
                                           wts=wts)
    return goku_heads_param_grads(*heads, xs, tape, dgates, dh0, dc0)


# ---------------------------------------------------------------------------
# The differentiable entry point.

class _GokuHeadsFn(torch.autograd.Function):
    """(z0, theta) = heads(xs; every head tensor), on the card. With
    ``keep_tape`` (a gradient will be taken) the forward keeps the tape for
    the sweep."""

    @staticmethod
    def forward(ctx, heads, keep_tape, xs, *params):
        wts = _packed(heads, xs.device)
        out = goku_heads_cuda(*heads, xs, tape=keep_tape, wts=wts)
        ctx.heads = heads
        ctx.save_for_backward(xs, wts, out[2] if keep_tape else None)
        return out[0], out[1]

    @staticmethod
    @once_differentiable
    def backward(ctx, g_z0, g_th):
        xs, wts, tape = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        dxs, dparams = goku_heads_backward_cuda(*ctx.heads, xs, tape, g_z0,
                                                g_th, wts=wts)
        return (None, None,
                *[d if w else None for d, w in zip([dxs] + dparams, want)])


def goku_heads(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
               pe_theta_bwd: Recurrent, xs):
    """All three GOKU heads: the CUDA kernels for a CUDA ``xs``, the plain
    version with autograd for a CPU ``xs``. Differentiable in ``xs`` and
    every head weight: on the card the forward keeps its tape and the
    gradient is the sweep kernel and the products over it. Returns
    ``(z0_out, theta_out)``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    check_goku_heads(*heads, xs)
    if xs.device.type == "cpu":
        return goku_heads_reference(*heads, xs)
    params = _heads_params(*heads)
    keep_tape = torch.is_grad_enabled() and any(
        t.requires_grad for t in [xs] + params)
    return _GokuHeadsFn.apply(heads, keep_tape, xs, *params)
