"""CUDA kernel for the three GOKU encoder heads (replaces the Pallas TPU
kernel latentdiffeq/ops/recurrent_pallas.py::pallas_goku_heads).

``goku_heads`` runs the kernel (csrc/goku_heads.cu) on CUDA tensors and the
plain PyTorch version ``goku_heads_reference`` on CPU tensors. The gradient
mirrors the JAX ``custom_vjp``: the forward is the kernel, the backward
recomputes through the plain version with autograd (no backward kernel).
Shapes on the main path: xs (64, 50, 32) in training, (45, 100, 32) in
validation; H = 16; two layers per stack.
"""
from __future__ import annotations

import ctypes

import torch

from ..nn.layers import identity, relu, tanh
from ..nn.recurrent import LSTMCell, Recurrent, RNNCell, fused_goku_heads
from ._build import load_kernel

__all__ = ["goku_heads", "goku_heads_cuda", "goku_heads_reference",
           "pack_goku_heads", "check_goku_heads"]

# RNN activation codes understood by the kernel.
_ACT_CODES = {identity: 0, relu: 1, tanh: 2}
# Batch rows per block: 4 rows x 4H = 256 threads at H = 16.
ROWS_PER_BLOCK = 4


def goku_heads_reference(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
                         pe_theta_bwd: Recurrent, xs):
    """The plain PyTorch version: `nn.fused_goku_heads`."""
    return fused_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs)


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


def pack_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd) -> torch.Tensor:
    """One contiguous float32 buffer of every head weight, in the layout
    csrc/goku_heads.cu documents (the order of ``_heads_params``)."""
    return torch.cat([p.detach().reshape(-1) for p in
                      _heads_params(pe_z0, pe_theta_fwd, pe_theta_bwd)])


def _lib():
    lib = load_kernel("goku_heads")
    if not getattr(lib, "_ldq_typed", False):
        lib.ldq_goku_heads.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.ldq_goku_heads.restype = ctypes.c_int
        lib.ldq_goku_heads_n_weights.argtypes = [ctypes.c_int] * 3
        lib.ldq_goku_heads_n_weights.restype = ctypes.c_int
        lib.ldq_goku_heads_max_layers.argtypes = []
        lib.ldq_goku_heads_max_layers.restype = ctypes.c_int
        lib._ldq_typed = True
    return lib


def goku_heads_cuda(pe_z0, pe_theta_fwd, pe_theta_bwd, xs):
    """Launch the kernel once (no autograd). ``xs``: (B, T, D) float32 on
    the card. Returns (z0_out (B, H), theta_out (B, 2H))."""
    H, L, act = check_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, xs)
    if not xs.is_cuda or xs.dtype != torch.float32:
        raise ValueError("goku_heads_cuda takes a float32 CUDA tensor")
    xs = xs.contiguous()
    B, T, D = xs.shape
    wts = pack_goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd)
    if wts.device != xs.device or wts.dtype != torch.float32:
        raise ValueError("goku_heads_cuda: weights must be float32 on the "
                         "input's device")
    lib = _lib()
    if L > lib.ldq_goku_heads_max_layers():
        raise ValueError(f"goku_heads kernel takes at most "
                         f"{lib.ldq_goku_heads_max_layers()} layers")
    n_w = lib.ldq_goku_heads_n_weights(D, H, L)
    if n_w != wts.numel():
        raise ValueError(f"goku_heads: packed {wts.numel()} weights, the "
                         f"kernel's layout expects {n_w}")
    z0 = torch.empty(B, H, device=xs.device, dtype=xs.dtype)
    th = torch.empty(B, 2 * H, device=xs.device, dtype=xs.dtype)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with torch.cuda.device(xs.device):
        err = lib.ldq_goku_heads(xs.data_ptr(), wts.data_ptr(), n_w,
                                 z0.data_ptr(), th.data_ptr(), B, T, D, H,
                                 L, act, ROWS_PER_BLOCK, stream)
    if err != 0:
        raise RuntimeError(f"goku_heads kernel launch failed: CUDA error "
                           f"{err}")
    goku_heads_cuda.launches += 1
    return z0, th


goku_heads_cuda.launches = 0


class _GokuHeadsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, heads, xs, *params):
        ctx.heads = heads
        ctx.save_for_backward(xs)
        return goku_heads_cuda(*heads, xs)

    @staticmethod
    def backward(ctx, g_z0, g_th):
        (xs,) = ctx.saved_tensors
        params = _heads_params(*ctx.heads)
        want = [ctx.needs_input_grad[1]] + list(ctx.needs_input_grad[2:])
        xs_ = xs.detach().requires_grad_(want[0])
        inputs = [t for t, w in zip([xs_] + params, want) if w]
        grads = iter(())
        if inputs:
            with torch.enable_grad():
                z0, th = goku_heads_reference(*ctx.heads, xs_)
            grads = iter(torch.autograd.grad((z0, th), inputs,
                                             (g_z0, g_th),
                                             allow_unused=True))
        out = [next(grads) if w else None for w in want]
        return (None, *out)


def goku_heads(pe_z0: Recurrent, pe_theta_fwd: Recurrent,
               pe_theta_bwd: Recurrent, xs):
    """All three GOKU heads: the CUDA kernel for a CUDA ``xs``, the plain
    version for a CPU ``xs``. Differentiable in ``xs`` and every head
    weight. Returns ``(z0_out, theta_out)``."""
    heads = (pe_z0, pe_theta_fwd, pe_theta_bwd)
    check_goku_heads(*heads, xs)
    if xs.device.type == "cpu":
        return goku_heads_reference(*heads, xs)
    return _GokuHeadsFn.apply(heads, xs, *_heads_params(*heads))
