"""Device selection and the identity layer of the PyTorch port.

Every entry point of the port (model construction, the data generator, the
trainer) takes an explicit ``device``. The default is the card: without
CUDA the port refuses to run unless the caller asks for the CPU, so a run
never lands on the CPU by accident.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "DeviceLike", "Identity", "tree_size"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without an index gets the
    current one. Raises when CUDA is asked for (or defaulted to) and this
    process has no usable card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "latentdiffeq_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Identity(torch.nn.Module):
    """The identity layer, parameter-free (the LatentODE ``latent_out``
    slot; reference: ``x -> x`` at LatentODE.jl:149)."""

    def forward(self, x):
        return x


def tree_size(tree) -> int:
    """Total number of scalars in a module's parameters and buffers, or in
    the tensors of a (nested) list, tuple or dict (JAX's ``tree_size``
    counts a pytree's array leaves)."""
    if isinstance(tree, torch.nn.Module):
        return sum(t.numel() for t in list(tree.parameters())
                   + list(tree.buffers()))
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, dict):
        return sum(tree_size(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size(v) for v in tree)
    return 0
