"""Latent ODE model type (counterpart of latentdiffeq/models/latent_ode.py;
Chen et al. 2018, arXiv:1806.07366).

A single recurrent z0 encoder over the reversed sequence, a trainable
neural vector field integrated from the sampled initial state, optional
state augmentation (reference: src/models/LatentODE.jl).

``use_kernel_solve`` runs the solve and its gradient as the hand-written
CUDA kernels of ops/node_cuda.py (one launch each; in a population under
``torch.func.vmap`` the forward and sweep once a replica, the weight
gradients once for all). It needs a fixed-grid
float32 solve and a Chain-of-Dense field and raises otherwise; with the
switch on, a CUDA tensor runs the kernels and a CPU tensor their plain
PyTorch versions. The model is float32 end to end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import nn
from ..adjoint.modes import Unrolled
from ..adjoint.odeint import SolveOptions, odeint, uses_fixed_grid
from ..core import Identity, resolve_device
from ..ops.node_cuda import solve_neural_field
from ..solve.rk import Tsit5
from .dynamics import NeuralODEDynamics
from .template import Decoder, Encoder, ModelType

__all__ = ["LatentODE", "latent_ode_default_layers", "NODE"]


@dataclasses.dataclass(frozen=True)
class LatentODE(ModelType):
    """Reference: ``struct LatentODE <: LatentDE`` (LatentODE.jl:7).
    ``encoder_unroll`` is a JAX scheduling knob with no effect on results;
    it is accepted and ignored here."""

    encoder_unroll: int = 1
    use_kernel_solve: bool = False

    def apply_pattern_extractor(self, encoder: Encoder, fe_out,
                                cur_len=None):
        """Single stacked RNN over the reversed sequence, last state
        (LatentODE.jl:20-34). ``cur_len``: masked-curriculum mode, the
        reverse scan idles through the padding and then consumes the real
        prefix reversed."""
        mask = (None if cur_len is None else
                torch.arange(fe_out.shape[1], device=fe_out.device)
                < cur_len)
        return encoder.pattern_extractor(fe_out, reverse=True, mask=mask)

    def apply_latent_in(self, encoder: Encoder, pe_out):
        """Two Dense heads -> (z0_mu, z0_logvar) (LatentODE.jl:36-43)."""
        li_mu, li_logvar = encoder.latent_in
        return li_mu(pe_out), li_logvar(pe_out)

    def sample(self, mu, logvar, generator=None, eps=None):
        """Reparameterised sample (LatentODE.jl:82-89). ``eps``: the
        standard-normal noise itself, else drawn from ``generator`` on the
        tensor's device."""
        if eps is None:
            eps = torch.randn(logvar.shape, generator=generator,
                              device=logvar.device, dtype=logvar.dtype)
        return mu + eps * torch.exp(logvar / 2)

    def apply_latent_out(self, decoder: Decoder, l):
        """Pass through the user layer (identity in the default
        architecture; LatentODE.jl:54,149)."""
        return decoder.latent_out(l)

    def diffeq_layer(self, decoder: Decoder, z0_hat, t, key=None):
        """Integrate the trainable vector field from z0_hat, padded with
        zeros when augment_dim > 0 (LatentODE.jl:61-78); failed
        trajectories are NaN-filled."""
        de = decoder.diffeq
        if not isinstance(de, NeuralODEDynamics):
            raise TypeError(f"LatentODE needs a NeuralODEDynamics in the "
                            f"diffeq slot, got {type(de).__name__}")
        if de.augment_dim > 0:
            pad = z0_hat.new_zeros(z0_hat.shape[:-1] + (de.augment_dim,))
            z0_hat = torch.cat([z0_hat, pad], dim=-1)

        # the solver integrates in float32 whatever the model's type
        in_dtype = z0_hat.dtype
        if self.use_kernel_solve:
            if (not uses_fixed_grid(de.solver, de.options)
                    or de.options.interp_stride != 1):
                raise ValueError(
                    "LatentODE(use_kernel_solve=True) requires a fixed-grid "
                    "solve: options.adaptive=False, interp_stride=1 "
                    "(ops/node_cuda.py)")
            if in_dtype != torch.float32 or any(
                    p.dtype != torch.float32 for p in de.dudt.parameters()):
                # the plain path evaluates the field in the model's type;
                # the kernel computes in float32 throughout, which would
                # silently change the trajectories: refuse instead
                raise ValueError(
                    "use_kernel_solve supports float32 models only (the "
                    f"kernel would change {in_dtype} numerics); use the "
                    "plain path for other types")
            ys, success, stats = solve_neural_field(
                de.dudt, de.solver, z0_hat, t,
                substeps=de.options.substeps)
        else:
            def f(u, p, t_):
                return p(u.to(in_dtype)).to(torch.float32)

            ys, success, stats = odeint(f, de.solver,
                                        z0_hat.to(torch.float32), de.dudt,
                                        t, de.options, de.sensealg)
        ys = torch.where(success[:, None, None], ys,
                         torch.full_like(ys, float("nan")))
        if de.transform is not None:
            ys = de.transform(ys)
        ys = ys.to(in_dtype)
        aux = {"success": success,
               "stats": {k: v.sum() for k, v in stats.items()}}
        return ys, aux


def NODE(latent_dim_in: int, *, hidden_dim: int = 200, augment_dim: int = 0,
         activation: Callable = nn.relu, solver=None, sensealg=None,
         options=None, init=nn.default_init,
         generator: Optional[torch.Generator] = None, device=None,
         dtype=torch.float32) -> NeuralODEDynamics:
    """The reference's NODE spec (nODE.jl:13-31): dudt = Dense(in+aug,
    hidden, relu) -> Dense(hidden, hidden, relu) -> Dense(hidden, in+aug),
    Tsit5 solver. Weights are drawn on the CPU from ``generator`` (seed 0
    when None) and moved to ``device`` (default: the card)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dim = latent_dim_in + augment_dim
    dudt = nn.mlp((dim, hidden_dim, hidden_dim, dim), activation,
                  nn.identity, winit=init, generator=generator, dtype=dtype)
    return NeuralODEDynamics(
        dudt=dudt.to(device), latent_dim_in=latent_dim_in,
        augment_dim=augment_dim,
        solver=solver if solver is not None else Tsit5(),
        sensealg=sensealg if sensealg is not None else Unrolled(),
        options=options if options is not None else SolveOptions())


def latent_ode_default_layers(input_dim: int, diffeq: NeuralODEDynamics, *,
                              hidden_dim_resnet: int = 200,
                              rnn_input_dim: int = 32,
                              rnn_output_dim: int = 32,
                              output_activation: Callable = nn.sigmoid,
                              init=nn.default_init,
                              generator: Optional[torch.Generator] = None,
                              device=None, dtype=torch.float32):
    """Default LatentODE architecture (reference: LatentODE.jl:100-152).
    Returns ``(encoder_layers, decoder_layers)`` for
    ``LatentDiffEqModel.build(LatentODE(), ...)``. Weights are drawn on
    the CPU from ``generator`` (seed 0 when None) and moved to ``device``
    (default: the card), where ``diffeq`` must already be."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kw = dict(winit=init, generator=generator, dtype=dtype)
    latent_dim_in = diffeq.latent_dim_in
    latent_dim_out = diffeq.latent_dim_out

    feature_extractor = nn.resnet_mlp(
        input_dim, hidden_dim_resnet, rnn_input_dim, nn.relu, nn.relu, **kw)
    pattern_extractor = nn.Recurrent.rnn(
        rnn_input_dim, (rnn_output_dim, rnn_output_dim), nn.relu, **kw)
    latent_in = (nn.Dense(rnn_output_dim, latent_dim_in, **kw),
                 nn.Dense(rnn_output_dim, latent_dim_in, **kw))
    reconstructor = nn.resnet_mlp(
        latent_dim_out, hidden_dim_resnet, input_dim, nn.relu,
        output_activation, **kw)

    encoder_layers = (feature_extractor.to(device),
                      pattern_extractor.to(device),
                      tuple(d.to(device) for d in latent_in))
    decoder_layers = (Identity(), diffeq.to(device),
                      reconstructor.to(device))
    return encoder_layers, decoder_layers
