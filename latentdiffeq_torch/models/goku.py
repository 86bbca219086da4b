"""GOKU-net model type (counterpart of latentdiffeq/models/goku.py).

The encoder infers a latent initial state z0 and latent mechanistic
parameters theta; the decoder maps them to the ODE's state and parameter
space, solves the batched ODE, and reconstructs frames (reference:
src/models/GOKU.jl).

Two switches select the hand-written CUDA kernels: ``use_kernel_encoder``
(the three recurrent heads in one kernel, ops/recurrent_cuda.py) and
``use_kernel_solver`` (the whole batched fixed-grid RK solve of an
``ODEDynamics`` in one kernel, ops/ode_cuda.py). As JAX's
``use_pallas_solver`` traces any field into its Pallas solve, the RK
kernel takes any field with a fixed-grid solver: a hand-written functor
where the field names one, else a functor generated from the field's trace
(ops/rhs_trace.py, ops/rhs_codegen.py); a field the kernel cannot run
raises ValueError naming the graph node, on either device, at the first
solve. With a switch on, a CUDA tensor runs the kernel and a CPU tensor
runs the kernel's plain PyTorch version. ``SDEDynamics`` always take the SDE solvers (solve/sde.py), as in
the JAX package, whatever ``use_kernel_solver`` says.

Mixed precision (``goku_default_layers(..., dtype=torch.bfloat16)``): the
NN stages compute in the parameters' dtype, and the solve always
integrates in float32 (``diffeq_layer`` casts in and casts back), as in the
JAX package. The heads kernel has bfloat16 instances; the RK kernel runs
float32 behind the casts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import nn
from ..adjoint.odeint import odeint, uses_fixed_grid
from ..core import resolve_device
from ..ops.ode_cuda import solve_fixed_grid_batched
from ..ops.recurrent_cuda import goku_heads
from .. import random as jr
from ..solve.sde import solve_sde_adaptive, solve_sde_fixed_grid
from .dynamics import ODEDynamics, SDEDynamics
from .template import Decoder, Encoder, ModelType

__all__ = ["GOKU", "GOKUBasic", "goku_default_layers"]


class GOKU(ModelType):
    use_kernel_encoder: bool = False
    use_kernel_solver: bool = False

    def apply_pattern_extractor(self, encoder: Encoder, fe_out,
                                cur_len=None):
        """z0 head: stacked RNN over the reversed sequence; theta head:
        bidirectional stacked LSTM (GOKU.jl:30-49). The encoder kernel is
        bypassed on the masked-curriculum path (``cur_len`` set), as in
        the JAX package."""
        pe_z0, pe_theta_fwd, pe_theta_bwd = encoder.pattern_extractor
        if self.use_kernel_encoder and cur_len is None:
            return goku_heads(pe_z0, pe_theta_fwd, pe_theta_bwd, fe_out)
        mask = (None if cur_len is None else
                torch.arange(fe_out.shape[1], device=fe_out.device)
                < cur_len)
        z0_out = pe_z0(fe_out, reverse=True, mask=mask)
        th_f = pe_theta_fwd(fe_out, mask=mask)
        th_b = pe_theta_bwd(fe_out, reverse=True, mask=mask)
        return z0_out, torch.cat([th_f, th_b], dim=-1)

    def apply_latent_in(self, encoder: Encoder, pe_out):
        """Four Dense heads -> ((z0_mu, theta_mu), (z0_logvar,
        theta_logvar)) (GOKU.jl:61-72)."""
        z0_out, th_out = pe_out
        li_mu_z0, li_logvar_z0, li_mu_th, li_logvar_th = encoder.latent_in
        return ((li_mu_z0(z0_out), li_mu_th(th_out)),
                (li_logvar_z0(z0_out), li_logvar_th(th_out)))

    def sample(self, mu, logvar, generator=None, eps=None):
        """Reparameterised sample of (z0, theta) (GOKU.jl:155-163).
        ``eps``: the (z0, theta) standard-normal noise, else drawn from
        ``generator`` on the tensors' device."""
        (z0_mu, th_mu), (z0_lv, th_lv) = mu, logvar
        if eps is None:
            eps = tuple(torch.randn(lv.shape, generator=generator,
                                    device=lv.device, dtype=lv.dtype)
                        for lv in (z0_lv, th_lv))
        e0, e1 = eps
        return (z0_mu + e0 * torch.exp(z0_lv / 2),
                th_mu + e1 * torch.exp(th_lv / 2))

    def apply_latent_out(self, decoder: Decoder, l):
        z0_tilde, th_tilde = l
        lo_z0, lo_th = decoder.latent_out
        return lo_z0(z0_tilde), lo_th(th_tilde)

    def diffeq_layer(self, decoder: Decoder, l_hat, t, key=None):
        """Batched solve from per-sample (z0_hat, theta_hat); failed
        trajectories are NaN-filled (GOKU.jl:113-114, goku.py:142).
        ``SDEDynamics`` need ``key``: row b integrates the Brownian path of
        ``split(key, B)[b]`` (``key[b]`` for keys (B, 2)), adaptively or
        on the grid as ``de.adaptive``
        says (goku.py:110-129). ``use_kernel_solver`` names the RK kernel
        only, as ``use_pallas_solver`` does in JAX: the SDE branch comes
        first and never runs it. NN stages below float32 (bfloat16): the
        solve integrates in float32 and ``ys`` comes back in their dtype
        (goku.py:102-108, 145). A float64 model keeps its precision (the
        tests' float64 referees; they lift JAX's cast to match)."""
        z0_hat, th_hat = l_hat
        de = decoder.diffeq
        in_dtype = z0_hat.dtype
        solve_dtype = torch.promote_types(in_dtype, torch.float32)
        z0_hat, th_hat = z0_hat.to(solve_dtype), th_hat.to(solve_dtype)
        if isinstance(de, SDEDynamics):
            if key is None:
                raise ValueError("SDE dynamics require a PRNG `key` "
                                 "(pass key= to the model call)")
            key = jr.as_key(key, z0_hat.device)
            # keys (B, 2): a rank's rows of a data-parallel batch
            keys = key if key.dim() == 2 else jr.split(key, z0_hat.shape[0])
            if de.adaptive:
                ys, success, stats = solve_sde_adaptive(
                    de.f, de.g, de.solver, z0_hat, th_hat, t, keys,
                    cfg=de.adaptive_cfg)
            else:
                ys, success, stats = solve_sde_fixed_grid(
                    de.f, de.g, de.solver, z0_hat, th_hat, t, keys,
                    substeps=de.substeps)
        elif not isinstance(de, ODEDynamics):
            raise TypeError(f"GOKU's diffeq slot takes ODEDynamics or "
                            f"SDEDynamics, got {type(de).__name__}")
        elif self.use_kernel_solver and uses_fixed_grid(de.solver,
                                                        de.options):
            if de.options.interp_stride != 1:
                # the kernel has no strided mode; the JAX package's kernel
                # route ignores the option (goku.py:130-135), which would
                # change results, so the port refuses instead
                raise NotImplementedError(
                    "use_kernel_solver has no interp_stride > 1 mode; set "
                    "use_kernel_solver=False to solve it strided")
            ys, success, stats = solve_fixed_grid_batched(
                de.f, de.solver, z0_hat, th_hat, t,
                substeps=de.options.substeps)
        else:
            ys, success, stats = odeint(de.f, de.solver, z0_hat, th_hat, t,
                                        de.options, de.sensealg)
        ys = torch.where(success[:, None, None], ys,
                         torch.full_like(ys, float("nan")))
        if de.transform is not None:
            ys = de.transform(ys)
        ys = ys.to(in_dtype)
        aux = {"success": success,
               "stats": {k: v.sum() for k, v in stats.items()}}
        return ys, aux


@dataclasses.dataclass(frozen=True)
class GOKUBasic(GOKU):
    """The concrete default GOKU variant (reference: GOKU.jl:7)."""

    use_kernel_encoder: bool = False
    use_kernel_solver: bool = False


def goku_default_layers(input_dim: int, diffeq, *,
                        hidden_dim_resnet: int = 200,
                        rnn_input_dim: int = 32,
                        rnn_output_dim: int = 16,
                        latent_dim_z0: int = 16,
                        latent_dim_theta: int = 16,
                        latent_to_diffeq_dim: int = 200,
                        general_activation: Callable = nn.relu,
                        z0_activation: Callable = nn.identity,
                        theta_activation: Callable = nn.softplus,
                        output_activation: Callable = nn.sigmoid,
                        init=nn.default_init,
                        generator: Optional[torch.Generator] = None,
                        device=None, dtype=torch.float32):
    """Default GOKU architecture (reference: GOKU.jl:199-274). Returns
    ``(encoder_layers, decoder_layers)`` for
    ``LatentDiffEqModel.build(GOKUBasic(), ...)``.

    Weights are drawn on the CPU from ``generator`` (seed 0 when None), so
    a seed gives the same weights on every device, then moved to
    ``device`` (default: the card)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kw = dict(winit=init, generator=generator, dtype=dtype)
    z_dim, theta_dim = diffeq.z_dim, diffeq.theta_dim
    hidden = (rnn_output_dim, rnn_output_dim)

    feature_extractor = nn.resnet_mlp(
        input_dim, hidden_dim_resnet, rnn_input_dim, general_activation,
        general_activation, **kw)
    pattern_extractor = (
        nn.Recurrent.rnn(rnn_input_dim, hidden, nn.relu, **kw),
        nn.Recurrent.lstm(rnn_input_dim, hidden, **kw),
        nn.Recurrent.lstm(rnn_input_dim, hidden, **kw),
    )
    latent_in = (
        nn.Dense(rnn_output_dim, latent_dim_z0, **kw),
        nn.Dense(rnn_output_dim, latent_dim_z0, **kw),
        nn.Dense(rnn_output_dim * 2, latent_dim_theta, **kw),
        nn.Dense(rnn_output_dim * 2, latent_dim_theta, **kw),
    )
    latent_out = (
        nn.mlp((latent_dim_z0, latent_to_diffeq_dim, z_dim),
               general_activation, z0_activation, **kw),
        nn.mlp((latent_dim_theta, latent_to_diffeq_dim, theta_dim),
               general_activation, theta_activation, **kw),
    )
    reconstructor = nn.resnet_mlp(
        z_dim, hidden_dim_resnet, input_dim, general_activation,
        output_activation, **kw)

    encoder_layers = (feature_extractor.to(device),
                      tuple(h.to(device) for h in pattern_extractor),
                      tuple(d.to(device) for d in latent_in))
    decoder_layers = (tuple(m.to(device) for m in latent_out), diffeq,
                      reconstructor.to(device))
    return encoder_layers, decoder_layers
