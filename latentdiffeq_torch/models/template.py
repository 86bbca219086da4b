"""The latent-DE model template: Encoder -> sample -> Decoder (counterpart
of latentdiffeq/models/template.py).

Six user-swappable slots (encoder = feature_extractor -> pattern_extractor
-> latent_in; decoder = latent_out -> diffeq -> reconstructor) whose
behaviour dispatches on a model-type object with seven hooks
(reference: src/models/LatentDiffEqModel.jl). Data layout is (batch, time,
features). Randomness is explicit: a ``torch.Generator`` for the
reparameterisation noise, or the noise itself (``eps``), and for SDE
dynamics a PRNG ``key`` (latentdiffeq_torch.random) for the Brownian
path.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

__all__ = ["LatentDiffEqModel", "Encoder", "Decoder", "ModelType"]


def _slot(layer):
    """Tuples of layers (e.g. GOKU's three recurrent heads) become
    ModuleLists so their parameters register in order."""
    if isinstance(layer, (tuple, list)):
        return nn.ModuleList(_slot(x) for x in layer)
    return layer


def _noise_widths(model):
    """The widths of the reparameterisation noise in the order
    ``model_type.sample`` draws it: the output widths of the logvar heads,
    every second layer of ``latent_in`` (GOKU: z0 and theta; LatentODE:
    one). A tuple for several groups, else an int."""
    li = model.encoder.latent_in
    heads = list(li) if isinstance(li, torch.nn.ModuleList) else [li]
    widths = tuple(h.out_dim for h in heads[1::2])
    return widths if len(widths) > 1 else widths[0]


def _noise_dtype(model):
    """The dtype ``model_type.sample`` draws the noise in: the logvar
    heads' (bfloat16 for bf16 NN stages, as JAX draws it)."""
    li = model.encoder.latent_in
    head = list(li)[1] if isinstance(li, torch.nn.ModuleList) else li
    return head.W.dtype


class ModelType:
    """Base for model-type tags; subclasses implement the hooks."""

    def apply_feature_extractor(self, encoder: "Encoder", x):
        return encoder.feature_extractor(x)

    def apply_pattern_extractor(self, encoder: "Encoder", fe_out,
                                cur_len=None):
        raise NotImplementedError

    def apply_latent_in(self, encoder: "Encoder", pe_out):
        raise NotImplementedError

    def sample(self, mu, logvar, generator=None, eps=None):
        raise NotImplementedError

    def apply_latent_out(self, decoder: "Decoder", l):
        raise NotImplementedError

    def diffeq_layer(self, decoder: "Decoder", l_hat, t, key=None):
        """Returns (z_traj, aux): z_traj (batch, time, z_dim); aux carries
        per-sample ``success`` and summed solver ``stats``. ``key``: the
        Brownian path of SDE dynamics."""
        raise NotImplementedError

    def apply_reconstructor(self, decoder: "Decoder", z):
        return decoder.reconstructor(z)


class Encoder(nn.Module):
    def __init__(self, feature_extractor, pattern_extractor, latent_in,
                 model_type: ModelType):
        super().__init__()
        self.feature_extractor = _slot(feature_extractor)
        self.pattern_extractor = _slot(pattern_extractor)
        self.latent_in = _slot(latent_in)
        self.model_type = model_type

    def forward(self, x, cur_len=None):
        mt = self.model_type
        fe_out = mt.apply_feature_extractor(self, x)
        pe_out = mt.apply_pattern_extractor(self, fe_out, cur_len=cur_len)
        return mt.apply_latent_in(self, pe_out)


class Decoder(nn.Module):
    def __init__(self, latent_out, diffeq, reconstructor,
                 model_type: ModelType):
        super().__init__()
        self.latent_out = _slot(latent_out)
        # a static spec (ODEDynamics) or a module whose weights register
        # here, between latent_out's and the reconstructor's
        # (NeuralODEDynamics)
        self.diffeq = diffeq
        self.reconstructor = _slot(reconstructor)
        self.model_type = model_type

    def forward(self, l, t, key=None):
        mt = self.model_type
        l_hat = mt.apply_latent_out(self, l)
        z, aux = mt.diffeq_layer(self, l_hat, t, key=key)
        x_hat = mt.apply_reconstructor(self, z)
        return (x_hat, z, l_hat), aux


class LatentDiffEqModel(nn.Module):
    """``model(x, t, variational=..., generator=..., key=...)`` ->
    ``((x_hat, z_hat, l_hat), mu, logvar, aux)``."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 model_type: ModelType):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.model_type = model_type

    @staticmethod
    def build(model_type, encoder_layers, decoder_layers
              ) -> "LatentDiffEqModel":
        fe, pe, li = encoder_layers
        lo, de, re = decoder_layers
        return LatentDiffEqModel(Encoder(fe, pe, li, model_type),
                                 Decoder(lo, de, re, model_type), model_type)

    def forward(self, x, t, *, variational: bool = False,
                generator: Optional[torch.Generator] = None,
                eps: Any = None, cur_len=None, key=None):
        """``eps`` (optional): the reparameterisation noise itself, in the
        structure of ``mu``, in place of drawing it from ``generator``.
        ``cur_len``: masked-curriculum mode, encode only the first
        ``cur_len`` frames (the loss masks the rest). ``key``: the decoder's
        PRNG key, the Brownian path of SDE dynamics (the JAX model's
        ``dkey``: ``split(key)[1]`` when variational, else ``key``)."""
        mu, logvar = self.encoder(x, cur_len=cur_len)
        if variational:
            l = self.model_type.sample(mu, logvar, generator=generator,
                                       eps=eps)
        else:
            l = mu
        out, aux = self.decoder(l, t, key=key)
        return out, mu, logvar, aux

    def forecast(self, x_context, t, key=None):
        """Encode a context window, decode over any (longer) grid ``t``.
        Returns ``(x_hat, z_hat, l_hat)``."""
        out, _, _, _ = self(x_context, t, variational=False, key=key)
        return out
