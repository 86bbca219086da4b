from .template import LatentDiffEqModel, Encoder, Decoder, ModelType
from .dynamics import ODEDynamics, SDEDynamics, NeuralODEDynamics
from .goku import GOKU, GOKUBasic, goku_default_layers
from .latent_ode import LatentODE, latent_ode_default_layers, NODE

__all__ = ["LatentDiffEqModel", "Encoder", "Decoder", "ModelType",
           "ODEDynamics", "SDEDynamics", "NeuralODEDynamics", "GOKU",
           "GOKUBasic", "goku_default_layers", "LatentODE",
           "latent_ode_default_layers", "NODE", "default_layers"]


def default_layers(model_type, input_dim, diffeq, **kwargs):
    """Dispatcher mirroring the reference's
    ``default_layers(model_type, input_dim, diffeq; ...)``
    (reference: GOKU.jl:199, LatentODE.jl:100)."""
    if isinstance(model_type, GOKU):
        return goku_default_layers(input_dim, diffeq, **kwargs)
    if isinstance(model_type, LatentODE):
        return latent_ode_default_layers(input_dim, diffeq, **kwargs)
    raise ValueError(f"no default layers for model type {model_type}")
