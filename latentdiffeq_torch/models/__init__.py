from .template import LatentDiffEqModel, Encoder, Decoder, ModelType
from .dynamics import ODEDynamics
from .goku import GOKU, GOKUBasic, goku_default_layers

__all__ = ["LatentDiffEqModel", "Encoder", "Decoder", "ModelType",
           "ODEDynamics", "GOKU", "GOKUBasic", "goku_default_layers"]
