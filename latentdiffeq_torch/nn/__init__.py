from .init import kaiming_uniform, glorot_uniform, zeros_init, default_init
from .layers import (Dense, Chain, SkipConnection, FrozenLinear, mlp,
                     resnet_mlp, identity, relu, softplus, sigmoid, tanh)
from .recurrent import RNNCell, LSTMCell, Recurrent, fused_goku_heads

__all__ = [
    "kaiming_uniform", "glorot_uniform", "zeros_init", "default_init",
    "Dense", "Chain", "SkipConnection", "FrozenLinear", "mlp", "resnet_mlp",
    "identity", "relu", "softplus", "sigmoid", "tanh",
    "RNNCell", "LSTMCell", "Recurrent", "fused_goku_heads",
]
