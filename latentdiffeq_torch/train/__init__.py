from .losses import kl, vector_kl, vector_mse, reconstruction_loss, loss_batch
from .annealing import frange_cycle_linear
from .data import (normalize_to_unit_segment, denormalize_unit_segment,
                   rand_time, time_loader, splitobs, sample_window,
                   DataLoader)
from .optim import FluxAdam, adam, adamw
from .checkpoint import (jax_param_paths, load_jax_params, save_checkpoint,
                         load_checkpoint)
from .trainer import TrainConfig, Trainer
from .multiseed import MultiSeedTrainer, StackedModels
from .warm_start import latent_warm_start
from . import selectors

__all__ = [
    "kl", "vector_kl", "vector_mse", "reconstruction_loss", "loss_batch",
    "frange_cycle_linear", "normalize_to_unit_segment",
    "denormalize_unit_segment", "rand_time", "time_loader", "splitobs",
    "sample_window", "DataLoader",
    "FluxAdam", "adam", "adamw", "jax_param_paths", "load_jax_params",
    "save_checkpoint", "load_checkpoint", "TrainConfig", "Trainer",
    "MultiSeedTrainer", "StackedModels", "latent_warm_start", "selectors",
]
