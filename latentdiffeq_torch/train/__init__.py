from .losses import kl, vector_kl, vector_mse, reconstruction_loss, loss_batch
from .annealing import frange_cycle_linear
from .data import (normalize_to_unit_segment, denormalize_unit_segment,
                   rand_time, time_loader, splitobs, sample_window,
                   DataLoader)
from .optim import (FluxAdam, Optimizer, adam, adamw, adabelief, sgd,
                    apply_updates, clip_by_global_norm, chain)
from .checkpoint import (jax_param_paths, load_jax_params, save_checkpoint,
                         load_checkpoint)
from .trainer import TrainConfig, Trainer, make_block_fn
from .multiseed import MultiSeedTrainer, StackedModels
from .selectors import (temporal_agreement, observation_forecast_scores,
                        observation_composite_scores, combine_composite)
from .visualize import visualize_val_image
from .warm_start import latent_warm_start
from . import selectors

__all__ = [
    "kl", "vector_kl", "vector_mse", "reconstruction_loss", "loss_batch",
    "frange_cycle_linear", "normalize_to_unit_segment",
    "denormalize_unit_segment", "rand_time", "time_loader", "splitobs",
    "sample_window", "DataLoader",
    "FluxAdam", "Optimizer", "adam", "adamw", "adabelief", "sgd",
    "apply_updates", "clip_by_global_norm", "chain",
    "jax_param_paths", "load_jax_params",
    "save_checkpoint", "load_checkpoint", "TrainConfig", "Trainer",
    "make_block_fn",
    "MultiSeedTrainer", "StackedModels",
    "temporal_agreement", "observation_forecast_scores",
    "observation_composite_scores", "combine_composite",
    "visualize_val_image", "latent_warm_start", "selectors",
]
