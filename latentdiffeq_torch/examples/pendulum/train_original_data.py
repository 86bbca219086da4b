"""GOKU on the GOKU-net paper's pendulum dataset (counterpart of
examples/pendulum/train_original_data.py:33-70; reference:
model_train_original_data.jl).

    python -m latentdiffeq_torch.examples.pendulum.train_original_data \\
        --data /path/to/processed_data.npz

The paper's data (Linial et al. 2020), min-max normalised, trained with a
small fixed beta (no annealing: start = end = ``--beta``, one flat cycle,
model_train_original_data.jl:44-45), plain Flux ADAM, 900 epochs, seed 3;
the best checkpoint goes to ``OUTPUT_DIR/best_model.npz``. The data comes
from a local npz only (the reference's figshare file is not fetched):
``train_data`` of shape (n, T, 28, 28) or (n, T, 784) float frames. The
JAX script's flags and defaults, and ``--device`` (default ``cuda``); the
model runs the hand-written kernels. A seed draws other initial weights
than JAX's (torch's generator, not threefry).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.train import (TrainConfig, Trainer, adam,
                                      normalize_to_unit_segment, splitobs)

__all__ = ["OUTPUT_DIR", "build_parser", "main"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output_original")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="npz with train_data (n, T, 28*28)")
    ap.add_argument("--epochs", type=int, default=900)
    ap.add_argument("--beta", type=float, default=1e-5)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the model trains")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    with np.load(args.data) as d:
        x = d["train_data"].astype(np.float32)
    if x.ndim == 4:
        x = x.reshape(x.shape[0], x.shape[1], -1)
    # min-max normalise (model_train_original_data.jl:89)
    x, lo, hi = normalize_to_unit_segment(x)
    train_set, val_set = splitobs(x, 0.9)

    diffeq = Pendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(
        x.shape[-1], diffeq,
        generator=torch.Generator().manual_seed(args.seed), device=dev)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc, dec)

    # a fixed tiny beta: start == end == beta, one flat cycle
    cfg = TrainConfig(lr=args.lr, epochs=args.epochs, seed=args.seed,
                      seq_len=min(args.seq_len, x.shape[1]),
                      batch_size=args.batch_size,
                      start_beta=args.beta, end_beta=args.beta, n_cycle=1,
                      ratio=0.5, checkpoint_dir=OUTPUT_DIR)
    trainer = Trainer(model, cfg, optimizer=adam(lr=args.lr), device=dev)
    trainer.fit(train_set, val_set)
    return trainer


if __name__ == "__main__":
    main()
