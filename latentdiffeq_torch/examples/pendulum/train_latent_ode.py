"""Latent ODE on pendulum video (counterpart of
examples/pendulum/train_latent_ode.py:24-83; reference:
model_train_LatentODE.jl).

    python -m latentdiffeq_torch.examples.pendulum.train_latent_ode \\
        --pallas-solve --epochs 2

The GOKU script's skeleton with ``LatentODE``, a 16-dim neural vector field
(``NODE(16)``), decay 1e-4 and seed 1; the best checkpoint goes to
``OUTPUT_DIR/best_model.npz``. The JAX script's flags and defaults, and
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
``--pallas-solve`` keeps JAX's name so that its command lines carry over:
here it selects ``LatentODE(use_kernel_solve=True)``, the neural-field
solve and its gradients in the hand-written CUDA kernels
(ops/node_cuda.py), also for a population (``--seeds``). A seed draws
other initial weights than JAX's (torch's generator, not threefry).
"""
from __future__ import annotations

import argparse
import os

import torch

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.examples.pendulum.create_data import load_or_generate
from latentdiffeq_torch.models import (LatentDiffEqModel, LatentODE, NODE,
                                       latent_ode_default_layers)
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig, Trainer,
                                      splitobs)

__all__ = ["OUTPUT_DIR", "build_parser", "main"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output_latent_ode")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--decay", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--latent-dim", type=int, default=16)
    ap.add_argument("--augment-dim", type=int, default=0,
                    help="augmented NODE (the reference shows NODE(2, "
                         "augment_dim=2), model_train_LatentODE.jl:36)")
    ap.add_argument("--pallas-solve", action="store_true",
                    help="run the neural-field solve and its gradients in "
                         "the hand-written CUDA kernels (node_field.cu; "
                         "JAX's flag name, where it is one Pallas kernel)")
    ap.add_argument("--seeds", type=int, default=0, metavar="S",
                    help="population training: S seeds at once, keep the "
                         "argmin-validation replica (0 = single seed)")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the model trains")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.seeds and args.resume:
        ap.error("--seeds is incompatible with --resume")
    dev = resolve_device(args.device)

    latent, u0s, ps, frames = load_or_generate(device=dev)
    x = frames.reshape(frames.shape[0], frames.shape[1], -1)
    train_set, val_set = splitobs(x, 0.9)
    input_dim = x.shape[-1]
    model_type = LatentODE(use_kernel_solve=args.pallas_solve)

    def build(seed):
        g = torch.Generator().manual_seed(seed)
        diffeq = NODE(args.latent_dim, augment_dim=args.augment_dim,
                      options=make_options(adaptive=False, substeps=1),
                      generator=g, device=dev)
        enc, dec = latent_ode_default_layers(input_dim, diffeq,
                                             generator=g, device=dev)
        return LatentDiffEqModel.build(model_type, enc, dec)

    cfg = TrainConfig(lr=args.lr, decay=args.decay,
                      batch_size=args.batch_size, seq_len=args.seq_len,
                      epochs=args.epochs, seed=args.seed,
                      checkpoint_dir=OUTPUT_DIR)

    if args.seeds:
        seeds = list(range(args.seed, args.seed + args.seeds))
        ms = MultiSeedTrainer(build, cfg, seeds, device=dev)
        ms.fit(train_set, val_set)
        print(f"winner: seed {ms.best_seed} (val {ms.best_val_loss:.4f}) "
              f"-> {cfg.checkpoint_dir}/best_model.npz")
        return ms

    trainer = Trainer(build(args.seed), cfg, device=dev)
    if args.resume:
        trainer.restore(args.resume)
    trainer.fit(train_set, val_set)
    return trainer


if __name__ == "__main__":
    main()
