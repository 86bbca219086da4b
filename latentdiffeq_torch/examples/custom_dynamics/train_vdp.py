"""GOKU on Van der Pol trajectories with learned mu (counterpart of
examples/custom_dynamics/train_vdp.py:25-86).

    python -m latentdiffeq_torch.examples.custom_dynamics.train_vdp --epochs 2

The observations are a fixed random linear + relu lift of the 2-d state
to ``--input-dim`` channels. GOKU at the JAX example's widths
(``hidden_dim_resnet=100``, ``latent_to_diffeq_dim=100``) and
``TrainConfig``, with the hand-written kernels on (the encoder's heads and
the RK solve's Van der Pol functor); the best checkpoint goes to
``OUTPUT_DIR/best_model.npz``. The JAX script's flags and defaults, and
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). A
seed draws other initial weights than JAX's (torch's generator).

``make_data`` makes what JAX's ``make_data`` makes: the same numpy draws,
the ODE solved adaptively at the solver's defaults (rtol 1e-3, atol 1e-6;
JAX's passes no options), the stochastic one on the grid with 4 sub-steps
(``custom_data.make_vdp_data``). The returned dynamics train on the grid
with 4 sub-steps, as JAX's do.
"""
from __future__ import annotations

import argparse
import os

import torch

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.custom_data import make_vdp_data
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.train import TrainConfig, Trainer, splitobs

__all__ = ["OUTPUT_DIR", "make_data", "build_parser", "main"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output_vdp")


def make_data(n_traj=256, T=100, dt=0.1, input_dim=64, seed=0,
              mu_max=2.0, stochastic_sigma=0.0, device=None):
    """``(x (n, T, input_dim), z (n, T, 2), mus (n, 1), vdp)`` on
    ``device`` (train_vdp.py:25-64): mu ~ U(0.5, mu_max) (2 keeps it weakly
    nonlinear, 4 reaches relaxation oscillations); ``stochastic_sigma >
    0`` draws the multiplicative-noise SDE and returns its spec."""
    options = make_options() if stochastic_sigma == 0.0 else None
    return make_vdp_data(n_traj=n_traj, T=T, dt=dt, input_dim=input_dim,
                         seed=seed, mu_max=mu_max,
                         stochastic_sigma=stochastic_sigma, device=device,
                         options=options)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--input-dim", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the model trains")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    x, z, mus, vdp = make_data(input_dim=args.input_dim, device=dev)
    train_set, val_set = splitobs(x, 0.9)

    enc, dec = goku_default_layers(
        args.input_dim, vdp, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
        generator=torch.Generator().manual_seed(0), device=dev)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc, dec)
    cfg = TrainConfig(epochs=args.epochs, batch_size=64, seq_len=50,
                      dt=0.1, seed=7, checkpoint_dir=OUTPUT_DIR)
    trainer = Trainer(model, cfg, device=dev)
    trainer.fit(train_set, val_set)
    return trainer


if __name__ == "__main__":
    main()
