"""Forecasting: condition on the first frames, predict the whole horizon
(counterpart of examples/pendulum/forecast.py:29-62).

    python -m latentdiffeq_torch.examples.pendulum.forecast [--ckpt PATH]

Restores a GOKU checkpoint (the port's or the JAX package's, through the
port's loader; default ``OUTPUT_DIR/best_model.npz``, train_goku.py's),
encodes only the first ``--context`` frames of each validation video,
integrates the inferred dynamics over all 100 frames (``model.forecast``)
and prints the reconstruction error inside and beyond the context, as the
JAX script does. The model runs the hand-written kernels;
``--device cpu`` runs their plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import os

import torch

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.examples.pendulum.create_data import load_or_generate
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.pendulum import Pendulum
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.train import TrainConfig, Trainer, splitobs

__all__ = ["OUTPUT_DIR", "build_parser", "forecast_errors", "main"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint (default OUTPUT_DIR/best_model.npz)")
    ap.add_argument("--context", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


@torch.no_grad()
def forecast_errors(model, val_set, context: int):
    """Per-frame mean squared error (over videos and pixels) of
    ``model.forecast`` from the first ``context`` frames over the whole
    horizon of ``val_set`` (n, T, pixels) on the dataset's 0.05 s grid;
    returns ``(err (T,), x_hat)``."""
    dev = next(model.parameters()).device
    xv = torch.as_tensor(val_set, dtype=torch.float32).to(dev)
    t_full = torch.arange(xv.shape[1], dtype=torch.float32,
                          device=dev) * 0.05
    x_hat, _, _ = model.forecast(xv[:, :context], t_full)
    err = torch.mean((xv - x_hat.float()) ** 2, dim=(0, 2))
    return err.double().cpu().numpy(), x_hat


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    ckpt = args.ckpt or os.path.join(OUTPUT_DIR, "best_model.npz")

    latent, u0s, ps, frames = load_or_generate(device=dev)
    x = frames.reshape(frames.shape[0], frames.shape[1], -1)
    _, val_set = splitobs(x, 0.9)
    full_len = x.shape[1]

    diffeq = Pendulum(options=make_options(adaptive=False, substeps=1))
    enc, dec = goku_default_layers(
        x.shape[-1], diffeq, generator=torch.Generator().manual_seed(333),
        device=dev)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc, dec)
    tr = Trainer(model, TrainConfig(), device=dev)
    tr.restore(ckpt)

    err, _ = forecast_errors(tr.model, val_set, args.context)
    inside = err[:args.context].mean()
    beyond = err[args.context:].mean()
    print(f"per-pixel MSE inside context (frames 0-{args.context - 1}): "
          f"{inside:.5f}")
    print(f"per-pixel MSE beyond context (frames {args.context}-"
          f"{full_len - 1}): {beyond:.5f}")
    print(f"degradation factor: {beyond / inside:.2f}x")
    return {"inside": float(inside), "beyond": float(beyond), "err": err}


if __name__ == "__main__":
    main()
