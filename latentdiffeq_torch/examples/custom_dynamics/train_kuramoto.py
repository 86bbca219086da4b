"""GOKU on Kuramoto phase oscillators with learned (omega, K) (counterpart
of examples/custom_dynamics/train_kuramoto.py:37-208).

    python -m latentdiffeq_torch.examples.custom_dynamics.train_kuramoto \\
        --epochs 2

The latent state is the 10 phases, observed through ``transform=sin``; the
data are a fixed random linear + relu lift of sin(phases) to
``--input-dim`` channels. GOKU at the JAX example's widths
(``hidden_dim_resnet=100``, ``latent_to_diffeq_dim=100``) and
``TrainConfig`` (the identification recipe's KL ceiling: ``end_beta=0.01``,
one cycle), with the hand-written kernels on (the encoder's heads and the
RK solve's Kuramoto<10> functor); the best checkpoint goes to
``OUTPUT_DIR/best_model.npz``. The JAX script's flags and defaults, and
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path). A
seed draws other initial weights than JAX's (torch's generator).

``make_data`` makes what JAX's ``make_data`` makes: the same numpy draws,
solved adaptively at the solver's defaults (JAX's passes no options); the
returned dynamics train on the grid with 4 sub-steps. The host-side
readout helpers (``invert_lift_phases``, ``fit_lift_readout``,
``estimate_omega_k``) are numpy, as in JAX.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.custom_data import make_kuramoto_data
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.solve import make_options
from latentdiffeq_torch.train import TrainConfig, Trainer, splitobs

__all__ = ["OUTPUT_DIR", "make_data", "build_parser", "main",
           "invert_lift_phases", "fit_lift_readout", "estimate_omega_k"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output_kuramoto")


def make_data(n_traj=256, T=100, dt=0.1, n_osc=10, input_dim=64, seed=0,
              omega_range=(1.0, 3.0), k_range=(0.2, 2.0),
              omega_spread: float = 0.0, return_lift: bool = False,
              device=None):
    """``(x, z_sin, thetas, kur)`` (and the lift ``{W, b, mn, mx}`` with
    ``return_lift``) on ``device`` (train_kuramoto.py:37-86): per-row omega
    ~ U(omega_range), K ~ U(k_range), phases ~ U(-pi, pi);
    ``omega_spread > 0`` fixes the offsets linspace(-spread, spread, N)."""
    return make_kuramoto_data(
        n_traj=n_traj, T=T, dt=dt, n_osc=n_osc, input_dim=input_dim,
        seed=seed, omega_range=omega_range, k_range=k_range,
        omega_spread=omega_spread, return_lift=return_lift, device=device,
        options=make_options())


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
    x, z_sin, thetas, kur = make_data(input_dim=args.input_dim, device=dev)
    train_set, val_set = splitobs(x, 0.9)

    enc, dec = goku_default_layers(
        args.input_dim, kur, hidden_dim_resnet=100, latent_to_diffeq_dim=100,
        generator=torch.Generator().manual_seed(0), device=dev)
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True), enc, dec)
    cfg = TrainConfig(epochs=args.epochs, batch_size=64, seq_len=50,
                      dt=0.1, seed=7,
                      # the custom-dynamics identification recipe: a tiny
                      # KL ceiling
                      start_beta=0.0, end_beta=0.01, n_cycle=1,
                      checkpoint_dir=OUTPUT_DIR)
    trainer = Trainer(model, cfg, device=dev)
    trainer.fit(train_set, val_set)
    return trainer


def invert_lift_phases(x, lift, dt=0.1):
    """Unsupervised per-frame inversion of the known observation map, then
    the branch of each phase from time (train_kuramoto.py:116-153): each
    frame's sin-phases solve a least-squares system on its relu-active
    channels; phi vs pi - phi is fixed by the sign of d(sin)/dt (phases
    advance at omega > 0, so sign(cos phi) = sign(d sin / dt)). Returns
    ``(phi (n, T, N) unwrapped phases, omega_hat (n,))``, the median phase
    rate of each trajectory."""
    W, b = lift["W"], lift["b"]
    n_osc = W.shape[0]
    Y = np.asarray(x) * (lift["mx"] - lift["mn"]) + lift["mn"]
    n, T, _ = Y.shape
    Z = np.empty((n, T, n_osc), np.float64)
    for i in range(n):
        for t in range(T):
            y = Y[i, t]
            a = y > 1e-6
            if a.sum() < n_osc:
                a = np.ones_like(a, bool)
            Z[i, t] = np.linalg.lstsq(W[:, a].T, y[a] - b[a], rcond=None)[0]
    s = np.clip(Z, -1.0, 1.0)
    cos_sign = np.sign(np.gradient(s, axis=1))
    cos_sign[cos_sign == 0] = 1.0
    phi = np.unwrap(np.arctan2(s, cos_sign * np.sqrt(1.0 - s ** 2)), axis=1)
    omega_hat = np.median(np.diff(phi, axis=1), axis=(1, 2)) / dt
    return phi.astype(np.float32), omega_hat.astype(np.float32)


def fit_lift_readout(lift, n_samples=8192, seed=0, lam=1e-3):
    """A frame-wise readout of sin-phases from observations derived from
    the known lift alone (train_kuramoto.py:156-182): random phases pushed
    through the map, then a ridge fit of the inverse. Returns ``(R, c)``
    with ``readout(x) = x @ R.T + c``, the sin-phases in the oscillators'
    order."""
    W, b = lift["W"], lift["b"]
    n_osc = W.shape[0]
    rng = np.random.default_rng(seed)
    u = np.sin(rng.uniform(-np.pi, np.pi, (n_samples, n_osc)))
    y = np.maximum(u @ W + b, 0.0)
    y = (y - lift["mn"]) / (lift["mx"] - lift["mn"])
    ym, um = y.mean(0), u.mean(0)
    yc = y - ym
    Rt = np.linalg.solve(yc.T @ yc + lam * np.eye(y.shape[1]),
                         yc.T @ (u - um))               # (input_dim, n_osc)
    R = Rt.T
    c = um - ym @ Rt
    return R.astype(np.float32), c.astype(np.float32)


def estimate_omega_k(phi, deltas, dt=0.1):
    """Per-trajectory (omega, K) by least squares on the known dynamics
    (train_kuramoto.py:185-208): dphi_i/dt - delta_i = omega + K c_i(t),
    c_i = (1/N) sum_j sin(phi_j - phi_i) at the interval midpoints, a
    2-column fit a trajectory. ``phi`` (n, T, N) unwrapped phases,
    ``deltas`` (N,) the fixed frequency offsets. Returns ``(omega_hat,
    k_hat)``, each (n,)."""
    n, T, N = phi.shape
    dphi = np.diff(phi, axis=1) / dt                    # (n, T-1, N)
    mid = 0.5 * (phi[:, 1:] + phi[:, :-1])
    diff = mid[..., None, :] - mid[..., :, None]        # phi_j - phi_i
    c = np.sin(diff).sum(-1) / N                        # (n, T-1, N)
    om = np.empty(n, np.float64)
    kk = np.empty(n, np.float64)
    for i in range(n):
        y = (dphi[i] - np.asarray(deltas)[None, :]).ravel()
        A = np.stack([np.ones_like(c[i].ravel()), c[i].ravel()], 1)
        om[i], kk[i] = np.linalg.lstsq(A, y, rcond=None)[0]
    return om.astype(np.float32), kk.astype(np.float32)


if __name__ == "__main__":
    main()
