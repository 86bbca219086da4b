"""GOKU-net pendulum tutorial — build every layer by hand.

The runnable counterpart of examples/tutorial/tutorial.py in the PyTorch
port (and of the reference's 46-cell tutorial notebook): what a GOKU-net
is, how the pendulum video data is made, every encoder/decoder layer built
and shape-checked by hand (reference cells 19-33), one manual forward
through each stage, the annealed ELBO loss, a live training run (cells
37-45), and the standard visualization figure.

`latentdiffeq_torch.models.goku_default_layers` + `Trainer` do all of this
for you in four lines — walk `main` top to bottom to see exactly what they
do.

Run: python -m latentdiffeq_torch.examples.tutorial.tutorial [--epochs N]
[--device cpu] (seconds an epoch on the card; figures are written with
Pillow into this folder's output/). `make_notebook.py` turns it into an
executed .ipynb.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import latentdiffeq_torch as ldq
from latentdiffeq_torch import nn
from latentdiffeq_torch import random as jr
from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.examples.pendulum.create_data import load_or_generate
from latentdiffeq_torch.models import GOKUBasic, LatentDiffEqModel
from latentdiffeq_torch.train import (Trainer, TrainConfig,
                                      frange_cycle_linear, load_checkpoint,
                                      loss_batch, splitobs)
from latentdiffeq_torch.train.visualize import visualize_val_image

__all__ = ["OUTPUT_DIR", "CHECKPOINT", "build_parser", "main"]

HERE = os.path.dirname(os.path.abspath(__file__))
OUTPUT_DIR = os.path.join(HERE, "output")
CHECKPOINT = os.path.normpath(os.path.join(
    HERE, "..", "..", "..", "benchmarks", "artifacts", "goku_best_model.npz"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=150,
                    help="training epochs of section 13")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the model runs")
    return ap


def save_lines(path, title, series, labels=None):
    """A line plot of each of ``series`` (1-D arrays) on shared axes, drawn
    with Pillow."""
    from PIL import Image, ImageDraw

    W, H, pad = 640, 240, 30
    img = Image.new("RGB", (W, H), "white")
    g = ImageDraw.Draw(img)
    g.rectangle((pad, pad, W - pad, H - pad), outline="black")
    g.text((pad, 8), title, fill="black")
    v = np.concatenate([np.asarray(s, np.float64).ravel() for s in series])
    v = v[np.isfinite(v)]
    lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
    span = hi - lo if hi > lo else 1.0
    colors = [(75, 0, 130), (255, 140, 0), (34, 139, 34), (30, 144, 255)]
    for k, s in enumerate(series):
        s = np.asarray(s, np.float64).ravel()
        n = max(len(s) - 1, 1)
        pts = [(pad + (W - 2 * pad) * i / n,
                H - pad - (H - 2 * pad) * (a - lo) / span)
               for i, a in enumerate(s) if np.isfinite(a)]
        if len(pts) > 1:
            g.line(pts, fill=colors[k % len(colors)], width=2)
        if labels:
            g.text((W - pad - 120, pad + 4 + 12 * k), labels[k],
                   fill=colors[k % len(colors)])
    g.text((pad, H - pad + 6), f"[{lo:.3g}, {hi:.3g}]", fill="gray")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img.save(path)
    return path


def save_strip(path, frames):
    """Frames (k, h, w) in [0, 1] side by side, light on dark, enlarged."""
    from PIL import Image

    strip = np.concatenate(list(frames), axis=1)
    img = Image.fromarray((np.clip(strip, 0, 1) * 255).round()
                          .astype(np.uint8))
    img = img.resize((img.width * 4, img.height * 4), Image.NEAREST)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img.save(path)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    figures = []

    # ---------------------------------------------------------------------
    # 1. What a GOKU-net is.
    #
    # A GOKU-net (Linial et al. 2020) is a VAE whose latent space is
    # governed by a KNOWN mechanistic differential equation with UNKNOWN
    # per-sample parameters. For pendulum videos: the encoder watches
    # frames and infers both the initial state (angle, velocity) AND the
    # pendulum length L; the decoder solves the pendulum ODE forward and
    # renders frames back. The physics is the inductive bias — the model
    # identifies interpretable mechanistic parameters from pixels.
    # (reference notebook cells 1-5)
    # ---------------------------------------------------------------------
    G = 10.0

    def pendulum_f(u, p, t):
        # du1 = u2 ; du2 = -G/L sin(u1), with theta = [L] learned per
        # sample; u (..., 2) and p (..., 1) batch over their leading axes
        return torch.stack([u[..., 1], -G / p[..., 0] * torch.sin(u[..., 0])],
                           dim=-1)

    diffeq = ldq.models.ODEDynamics(
        f=pendulum_f, z_dim=2, theta_dim=1,
        solver=ldq.Tsit5(),
        sensealg=ldq.Unrolled(),                   # discretize-then-optimize
        options=ldq.make_options(adaptive=False, substeps=1),
    )
    print(f"latent ODE state dim {diffeq.z_dim}, mechanistic params "
          f"{diffeq.theta_dim} (the unknown length L)")

    # ---------------------------------------------------------------------
    # 2. Data: 450 videos of 100 28x28 frames (reference cells 7-13).
    #
    # Each trajectory draws L ~ U(1, 2) and u0 ~ U; the ODE ensemble is
    # solved adaptively on the device and every state is rasterized to a
    # 28x28 frame by the anti-aliased rod renderer (the Luxor role). NOTE
    # the rendered rod length is FIXED at 19 px — L is recoverable from the
    # DYNAMICS only (the oscillation frequency ~ sqrt(G/L)), which is
    # exactly what makes this an identification benchmark and not a
    # geometry-reading task. The dataset is cached (create_data.py).
    # ---------------------------------------------------------------------
    latent, u0s, ps, frames = load_or_generate(device=dev)
    x = frames.reshape(frames.shape[0], frames.shape[1], -1)
    train_set, val_set = splitobs(x, 0.9)
    input_dim = x.shape[-1]
    print(f"frames {frames.shape} -> flattened {x.shape}; "
          f"train {train_set.shape[0]}, val {val_set.shape[0]}")
    print(f"L range: [{ps.min():.2f}, {ps.max():.2f}]")

    # ---------------------------------------------------------------------
    # 2b. Look at the data: one trajectory, every 12th frame. The rod length
    #     on screen never changes — only the swing dynamics carry L.
    # ---------------------------------------------------------------------
    figures.append(save_strip(os.path.join(OUTPUT_DIR, "trajectory_0.png"),
                              frames[0, ::12][:8]))
    print(f"trajectory 0: L = {float(ps[0, 0]):.2f} -> {figures[-1]}")

    # ---------------------------------------------------------------------
    # 3. Encoder stage 1 — the feature extractor (reference cells 19-21).
    #
    # A framewise "resnet MLP": pixels -> 200 -> (+skip) -> (+skip) -> 32.
    # It runs on every frame independently (one big batched product),
    # compressing 784 pixels to a 32-dim feature per frame. Weights are
    # drawn on the CPU from one seeded generator, then moved to the device.
    # ---------------------------------------------------------------------
    gen = torch.Generator().manual_seed(333)
    init = nn.default_init      # kaiming_uniform(gain=1/sqrt(3)), Flux's
    kw = dict(winit=init, generator=gen)

    hidden, rnn_in, rnn_out, latent_dim = 200, 32, 16, 16

    feature_extractor = nn.Chain([
        nn.Dense(input_dim, hidden, nn.relu, **kw),
        nn.SkipConnection(nn.Dense(hidden, hidden, nn.relu, **kw)),
        nn.SkipConnection(nn.Dense(hidden, hidden, nn.relu, **kw)),
        nn.Dense(hidden, rnn_in, nn.relu, **kw),
    ]).to(dev)

    xb_demo = torch.as_tensor(train_set[:4, :50], device=dev)  # (4, 50, 784)
    fe_out = feature_extractor(xb_demo)
    print(f"feature extractor: {tuple(xb_demo.shape)} -> "
          f"{tuple(fe_out.shape)}")
    assert fe_out.shape == (4, 50, rnn_in)

    # ---------------------------------------------------------------------
    # 4. Encoder stage 2 — the pattern extractor (reference cells 22-24).
    #
    # Two recurrences, run where their information lives:
    # - z0 head: a stacked RNN over the REVERSED sequence — its last state
    #   has seen frame 0 most recently, right where the initial state is.
    # - theta head: a bidirectional stacked LSTM — L is a property of the
    #   WHOLE swing, so both directions' final states are concatenated.
    # ---------------------------------------------------------------------
    pe_z0 = nn.Recurrent.rnn(rnn_in, (rnn_out, rnn_out), nn.relu,
                             **kw).to(dev)
    pe_theta_fwd = nn.Recurrent.lstm(rnn_in, (rnn_out, rnn_out), **kw).to(dev)
    pe_theta_bwd = nn.Recurrent.lstm(rnn_in, (rnn_out, rnn_out), **kw).to(dev)

    z0_feat = pe_z0(fe_out, reverse=True)
    th_f = pe_theta_fwd(fe_out)
    th_b = pe_theta_bwd(fe_out, reverse=True)
    th_feat = torch.cat([th_f, th_b], dim=-1)
    print(f"z0 head: {tuple(fe_out.shape)} -> {tuple(z0_feat.shape)} (last "
          f"state, reversed)")
    print(f"theta head: -> {tuple(th_feat.shape)} (fwd ++ bwd last states)")
    assert z0_feat.shape == (4, rnn_out) and th_feat.shape == (4, 2 * rnn_out)

    # ---------------------------------------------------------------------
    # 5. Encoder stage 3 — latent_in: four Dense heads producing the
    #    variational posterior (z0_mu, z0_logvar, theta_mu, theta_logvar)
    #    (reference cells 25-26).
    # ---------------------------------------------------------------------
    latent_in = tuple(nn.Dense(d, latent_dim, **kw).to(dev)
                      for d in (rnn_out, rnn_out, 2 * rnn_out, 2 * rnn_out))
    z0_mu, z0_logvar = latent_in[0](z0_feat), latent_in[1](z0_feat)
    th_mu, th_logvar = latent_in[2](th_feat), latent_in[3](th_feat)
    print(f"posterior: z0 mu/logvar {tuple(z0_mu.shape)}, theta mu/logvar "
          f"{tuple(th_mu.shape)}")
    encoder_layers = (feature_extractor, (pe_z0, pe_theta_fwd, pe_theta_bwd),
                      latent_in)

    # ---------------------------------------------------------------------
    # 6. The reparameterization trick (reference cell 37): sample
    #    l = mu + eps * exp(logvar / 2) with eps ~ N(0, I), so gradients
    #    flow through mu and logvar.
    # ---------------------------------------------------------------------
    # JAX's draw from PRNGKey(0), the same numbers (latentdiffeq_torch.random)
    eps = jr.normal(jr.PRNGKey(0, device=dev), z0_mu.shape)
    z0_tilde = z0_mu + eps * torch.exp(z0_logvar / 2)
    print(f"sampled latent z0_tilde {tuple(z0_tilde.shape)}")

    # ---------------------------------------------------------------------
    # 7. Decoder stage 1 — latent_out: two MLPs mapping the 16-dim
    #    variational latents into the ODE's coordinates: z0_hat (angle,
    #    velocity) and theta_hat = L (reference cells 28-30). softplus keeps
    #    L strictly positive — a pendulum with negative length isn't physics.
    # ---------------------------------------------------------------------
    lo_z0 = nn.mlp((latent_dim, 200, diffeq.z_dim), nn.relu, nn.identity,
                   **kw).to(dev)
    lo_theta = nn.mlp((latent_dim, 200, diffeq.theta_dim), nn.relu,
                      nn.softplus, **kw).to(dev)
    z0_hat = lo_z0(z0_tilde)
    th_hat = lo_theta(th_mu)
    print(f"ODE initial state z0_hat {tuple(z0_hat.shape)}, params theta_hat "
          f"{tuple(th_hat.shape)}, L > 0: {bool((th_hat > 0).all())}")

    # ---------------------------------------------------------------------
    # 8. Decoder stage 2 — the diffeq layer: solve the pendulum ODE from
    #    each sample's (z0_hat, theta_hat) (reference cells 31-32). Here the
    #    reference round-trips to CPU for EnsembleThreads; the port solves
    #    the whole batch at once on the device. Demo with known parameters
    #    so the trajectory is meaningful:
    # ---------------------------------------------------------------------
    # pendulum_f is this file's own Python function, so it takes the plain
    # batched Tsit5 solve: the hand-written RK kernel runs only the
    # vector fields compiled into it (latentdiffeq_torch.pendulum's
    # pendulum_f among them) and refuses any other RHS
    t_grid = torch.arange(100, dtype=torch.float32, device=dev) * 0.05
    sol = ldq.solve_ensemble(
        ldq.ODEProblem(f=pendulum_f, u0=torch.zeros(2, device=dev),
                       tspan=(0.0, 4.95), p=torch.ones(1, device=dev)),
        u0s=torch.as_tensor(u0s[:3], device=dev),
        ps=torch.as_tensor(ps[:3], device=dev), saveat=t_grid,
        adaptive=False)
    print(f"batched solve: ys {tuple(sol.ys.shape)}, all succeeded: "
          f"{bool(sol.success.all())}, RHS evals: "
          f"{int(sol.stats['n_rhs_evals'])}")
    figures.append(save_lines(
        os.path.join(OUTPUT_DIR, "ode_solutions.png"),
        "pendulum ODE solutions (angle, rad) — longer L, slower swing",
        [sol.ys[i, :, 0].cpu().numpy() for i in range(3)],
        [f"L = {float(ps[i, 0]):.2f}" for i in range(3)]))

    # ---------------------------------------------------------------------
    # 9. Decoder stage 3 — the reconstructor: another resnet MLP mapping
    #    each solved state (angle, velocity) back to 784 sigmoid pixels
    #    (reference cell 33).
    # ---------------------------------------------------------------------
    reconstructor = nn.Chain([
        nn.Dense(diffeq.z_dim, hidden, nn.relu, **kw),
        nn.SkipConnection(nn.Dense(hidden, hidden, nn.relu, **kw)),
        nn.SkipConnection(nn.Dense(hidden, hidden, nn.relu, **kw)),
        nn.Dense(hidden, input_dim, nn.sigmoid, **kw),
    ]).to(dev)
    decoder_layers = ((lo_z0, lo_theta), diffeq, reconstructor)

    # ---------------------------------------------------------------------
    # 10. Assemble the six-slot model (reference cell 35). The container
    #     just wires the stages: encode -> sample -> latent_out -> solve ->
    #     transform -> reconstruct, returning ((x_hat, z_hat, l_hat), mu,
    #     logvar, aux).
    # ---------------------------------------------------------------------
    model = LatentDiffEqModel.build(GOKUBasic(), encoder_layers,
                                    decoder_layers)

    t = torch.arange(50, dtype=torch.float32, device=dev) * 0.05
    xb = torch.as_tensor(train_set[:8, 25:75], device=dev)
    noise = torch.Generator(device=dev).manual_seed(0)
    (x_hat, z_hat, l_hat), mu, logvar, aux = model(
        xb, t, variational=True, generator=noise)
    print(f"forward: x_hat {tuple(x_hat.shape)}, latent trajectory z_hat "
          f"{tuple(z_hat.shape)}, inferred L {tuple(l_hat[1].shape)}")
    print(f"solver successes: {int(aux['success'].sum())}/8")

    # ---------------------------------------------------------------------
    # 11. The loss (reference cells 38-40): per-pixel reconstruction +
    #     beta * KL(posterior || N(0, I)) over BOTH latent groups.
    # ---------------------------------------------------------------------
    loss, metrics = loss_batch(model, xb, t, beta=0.5, variational=True,
                               generator=noise)
    print(f"initial loss {loss.item():.2f} = rec {metrics['rec'].item():.2f}"
          f" + 0.5 * kl {metrics['kl'].item():.2f} "
          f"| RHS evals {int(metrics['n_rhs_evals'])}")

    # ---------------------------------------------------------------------
    # 12. Cyclical KL annealing (reference cell 43): beta ramps 0 -> 1 in 4
    #     cycles, holding at 1 for the last 10% of each. Early low-beta
    #     phases let the reconstruction organize the latent space before the
    #     prior pressure kicks in.
    # ---------------------------------------------------------------------
    beta_schedule = frange_cycle_linear(1500, 0.0, 1.0, 4, 0.9)
    figures.append(save_lines(os.path.join(OUTPUT_DIR, "beta_schedule.png"),
                              "cyclical KL annealing schedule (beta by "
                              "epoch)", [np.asarray(beta_schedule)]))

    # ---------------------------------------------------------------------
    # 13. Train (reference cell 45). The Trainer runs the reference's loop
    #     (random window sampling, minibatching, ADAMW, the full validation
    #     loss after every minibatch, best tracking). 150 epochs to watch
    #     the loss move; the real flagship runs 3000 (see
    #     benchmarks/quality_goku.py — angle corr 0.997, L error 0.026).
    # ---------------------------------------------------------------------
    # on the card the encoder's three recurrences run as one hand-written
    # kernel: use_kernel_encoder, JAX's use_pallas_encoder, the same field
    model = LatentDiffEqModel.build(
        GOKUBasic(use_kernel_encoder=dev.type == "cuda"), encoder_layers,
        decoder_layers)
    cfg = TrainConfig(epochs=1500, seed=333, save_best=False)
    trainer = Trainer(model, cfg, device=dev)
    trainer.fit(train_set, val_set, epochs=args.epochs)
    print(f"best val loss after {args.epochs} epochs: "
          f"{trainer.best_val_loss:.2f}")
    figures.append(save_lines(
        os.path.join(OUTPUT_DIR, "val_loss.png"),
        f"validation loss ({args.epochs} tutorial epochs)",
        [[h["val_loss"] for h in trainer.history]]))

    # ---------------------------------------------------------------------
    # 14. What convergence looks like (reference cells 44-46): the committed
    #     flagship winner (benchmarks/artifacts/) decoded on a validation
    #     sample — inferred vs true angle and the reconstruction mosaic.
    # ---------------------------------------------------------------------
    decoded = None
    if os.path.exists(CHECKPOINT):
        # the JAX Trainer's checkpoint, read by the port's loader into the
        # same layers (their parameters carry JAX's key paths)
        meta = load_checkpoint(CHECKPOINT, model)
        _, val_latent = splitobs(latent, 0.9)
        _, val_ps = splitobs(ps, 0.9)
        fig_path = os.path.join(OUTPUT_DIR, "converged_sample.png")
        decoded = visualize_val_image(
            model, val_set, val_latent, val_ps, vis_len=60, dt=0.05, h=28,
            w=28, path=fig_path, rng=np.random.default_rng(4))
        figures.append(fig_path)
        print(f"converged-model figure written to {fig_path} "
              f"(trained {meta.get('epoch')} epochs)")
    else:
        print("committed flagship checkpoint not found; skipping")
    return {"trainer": trainer, "decoded": decoded, "figures": figures}


if __name__ == "__main__":
    main()
