"""GOKU-net on pendulum video (counterpart of
examples/pendulum/train_goku.py:28-290).

    python -m latentdiffeq_torch.examples.pendulum.train_goku --epochs 2
    python -m latentdiffeq_torch.examples.pendulum.train_goku --device cpu
    python -m torch.distributed.run --nproc-per-node N \
        -m latentdiffeq_torch.examples.pendulum.train_goku --data-parallel N

Cached data generation (create_data.py), the 90/10 split, GOKU's default
layers, Flux ADAMW ELBO training with cyclical KL annealing on random
50-frame windows, validation after every minibatch, the best checkpoint in
``OUTPUT_DIR/best_model.npz`` and figures in ``OUTPUT_DIR/visualization``;
with ``--seeds`` a population (MultiSeedTrainer) and its winner.

The JAX script's flags and defaults, so that its command lines run here,
except ``--unroll``, which only schedules the JAX solver's scan. Added:
``--device`` (default ``cuda``; ``cpu`` runs every kernel's plain PyTorch
version, the counterpart of ``LDQ_PLATFORM=cpu``).

``--data-parallel N`` trains on N ranks (``parallel/``): the batch sharded
over them (``Trainer(mesh=)``), or with ``--seeds`` the seeds
(``MultiSeedTrainer(mesh=)``). Start N ranks with ``python -m
torch.distributed.run --nproc-per-node N``; with N = 1 and no launcher the
script sets up its one-rank group itself, and a launcher's ``WORLD_SIZE``
other than N raises. Each rank trains on ``cuda:LOCAL_RANK`` (a
``--device`` with an index pins every rank to that card) or on the CPU
with ``--device cpu``; the group uses NCCL on the card and gloo on the
CPU or where ranks share a card (NCCL refuses two ranks on one device).
It trains in blocks, as a solo run does (on NCCL each epoch's CUDA graph
holds the gradient all-reduces), but for ranks that share a card, which
run the per-step loop. Rank 0 prints, draws the figures and writes the
checkpoints.

Differences from the JAX script, each on purpose:
- the model runs the hand-written kernels (``GOKUBasic(use_kernel_encoder=
  True, use_kernel_solver=True)``): the encoder's recurrent heads and the
  fixed-grid RK solve, one launch each a call on the card;
- a seed draws other initial weights than JAX's (torch's generator, not
  threefry);
- the figures draw their sample and window from a generator of their own,
  seeded from ``--seed``, so that a run with ``--no-viz`` trains the same
  weights (JAX hands the figure ``tr.np_rng``, which its block mode never
  draws from, so the draws are the same as here); they are written on the
  epochs at which JAX's ``Trainer.fit`` calls its callbacks in its default
  block mode (``figure_epochs``), not on every epoch.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.examples.pendulum import create_data
from latentdiffeq_torch.examples.pendulum.create_data import load_or_generate
from latentdiffeq_torch.models import (GOKUBasic, LatentDiffEqModel,
                                       goku_default_layers)
from latentdiffeq_torch.parallel import initialize_distributed, make_mesh
from latentdiffeq_torch.pendulum import Pendulum, PendulumFriction, SPendulum
from latentdiffeq_torch.solve import SDEAdaptiveConfig, make_options
from latentdiffeq_torch.train import (MultiSeedTrainer, TrainConfig, Trainer,
                                      splitobs)
from latentdiffeq_torch.train.trainer import _prog_seq_lengths, block_end
from latentdiffeq_torch.train.visualize import visualize_val_image

__all__ = ["OUTPUT_DIR", "build_parser",
           "figure_epochs", "data_parallel_mesh", "main"]

OUTPUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "output")


def figure_epochs(cfg: TrainConfig, start: int = 0):
    """The epochs at which JAX's ``Trainer.fit`` calls its callbacks in
    block mode from epoch ``start`` (trainer.py:759-819), as the port's
    does: the last epoch of each block. A block holds at most
    ``cfg.epochs_per_dispatch`` epochs and ends at ``cfg.epochs``; in the
    sliced curriculum it also ends where the window length changes (the
    masked curriculum runs one length). A per-step run (``--data-parallel``
    on ranks that share a card) draws on the same epochs."""
    prog = _prog_seq_lengths(cfg)
    out, ep0 = [], start
    while ep0 < cfg.epochs:
        ep0 = block_end(cfg, prog, ep0, cfg.epochs)[0]
        out.append(ep0 - 1)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--decay", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=333)
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive Tsit5 (default: the fixed dt grid, in "
                         "the RK kernel)")
    ap.add_argument("--diffeq", default="pendulum",
                    choices=["pendulum", "friction", "spendulum"],
                    help="latent dynamics: Pendulum / PendulumFriction / "
                         "SPendulum (pendulum.jl)")
    ap.add_argument("--free-bits", type=float, default=None,
                    help="per-dim KL floor; default 0 for pendulum and "
                         "spendulum, 0.1 for friction; 0 forces it off")
    ap.add_argument("--seeds", type=int, default=0, metavar="S",
                    help="population training: S seeds (seed..seed+S-1) "
                         "at once, keep the winner (0 = single seed)")
    ap.add_argument("--progressive", action="store_true",
                    help="progressive-observation curriculum: seq_len "
                         "ramps --start-seq-len -> --seq-len over "
                         "--prog-duration epochs")
    ap.add_argument("--start-seq-len", type=int, default=20)
    ap.add_argument("--prog-duration", type=int, default=300)
    ap.add_argument("--masked", action="store_true",
                    help="the masked curriculum (one length a step, "
                         "TrainConfig.masked_curriculum); implies "
                         "--progressive")
    ap.add_argument("--prune-at", type=int, default=0, metavar="E",
                    help="with --seeds: at epoch E keep the --prune-keep "
                         "best-val replicas")
    ap.add_argument("--prune-keep", type=int, default=2)
    ap.add_argument("--select-by", default="val",
                    choices=["val", "pixel", "pixel-composite"],
                    help="with --seeds: the winner by best validation "
                         "loss, by the pixel-angle correlation, or by the "
                         "pixel forecast score among in-context passers")
    ap.add_argument("--forecast-ctx", type=int, default=50,
                    help="context length of --select-by pixel-composite")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="NN-stage dtype (the latent solve stays float32)")
    ap.add_argument("--warm-start", action="store_true",
                    help="pixel-readout warm start before ELBO training "
                         "(every replica with --seeds)")
    ap.add_argument("--warm-steps", type=int, default=300)
    ap.add_argument("--no-viz", action="store_true")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--data-parallel", type=int, default=0, metavar="N",
                    help="train data-parallel on N ranks, started by "
                         "python -m torch.distributed.run --nproc-per-node "
                         "N (0 = one process; N must divide the batch "
                         "size, or with --seeds the seed count)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the model trains")
    return ap


def data_parallel_mesh(n: int, device):
    """The mesh of ``--data-parallel n``: joins the launcher's group (or
    sets up a one-rank group when n is 1 and no launcher ran), on
    ``cuda:LOCAL_RANK`` for ``device`` ``cuda``; a card index in
    ``device`` pins every rank to that card, and ranks that share it
    reduce with gloo. Returns ``(mesh, device, whether this call started
    the group)``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n:
        raise ValueError(
            f"--data-parallel {n} needs {n} ranks and {world} were started; "
            f"launch with python -m torch.distributed.run --nproc-per-node "
            f"{n}")
    dev = torch.device(device)
    shared = (dev.type == "cuda" and dev.index is not None
              and int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    started = not dist.is_initialized()
    initialize_distributed(backend="gloo" if shared else None, device=dev)
    return make_mesh(n), dev, started


def load_data(diffeq_name: str, device):
    """The dataset of the ``--diffeq`` spec: the damped spec trains on
    damped-dynamics video, cached on its own (train_goku.py:136-145)."""
    if diffeq_name == "friction":
        return load_or_generate(
            os.path.join(create_data.DATA_DIR, "pendulum_friction_data.npz"),
            diffeq=PendulumFriction(), device=device)
    return load_or_generate(device=device)


def make_diffeq(args):
    options = (make_options(adaptive=True) if args.adaptive
               else make_options(adaptive=False, substeps=1))
    if args.diffeq == "spendulum":
        # --adaptive: per-trajectory dyadic SRA1 stepping, the reference's
        # SOSRI() semantics (pendulum.jl:103)
        return SPendulum(adaptive=args.adaptive,
                         adaptive_cfg=SDEAdaptiveConfig(
                             max_steps=256, depth_cap=6,
                             max_steps_per_interval=6))
    if args.diffeq == "friction":
        return PendulumFriction(options=options)
    return Pendulum(options=options)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.seeds and args.resume:
        ap.error("--seeds is incompatible with --resume (population "
                 "training starts fresh; restore the winner checkpoint "
                 "into a plain Trainer instead)")
    if not args.data_parallel:
        return train(args, resolve_device(args.device), None)
    mesh, dev, started = data_parallel_mesh(args.data_parallel, args.device)
    try:
        return train(args, dev, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def train(args, dev, mesh):
    """The run of ``main``'s arguments on ``dev`` (``mesh``: data
    parallel)."""
    rank0 = mesh is None or mesh.get_local_rank() == 0
    latent, u0s, ps, frames = load_data(args.diffeq, dev)
    x = frames.reshape(frames.shape[0], frames.shape[1], -1)
    train_set, val_set = splitobs(x, 0.9)
    _, val_latent = splitobs(latent, 0.9)
    _, val_ps = splitobs(ps, 0.9)
    input_dim = x.shape[-1]

    diffeq = make_diffeq(args)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model_type = GOKUBasic(use_kernel_encoder=True, use_kernel_solver=True)

    def init_fn(seed):
        enc, dec = goku_default_layers(
            input_dim, diffeq, generator=torch.Generator().manual_seed(seed),
            device=dev, dtype=dtype)
        return LatentDiffEqModel.build(model_type, enc, dec)

    free_bits = args.free_bits if args.free_bits is not None else (
        0.1 if args.diffeq == "friction" else 0.0)
    cfg = TrainConfig(lr=args.lr, decay=args.decay,
                      batch_size=args.batch_size, seq_len=args.seq_len,
                      epochs=args.epochs, seed=args.seed,
                      free_bits=free_bits,
                      progressive_training=args.progressive or args.masked,
                      start_seq_len=args.start_seq_len,
                      prog_training_duration=args.prog_duration,
                      prog_seq_len_step=1 if args.masked else 5,
                      masked_curriculum=args.masked,
                      checkpoint_dir=OUTPUT_DIR)
    warm = None
    if args.warm_start:
        from latentdiffeq_torch.pixel_observable import (
            pendulum_pixel_estimates, warm_start_pendulum)
        est = pendulum_pixel_estimates(train_set, cfg.dt)

        def warm(m):
            return warm_start_pendulum(m, train_set, cfg.dt,
                                       steps=args.warm_steps,
                                       estimates=est)[0]

    if args.seeds:
        return train_population(args, init_fn, cfg, train_set, val_set,
                                warm, dev, mesh)

    trainer = Trainer(init_fn(args.seed), cfg, device=dev, mesh=mesh)
    if args.resume:
        trainer.restore(args.resume)
    elif warm is not None:
        warm(trainer.model)

    callbacks = []
    if not args.no_viz and rank0:
        fig_rng = np.random.default_rng(args.seed)
        fig_at = set(figure_epochs(cfg, trainer.epoch))

        def viz(tr, rec):
            if rec["epoch"] not in fig_at:
                return
            path = os.path.join(cfg.checkpoint_dir, "visualization",
                                f"fig_{rec['epoch']}.png")
            visualize_val_image(
                tr.model, val_set, val_latent, val_ps, vis_len=60,
                dt=cfg.dt, h=28, w=28, path=path, rng=fig_rng)
            print(f"figure {path}", flush=True)

        callbacks.append(viz)

    trainer.fit(train_set, val_set, callbacks=callbacks)
    return trainer


def train_population(args, init_fn, cfg, train_set, val_set, warm, dev,
                     mesh=None):
    """``--seeds S``: train the population (its seeds sharded over
    ``mesh``), prune, pick and save the winner (train_goku.py:189-257)."""
    seeds = list(range(args.seed, args.seed + args.seeds))
    ms = MultiSeedTrainer(init_fn, cfg, seeds, device=dev, mesh=mesh)
    say = (print if mesh is None or mesh.get_local_rank() == 0
           else (lambda *a, **k: None))
    if warm is not None:
        ms.warm_start(warm)
    if args.prune_at and args.prune_at < args.epochs:
        # train everyone to the prune point, keep the best-val replicas and
        # spend the rest of the budget on them; their streams go on as if
        # the others had never trained
        ms.fit(train_set, val_set, epochs=args.prune_at)
        vals = np.where(np.isfinite(ms.per_seed_best_vals),
                        ms.per_seed_best_vals, np.inf)
        keep = list(np.argsort(vals)[:args.prune_keep])
        dropped = [s for i, s in enumerate(ms.seeds) if i not in keep]
        ms.prune(sorted(keep))
        say(f"epoch {args.prune_at}: pruned to seeds {ms.seeds} "
            f"(dropped {dropped})")
    ms.fit(train_set, val_set)
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    ckpt = os.path.join(cfg.checkpoint_dir, "best_model.npz")
    if args.select_by in ("pixel", "pixel-composite"):
        from latentdiffeq_torch.pixel_observable import (
            pixel_angles, population_pixel_composite_scores,
            population_pixel_scores)
        th_obs = pixel_angles(val_set)
        if args.select_by == "pixel-composite":
            def score_fn(m):
                return population_pixel_composite_scores(
                    m, val_set, th_obs, cfg.dt, args.forecast_ctx)
        else:
            def score_fn(m):
                return population_pixel_scores(m, val_set, th_obs, cfg.dt)
        _, info = ms.select(score_fn)
        ms.save_replica(ckpt, info["index"], from_best=info["from_best"])
        label = ("pixel-composite score"
                 if args.select_by == "pixel-composite"
                 else "pixel-angle corr")
        say(f"winner: seed {info['seed']} ({label} "
            f"{info['score']:.4f}, "
            f"{'best-carry' if info['from_best'] else 'live'} "
            f"weights) -> {ckpt}")
    else:
        ms.save_best(ckpt)
        say(f"winner: seed {ms.best_seed} "
            f"(val {ms.best_val_loss:.4f}) -> {ckpt}")
    return ms


if __name__ == "__main__":
    main()
