"""train_goku.py --data-parallel N with one rank a card (NCCL) against one
process, on one host, through chip_smoke.py's data-parallel worker and
gates (phase 4k):

    python3 scripts/dp_cards.py [--cards 4]
    python3 scripts/dp_cards.py --cards 4 --device cpu   # gloo, a small video

Builds the kernels and makes the pendulum video once, then starts N ranks
of ``chip_smoke.py --dp-worker`` under torch.distributed.run: each runs
train_goku.py --data-parallel N --epochs 2 --no-viz twice on its card
(``cuda:LOCAL_RANK``; the Trainer in blocks), one step of train_goku's
seed-333 model on its rows of a minibatch, and that model's
``Trainer(mesh=)`` in 2 blocks of 3 epochs (DDP's warm-up, then captured
epochs with NCCL's all-reduces inside) and per step; rank 0 then runs
train_goku in one process. ``chip_smoke.dp_check`` holds them (launches,
runs and ranks bit for bit, the blocks bit for bit with the per-step
loop and a graph captured, the first step, each epoch's validation loss,
the weights) and the script prints the card line and its summary as one
JSON line. ``--device cpu``
rehearses the flow on a small synthetic video (40 trajectories of 12
frames, batch 8, windows of 8).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "dp_cards")


def video(device):
    """The pendulum video (made on card 0), or a small synthetic one."""
    import numpy as np
    import torch
    if device == "cpu":
        rng = np.random.default_rng(0)
        latent = rng.normal(size=(40, 12, 2)).astype(np.float32)
        return (latent, latent[:, 0].copy(),
                rng.uniform(1, 2, (40, 1)).astype(np.float32),
                rng.uniform(0, 1, (40, 12, 28, 28)).astype(np.float32))
    from latentdiffeq_torch.ops import _build
    from latentdiffeq_torch.pendulum_data import generate_dataset
    _build.build_kernels()
    out = generate_dataset(device="cuda")
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from latentdiffeq_torch.examples.pendulum import create_data
    card = args.device == "cuda"
    if card and torch.cuda.device_count() < args.cards:
        sys.exit(f"needs {args.cards} cards, has {torch.cuda.device_count()}")
    ranks, launch_s = cs.dp_launch(
        OUT, args.cards, ["--device", args.device]
        + ([] if card else ["--small"]), video=video(args.device),
        cache=create_data.cache_key(device=args.device))
    line = cs.gpu_line() if card else "cpu"
    summary = cs.dp_check(ranks, f"{args.cards} ranks",
                          cs.DP_LAUNCHES if card else None, line)
    print(line, flush=True)
    print(json.dumps(dict(summary, launch_s=launch_s, card=line)),
          flush=True)


if __name__ == "__main__":
    main()
