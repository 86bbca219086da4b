"""Run chip_smoke.py's phase 4n alone on the card: block mode (the epochs
as CUDA graphs, the best on the device) against the per-step loop, bit for
bit, for each of its paths (chip_smoke.block_parts: full-width GOKU and
LatentODE, SDE and adaptive GOKU, the populations), with the launch counts,
the graphs' capture seconds and nodes, the profiler windows and the steady
epoch times.

    python3 scripts/block_smoke.py ["(a) SDE GOKU" ...]
    python3 scripts/block_smoke.py --mesh [GOKU LatentODE]

Arguments name the paths to run (default: all). ``--mesh``: phase 4n's
mesh check instead (chip_smoke.mesh_block_path), on a one-rank NCCL
group set up there: each path as
``Trainer(mesh=make_mesh(1))`` in blocks (DDP's all-reduces in the
captured epochs) against the mesh's per-step loop and the solo block
Trainer, bit for bit (default paths: GOKU and LatentODE).

Builds the port's kernels, generates the 450-video pendulum set on the card
(chip_smoke's phase 4 data), runs chip_smoke.block_path and prints its
[block] lines, the card's name and power limit and "block_smoke: ok";
exits 1 (through chip_smoke.fail) if a check fails, and with an exception
if a capture or a replay fails. Needs a CUDA GPU.
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from latentdiffeq_torch.ops import _build  # noqa: E402
from latentdiffeq_torch.pendulum_data import generate_dataset  # noqa: E402
from latentdiffeq_torch.train import splitobs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("block_smoke: needs a CUDA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    t0 = time.perf_counter()
    _build.build_kernels()
    cs.log("build", f"kernels in {time.perf_counter() - t0:.2f} s; torch "
                    f"{torch.__version__} cuda {torch.version.cuda}")
    _, _, _, frames = generate_dataset(device="cuda")
    train_set, val_set = splitobs(frames.reshape(450, 100, 784), 0.9)
    names = [a for a in sys.argv[1:] if a != "--mesh"]
    dev = torch.device("cuda")
    if "--mesh" not in sys.argv[1:]:
        steady = cs.block_path(train_set, val_set, dev, gpu,
                               only=names or None)
    else:
        steady = cs.mesh_block_path(train_set, val_set, dev, gpu,
                                    only=names or cs.BLOCK_FIRST)
    cs.log("block", f"steady epoch s (per-step, block): {steady}")
    print(gpu, flush=True)
    print("block_smoke: ok", flush=True)


if __name__ == "__main__":
    main()
