"""goku_heads' outputs on fixed inputs, to hold two trees' kernels bit for bit.

    python3 scripts/heads_tree_bits.py save OUT.pt [--root DIR]
    python3 scripts/heads_tree_bits.py compare A.pt B.pt

``save`` imports the port from the tree at DIR (default: this checkout),
builds its kernels there, and writes what the heads kernels give for
seeded inputs at three head widths (D, H) = (32, 16), (10, 8), (64, 32),
B 64, T 50: the forward's outputs with and without the tape, the tape, and
the sweep's dgates, dh0 and dc0; in float32 and, where the tree has them,
in the bfloat16 instances (the same weights and inputs rounded to
bfloat16). ``compare`` prints, per width and dtype held by both files,
whether they are equal bit for bit and their largest difference, names
the entries only one file holds, and exits 1 if any common one differs. Needs one CUDA card for ``save``. To check that a change
keeps the single-replica launch as it was, unpack the older commit under
build/ (``git archive <commit> latentdiffeq_torch | tar -x -C build/old``)
and save from both trees in one call.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

WIDTHS = ((32, 16), (10, 8), (64, 32))


def save(out: str, root: str):
    sys.path.insert(0, os.path.abspath(root))
    from latentdiffeq_torch import nn as tnn
    from latentdiffeq_torch.ops import recurrent_cuda as rc

    if not torch.cuda.is_available():
        sys.exit("heads_tree_bits.py save needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtypes = [torch.float32] + [d for d in getattr(rc, "DTYPES", ())
                                if d != torch.float32]
    res = {}
    for D, H in WIDTHS:
        g = torch.Generator().manual_seed(D)
        heads = (tnn.Recurrent.rnn(D, (H, H), tnn.relu),
                 tnn.Recurrent.lstm(D, (H, H)), tnn.Recurrent.lstm(D, (H, H)))
        with torch.no_grad():
            for p in (p for h in heads for p in h.parameters()):
                p.copy_(torch.randn(p.shape, generator=g) * 0.15)
        xs = torch.randn(64, 50, D, generator=g)
        gz = torch.randn(64, H, generator=g)
        gt = torch.randn(64, 2 * H, generator=g)
        for dt in dtypes:
            hs = tuple(h.cuda().to(dt) for h in heads)
            x, a, b = (t.cuda().to(dt) for t in (xs, gz, gt))
            with torch.no_grad():
                z, th, tape = rc.goku_heads_cuda(*hs, x, tape=True)
                z2, th2 = rc.goku_heads_cuda(*hs, x)
                sweep = rc.goku_heads_bwd_cuda(*hs, tape, a, b)
            key = f"{D}x{H}" + ("" if dt == torch.float32 else " bf16")
            res[key] = [t.cpu() for t in (z, th, tape, z2, th2) + sweep]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(res, out)
    print(f"saved {out} from {root}: {sorted(res)}")


def compare(a: str, b: str) -> bool:
    ra, rb = torch.load(a), torch.load(b)
    same = True
    for key in sorted(set(ra) ^ set(rb)):
        print(f"heads {key}: only in {a if key in ra else b}")
    for key in (k for k in ra if k in rb):
        eq = all(torch.equal(x, y) for x, y in zip(ra[key], rb[key]))
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(ra[key], rb[key]))
        print(f"heads {key}: bit for bit {eq}, largest difference {diff:.3e}")
        same = same and eq
    return same


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "save":
        save(args.out, args.root)
    elif not compare(args.a, args.b):
        sys.exit(1)


if __name__ == "__main__":
    main()
