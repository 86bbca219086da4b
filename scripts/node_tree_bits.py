"""The neural-field kernels' outputs on fixed inputs, to hold two trees'
kernels bit for bit.

    python3 scripts/node_tree_bits.py save OUT.pt [--root DIR]
    python3 scripts/node_tree_bits.py compare A.pt B.pt

``save`` imports the port from the tree at DIR (default: this checkout),
builds its kernels there, and writes what the forward and sweep kernels
give for a seeded full-width field (16-200-200-16, relu, Tsit5) at B 64,
T 50 and B 45, T 100, at one and at two rows a block: the forward's ys
with and without the tape, the tape, and the sweep's du0 and Delta; each
once from a solo call and once from a call with a replica axis of one
(u0s (1, B, 16), every weight (1, ...)). ``compare`` prints, per entry
held by both files, whether they are equal bit for bit and their largest
difference, names the entries only one file holds, and exits 1 if any
common one differs. Needs one CUDA card for ``save``. To check that a
change keeps the single-replica launch as it was, unpack the older commit
under build/ (``git archive <commit> latentdiffeq_torch | tar -x -C
build/old``) and save from both trees in one call; the files are about
0.7 GB each, so save them under build/.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

WIDTHS = (16, 200, 200, 16)
SHAPES = ((64, 50), (45, 100))


def save(out: str, root: str):
    sys.path.insert(0, os.path.abspath(root))
    from latentdiffeq_torch import nn as tnn
    from latentdiffeq_torch.ops import node_cuda
    from latentdiffeq_torch.solve.rk import Tsit5

    if not torch.cuda.is_available():
        sys.exit("node_tree_bits.py save needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    solver = Tsit5()
    g = torch.Generator().manual_seed(14)
    m = tnn.mlp(WIDTHS, tnn.relu, tnn.identity, generator=g)
    with torch.no_grad():
        for lyr in m.layers:
            lyr.b.copy_(torch.randn(lyr.b.shape, generator=g) * 0.1)
    m = m.cuda()
    f = node_cuda.dense_stack(m)
    one = f._replace(Ws=[W.detach()[None] for W in f.Ws],
                     bs=[b.detach()[None] for b in f.bs])
    res = {}
    for B, T in SHAPES:
        u0s = (torch.randn(B, WIDTHS[0], generator=g) * 0.5).cuda()
        w = torch.randn(B, T, WIDTHS[0], generator=g).cuda()
        saveat = torch.arange(T, dtype=torch.float32).cuda() * 0.05
        for rows in (1, 2):
            for tag, fld, u, gw in (("solo", m, u0s, w),
                                    ("S1", one, u0s[None], w[None])):
                with torch.no_grad():
                    ys, tape = node_cuda.solve_neural_field_cuda(
                        fld, solver, u, saveat, tape=True,
                        rows_per_block=rows)
                    ys0 = node_cuda.solve_neural_field_cuda(
                        fld, solver, u, saveat, rows_per_block=rows)
                du0, delta = node_cuda.neural_field_sweep_cuda(
                    fld, solver, saveat, tape, gw, rows_per_block=rows)
                key = f"B{B} T{T} rows {rows} {tag}"
                res[key] = [(t[0] if tag == "S1" else t).cpu()
                            for t in (ys, tape, ys0, du0, delta)]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(res, out)
    print(f"saved {out} from {root}: {sorted(res)}")


def compare(a: str, b: str) -> bool:
    ra, rb = torch.load(a), torch.load(b)
    same = True
    for key in sorted(set(ra) ^ set(rb)):
        print(f"node_field {key}: only in {a if key in ra else b}")
    for key in (k for k in ra if k in rb):
        eq = all(torch.equal(x, y) for x, y in zip(ra[key], rb[key]))
        diff = max(float((x - y).abs().max())
                   for x, y in zip(ra[key], rb[key]))
        print(f"node_field {key} (ys, tape, ys without the tape, du0, "
              f"Delta): bit for bit {eq}, largest difference {diff:.3e}")
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
