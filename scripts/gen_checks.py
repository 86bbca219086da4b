"""Run chip_smoke.py's checks and timing of some user-field instances
(gen_kernel_checks, phase 5) and its phase 4m (GOKU on Lorenz-96-40 and
Kuramoto-64, kernel route against plain route) alone on the card, without
the rest of the script:

    python3 scripts/gen_checks.py [--fields pendulum-untagged,lorenz96-40,kuramoto64]

--fields names chip_smoke.gen_fields() labels. Prints the check and
timing lines, then each 4m kernel's launches, largest error against its
plain version and timing row, the card's name and power limit, and
"gen_checks: ok"; exits 1 (through chip_smoke.fail) if a check fails.
Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from latentdiffeq_torch.ops import ode_cuda  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fields",
                    default="pendulum-untagged,lorenz96-40,kuramoto64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("gen_checks: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = cs.gpu_line()
    fields = cs.gen_fields()
    keep = {k: fields[k] for k in args.fields.split(",")}
    t0 = time.perf_counter()
    ode_cuda.build_instances([(f, d, p) for f, d, p, *_ in keep.values()])
    print("built in", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    errs, times = cs.gen_kernel_checks(
        torch.Generator(device=dev).manual_seed(16), cs.max_sm_clock_mhz(),
        keep)
    print("checks in", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    launches = cs.wide_path(dev, gpu)
    print("4m in", time.perf_counter() - t0, flush=True)
    for name in sorted(launches):
        print(name, launches[name], errs.get(name), times.get(name),
              flush=True)
    print(gpu)
    print("gen_checks: ok", flush=True)


if __name__ == "__main__":
    main()
