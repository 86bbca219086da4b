"""Compare the port's pendulum dataset with the JAX package's, on the CPU:

    JAX_PLATFORMS=cpu python scripts/dataset_vs_jax.py [--n-traj 450]

Both draw the same initial conditions and integrate with adaptive Tsit5
(rtol 1e-3, atol 1e-6) and dense output on the frame grid. Prints three
comparisons of the states over all rows and frames, each as the largest
difference, the number of rows whose largest difference exceeds 1e-4 and
the number of rows whose accepted or rejected step counts differ:

- the port's generator against the JAX generator, both in float32;
- the JAX solve jitted against the same solve run eagerly
  (``jax.disable_jit``), both in float32: how far the reference agrees
  with itself when only the rounding of its sums changes;
- the port's solve against the JAX solve, both in float64.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples", "pendulum"))


def report(name, ys_a, st_a, ys_b, st_b):
    d = np.abs(np.asarray(ys_a) - np.asarray(ys_b)).max(axis=(1, 2))
    counts = [np.asarray(st_a[k]) != np.asarray(st_b[k])
              for k in ("n_accepted", "n_rejected")]
    print(f"{name}: max |diff| {d.max():.3e}, rows above 1e-4: "
          f"{int((d > 1e-4).sum())}, rows with other step counts: "
          f"{int((counts[0] | counts[1]).sum())} of {len(d)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-traj", type=int, default=450)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import torch
    from create_data import Pendulum, generate_dataset as jax_generate

    from latentdiffeq.solve import adaptive as jad
    from latentdiffeq.solve.rk import Tsit5 as JTsit5
    from latentdiffeq_torch import pendulum_data
    from latentdiffeq_torch.pendulum import pendulum_f
    from latentdiffeq_torch.solve import adaptive as tad
    from latentdiffeq_torch.solve.rk import Tsit5

    lat_j, u0_j, ps_j, _ = jax_generate(n_traj=args.n_traj)
    lat, u0s, ps, _ = pendulum_data.generate_dataset(n_traj=args.n_traj,
                                                     device="cpu")
    assert np.array_equal(u0s.numpy(), u0_j) and np.array_equal(
        ps.numpy(), ps_j)
    d = np.abs(lat.numpy() - np.asarray(lat_j))
    print(f"generators, float32: max |angle diff| {d[..., 0].max():.3e} "
          f"rad, max |velocity diff| {d[..., 1].max():.3e}, rows above "
          f"1e-4: {int((d.max(axis=(1, 2)) > 1e-4).sum())} of {len(d)}")

    u0_np, ps_np = pendulum_data.draw_initial_conditions(args.n_traj)
    grid = np.arange(100) * pendulum_data.DT
    jf = Pendulum().f

    def jax_solve(u0, p, saveat):
        return jax.vmap(lambda u, q: jad.solve_adaptive(
            jf, JTsit5(), u, q, saveat, jad.AdaptiveConfig()))(u0, p)

    args32 = (jnp.asarray(u0_np), jnp.asarray(ps_np),
              jnp.asarray(grid.astype(np.float32)))
    ys_jit, _, st_jit = jax.jit(jax_solve)(*args32)
    with jax.disable_jit():
        ys_eager, _, st_eager = jax_solve(*args32)
    report("JAX jitted vs eager, float32", ys_jit, st_jit, ys_eager,
           st_eager)

    with jax.enable_x64(True):
        ys_j64, _, st_j64 = jax.jit(jax_solve)(
            jnp.asarray(u0_np, jnp.float64), jnp.asarray(ps_np, jnp.float64),
            jnp.asarray(grid, jnp.float64))
    ys_t64, _, st_t64 = tad.solve_adaptive(
        pendulum_f, Tsit5(), torch.tensor(u0_np, dtype=torch.float64),
        torch.tensor(ps_np, dtype=torch.float64),
        torch.tensor(grid, dtype=torch.float64))
    report("port vs JAX, float64", ys_t64.numpy(),
           {k: v.numpy() for k, v in st_t64.items()}, ys_j64, st_j64)


if __name__ == "__main__":
    main()
