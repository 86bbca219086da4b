"""Pendulum video dataset generation (counterpart of
examples/pendulum/create_data.py:31-135; reference:
examples/pendulum_friction-less/create_data.jl).

Draws the initial conditions and lengths with the same numpy calls on
``default_rng(seed)`` as the JAX package, so they are identical;
integrates the true pendulum as the JAX generator does, with adaptive
Tsit5 at the default tolerances (rtol 1e-3, atol 1e-6) and dense output
on the frame grid, batched over the trajectories; and rasterises every
frame at once with a vectorised anti-aliased torch renderer of the same
geometry: pivot at (0, -8.5), a fixed visual rod length of 19 px, disc
radius 1.75, rod width 3.75, a black tick across the rod midpoint and a
black hub on the pivot.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core import resolve_device
from .pendulum import Pendulum
from .solve.adaptive import AdaptiveConfig, solve_adaptive
from .solve.rk import Tsit5

__all__ = ["TSPAN", "DT", "N_TRAJ", "SEED", "HIGH_DIM_ARGS", "H", "W",
           "draw_initial_conditions", "render_frames", "generate_dataset"]

TSPAN = (0.0, 4.95)
DT = 0.05                      # -> 100 frames
U0_RANGE = np.array([[-np.pi / 6, np.pi / 6],
                     [-np.pi / 3, np.pi / 3]])
P_RANGE = (1.0, 2.0)
N_TRAJ = 450
SEED = 1
HIGH_DIM_ARGS = (19.0, 1.75, 3.75)   # visual length, disc radius, rod width
H = W = 28


def draw_initial_conditions(n_traj: int = N_TRAJ, seed: int = SEED):
    """(u0s (n, 2), ps (n, 1)) float32 numpy arrays, drawn exactly as
    create_data.py:113-119 draws them."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(P_RANGE[0], P_RANGE[1], (n_traj, 1)).astype(np.float32)
    u0s = np.stack([rng.uniform(U0_RANGE[i, 0], U0_RANGE[i, 1], n_traj)
                    for i in range(2)], axis=1).astype(np.float32)
    return u0s, ps


def _aa(dist, edge):
    """1-px anti-aliased coverage for distance below ``edge``."""
    return torch.clamp(edge - dist + 0.5, 0.0, 1.0)


def render_frames(angles, *, pendulum_length: float = HIGH_DIM_ARGS[0],
                  radius: float = HIGH_DIM_ARGS[1],
                  rod_thickness: float = HIGH_DIM_ARGS[2],
                  h: int = H, w: int = W):
    """Rasterise frames for any shape of ``angles`` (radians from
    vertical-down): returns ``angles.shape + (h, w)`` in [0, 1], on the
    angles' device (create_data.py:48-93)."""
    dev, dt = angles.device, angles.dtype
    ys = torch.arange(h, dtype=dt, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=dt, device=dev) - (w - 1) / 2.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")

    a = angles[..., None, None]
    pivot = (0.0, -8.5)
    a1 = math.pi / 2 + a
    bob = (pivot[0] + pendulum_length * torch.cos(a1),
           pivot[1] + pendulum_length * torch.sin(a1))

    def disc(center, r):
        return _aa(torch.hypot(px - center[0], py - center[1]), r)

    def capsule(p0, p1, half_w):
        vx, vy = p1[0] - p0[0], p1[1] - p0[1]
        L2 = vx * vx + vy * vy
        t = torch.clamp(((px - p0[0]) * vx + (py - p0[1]) * vy) / L2, 0, 1)
        cx = p0[0] + t * vx
        cy = p0[1] + t * vy
        return _aa(torch.hypot(px - cx, py - cy), half_w)

    white = torch.maximum(disc(bob, radius), disc(pivot, radius))
    white = torch.maximum(white, capsule(pivot, bob, rod_thickness / 2))

    mid = ((pivot[0] + bob[0]) / 2, (pivot[1] + bob[1]) / 2)
    norm = torch.clamp(torch.hypot(bob[0] - pivot[0], bob[1] - pivot[1]),
                       min=1e-6)
    rod = ((bob[0] - pivot[0]) / norm, (bob[1] - pivot[1]) / norm)
    perp = (-rod[1], rod[0])
    tick_half = 2.4
    tick = capsule((mid[0] - tick_half * perp[0], mid[1] - tick_half * perp[1]),
                   (mid[0] + tick_half * perp[0], mid[1] + tick_half * perp[1]),
                   0.5)
    hub = disc(pivot, radius / 2)
    return white * (1 - tick) * (1 - hub)


def generate_dataset(*, n_traj: int = N_TRAJ, seed: int = SEED,
                     tspan=TSPAN, dt: float = DT, diffeq=None,
                     device=None, renderer: str = "torch"):
    """The pendulum video dataset on ``device`` (default: the card).

    Returns ``(latent (n, T, 2), u0s (n, 2), ps (n, 1), frames (n, T, H,
    W))`` float32 tensors, frames in [0, 1]. Raises unless every
    trajectory's solve succeeds. ``renderer``: ``"torch"`` draws the frames
    with ``render_frames`` on ``device``, ``"native"`` with the C++ host
    rasterizer (``utils.native``; the same geometry, the card left free,
    create_data.py:128-132)."""
    if renderer not in ("torch", "native"):
        raise ValueError(f"renderer must be 'torch' or 'native', got "
                         f"{renderer!r}")
    device = resolve_device(device)
    if diffeq is None:
        diffeq = Pendulum()
    T = int(round((tspan[1] - tspan[0]) / dt)) + 1
    u0s_np, ps_np = draw_initial_conditions(n_traj, seed)
    saveat = torch.as_tensor(tspan[0] + dt * np.arange(T), dtype=torch.float32,
                             device=device)
    u0s = torch.as_tensor(u0s_np, device=device)
    ps = torch.as_tensor(ps_np, device=device)
    with torch.no_grad():
        latent, ok, _ = solve_adaptive(diffeq.f, Tsit5(), u0s, ps, saveat,
                                       AdaptiveConfig())
        if not bool(ok.all()):
            raise RuntimeError("data-generation solves must succeed")
        if renderer == "native":
            from .utils.native import native_render_trajectories
            frames = torch.from_numpy(native_render_trajectories(
                latent[..., 0].cpu().numpy())).to(device)
        else:
            frames = render_frames(latent[..., 0])
    return latent, u0s, ps, frames
