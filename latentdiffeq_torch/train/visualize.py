"""Per-epoch visualization (counterpart of latentdiffeq/train/visualize.py;
reference: examples/pendulum_friction-less/model_train.jl:244-290).

``visualize_val_image`` picks a random validation sample and window (the
same two ``rng.integers`` draws as the JAX function), runs the model
non-variationally (an SDE model on the Brownian path of ``PRNGKey(0)``,
the key JAX passes), and draws two panels into a PNG at ``path``: the
inferred latent angle against the true one on twin axes, and a true-over-
predicted frame mosaic (every 6th frame) titled with the true and the
inferred pendulum length. ``val_image_data`` returns the numbers plotted.
The figure is drawn with Pillow (JAX's with matplotlib), the same two
panels in a plainer style.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import random as jr

__all__ = ["val_image_data", "visualize_val_image"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


@torch.no_grad()
def val_image_data(model, val_set, val_latent, val_ps, *, vis_len: int,
                   dt: float, rng: Optional[np.random.Generator] = None):
    """The numbers ``visualize_val_image`` plots: the sample ``j`` and the
    window start ``s`` (drawn from ``rng`` as visualize.py:35-39 draws
    them), the window ``x`` (vis_len, pixels), the model's ``x_hat`` and
    latent ``z`` over it, the true latent window, the true length and the
    inferred one (``theta_hat``, None for a model without a theta head)."""
    rng = rng or np.random.default_rng()
    j = int(rng.integers(0, val_set.shape[0]))
    full = val_set.shape[1]
    vis_len = min(vis_len, full)
    s = int(rng.integers(0, max(full - vis_len, 1)))
    dev = next(model.parameters()).device
    x = torch.as_tensor(val_set[j:j + 1, s:s + vis_len],
                        dtype=torch.float32).to(dev)
    t = torch.arange(vis_len, dtype=torch.float32, device=dev) * dt
    (x_hat, z_hat, l_hat), _, _, _ = model(
        x, t, variational=False, key=jr.PRNGKey(0, device=dev))
    theta_hat = None
    if isinstance(l_hat, tuple):
        theta_hat = float(_host(l_hat[1]).ravel()[0])
    return {"j": j, "s": s, "vis_len": vis_len, "x": _host(x)[0],
            "x_hat": _host(x_hat)[0], "z": _host(z_hat)[0],
            "true_latent": _host(val_latent[j])[s:s + vis_len],
            "true_p": float(_host(val_ps[j]).ravel()[0]),
            "theta_hat": theta_hat}


def _mosaic(d, h: int, w: int):
    """True frames over predicted ones, every 6th (model_train.jl:269)."""
    sel = np.arange(0, d["vis_len"], 6)
    return np.concatenate([
        np.concatenate([d["x"][i].reshape(h, w) for i in sel], axis=1),
        np.concatenate([np.clip(d["x_hat"][i].reshape(h, w), 0, 1)
                        for i in sel], axis=1)], axis=0)


def _label(d):
    label = f"True Pendulum Length = {d['true_p']:.2f}"
    if d["theta_hat"] is not None:
        label += f"   Inferred = {d['theta_hat']:.2f}"
    return label


def _draw(d, mosaic, path):
    from PIL import Image, ImageDraw

    W, top, pad = 800, 260, 50
    scale = max(1, (W - 2 * pad) // mosaic.shape[1])
    tile = Image.fromarray((mosaic * 255).round().astype(np.uint8)).resize(
        (mosaic.shape[1] * scale, mosaic.shape[0] * scale), Image.NEAREST)
    img = Image.new("RGB", (W, top + 40 + tile.height + 10), "white")
    g = ImageDraw.Draw(img)
    x0, x1, y0, y1 = pad, W - pad, 30, top - 30
    g.rectangle((x0, y0, x1, y1), outline="black")
    g.text((W // 2 - 80, 8), "Sample from validation set", fill="black")
    g.text((W // 2 - 12, top - 22), "time", fill="black")
    g.text((x0, y0 - 14), "inferred angle", fill=(75, 0, 130))
    g.text((x1 - 60, y0 - 14), "true angle", fill=(255, 140, 0))
    for series, color in ((d["z"][:, 0], (75, 0, 130)),
                          (d["true_latent"][:, 0], (255, 140, 0))):
        v = np.asarray(series, np.float64)
        lo, hi = float(np.nanmin(v)), float(np.nanmax(v))
        span = hi - lo if hi > lo else 1.0
        n = max(len(v) - 1, 1)
        pts = [(x0 + (x1 - x0) * i / n, y1 - (y1 - y0) * (a - lo) / span)
               for i, a in enumerate(v) if np.isfinite(a)]
        if len(pts) > 1:
            g.line(pts, fill=color, width=2)
    g.text((pad, top + 10), _label(d), fill="gray")
    img.paste(tile, ((W - tile.width) // 2, top + 40))
    img.save(path)


def visualize_val_image(model, val_set, val_latent, val_ps, *, vis_len: int,
                        dt: float, h: int, w: int, path: str,
                        rng: Optional[np.random.Generator] = None):
    """``val_set``: (n, T, pixels); ``val_latent``: (n, T, 2); ``val_ps``:
    (n, 1), numpy arrays or tensors. Saves a PNG to ``path`` (visualize.py:
    22-83). Returns ``val_image_data``'s numbers."""
    d = val_image_data(model, val_set, val_latent, val_ps, vis_len=vis_len,
                       dt=dt, rng=rng)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _draw(d, _mosaic(d, h, w), path)
    return d
