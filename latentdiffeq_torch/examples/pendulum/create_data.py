"""The pendulum video dataset behind a keyed cache (counterpart of
examples/pendulum/create_data.py:138-150).

    python -m latentdiffeq_torch.examples.pendulum.create_data [--device cpu]

``load_or_generate`` generates the 450 x 100 x 28 x 28 dataset with
``latentdiffeq_torch.pendulum_data.generate_dataset`` and caches it as an
npz of numpy arrays in ``DATA_DIR`` (this folder's ``data/``, never the
JAX example's). JAX's cache returns whatever file is at the path and
ignores the arguments; this one stores the generator's arguments and the
device type with the arrays (the card and the CPU differ in the last
bits) and returns a file only when they equal the call's. A file whose key
differs is regenerated and overwritten, never returned. The frames are
rendered with torch (JAX's ``renderer="native"``, its C++ host rasterizer,
is not ported yet).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from latentdiffeq_torch.core import resolve_device
from latentdiffeq_torch.pendulum_data import DT, N_TRAJ, SEED, TSPAN
from latentdiffeq_torch.pendulum_data import generate_dataset

__all__ = ["DATA_DIR", "cache_key", "load_or_generate", "write_cache",
           "main"]

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEFAULT_FILE = "pendulum_data.npz"
_NAMES = ("latent", "u0s", "ps", "frames")


def cache_key(*, diffeq=None, n_traj: int = N_TRAJ, seed: int = SEED,
              tspan=TSPAN, dt: float = DT, device=None) -> dict:
    """The generator's arguments, defaults filled in, and the device type:
    what a cached file must have been made with to be returned. The
    dynamics count by their vector field's qualified name (the generator
    integrates ``diffeq.f``; None is the frictionless pendulum)."""
    f = None if diffeq is None else diffeq.f
    name = ("latentdiffeq_torch.pendulum.pendulum_f" if f is None
            else f"{f.__module__}.{f.__qualname__}")
    return {"diffeq": name, "n_traj": int(n_traj), "seed": int(seed),
            "tspan": [float(tspan[0]), float(tspan[1])], "dt": float(dt),
            "device": resolve_device(device).type}


def _stored_key(path: str):
    try:
        with np.load(path) as d:
            return json.loads(bytes(d["cache_key"]).decode())
    except (KeyError, ValueError, OSError):
        return None


def write_cache(path: str, arrays, key: dict):
    """Write ``(latent, u0s, ps, frames)`` (tensors or arrays) with ``key``
    (``cache_key``'s) as a compressed npz, atomically."""
    out = {n: (a.detach().cpu().numpy() if hasattr(a, "detach")
               else np.asarray(a)) for n, a in zip(_NAMES, arrays)}
    out["cache_key"] = np.frombuffer(json.dumps(key, sort_keys=True)
                                     .encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)
    return tuple(out[n] for n in _NAMES)


def load_or_generate(path: str = None, **kwargs):
    """The dataset ``(latent (n, T, 2), u0s (n, 2), ps (n, 1), frames (n,
    T, 28, 28))`` as float32 numpy arrays, from the cache at ``path``
    (default ``DATA_DIR/pendulum_data.npz``) when its key equals
    ``cache_key(**kwargs)``, else generated (``generate_dataset(**kwargs)``:
    ``diffeq``, ``n_traj``, ``seed``, ``tspan``, ``dt``, ``device``) and
    cached."""
    if path is None:
        path = os.path.join(DATA_DIR, DEFAULT_FILE)
    key = cache_key(**kwargs)
    if os.path.exists(path):
        stored = _stored_key(path)
        if stored == key:
            with np.load(path) as d:
                return tuple(d[n] for n in _NAMES)
        print(f"{path}: cached with {stored}, asked for {key}; "
              "regenerating", flush=True)
    return write_cache(path, generate_dataset(**kwargs), key)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where to generate: cuda (default) or cpu")
    args = ap.parse_args(argv)
    latent, u0s, ps, frames = load_or_generate(device=args.device)
    print("latent:", latent.shape, "frames:", frames.shape,
          "mean pixel:", frames.mean())
    return latent, u0s, ps, frames


if __name__ == "__main__":
    main()
