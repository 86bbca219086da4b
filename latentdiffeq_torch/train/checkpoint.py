"""Checkpoints and the JAX weight bridge (counterpart of
latentdiffeq/train/checkpoint.py).

The port's modules name and register their parameters as the JAX pytree
does, so ``named_parameters()`` with '.' read as '/' yields the JAX key
paths (``_path_str`` in the JAX package, e.g.
``encoder/pattern_extractor/1/cells/0/Wi``) in JAX flatten order.

Both JAX ``.npz`` formats load:
  v2: ``leaf::<path>`` keys plus ``__meta__`` = {"format_version", "meta",
      "paths"}; paths such as ``model/encoder/feature_extractor/layers/0/W``.
  v1: ``leaf_{i}`` keys in flatten order, ``__meta__`` = the user meta.
      Files written by the JAX Trainer hold the tree {"key", "model",
      "opt_state"}: leaf_0 is the PRNG key, then the model's n leaves,
      then Adam's m (n), t (1) and v (n).
The port writes v2. An optimizer's state lies under ``opt_state/`` by
JAX's pytree paths (``train/optim.py``: ``m``, ``t``, ``v`` for ADAM(W),
``m``, ``s`` for AdaBelief, ``<i>/...`` in a chain); a Trainer checkpoint
also holds its random streams (``window_gen`` and ``noise_gen`` arrays,
``np_rng`` in the meta, as JAX's Trainer stores its ``np_rng``). A
population (train/multiseed.py) is one v2 file of stacked arrays
(``save_arrays``); each of its replicas can also be written as a Trainer
checkpoint (``trainer_arrays``), which ``load_checkpoint`` reads into a
single model.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["jax_param_paths", "load_jax_params", "save_checkpoint",
           "load_checkpoint", "save_arrays", "load_arrays",
           "trainer_arrays", "FORMAT_VERSION"]

FORMAT_VERSION = 2
_LEAF_PREFIX = "leaf::"


def jax_param_paths(model: torch.nn.Module) -> List[str]:
    """The model's parameter paths in JAX flatten order."""
    return [name.replace(".", "/") for name, _ in model.named_parameters()]


def load_jax_params(model: torch.nn.Module, arrays: Dict[str, np.ndarray]):
    """Copy arrays keyed by JAX key-path strings into ``model``. The key
    set must equal the model's paths and every shape must match."""
    params = dict(zip(jax_param_paths(model), model.parameters()))
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError(f"JAX params do not match the model: missing "
                         f"{missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for path, p in params.items():
            a = np.asarray(arrays[path])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"'{path}': array shape {a.shape} != "
                                 f"parameter shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)).to(p.dtype))
    return model


def _np(t):
    """An npz-safe array: bfloat16, which numpy has no type for, is stored
    as float32, which holds every bfloat16 value exactly (JAX
    checkpoint.py:69-76); loading casts back to the parameter's dtype."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def trainer_arrays(paths, params, m=None, v=None, t=None):
    """The arrays of a Trainer checkpoint: ``model/<path>`` for each of
    ``params`` (in the order of ``paths``), and with Adam's moments ``m``,
    ``v`` and step ``t`` its state in JAX flatten order (m, t, v)."""
    out = {f"model/{p}": _np(a) for p, a in zip(paths, params)}
    if m is not None:
        out.update({f"opt_state/m/{p}": _np(a) for p, a in zip(paths, m)})
        out["opt_state/t"] = np.asarray(t, np.int32)
        out.update({f"opt_state/v/{p}": _np(a) for p, a in zip(paths, v)})
    return out


def save_arrays(path: str, arrays: Dict[str, np.ndarray],
                meta: Optional[dict] = None):
    """Write named arrays and a JSON-able ``meta`` as a format-v2 ``.npz``
    (atomically: a temporary file, then a rename)."""
    names = list(arrays)
    blob = {"format_version": FORMAT_VERSION, "meta": meta or {},
            "paths": names}
    out = {_LEAF_PREFIX + k: arrays[k] for k in names}
    out["__meta__"] = np.frombuffer(json.dumps(blob).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **out)
    os.replace(tmp, path)


def load_arrays(path: str):
    """The named arrays and the meta of a format-v2 ``.npz``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    with np.load(path) as data:
        blob = json.loads(bytes(data["__meta__"]).decode())
        if "format_version" not in blob:
            raise ValueError(f"{path} is not a format-v2 checkpoint")
        arrays = {k: data[_LEAF_PREFIX + k] for k in blob["paths"]}
    return arrays, blob.get("meta", {})


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    meta: Optional[dict] = None,
                    arrays: Optional[Dict[str, np.ndarray]] = None):
    """Write ``{"model", "opt_state"}`` as a format-v2 ``.npz``: the
    optimizer's state under its JAX pytree paths
    (``Optimizer.state_arrays``), and ``arrays``, more named arrays beside
    them (the Trainer's random streams)."""
    paths = jax_param_paths(model)
    out = trainer_arrays(paths, list(model.parameters()))
    if optimizer is not None:
        out.update({f"opt_state/{k}": _np(a) for k, a in
                    optimizer.state_arrays(paths).items()})
    out.update(arrays or {})
    save_arrays(path, out, meta)


def _split_v1(data, paths):
    n = len(paths)
    stored = len([k for k in data.files if k != "__meta__"])
    leaf = lambda i: data[f"leaf_{i}"]  # noqa: E731
    if stored == n:                       # a bare model tree
        return {p: leaf(i) for i, p in enumerate(paths)}, {}
    if stored == 3 * n + 2:               # {"key", "model", "opt_state"}
        model = {p: leaf(1 + i) for i, p in enumerate(paths)}
        opt = {f"m/{p}": leaf(1 + n + i) for i, p in enumerate(paths)}
        opt["t"] = leaf(1 + 2 * n)
        opt.update({f"v/{p}": leaf(2 + 2 * n + i)
                    for i, p in enumerate(paths)})
        return model, opt
    raise ValueError(f"legacy (v1) checkpoint has {stored} leaves; a model "
                     f"with {n} parameters expects {n} or {3 * n + 2}")


def _split_v2(data, names):
    """The model's arrays, the optimizer's (names below ``opt_state/``) and
    the rest (other than the JAX Trainer's ``key``)."""
    parts = ({}, {}, {})
    for k in names:
        a = data[_LEAF_PREFIX + k]
        if k.startswith("model/"):
            parts[0][k[len("model/"):]] = a
        elif k.startswith("opt_state/"):
            parts[1][k[len("opt_state/"):]] = a
        elif k != "key":
            parts[2][k] = a
    return parts


def _load_optimizer(optimizer, opt, paths, path):
    """Set ``optimizer``'s state from a checkpoint's ``opt_state`` arrays;
    their names must be the optimizer's (JAX raises on the same
    mismatch)."""
    want = set(optimizer.state_arrays(paths))
    if set(opt) != want:
        raise ValueError(
            f"{path}: its optimizer state does not fit "
            f"{type(optimizer).__name__}: missing "
            f"{sorted(want - set(opt))[:4]}, unexpected "
            f"{sorted(set(opt) - want)[:4]}")
    optimizer.load_state_arrays(opt, paths)


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None, *,
                    arrays: Optional[dict] = None):
    """Load a JAX or port ``.npz`` (v1 or v2) into ``model``, and into
    ``optimizer`` when given and the file holds an optimizer state.
    ``arrays``: a dict that receives the file's other named arrays (v2).
    Returns the stored user meta dict."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    paths = jax_param_paths(model)
    with np.load(path) as data:
        blob = json.loads(bytes(data["__meta__"]).decode())
        if "format_version" in blob:
            meta = blob.get("meta", {})
            params, opt, rest = _split_v2(data, blob["paths"])
        else:
            meta = blob
            (params, opt), rest = _split_v1(data, paths), {}
    load_jax_params(model, params)
    if optimizer is not None and opt:
        _load_optimizer(optimizer, opt, paths, path)
    if arrays is not None:
        arrays.update(rest)
    return meta
