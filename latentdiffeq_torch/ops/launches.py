"""The kernel wrappers' launch counters and their plain versions' call
counters, read and moved as one.

Each wrapper adds one to its counter where it launches its kernel, so a
counter counts the wrapper's calls. A CUDA graph replays the kernels it
captured without calling any wrapper: ``train/trainer.py`` takes what each
counter gained while an epoch was captured (``snapshot`` before and after,
``gained``), puts the counters back (the capture ran nothing), and adds the
gain on every replay (``add``), so that the counters keep counting the
kernels that ran. The RK launchers count by kernel instance, in a dict. A
population's launches with a replica axis (``goku_heads`` on a (B, S) grid,
the vmapped RK solve, ``node_field`` with grid z the replica) count one a
call in the same counters, so a captured population epoch's counts replay
the same way."""
from __future__ import annotations

from typing import Dict, Union

from . import node_cuda, ode_cuda, recurrent_cuda

__all__ = ["snapshot", "gained", "restore", "add", "reset"]

Counts = Dict[str, Union[int, Dict[str, int]]]


def _counters():
    """{name: (holder, attribute)} of every counter."""
    return {
        "goku_heads": (recurrent_cuda.goku_heads_cuda, "launches"),
        "goku_heads[bf16]": (recurrent_cuda.goku_heads_cuda,
                             "bf16_launches"),
        "goku_heads_bwd": (recurrent_cuda.goku_heads_bwd_cuda, "launches"),
        "goku_heads_bwd[bf16]": (recurrent_cuda.goku_heads_bwd_cuda,
                                 "bf16_launches"),
        "rk_fixed_grid": (ode_cuda.solve_fixed_grid_batched_cuda,
                          "launches"),
        "rk_fixed_grid_bwd": (ode_cuda.solve_fixed_grid_batched_bwd_cuda,
                              "launches"),
        "node_field_fwd": (node_cuda.solve_neural_field_cuda, "launches"),
        "node_field_bwd": (node_cuda.neural_field_sweep_cuda, "launches"),
        "node_field_dw": (node_cuda.neural_field_dw_cuda, "launches"),
        "plain goku_heads": (recurrent_cuda.goku_heads_reference, "calls"),
        "plain rk_fixed_grid": (ode_cuda.solve_fixed_grid_batched_reference,
                                "calls"),
    }


def snapshot() -> Counts:
    """Every counter's value (a copy of the RK launchers' dicts)."""
    out = {}
    for name, (holder, attr) in _counters().items():
        v = getattr(holder, attr)
        out[name] = dict(v) if isinstance(v, dict) else v
    return out


def gained(before: Counts, after: Counts) -> Counts:
    """What each counter gained from ``before`` to ``after``."""
    out = {}
    for name, a in after.items():
        b = before[name]
        if isinstance(a, dict):
            out[name] = {k: n - b.get(k, 0) for k, n in a.items()
                         if n != b.get(k, 0)}
        else:
            out[name] = a - b
    return out


def restore(counts: Counts):
    """Set every counter to ``counts`` (the RK launchers' dicts in
    place)."""
    for name, (holder, attr) in _counters().items():
        v = counts[name]
        if isinstance(v, dict):
            d = getattr(holder, attr)
            d.clear()
            d.update(v)
        else:
            setattr(holder, attr, v)


def add(delta: Counts):
    """Add ``delta`` (from ``gained``) to the counters."""
    for name, (holder, attr) in _counters().items():
        v = delta[name]
        if isinstance(v, dict):
            d = getattr(holder, attr)
            for k, n in v.items():
                d[k] = d.get(k, 0) + n
        else:
            setattr(holder, attr, getattr(holder, attr) + v)


def reset():
    """Every counter to 0."""
    restore({k: {} if isinstance(v, dict) else 0
             for k, v in snapshot().items()})
