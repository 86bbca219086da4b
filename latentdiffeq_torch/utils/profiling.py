"""Observability: phase timers, profiler traces, NaN debugging
(counterpart of latentdiffeq/utils/profiling.py).

Wall-clock phase timers that synchronise with the card when asked, a
context manager around ``torch.profiler`` that writes a Chrome trace, and a
NaN debug switch that raises where a NaN is produced instead of letting the
NaN-fill convention flow into the loss (the counterpart of
``jax_debug_nans``).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PhaseTimer", "trace_profile", "enable_debug_nans"]


def _cuda_devices(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class PhaseTimer:
    """Accumulating per-phase wall-clock timer.

    >>> timer = PhaseTimer()
    >>> with timer("solve", block_on=u0s):
    ...     ys = solve(u0s, ...)
    >>> timer.summary()
    {'solve': {'total_s': ..., 'count': ..., 'mean_ms': ...}}

    CUDA launches are asynchronous: pass tensors of the region's card as
    ``block_on`` (a tensor, or lists, tuples and dicts of them) and the
    timer synchronises each card they lie on, so all the region's work
    there, before it stops the clock (JAX's ``jax.block_until_ready``).
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                for dev in _cuda_devices(block_on, set()):
                    torch.cuda.synchronize(dev)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1e3 * self.totals[k] /
                                 max(self.counts[k], 1), 3)}
            for k in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (host and, when
    the process has a card, CUDA activity) and write it as a Chrome trace,
    ``logdir/trace_<time>_<pid>.json`` (Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` tabulate the region."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
                ".json"))


# Operations that make tensors without computing them: a NaN they hold is
# a constant (GOKU's NaN fill of failed rows) or uninitialised memory, not
# one produced by arithmetic.
_FACTORIES = frozenset({
    "aten::full", "aten::full_like", "aten::new_full", "aten::fill_",
    "aten::fill", "aten::empty", "aten::empty_like", "aten::new_empty",
    "aten::empty_strided", "aten::new_empty_strided", "aten::scalar_tensor",
    "aten::lift_fresh", "aten::_to_copy", "aten::copy_", "aten::clone",
    "aten::detach", "aten::view", "aten::_unsafe_view", "aten::alias",
    "aten::slice", "aten::select", "aten::expand", "aten::t",
    "aten::transpose", "aten::permute", "aten::unsqueeze", "aten::squeeze",
    "aten::reshape", "aten::as_strided"})


class _RaiseOnNaN(TorchDispatchMode):
    """Checks the floating outputs of every operation that computes them,
    in the forward and (on the thread that runs it) the backward."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name not in _FACTORIES:
            flat = out if isinstance(out, (tuple, list)) else (out,)
            for t in flat:
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {name}")
        return out


_DEBUG_NANS: Optional[_RaiseOnNaN] = None


def enable_debug_nans(on: bool = True):
    """Debug mode: raise ``FloatingPointError`` where an operation produces
    a NaN, in the forward as ``jax_debug_nans`` does, instead of letting
    the NaN-fill convention flow into the loss; the backward also runs
    under autograd's anomaly mode with its NaN check (which raises
    ``RuntimeError`` naming the backward function).

    The check is stricter than JAX's under ``jit``, which looks at a
    compiled function's outputs and only then finds the operation: each
    operation here is checked as it runs, so a NaN that a later mask would
    remove (``mask_failures``) raises too.

    Cost: every operation then returns through Python and checks its
    output, a reduction and a host synchronisation each (on the card the
    step runs at the speed of its launches one by one), and anomaly mode
    keeps a traceback a node. It does nothing unless switched on, and it
    applies to the thread that switched it on."""
    global _DEBUG_NANS
    torch.autograd.set_detect_anomaly(on, check_nan=True)
    if on and _DEBUG_NANS is None:
        _DEBUG_NANS = _RaiseOnNaN()
        _DEBUG_NANS.__enter__()
    elif not on and _DEBUG_NANS is not None:
        _DEBUG_NANS.__exit__(None, None, None)
        _DEBUG_NANS = None
