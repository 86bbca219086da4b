"""Observability: phase timers, profiler traces, NaN debugging
(counterpart of latentdiffeq/utils/profiling.py).

Wall-clock phase timers that synchronise with the card when asked, a
context manager around ``torch.profiler`` with device tracing armed before
its region, one that writes its Chrome trace, a count of the kernel
records such a trace lost, the node counts of a captured CUDA graph, and a
NaN debug switch that raises where a NaN is produced instead of letting the
NaN-fill convention flow into the loss (the counterpart of
``jax_debug_nans``).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PhaseTimer", "device_profile", "trace_profile", "PAD",
           "PAD_KERNEL", "lost_kernel_records", "graph_nodes",
           "enable_debug_nans"]


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


# device_profile's warm-up step: rounds of one launch, a wait for it and a
# host pause, ~25 ms in all, about ten times the ~2 ms of launches a window
# was seen to lose.
_ARM_ROUNDS = 20
_ARM_PAUSE_S = 1e-3

# device_profile's pads, the first and the last thing its recorded step
# runs: rounds of one spin kernel (PAD_KERNEL, ~1 us), a wait for it and a
# host pause, for _PAD_S each, inside host annotations named PAD. The
# profiler keeps a device record only if its time, mapped onto the host
# clock, falls inside the window, and on an H100 that mapping was off by
# -6.3 to +12.2 ms in some windows (the kept records' start less their
# launch's, scripts/profiler_window.py): the region's first launches, or
# its last, then lost their records, as many as ran that long after the
# window opened or before it closed (a whole 100-launch burst; both
# forward kernels of a training step). The pads, ~8 times the largest
# offset seen, take that loss; readers of the region leave their records
# out (PAD, PAD_KERNEL), and lost_kernel_records counts their launches
# apart.
PAD = "device_profile pad"
PAD_KERNEL = "spin_kernel"
_PAD_S = 0.1
_PAD_SPIN_CYCLES = 1000


def _pad():
    with torch.profiler.record_function(PAD):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < _PAD_S:
            torch.cuda._sleep(_PAD_SPIN_CYCLES)
            torch.cuda.synchronize()
            time.sleep(_ARM_PAUSE_S)


@contextlib.contextmanager
def device_profile(pads: bool = True,
                   **kwargs) -> Iterator[torch.profiler.profile]:
    """``torch.profiler.profile`` over the enclosed region (host and, when
    the process has a card, CUDA activity; ``kwargs`` go to the profiler),
    with device tracing armed before the region opens.

    A window entered right before its launches can lose the kernel
    records of the first of them: on an H100, late in a long process, the
    first 16-18 launches of a traced training step (its first ~2 ms) had
    launch records and no kernel records (``lost_kernel_records`` counts
    them). So the profile starts in a warm-up step, which launches a few
    kernels and waits for them (their records fall before the window and
    are dropped), and records from the next step on. On a card and with
    ``pads``, that step runs a pad before the region and one after it
    (spin kernels, ``PAD_KERNEL``, and waits in host annotations ``PAD``),
    so that a device clock mapped a few ms off puts none of the region's
    records outside the window; the region's device records are the
    window's less the pads'."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kwargs.setdefault("activities", acts)
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1)
    with torch.profiler.profile(schedule=sched, **kwargs) as prof:
        if cuda:
            x = torch.zeros(1, device=torch.cuda.current_device())
            for _ in range(_ARM_ROUNDS):
                x.add_(1.0)
                torch.cuda.synchronize()
                time.sleep(_ARM_PAUSE_S)
        prof.step()
        pads = cuda and pads
        if pads:
            _pad()
        yield prof
        if pads:
            _pad()


@contextlib.contextmanager
def trace_profile(logdir: str):
    """Profile the enclosed region with ``device_profile`` (host and, when
    the process has a card, CUDA activity) and write it as a Chrome trace,
    ``logdir/trace_<time>_<pid>.json`` (Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` tabulate the region and,
    on a card, ``device_profile``'s pads (a ``PAD`` row and a
    ``PAD_KERNEL`` row)."""
    os.makedirs(logdir, exist_ok=True)
    with device_profile() as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
                ".json"))


def lost_kernel_records(path: str) -> dict:
    """Kernel launches in a Chrome trace from ``torch.profiler`` whose
    launch record has no kernel record with its correlation id: their
    count (``lost``), the launches' count, whether the lost ones are the
    window's first launches, and the host time (us) from the first launch
    to the last lost one. These count the region's launches: those outside
    ``device_profile``'s pads where the trace has them, whose own launches
    and lost ones are ``pad_launches`` and ``pad_lost``."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    launches = sorted((e for e in ev
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "Launch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    kernels = {e.get("args", {}).get("correlation") for e in ev
               if e.get("cat") == "kernel"}
    pads = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in ev
            if e.get("cat") == "user_annotation" and e.get("name") == PAD]
    in_pad = [any(lo <= e["ts"] <= hi for lo, hi in pads) for e in launches]
    pad = [e for e, p in zip(launches, in_pad) if p]
    launches = [e for e, p in zip(launches, in_pad) if not p]

    def lost_in(ls):
        return [i for i, e in enumerate(ls)
                if e.get("args", {}).get("correlation") not in kernels]

    lost = lost_in(launches)
    return {"launches": len(launches), "lost": len(lost),
            "lost_are_a_prefix": lost == list(range(len(lost))),
            "lost_span_us": (launches[lost[-1]]["ts"] - launches[0]["ts"]
                             if lost else 0.0),
            "pad_launches": len(pad), "pad_lost": len(lost_in(pad))}


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


def graph_nodes(raw_graph: int) -> Dict[str, int]:
    """``{"kernel": n, "all": m}``: the kernel nodes and all the nodes of
    a captured CUDA graph, ``raw_graph`` its ``cudaGraph_t``
    (``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``), read
    with ``cuGraphGetNodes`` and ``cuGraphNodeGetType`` of libcuda."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(0), 0
    for node in nodes:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return {"kernel": kernels, "all": n.value}


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
