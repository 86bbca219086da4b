"""Optimizers with Flux semantics: ADAM, ADAMW, AdaBelief, SGD, global-norm
clipping and their composition (counterpart of
latentdiffeq/train/optim.py:31-144).

Each optimizer is an object over a list of parameters that a training loop
drives as it drives a torch optimizer: ``zero_grad()``, ``step()`` (reads
each parameter's ``.grad``; a missing gradient counts as zero),
``state_arrays()`` and ``load_state_arrays()``. Built without parameters
(``params=None``) it is unbound, and ``Trainer`` binds it to its model's
parameters, so ``Trainer(model, cfg, optimizer=chain(clip_by_global_norm(
1.0), adabelief(lr=1e-3)))`` works as in JAX. The JAX package's optimizers
are pure transforms (``init``, ``update`` returning descent deltas,
``apply_updates``); here ``update(grads)`` of a bound optimizer returns the
deltas and advances its state, ``apply_updates(params, updates)`` subtracts
them, and ``step()`` is the two. ``chain`` hands each member's deltas to
the next, in order, as JAX's does.

Flux's ADAMW is ``Optimiser(ADAM(eta, beta), WeightDecay(decay))``: the
decay term is added to the Adam update and is NOT scaled by the learning
rate (update = adam(g) + decay * p; p <- p - update). That differs from
``torch.optim.AdamW`` (decay * lr), which is not used.

A parameter below float32 (bfloat16) keeps its moments in its own dtype;
each update is computed in float32 and rounded once into the parameter's
dtype (ADAM's is JAX's arithmetic, where the float32 bias corrections
promote, optim.py:69-72).

A scalar that an update reads and that changes from step to step (ADAM's
bias corrections) is a float32 tensor on the parameters' device, so that
the step's arithmetic is the same whether it comes from the host or from a
table on the card: ``step_scalars(n)`` gives the next n steps' values as
float32 numpy arrays, and ``use_step_scalars`` hands the update 0-d device
tensors read from such a table in their place (train/trainer.py's CUDA
graphs, which replay an epoch with no Python in between). ``advance(n)``
moves the step counters without a step, and ``state_tensors()`` lists the
tensors an update changes in place.

Checkpoints name an optimizer's state by JAX's pytree paths
(``state_arrays``): ``m/<path>``, ``t`` and ``v/<path>`` for ADAM(W),
``m/<path>`` and ``s/<path>`` for AdaBelief, nothing for SGD and clipping,
and ``<i>/...`` for member i of a chain.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Optimizer", "FluxAdam", "apply_updates", "adam", "adamw",
           "adabelief", "sgd", "clip_by_global_norm", "chain"]


def _compute_dtype(p: torch.Tensor) -> torch.dtype:
    return torch.promote_types(p.dtype, torch.float32)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor], updates):
    """params <- params - updates, each update rounded into its parameter's
    dtype (updates are descent deltas, as Flux's ``update!``)."""
    for p, u in zip(params, updates):
        p.sub_(u.to(p.dtype))
    return params


class Optimizer:
    """Base of the port's optimizers: a gradient transform bound to a list
    of parameters. Subclasses define ``_init_state``, ``update``,
    ``state_arrays`` and ``load_state_arrays``."""

    def __init__(self, params: Optional[Iterable[torch.Tensor]] = None):
        self.params: Optional[List[torch.Tensor]] = None
        if params is not None:
            self.bind(params)

    def bind(self, params: Iterable[torch.Tensor]) -> "Optimizer":
        """Attach to ``params`` with a fresh state. Returns self."""
        self.params = list(params)
        self._init_state()
        return self

    def _init_state(self):
        pass

    def _bound(self) -> List[torch.Tensor]:
        if self.params is None:
            raise ValueError(f"{type(self).__name__} is not bound to "
                             "parameters; pass params or call bind()")
        return self.params

    def zero_grad(self):
        for p in self._bound():
            p.grad = None

    def update(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The descent deltas for ``grads`` (one per parameter); advances
        the state."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        params = self._bound()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        apply_updates(params, self.update(grads))

    def state_arrays(self, paths: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The state as arrays named by JAX's pytree paths below
        ``opt_state`` (``paths``: the parameters' paths)."""
        return {}

    def load_state_arrays(self, arrays: Dict[str, object],
                          paths: Sequence[str]):
        """Set the state from ``state_arrays``' names (a checkpoint's)."""

    def state_tensors(self) -> List[torch.Tensor]:
        """The state tensors an update changes in place (the moments)."""
        return []

    def advance(self, n: int):
        """Move the step counters by ``n`` steps (negative: back) without
        updating anything."""

    def step_scalars(self, n: int) -> Dict[str, np.ndarray]:
        """The scalars the next ``n`` updates read that change from step to
        step, by name: float32 arrays of length n."""
        return {}

    def use_step_scalars(self, scalars: Optional[Dict[str, torch.Tensor]]):
        """Make the next updates read ``scalars`` (``step_scalars``' names,
        0-d float32 tensors on the parameters' device) in place of the
        values they compute from their step counters; None: compute them
        again."""


def _copy_into(dsts, srcs):
    with torch.no_grad():
        for dst, src in zip(dsts, srcs):
            dst.copy_(torch.as_tensor(src))


class FluxAdam(Optimizer):
    """Adam with bias correction (Flux 0.13 ADAM) plus optional decoupled
    weight decay (optim.py:52-92). ``state_dict`` / ``load_state_dict``
    (lists of moments) serve ``MultiSeedTrainer``'s stacked replicas."""

    def __init__(self, params: Optional[Iterable[torch.Tensor]] = None,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, decay: float = 0.0,
                 scale_decay_by_lr: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd = decay * lr if scale_decay_by_lr else decay
        super().__init__(params)

    def _init_state(self):
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0
        self._scalars = None

    def _corrections(self, t: int):
        """The bias corrections 1 - b^t of step ``t``, in float32 as the
        JAX package computes them (one scalar at a time: numpy's array
        power may round otherwise)."""
        t = np.float32(t)
        return (np.float32(1) - np.float32(self.b1) ** t,
                np.float32(1) - np.float32(self.b2) ** t)

    @torch.no_grad()
    def update(self, grads):
        self.t += 1
        b1, b2 = self.b1, self.b2
        params = self._bound()
        if self._scalars is not None:
            c1, c2 = self._scalars["c1"], self._scalars["c2"]
        elif params:
            c1, c2 = (torch.full((), float(c), dtype=torch.float32,
                                 device=params[0].device)
                      for c in self._corrections(self.t))
        out = []
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            ct = _compute_dtype(p)
            upd = self.lr * (m.to(ct) / c1) / (torch.sqrt(v.to(ct) / c2)
                                               + self.eps)
            if self.wd:
                upd = upd + self.wd * p
            out.append(upd)
        return out

    def state_dict(self):
        return {"m": [t.clone() for t in self.m],
                "v": [t.clone() for t in self.v], "t": self.t}

    def load_state_dict(self, state):
        _copy_into(self.m, state["m"])
        _copy_into(self.v, state["v"])
        self.t = int(state["t"])

    def state_arrays(self, paths):
        out = {f"m/{p}": a for p, a in zip(paths, self.m)}
        out["t"] = torch.tensor(self.t, dtype=torch.int32)
        out.update({f"v/{p}": a for p, a in zip(paths, self.v)})
        return out

    def load_state_arrays(self, arrays, paths):
        _copy_into(self.m, [arrays[f"m/{p}"] for p in paths])
        _copy_into(self.v, [arrays[f"v/{p}"] for p in paths])
        self.t = int(np.asarray(arrays["t"]))

    def state_tensors(self):
        return self.m + self.v

    def advance(self, n):
        self.t += n

    def step_scalars(self, n):
        c = np.array([self._corrections(t)
                      for t in range(self.t + 1, self.t + n + 1)],
                     np.float32).reshape(n, 2)
        return {"c1": c[:, 0], "c2": c[:, 1]}

    def use_step_scalars(self, scalars):
        self._scalars = scalars


class AdaBelief(Optimizer):
    """AdaBelief (Zhuang et al. 2020) with Flux 0.13's semantics, no bias
    correction (optim.py:95-113): m = b1 m + (1 - b1) g; s = b2 s +
    (1 - b2) (g - m)^2; update = lr * m / (sqrt(s) + eps)."""

    def __init__(self, params=None, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        super().__init__(params)

    def _init_state(self):
        self.m = [torch.zeros_like(p) for p in self.params]
        self.s = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads):
        b1, b2 = self.b1, self.b2
        out = []
        for p, g, m, s in zip(self._bound(), grads, self.m, self.s):
            m.mul_(b1).add_((1 - b1) * g)
            s.mul_(b2).add_((1 - b2) * (g - m) ** 2)
            ct = _compute_dtype(p)
            out.append(self.lr * m.to(ct) / (torch.sqrt(s.to(ct))
                                             + self.eps))
        return out

    def state_arrays(self, paths):
        out = {f"m/{p}": a for p, a in zip(paths, self.m)}
        out.update({f"s/{p}": a for p, a in zip(paths, self.s)})
        return out

    def load_state_arrays(self, arrays, paths):
        _copy_into(self.m, [arrays[f"m/{p}"] for p in paths])
        _copy_into(self.s, [arrays[f"s/{p}"] for p in paths])

    def state_tensors(self):
        return self.m + self.s


class SGD(Optimizer):
    """update = lr * g (optim.py:42-49)."""

    def __init__(self, params=None, lr: Optional[float] = None):
        if lr is None:
            raise ValueError("sgd needs a learning rate: sgd(lr=...)")
        self.lr = lr
        super().__init__(params)

    @torch.no_grad()
    def update(self, grads):
        return [self.lr * g.to(_compute_dtype(p))
                for p, g in zip(self._bound(), grads)]


class ClipByGlobalNorm(Optimizer):
    """Scales the gradients by min(1, max_norm / (norm + 1e-12)), norm the
    global L2 norm over every gradient (optim.py:116-128); composes with
    ``chain``. The norm is summed in float32 leaf by leaf, in order, and
    each gradient keeps its dtype."""

    def __init__(self, max_norm: float, params=None):
        self.max_norm = max_norm
        super().__init__(params)

    @torch.no_grad()
    def update(self, grads):
        sq = 0
        for g in grads:
            gf = g.to(_compute_dtype(g))
            sq = sq + torch.sum(gf * gf)
        norm = torch.sqrt(sq)
        scale = torch.clamp(self.max_norm / (norm + 1e-12), max=1.0)
        return [(g * scale).to(g.dtype) for g in grads]


class Chain(Optimizer):
    """Sequential composition (Flux's ``Optimiser(...)``,
    optim.py:131-144): each member transforms the previous member's
    output; every member is bound to the chain's parameters."""

    def __init__(self, opts: Sequence[Optimizer], params=None):
        self.opts = list(opts)
        super().__init__(params)

    def bind(self, params):
        self.params = list(params)
        for o in self.opts:
            o.bind(self.params)
        return self

    @torch.no_grad()
    def update(self, grads):
        self._bound()
        for o in self.opts:
            grads = o.update(grads)
        return grads

    def state_arrays(self, paths):
        return {f"{i}/{k}": a for i, o in enumerate(self.opts)
                for k, a in o.state_arrays(paths).items()}

    def load_state_arrays(self, arrays, paths):
        for i, o in enumerate(self.opts):
            o.load_state_arrays(_member(arrays, i), paths)

    def state_tensors(self):
        return [t for o in self.opts for t in o.state_tensors()]

    def advance(self, n):
        for o in self.opts:
            o.advance(n)

    def step_scalars(self, n):
        return {f"{i}/{k}": a for i, o in enumerate(self.opts)
                for k, a in o.step_scalars(n).items()}

    def use_step_scalars(self, scalars):
        for i, o in enumerate(self.opts):
            o.use_step_scalars(None if scalars is None
                               else _member(scalars, i))


def _member(named, i: int):
    """The entries of chain member ``i`` (``i/<name>``), without the
    prefix."""
    pre = f"{i}/"
    return {k[len(pre):]: a for k, a in named.items() if k.startswith(pre)}


def adam(params=None, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> FluxAdam:
    """Flux ADAM (optim.py:52-76); ``params=None``: unbound."""
    return FluxAdam(params, lr, b1, b2, eps)


def adamw(params=None, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          decay: float = 0.0, eps: float = 1e-8,
          scale_decay_by_lr: bool = False) -> FluxAdam:
    """Flux ADAMW (optim.py:79-92; reference: model_train.jl:138 uses
    ADAMW(1e-3, (0.9, 0.999), 0.001))."""
    return FluxAdam(params, lr, b1, b2, eps, decay, scale_decay_by_lr)


def adabelief(params=None, lr: float = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> AdaBelief:
    return AdaBelief(params, lr, b1, b2, eps)


def sgd(params=None, lr: Optional[float] = None) -> SGD:
    return SGD(params, lr)


def clip_by_global_norm(max_norm: float, params=None) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(max_norm, params)


def chain(*opts: Optimizer, params=None) -> Chain:
    return Chain(opts, params)
