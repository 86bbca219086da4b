"""The training loop (counterpart of latentdiffeq/train/trainer.py:37-139,
294-421, 717-870).

A plain per-step loop with the semantics of the JAX fused epoch: each
minibatch takes one random window shared by the batch, a variational ELBO
step with Flux ADAMW, then (``val_every_batch``) the deterministic
validation loss on the full sequences of the whole validation set
(model_train.jl:204). The best validation loss is tracked NaN-safely (a NaN
never counts as an improvement) together with the weights and optimizer
state that produced it. The JAX epoch-fusion knobs (``jit_epoch``,
``epochs_per_dispatch``, ``unroll``) only schedule work and are not ported;
nor are the curriculum and adaptive-budget options.

Randomness: a numpy generator (``seed``) permutes the training set each
epoch, a CPU ``torch.Generator`` draws the window starts, and a generator
on the training device draws the reparameterisation noise and, for SDE
dynamics, the Brownian key of each train step and validation pass (two
uint32 words, as the JAX trainer hands each a key, trainer.py:496-545).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core import resolve_device
from ..models.dynamics import SDEDynamics
from . import optim
from .annealing import frange_cycle_linear
from .checkpoint import load_checkpoint, save_checkpoint
from .losses import loss_batch

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    """Mirrors the reference's ``Args`` (model_train.jl:28-62)."""

    lr: float = 1e-3
    decay: float = 1e-3
    batch_size: int = 64
    seq_len: int = 50
    epochs: int = 1500
    seed: int = 333
    dt: float = 0.05
    variational: bool = True

    # KL annealing (model_train.jl:45-49)
    start_beta: float = 0.0
    end_beta: float = 1.0
    n_cycle: int = 4
    ratio: float = 0.9

    # the reference computes the full val loss every minibatch
    val_every_batch: bool = True
    mask_failures: bool = False
    free_bits: float = 0.0

    checkpoint_dir: str = "output"
    save_best: bool = True


class Trainer:
    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 optimizer: Optional[optim.FluxAdam] = None,
                 loss_fn: Callable = loss_batch, device=None):
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"trainer on {self.device}")
        self.model = model
        self.cfg = cfg
        self.opt = optimizer if optimizer is not None else optim.adamw(
            model.parameters(), cfg.lr, 0.9, 0.999, cfg.decay)
        self.loss_fn = loss_fn
        self.epoch = 0
        self.best_val_loss = float("inf")
        self.best = None
        self.history = []
        self.np_rng = np.random.default_rng(cfg.seed)
        self.window_gen = torch.Generator().manual_seed(cfg.seed)
        self.noise_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        decoder = getattr(model, "decoder", None)
        self._sde = isinstance(getattr(decoder, "diffeq", None), SDEDynamics)

    def _grid(self, n: int):
        return torch.arange(n, dtype=torch.float32,
                            device=self.device) * self.cfg.dt

    def _key_kw(self, key):
        """``{"key": key}`` for SDE dynamics (a key drawn from the noise
        generator when ``key`` is None), else no keyword: an ODE model's
        loss takes none."""
        if key is None and self._sde:
            key = torch.randint(0, 2 ** 32, (2,), generator=self.noise_gen,
                                device=self.device, dtype=torch.int64)
        return {} if key is None else {"key": key}

    def train_step(self, x, beta: float, *, eps=None, key=None):
        """One ELBO gradient step with ADAMW on the window ``x`` (batch,
        seq_len, features). ``eps`` and ``key`` optionally fix the
        reparameterisation noise and the Brownian path. Returns the step's
        metrics (tensors, not synchronised)."""
        cfg = self.cfg
        self.opt.zero_grad()
        loss, metrics = self.loss_fn(
            self.model, x, self._grid(x.shape[1]), beta,
            variational=cfg.variational, generator=self.noise_gen, eps=eps,
            mask_failures=cfg.mask_failures, free_bits=cfg.free_bits,
            **self._key_kw(key))
        loss.backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(self, val, beta: float, *, key=None):
        """Loss on the full validation sequences at the posterior mean
        (for SDE dynamics on one Brownian path, ``key`` or a drawn one)."""
        _, metrics = self.loss_fn(
            self.model, val, self._grid(val.shape[1]), beta,
            variational=False, mask_failures=self.cfg.mask_failures,
            free_bits=self.cfg.free_bits, **self._key_kw(key))
        return metrics

    def _window(self, x):
        seq_len = self.cfg.seq_len
        start = int(torch.randint(0, max(x.shape[1] - seq_len, 1), (1,),
                                  generator=self.window_gen))
        return x[:, start:start + seq_len]

    def _snapshot(self, epoch: int):
        return {"model": copy.deepcopy(self.model.state_dict()),
                "opt_state": self.opt.state_dict(), "epoch": epoch,
                "val": self.best_val_loss}

    def fit(self, train_set, val_set, *, epochs: Optional[int] = None,
            callbacks=(), verbose: bool = True):
        """Train on (samples, time, features) sets; returns the history of
        per-epoch summaries."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        schedule = frange_cycle_linear(cfg.epochs, cfg.start_beta,
                                       cfg.end_beta, cfg.n_cycle, cfg.ratio)
        data = torch.as_tensor(train_set, dtype=torch.float32).to(
            self.device)
        val = torch.as_tensor(val_set, dtype=torch.float32).to(self.device)
        n, T = data.shape[0], data.shape[1]
        if cfg.seq_len > T:
            raise ValueError(f"cfg.seq_len={cfg.seq_len} exceeds the data's "
                             f"sequence length T={T}")
        steps = n // cfg.batch_size
        if steps < 1:
            raise ValueError(f"batch_size={cfg.batch_size} exceeds the "
                             f"training set size n={n}")

        while self.epoch < epochs:
            ep = self.epoch
            beta = float(schedule[min(ep, len(schedule) - 1)])
            t0 = time.perf_counter()
            perm = torch.as_tensor(self.np_rng.permutation(n))
            ms, vm = [], None
            for s in range(steps):
                idx = perm[s * cfg.batch_size:(s + 1) * cfg.batch_size]
                x = self._window(data[idx.to(self.device)])
                ms.append(self.train_step(x, beta))
                if cfg.val_every_batch:
                    vm = self.val_step(val, beta)
            if vm is None:
                vm = self.val_step(val, beta)
            val_loss = float(vm["loss"])          # synchronises
            train_loss = float(torch.stack([m["loss"] for m in ms]).mean())
            rhs = int(sum(int(m["n_rhs_evals"]) for m in ms))
            wall = time.perf_counter() - t0
            rec = {"epoch": ep, "train_loss": train_loss,
                   "val_loss": val_loss, "beta": beta,
                   "seq_len": cfg.seq_len, "epoch_s": wall,
                   "rhs_evals_per_s": rhs / wall,
                   "kl": float(torch.stack([m["kl"] for m in ms]).mean()),
                   "n_failed": int(sum(int(m["n_failed"]) for m in ms))}
            self.history.append(rec)
            if verbose:
                print(f"epoch {ep:4d}  loss {train_loss:10.4f}  "
                      f"val {val_loss:10.4f}  beta {beta:.3f}  "
                      f"{wall:7.3f}s", flush=True)
            self.epoch += 1
            # NaN-safe: a NaN val loss compares False and never replaces
            # the last real best
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self.best = self._snapshot(ep)
                if cfg.save_best:
                    self.save(f"{cfg.checkpoint_dir}/best_model.npz")
            for cb in callbacks:
                cb(self, rec)
        return self.history

    def save(self, path: str):
        save_checkpoint(path, self.model, self.opt,
                        meta={"epoch": self.epoch,
                              "best_val_loss": self.best_val_loss})

    def restore(self, path: str):
        meta = load_checkpoint(path, self.model, self.opt)
        self.epoch = int(meta.get("epoch", 0))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        return self
