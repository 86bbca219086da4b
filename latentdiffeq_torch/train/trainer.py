"""The training loop (counterpart of latentdiffeq/train/trainer.py:37-139,
294-421, 717-870).

A plain per-step loop with the semantics of the JAX fused epoch: each
minibatch takes one random window shared by the batch, a variational ELBO
step with Flux ADAMW, then (``val_every_batch``) the deterministic
validation loss on the full sequences of the whole validation set
(model_train.jl:204). The best validation loss is tracked NaN-safely (a NaN
never counts as an improvement) together with the weights and optimizer
state that produced it. The JAX epoch-fusion knobs (``jit_epoch``,
``epochs_per_dispatch``, ``unroll``) only schedule work and are not ported.

Curricula (trainer.py:55-78, 163-173): ``progressive_training`` ramps the
window length over the first ``prog_training_duration`` epochs
(``_prog_seq_lengths``); each epoch trains on windows of its length.
``masked_curriculum`` is taken for parity with the JAX option and trains the
same sliced windows. JAX's masked mode keeps a ``seq_len`` buffer with the
length carried as ``cur_len`` only so that its fused blocks compile once; it
draws the same starts and averages the loss over the same frames, so its
steps equal the sliced ones. The port runs per step and has no fused
blocks, and the sliced windows keep the encoder on its kernel and solve only
the epoch's frames. ``loss_batch(cur_len=)`` still takes the masked form.

``autosize_adaptive`` (trainer.py:103-139, 176-276, 673-712) probes the
adaptive solve once at the start of a fit and shrinks the dynamics' step
budget (and, for SDEs, the Brownian tree's depth cap) to what the data
needs; ``autosize_adaptive_budget`` runs the probe on demand.

Randomness: a numpy generator (``seed``) permutes the training set each
epoch, a CPU ``torch.Generator`` draws the window starts, and a generator
on the training device draws the reparameterisation noise and, for SDE
dynamics, the Brownian key of each train step and validation pass (two
uint32 words, as the JAX trainer hands each a key, trainer.py:496-545).
``save`` stores the three streams with the weights and the optimizer's
state, so a run restored from it goes on exactly as if it had not stopped
(trainer.py:873-913 stores ``np_rng`` and the key). The noise generator's
state is the device's own (Philox on the card, mt19937 on the CPU): a
checkpoint restored on the other device type reseeds it from ``seed``,
with a warning, and restores the other two.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .. import random as jr
from ..core import resolve_device
from ..models.dynamics import ODEDynamics, SDEDynamics
from . import optim
from .annealing import frange_cycle_linear
from .checkpoint import load_checkpoint, save_checkpoint
from .data import sample_window
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

    # progressive observation training (model_train.jl:53-56): window
    # lengths ramp from start_seq_len to seq_len over the first
    # prog_training_duration epochs, rounded up to multiples of
    # prog_seq_len_step (None: one length per epoch, as the reference)
    progressive_training: bool = False
    prog_training_duration: int = 200
    start_seq_len: int = 10
    prog_seq_len_step: Optional[int] = 5
    # parity with JAX's masked curriculum, which trains the same sliced
    # windows (module docstring)
    masked_curriculum: bool = False

    # the reference computes the full val loss every minibatch
    val_every_batch: bool = True
    mask_failures: bool = False
    free_bits: float = 0.0

    checkpoint_dir: str = "output"
    save_best: bool = True

    # probe-size the adaptive step budget at the start of fit() (see
    # _autosize_probe): max_steps = ceil(autosize_safety * the probe's
    # attempts), at its autosize_quantile over the rows (< 1 needs
    # mask_failures); an SDE's depth_cap shrinks to the probe's deepest
    # refinement + autosize_depth_margin. No-op for fixed-grid dynamics.
    autosize_adaptive: bool = False
    autosize_safety: float = 1.5
    autosize_quantile: float = 1.0
    autosize_depth_margin: int = 2


def _prog_seq_lengths(cfg: TrainConfig) -> np.ndarray:
    """Progressive curriculum lengths (model_train.jl:142-147)."""
    if not cfg.progressive_training:
        return np.array([], dtype=int)
    r = np.linspace(cfg.start_seq_len, cfg.seq_len,
                    cfg.prog_training_duration)
    lengths = np.round(r).astype(int)
    if cfg.prog_seq_len_step:
        s = cfg.prog_seq_len_step
        lengths = np.minimum(-(-lengths // s) * s, cfg.seq_len)
    return lengths


def _epoch_length(cfg: TrainConfig, prog, epoch: int) -> int:
    """An epoch's window length: the curriculum's, ``seq_len`` past the
    ramp."""
    return int(prog[epoch]) if epoch < len(prog) else cfg.seq_len


def _autosize_probe(model, cfg: TrainConfig, train_set, seq_len=None,
                    safety=None, floor: int = 16, verbose: bool = False):
    """The probe behind ``autosize_adaptive_budget`` (trainer.py:176-276):
    encode the first ``batch_size`` training rows with the current weights
    (posterior means, no gradient), map them through latent_out, solve each
    row adaptively once and size the budget from its attempts (accepted +
    rejected steps): ``max(floor, ceil(safety * target))``, target the
    largest attempts or their ``autosize_quantile``, never above the
    configured effective budget. For SDE dynamics the rows take the keys
    ``split(PRNGKey(0), B)`` (the JAX probe's) and ``depth_cap`` shrinks to
    the deepest refinement + ``autosize_depth_margin``. Returns
    ``(sized max_steps, new dynamics)``, or ``(None, None)`` for dynamics
    that are not adaptive or when a probe row fails (no evidence that the
    budget can shrink)."""
    from ..solve.adaptive import solve_adaptive
    from ..solve.sde import solve_sde_adaptive

    seq_len = seq_len or cfg.seq_len
    safety = cfg.autosize_safety if safety is None else safety
    de = model.decoder.diffeq
    is_ode = isinstance(de, ODEDynamics) and de.options.adaptive
    is_sde = isinstance(de, SDEDynamics) and de.adaptive
    if not (is_ode or is_sde):
        return None, None
    acfg = de.options.adaptive_cfg if is_ode else de.adaptive_cfg
    dev = next(model.parameters()).device
    x = torch.as_tensor(train_set[:cfg.batch_size, :seq_len],
                        dtype=torch.float32).to(dev)
    t = torch.arange(seq_len, dtype=torch.float32, device=dev) * cfg.dt
    with torch.no_grad():
        mu, _ = model.encoder(x)
        z0, th = (a.detach().float() for a in
                  model.model_type.apply_latent_out(model.decoder, mu))
        if is_ode:
            _, ok, st = solve_adaptive(de.f, de.solver, z0, th, t, acfg)
            depths = None
        else:
            keys = jr.split(jr.PRNGKey(0, device=dev), z0.shape[0])
            _, ok, st = solve_sde_adaptive(de.f, de.g, de.solver, z0, th, t,
                                           keys, acfg)
            depths = st["max_depth"].cpu().numpy()
        attempts = (st["n_accepted"] + st["n_rejected"]).cpu().numpy()
    if not bool(ok.all()):
        return None, None   # capped probe: no evidence the budget shrinks
    q = float(cfg.autosize_quantile)
    if q < 1.0 and not cfg.mask_failures:
        raise ValueError(
            "autosize_quantile < 1 sizes the step budget below the probe's "
            "worst trajectory, so tail trajectories are expected to NaN-"
            "fill; without mask_failures=True those NaNs poison the whole "
            "batch loss and gradients. Set TrainConfig(mask_failures=True) "
            "(or autosize_quantile=1.0).")
    if not cfg.mask_failures:
        warnings.warn(
            "autosize_adaptive with mask_failures=False: if training later "
            "stiffens the dynamics past the probe-sized budget, solves "
            "NaN-fill and the unmasked loss/gradients go NaN, corrupting "
            "the run. Prefer TrainConfig(mask_failures=True).",
            stacklevel=3)
    target = (int(attempts.max()) if q >= 1.0
              else int(math.ceil(float(np.quantile(attempts, q)))))
    sized = max(floor, int(math.ceil(safety * target)))
    # never above the configured effective budget (the user's ceiling,
    # including a per-interval cap)
    eff = acfg.max_steps
    if is_sde and acfg.max_steps_per_interval:
        eff = min(eff, acfg.max_steps_per_interval * max(seq_len - 1, 1))
    sized = min(sized, eff)
    new_acfg = dataclasses.replace(acfg, max_steps=sized,
                                   **({"max_steps_per_interval": 0}
                                      if is_sde else {}))
    sized_depth = None
    if is_sde:
        sized_depth = min(int(acfg.depth_cap),
                          int(depths.max()) + int(cfg.autosize_depth_margin))
        new_acfg = dataclasses.replace(new_acfg, depth_cap=sized_depth)
    if is_ode:
        new_de = dataclasses.replace(
            de, options=de.options.replace(adaptive_cfg=new_acfg))
    else:
        new_de = dataclasses.replace(de, adaptive_cfg=new_acfg)
    if verbose:
        depth_note = ("" if sized_depth is None else
                      f", depth_cap {int(acfg.depth_cap)} -> {sized_depth} "
                      f"(probe max depth {int(depths.max())})")
        print(f"autosized adaptive budget: max attempts "
              f"{int(attempts.max())} -> max_steps {sized} "
              f"(was {eff}){depth_note}", flush=True)
    return sized, new_de


class Trainer:
    """``optimizer``: a ``train.optim`` optimizer, bound to the model's
    parameters or unbound (then bound here); default Flux ADAMW(cfg.lr,
    (0.9, 0.999), cfg.decay)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 optimizer: Optional[optim.Optimizer] = None,
                 loss_fn: Callable = loss_batch, device=None):
        self.device = resolve_device(device)
        for name, p in model.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"trainer on {self.device}")
        self.model = model
        self.cfg = cfg
        if optimizer is None:
            optimizer = optim.adamw(None, cfg.lr, 0.9, 0.999, cfg.decay)
        if optimizer.params is None:
            optimizer.bind(model.parameters())
        self.opt = optimizer
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
        """One ELBO gradient step of the optimizer on the window ``x``
        (batch, seq_len, features). ``eps`` and ``key`` optionally fix the
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

    def autosize_adaptive_budget(self, train_set, *, seq_len=None,
                                 safety: Optional[float] = None,
                                 floor: int = 16,
                                 verbose: bool = False) -> Optional[int]:
        """Probe-size the adaptive step budget from the data (see
        ``_autosize_probe`` and TrainConfig.autosize_adaptive) and swap the
        model's dynamics for the sized ones. The parameters and the
        optimizer state stay as they are (the dynamics hold none). Returns
        the sized ``max_steps``, or None (fixed-grid or neural dynamics, or
        a probe row that failed)."""
        sized, new_de = _autosize_probe(self.model, self.cfg, train_set,
                                        seq_len, safety, floor, verbose)
        if sized is None:
            return None
        self.model.decoder.diffeq = new_de
        return sized

    def _snapshot(self, epoch: int):
        return {"model": copy.deepcopy(self.model.state_dict()),
                "epoch": epoch, "val": self.best_val_loss}

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

        if cfg.autosize_adaptive and self.epoch == 0:
            self.autosize_adaptive_budget(train_set, verbose=verbose)
        prog = _prog_seq_lengths(cfg)

        while self.epoch < epochs:
            ep = self.epoch
            beta = float(schedule[min(ep, len(schedule) - 1)])
            seq_len = _epoch_length(cfg, prog, ep)
            t0 = time.perf_counter()
            perm = torch.as_tensor(self.np_rng.permutation(n))
            ms, vm = [], None
            for s in range(steps):
                idx = perm[s * cfg.batch_size:(s + 1) * cfg.batch_size]
                x = sample_window(data[idx.to(self.device)], seq_len,
                                  self.window_gen)
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
                   "seq_len": seq_len, "epoch_s": wall,
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

    @property
    def best_model(self) -> torch.nn.Module:
        """The best-validation weights seen so far as a model (a copy with
        the snapshot's weights), or the live model before the first
        snapshot (trainer.py:882-888)."""
        if self.best is None:
            return self.model
        m = copy.deepcopy(self.model)
        m.load_state_dict(self.best["model"])
        return m

    def save(self, path: str):
        """Write the weights, the optimizer's state and the epoch, with the
        three random streams: ``np_rng``'s state in the meta under JAX's
        name, ``window_gen`` and ``noise_gen``'s states as arrays. A run
        restored from it goes on exactly as if it had not stopped."""
        save_checkpoint(
            path, self.model, self.opt,
            meta={"epoch": self.epoch, "best_val_loss": self.best_val_loss,
                  "np_rng": self.np_rng.bit_generator.state,
                  "noise_gen_device": self.noise_gen.device.type},
            arrays={"window_gen": self.window_gen.get_state().numpy(),
                    "noise_gen": self.noise_gen.get_state().numpy()})

    def restore(self, path: str):
        """Load a checkpoint of ``save`` (or the JAX Trainer's, or a bare
        model's). The random streams are restored when the file holds the
        port's three; otherwise (a JAX file, a checkpoint written before
        they were stored, a population replica) they stay as seeded from
        ``cfg.seed``. A noise stream saved on another device type cannot
        be set here: it is reseeded from ``cfg.seed``, with a warning."""
        extra = {}
        meta = load_checkpoint(path, self.model, self.opt, arrays=extra)
        self.epoch = int(meta.get("epoch", 0))
        self.best_val_loss = float(meta.get("best_val_loss", float("inf")))
        if "np_rng" in meta and {"window_gen", "noise_gen"} <= set(extra):
            self.np_rng.bit_generator.state = meta["np_rng"]
            self.window_gen.set_state(torch.from_numpy(
                np.array(extra["window_gen"])))
            saved_on = meta.get("noise_gen_device")
            if saved_on == self.noise_gen.device.type:
                self.noise_gen.set_state(torch.from_numpy(
                    np.array(extra["noise_gen"])))
            else:
                self.noise_gen.manual_seed(self.cfg.seed)
                warnings.warn(
                    f"{path}: its noise stream was saved on {saved_on}; "
                    f"this run's is on {self.noise_gen.device.type}, so it "
                    f"is reseeded from seed {self.cfg.seed} (the "
                    "permutation and window streams are restored)")
        return self
