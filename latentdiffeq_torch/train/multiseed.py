"""Population training: S seeds of one architecture trained at once
(counterpart of latentdiffeq/train/multiseed.py:57-566).

Whether a GOKU run converges to the identifiable solution or collapses
depends on its random tape, so the quality records train several seeds and
keep the best (examples/pendulum/train_goku.py ``--seeds 8 --masked
--select-by pixel --warm-start``). A step at batch 64 is latency bound, so
the population runs as one program, as JAX's ``jax.vmap`` of its block
program does: the replicas' tensors are stacked on a leading axis
(``torch.func.stack_module_state``), the loss is ``torch.func.vmap`` of
``functional_call`` over them, and the gradient is autograd of the sum of
the replica losses. Flux ADAMW is elementwise, so one optimizer updates the
stacked tensors. Under the vmap each CUDA kernel of the step launches once
for all replicas (ops/recurrent_cuda.py and ops/ode_cuda.py carry the vmap
rules), except the neural-field solve's forward and sweep, which launch
once a replica (its weight gradients once for all; ops/node_cuda.py).

Randomness is drawn per replica, outside the vmap, from the streams a solo
``Trainer(model_init_fn(s), replace(cfg, seed=s))`` would use: a numpy
generator for the shuffles, a CPU generator for the window starts and a
generator on the device for the reparameterisation noise (and SDE keys).
Replica s therefore trains like that Trainer, equal up to float32 rounding
(batched products sum in another order; tests hold rtol 2e-4).

Each replica keeps its own NaN-safe best (weights, Adam moments, epoch):
a NaN validation loss never replaces a finite best, and a replica that
never recorded one loses every selection.

Block mode (``TrainConfig.jit_epoch``, ``epochs_per_dispatch``; JAX's
``fit`` is ``jax.jit(jax.vmap(make_block_fn))``, multiseed.py:186-266):
``fit`` runs blocks of epochs through the Trainer's ``make_block_fn`` with
the population's steps. A block draws every replica's permutations and
window starts on the host up front, in the per-step loop's order, moves
them to the device in one copy, gathers each step's windows there from the
tables (rows (S, B), starts (S,)), and keeps each replica's best on the
device (an (S,) mask over the stacked weights and Adam moments, the
validation losses in float64 and the epochs), read once at the block's
end. On the card every epoch after a block's first is a CUDA graph replay
with all S noise generators registered. History is written an epoch at a
time; the progress line, ``save_best``, ``save_population`` and the
callbacks run once a block, as in JAX. ``jit_epoch=False`` runs the
per-step loop; both give the same numbers bit for bit.

Population parallelism (``mesh``, JAX's ``mesh=``, multiseed.py:82-132):
the seed axis is sharded over the mesh's ranks. Rank r trains the r-th
block of S / ranks seeds with their own streams, and nothing is collective
while they train. ``seeds``, the indices of ``prune``, ``select``,
``seed_model`` and ``save_replica``, ``per_seed_best_vals`` and the
history stay those of the whole population: the selection gathers the
ranks' numbers (every rank then agrees on the winner), a replica's weights
come from the rank that trains it, and rank 0 writes the checkpoints.
``params``, ``stacked_models`` and ``warm_start`` are this rank's
replicas'.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call, stack_module_state, vmap

from .. import random as jr
from ..core import resolve_device
from ..models.dynamics import SDEDynamics
from ..models.template import _noise_dtype, _noise_widths
from ..parallel.mesh import mesh_rank, mesh_size
from . import optim
from .annealing import frange_cycle_linear
from .checkpoint import (_np, jax_param_paths, load_arrays, save_arrays,
                         trainer_arrays)
from .data import gather_window, window_start
from .losses import loss_batch
from .trainer import (TrainConfig, _autosize_probe, _epoch_length,
                      _prog_seq_lengths, block_end, length_runs,
                      make_block_fn)

__all__ = ["MultiSeedTrainer", "StackedModels"]


class _Replica:
    """Calls ``base`` with one replica's tensors: the model a loss function
    sees inside the vmap over replicas."""

    def __init__(self, base, params, buffers):
        self.base, self.tensors = base, (params, buffers)

    def __call__(self, *args, **kwargs):
        return functional_call(self.base, self.tensors, args, kwargs)

    def latent(self, x):
        """``(l_hat, mu, logvar)``: the deterministic encode -> latent_out
        path (the warm start's)."""
        return functional_call(_LatentPath(self.base), (
            {f"m.{k}": v for k, v in self.tensors[0].items()},
            {f"m.{k}": v for k, v in self.tensors[1].items()}), (x,))


class _LatentPath(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, x):
        mu, logvar = self.m.encoder(x)
        return (self.m.model_type.apply_latent_out(self.m.decoder, mu), mu,
                logvar)


@dataclasses.dataclass
class StackedModels:
    """S replicas of one architecture: ``base`` (the module whose structure
    and static configuration they share) and ``params`` / ``buffers``
    ({name: (S, ...)}). ``map(fn, *args)`` runs ``fn(replica, *args)`` for
    every replica in one ``torch.func.vmap``, ``replica`` a callable
    standing for the module (and ``replica.latent(x)`` its deterministic
    latent path); the args are shared unless ``in_dims`` says otherwise."""
    base: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]

    def __len__(self) -> int:
        return next(iter(self.params.values())).shape[0]

    def parameters(self):
        """The stacked parameter tensors (what a block steps and tracks)."""
        return iter(self.params.values())

    def map(self, fn: Callable, *args, in_dims=None):
        dims = (0, 0) + (tuple(in_dims) if in_dims is not None
                         else (None,) * len(args))
        return vmap(lambda p, b, *a: fn(_Replica(self.base, p, b), *a),
                    in_dims=dims)(self.params, self.buffers, *args)

    def replica(self, i: int) -> torch.nn.Module:
        """Replica ``i`` as a module of its own (a copy of ``base``)."""
        m = copy.deepcopy(self.base)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(self.params[k][i])
            for k, b in m.named_buffers():
                b.copy_(self.buffers[k][i])
        return m


class MultiSeedTrainer:
    """Train one architecture under ``seeds`` at once.

    ``model_init_fn(seed) -> module`` builds replica ``seed``'s model on
    the trainer's device (e.g. ``LatentDiffEqModel.build(GOKUBasic(...),
    *goku_default_layers(784, diffeq, generator=torch.Generator()
    .manual_seed(seed)))``). Seed s trains like ``Trainer(
    model_init_fn(s), replace(cfg, seed=s))``, curricula and autosize
    included. The replicas' tensors are ``self.params`` / ``self.buffers``
    ({name: (S, ...)}); ``self.base`` holds the shared structure. ``mesh``:
    shard the seeds over its ranks (module docstring); their number must
    divide over them."""

    def __init__(self, model_init_fn: Callable, cfg: TrainConfig,
                 seeds: Sequence[int], *, loss_fn: Callable = loss_batch,
                 device=None, mesh=None):
        if len(seeds) < 1:
            raise ValueError("need at least one seed")
        self.mesh = mesh
        self.rank, self.world = mesh_rank(mesh), mesh_size(mesh)
        if len(seeds) % self.world:
            raise ValueError(
                f"population parallelism shards the SEED axis: {len(seeds)}"
                f" seeds not divisible by mesh size {self.world}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seeds = [int(s) for s in seeds]
        models = [model_init_fn(s) for s in self.local_seeds]
        for name, p in models[0].named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"trainer on {self.device}")
        self.base = models[0]
        self.params, self.buffers = stack_module_state(models)
        self.paths = jax_param_paths(self.base)
        self.opt = optim.adamw(list(self.params.values()), cfg.lr, 0.9,
                               0.999, cfg.decay)
        self.loss_fn = loss_fn
        self.np_rngs = [np.random.default_rng(s) for s in self.local_seeds]
        self.window_gens = [torch.Generator().manual_seed(s)
                            for s in self.local_seeds]
        self.noise_gens = [torch.Generator(device=self.device).manual_seed(s)
                           for s in self.local_seeds]
        self._widths = _noise_widths(self.base)
        self._noise_dtype = _noise_dtype(self.base)
        self.epoch = 0
        self._best = None
        self.history = []
        # block mode: a BlockFn per (seq_len, steps, val_len) and the best
        # on the device (aliasing _best's tensors), both rebuilt when the
        # population's tensors change
        self._block_fns = {}
        self._best_dev = None
        # torch.cuda.set_sync_debug_mode for the blocks' replays (BlockFn)
        self.sync_debug = None

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    @property
    def local_seeds(self):
        """The seeds this rank trains (all of them without a mesh)."""
        k = len(self.seeds) // self.world
        return self.seeds[self.rank * k:(self.rank + 1) * k]

    # ------------------------------------------------------------------
    # the population over the mesh's ranks (no-ops without a mesh)
    # ------------------------------------------------------------------
    def _gather(self, *arrays):
        """Every rank's arrays of per-replica values, concatenated in rank
        order (the whole population's)."""
        if self.mesh is None:
            return arrays if len(arrays) > 1 else arrays[0]
        got = [None] * self.world
        torch.distributed.all_gather_object(got, arrays,
                                            group=self.mesh.get_group())
        out = tuple(np.concatenate([g[i] for g in got])
                    for i in range(len(arrays)))
        return out if len(out) > 1 else out[0]

    def _from_owner(self, i: int, make: Callable):
        """``make(j)`` evaluated on the rank that trains replica ``i`` (its
        ``j``-th), handed to every rank."""
        owner, j = divmod(i, len(self.local_seeds))
        if self.mesh is None:
            return make(j)
        box = [make(j) if self.rank == owner else None]
        group = self.mesh.get_group()
        torch.distributed.broadcast_object_list(
            box, src=torch.distributed.get_global_rank(group, owner),
            group=group)
        return box[0]

    @property
    def _sde(self) -> bool:
        return isinstance(self.base.decoder.diffeq, SDEDynamics)

    @property
    def stacked_models(self) -> StackedModels:
        """The live population."""
        return StackedModels(self.base, self.params, self.buffers)

    def _grid(self, n: int):
        return torch.arange(n, dtype=torch.float32,
                            device=self.device) * self.cfg.dt

    # ------------------------------------------------------------------
    # per-replica randomness, drawn outside the vmap in the solo Trainer's
    # order: the SDE key first, then the noise of each group
    # ------------------------------------------------------------------
    def _keys(self):
        if not self._sde:
            return None
        return torch.stack([torch.randint(0, 2 ** 32, (2,), generator=g,
                                          device=self.device,
                                          dtype=torch.int64)
                            for g in self.noise_gens])

    def _eps(self, batch: int):
        widths = (self._widths if isinstance(self._widths, tuple)
                  else (self._widths,))
        draws = [[torch.randn((batch, w), generator=g, device=self.device,
                              dtype=self._noise_dtype)
                  for w in widths] for g in self.noise_gens]
        eps = tuple(torch.stack([d[j] for d in draws])
                    for j in range(len(widths)))
        return eps if isinstance(self._widths, tuple) else eps[0]

    def _windows(self, data, idx, seq_len: int):
        """Each replica's minibatch (rows ``idx`` (S, B)) in its own window,
        the starts drawn from the replicas' window generators: (S, B,
        seq_len, features), one gather."""
        T = data.shape[1]
        starts = torch.tensor([window_start(T, seq_len, g)
                               for g in self.window_gens])
        return gather_window(data, idx, starts.to(self.device), seq_len)

    # ------------------------------------------------------------------
    def train_step(self, xs, beta: float, *, eps=None, keys=None):
        """One ELBO step of every replica: ``xs`` (S, B, seq_len, features),
        replica s on xs[s]. ``eps`` (the structure of the noise, each (S, B,
        width)) and ``keys`` (S, 2) fix the randomness; by default they are
        drawn from the replicas' generators. Returns metrics of shape (S,)
        (tensors, not synchronised)."""
        cfg = self.cfg
        if keys is None:
            keys = self._keys()
        if eps is None:
            eps = self._eps(xs.shape[1])
        t = self._grid(xs.shape[2])

        def one(m, x, e, k):
            return self.loss_fn(
                m, x, t, beta, variational=cfg.variational, eps=e,
                mask_failures=cfg.mask_failures, free_bits=cfg.free_bits,
                **({} if k is None else {"key": k}))

        self.opt.zero_grad()
        losses, metrics = self.stacked_models.map(
            one, xs, eps, keys, in_dims=(0, 0, None if keys is None else 0))
        losses.sum().backward()
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def val_step(self, val, beta: float, *, keys=None):
        """Every replica's loss on the full validation sequences at the
        posterior mean (SDE dynamics: each on its key, drawn when None).
        Returns metrics of shape (S,)."""
        cfg = self.cfg
        if keys is None:
            keys = self._keys()
        t = self._grid(val.shape[1])

        def one(m, k):
            return self.loss_fn(
                m, val, t, beta, variational=False,
                mask_failures=cfg.mask_failures, free_bits=cfg.free_bits,
                **({} if k is None else {"key": k}))[1]

        return self.stacked_models.map(
            one, keys, in_dims=(None if keys is None else 0,))

    # ------------------------------------------------------------------
    def _init_best(self):
        S = len(self.local_seeds)
        st = self.opt.state_dict()
        return {"params": {k: v.detach().clone()
                           for k, v in self.params.items()},
                "m": st["m"], "v": st["v"],
                "val": np.full(S, np.inf), "epoch": np.zeros(S, np.int64)}

    @torch.no_grad()
    def _track_best(self, val_loss: np.ndarray, epoch: int):
        """NaN-safe per-replica best: a NaN compares False and never
        replaces the last finite best."""
        improved = val_loss < self._best["val"]
        if not improved.any():
            return
        self._best_dev = None      # the best's tensors are replaced
        mask = torch.as_tensor(improved, device=self.device)

        def sel(new, old):
            return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new,
                               old)

        b = self._best
        b["params"] = {k: sel(self.params[k].detach(), v)
                       for k, v in b["params"].items()}
        b["m"] = [sel(a, o) for a, o in zip(self.opt.m, b["m"])]
        b["v"] = [sel(a, o) for a, o in zip(self.opt.v, b["v"])]
        b["val"] = np.where(improved, val_loss, b["val"])
        b["epoch"] = np.where(improved, epoch, b["epoch"])

    def _block_fn(self, seq_len: int, steps: int, val_len: int):
        key = (seq_len, steps, val_len)
        fn = self._block_fns.get(key)
        if fn is None:
            fn = self._block_fns[key] = make_block_fn(
                self.cfg, self.opt, self.loss_fn, seq_len, steps, val_len,
                noise_gen=self.noise_gens,
                train_step=lambda m, xs, beta, eps, keys: self.train_step(
                    xs, beta, eps=eps, keys=keys),
                val_step=lambda m, val, beta, keys: self.val_step(
                    val, beta, keys=keys))
        return fn

    def _device_best(self):
        """The block's best: ``_best``'s weights and moments (the block
        updates them in place), its validation losses (float64) and epochs
        on the device."""
        if self._best_dev is None:
            b = self._best
            self._best_dev = {
                "model": list(b["params"].values()),
                "opt_state": list(b["m"]) + list(b["v"]),
                "val": torch.as_tensor(np.asarray(b["val"], np.float64),
                                       device=self.device),
                "epoch": torch.as_tensor(np.asarray(b["epoch"], np.int64),
                                         device=self.device)}
        return self._best_dev

    def run_block(self, data, val, betas, seq_len=None, cur_lens=None):
        """Run len(betas) epochs of every replica from ``self.epoch`` as one
        block (``Trainer.run_block`` for the population): each replica's
        permutations and window starts drawn here, in the per-step loop's
        order, the epochs through ``make_block_fn``, the best on the
        device. Returns the summaries, each (E, S) on the device; reads
        nothing back."""
        cfg = self.cfg
        n, T = data.shape[0], data.shape[1]
        steps, bs = n // cfg.batch_size, cfg.batch_size
        E = len(betas)
        lens = (list(cur_lens) if cur_lens is not None
                else [seq_len or cfg.seq_len] * E)
        idx = np.stack([
            np.stack([r.permutation(n)[:steps * bs].reshape(steps, bs)
                      for r in self.np_rngs], axis=1) for _ in range(E)])
        starts = np.array([[[window_start(T, lens[i], g)
                             for g in self.window_gens]
                            for _ in range(steps)] for i in range(E)])
        best = self._device_best()
        ids = np.arange(self.epoch, self.epoch + E)
        out = []
        for i, j in length_runs(lens):
            fn = self._block_fn(lens[i], steps, val.shape[1])
            fn.sync_debug = self.sync_debug
            out.append(fn(self.stacked_models, best, data, val, idx[i:j],
                          starts[i:j], betas[i:j], ids[i:j]))
        return {k: torch.cat([o[k] for o in out]) for k in out[0]}

    def fit(self, train_set, val_set, *, epochs: Optional[int] = None,
            callbacks=(), verbose: bool = True):
        """Train every replica; returns the history of per-epoch summaries,
        ``train_loss``, ``val_loss`` and ``n_failed`` per replica (arrays
        of shape (S,)). Data handling, curricula, autosize and block mode
        as in ``Trainer.fit``."""
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
        if self._best is None:
            self._best = self._init_best()
        prog = _prog_seq_lengths(cfg)

        while cfg.jit_epoch and self.epoch < epochs:
            ep0 = self.epoch
            seq_len = _epoch_length(cfg, prog, ep0)
            e, cur_lens = block_end(cfg, prog, ep0, epochs)
            betas = [float(schedule[min(i, len(schedule) - 1)])
                     for i in range(ep0, e)]
            t0 = time.perf_counter()
            summ = self.run_block(data, val, betas, seq_len, cur_lens)
            summ = {k: v.cpu() for k, v in summ.items()}   # the block's read
            self._best["val"] = self._best_dev["val"].cpu().numpy()
            self._best["epoch"] = self._best_dev["epoch"].cpu().numpy()
            per_ep = (time.perf_counter() - t0) / len(betas)
            for i in range(len(betas)):
                train_loss, val_loss, n_failed = self._gather(
                    summ["train_loss"][i].double().numpy(),
                    summ["val_loss"][i].double().numpy(),
                    summ["n_failed"][i].numpy())
                self.history.append({
                    "epoch": ep0 + i, "train_loss": train_loss,
                    "val_loss": val_loss, "beta": betas[i],
                    "seq_len": seq_len if cur_lens is None else cur_lens[i],
                    "epoch_s": per_ep, "n_failed": n_failed})
            self.epoch = e
            self._after(f"epochs {ep0:4d}-{e - 1:4d}", per_ep,
                        "s/epoch", verbose, callbacks)
        if cfg.jit_epoch:
            return self.history

        bs = cfg.batch_size
        while self.epoch < epochs:
            ep = self.epoch
            beta = float(schedule[min(ep, len(schedule) - 1)])
            # the block's beta: a float32 scalar on the device
            beta_t = torch.full((), beta, dtype=torch.float32,
                                device=self.device)
            seq_len = _epoch_length(cfg, prog, ep)
            t0 = time.perf_counter()
            perms = np.stack([r.permutation(n) for r in self.np_rngs])
            ms, vm = [], None
            for s in range(steps):
                idx = torch.as_tensor(perms[:, s * bs:(s + 1) * bs]).to(
                    self.device)
                xs = self._windows(data, idx, seq_len)
                ms.append(self.train_step(xs, beta_t))
                if cfg.val_every_batch:
                    vm = self.val_step(val, beta_t)
            if vm is None:
                vm = self.val_step(val, beta_t)
            val_loss = vm["loss"].double().cpu().numpy()   # synchronises
            train_loss = torch.stack([m["loss"] for m in ms]).mean(
                dim=0).double().cpu().numpy()
            n_failed = torch.stack([m["n_failed"] for m in ms]).sum(
                dim=0).cpu().numpy()
            self._track_best(val_loss, ep)
            wall = time.perf_counter() - t0
            train_loss, val_loss, n_failed = self._gather(
                train_loss, val_loss, n_failed)
            rec = {"epoch": ep, "train_loss": train_loss,
                   "val_loss": val_loss, "beta": beta,
                   "seq_len": seq_len, "epoch_s": wall,
                   "n_failed": n_failed}
            self.history.append(rec)
            self.epoch += 1
            self._after(f"epoch {ep:4d}", wall, "s", verbose, callbacks)
        return self.history

    def _after(self, what: str, secs: float, unit: str, verbose: bool,
               callbacks):
        """After an epoch (the per-step loop) or a block: the progress
        line, the checkpoints and the callbacks, on the last record."""
        cfg = self.cfg
        if verbose:
            vals = self.per_seed_best_vals
            j = _argmin_finite(vals)
            if self.rank == 0:
                print(f"{what}  [{self.n_seeds} seeds]  best val "
                      f"{vals[j]:10.4f} (seed {self.seeds[j]})"
                      f"  {secs:7.3f}{unit}", flush=True)
        if cfg.save_best:
            self.save_best(os.path.join(cfg.checkpoint_dir,
                                        "best_model.npz"))
            self.save_population(os.path.join(cfg.checkpoint_dir,
                                              "population.npz"))
        for cb in callbacks:
            cb(self, self.history[-1])

    # ------------------------------------------------------------------
    def warm_start(self, warm_fn: Callable) -> "MultiSeedTrainer":
        """Apply ``warm_fn(stacked_models)`` before training starts: it
        updates the stacked parameters in place, e.g. ``lambda m:
        pixel_observable.warm_start_pendulum(m, x, dt)`` (one vmapped
        regression for every replica, each from its own init). The
        optimizer's moments stay zero. Returns self."""
        if self.epoch != 0 or self._best is not None:
            raise ValueError("warm_start must run before training starts "
                             "(epoch 0, no best carry)")
        warm_fn(self.stacked_models)
        return self

    def prune(self, keep) -> "MultiSeedTrainer":
        """Keep the replicas at indices ``keep`` (into the current
        population). Their tensors, moments, best carries and random
        streams go on untouched, so training them on equals never having
        trained the others. With a mesh the survivors must still divide
        over it (JAX's prune refuses the same, multiseed.py:308-311); they
        are dealt out to the ranks afresh. Returns self."""
        keep = sorted(int(i) for i in keep)
        if not keep:
            raise ValueError("must keep at least one replica")
        if any(i < 0 or i >= self.n_seeds for i in keep):
            raise ValueError(f"keep indices {keep} out of range for "
                             f"{self.n_seeds} seeds")
        if len(keep) % self.world:
            raise ValueError(f"{len(keep)} surviving seeds not divisible by "
                             f"mesh size {self.world}")
        arrays, meta = self._population_state()
        arrays = {k: a[keep] if _per_replica(k) else a
                  for k, a in arrays.items()}
        meta = dict(meta, seeds=[meta["seeds"][i] for i in keep],
                    np_rng_states=[meta["np_rng_states"][i] for i in keep])
        self._set_state(arrays, meta)
        return self

    def autosize_adaptive_budget(self, train_set, *, seq_len=None,
                                 safety=None, floor: int = 16,
                                 verbose: bool = False) -> Optional[int]:
        """``Trainer.autosize_adaptive_budget`` for the population: probe on
        replica 0's live weights and give every replica the sized dynamics
        (they share one static configuration)."""
        sized, new_de = _autosize_probe(self.seed_model(0), self.cfg,
                                        train_set, seq_len, safety, floor,
                                        verbose)
        if sized is None:
            return None
        self.base.decoder.diffeq = new_de
        self._block_fns = {}     # graphs captured with the old budget
        return sized

    # ------------------------------------------------------------------
    # selection
    # ------------------------------------------------------------------
    @property
    def best_seed_index(self) -> int:
        return _argmin_finite(self.per_seed_best_vals)

    @property
    def best_seed(self) -> int:
        return self.seeds[self.best_seed_index]

    @property
    def per_seed_best_vals(self):
        """Per-replica best validation losses (+inf for a replica that never
        recorded a finite one)."""
        best = self._best if self._best is not None else self._init_best()
        return [float(v) for v in self._gather(np.asarray(best["val"]))]

    @property
    def best_val_loss(self) -> float:
        return self.per_seed_best_vals[self.best_seed_index]

    @property
    def stacked_best_models(self) -> StackedModels:
        """Every replica's best-so-far weights, stacked (for scoring the
        whole population in one vmapped call)."""
        best = self._best if self._best is not None else self._init_best()
        return StackedModels(self.base, best["params"], self.buffers)

    def _replica(self, i: int, from_best: bool) -> torch.nn.Module:
        def weights(j):
            stacked = (self.stacked_best_models if from_best
                       else self.stacked_models)
            m = stacked.replica(j)
            return m if self.mesh is None else {
                k: v.cpu() for k, v in m.state_dict().items()}

        got = self._from_owner(i, weights)
        if self.mesh is None:
            return got
        m = copy.deepcopy(self.base)
        m.load_state_dict(got)
        return m

    def seed_model(self, i: int) -> torch.nn.Module:
        """Live weights of replica ``i`` as a module."""
        return self._replica(i, from_best=False)

    def best_seed_model(self, i: int) -> torch.nn.Module:
        """Best-so-far weights of replica ``i`` as a module."""
        return self._replica(i, from_best=True)

    @property
    def best_model(self) -> torch.nn.Module:
        """The argmin-validation replica's best weights."""
        return self.best_seed_model(self.best_seed_index)

    def _scores(self, score_fn, stacked):
        sc = np.asarray(score_fn(stacked), np.float64)
        if sc.shape != (len(stacked),):
            raise ValueError(f"score_fn returned shape {sc.shape}, "
                             f"expected ({len(stacked)},)")
        return np.where(np.isfinite(sc), sc, -np.inf)

    def select(self, score_fn: Callable, *, include_best: bool = True):
        """The population winner by ``score_fn(stacked) -> (S,)`` (higher is
        better; non-finite scores lose), over the live weights and (with
        ``include_best``) the best carries: one call each (with a mesh, on
        each rank's replicas). Returns ``(model, info)``: the argmax
        replica's weights as a module and ``index/seed/score/from_best``
        with both score vectors."""
        sl = self._gather(self._scores(score_fn, self.stacked_models))
        sb = None
        if include_best:
            sb = self._gather(self._scores(score_fn,
                                           self.stacked_best_models))
        overall = sl if sb is None else np.maximum(sl, sb)
        i = int(np.argmax(overall))
        from_best = bool(sb is not None and sb[i] >= sl[i])
        model = self._replica(i, from_best)
        info = {"index": i, "seed": self.seeds[i],
                "score": float(overall[i]), "from_best": from_best,
                "scores_live": sl.tolist(),
                "scores_best": None if sb is None else sb.tolist()}
        return model, info

    @torch.no_grad()
    def elbo_rank(self, val_set, t, *, beta: float = 1.0, eps=None,
                  key=None, loss_fn: Callable = loss_batch):
        """Each live replica's variational validation loss at ``beta``
        (default 1, the ELBO), all on the same noise: ``eps`` (default
        drawn from a generator seeded 0) and, for SDE dynamics, the
        decoder's Brownian ``key`` (default ``split(PRNGKey(0))[1]``, the
        key JAX's default PRNGKey(0) hands the decoder). Returns a list of
        floats aligned with ``seeds``."""
        xv = torch.as_tensor(val_set, dtype=torch.float32).to(self.device)
        t = torch.as_tensor(t, dtype=torch.float32).to(self.device)
        if eps is None:
            g = torch.Generator(device=self.device).manual_seed(0)
            w = self._widths
            kw = dict(generator=g, device=self.device,
                      dtype=self._noise_dtype)
            eps = (tuple(torch.randn((xv.shape[0], k), **kw) for k in w)
                   if isinstance(w, tuple) else
                   torch.randn((xv.shape[0], w), **kw))
        kw = {}
        if self._sde:
            kw["key"] = (jr.split(jr.PRNGKey(0, device=self.device))[1]
                         if key is None else key)

        def one(m):
            return loss_fn(m, xv, t, beta, variational=True, eps=eps,
                           **kw)[0]

        return [float(v) for v in self._gather(
            self.stacked_models.map(one).double().cpu().numpy())]

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _replica_arrays(self, i: int, from_best: bool):
        if from_best:
            b = self._best if self._best is not None else self._init_best()
            params, m, v = b["params"], b["m"], b["v"]
        else:
            params, m, v = self.params, self.opt.m, self.opt.v
        return trainer_arrays(self.paths, [params[k][i] for k in params],
                              [a[i] for a in m], [a[i] for a in v],
                              self.opt.t)

    def save_replica(self, path: str, i: int, *, from_best: bool = True):
        """Write replica ``i`` (its best carry, or its live weights) as a
        Trainer checkpoint: ``Trainer.restore`` continues that replica."""
        def payload(j):
            best = self._best if self._best is not None else self._init_best()
            epoch = int(best["epoch"][j]) + 1 if from_best else self.epoch
            return (self._replica_arrays(j, from_best),
                    {"epoch": epoch, "best_val_loss": float(best["val"][j]),
                     "seed": self.seeds[i], "from_best": from_best})

        self._write(path, *self._from_owner(i, payload))

    def save_best(self, path: str):
        """Write the argmin-validation replica's best (weights, moments) as
        a Trainer checkpoint."""
        self.save_replica(path, self.best_seed_index, from_best=True)

    def _population_state(self):
        """``(arrays, meta)`` of the whole population: every replica's live
        and best tensors and moments, the best losses and epochs, and each
        replica's random streams (gathered over the ranks)."""
        b = self._best if self._best is not None else self._init_best()
        st = self.opt.state_dict()
        arrays = {}
        for tag, params, m, v in (("live", self.params, st["m"], st["v"]),
                                  ("best", b["params"], b["m"], b["v"])):
            arrays.update({f"{tag}/{k}": a for k, a in trainer_arrays(
                self.paths, list(params.values()), m, v, st["t"]).items()})
        arrays.update({f"buffers/{k}": _np(v)
                       for k, v in self.buffers.items()})
        arrays["best_val"] = np.asarray(b["val"], np.float64)
        arrays["best_epoch"] = np.asarray(b["epoch"], np.int64)
        arrays["window_gens"] = np.stack([g.get_state().numpy()
                                          for g in self.window_gens])
        arrays["noise_gens"] = np.stack([g.get_state().numpy()
                                         for g in self.noise_gens])
        rngs = [r.bit_generator.state for r in self.np_rngs]
        if self.mesh is not None:
            got = [None] * self.world
            torch.distributed.all_gather_object(
                got, (arrays, rngs), group=self.mesh.get_group())
            arrays = {k: np.concatenate([g[0][k] for g in got])
                      if _per_replica(k) else a for k, a in arrays.items()}
            rngs = [r for g in got for r in g[1]]
        return arrays, {"epoch": self.epoch, "seeds": self.seeds,
                        "has_best": self._best is not None,
                        "np_rng_states": rngs,
                        "noise_gen_device": self.device.type}

    def save_population(self, path: str):
        """Write everything ``restore`` needs to continue the run as if it
        had not stopped (``_population_state``)."""
        self._write(path, *self._population_state())

    def _write(self, path: str, arrays, meta):
        """Rank 0 writes; with a mesh the others wait until it has."""
        if self.rank == 0:
            save_arrays(path, arrays, meta)
        if self.mesh is not None:
            torch.distributed.barrier(group=self.mesh.get_group())

    def _set_state(self, arrays, meta, path: str = "the population state"):
        """Take the population ``(arrays, meta)`` of ``_population_state``
        (this rank's block of its replicas): new tensors, moments, best
        carries and streams. Noise streams saved on another device type
        (or by a file that does not say) are reseeded from the seeds, with
        a warning."""
        self.seeds = [int(s) for s in meta["seeds"]]
        k = len(self.seeds) // self.world
        rows = slice(self.rank * k, (self.rank + 1) * k)

        def dev(name, like):
            a = arrays[name][rows] if _per_replica(name) else arrays[name]
            # bfloat16 tensors are stored as float32 (checkpoint._np)
            return torch.from_numpy(np.array(a)).to(self.device, like.dtype)

        def part(tag):
            ps = list(self.params.values())
            return ([dev(f"{tag}/model/{p}", q)
                     for p, q in zip(self.paths, ps)],
                    [dev(f"{tag}/opt_state/m/{p}", q)
                     for p, q in zip(self.paths, ps)],
                    [dev(f"{tag}/opt_state/v/{p}", q)
                     for p, q in zip(self.paths, ps)])

        live, best = part("live"), part("best")
        self.buffers = {n: dev(f"buffers/{n}", b)
                        for n, b in self.buffers.items()}
        self.params = {n: a.requires_grad_()
                       for n, a in zip(self.params, live[0])}
        self.opt = optim.adamw(list(self.params.values()), self.cfg.lr, 0.9,
                               0.999, self.cfg.decay)
        self.opt.load_state_dict({"m": live[1], "v": live[2],
                                  "t": int(arrays["live/opt_state/t"])})
        # new tensors, optimizer and streams: new block functions
        self._block_fns, self._best_dev = {}, None
        self._best = None
        if meta["has_best"]:
            self._best = {"params": dict(zip(self.params, best[0])),
                          "m": best[1], "v": best[2],
                          "val": np.asarray(arrays["best_val"][rows]),
                          "epoch": np.asarray(arrays["best_epoch"][rows])}
        seeds = self.local_seeds
        self.np_rngs = []
        for st in meta["np_rng_states"][rows]:
            r = np.random.default_rng()
            r.bit_generator.state = st
            self.np_rngs.append(r)
        self.window_gens = [torch.Generator().set_state(torch.from_numpy(
            np.array(st))) for st in arrays["window_gens"][rows]]
        self.noise_gens = [torch.Generator(device=self.device)
                           for _ in seeds]
        saved_on = meta.get("noise_gen_device")
        if saved_on == self.device.type:
            for g, st in zip(self.noise_gens, arrays["noise_gens"][rows]):
                g.set_state(torch.from_numpy(np.array(st)))
        else:
            for g, sd in zip(self.noise_gens, seeds):
                g.manual_seed(sd)
            warnings.warn(
                f"{path}: its noise streams were saved on {saved_on}; this "
                f"run's are on {self.device.type}, so they are reseeded "
                "from the seeds (the other streams are restored)")
        self.epoch = int(meta["epoch"])

    def restore(self, path: str) -> "MultiSeedTrainer":
        """Continue a run from ``save_population``; the trainer must have
        the same seeds and configuration (with a mesh, every rank reads the
        file and takes its replicas). Noise streams saved on another
        device type are reseeded from the seeds, with a warning, as
        ``Trainer.restore`` does. Returns self."""
        arrays, meta = load_arrays(path)
        if list(meta["seeds"]) != self.seeds:
            raise ValueError(f"population checkpoint was trained with seeds "
                             f"{meta['seeds']}, this trainer has "
                             f"{self.seeds}")
        self._set_state(arrays, meta, path)
        return self


def _per_replica(name: str) -> bool:
    """Whether a population array has the replica axis first: all but the
    optimizers' step counts."""
    return not name.endswith("opt_state/t")


def _argmin_finite(vals) -> int:
    vals = np.asarray(vals, np.float64)
    return int(np.argmin(np.where(np.isfinite(vals), vals, np.inf)))
