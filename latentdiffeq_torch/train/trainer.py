"""The training loop (counterpart of latentdiffeq/train/trainer.py:37-139,
294-421, 604-870).

Each minibatch takes one random window shared by the batch, a variational
ELBO step with Flux ADAMW, then (``val_every_batch``) the deterministic
validation loss on the full sequences of the whole validation set
(model_train.jl:204). The best validation loss is tracked NaN-safely (a NaN
never counts as an improvement) together with the weights and optimizer
state that produced it.

Block mode (``jit_epoch``, ``epochs_per_dispatch``; the default, as in
JAX): ``fit`` runs blocks of up to ``epochs_per_dispatch`` epochs through
``make_block_fn``, JAX's fused epoch block. A block draws its permutations
and window starts on the host up front, moves them to the device in one
copy, runs its epochs with the step counters, the tables' indices and the
best (weights, optimizer state, validation loss, epoch) on the device, and
reads its summaries once, at its end; callbacks fire once a block, on its
last record, and the best checkpoint is written after a block in which the
best improved (trainer.py:755-819). On the card each epoch is a CUDA graph,
captured once per ``(seq_len, steps, val_len)`` and replayed with no host
read inside the block; on the CPU the same code runs eagerly. A block of
one epoch (``epochs_per_dispatch=1``) is JAX's per-epoch program. SDE
dynamics (on the grid or adaptive) and adaptive solves train in blocks
too: their keys are drawn from the noise generator inside the epoch, and a
captured adaptive solve runs its whole step budget of masked steps
(``solve.adaptive.all_inactive``), as JAX's bounded scan does, with the
early-exiting loop's results. ``MultiSeedTrainer`` runs the same blocks
over its stacked replicas, and a ``mesh`` its rows of each minibatch.
``jit_epoch=False`` runs the per-step loop. The two draw the same numbers
in the same order from each random stream and compute the same
operations, so a fit equals itself bit for bit whatever its blocking.

Curricula (trainer.py:55-78, 163-173): ``progressive_training`` ramps the
window length over the first ``prog_training_duration`` epochs
(``_prog_seq_lengths``); each epoch trains on windows of its length.
``masked_curriculum`` keeps JAX's block cadence (a block does not break
where the length changes) and, as JAX's, needs block mode; its epochs train
the sliced windows. JAX's masked mode keeps a ``seq_len`` buffer with the
length carried as ``cur_len`` only so that its fused blocks compile once; it
draws the same starts and averages the loss over the same frames, so its
steps equal the sliced ones. Here each length has its graph, and the sliced
windows keep the encoder on its kernel and solve only the epoch's frames.
``loss_batch(cur_len=)`` still takes the masked form.

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
with a warning, and restores the other two. A captured epoch registers the
noise generator with its graph, so each replay advances it as the eager
draws do.

Data parallelism (``mesh``, a 1-D mesh of ``parallel.make_mesh``; JAX's
GSPMD ``Trainer(mesh=)``, trainer.py:425-486): every rank runs this
Trainer on the whole dataset with the same seed, so it draws the same
permutations, window starts and noise as the solo Trainer, and trains on
its rows of each minibatch. The model is replicated from rank 0 and
wrapped in ``DistributedDataParallel``, which averages the gradients over
the ranks; each rank cuts the global batch's noise (and SDE keys) to its
rows, and the loss's batch couplings are made global (``loss_batch(
shards=)``), so the run equals the solo Trainer's up to the order of the
reductions. An epoch's summaries are each rank's share, made global once
an epoch or a block (``reduce_metrics``: the counts summed, the means
averaged), so every rank records the same history. Validation stays whole
on every rank, so every rank keeps the same best; rank 0 alone prints and
writes checkpoints, and ``restore`` leaves every rank with the same state.
A mesh trains in blocks as a solo Trainer does: on the card its group
runs NCCL (one rank a card) and each epoch's graph captures DDP's
gradient all-reduces and the loss's sums, after the eager epochs that
DDP's warm-up needs (``DDP_WARMUP_STEPS``); on the CPU (gloo) the blocks
run eagerly. Only a gloo group over CUDA tensors (ranks that share a
card), whose collectives a CUDA graph cannot capture, runs the per-step
loop, and ``fit`` warns.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import math
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import random as jr
from ..core import resolve_device
from ..models.dynamics import ODEDynamics, SDEDynamics
from ..models.template import _noise_dtype, _noise_widths
from ..ops import launches
from ..parallel.data_parallel import BatchShards, reduce_metrics
from ..parallel.mesh import mesh_rank, mesh_size
from ..utils.profiling import graph_nodes
from . import optim
from .annealing import frange_cycle_linear
from .checkpoint import load_checkpoint, save_checkpoint
from .data import gather_window, sample_window, window_start
from .losses import loss_batch

__all__ = ["TrainConfig", "Trainer", "make_block_fn"]

# DistributedDataParallel's eager iterations before a CUDA graph may capture
# one (PyTorch's whole-network capture of DDP): it rebuilds its buckets
# after the first and samples runtime statistics, with host syncs, in the
# first ten
DDP_WARMUP_STEPS = 11


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
    # JAX's masked curriculum: its block cadence, the same sliced windows
    # (module docstring); needs block mode (jit_epoch, epochs_per_dispatch
    # > 1)
    masked_curriculum: bool = False

    # the reference computes the full val loss every minibatch
    val_every_batch: bool = True
    mask_failures: bool = False
    free_bits: float = 0.0

    # block mode (module docstring): run the epochs in blocks of
    # epochs_per_dispatch through make_block_fn, each epoch a CUDA graph on
    # the card, the best tracked on the device; 1: a block an epoch.
    # jit_epoch=False: the per-step loop. Same numbers either way.
    jit_epoch: bool = True
    epochs_per_dispatch: int = 25

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


def block_end(cfg: TrainConfig, prog, ep0: int, epochs: int):
    """``(e, cur_lens)``: the block that starts at epoch ``ep0`` runs
    epochs ``ep0`` to ``e - 1`` (JAX's cadence, trainer.py:759-781: at
    most ``epochs_per_dispatch``, up to ``epochs``, and in the sliced
    curriculum only while the window length stays; the masked curriculum
    does not break for it and gets each epoch's length, ``cur_lens``,
    else None)."""
    if cfg.masked_curriculum and cfg.progressive_training:
        e = min(epochs, ep0 + cfg.epochs_per_dispatch)
        return e, [_epoch_length(cfg, prog, i) for i in range(ep0, e)]
    seq_len, e = _epoch_length(cfg, prog, ep0), ep0
    while (e < epochs and e - ep0 < cfg.epochs_per_dispatch
           and _epoch_length(cfg, prog, e) == seq_len):
        e += 1
    return e, None


def length_runs(lens):
    """``(i, j)`` of each run ``lens[i:j]`` of one window length: a block's
    epochs that one ``BlockFn`` (one graph) runs."""
    i = 0
    while i < len(lens):
        j = i
        while j < len(lens) and lens[j] == lens[i]:
            j += 1
        yield i, j
        i = j


def _fed(key) -> dict:
    """``{"key": key}``, or nothing for None (a step that draws its own)."""
    return {} if key is None else {"key": key}


def _grid(n: int, dt: float, device):
    return torch.arange(n, dtype=torch.float32, device=device) * dt


def _elbo_step(net, opt, loss_fn, cfg: TrainConfig, x, t, beta, *,
               generator=None, eps=None, **kw):
    """One ELBO gradient step of ``opt`` on the window ``x``; returns the
    step's metrics (detached, not synchronised)."""
    opt.zero_grad()
    loss, metrics = loss_fn(
        net, x, t, beta, variational=cfg.variational, generator=generator,
        eps=eps, mask_failures=cfg.mask_failures, free_bits=cfg.free_bits,
        **kw)
    loss.backward()
    opt.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def _val_metrics(model, loss_fn, cfg: TrainConfig, val, t, beta, **kw):
    """The loss on the full validation sequences at the posterior mean."""
    _, metrics = loss_fn(model, val, t, beta, variational=False,
                         mask_failures=cfg.mask_failures,
                         free_bits=cfg.free_bits, **kw)
    return metrics


def block_best(model: torch.nn.Module, opt: optim.Optimizer,
               val: float = float("inf"), epoch: int = 0):
    """A block's best state on the model's device, as JAX's carry holds it
    (trainer.py:621-625): copies of the weights and of the optimizer's
    state tensors, the validation loss (float64, so that it compares as the
    host's float does) and the epoch."""
    dev = next(model.parameters()).device
    return {"model": [p.detach().clone() for p in model.parameters()],
            "opt_state": [t.detach().clone() for t in opt.state_tensors()],
            "val": torch.tensor(val, dtype=torch.float64, device=dev),
            "epoch": torch.tensor(epoch, dtype=torch.int64, device=dev)}


@contextlib.contextmanager
def _sync_debug(mode):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the region (None: as
    it is)."""
    if mode is None:
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def epoch_summaries(ms):
    """An epoch's train summaries from its steps' metrics, under JAX's
    names: the mean loss and KL, the RHS evaluations and failed rows
    summed (each (S,) for a population's (S,) metrics)."""
    st = {n: torch.stack([m[n] for m in ms])
          for n in ("loss", "kl", "n_rhs_evals", "n_failed")}
    return {"train_loss": st["loss"].mean(0), "kl": st["kl"].mean(0),
            "rhs_evals": st["n_rhs_evals"].sum(0),
            "n_failed": st["n_failed"].sum(0)}


def _steps_of(a):
    """``a`` (E, steps, ...) as (E * steps, ...)."""
    return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])


def _layout(arrays):
    """What a table's shape and dtype depend on: each array's entries past
    its (E, steps) axes (None: no table)."""
    return None if arrays is None else tuple(
        (tuple(a.shape[2:]), a.dtype) for a in arrays)


def _at(table, i):
    """Entry ``i`` (a one-element device index) of ``table``."""
    return table.index_select(0, i)[0]


class _Tables:
    """A block's inputs on the device, indexed by the device step counter
    ``k`` and epoch counter ``e``, and its summaries. A table holds a
    step's entry after its first axis: (B,) rows and a start for the
    Trainer, (S, B) rows and (S,) starts for a population. ``eps`` and
    ``keys`` (the train steps' keys, then the validation passes': one a
    step with ``val_every_batch``, else one an epoch) are optional."""

    def __init__(self, dev, capacity: int, steps: int, layout, scalars,
                 val_per_step: bool):
        n = capacity * steps
        row, start, eps, keys = layout
        self.capacity, self.layout = capacity, layout
        self.rows = torch.empty(n, *row, dtype=torch.int64, device=dev)
        self.starts = torch.empty(n, *start, dtype=torch.int64, device=dev)
        self.betas = torch.empty(capacity, dtype=torch.float32, device=dev)
        self.ids = torch.empty(capacity, dtype=torch.int64, device=dev)
        self.scalars = {k: torch.empty(n, dtype=torch.float32, device=dev)
                        for k in scalars}
        self.eps = (None if eps is None else
                    [torch.empty(n, *shape, dtype=dtype, device=dev)
                     for shape, dtype in eps])
        self.keys = self.val_keys = None
        if keys is not None:
            (train, _), (val, _) = keys
            self.keys = torch.empty(n, *train, dtype=torch.int64, device=dev)
            # (E, steps, ...) read a step; (E, ...) read an epoch (its
            # layout counts the first axis past E as a step's)
            self.val_keys = (
                torch.empty(n, *val, dtype=torch.int64, device=dev)
                if val_per_step else
                torch.empty(capacity, *train, dtype=torch.int64, device=dev))
        self.flat = torch.empty(
            n * (math.prod(row) + math.prod(start) + len(scalars))
            + 2 * capacity, dtype=torch.float64, device=dev)
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.e = torch.zeros(1, dtype=torch.int64, device=dev)
        self.summ = {}

    def fits(self, E: int, layout, scalars) -> bool:
        return (E <= self.capacity and layout == self.layout
                and set(scalars) == set(self.scalars))


class BlockFn:
    """JAX's fused multi-epoch program (``make_block_fn``,
    trainer.py:294-421) on PyTorch, for one ``(seq_len, steps, val_len)``.

    ``block_fn(model, best, data, val_data, idx_blocks, starts, betas,
    epoch_ids, eps=None, keys=None)`` runs E = len(betas) epochs. Epoch
    i's step s takes the rows ``idx_blocks[i, s]`` (B,) of ``data``
    (samples, time, features, on the model's device) and the window of
    ``seq_len`` frames from ``starts[i, s]`` (``gather_window``), one ELBO
    step of the optimizer at ``betas[i]`` (the noise drawn from
    ``noise_gen``, or ``eps[i, s]``: a tensor (E, steps, B, w) or a tuple
    of them in the structure of the posterior's mean), then with
    ``val_every_batch`` the validation loss on the whole ``val_data``.
    ``keys`` (SDE dynamics' Brownian keys, the decoder's): ``(train,
    val)``, the train steps' (E, steps, 2) and the validation passes' (E,
    steps, 2), or (E, 2) without ``val_every_batch``; without them the
    steps draw their own (the Trainer's from its noise generator). After
    each epoch the summaries (JAX's ``train_loss``, ``val_loss`` — the
    last step's validation —, ``rhs_evals``, ``n_failed``, ``beta``,
    ``kl``) and, where the validation loss fell below ``best["val"]`` (NaN
    never does), the whole ``best`` (``block_best``: weights, optimizer
    state, validation loss and ``epoch_ids[i]``), in place. Returns the
    summaries, each (E,) on the device. The weights and the optimizer's
    state change in place, as the per-step loop changes them; JAX's
    ``keys`` are the starts, the noise and the Brownian keys here, drawn
    by the caller.

    A population (``MultiSeedTrainer``) passes its stacked replicas as
    ``model`` (``StackedModels``, whose ``parameters()`` are the stacked
    tensors), rows (E, steps, S, B), starts (E, steps, S) and every fed
    table with its replica axis after the step's; its steps return metrics
    (S,), so the summaries are (E, S), and ``best`` holds (S,) validation
    losses and epochs: each replica's best changes where its own loss
    improved.

    The inputs move to the device in one copy. Everything an epoch reads
    (rows, starts, beta, the optimizer's step scalars, the epoch id, fed
    noise and keys) it reads from tables at device counters, so on a CUDA
    device the first epoch run runs eagerly on a side stream (building
    every kernel library and filling every cache a launch keeps), the next
    is captured as a CUDA graph with the noise generators (``noise_gen``:
    one, or a list) registered, and every later epoch replays it with no
    host read; the kernels' launch counters gain on each replay what they
    gained at the capture (``ops.launches``). ``can_capture()`` says
    whether the next epoch may be captured (a mesh's DDP wants its warm-up
    of eager steps first); until it does, the epochs run eagerly on the
    side stream: ``stream``, or one of its own. An adaptive solve in a
    captured epoch runs its whole step budget (``solve.adaptive``). New
    tensors in any of those roles (another ``data``, ``best`` or table
    size) start over with an eager epoch. ``sync_debug`` (None, "warn" or
    "error") runs the replays under ``torch.cuda.set_sync_debug_mode``. A
    capture or replay that fails raises. On the CPU every epoch runs
    eagerly."""

    def __init__(self, cfg: TrainConfig, opt: optim.Optimizer,
                 loss_fn: Callable, seq_len: int, steps: int, val_len: int,
                 *, noise_gen=None, train_step: Optional[Callable] = None,
                 val_step: Optional[Callable] = None,
                 can_capture: Optional[Callable[[], bool]] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.cfg, self.opt, self.loss_fn = cfg, opt, loss_fn
        self.seq_len, self.steps, self.val_len = seq_len, steps, val_len
        self.noise_gens = ([] if noise_gen is None else [noise_gen]
                           if isinstance(noise_gen, torch.Generator)
                           else list(noise_gen))
        self.train_step = train_step or self._train_step
        self.val_step = val_step or self._val_step
        self.can_capture = can_capture or (lambda: True)
        self.sync_debug = None
        self._tabs = None
        self._sig = None
        self._warm = False
        self._graph = None
        self._delta = None
        self._stream = stream
        # the last capture's seconds (instantiation included) and its
        # graph's node counts (utils.graph_nodes)
        self.capture_s = None
        self.graph_nodes = None

    def _train_step(self, model, x, beta, eps, key):
        return _elbo_step(model, self.opt, self.loss_fn, self.cfg, x,
                          _grid(x.shape[1], self.cfg.dt, x.device), beta,
                          generator=(self.noise_gens[0] if self.noise_gens
                                     else None), eps=eps,
                          **_fed(key))

    def _val_step(self, model, val, beta, key):
        return _val_metrics(model, self.loss_fn, self.cfg, val,
                            _grid(self.val_len, self.cfg.dt, val.device),
                            beta, **_fed(key))

    def _upload(self, dev, idx_blocks, starts, betas, epoch_ids, eps, keys):
        """The block's inputs into the tables (one host-to-device copy, of
        every number as float64, which holds each exactly; fed noise and
        keys one copy each), counters at 0."""
        E, n = len(betas), len(betas) * self.steps
        idx, starts = np.asarray(idx_blocks), np.asarray(starts)
        scalars = self.opt.step_scalars(n)
        if eps is not None:
            eps = eps if isinstance(eps, (tuple, list)) else (eps,)
            eps = [torch.as_tensor(a) for a in eps]
        if keys is not None:
            keys = [torch.as_tensor(np.asarray(a, np.int64)) for a in keys]
        layout = (idx.shape[2:], starts.shape[2:], _layout(eps),
                  _layout(keys))
        tabs = self._tabs
        if tabs is None or not tabs.fits(E, layout, scalars):
            tabs = self._tabs = _Tables(dev, E, self.steps, layout, scalars,
                                        self.cfg.val_every_batch)
        parts = [idx, starts, np.asarray(betas, np.float32),
                 np.asarray(epoch_ids)] + [scalars[k] for k in tabs.scalars]
        host = np.concatenate([np.asarray(a, np.float64).ravel()
                               for a in parts])
        flat = tabs.flat[:host.size]
        flat.copy_(torch.from_numpy(host))
        o = 0
        for dst, m in ((tabs.rows, idx.size), (tabs.starts, starts.size),
                       (tabs.betas, E), (tabs.ids, E),
                       *((tabs.scalars[k], n) for k in tabs.scalars)):
            dst.view(-1)[:m].copy_(flat[o:o + m])
            o += m
        if eps is not None:
            for dst, a in zip(tabs.eps, eps):
                dst[:n].copy_(_steps_of(a))
        if keys is not None:
            train, val = keys
            tabs.keys[:n].copy_(_steps_of(train))
            if self.cfg.val_every_batch:
                val = _steps_of(val)
            tabs.val_keys[:len(val)].copy_(val)
        tabs.k.zero_()
        tabs.e.zero_()
        return tabs

    def _epoch(self, model, best, data, val, tabs, live):
        """One epoch, reading every input at the device counters (the code
        a graph captures)."""
        cfg = self.cfg
        e = tabs.e
        beta = tabs.betas.index_select(0, e).view(())
        ms, vm = [], None
        for _ in range(self.steps):
            k = tabs.k
            start = tabs.starts.index_select(0, k)
            x = gather_window(data, _at(tabs.rows, k),
                              start[0] if start.dim() > 1 else start,
                              self.seq_len)
            self.opt.use_step_scalars({
                n: t.index_select(0, k).view(())
                for n, t in tabs.scalars.items()})
            eps = None
            if tabs.eps is not None:
                eps = [_at(t, k) for t in tabs.eps]
                eps = tuple(eps) if len(eps) > 1 else eps[0]
            key = None if tabs.keys is None else _at(tabs.keys, k)
            ms.append(self.train_step(model, x, beta, eps, key))
            if cfg.val_every_batch:
                vm = self.val_step(model, val, beta,
                                   None if tabs.keys is None
                                   else _at(tabs.val_keys, k))
            k.add_(1)
        if vm is None:
            vm = self.val_step(model, val, beta, None if tabs.keys is None
                               else _at(tabs.val_keys, e))
        summ = dict(epoch_summaries(ms), val_loss=vm["loss"], beta=beta)
        with torch.no_grad():
            for n, v in summ.items():
                if n not in tabs.summ:
                    tabs.summ[n] = torch.zeros(tabs.capacity, *v.shape,
                                               dtype=v.dtype, device=v.device)
                tabs.summ[n].index_copy_(0, e, v.unsqueeze(0))
            # JAX's carry (trainer.py:395-404): weights, optimizer state,
            # val and epoch together, NaN-safe (a NaN compares False); a
            # population's (S,) mask picks each replica's row of the
            # stacked tensors
            val_loss = vm["loss"].double()
            improved = val_loss < best["val"]
            for b, a in zip(best["model"] + best["opt_state"], live):
                mask = improved.view(improved.shape
                                     + (1,) * (a.dim() - improved.dim()))
                b.copy_(torch.where(mask, a, b))
            best["val"].copy_(torch.where(improved, val_loss, best["val"]))
            best["epoch"].copy_(torch.where(
                improved, tabs.ids.index_select(0, e).view(()),
                best["epoch"]))
            e.add_(1)

    def __call__(self, model, best, data, val_data, idx_blocks, starts,
                 betas, epoch_ids, eps=None, keys=None):
        E = len(betas)
        if val_data.shape[1] != self.val_len:
            raise ValueError(f"val_data has {val_data.shape[1]} frames, "
                             f"the block function {self.val_len}")
        tabs = self._upload(data.device, idx_blocks, starts, betas,
                            epoch_ids, eps, keys)
        live = list(model.parameters()) + self.opt.state_tensors()
        bests = best["model"] + best["opt_state"]
        if len(bests) != len(live):
            raise ValueError(f"best holds {len(bests)} tensors, the model "
                             f"and optimizer {len(live)}")
        try:
            if data.device.type != "cuda":
                for _ in range(E):
                    self._epoch(model, best, data, val_data, tabs, live)
            else:
                self._run_cuda(E, model, best, data, val_data, tabs, live)
        finally:
            self.opt.use_step_scalars(None)
        return {n: v[:E] for n, v in tabs.summ.items()}

    def _run_cuda(self, E, model, best, data, val, tabs, live):
        sig = (id(tabs), data.data_ptr(), val.data_ptr(),
               *(t.data_ptr() for t in live + best["model"]
                 + best["opt_state"]),
               best["val"].data_ptr(), best["epoch"].data_ptr())
        if sig != self._sig:
            self._sig, self._graph, self._warm = sig, None, False
        if self._stream is None:
            self._stream = torch.cuda.Stream(data.device)
        cur = torch.cuda.current_stream(data.device)
        i = 0
        while i < E and not (self._warm and self.can_capture()):
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                self._epoch(model, best, data, val, tabs, live)
            cur.wait_stream(self._stream)
            self._warm = True
            i += 1
        if i == E:
            return
        if self._graph is None:
            self._capture(model, best, data, val, tabs, live)
        with _sync_debug(self.sync_debug):
            for _ in range(E - i):
                self._graph.replay()
                launches.add(self._delta)
                self.opt.advance(self.steps)

    def _capture(self, model, best, data, val, tabs, live):
        """Capture one epoch as a CUDA graph (nothing runs: the counters,
        the optimizer's step count and the noise generators are where they
        were), its graph's nodes counted before it is instantiated."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.noise_gens:
            if g.device.type == "cuda":
                graph.register_generator_state(g)
        before = launches.snapshot()
        # no collection inside the capture: freeing a dead trainer's graph
        # there (cudaGraphExecDestroy) would end it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                self._epoch(model, best, data, val, tabs, live)
        except RuntimeError as err:
            raise RuntimeError(
                f"capturing the epoch as a CUDA graph failed ({err}). One "
                f"cause: an autograd graph through the weights still alive "
                f"from before the fit (a loss computed and kept, not "
                f"backpropagated) holds their gradient accumulators on the "
                f"stream it was built on, which a capture cannot wait on; "
                f"drop it, or fit with TrainConfig(jit_epoch=False)") from err
        finally:
            if collecting:
                gc.enable()
            self._delta = launches.gained(before, launches.snapshot())
            launches.restore(before)
            self.opt.advance(-self.steps)
        self.graph_nodes = graph_nodes(graph.raw_cuda_graph())
        graph.instantiate()
        self._graph = graph
        self.capture_s = time.perf_counter() - t0


def make_block_fn(cfg: TrainConfig, opt: optim.Optimizer, loss_fn: Callable,
                  seq_len: int, steps: int, val_len: int, *,
                  noise_gen=None, train_step: Optional[Callable] = None,
                  val_step: Optional[Callable] = None,
                  can_capture: Optional[Callable[[], bool]] = None,
                  stream: Optional[torch.cuda.Stream] = None) -> BlockFn:
    """The fused multi-epoch program (JAX's ``make_block_fn``,
    trainer.py:294-421): a ``BlockFn`` for windows of ``seq_len`` frames,
    ``steps`` minibatch steps an epoch and validation sequences of
    ``val_len`` frames, stepping ``opt`` (bound to the model's parameters)
    on ``loss_fn``. ``noise_gen``: the reparameterisation noise's
    generator (a population's: one a replica). ``train_step(model, x,
    beta, eps, key)`` and ``val_step(model, val, beta, key)`` replace the
    plain ELBO step and validation pass (the Trainer and MultiSeedTrainer
    pass their own); ``key`` is the block's fed key, or None.
    ``can_capture``, ``stream``: see ``BlockFn``."""
    return BlockFn(cfg, opt, loss_fn, seq_len, steps, val_len,
                   noise_gen=noise_gen, train_step=train_step,
                   val_step=val_step, can_capture=can_capture,
                   stream=stream)


class Trainer:
    """``optimizer``: a ``train.optim`` optimizer, bound to the model's
    parameters or unbound (then bound here); default Flux ADAMW(cfg.lr,
    (0.9, 0.999), cfg.decay). ``mesh``: train data-parallel over its ranks
    (module docstring); ``cfg.batch_size`` must divide over them, and a
    ``loss_fn`` must take ``shards=`` as ``loss_batch`` does."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 optimizer: Optional[optim.Optimizer] = None,
                 loss_fn: Callable = loss_batch, device=None, mesh=None):
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
        # block mode: a BlockFn per (seq_len, steps, val_len), and the best
        # on the device (block_best), kept across blocks
        self._block_fns = {}
        self._best_dev = None
        # torch.cuda.set_sync_debug_mode for the blocks' replays (BlockFn)
        self.sync_debug = None
        decoder = getattr(model, "decoder", None)
        self._sde = isinstance(getattr(decoder, "diffeq", None), SDEDynamics)
        self.mesh = mesh
        self.rank, self.world = mesh_rank(mesh), mesh_size(mesh)
        self._net, self._shards, self._stream = model, None, None
        self._ddp_steps = 0     # DDP's forwards run by the host
        if mesh is not None:
            if cfg.batch_size % self.world:
                raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                                 f"by mesh size {self.world}")
            group = mesh.get_group()
            self._shards = BatchShards(group, self.world)
            if self.device.type == "cuda":
                # the stream of every train step and every block's epochs:
                # DDP's gradient accumulators keep the stream they were
                # made on, and a capture cannot wait on another
                self._stream = torch.cuda.Stream(self.device)
            # replicates rank 0's parameters and buffers; the gradients are
            # averaged in its backward hooks
            with self._on_stream():
                self._net = DistributedDataParallel(
                    model, process_group=group,
                    device_ids=([self.device.index]
                                if self.device.type == "cuda" else None))
            # DDP samples its runtime statistics, syncing on CUDA events,
            # in the first ten forwards and then every 100th, which a
            # captured epoch may hold: only in the first ten
            self._net._set_ddp_runtime_logging_sample_rate(2 ** 31 - 1)

    def _grid(self, n: int):
        return _grid(n, self.cfg.dt, self.device)

    def _key_kw(self, key):
        """``{"key": key}`` for SDE dynamics (a key drawn from the noise
        generator when ``key`` is None), else no keyword: an ODE model's
        loss takes none."""
        if key is None and self._sde:
            key = torch.randint(0, 2 ** 32, (2,), generator=self.noise_gen,
                                device=self.device, dtype=torch.int64)
        return {} if key is None else {"key": key}

    def _shard_randomness(self, b: int, eps, kw):
        """A rank's noise and SDE keys: the global batch's, drawn from the
        noise generator as the solo Trainer draws them (the key first, then
        each group's noise), cut to this rank's ``b`` rows."""
        rows = slice(self.rank * b, (self.rank + 1) * b)
        n = b * self.world
        if "key" in kw:
            kw["key"] = jr.split(jr.as_key(kw["key"], self.device), n)[rows]
        if eps is None and self.cfg.variational:
            widths = _noise_widths(self.model)
            draw = dict(generator=self.noise_gen, device=self.device,
                        dtype=_noise_dtype(self.model))
            eps = (tuple(torch.randn((n, w), **draw)[rows] for w in widths)
                   if isinstance(widths, tuple)
                   else torch.randn((n, widths), **draw)[rows])
        return eps, dict(kw, shards=self._shards)

    def train_step(self, x, beta: float, *, eps=None, key=None):
        """One ELBO gradient step of the optimizer on the window ``x``
        (batch, seq_len, features). ``eps`` and ``key`` optionally fix the
        reparameterisation noise and the Brownian path. Returns the step's
        metrics (tensors, not synchronised). With a mesh, ``x`` (and a
        given ``eps``) are this rank's rows of the global minibatch and the
        metrics its share: their mean over the ranks (the sum for ``n_*``)
        is the global batch's."""
        with self._on_stream():
            kw = self._key_kw(key)
            if self.mesh is not None:
                eps, kw = self._shard_randomness(x.shape[0], eps, kw)
                self._ddp_steps += 1
            return _elbo_step(self._net, self.opt, self.loss_fn, self.cfg, x,
                              self._grid(x.shape[1]), beta,
                              generator=self.noise_gen, eps=eps, **kw)

    def val_step(self, val, beta: float, *, key=None):
        """Loss on the full validation sequences at the posterior mean
        (for SDE dynamics on one Brownian path, ``key`` or a drawn one)."""
        return _val_metrics(self.model, self.loss_fn, self.cfg, val,
                            self._grid(val.shape[1]), beta,
                            **self._key_kw(key))

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
        self._block_fns = {}     # graphs captured with the old budget
        return sized

    def _snapshot(self, epoch: int):
        return {"model": copy.deepcopy(self.model.state_dict()),
                "epoch": epoch, "val": self.best_val_loss}

    def _per_step_only(self) -> Optional[str]:
        """Why this Trainer runs the per-step loop whatever ``jit_epoch``
        says (None: block mode can run): a mesh whose group runs gloo over
        CUDA tensors (ranks that share a card), whose collectives a CUDA
        graph cannot capture. A mesh on NCCL captures them in each epoch's
        graph; a mesh on the CPU runs its blocks eagerly."""
        if (self.mesh is not None and self.device.type == "cuda"
                and dist.get_backend(self.mesh.get_group()) != "nccl"):
            return (f"a {dist.get_backend(self.mesh.get_group())} group "
                    f"over CUDA tensors (ranks sharing a card)")
        return None

    def _use_blocks(self) -> bool:
        """Whether ``fit`` runs blocks: ``jit_epoch``, unless
        ``_per_step_only`` names a reason, which it warns of."""
        why = self._per_step_only() if self.cfg.jit_epoch else None
        if why is not None:
            warnings.warn(f"Trainer.fit runs the per-step loop for {why}: a "
                          f"CUDA graph captures a mesh's collectives only on "
                          f"NCCL, one rank a card", stacklevel=3)
        return self.cfg.jit_epoch and why is None

    def _global(self, summ):
        """A mesh's epoch summaries (each rank's share) made global as
        ``reduce_metrics`` makes a step's metrics: the counts summed over
        the ranks, the means averaged. Without a mesh, ``summ``."""
        if self.mesh is None:
            return summ
        names = {"train_loss": "loss", "kl": "kl", "rhs_evals": "n_rhs_evals",
                 "n_failed": "n_failed"}
        red = reduce_metrics({m: summ[k] for k, m in names.items()},
                             self.mesh.get_group(), self.world)
        return dict(summ, **{k: red[m] for k, m in names.items()})

    def _block_fn(self, seq_len: int, steps: int, val_len: int) -> BlockFn:
        key = (seq_len, steps, val_len)
        fn = self._block_fns.get(key)
        if fn is None:
            fn = self._block_fns[key] = make_block_fn(
                self.cfg, self.opt, self.loss_fn, seq_len, steps, val_len,
                noise_gen=self.noise_gen,
                train_step=lambda m, x, beta, eps, key: self.train_step(
                    x, beta, eps=eps, **_fed(key)),
                val_step=lambda m, val, beta, key: self.val_step(
                    val, beta, **_fed(key)),
                can_capture=(None if self.mesh is None else
                             lambda: self._ddp_steps >= DDP_WARMUP_STEPS),
                stream=self._stream)
        return fn

    def run_block(self, data, val, betas, seq_len=None, cur_lens=None):
        """Run len(betas) epochs from ``self.epoch`` as one block
        (trainer.py:604-635): the permutations and window starts drawn here
        from the host streams, in the per-step loop's order, the epochs
        through ``make_block_fn``, the best on the device. With a mesh
        each step trains on this rank's rows of its minibatch.
        ``cur_lens`` (the masked curriculum): each epoch's window length,
        else ``seq_len`` for all. Returns the summaries, each (E,) on the
        device (a mesh's made global); reads nothing back."""
        cfg = self.cfg
        n, T = data.shape[0], data.shape[1]
        steps = n // cfg.batch_size
        E = len(betas)
        lens = (list(cur_lens) if cur_lens is not None
                else [seq_len or cfg.seq_len] * E)
        b = cfg.batch_size // self.world          # this rank's rows
        idx = np.stack([self.np_rng.permutation(n)[:steps * cfg.batch_size]
                        .reshape(steps, cfg.batch_size) for _ in range(E)]
                       )[..., self.rank * b:(self.rank + 1) * b]
        starts = np.array([[window_start(T, lens[i], self.window_gen)
                            for _ in range(steps)] for i in range(E)])
        if self._best_dev is None:
            self._best_dev = block_best(self.model, self.opt,
                                        self.best_val_loss, self.epoch)
        ids = np.arange(self.epoch, self.epoch + E)
        out = []
        for i, j in length_runs(lens):
            fn = self._block_fn(lens[i], steps, val.shape[1])
            fn.sync_debug = self.sync_debug
            out.append(fn(self.model, self._best_dev, data, val, idx[i:j],
                          starts[i:j], betas[i:j], ids[i:j]))
        return self._global({k: torch.cat([o[k] for o in out])
                             for k in out[0]})

    def fit(self, train_set, val_set, *, epochs: Optional[int] = None,
            callbacks=(), verbose: bool = True):
        """Train on (samples, time, features) sets; returns the history of
        per-epoch summaries. Block mode unless ``jit_epoch`` is off or the
        configuration runs per step (module docstring)."""
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
        if cfg.masked_curriculum and not (cfg.jit_epoch
                                          and cfg.epochs_per_dispatch > 1):
            raise ValueError(
                "masked_curriculum requires block mode (jit_epoch=True, "
                "epochs_per_dispatch > 1) — it is a property of the fused "
                "block program")
        use_blocks = self._use_blocks()

        if cfg.autosize_adaptive and self.epoch == 0:
            self.autosize_adaptive_budget(train_set, verbose=verbose)
        prog = _prog_seq_lengths(cfg)

        while use_blocks and self.epoch < epochs:
            ep0 = self.epoch
            seq_len = _epoch_length(cfg, prog, ep0)
            e, cur_lens = block_end(cfg, prog, ep0, epochs)
            betas = [float(schedule[min(i, len(schedule) - 1)])
                     for i in range(ep0, e)]
            t0 = time.perf_counter()
            summ = self.run_block(data, val, betas, seq_len, cur_lens)
            summ = {k: v.cpu() for k, v in summ.items()}   # the block's read
            wall = time.perf_counter() - t0
            per_ep = wall / len(betas)
            for i in range(len(betas)):
                self.history.append({
                    "epoch": ep0 + i,
                    "train_loss": float(summ["train_loss"][i]),
                    "val_loss": float(summ["val_loss"][i]),
                    "beta": betas[i],
                    "seq_len": seq_len if cur_lens is None else cur_lens[i],
                    "epoch_s": per_ep,
                    "rhs_evals_per_s": int(summ["rhs_evals"][i]) / per_ep,
                    "kl": float(summ["kl"][i]),
                    "n_failed": int(summ["n_failed"][i])})
            prev_best = self.best_val_loss
            self.best_val_loss = float(self._best_dev["val"])
            if verbose and self.rank == 0:
                r = self.history[-1]
                print(f"epochs {ep0:4d}-{e - 1:4d}  "
                      f"loss {r['train_loss']:10.4f}  "
                      f"val {r['val_loss']:10.4f}  best "
                      f"{self.best_val_loss:10.4f}  "
                      f"{per_ep:7.4f}s/epoch", flush=True)
            self.epoch = e
            if self.best_val_loss < prev_best:
                best_ep = int(self._best_dev["epoch"])
                self.best = self._best_snapshot(best_ep)
                # after every block, so that an interrupted run leaves its
                # best behind (trainer.py:811-815)
                if cfg.save_best:
                    self._save_best(f"{cfg.checkpoint_dir}/best_model.npz",
                                    best_ep, steps * (e - 1 - best_ep))
            for cb in callbacks:
                cb(self, self.history[-1])
        if use_blocks:
            return self.history

        b = cfg.batch_size // self.world          # this rank's rows
        while self.epoch < epochs:
            ep = self.epoch
            beta = float(schedule[min(ep, len(schedule) - 1)])
            # the block's beta: a float32 scalar on the device
            beta_t = torch.full((), beta, dtype=torch.float32,
                                device=self.device)
            seq_len = _epoch_length(cfg, prog, ep)
            t0 = time.perf_counter()
            perm = torch.as_tensor(self.np_rng.permutation(n))
            ms, vm = [], None
            for s in range(steps):
                idx = perm[s * cfg.batch_size:(s + 1) * cfg.batch_size]
                idx = idx[self.rank * b:(self.rank + 1) * b]
                # contiguous, as the block's gather_window is
                x = sample_window(data[idx.to(self.device)], seq_len,
                                  self.window_gen).contiguous()
                ms.append(self.train_step(x, beta_t))
                if cfg.val_every_batch:
                    vm = self.val_step(val, beta_t)
            if vm is None:
                vm = self.val_step(val, beta_t)
            summ = self._global(epoch_summaries(ms))
            val_loss = float(vm["loss"])          # synchronises
            train_loss = float(summ["train_loss"])
            wall = time.perf_counter() - t0
            rec = {"epoch": ep, "train_loss": train_loss,
                   "val_loss": val_loss, "beta": beta,
                   "seq_len": seq_len, "epoch_s": wall,
                   "rhs_evals_per_s": int(summ["rhs_evals"]) / wall,
                   "kl": float(summ["kl"]),
                   "n_failed": int(summ["n_failed"])}
            self.history.append(rec)
            if verbose and self.rank == 0:
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

    @contextlib.contextmanager
    def _on_stream(self):
        """The region on a CUDA mesh's stream, on which its DDP was built
        (autograd accumulates a parameter's gradient on the stream where
        DDP's hooks made its accumulator), joined with the caller's
        stream on both sides; without one, or on it already, where it
        is."""
        if (self._stream is None
                or torch.cuda.current_stream(self.device) == self._stream):
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def _best_snapshot(self, epoch: int):
        """``_snapshot`` of the device best: the state dict with the best
        weights."""
        sd = {k: v.detach().clone() for k, v in
              self.model.state_dict().items()}
        for (name, _), b in zip(self.model.named_parameters(),
                                self._best_dev["model"]):
            sd[name] = b.detach().clone()
        return {"model": sd, "epoch": epoch, "val": self.best_val_loss}

    def _save_best(self, path: str, epoch: int, lag: int):
        """Write the device best as JAX's ``_save_best`` does
        (trainer.py:890-901): its weights and optimizer state, ``epoch`` +
        1, its validation loss, and the current random streams (resuming
        from it replays from the best epoch with the moments that produced
        it). ``lag``: the optimizer steps taken since the best epoch's
        end. The best is swapped into the live tensors for the write and
        back after it. With a mesh every rank calls it, as ``save``."""
        if self.rank == 0:
            self._write_best(path, epoch, lag)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group())

    def _write_best(self, path: str, epoch: int, lag: int):
        live = list(self.model.parameters()) + self.opt.state_tensors()
        best = self._best_dev["model"] + self._best_dev["opt_state"]
        kept = [t.detach().clone() for t in live]
        with torch.no_grad():
            for t, b in zip(live, best):
                t.copy_(b)
        self.opt.advance(-lag)
        try:
            self._write(path, epoch + 1)
        finally:
            self.opt.advance(lag)
            with torch.no_grad():
                for t, k in zip(live, kept):
                    t.copy_(k)

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
        restored from it goes on exactly as if it had not stopped. With a
        mesh every rank calls it: rank 0 writes (every rank holds the same
        state) and the others wait until the file is there."""
        if self.rank == 0:
            self._write(path, self.epoch)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.get_group())

    def _write(self, path: str, epoch: int):
        save_checkpoint(
            path, self.model, self.opt,
            meta={"epoch": epoch, "best_val_loss": self.best_val_loss,
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
        self._best_dev = None    # the next block tracks from this state
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
