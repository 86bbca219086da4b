"""Data utilities (counterpart of latentdiffeq/train/data.py): min-max
normalisation, the numpy window sampler, the 90/10 split, one shared random
time window per minibatch, and a shuffled drop-partial minibatcher. Layout
(samples, time, features)."""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

__all__ = ["normalize_to_unit_segment", "denormalize_unit_segment",
           "rand_time", "time_loader", "splitobs", "window_start",
           "sample_window", "gather_window", "DataLoader"]


def normalize_to_unit_segment(x):
    """Min-max normalise to [0, 1]; returns (x_norm, min, max) (a tensor or
    a numpy array alike)."""
    lo = x.min()
    hi = x.max()
    return (x - lo) / (hi - lo), lo, hi


def denormalize_unit_segment(x, lo, hi):
    """Inverse of normalize_to_unit_segment."""
    return x * (hi - lo) + lo


def rand_time(rng: np.random.Generator, full_seq_len: int,
              seq_len: int) -> int:
    """Random window start from a numpy generator (the JAX package's draw):
    uniform over [0, full_seq_len - seq_len - 1]; 0 when the window spans
    the full sequence."""
    if seq_len >= full_seq_len:
        return 0
    return int(rng.integers(0, full_seq_len - seq_len))


def time_loader(x, full_seq_len: int, seq_len: int,
                rng: np.random.Generator):
    """One random contiguous window shared by the whole batch; ``x``
    (batch, time, features)."""
    s = rand_time(rng, full_seq_len, seq_len)
    return x[:, s:s + seq_len, :]


def splitobs(x, at: float = 0.9):
    """Split along the sample axis, no shuffle (model_train.jl:115-117)."""
    k = int(x.shape[0] * at)
    return x[:k], x[k:]


def window_start(T: int, n: int,
                 generator: Optional[torch.Generator] = None) -> int:
    """A window's start, uniform over [0, T - n) (0 when n frames span the
    sequence), drawn from ``generator``."""
    return int(torch.randint(0, max(T - n, 1), (1,), generator=generator))


def sample_window(x, seq_len: int,
                  generator: Optional[torch.Generator] = None,
                  start: Optional[int] = None):
    """One random contiguous window of ``seq_len`` frames shared by the
    whole batch; the start is drawn by ``window_start`` unless given."""
    if start is None:
        start = window_start(x.shape[1], seq_len, generator)
    return x[:, start:start + seq_len]


def gather_window(data, rows, start, seq_len: int):
    """The window of ``sample_window`` read with device indices, as JAX's
    ``dynamic_slice_in_dim`` reads it (trainer.py:334-335): the rows
    ``rows`` (B,) of ``data`` (samples, time, features), frames ``start``
    (a one-element integer tensor) to ``start + seq_len``. Nothing is read
    back to the host, so a CUDA graph can replay it with new indices.
    Returns a contiguous (B, seq_len, features) copy. A population's:
    ``rows`` (S, B) and ``start`` (S,), replica s's rows in its own
    window, (S, B, seq_len, features)."""
    if rows.dim() == 1:
        frames = start + torch.arange(seq_len, device=start.device)
        return data.index_select(0, rows).index_select(1, frames)
    frames = start[:, None] + torch.arange(seq_len, device=start.device)
    return data[rows[:, :, None], frames[:, None, :]]


class DataLoader:
    """Shuffled, drop-partial minibatcher (Flux ``DataLoader(batchsize,
    shuffle=true, partial=false)``, model_train.jl:120)."""

    def __init__(self, data, batch_size: int, shuffle: bool = True,
                 drop_partial: bool = True,
                 generator: Optional[torch.Generator] = None):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_partial = drop_partial
        self.generator = generator

    def __len__(self) -> int:
        n = self.data.shape[0]
        return (n // self.batch_size if self.drop_partial
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator:
        n = self.data.shape[0]
        idx = (torch.randperm(n, generator=self.generator) if self.shuffle
               else torch.arange(n))
        stop = (n - n % self.batch_size) if self.drop_partial else n
        for i in range(0, stop, self.batch_size):
            yield self.data[idx[i:i + self.batch_size].to(self.data.device)]
