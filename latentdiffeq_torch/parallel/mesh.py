"""Process groups and the data mesh (counterpart of
latentdiffeq/parallel/mesh.py).

JAX spans its devices with one program and a ``jax.sharding.Mesh``; the
port runs one process a rank under ``torch.distributed`` (started by
``python -m torch.distributed.run``, one rank a card), and its mesh is a
1-D ``DeviceMesh`` over the ranks. Parameters are replicated by a broadcast
from rank 0 and a batch is sharded by giving each rank its rows of the
leading axis. JAX's ``P`` and ``NamedSharding`` name layouts of one global
array and have no counterpart here.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "replicate", "shard_batch",
           "initialize_distributed", "mesh_rank", "mesh_size"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device="cuda", **kwargs) -> int:
    """Join (or start) the process group and return the world size.

    Under ``torch.distributed.run`` call it with no address: the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is read.
    ``coordinator_address``: an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``), or ``host:port``, with ``num_processes`` and
    ``process_id``. Without a launcher and with at most one process, a
    one-rank group on an in-memory store is set up. ``backend``: default
    ``nccl`` for ``device`` on CUDA, and ``gloo`` on the CPU or when this
    host starts more ranks (``LOCAL_WORLD_SIZE``) than it has cards: ranks
    that share a card need gloo, which also reduces CUDA tensors, since
    NCCL refuses two ranks on one device. A second call does nothing, as
    JAX's does (mesh.py:20-41).

    An NCCL group needs no setting before it starts for a CUDA graph to
    capture its collectives (``Trainer(mesh=)``'s epochs): with the
    defaults of PyTorch 2.11 and NCCL 2.28, error handling and the
    watchdog on, a one-rank group's captured epochs replay as their
    per-step loop runs (``chip_smoke.py`` phase 4n on a mesh)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        backend = ("nccl" if torch.device(device).type == "cuda"
                   and local <= torch.cuda.device_count() else "gloo")
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id,
                                **kwargs)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kwargs)
    else:
        if num_processes not in (None, 1):
            raise ValueError(
                f"{num_processes} processes need a launcher "
                "(python -m torch.distributed.run) or a coordinator_address")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over ranks 0 .. ``n_devices`` - 1
    (every rank by default) of the initialised group; raises past the
    world size, as JAX's raises past ``jax.devices()``. Every rank calls
    it. Its device type is ``cuda`` when the group runs NCCL or this
    process has set a card, else ``cpu``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    on_card = dist.get_backend() == "nccl" or (
        torch.cuda.is_available() and torch.cuda.is_initialized())
    return DeviceMesh("cuda" if on_card else "cpu", list(range(n)),
                      mesh_dim_names=(axis_name,))


def mesh_size(mesh) -> int:
    """Ranks on the mesh (1 without one)."""
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    """This process's place on the mesh (0 without one)."""
    return 0 if mesh is None else mesh.get_local_rank()


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    return [t for v in obj for t in _tensors(v)]


@torch.no_grad()
def replicate(tree, mesh: DeviceMesh):
    """Give every rank rank 0's values of a module's parameters and buffers
    or of the tensors in a (nested) list, tuple or dict, in place. Returns
    ``tree``."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    for t in _tensors(tree):
        dist.broadcast(t.data, src=src, group=group)
    return tree


def shard_batch(x, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's rows of the leading (batch) axis: the rank's equal
    block, in rank order. The batch must divide the mesh."""
    n, r = mesh.size(), mesh.get_local_rank()
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not divide over "
                         f"{n} ranks on axis {axis_name!r}")
    b = x.shape[0] // n
    return x[r * b:(r + 1) * b]
