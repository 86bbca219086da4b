"""Data parallelism over ``torch.distributed`` ranks (counterpart of
latentdiffeq/parallel/). JAX's ``P`` and ``NamedSharding`` describe the
layout of one global array over a JAX mesh and have no port."""
from .mesh import make_mesh, replicate, shard_batch, initialize_distributed
from .data_parallel import (BatchShards, make_dp_train_step,
                            make_shardmap_train_step)

__all__ = ["make_mesh", "replicate", "shard_batch", "initialize_distributed",
           "make_dp_train_step", "make_shardmap_train_step", "BatchShards"]
