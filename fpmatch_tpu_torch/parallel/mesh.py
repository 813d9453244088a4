"""Data-parallel helpers of the rank grid: the counterpart of the JAX
package's `parallel/mesh.py`.

The JAX package shards each batch leaf over the "data" mesh axis and
replicates the parameters; XLA inserts the collectives. Here every rank is
a process: it keeps its own slice of each global batch (`shard_batch`; the
ranks of one edge group take the same slice) and a copy of the weights that
rank 0 broadcasts (`replicate_state`); the train step sums the gradients
over the data group (`train.step`). A data-only grid (the JAX package's
`make_mesh`) is `distributed.make_hybrid_mesh(D, 1)`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .distributed import RankGrid


def rank_rows_of(batch_size: int, grid: RankGrid) -> slice:
    """This rank's slice [d B / D, (d + 1) B / D) of a global batch."""
    if batch_size % grid.data:
        raise ValueError(f"batch size {batch_size} not divisible by data "
                         f"axis {grid.data}")
    per = batch_size // grid.data
    return slice(grid.d * per, (grid.d + 1) * per)


def shard_batch(batch, grid: RankGrid):
    """This rank's slice of a PairBatch (numpy arrays or tensors) along its
    batch axis; fields that are not arrays are kept."""
    sl = rank_rows_of(batch.batch_size, grid)

    def take(a):
        if isinstance(a, (np.ndarray, torch.Tensor)):
            return a[sl]
        return a

    return type(batch)(*(take(a) for a in batch))


@torch.no_grad()
def replicate_state(model: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank of the
    default process group (in place); returns the model."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)
    return model
