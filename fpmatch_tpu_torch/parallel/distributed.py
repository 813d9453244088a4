"""Process groups and the collectives of the data x edge rank grid: the
counterpart of the JAX package's `parallel/distributed.py`.

Where the JAX package builds one GSPMD mesh and lets XLA insert the
collectives, the port runs one process per rank (`torch.distributed`) and
writes each collective itself:

  * `initialize` joins the process group (NCCL for a CUDA device, gloo for
    the CPU) from torchrun's variables or from explicit arguments; it is a
    no-op with one process and no arguments.
  * `make_hybrid_mesh(D, E)` lays D x E ranks out as rank = d E + e, so the
    ranks of one edge group are contiguous (the JAX package keeps the edge
    axis ICI-adjacent the same way) and returns this rank's `RankGrid`: its
    coordinates, its data group (the D ranks with its e) and its edge group
    (the E ranks with its d). Every rank creates every group, in one order.
  * The autograd-aware collectives of the row-sharded association graph
    (`parallel.edge_partition`) and of the global batch statistics
    (`all_reduce_sum`): each is a `torch.autograd.Function` whose backward
    is the conjugate collective.

A rank grid always goes through its collectives, also where a group holds
one rank (world size 1 on one card): nothing takes a shortcut past them.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

# a hung collective ends in an error after this long, not in a hang
DEFAULT_TIMEOUT_S = 300


def initialize(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the default process group. Without `init_method`, torchrun's
    variables say where (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK); with
    neither (one plain process) this is a no-op and returns False. Returns
    True when a group was joined (or was already there)."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1 \
                and "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK; the global
    rank when it is not set)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


@dataclass(frozen=True)
class RankGrid:
    """This rank's place in a data x edge grid of `data * edge` ranks
    (rank = d * edge + e) and its two process groups."""
    data: int                 # D: ranks along the batch axis
    edge: int                 # E: ranks along the association rows
    d: int                    # this rank's data index
    e: int                    # this rank's edge index
    data_group: object        # the D ranks with this rank's e
    edge_group: object        # the E ranks with this rank's d

    @property
    def rank(self) -> int:
        return self.d * self.edge + self.e

    @property
    def size(self) -> int:
        return self.data * self.edge


def make_hybrid_mesh(data: int, edge: int = 1) -> RankGrid:
    """The D x E grid over the ranks of the default process group, which
    must hold exactly `data * edge` ranks."""
    world = dist.get_world_size()
    if data * edge != world:
        raise ValueError(f"a {data}x{edge} grid needs {data * edge} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    d, e = divmod(rank, edge)
    data_groups = [dist.new_group([dd * edge + ee for dd in range(data)])
                   for ee in range(edge)]
    edge_groups = [dist.new_group([dd * edge + ee for ee in range(edge)])
                   for dd in range(data)]
    return RankGrid(data, edge, d, e, data_groups[e], edge_groups[d])


# ----------------------------------------------------------- collectives
def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of every rank's input is the sum of
    the ranks' output gradients (the loss is the ranks' losses summed)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward on a tensor every rank of the group holds alike;
    backward sums the ranks' gradients (each rank's covers its own share of
    the work, e.g. its own association edges)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


class _RowSlice(torch.autograd.Function):
    """This rank's block of rows (axis 1) of a tensor the group holds
    alike; backward all-gathers the blocks' gradients, so every rank gets
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, index: int, parts: int):
        ctx.group = group
        rows = x.shape[1] // parts
        return x[:, index * rows:(index + 1) * rows].contiguous()

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.group, 1), None, None, None


def row_slice(x: torch.Tensor, group, index: int, parts: int
              ) -> torch.Tensor:
    return _RowSlice.apply(x, group, index, parts)


class _GatherRows(torch.autograd.Function):
    """All-gather of the ranks' row blocks (axis 1) into the whole tensor;
    backward keeps this rank's block of the gradient (every rank's gradient
    of the whole is the same, so nothing is summed)."""

    @staticmethod
    def forward(ctx, y, group, index: int):
        ctx.rows, ctx.index = y.shape[1], index
        return _gather(y, group, 1)

    @staticmethod
    def backward(ctx, dy):
        r, i = ctx.rows, ctx.index
        return dy[:, i * r:(i + 1) * r], None, None


def gather_rows(y: torch.Tensor, group, index: int) -> torch.Tensor:
    return _GatherRows.apply(y, group, index)


class PendingExchange:
    """The handle of a posted halo exchange: `wait()` before reading the
    received buffer."""

    def __init__(self):
        self.work = None

    def wait(self):
        if self.work is not None:
            self.work.wait()
            self.work = None


class _HaloExchange(torch.autograd.Function):
    """all_to_all over the group along axis 0 (peer-major buffers: block r
    goes to rank r, block q of the result came from rank q). Forward posts
    the exchange and returns at once (`pending.wait()` before the result is
    read); backward is the reverse exchange of the gradient blocks, which
    is the same all_to_all."""

    @staticmethod
    def forward(ctx, pack, group, pending: PendingExchange):
        ctx.group = group
        pack = pack.contiguous()
        recv = torch.empty_like(pack)
        pending.work = dist.all_to_all_single(recv, pack, group=group,
                                              async_op=True)
        return recv

    @staticmethod
    def backward(ctx, drecv):
        drecv = drecv.contiguous()
        dpack = torch.empty_like(drecv)
        dist.all_to_all_single(dpack, drecv, group=ctx.group)
        return dpack, None, None


def halo_exchange(pack: torch.Tensor, group):
    """Post the exchange of `pack` (p, ...): returns (the receive buffer,
    its PendingExchange)."""
    pending = PendingExchange()
    return _HaloExchange.apply(pack, group, pending), pending

