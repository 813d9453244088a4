"""Row-sharded association graphs: the multi-rank axis of the association
GNN, the counterpart of the JAX package's `parallel/edge_partition.py`.

The association node space (N1, N2) is sharded by graph-1 rows: rank q of
an edge group of p ranks owns rows [q R, (q + 1) R), R = N1 / p. Each
association edge (e1, e2) belongs to the rank that owns its OUTPUT row, so
every scatter is local; what an edge needs from another rank is its INPUT
row of X (the halo). The host-side planners (`plan_row_shards`,
`plan_batch_rows`, copied from the JAX package, numpy only) group each
rank's edges into local and halo ones and list the rows each rank sends
each peer. One layer then is:

  1. pack X[send_idx] * send_mask and post one all_to_all over the edge
     group (`distributed.halo_exchange`);
  2. contract the local edges, with `Kp * X`, while the exchange runs;
  3. wait, and contract the halo edges from the received buffer.

Both contractions are `ops.assoc.assoc_matvec_auto` on this rank's edge
lists: K2 / K3 forward and K6 plus the flipped K2 / K3 backward on a CUDA
tensor, the plain ops on a CPU one. The halo contraction reads the receive
buffer (p s_cap = N1 rows; a RowShardPlan's tighter p s_max rows are
padded with zero rows up to R) and writes local rows, which fit in its row
space; its Kp is zero and its first R rows are kept. Padded plan slots read
Ke row E1, an appended zero row, and are masked out of the kernels.

`rank_aggregate` is that work as a pure function of one rank's tensors; the
collective path (`row_sharded_aggregate`, what `NGMNet` runs under a rank
grid) and the one-process emulation (`emulated_row_sharded_aggregate`, the
exchange an index copy of the stacked packs) share every line of it.
The op-level forms of the JAX package (v1 `edge_sharded_matvec` with
`shard_pair_for_edges`, v2 `row_sharded_matvec` with `shard_rows`; an edge
mesh is `distributed.make_hybrid_mesh(1, p)`) and its host-loop
`edge_partition_reference` are here too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.assoc import assoc_matvec, assoc_matvec_auto
from . import distributed as pd


# --------------------------------------------------------------- planners
class RowShardPlan(NamedTuple):
    """Host-built metadata of one pair's row-sharded matvec (numpy, padded
    to uniform lengths per plan)."""
    n_shards: int
    rows_per: int          # owned N1 rows per rank (N1 padded to p·rows_per)
    s_max: int             # send slots per (rank, peer) pair
    transpose: bool        # planned for K^T x (graph-2 roles swap too)
    send_idx: np.ndarray   # (p, p, s_max) int32: LOCAL row q sends to peer r
    send_mask: np.ndarray  # (p, p, s_max) float32: 1.0 on real slots
    # per-rank edge groups; padded slots have ke_row == E1 (a zero row)
    loc_gather: np.ndarray   # (p, e_loc) int32: local row to gather from
    loc_scatter: np.ndarray  # (p, e_loc) int32: local output row
    loc_ke_row: np.ndarray   # (p, e_loc) int32: row of Ke for this edge
    halo_gather: np.ndarray  # (p, e_halo) int32: slot into the recv buffer
    halo_scatter: np.ndarray  # (p, e_halo) int32
    halo_ke_row: np.ndarray  # (p, e_halo) int32


def _pad2d(rows, width, fill):
    out = np.full((len(rows), width), fill, np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def plan_row_shards(n1: int, src1, dst1, n_shards: int,
                    transpose: bool = False) -> RowShardPlan:
    """Partition graph-1 rows into `n_shards` contiguous blocks and group
    edges by output-row owner, splitting each rank's edges into local and
    halo ones by where their input row lives. `transpose=True` plans for
    K^T x (the model's orientation): output rows are dst1, input rows src1.
    """
    src1 = np.asarray(src1, np.int32)
    dst1 = np.asarray(dst1, np.int32)
    # assoc_matvec: Y[src] += Ke X[dst]; transpose swaps the roles
    in_rows, out_rows = (src1, dst1) if transpose else (dst1, src1)

    p = n_shards
    rows_per = -(-n1 // p)

    def owner(r):
        return np.minimum(r // rows_per, p - 1)

    e_owner = owner(out_rows)
    in_owner = owner(in_rows)
    is_local = e_owner == in_owner

    # send lists: the rows rank q owns that rank r's halo edges read
    send = [[[] for _ in range(p)] for _ in range(p)]
    for q in range(p):
        for r in range(p):
            if q == r:
                continue
            need = np.unique(in_rows[(e_owner == r) & (in_owner == q)])
            send[q][r] = list(need)
    s_max = max(1, max(len(send[q][r]) for q in range(p) for r in range(p)))

    send_idx = np.zeros((p, p, s_max), np.int32)
    send_mask = np.zeros((p, p, s_max), np.float32)
    # on rank r, the row g sent by rank q lands at slot q*s_max + its
    # position in send[q][r]
    slot_of = [dict() for _ in range(p)]
    for q in range(p):
        for r in range(p):
            rows = send[q][r]
            send_idx[q, r, :len(rows)] = np.asarray(rows, np.int32) \
                - q * rows_per
            send_mask[q, r, :len(rows)] = 1.0
            for k, g in enumerate(rows):
                slot_of[r][g] = q * s_max + k

    loc_g, loc_s, loc_k = [], [], []
    hal_g, hal_s, hal_k = [], [], []
    for q in range(p):
        mine = np.nonzero(e_owner == q)[0]
        lm = mine[is_local[mine]]
        hm = mine[~is_local[mine]]
        loc_g.append(in_rows[lm] - q * rows_per)
        loc_s.append(out_rows[lm] - q * rows_per)
        loc_k.append(lm)
        hal_g.append(np.asarray([slot_of[q][g] for g in in_rows[hm]],
                                np.int32))
        hal_s.append(out_rows[hm] - q * rows_per)
        hal_k.append(hm)

    e1 = len(src1)
    e_loc = max(1, max(len(x) for x in loc_g))
    e_halo = max(1, max(len(x) for x in hal_g))
    return RowShardPlan(
        n_shards=p, rows_per=rows_per, s_max=s_max, transpose=transpose,
        send_idx=send_idx, send_mask=send_mask,
        loc_gather=_pad2d(loc_g, e_loc, 0),
        loc_scatter=_pad2d(loc_s, e_loc, 0),
        loc_ke_row=_pad2d(loc_k, e_loc, e1),
        halo_gather=_pad2d(hal_g, e_halo, 0),
        halo_scatter=_pad2d(hal_s, e_halo, 0),
        halo_ke_row=_pad2d(hal_k, e_halo, e1),
    )


def halo_fraction(plan) -> float:
    """Rows exchanged per layer relative to what full replication moves
    (p (p - 1) rows_per row transfers): < 1 means the halo exchange moves
    less than an all-gather of X would. Takes a RowShardPlan, or a
    BatchRowPlan (then averaged over its samples)."""
    mask = np.asarray(plan.send_mask.cpu() if torch.is_tensor(plan.send_mask)
                      else plan.send_mask)
    p = mask.shape[-2]
    rows_per = mask.shape[-1] if isinstance(plan, BatchRowPlan) \
        else plan.rows_per
    samples = mask.shape[0] if isinstance(plan, BatchRowPlan) else 1
    return float(mask.sum()) / (samples * p * (p - 1) * rows_per)


class BatchRowPlan(NamedTuple):
    """Per-sample row-shard plans stacked with uniform shapes (s_cap =
    rows_per, e_cap = E1: both are upper bounds), so the shapes depend only
    on (B, p, N1, E1). Numpy arrays on the host (`plan_batch_rows`),
    tensors after `.to(device)`."""
    send_idx: object      # (B, p, p, s_cap) int32
    send_mask: object     # (B, p, p, s_cap) float32
    loc_gather: object    # (B, p, e_cap) int32
    loc_scatter: object   # (B, p, e_cap) int32
    loc_ke_row: object    # (B, p, e_cap) int32 (E1: the appended zero row)
    halo_gather: object   # (B, p, e_cap) int32 (slot into the recv buffer)
    halo_scatter: object  # (B, p, e_cap) int32
    halo_ke_row: object   # (B, p, e_cap) int32
    # orientation guard, as the JAX package's: shape (1,) iff the plan was
    # built with transpose=True, else (0,); a plan of the other orientation
    # would route the wrong K, so the aggregate refuses it
    transpose_tag: object

    @property
    def n_shards(self) -> int:
        return self.send_idx.shape[1]

    @property
    def transpose(self) -> bool:
        return self.transpose_tag.shape[0] == 1

    def to(self, device) -> "BatchRowPlan":
        return BatchRowPlan(*(torch.as_tensor(a).to(device) for a in self))


def plan_batch_rows(n1: int, src1, dst1, n_shards: int,
                    transpose: bool = True) -> BatchRowPlan:
    """A BatchRowPlan for a padded batch.

    :param n1: padded node count (divisible by n_shards)
    :param src1, dst1: (B, E1) graph-1 edge endpoints (padded slots may
        alias node 0: they carry Ke == 0 in the model and take local-edge
        slots on rank 0)
    """
    src1 = np.asarray(src1)
    dst1 = np.asarray(dst1)
    B, E1 = src1.shape
    p = n_shards
    assert n1 % p == 0, f"n1={n1} must be divisible by n_shards={p}"
    rows_per = n1 // p
    s_cap, e_cap = rows_per, E1

    f = dict(send_idx=np.zeros((B, p, p, s_cap), np.int32),
             send_mask=np.zeros((B, p, p, s_cap), np.float32),
             loc_gather=np.zeros((B, p, e_cap), np.int32),
             loc_scatter=np.zeros((B, p, e_cap), np.int32),
             loc_ke_row=np.full((B, p, e_cap), E1, np.int32),
             halo_gather=np.zeros((B, p, e_cap), np.int32),
             halo_scatter=np.zeros((B, p, e_cap), np.int32),
             halo_ke_row=np.full((B, p, e_cap), E1, np.int32))
    for b in range(B):
        pl = plan_row_shards(n1, src1[b], dst1[b], p, transpose=transpose)
        s_b = pl.s_max
        f["send_idx"][b, :, :, :s_b] = pl.send_idx
        f["send_mask"][b, :, :, :s_b] = pl.send_mask
        eL = pl.loc_gather.shape[1]
        f["loc_gather"][b, :, :eL] = pl.loc_gather
        f["loc_scatter"][b, :, :eL] = pl.loc_scatter
        f["loc_ke_row"][b, :, :eL] = pl.loc_ke_row
        eH = pl.halo_gather.shape[1]
        # recv slots q*s_b + k -> q*s_cap + k of the uniform buffer
        hg = pl.halo_gather
        f["halo_gather"][b, :, :eH] = (hg // s_b) * s_cap + hg % s_b
        f["halo_scatter"][b, :, :eH] = pl.halo_scatter
        f["halo_ke_row"][b, :, :eH] = pl.halo_ke_row
    return BatchRowPlan(
        transpose_tag=np.zeros((1,) if transpose else (0,), np.int32), **f)


# ------------------------------------------------------ one rank's work
class RankRows(NamedTuple):
    """One rank's part of a BatchRowPlan (B leading), as tensors."""
    send_idx: torch.Tensor      # (B, p, s_cap)
    send_mask: torch.Tensor     # (B, p, s_cap)
    loc_gather: torch.Tensor    # (B, e_cap)
    loc_scatter: torch.Tensor
    loc_ke_row: torch.Tensor
    halo_gather: torch.Tensor
    halo_scatter: torch.Tensor
    halo_ke_row: torch.Tensor


def rank_rows(plan: BatchRowPlan, q: int) -> RankRows:
    return RankRows(*(a[:, q] for a in plan[:8]))


def _rows_of(Kz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kz[b, idx[b]]: (B, E + 1, ...) by (B, k) -> (B, k, ...)."""
    b = torch.arange(Kz.shape[0], device=Kz.device)[:, None]
    return Kz[b, idx.long()]


def rank_edges(Ke: torch.Tensor, rows: RankRows, e1_mask=None):
    """This rank's Ke rows and kernel masks: (KeL, KeH, mL, mH). Padded
    plan slots read Ke row E1, an appended zero row, and are masked out
    (as are the slots of padded graph-1 edges when `e1_mask` is given)."""
    B, E1, E2 = Ke.shape
    Kez = torch.cat([Ke, Ke.new_zeros((B, 1, E2))], dim=1)
    real = torch.ones((B, E1), dtype=torch.bool, device=Ke.device) \
        if e1_mask is None else e1_mask.bool()
    realz = torch.cat([real, real.new_zeros((B, 1))], dim=1)
    return (_rows_of(Kez, rows.loc_ke_row), _rows_of(Kez, rows.halo_ke_row),
            _rows_of(realz, rows.loc_ke_row),
            _rows_of(realz, rows.halo_ke_row))


def pack_halo(X_loc: torch.Tensor, rows: RankRows) -> torch.Tensor:
    """The rows this rank sends each peer, peer-major: (p, B, s_cap, N2,
    C), zero on unused slots."""
    pack = _rows_of(X_loc, rows.send_idx.flatten(1))
    B, p, s = rows.send_idx.shape
    pack = pack.reshape(B, p, s, *X_loc.shape[2:]) \
        * rows.send_mask[..., None, None].to(X_loc.dtype)
    return pack.transpose(0, 1)


def _contract(X, Kp, Ke, gather, scatter, src2, dst2, transpose, e1_mask,
              e2_mask):
    """Y[scatter] += Ke X[gather] in the orientation of the plan (graph 2
    as `ops.assoc` takes it), through `assoc_matvec_auto`."""
    s1, d1 = (gather, scatter) if transpose else (scatter, gather)
    return assoc_matvec_auto(X, Kp, Ke, s1, d1, src2, dst2,
                             transpose=transpose, e1_mask=e1_mask,
                             e2_mask=e2_mask)


def rank_aggregate(X_loc, Kp_loc, KeL, KeH, recv, rows: RankRows, src2,
                   dst2, mL=None, mH=None, e2_mask=None,
                   transpose: bool = True, wait=None) -> torch.Tensor:
    """One rank's rows of K(^T) vec X: the local edges with `Kp * X`, then
    (after `wait()`, when given: the exchange is still in flight until
    then) the halo edges from `recv`, the received packs (p, B, s_cap, N2,
    C). Returns (B, R, N2, C) float32."""
    y = _contract(X_loc, Kp_loc, KeL, rows.loc_gather, rows.loc_scatter,
                  src2, dst2, transpose, mL, e2_mask)
    if wait is not None:
        wait()
    p, B, s = recv.shape[:3]
    halo = recv.transpose(0, 1).reshape(B, p * s, *recv.shape[3:])
    R = X_loc.shape[1]
    if p * s < R:
        # a tight plan (RowShardPlan's s_max) receives fewer rows than the
        # rank owns: zero rows give the contraction its R output rows
        halo = torch.cat([halo, halo.new_zeros((B, R - p * s,
                                                *halo.shape[2:]))], dim=1)
    kp0 = torch.zeros(halo.shape[:3], dtype=torch.float32,
                      device=halo.device)
    yh = _contract(halo, kp0, KeH, rows.halo_gather, rows.halo_scatter, src2,
                   dst2, transpose, mH, e2_mask)
    return y + yh[:, :R]


def _check_plan(plan: BatchRowPlan, transpose: bool):
    if plan.transpose != transpose:
        raise ValueError(
            f"BatchRowPlan was built with transpose={plan.transpose} but "
            f"this aggregate computes transpose={transpose}: the plan "
            "would route the wrong K orientation")


def row_sharded_aggregate(X, Kp, Ke, plan: BatchRowPlan, src2, dst2,
                          grid: "pd.RankGrid", e1_mask=None, e2_mask=None,
                          transpose: bool = True) -> torch.Tensor:
    """K(^T) vec X over the rank grid's edge group: X (B, N1, N2, C), Kp
    (B, N1, N2), Ke (B, E1, E2) (zero on padded slots) are the same on
    every rank of the group, and so is the (B, N1, N2, C) float32 result.
    Each rank contracts its rows (one halo all_to_all), and the rows are
    all-gathered. Autograd: the row slices of X and Kp gather their
    gradients, Ke's is summed over the group, the exchange's is the reverse
    exchange. Mean normalization is the caller's."""
    _check_plan(plan, transpose)
    g, p, q = grid.edge_group, grid.edge, grid.e
    if plan.n_shards != p:
        raise ValueError(f"the plan has {plan.n_shards} shards, the edge "
                         f"group {p} ranks")
    rows = rank_rows(plan, q)
    X_loc = pd.row_slice(X, g, q, p)
    Kp_loc = pd.row_slice(Kp, g, q, p)
    KeL, KeH, mL, mH = rank_edges(pd.copy_to_group(Ke, g), rows, e1_mask)
    recv, pending = pd.halo_exchange(pack_halo(X_loc, rows), g)
    y = rank_aggregate(X_loc, Kp_loc, KeL, KeH, recv, rows, src2, dst2, mL,
                       mH, e2_mask, transpose, wait=pending.wait)
    return pd.gather_rows(y, g, q)


def emulated_row_sharded_aggregate(X, Kp, Ke, plan: BatchRowPlan, src2,
                                   dst2, e1_mask=None, e2_mask=None,
                                   transpose: bool = True,
                                   on_rank=None) -> torch.Tensor:
    """`row_sharded_aggregate` of all p ranks in one process: the exchange
    is an index copy of the stacked packs (rank r receives block r of every
    rank's pack). Differentiable like the collective path. `on_rank(q,
    fn)` (optional) runs rank q's `rank_aggregate` call `fn()` and returns
    its result, e.g. to time or count each rank."""
    _check_plan(plan, transpose)
    p = plan.n_shards
    R = X.shape[1] // p
    ranks = [rank_rows(plan, q) for q in range(p)]
    X_locs = [X[:, q * R:(q + 1) * R] for q in range(p)]
    packs = torch.stack([pack_halo(X_locs[q], ranks[q]) for q in range(p)])
    ys = []
    for r in range(p):
        KeL, KeH, mL, mH = rank_edges(Ke, ranks[r], e1_mask)
        recv = packs[:, r]                      # (p_q, B, s_cap, N2, C)

        def fn(r=r, KeL=KeL, KeH=KeH, mL=mL, mH=mH, recv=recv):
            return rank_aggregate(X_locs[r].contiguous(),
                                  Kp[:, r * R:(r + 1) * R].contiguous(),
                                  KeL, KeH, recv, ranks[r], src2, dst2, mL,
                                  mH, e2_mask, transpose)

        ys.append(fn() if on_rank is None else on_rank(r, fn))
    return torch.cat(ys, dim=1)


# ------------------------------------------------------- op-level forms
def edge_sharded_matvec(X, Kp, Ke, src1, dst1, src2, dst2, group,
                        transpose: bool = False) -> torch.Tensor:
    """v1: this rank's share of K(^T) vec X from a contiguous E1 slice of
    the edges (`shard_pair_for_edges`), Kp on the group's first rank only,
    summed over the group (X replicated, the result on every rank)."""
    import torch.distributed as dist

    q = dist.get_rank(group)
    kp = Kp if q == 0 else torch.zeros_like(Kp)
    y = assoc_matvec_auto(X, kp, Ke, src1, dst1, src2, dst2,
                          transpose=transpose)
    return pd.all_reduce_sum(y, group)


def shard_pair_for_edges(Ke, src1, dst1, n_shards: int, q: int):
    """Rank q's contiguous slice of the E1 axis (E1 divisible by
    n_shards): (Ke, src1, dst1), each with its batch axis."""
    per = Ke.shape[1] // n_shards
    sl = slice(q * per, (q + 1) * per)
    return Ke[:, sl], src1[:, sl], dst1[:, sl]


def shard_rows(plan: RowShardPlan, X, Kp, Ke, device=None):
    """Host-side preparation of v2's operands for every rank: X / Kp rows
    padded to p·rows_per and split (p, rows_per, ...), and each rank's Ke
    rows (p, e_loc, E2) / (p, e_halo, E2), padded slots on the appended
    zero row. Returns tensors (Xp, Kpp, KeL, KeH)."""
    p, rows_per = plan.n_shards, plan.rows_per
    X, Kp, Ke = (np.asarray(a, np.float32) for a in (X, Kp, Ke))
    pad = p * rows_per - X.shape[0]
    Xp = np.pad(X, ((0, pad), (0, 0), (0, 0))).reshape(p, rows_per,
                                                       *X.shape[1:])
    Kpp = np.pad(Kp, ((0, pad), (0, 0))).reshape(p, rows_per, -1)
    Kez = np.concatenate([Ke, np.zeros((1, Ke.shape[1]), Ke.dtype)], 0)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (Xp, Kpp, Kez[plan.loc_ke_row],
                           Kez[plan.halo_ke_row]))


def row_sharded_matvec(plan: RowShardPlan, X_loc, Kp_loc, KeL, KeH, src2,
                       dst2, group) -> torch.Tensor:
    """v2: one pair's K(^T) vec X (orientation from the plan) on this rank
    of `group`: X_loc (rows_per, N2, C) and Kp_loc are its rows, KeL / KeH
    its Ke rows (`shard_rows`); returns its (rows_per, N2, C) rows of the
    result, which stay sharded. The B = 1 case of `rank_aggregate`, one
    halo all_to_all."""
    import torch.distributed as dist

    q = dist.get_rank(group)
    dev = X_loc.device
    t = lambda a: torch.as_tensor(a[q], device=dev)[None]  # noqa: E731
    rows = RankRows(t(plan.send_idx), t(plan.send_mask), t(plan.loc_gather),
                    t(plan.loc_scatter), t(plan.loc_ke_row),
                    t(plan.halo_gather), t(plan.halo_scatter),
                    t(plan.halo_ke_row))
    X1 = X_loc[None]
    recv, pending = pd.halo_exchange(pack_halo(X1, rows), group)
    y = rank_aggregate(X1, Kp_loc[None], KeL[None], KeH[None], recv, rows,
                       src2[None], dst2[None], transpose=plan.transpose,
                       wait=pending.wait)
    return y[0]


def edge_partition_reference(X, Kp, Ke, src1, dst1, src2, dst2,
                             n_shards: int, transpose: bool = False
                             ) -> torch.Tensor:
    """Host-loop reference for tests: split E1 (axis 1) into shards and sum
    the partial products (plain ops), Kp in the first only."""
    e1 = Ke.shape[1]
    per = e1 // n_shards
    y = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    for s in range(n_shards):
        sl = slice(s * per, (s + 1) * per if s < n_shards - 1 else e1)
        kp = Kp if s == 0 else torch.zeros_like(Kp)
        y = y + assoc_matvec(X, kp, Ke[:, sl], src1[:, sl], dst1[:, sl],
                             src2, dst2, transpose=transpose)
    return y
