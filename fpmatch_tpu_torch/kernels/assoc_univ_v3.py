"""UNIV-scale association matvec for one pair: CUDA kernel.

Counterpart of the JAX package's `kernels/assoc_univ_v3.py` (the Pallas
`_kernel` reached through `assoc_matvec_univ_v3_raw`, with the spilled edges
that wrapper adds): the same function and contract, re-thought for a GPU.

    Y[i1,i2,c] = Kp[i1,i2] X[i1,i2,c]
               + sum_{e1: out1(e1)=i1} sum_{e2: out2(e2)=i2}
                     Ke[e1,e2] X[in1(e1), in2(e2), c]

The orientation (K or K^T) is fixed by the plan. Because the card has indexed
loads, every edge takes part in the kernel itself: no spill postlude, no
spatially sorted / transposed X layout, no materialised KeP.

Per pair (same arguments as the JAX plan):

    plan = plan_univ_v3(pts2, src1, dst1, src2, dst2, transpose=True,
                        n1=N).to(device)
    Y = assoc_matvec_univ_v3(X, Kp, Ke, plan)            # once per GNN layer

Rounding follows the JAX path. The JAX plan keeps an edge pair (e1, e2) in
its kernel iff neither edge spills (`keep1[e1] and keep2[e2]`: it spills
all of spill1 x E2 and keep1 x spill2 to f32 XLA terms), and with bf16 X
(`univ_bf16`, bf16 compute) the kept pairs read Ke rounded to bf16
(`build_kep(..., dtype=bfloat16)`). So with bf16 X a kept pair's term is
f32(bf16 x) f32(bf16 ke) and a spilled pair's f32(bf16 x) ke; sums and the
result are f32. `plan_univ_v3` repeats the JAX plan's decision (graph-2
x-sort, slot caps, same-window-first slot fill over 128-lane windows) only
to set `keep1` / `keep2`: here every edge has a slot whatever it decides.
With f32 X the flags change nothing.

`plan.to(device)` makes the tensors both versions read: the padded slot
tables of the plain version and the kernel's own tables (graph 1 as CSR
by output row, rows ordered by degree; graph 2 as per-warp slices of a
degree-sorted CSR, see `_sliced`). `assoc_matvec_univ_v3` launches the CUDA
kernel (csrc/assoc_univ_v3.cu) for CUDA tensors — or raises — and uses
`assoc_matvec_univ_v3_plain`, the plain PyTorch version of the same function
over the slot tables, only for tensors that lie on the CPU. The kernel is
memory-bound; see the note at the top of the source. Inference only: like
the TPU kernel it has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build

# the TPU kernel this one replaces (file:line of the Pallas kernel body)
REPLACES = "fpmatch_tpu/kernels/assoc_univ_v3.py:320"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_univ_v3.cu"

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES: Dict[str, int] = {"assoc_univ_v3": 0}

LANE = 128              # the JAX plan's lane window (decides keep2)
WARP = 32               # slice width of the kernel's graph-2 table
SPILL_BIT = np.int32(-2 ** 31)   # set on a table entry whose edge spills


class UnivPlanV3(NamedTuple):
    """Host-built tables (numpy) of one pair; `.to(device)` makes the tensors
    the kernel and the plain version read."""
    n1: int
    n2: int
    s1: int                # graph-1 slots per output row (max degree, >= 1)
    s2: int                # graph-2 slots per output column
    transpose: bool
    # the plain version's padded slot tables (every edge has a slot)
    in1_slot: np.ndarray   # (n1, s1) int32 gathered row per slot (pad: 0)
    e1_slot: np.ndarray    # (n1, s1) int32 graph-1 edge id (pad: -1)
    in2_slot: np.ndarray   # (n2, s2) int32 gathered column per slot (pad: 0)
    e2_slot: np.ndarray    # (n2, s2) int32 graph-2 edge id (pad: -1)
    # the JAX plan's decision: edges its kernel keeps (the rest it spills)
    keep1: np.ndarray      # (E1,) bool
    keep2: np.ndarray      # (E2,) bool
    # the CUDA kernel's tables; an entry is (in, e), e | SPILL_BIT if spilled
    rows1: np.ndarray      # (n1,) int32 output rows, largest degree first
    ptr1: np.ndarray       # (n1 + 1,) int32 CSR offsets by output row
    ent1: np.ndarray       # (E1, 2) int32 entries, edge-id order per row
    cols2: np.ndarray      # (n2,) int32 output column of thread position t
    cnt2: np.ndarray       # (n2,) int32 entries of position t
    sptr2: np.ndarray      # (ceil(n2 / 32),) int32 start of each warp slice
    ent2: np.ndarray       # (sum of slices, 2) int32 sliced entries

    def to(self, device) -> "UnivPlanDev":
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return UnivPlanDev(*self[:5], *(t(a) for a in self[5:]))


class UnivPlanDev(NamedTuple):
    """A plan whose tables are tensors on one device (int32; keep1 / keep2
    bool)."""
    n1: int
    n2: int
    s1: int
    s2: int
    transpose: bool
    in1_slot: torch.Tensor
    e1_slot: torch.Tensor
    in2_slot: torch.Tensor
    e2_slot: torch.Tensor
    keep1: torch.Tensor
    keep2: torch.Tensor
    rows1: torch.Tensor
    ptr1: torch.Tensor
    ent1: torch.Tensor
    cols2: torch.Tensor
    cnt2: torch.Tensor
    sptr2: torch.Tensor
    ent2: torch.Tensor

    def to(self, device) -> "UnivPlanDev":
        return UnivPlanDev(*self[:5], *(t.to(device) for t in self[5:]))

    def kernel_tables(self):
        """The tables in the order of the CUDA kernel's arguments."""
        return self[self._fields.index("rows1"):]


def _auto_cap(deg: np.ndarray, spill_frac: float = 0.005) -> int:
    """The JAX plan's automatic slot cap: the smallest slot count whose
    overflow is <= spill_frac of all edges (>= 1)."""
    total = max(int(deg.sum()), 1)
    for s in range(1, int(deg.max()) + 1):
        if np.maximum(deg - s, 0).sum() <= spill_frac * total:
            return s
    return max(1, int(deg.max()))


def _rank_in_run(key: np.ndarray, order: np.ndarray, n: int) -> np.ndarray:
    """Position of each edge within its `key` run when the edges are taken
    in `order` (which must group them by key)."""
    deg = np.bincount(key, minlength=n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    rank = np.empty(len(key), np.int64)
    rank[order] = np.arange(len(key)) - starts[key[order]]
    return rank


def _kept_edges(pts2, out1, out2, in2, n1: int, s1_cap=None, s2_cap=None):
    """The JAX plan's kept / spilled split (`fpmatch_tpu` plan_univ_v3): a
    graph-1 edge is kept iff it is among the first s1 edges (by id) of its
    output row; a graph-2 edge iff its gather column lies in the 128-lane
    window of its output column or a neighbouring one (columns x-sorted by
    `pts2`) and it is among the first s2 such edges of that column, in the
    order (window distance, id). Returns (keep1, keep2) as bool arrays."""
    deg1 = np.bincount(out1, minlength=n1)
    if s1_cap is not None:
        s1 = int(min(max(deg1.max(), 1), s1_cap))
    else:
        s1 = int(min(max(deg1.max(), 1), max(2 * _auto_cap(deg1), 12)))
    keep1 = _rank_in_run(out1, np.argsort(out1, kind="stable"), n1) < s1

    n2 = len(pts2)
    perm2 = np.argsort(np.asarray(pts2)[:, 0], kind="stable")
    inv2 = np.empty(n2, np.int64)
    inv2[perm2] = np.arange(n2)
    o2s, i2s = inv2[out2], inv2[in2]
    deg2 = np.bincount(o2s, minlength=n2)
    s2 = int(min(max(deg2.max(), 1), s2_cap or _auto_cap(deg2)))
    dist = np.abs(i2s // LANE - o2s // LANE)
    order2 = np.lexsort((np.arange(len(o2s)), dist, o2s))
    keep2 = (dist <= 1) & (_rank_in_run(o2s, order2, n2) < s2)
    return keep1, keep2


def _slots(out_nodes: np.ndarray, in_nodes: np.ndarray, n: int):
    """Pad each node's incident edges (those whose `out` endpoint it is) to
    max-degree slots, in edge-id order: (in_slot, e_slot), both (n, s)."""
    deg = np.bincount(out_nodes, minlength=n)
    s = max(int(deg.max()) if len(deg) else 0, 1)   # >= 1: zero-edge side
    in_slot = np.zeros((n, s), np.int32)
    e_slot = np.full((n, s), -1, np.int32)
    order = np.argsort(out_nodes, kind="stable")
    pos = _rank_in_run(out_nodes, order, n)
    in_slot[out_nodes, pos] = in_nodes
    e_slot[out_nodes, pos] = np.arange(len(out_nodes))
    return in_slot, e_slot


def _entries(in_nodes, keep, order):
    """(in, e | SPILL_BIT if spilled) of the edges in `order`, (k, 2)."""
    e = order.astype(np.int32)
    e[~keep[order]] |= SPILL_BIT
    return np.stack([in_nodes[order].astype(np.int32), e], axis=1)


def _sliced(out_nodes, in_nodes, keep, n: int):
    """Graph 2 as the kernel walks it: thread position t owns output column
    cols2[t], columns ordered by degree (largest first, stable), so the 32
    lanes of a warp run nearly the same count. Warp w's entries form one
    slice at sptr2[w], entry b of lane l at sptr2[w] + 32 b + l (a warp's
    load of step b is 32 consecutive entries); only a slice's own longest
    run is padded, and no lane reads past its own count."""
    deg = np.bincount(out_nodes, minlength=n)
    cols = np.argsort(-deg, kind="stable").astype(np.int32)
    cnt = deg[cols].astype(np.int32)
    width = cnt[::WARP].astype(np.int64)     # each warp's longest run: its
    sptr = np.zeros(len(width), np.int64)    # first lane's (sorted)
    np.cumsum(width[:-1] * WARP, out=sptr[1:])
    ent = np.zeros((int(width.sum()) * WARP, 2), np.int32)
    t_of = np.empty(n, np.int64)             # thread position of each node
    t_of[cols] = np.arange(n)
    t = t_of[out_nodes]                      # per edge, in edge-id order
    b = _rank_in_run(out_nodes, np.argsort(out_nodes, kind="stable"), n)
    ent[sptr[t // WARP] + WARP * b + t % WARP] = _entries(
        in_nodes, keep, np.arange(len(out_nodes)))
    return cols, cnt, sptr.astype(np.int32), ent


def pad_points(P: np.ndarray, n: int) -> np.ndarray:
    """Coordinates of a bucket of n nodes holding the points P, as the JAX
    CLI pads them for its plan: pad nodes at x = 1e9 + k (sorted last, in
    order)."""
    out = np.full((n, 2), 1e9, np.float32)
    out[:len(P)] = P
    out[len(P):, 0] += np.arange(n - len(P))
    return out


def plan_univ_v3(pts2, src1, dst1, src2, dst2, transpose: bool = True,
                 s1_cap: int = None, s2_cap: int = None,
                 n1: int = None) -> UnivPlanV3:
    """Build the plan of one pair (numpy, host), with the JAX plan's
    arguments.

    :param pts2: (n2, 2) graph-2 node coordinates; n2 = len(pts2). Only the
        kept / spilled split reads them (the JAX plan's x-sort); a padded
        bucket passes its pad nodes as the JAX CLI does (`pad_points`)
    :param src1, dst1, src2, dst2: the REAL edges only (no padded slots)
    :param transpose: plan K^T x (the model's orientation): output rows are
        dst and gathered rows src, per `ops.assoc.assoc_matvec`'s role swap
    :param s1_cap, s2_cap: the JAX plan's slot caps (None = its automatic
        caps); they decide which edges count as spilled, nothing else
    :param n1: graph-1 node count (None: from the edges, as in JAX)
    """
    src1 = np.asarray(src1, np.int64)
    dst1 = np.asarray(dst1, np.int64)
    src2 = np.asarray(src2, np.int64)
    dst2 = np.asarray(dst2, np.int64)
    if transpose:
        out1, in1, out2, in2 = dst1, src1, dst2, src2
    else:
        out1, in1, out2, in2 = src1, dst1, src2, dst2
    if n1 is None:
        n1 = int(max(out1.max(), in1.max())) + 1 if len(out1) else 1
    n2 = len(pts2)
    keep1, keep2 = _kept_edges(pts2, out1, out2, in2, n1, s1_cap, s2_cap)
    in1_slot, e1_slot = _slots(out1, in1, n1)
    in2_slot, e2_slot = _slots(out2, in2, n2)
    deg1 = np.bincount(out1, minlength=n1)
    ptr1 = np.zeros(n1 + 1, np.int32)
    np.cumsum(deg1, out=ptr1[1:])
    return UnivPlanV3(
        n1=n1, n2=n2, s1=in1_slot.shape[1], s2=in2_slot.shape[1],
        transpose=transpose, in1_slot=in1_slot, e1_slot=e1_slot,
        in2_slot=in2_slot, e2_slot=e2_slot, keep1=keep1, keep2=keep2,
        rows1=np.argsort(-deg1, kind="stable").astype(np.int32), ptr1=ptr1,
        ent1=_entries(in1, keep1, np.argsort(out1, kind="stable")),
        **dict(zip(("cols2", "cnt2", "sptr2", "ent2"),
                   _sliced(out2, in2, keep2, n2))))


def _check(X, Kp, Ke, plan):
    if not isinstance(plan, UnivPlanDev):
        raise TypeError("plan must be a UnivPlanDev (UnivPlanV3.to(device))")
    if X.dim() != 3 or tuple(X.shape[:2]) != (plan.n1, plan.n2):
        raise ValueError(f"X must be ({plan.n1}, {plan.n2}, C), got "
                         f"{tuple(X.shape)}")
    if tuple(Kp.shape) != (plan.n1, plan.n2) or Ke.dim() != 2:
        raise ValueError("Kp must be (n1, n2) and Ke (E1, E2)")
    if Ke.shape[0] < len(plan.keep1) or Ke.shape[1] < len(plan.keep2):
        raise ValueError(f"Ke {tuple(Ke.shape)} is smaller than the plan's "
                         f"({len(plan.keep1)}, {len(plan.keep2)}) edges")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if Kp.dtype != torch.float32 or Ke.dtype != torch.float32:
        raise TypeError("Kp and Ke must be float32")
    dev = X.get_device()          # an int: cheaper than comparing devices
    if any(t.get_device() != dev for t in (Kp, Ke, *plan[5:])):
        raise ValueError("X, Kp, Ke and the plan must lie on one device")


def assoc_matvec_univ_v3_plain(X: torch.Tensor, Kp: torch.Tensor,
                               Ke: torch.Tensor, plan: UnivPlanDev
                               ) -> torch.Tensor:
    """The plain PyTorch version: the padded slot tables, `index_select` +
    broadcast multiply + sums over the slot axes, f32 accumulation; with
    bf16 X, Ke rounded to bf16 on the kept pairs (`keep1 x keep2`). Used by
    the CPU tests and as the yardstick the kernel is held against."""
    _check(X, Kp, Ke, plan)
    n1, n2, C = X.shape
    E1, E2 = Ke.shape
    Kz = torch.nn.functional.pad(Ke, (0, 1, 0, 1))           # zero row/col
    e1 = torch.where(plan.e1_slot < 0, E1, plan.e1_slot).long()   # (n1, S1)
    e2 = torch.where(plan.e2_slot < 0, E2, plan.e2_slot).long()   # (n2, S2)
    rounded = X.dtype == torch.bfloat16
    if rounded:     # per-edge flags over Kz's ids (pads: not kept)
        k1 = torch.zeros(E1 + 1, dtype=torch.bool, device=X.device)
        k2 = torch.zeros(E2 + 1, dtype=torch.bool, device=X.device)
        k1[:len(plan.keep1)] = plan.keep1
        k2[:len(plan.keep2)] = plan.keep2
        kept2 = k2[e2.reshape(-1)]
    in2 = plan.in2_slot.long().reshape(-1)
    Xf = X.float()
    Y = Kp[..., None] * Xf
    for a in range(plan.s1):
        rows = Xf.index_select(0, plan.in1_slot[:, a].long())    # (n1, n2, C)
        g = rows.index_select(1, in2).reshape(n1, n2, plan.s2, C)
        ke = Kz.index_select(0, e1[:, a]).index_select(1, e2.reshape(-1))
        if rounded:
            ke = torch.where(k1[e1[:, a]][:, None] & kept2[None, :],
                             ke.bfloat16().float(), ke)
        Y = Y + (g * ke.reshape(n1, n2, plan.s2, 1)).sum(dim=2)
    return Y


_FNS: Dict[torch.dtype, tuple] = {}


def _kernel_fn(dtype):
    """(library, C entry point with its argument types) for X's dtype."""
    if dtype not in _FNS:
        lib = _build.load("assoc_univ_v3")
        fn = (lib.fpm_assoc_univ_v3_bf16 if dtype == torch.bfloat16
              else lib.fpm_assoc_univ_v3_f32)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + \
            [ctypes.c_longlong, ctypes.c_void_p]
        _FNS[dtype] = (lib, fn)
    return _FNS[dtype]


def _launch(X, Kp, Ke, plan) -> torch.Tensor:
    lib, fn = _kernel_fn(X.dtype)
    X, Kp = X.contiguous(), Kp.contiguous()
    if Ke.stride(1) != 1 and Ke.numel():
        Ke = Ke.contiguous()
    tabs = [t.contiguous() for t in plan.kernel_tables()]
    if any(t.dtype != torch.int32 for t in tabs):
        raise TypeError("the plan's kernel tables must be int32")
    n1, n2, C = X.shape
    Y = torch.empty((n1, n2, C), dtype=torch.float32, device=X.device)
    ke_stride = Ke.stride(0) if Ke.numel() else 0
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), Kp.data_ptr(), Ke.data_ptr(),
                  *(t.data_ptr() for t in tabs), Y.data_ptr(), n1, n2, C,
                  len(plan.keep1), len(plan.keep2), ke_stride, stream)
    _build.check(lib, code, "assoc_univ_v3 launch")
    LAUNCHES["assoc_univ_v3"] += 1
    return Y


def assoc_matvec_univ_v3(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                         plan: UnivPlanDev) -> torch.Tensor:
    """K vec(X) (orientation fixed by the plan) for one pair.

    :param X: (n1, n2, C) float32 or bfloat16 (bf16: gathered from the bf16
        values, Ke rounded to bf16 on the pairs the JAX plan keeps; products,
        sums and the result f32)
    :param Kp: (n1, n2) f32; Ke: (E1, E2) f32 — E1 / E2 may be padded wider
        than the plan's real edge lists; only the plan's rows / columns are
        read
    :return: (n1, n2, C) float32

    CUDA tensors go through the CUDA kernel (a failed build or launch
    raises); CPU tensors through the plain version.
    """
    _check(X, Kp, Ke, plan)
    if X.device.type == "cuda":
        return _launch(X, Kp, Ke, plan)
    if X.device.type == "cpu":
        return assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    raise RuntimeError(f"assoc_matvec_univ_v3: unsupported device {X.device}")
