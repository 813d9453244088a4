"""Blocked UNIV-scale association matvec over a 3 x 3 window of X blocks:
CUDA kernel.

Counterpart of the JAX package's `kernels/assoc_univ.py` (the Pallas
`_univ_kernel` reached through `_univ_pallas` from `assoc_matvec_univ`, and
the spill terms that wrapper adds): the same function, plan and public
signature. Delaunay edges are spatially local, so with nodes sorted along x
every edge's endpoints fall in a narrow band:

  * nodes of graph 1 form row blocks of r1, graph 2 column blocks of r2;
  * edges are grouped by their scatter endpoint's block (disjoint tiles);
  * each kept edge's gather endpoint lies in the 3-block window around its
    scatter block; the others are spilled: spilled graph-1 edges meet every
    graph-2 edge, kept graph-1 edges the spilled graph-2 edges, so the
    result is exact for any graph.

Per pair (Ke and the plan are reused across GNN layers; only X changes):

    plan = plan_univ(points1, points2, src1, dst1, src2, dst2,
                     transpose=True).to(device)
    KeR  = gather_ke_blocks(Ke, plan)                  # once per pair
    Y    = assoc_matvec_univ(X, Kp, Ke, plan, KeR)     # per layer

`plan_univ` is host numpy and equal, field for field, to the JAX package's;
`UnivPlan.to(device)` adds the tables the CUDA kernel reads: each block's
kept slots ordered by local scatter index with their original gather nodes,
and the spilled / kept edge lists of both graphs ordered by sorted scatter
node (the plain version reads the plan's own spill lists instead, so a fault
in those tables shows against it). `assoc_matvec_univ` launches the kernel (csrc/assoc_univ.cu: kept
terms, spill terms and Kp X in one launch) for CUDA tensors — or raises —
and uses `assoc_matvec_univ_plain`, the plain PyTorch version of the same
function, only for tensors that lie on the CPU. The JAX function's
`fused_ta` chooses a layout of the TPU's matrix unit and has no counterpart.

Rounding follows the JAX wrapper. Precision "default" rounds X and KeR to
bf16 for the kept-edge part (products and sums f32). With bf16 X the kept
part is rounded to bf16 (JAX scatters it into `zeros_like(X)`) and every
spilled product is bf16(X) bf16(Ke) rounded to bf16 (JAX's
`ops.assoc.assoc_matvec` multiplies in X's dtype); with f32 X the spilled
part is f32. Sums are f32 and the result is f32. The kernel is
memory-bound; see the note at the top of the source. Inference only: like
the TPU kernel it has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import _build
from ._cells import channel_tiling
from ..ops.assoc import assoc_matvec_chunked

# the TPU kernel this one replaces (file:line of the Pallas kernel body)
REPLACES = "fpmatch_tpu/kernels/assoc_univ.py:165"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_univ.cu"

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES: Dict[str, int] = {"assoc_univ": 0}

PRECISIONS = ("highest", "default")
_MAX_SMEM = 232448         # kMaxSmem of the CUDA source: one block's tables


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class UnivPlan(NamedTuple):
    """Host-built blocking metadata (numpy), the JAX package's `UnivPlan`
    field for field. Node indices are in SORTED order (spatial sort along x):
    `perm1` / `perm2` map sorted node -> original node."""
    r1: int
    r2: int
    b1: int                 # padded edges per row block
    b2: int                 # padded edges per column block
    n1p: int                # N1 padded to I * r1
    n2p: int
    transpose: bool
    perm1: np.ndarray       # (N1,)
    perm2: np.ndarray
    e1_idx: np.ndarray      # (I, B1) original edge id; pad = E1 (zero Ke row)
    d1_loc: np.ndarray      # (I, B1, 1) gather row local to the 3 r1 window
    s1_loc: np.ndarray      # (I, B1, 1) scatter row local to the r1 block
    e2_idx: np.ndarray      # (J, B2)
    d2_loc: np.ndarray      # (J, B2, 1)
    s2_loc: np.ndarray      # (J, B2, 1)
    spill1: np.ndarray      # (K1,) original e1 ids outside the window
    spill2: np.ndarray      # (K2,) original e2 ids
    src1: np.ndarray        # orientation-swapped endpoints, original ids
    dst1: np.ndarray
    src2: np.ndarray
    dst2: np.ndarray

    def to(self, device) -> "UnivPlanDev":
        """The tensors the kernel and the plain version read, on `device`."""
        t = lambda a, dt=torch.int64: torch.from_numpy(
            np.ascontiguousarray(a)).to(device=device, dtype=dt)
        i32 = lambda a: t(a, torch.int32)
        n1, n2 = len(self.perm1), len(self.perm2)
        e1n, e2n = len(self.src1), len(self.src2)
        blk1, offs1 = _block_csr(self.e1_idx, self.s1_loc, self.dst1, self.r1)
        blk2, offs2 = _block_csr(self.e2_idx, self.s2_loc, self.dst2, self.r2)
        row1 = _inverse(self.perm1)[self.src1]      # sorted scatter nodes
        col2 = _inverse(self.perm2)[self.src2]
        keep1 = np.setdiff1d(np.arange(e1n), self.spill1)
        # the plain version's spill terms, from the plan's own lists as the
        # JAX wrapper takes them: spilled e1 against all e2, then kept e1
        # against spilled e2 — (Ke rows, Ke columns or None for all, and the
        # (1, K) edge lists of each term)
        spills = []
        if len(self.spill1):
            sp = self.spill1
            spills.append((t(sp), None, t(self.src1[sp][None]),
                           t(self.dst1[sp][None]), t(self.src2[None]),
                           t(self.dst2[None])))
        if len(self.spill2):
            sp2 = self.spill2
            spills.append((t(keep1), t(sp2), t(self.src1[keep1][None]),
                           t(self.dst1[keep1][None]), t(self.src2[sp2][None]),
                           t(self.dst2[sp2][None])))
        runs = (_runs(self.spill1, row1, self.dst1, n1),
                _runs(keep1, row1, self.dst1, n1),
                _runs(np.arange(e2n), col2, self.dst2, n2),
                _runs(self.spill2, col2, self.dst2, n2))
        return UnivPlanDev(
            *self[:7], n1, n2, e1n, e2n, i32(self.perm1), i32(self.perm2),
            t(self.e1_idx), t(self.e2_idx),
            t(self.d1_loc[..., 0]), t(self.s1_loc[..., 0]),
            t(self.d2_loc[..., 0]), t(self.s2_loc[..., 0]), tuple(spills),
            i32(blk1), i32(offs1), i32(blk2), i32(offs2),
            *(i32(a) for run in runs for a in run))


class UnivPlanDev(NamedTuple):
    """A plan on one device: the JAX plan's scalars and tables (int64), the
    plain version's spill terms, and the kernel's tables (int32). `blk*`
    hold, per block, the kept slots ordered by local scatter index (stable;
    pads in no run) as (slot, original gather node); the four edge lists are
    CSRs over SORTED scatter nodes holding (original edge id, original
    gather node)."""
    r1: int
    r2: int
    b1: int
    b2: int
    n1p: int
    n2p: int
    transpose: bool
    n1: int
    n2: int
    e1: int                 # real edges of graph 1 (= the pad id)
    e2: int
    perm1: torch.Tensor     # (N1,) int32 sorted node -> original node
    perm2: torch.Tensor
    e1_idx: torch.Tensor    # (I, B1)
    e2_idx: torch.Tensor    # (J, B2)
    d1_loc: torch.Tensor    # (I, B1)
    s1_loc: torch.Tensor
    d2_loc: torch.Tensor    # (J, B2)
    s2_loc: torch.Tensor
    spills: tuple           # per spill term: (Ke rows, Ke columns or None,
    #                         src1, dst1, src2, dst2 as (1, K) edge lists)
    blk1: torch.Tensor      # (I, B1, 2)
    offs1: torch.Tensor     # (I, r1 + 1) run offsets per local row
    blk2: torch.Tensor      # (J, B2, 2)
    offs2: torch.Tensor     # (J, r2 + 1)
    spill1_offs: torch.Tensor   # (N1 + 1,) spilled graph-1 edges
    spill1: torch.Tensor        # (K1, 2)
    keep1_offs: torch.Tensor    # kept graph-1 edges
    keep1: torch.Tensor
    all2_offs: torch.Tensor     # every graph-2 edge
    all2: torch.Tensor
    spill2_offs: torch.Tensor   # spilled graph-2 edges
    spill2: torch.Tensor

    def kernel_tables(self):
        """The int32 tables in the order of the CUDA kernel's arguments."""
        return (self.perm1, self.perm2) + self[self._fields.index("blk1"):]


def _inverse(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def _block_csr(e_idx, s_loc, gath, r: int):
    """Each block's kept slots ordered by local scatter index (stable; pad
    slots last, in no run): ((nblk, B, 2) of (slot, original gather node),
    run offsets (nblk, r + 1)). Past a block's last run the entries are 0."""
    nblk = e_idx.shape[0]
    real = e_idx < len(gath)
    key = np.where(real, s_loc[..., 0], r)
    order = np.argsort(key, axis=1, kind="stable")
    gz = np.append(np.asarray(gath, np.int64), 0)         # pad id -> 0
    blk = np.stack([np.where(np.take_along_axis(real, order, axis=1),
                             order, 0),
                    np.take_along_axis(gz[e_idx], order, axis=1)], axis=-1)
    counts = np.zeros((nblk, r + 1), np.int64)
    np.add.at(counts, (np.arange(nblk)[:, None], key), 1)
    offs = np.zeros((nblk, r + 1), np.int64)
    np.cumsum(counts[:, :r], axis=1, out=offs[:, 1:])
    return blk, offs


def _runs(ids, node, gath, n: int):
    """The edges `ids` as a CSR over sorted scatter nodes (stable by edge
    id): (offsets (n + 1,), (K, 2) of (edge id, original gather node))."""
    ids = np.asarray(ids, np.int64)
    key = node[ids]
    order = np.argsort(key, kind="stable")
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=n), out=offs[1:])
    ids = ids[order]
    return offs, np.stack([ids, gath[ids]], axis=-1).reshape(-1, 2)


def _plan_axis(points, scat, gath, r):
    """Sort nodes along x, group edges by scatter-endpoint block, localize
    indices to the block / window.

    Returns (perm, n_pad, e_idx (I,B), d_loc, s_loc, spill_ids, bmax)."""
    n = len(points)
    perm = np.argsort(points[:, 0], kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n, dtype=np.int32)
    s = inv[scat]           # sorted coords
    d = inv[gath]
    n_pad = _round_up(max(n, r), r)
    nblk = n_pad // r
    blk = s // r
    # window test: gather endpoint within [ (b-1)·r, (b+2)·r )
    ok = (d >= (blk - 1) * r) & (d < (blk + 2) * r)
    spill = np.nonzero(~ok)[0].astype(np.int32)
    groups = [np.nonzero(ok & (blk == b))[0].astype(np.int32)
              for b in range(nblk)]
    bmax = max(1, max(len(g) for g in groups))
    ne = len(scat)
    e_idx = np.full((nblk, bmax), ne, np.int32)
    d_loc = np.zeros((nblk, bmax), np.int32)
    s_loc = np.zeros((nblk, bmax), np.int32)
    for b, g in enumerate(groups):
        e_idx[b, :len(g)] = g
        d_loc[b, :len(g)] = d[g] - (b - 1) * r   # local to the 3r window
        s_loc[b, :len(g)] = s[g] - b * r
    return (perm, n_pad, e_idx, d_loc[..., None], s_loc[..., None], spill,
            bmax)


def plan_univ(points1, points2, src1, dst1, src2, dst2, *,
              r1: int = 32, r2: int = 128, transpose: bool = False,
              b1: Optional[int] = None, b2: Optional[int] = None
              ) -> UnivPlan:
    """Build the blocking plan of one pair (host numpy).

    `transpose=True` plans K^T x (the model's orientation): scatter = dst,
    gather = src, as `ops.assoc.assoc_matvec`'s role swap. `b1` / `b2`
    default to the largest block's edge count rounded up to 8 / 128."""
    src1 = np.asarray(src1, np.int32)
    dst1 = np.asarray(dst1, np.int32)
    src2 = np.asarray(src2, np.int32)
    dst2 = np.asarray(dst2, np.int32)
    if transpose:
        src1, dst1 = dst1, src1
        src2, dst2 = dst2, src2
    # assoc_matvec semantics: scatter to src, gather from dst
    p1, n1p, e1i, d1l, s1l, sp1, bm1 = _plan_axis(
        np.asarray(points1), src1, dst1, r1)
    p2, n2p, e2i, d2l, s2l, sp2, bm2 = _plan_axis(
        np.asarray(points2), src2, dst2, r2)
    b1 = b1 or _round_up(bm1, 8)
    b2 = b2 or _round_up(bm2, 128)
    pad1 = b1 - e1i.shape[1]
    pad2 = b2 - e2i.shape[1]
    e1n = len(src1)
    e2n = len(src2)
    e1i = np.pad(e1i, ((0, 0), (0, pad1)), constant_values=e1n)
    d1l = np.pad(d1l, ((0, 0), (0, pad1), (0, 0)))
    s1l = np.pad(s1l, ((0, 0), (0, pad1), (0, 0)))
    e2i = np.pad(e2i, ((0, 0), (0, pad2)), constant_values=e2n)
    d2l = np.pad(d2l, ((0, 0), (0, pad2), (0, 0)))
    s2l = np.pad(s2l, ((0, 0), (0, pad2), (0, 0)))
    return UnivPlan(r1=r1, r2=r2, b1=b1, b2=b2, n1p=n1p, n2p=n2p,
                    transpose=transpose, perm1=p1, perm2=p2,
                    e1_idx=e1i, d1_loc=d1l, s1_loc=s1l,
                    e2_idx=e2i, d2_loc=d2l, s2_loc=s2l,
                    spill1=sp1, spill2=sp2,
                    src1=src1, dst1=dst1, src2=src2, dst2=dst2)


def gather_ke_blocks(Ke: torch.Tensor, plan, dtype=None) -> torch.Tensor:
    """(I·B1, J·B2) block-gathered Ke; padded slots read an appended zero
    row / column. One gather per pair, amortized over layers. `plan` is a
    host `UnivPlan` or a device plan; `dtype=torch.bfloat16` is what the
    precision "default" kernel reads."""
    Kz = torch.nn.functional.pad(Ke, (0, 1, 0, 1))
    rows = torch.as_tensor(plan.e1_idx, device=Ke.device).reshape(-1).long()
    cols = torch.as_tensor(plan.e2_idx, device=Ke.device).reshape(-1).long()
    out = Kz.index_select(0, rows).index_select(1, cols)
    return out.to(dtype) if dtype is not None else out


# -------------------------------------------------------------- the pieces
def _check(X, Kp, Ke, plan, precision, KeR):
    if not isinstance(plan, UnivPlanDev):
        raise TypeError("plan must be a UnivPlanDev (UnivPlan.to(device))")
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if X.dim() != 3 or tuple(X.shape[:2]) != (plan.n1, plan.n2):
        raise ValueError(f"X must be ({plan.n1}, {plan.n2}, C), got "
                         f"{tuple(X.shape)}")
    if tuple(Kp.shape) != (plan.n1, plan.n2):
        raise ValueError(f"Kp must be ({plan.n1}, {plan.n2}), got "
                         f"{tuple(Kp.shape)}")
    if tuple(Ke.shape) != (plan.e1, plan.e2):
        raise ValueError(f"Ke must be ({plan.e1}, {plan.e2}), got "
                         f"{tuple(Ke.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if Kp.dtype != torch.float32 or Ke.dtype != torch.float32:
        raise TypeError("Kp and Ke must be float32")
    for t in (Kp, Ke, plan.perm1) + (() if KeR is None else (KeR,)):
        if t.device != X.device:
            raise ValueError("X, Kp, Ke, KeR and the plan must lie on one "
                             "device")


def compute_dtype(X: torch.Tensor, precision: str) -> torch.dtype:
    """The dtype of X and KeR in the kept-edge part."""
    return torch.bfloat16 if precision == "default" else X.dtype


def halo(X: torch.Tensor, plan: UnivPlanDev, dtype) -> torch.Tensor:
    """(C, n1p + 2 r1, n2p + 2 r2): X in sorted order, channel-major, with a
    zero halo of one block on each side (the plain version's layout; the
    kernel reads X as it is)."""
    n1, n2, _ = X.shape
    Xs = X.index_select(0, plan.perm1).index_select(1, plan.perm2)
    Xs = Xs.to(dtype).permute(2, 0, 1)
    return torch.nn.functional.pad(
        Xs, (plan.r2, plan.n2p - n2 + plan.r2,
             plan.r1, plan.n1p - n1 + plan.r1)).contiguous()


def _unsort(Ys: torch.Tensor, plan: UnivPlanDev) -> torch.Tensor:
    """(C, n1p, n2p) sorted tiles -> (N1, N2, C) in original node order."""
    Ys = Ys[:, :plan.n1, :plan.n2].permute(1, 2, 0)
    Y = torch.empty_like(Ys)
    Y[plan.perm1[:, None], plan.perm2[None, :]] = Ys
    return Y


def kept_terms_plain(Xp: torch.Tensor, KeR: torch.Tensor, plan: UnivPlanDev,
                     chunk: int = 256) -> torch.Tensor:
    """The kept-edge terms of every tile, (C, n1p, n2p) float32 in sorted
    order, from the JAX plan's own fields (not the kernel's tables), gathered
    from the halo layout and summed with `index_add_` in f32, `chunk`
    graph-1 slots at a time; pad slots are left out, as the kernel leaves
    them."""
    C = Xp.shape[0]
    dev = Xp.device

    def flat(e_idx, d_loc, s_loc, r, n_edges):
        blk = torch.arange(e_idx.shape[0], device=dev)[:, None] * r
        keep = (e_idx < n_edges).reshape(-1)
        pos = torch.nonzero(keep).reshape(-1)
        return (pos, (blk + d_loc).reshape(-1)[pos],
                (blk + s_loc).reshape(-1)[pos])

    p, g1, o1 = flat(plan.e1_idx, plan.d1_loc, plan.s1_loc, plan.r1, plan.e1)
    q, g2, o2 = flat(plan.e2_idx, plan.d2_loc, plan.s2_loc, plan.r2, plan.e2)
    K = KeR.index_select(1, q).float()
    Xf = Xp.float()
    Ys = torch.zeros((C, plan.n1p, plan.n2p), dtype=torch.float32, device=dev)
    for lo in range(0, len(p), chunk):
        sl = slice(lo, lo + chunk)
        G = Xf.index_select(1, g1[sl]).index_select(2, g2)     # (C, P, Q)
        W = G * K.index_select(0, p[sl])[None]
        T = torch.zeros((C, W.shape[1], plan.n2p), dtype=torch.float32,
                        device=dev)
        T.index_add_(2, o2, W)
        Ys.index_add_(1, o1[sl], T)
    return Ys


def spill_terms_plain(X: torch.Tensor, Ke: torch.Tensor, plan: UnivPlanDev):
    """The spilled part from the plan's own edge lists (`plan.spills`, not
    the kernel's tables): spilled graph-1 edges against every graph-2 edge,
    then kept graph-1 edges against the spilled graph-2 edges, each through
    the plain op in X's dtype (bf16 X: bf16 products, f32 sums; as the JAX
    wrapper's `ops.assoc.assoc_matvec`) in the plan's swapped,
    non-transposed orientation. Returns the list of (N1, N2, C) float32
    terms (empty when nothing spilled)."""
    zero_kp = torch.zeros((1, plan.n1, plan.n2), dtype=torch.float32,
                          device=X.device)
    terms = []
    for rows, cols, *edges in plan.spills:
        ke = Ke if cols is None else Ke.index_select(1, cols)
        terms.append(assoc_matvec_chunked(
            X[None], zero_kp, ke.index_select(0, rows)[None], *edges)[0])
    return terms


def _ker(Ke, plan, KeR, dtype):
    if KeR is None:
        return gather_ke_blocks(Ke, plan, dtype=dtype)
    return KeR if KeR.dtype == dtype else KeR.to(dtype)


def launch_kernel(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                  KeR: torch.Tensor, plan: UnivPlanDev,
                  precision: str = "highest") -> torch.Tensor:
    """One launch of the CUDA kernel: the whole product, (N1, N2, C)
    float32. KeR from `gather_ke_blocks`, in `compute_dtype(X, precision)`."""
    _check(X, Kp, Ke, plan, precision, KeR)
    if X.device.type != "cuda":
        raise RuntimeError("assoc_univ: the kernel runs on CUDA tensors")
    tabs = plan.kernel_tables()
    if any(t.device != X.device for t in tabs):
        raise ValueError("assoc_univ: X and the plan's tables must lie on "
                         "one device")
    I, J = plan.n1p // plan.r1, plan.n2p // plan.r2
    n1, n2, C = X.shape
    if tuple(KeR.shape) != (I * plan.b1, J * plan.b2):
        raise ValueError(f"KeR must be {(I * plan.b1, J * plan.b2)}, got "
                         f"{tuple(KeR.shape)}")
    if KeR.dtype != compute_dtype(X, precision):
        raise TypeError(f"KeR must be {compute_dtype(X, precision)} for "
                        f"{X.dtype} X at precision {precision!r}")
    if 8 * (plan.b1 + plan.b2) > _MAX_SMEM:
        raise ValueError("assoc_univ: the plan's per-block tables do not fit "
                         "shared memory; use a smaller r1 / r2")
    X, Kp, Ke, KeR = (t.contiguous() for t in (X, Kp, Ke, KeR))
    nc, vec = channel_tiling(X)
    lib = _build.load("assoc_univ")
    name = ("fpm_assoc_univ_bf16" if X.dtype == torch.bfloat16 else
            "fpm_assoc_univ_f32_bf16" if KeR.dtype == torch.bfloat16 else
            "fpm_assoc_univ_f32")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p]
    Y = torch.empty((n1, n2, C), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), KeR.data_ptr(), Ke.data_ptr(), Kp.data_ptr(),
                  *(t.data_ptr() for t in tabs), Y.data_ptr(), n1, n2, C,
                  plan.e2, I, J, plan.r1, plan.r2, plan.b1, plan.b2, nc,
                  int(vec), stream)
    _build.check(lib, code, "assoc_univ launch")
    LAUNCHES["assoc_univ"] += 1
    return Y


# ------------------------------------------------------------ entry points
def assoc_matvec_univ_plain(X: torch.Tensor, Kp: torch.Tensor,
                            Ke: torch.Tensor, plan: UnivPlanDev,
                            KeR: Optional[torch.Tensor] = None, *,
                            precision: str = "highest") -> torch.Tensor:
    """The plain PyTorch version of `assoc_matvec_univ`: the same sort and
    rounding, the kept part from the halo layout (`kept_terms_plain`, rounded
    to bf16 for bf16 X), the spilled part from the plan's own edge lists
    through the plain op (`spill_terms_plain`), then Kp X. Used by the
    CPU tests and as the yardstick the kernel is held against; launches
    nothing."""
    _check(X, Kp, Ke, plan, precision, KeR)
    dt = compute_dtype(X, precision)
    Y = _unsort(kept_terms_plain(halo(X, plan, dt), _ker(Ke, plan, KeR, dt),
                                 plan), plan)
    if X.dtype == torch.bfloat16:
        Y = Y.bfloat16().float()
    for term in spill_terms_plain(X, Ke, plan):
        Y = Y + term
    return Y + Kp[..., None] * X.float()


def assoc_matvec_univ(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                      plan: UnivPlanDev, KeR: Optional[torch.Tensor] = None,
                      *, precision: str = "highest") -> torch.Tensor:
    """K vec(X) / K^T vec(X) (orientation fixed by the plan) for one
    UNIV-scale pair; the contract of `ops.assoc.assoc_matvec`, single pair.

    :param X: (N1, N2, C) float32 or bfloat16
    :param Kp: (N1, N2) f32; Ke: (E1, E2) f32 over the plan's real edges
    :param KeR: `gather_ke_blocks(Ke, plan)`, made here when not given
        (cast to the compute dtype when it differs)
    :param precision: "highest" (X's dtype) or "default" (X and KeR rounded
        to bf16 in the kept-edge part; f32 products and sums)
    :return: (N1, N2, C) float32

    CUDA tensors go through one launch of the CUDA kernel (a failed build
    or launch raises); CPU tensors through the plain version.
    """
    _check(X, Kp, Ke, plan, precision, KeR)
    if X.device.type == "cuda":
        return launch_kernel(
            X, Kp, Ke, _ker(Ke, plan, KeR, compute_dtype(X, precision)),
            plan, precision)
    if X.device.type == "cpu":
        return assoc_matvec_univ_plain(X, Kp, Ke, plan, KeR,
                                       precision=precision)
    raise RuntimeError(f"assoc_matvec_univ: unsupported device {X.device}")


__all__ = ["UnivPlan", "UnivPlanDev", "plan_univ", "gather_ke_blocks",
           "assoc_matvec_univ", "assoc_matvec_univ_plain"]
