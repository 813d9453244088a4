"""The edge / diagonal gradient of the association matvec ("K6"): CUDA
kernel.

For the forward of `kernels.assoc_bucket` / `ops.assoc.assoc_matvec`,

    Y[b,a,j,c] = Kp[b,a,j] X[b,a,j,c]
               + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
                     Ke[b,e1,e2] X[b, in1(e1), in2(e2), c]

with (out, in) = (src, dst), or (dst, src) for `transpose=True`, this
module computes, for an upstream gradient dY,

    dKe[b,e1,e2] = sum_c dY[b, out1(e1), out2(e2), c] X[b, in1(e1), in2(e2), c]
    dKp[b,i,j]   = sum_c dY[b,i,j,c] X[b,i,j,c]

(`dX` is the forward kernel again with `transpose` flipped). No Pallas
kernel stands behind it: on the training path the JAX package leaves the
matvec to XLA (`fpmatch_tpu/ops/assoc.py:46`) and JAX AD derives this from
it; `REPLACES` names that function.

bf16 X (the `--bf16` training path): dY stays f32 on the way in, and the
rounding is JAX AD's of the bf16 forward terms bf16(bf16(Ke) X):

    dKe[b,e1,e2] = bf16( sum_c bf16( bf16(dY[...]) X[...] ) )   (stored f32)
    dKp[b,i,j]   = sum_c dY[b,i,j,c] f32(X[b,i,j,c])

JAX sums dKe's products in bf16; here the sum is f32 and is rounded once,
so the two differ by JAX's bf16 accumulation order only (within a bf16 ulp
or so of the result).

Padded slots: with `e1_mask` / `e2_mask` (True = real edge) a masked-out slot
gets dKe = 0. Without masks a padded slot aliases node 0 and gets the value
of an edge (0, 0), as JAX AD gives it; either way the model's `* emask` on
Ke (`InnerProductAffinity`) stops it.

Both versions read graph 1 through the forward's grouping
(`kernels.assoc_bucket.plan_bucket`: edge ids sorted by out1, their in1,
the run offsets), which the forward of the same edge lists has already
made and kept, so the backward adds no grouping of its own; masked graph-1
slots are in no run.

`assoc_edge_grad` launches the CUDA kernel (`csrc/assoc_grad.cu`: a block
per (output row, sample, tile of graph-2 slots) streams the X rows of the
row's graph-1 run through shared memory, a thread per graph-2 slot with its
dY values in registers; `grad_geometry` is its shape rule) for CUDA tensors
— or raises — and uses the plain PyTorch version `assoc_edge_grad_plain`
only for tensors that lie on the CPU. X is float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span
from . import _build
from .assoc_bucket import plan_bucket

REPLACES = "fpmatch_tpu/ops/assoc.py:46"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_grad.cu"

# launches of the CUDA kernel, counted where the wrapper launches it (one
# launch computes dKe and dKp)
LAUNCHES: Dict[str, int] = {"assoc_grad": 0}

# the kernel's shape rule (`grad_geometry`): a block has 2 N2 threads, but
# GRAD_MIN_TILE to GRAD_TILE, a thread holds at most GRAD_SLICE channels of
# dY per pass, and the
# two staged X rows may take STAGE_BYTES of shared memory (above 48 KB the
# launcher raises the kernel's dynamic shared-memory limit)
GRAD_TILE = 512
GRAD_MIN_TILE = 128
GRAD_SLICE = 32
STAGE_BYTES = 96 * 1024
CHUNK_E1 = 256     # graph-1 run positions per step of the plain version


class GradGeom(NamedTuple):
    """Launch geometry of the kernel, passed to it as ints in this order
    (`GradGeom` in csrc/assoc_grad.cu)."""
    B: int
    N1: int
    N2: int
    C: int
    E1: int
    E2: int
    cb: int          # channels per pass
    passes: int      # ceil(C / cb)
    nc: int          # channels a thread holds: the kernel's instantiation
    threads: int     # per block: graph-2 slots per tile
    tiles: int       # ceil(E2 / threads)
    staged: int      # 1: X rows through shared memory
    xs: int          # elements per staged node
    nw: int          # 32-bit words per staged node when padded (0: as it is)
    x_bytes: int     # one staged X row, 16-byte padded
    smem: int        # dynamic shared memory of a block

    @property
    def path(self) -> str:
        return "staged" if self.staged else "global"


def grad_geometry(B: int, N1: int, N2: int, C: int, E1: int, E2: int,
                  itemsize: int, x_aligned: bool = True) -> GradGeom:
    """The kernel's shape rule, in one place.

    A block owns one output row and a tile of graph-2 slots, a thread one
    slot: 2 N2 slots (GRAD_MIN_TILE to GRAD_TILE; no more than E2, all
    rounded up to a warp), so that each staged X row serves about twice its
    own number of nodes in dot products (the tile sizes tried are in
    PERF.md). A thread holds cb =
    min(C, GRAD_SLICE) channels of dY (in nc registers: 1, or cb rounded up
    to 4); more channels take several passes over the row's run. `staged`:
    two X rows (every channel) fit in STAGE_BYTES and stream through shared
    memory, double-buffered; otherwise (`global`) the threads read X from
    global memory / L2, and every size runs. A staged node whose values are
    an even number of 32-bit words (X 4-byte aligned) gets one word of
    padding, so a warp's reads spread over the banks."""
    cb = min(max(C, 1), GRAD_SLICE)
    passes = -(-C // cb)
    nc = 1 if cb == 1 else -(-cb // 4) * 4
    warps = lambda n: -(-max(n, 1) // 32) * 32
    threads = min(warps(E2),
                  max(GRAD_MIN_TILE, min(warps(2 * N2), GRAD_TILE)))
    tiles = max(-(-E2 // threads), 1)
    node = C * itemsize
    nw = node // 4 if node % 8 == 0 and x_aligned else 0
    xs = (node + 4) // itemsize if nw else C
    x_bytes = -(-(N2 * xs * itemsize) // 16) * 16
    if 2 * x_bytes > STAGE_BYTES:
        return GradGeom(B, N1, N2, C, E1, E2, cb, passes, nc, threads,
                        tiles, 0, C, 0, 0, 0)
    return GradGeom(B, N1, N2, C, E1, E2, cb, passes, nc, threads, tiles, 1,
                    xs, nw, x_bytes, 2 * x_bytes)


def _roles(src1, dst1, src2, dst2, transpose: bool):
    """(out1, in1, out2, in2): Y[out] += Ke X[in]."""
    if transpose:
        return dst1, src1, dst2, src2
    return src1, dst1, src2, dst2


def _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask):
    if X.dim() != 4 or tuple(dY.shape) != tuple(X.shape):
        raise ValueError(f"dY and X must be one (B, N1, N2, C) shape, got "
                         f"{tuple(dY.shape)} and {tuple(X.shape)}")
    if dY.dtype != torch.float32 or X.dtype not in (torch.float32,
                                                    torch.bfloat16):
        raise TypeError(f"assoc_edge_grad takes float32 dY and float32 or "
                        f"bfloat16 X, got {dY.dtype} and {X.dtype}")
    B = X.shape[0]
    for name, t in (("src1", src1), ("dst1", dst1), ("src2", src2),
                    ("dst2", dst2), ("e1_mask", e1_mask),
                    ("e2_mask", e2_mask)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name} must be (B, E), got {tuple(t.shape)}")
        if t.device != X.device or dY.device != X.device:
            raise ValueError("all tensors must lie on one device")
        if not name.endswith("mask") and (t.dtype.is_floating_point
                                          or t.dtype == torch.bool):
            raise TypeError(f"{name} must be an integer tensor")
    if src1.shape != dst1.shape or src2.shape != dst2.shape:
        raise ValueError("src / dst of a graph must have one shape")
    for m, s in ((e1_mask, src1), (e2_mask, src2)):
        if m is not None and m.shape != s.shape:
            raise ValueError("an edge mask must have its edge list's shape")


def _plan(X, src1, dst1, src2, dst2, transpose, e1_mask, e2_mask):
    return plan_bucket(src1, dst1, src2, dst2, X.shape[1], X.shape[2],
                       transpose, e1_mask, e2_mask)


def assoc_edge_grad_plain(dY, X, src1, dst1, src2, dst2,
                          transpose: bool = False, e1_mask=None, e2_mask=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version, on the kernel's grouping: for each
    position of the forward's graph-1 runs (`plan_bucket`, CHUNK_E1 at a
    time, so the live (B, chunk, E2, C) products stay bounded) gather the dY
    row of the run's node and the X row in1, then the columns out2 / in2,
    multiply and sum over C, and put the result at the position's edge id;
    positions past the runs (masked slots) and masked graph-2 slots get 0.
    With bf16 X the roundings of the module docstring. Returns (dKe (B, E1,
    E2), dKp (B, N1, N2)), float32."""
    _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask)
    plan = _plan(X, src1, dst1, src2, dst2, transpose, e1_mask, e2_mask)
    _, _, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    B, N1, _, C = X.shape
    E1, E2 = src1.shape[1], src2.shape[1]
    bf16 = X.dtype == torch.bfloat16
    Xf = X.float()
    dYr = dY.bfloat16().float() if bf16 else dY
    dev = X.device
    bi = torch.arange(B, device=dev)[:, None, None]
    # the node whose run holds each position (N1: past the runs)
    pos = torch.arange(E1, device=dev).expand(B, E1).contiguous()
    node = torch.searchsorted(plan.offs1[:, 1:].contiguous().long(), pos,
                              right=True)
    o2 = out2.long()[:, None, :]
    i2 = in2.long()[:, None, :]
    parts = []
    for lo in range(0, E1, CHUNK_E1):
        o1 = node[:, lo:lo + CHUNK_E1].clamp(max=max(N1 - 1, 0))[:, :, None]
        i1 = plan.ins1[:, lo:lo + CHUNK_E1].long()[:, :, None]
        prod = dYr[bi, o1, o2] * Xf[bi, i1, i2]
        if bf16:
            prod = prod.bfloat16().float()
        parts.append(prod.sum(-1))
    rows = torch.cat(parts, dim=1) if parts else torch.zeros(
        (B, 0, E2), device=dev)
    if bf16:
        rows = rows.bfloat16().float()
    rows = torch.where((node < N1)[:, :, None], rows, 0.0)
    if e2_mask is not None:
        rows = torch.where(e2_mask.bool()[:, None, :], rows, 0.0)
    dKe = torch.zeros((B, E1, E2), dtype=torch.float32, device=dev)
    dKe.scatter_(1, plan.order1.long()[:, :, None].expand(B, E1, E2), rows)
    return dKe, (dY * Xf).sum(-1)


def _launch(dY, X, src1, dst1, src2, dst2, transpose, e1_mask, e2_mask):
    B, N1, N2, C = X.shape
    E1, E2 = src1.shape[1], src2.shape[1]
    dY, X = dY.contiguous(), X.contiguous()
    plan = _plan(X, src1, dst1, src2, dst2, transpose, e1_mask, e2_mask)
    _, _, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    idx2 = [t.int().contiguous() for t in (out2, in2)]
    m2 = None if e2_mask is None else e2_mask.bool().contiguous()
    g = grad_geometry(B, N1, N2, C, E1, E2, X.element_size(),
                      X.data_ptr() % 4 == 0)
    dKe = torch.empty((B, E1, E2), dtype=torch.float32, device=X.device)
    dKp = torch.empty((B, N1, N2), dtype=torch.float32, device=X.device)
    if N1 == 0 or N2 == 0 or C == 0:
        dKe.zero_()             # no row to walk: every slot is in no run
        dKp.zero_()
    lib = _build.load("assoc_grad")
    fn = (lib.fpm_assoc_grad_bf16 if X.dtype == torch.bfloat16
          else lib.fpm_assoc_grad_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
    geom = (ctypes.c_int * len(g))(*g)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(dY.data_ptr(), X.data_ptr(),
                  *(t.data_ptr() for t in plan[2:5]),
                  *(t.data_ptr() for t in idx2),
                  None if m2 is None else m2.data_ptr(),
                  dKe.data_ptr(), dKp.data_ptr(), ctypes.addressof(geom),
                  len(g), stream)
    _build.check(lib, code, "assoc_grad launch")
    LAUNCHES["assoc_grad"] += 1
    return dKe, dKp


def assoc_edge_grad(dY: torch.Tensor, X: torch.Tensor, src1, dst1, src2,
                    dst2, transpose: bool = False,
                    e1_mask: Optional[torch.Tensor] = None,
                    e2_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dKe, dKp) of the association matvec for the upstream gradient `dY`.

    :param dY: (B, N1, N2, C) float32
    :param X: the forward's input, same shape, float32 or bfloat16
    :param src1, dst1: (B, E1) integer edge endpoints; src2, dst2: (B, E2)
    :param transpose: the forward's orientation
    :param e1_mask, e2_mask: optional (B, E) validity; masked slots get 0
    :return: dKe (B, E1, E2) and dKp (B, N1, N2), float32

    CUDA tensors go through the CUDA kernel (a failed build or launch
    raises); CPU tensors through the plain version.
    """
    with span("op.assoc_grad"):
        _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask)
        if X.device.type == "cuda":
            return _launch(dY, X, src1, dst1, src2, dst2, transpose, e1_mask,
                           e2_mask)
        if X.device.type == "cpu":
            return assoc_edge_grad_plain(dY, X, src1, dst1, src2, dst2,
                                         transpose, e1_mask, e2_mask)
        raise RuntimeError(f"assoc_edge_grad: unsupported device {X.device}")
