"""Masked log-space Sinkhorn on the square bucket: one CUDA launch a call,
forward and backward.

`ops.sinkhorn.sinkhorn_batch` runs its sweeps here when `takes_kernel`
says so (a CUDA float32 (B, S, S) tensor, 0 < S <= MAX_S, whose backward's
shared memory fits); every other call keeps the plain PyTorch version,
`ops.sinkhorn.sinkhorn_batch_plain`, which the CPU tests hold against the
JAX package and the card tests hold this kernel against. No Pallas kernel
stands behind it: the JAX package leaves the loop to XLA
(`REPLACES` names the function); the port's eager loop launched ~17 ops a
sweep, 365 for a call of 20 sweeps.

`sinkhorn_kernel` is a `torch.autograd.Function`: the forward
(`csrc/sinkhorn.cu`, `fpm_sinkhorn_fwd`) keeps each sample's tile in
shared memory through every sweep and writes only the result; the backward
(`fpm_sinkhorn_bwd`) reloads the scores, re-runs the sweeps keeping each
sweep's normalizers, and runs the adjoint sweeps in reverse, so nothing of
the sweeps is kept between the two. `sinkhorn_geometry` is the shape rule.
The launches run inside the caller's `op.sinkhorn` span (the backward's in
the same name, `op.sinkhorn.backward` inside a train step's backward).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import span
from . import _build

REPLACES = "fpmatch_tpu/ops/sinkhorn.py:sinkhorn_batch"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/sinkhorn.cu"

# launches of the CUDA kernels, counted where the wrapper launches them
LAUNCHES: Dict[str, int] = {"sinkhorn_fwd": 0, "sinkhorn_bwd": 0}

# the largest square bucket the kernels take, and the shared memory a block
# may use on an H100 (227 KB)
MAX_S = 128
SMEM_LIMIT = 232448
# lines of a sweep a warp walks at once, their shuffles overlapped (`kQ` in
# csrc/sinkhorn.cu)
LINES_PER_WARP = 8


class SinkhornGeom(NamedTuple):
    """Launch geometry, passed to the kernels as int64s in this order
    (`Geom` in csrc/sinkhorn.cu); the strides and count fields are the
    call's own."""
    B: int
    S: int
    iters: int
    dummy: int
    threads: int     # per block: one sample
    vals: int        # entries of a line a lane holds: 1, 2 or 4
    smem_fwd: int    # bytes: the tile, rows padded to S + 1 floats
    smem_bwd: int    # bytes: the tile, g, and iters x S normalizers


def sinkhorn_geometry(B: int, S: int, max_iter: int, dummy_row: bool = True
                      ) -> SinkhornGeom:
    """The kernels' shape rule, in one place. A block holds one sample and
    has ceil(S / LINES_PER_WARP) warps, so that each warp walks the
    LINES_PER_WARP lines it owns in a sweep at once (their reductions'
    latencies overlap) and at S = 64 a block is 256 threads, 4 of which fit
    an SM (B = 512 in one wave); each lane holds ceil(S / 32) entries of a
    line (1, 2 or 4)."""
    warps = -(-S // LINES_PER_WARP)
    vals = -(-S // 32)
    vals = 4 if vals > 2 else vals
    tile = 4 * S * (S + 1)
    iters = max(int(max_iter), 0)
    return SinkhornGeom(B, S, iters, int(bool(dummy_row)), 32 * warps, vals,
                        tile, 2 * tile + 4 * iters * S)


def takes_kernel(s: torch.Tensor, max_iter: int) -> bool:
    """Whether `sinkhorn_batch` runs the call on the kernels: a CUDA float32
    (B, S, S) tensor with B > 0 and 0 < S <= MAX_S whose backward's shared
    memory (`sinkhorn_geometry`) fits a block. Rectangular buckets, larger
    ones, other types and CPU tensors take the plain version."""
    if (s.device.type != "cuda" or s.dtype != torch.float32 or s.dim() != 3
            or s.shape[1] != s.shape[2]):
        return False
    B, S = s.shape[0], s.shape[1]
    return (B > 0 and 0 < S <= MAX_S
            and sinkhorn_geometry(B, S, max_iter).smem_bwd <= SMEM_LIMIT)


def _counts(n, B: int, device):
    """A (B,) integer count tensor on `device` as the kernel reads it in
    place: (tensor, element stride, 1 for int64)."""
    t = torch.as_tensor(n, device=device)
    if t.dtype not in (torch.int32, torch.int64):
        t = t.long()
    t = t.reshape(B)
    return t, t.stride(0), int(t.dtype == torch.int64)


_FNS: Dict[str, tuple] = {}


def _fn(name: str):
    """(library, ctypes function) of `fpm_sinkhorn_fwd` / `_bwd`."""
    if name not in _FNS:
        lib = _build.load("sinkhorn")
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        n_ptr = 4 if name == "fpm_sinkhorn_fwd" else 5
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p])
        _FNS[name] = (lib, fn)
    return _FNS[name]


def _launch(s, dy, n1, n2, tau: float, max_iter: int, dummy_row: bool):
    """One launch: the forward (dy None) or the backward. Returns the (B, S,
    S) float32 result, contiguous."""
    B, S = s.shape[0], s.shape[1]
    (c1, st1, w1), (c2, st2, w2) = n1, n2
    g = sinkhorn_geometry(B, S, max_iter, dummy_row)
    d_strides = tuple(dy.stride()) if dy is not None else (0, 0, 0)
    geom = (ctypes.c_longlong * 18)(*g, *s.stride(), *d_strides, st1, w1,
                                    st2, w2)
    out = torch.empty((B, S, S), dtype=torch.float32, device=s.device)
    name = "fpm_sinkhorn_fwd" if dy is None else "fpm_sinkhorn_bwd"
    lib, fn = _fn(name)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = ((s.data_ptr(), c1.data_ptr(), c2.data_ptr()) if dy is None
                else (s.data_ptr(), dy.data_ptr(), c1.data_ptr(),
                      c2.data_ptr()))
        code = fn(*ptrs, out.data_ptr(), float(tau), ctypes.addressof(geom),
                  len(geom), stream)
    _build.check(lib, code, f"{name} launch")
    LAUNCHES["sinkhorn_fwd" if dy is None else "sinkhorn_bwd"] += 1
    return out


class _SinkhornFn(torch.autograd.Function):
    """meta: ((stride, wide) of n1, of n2, tau, max_iter, dummy_row)."""

    @staticmethod
    def forward(ctx, s, c1, c2, meta):
        ctx.meta = meta
        ctx.save_for_backward(s, c1, c2)
        return _launch(s, None, (c1, *meta[0]), (c2, *meta[1]), *meta[2:])

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        s, c1, c2 = ctx.saved_tensors
        m = ctx.meta
        with span("op.sinkhorn"):
            ds = _launch(s, dy, (c1, *m[0]), (c2, *m[1]), *m[2:])
        return ds, None, None, None


def sinkhorn_kernel(s: torch.Tensor, n1, n2, *, tau: float = 1.0,
                    max_iter: int = 10, dummy_row: bool = True
                    ) -> torch.Tensor:
    """`sinkhorn_batch` on the kernels, differentiable in `s`.

    :param s: (B, S, S) float32 CUDA scores, at any strides, that
        `takes_kernel(s, max_iter)` accepts (others raise ValueError)
    :param n1, n2: (B,) integer valid counts (int32 or int64 on the card are
        read in place)
    :return: (B, S, S) doubly-stochastic maps, zero outside the valid blocks
    """
    if not takes_kernel(s, max_iter):
        raise ValueError(f"the Sinkhorn kernels take a CUDA float32 (B, S, S) "
                         f"tensor with 0 < S <= {MAX_S}, got {s.dtype} "
                         f"{tuple(s.shape)} on {s.device} ({max_iter} "
                         f"sweeps)")
    B = s.shape[0]
    c1, st1, w1 = _counts(n1, B, s.device)
    c2, st2, w2 = _counts(n2, B, s.device)
    meta = ((st1, w1), (st2, w2), float(tau), int(max_iter), bool(dummy_row))
    return _SinkhornFn.apply(s, c1, c2, meta)
